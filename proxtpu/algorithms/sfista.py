"""SFISTA: FISTA-like method for strongly convex composite problems.

JAX port of ``/root/reference/src/algorithms/sfista.jl`` (Kong 2021
Algorithm 2.2.2; step at lines 65-88): Nesterov-type A/a/tau sequence with a
prox center ``xt`` blending the previous main and auxiliary iterates.

Termination (``sfista.jl:91-105``): the "classic" criterion measures the
stationarity residual ``r = grad f(y) - grad f(xt) + (xt - y)/lam2`` (one
extra gradient per iteration, same cost as the reference whose ``stop`` does
this every iteration).  The "AIPP" variant is implemented against the
*initial point* ``x0``; the reference's AIPP path reads a nonexistent field
``iter.y0`` and is dead code (SURVEY.md §2.4) — here it actually works.

    minimize f(x) + g(x),   f mf-strongly convex with Lf-Lipschitz gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.tree import tree_map, tree_norm, tree_norm_sq, tree_sub
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class SFISTAState(NamedTuple):
    y: object
    x: object
    A: jnp.ndarray
    xt: object
    gradf_xt: object
    res: jnp.ndarray  # termination residual, computed in-step


@proxclass(meta_fields=("termination_type",))
class SFISTAIteration:
    f: object
    g: object
    x0: object
    Lf: object
    mf: object
    lam: object
    termination_type: str

    def _step_from(self, y_prev, x_prev, A_prev):
        lam, mf = self.lam, self.mf
        tau = lam * (1 + mf * A_prev)
        a = (tau + jnp.sqrt(tau**2 + 4 * tau * A_prev)) / 2
        A = A_prev + a
        xt = tree_map(
            lambda yl, xl: (A_prev / A) * yl + (a / A) * xl, y_prev, x_prev
        )
        _, gradf_xt = value_and_gradient(self.f, xt)
        lam2 = lam / (1 + lam * mf)
        y, _ = prox(
            self.g,
            tree_map(lambda xtl, gl: xtl - lam2 * gl, xt, gradf_xt),
            lam2,
        )
        x = tree_map(
            lambda xpl, yl, xtl: xpl
            + (a / (1 + A * mf)) * ((yl - xtl) / lam + mf * (yl - xpl)),
            x_prev, y, xt,
        )
        res = self._residual(y, x, A, xt, gradf_xt, lam2)
        return SFISTAState(y, x, A, xt, gradf_xt, res)

    def _residual(self, y, x, A, xt, gradf_xt, lam2):
        if self.termination_type == "AIPP":
            # AIPP-style termination: r in d_eta(f+g)(y), measured from x0
            r = tree_map(lambda x0l, xl: (x0l - xl) / A, self.x0, x)
            d0 = tree_sub(self.x0, y)
            eta = (tree_norm_sq(d0) - tree_norm_sq(tree_sub(x, y))) / (2 * A)
            denom = jnp.maximum(
                tree_norm_sq(tree_map(jnp.add, d0, r)), 1e-16
            )
            return (tree_norm_sq(r) + jnp.maximum(eta, 0.0)) / denom
        # classic approximate first-order stationarity
        _, gradf_y = value_and_gradient(self.f, y)
        r = tree_map(
            lambda gy, gxt, xtl, yl: gy - gxt + (xtl - yl) / lam2,
            gradf_y, gradf_xt, xt, y,
        )
        return tree_norm(r)

    def init(self):
        R = self.lam.dtype
        return self._step_from(self.x0, self.x0, jnp.ones((), R))

    def step(self, s):
        return self._step_from(s.y, s.x, s.A)

    def default_stopping_criterion(self, tol, s):
        return s.res <= tol

    def default_solution(self, s):
        return s.y

    def default_display(self, k, s):
        jax.debug.print("{:5d} | {:.3e}", k, s.res)


def make_sfista_iteration(
    *, x0, f=Zero(), g=Zero(), Lf, mf=0.0, termination_type=""
):
    x0 = astree(x0)
    R = real_dtype(x0)
    return SFISTAIteration(
        f=f, g=g, x0=x0, Lf=rscalar(Lf, R), mf=rscalar(mf, R),
        lam=rscalar(1 / jnp.asarray(Lf, R), R),
        termination_type=str(termination_type),
    )


def SFISTA(*, maxit=10_000, tol=1e-6, stop=None, solution=None, verbose=False,
           freq=100, display=None, **kwargs):
    """SFISTA solver (``sfista.jl:147-167``; note default tol=1e-6)."""
    return IterativeAlgorithm(
        make_sfista_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
