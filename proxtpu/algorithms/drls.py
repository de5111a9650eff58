"""DRLS: Douglas-Rachford line-search with pluggable directions.

JAX port of ``/root/reference/src/algorithms/drls.jl``: line search on
the Douglas-Rachford envelope (DRE, ``drls.jl:90-98``) with L-BFGS /
Nesterov / no-acceleration directions, quadratic-interpolation shortcut for
generalized-quadratic f (``drls.jl:172-184``), and the strongly-convex sign
flip ``dre_sign`` (``drls.jl:63``).  The default gamma / sufficient-decrease
constant follow ``drls_default_gamma`` / ``drls_C`` (``drls.jl:11-22``),
resolved at factory time from the static convexity trait of f.

    minimize f(x) + g(x),   f smooth with accessible prox.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.base import NESTEROV, QUASI_NEWTON
from ..accel.lbfgs import LBFGS
from ..prox.base import (
    Zero,
    is_convex,
    is_generalized_quadratic,
    prox,
    proxclass,
)
from ..utils.tree import (
    tree_inf_norm,
    tree_lincomb,
    tree_map,
    tree_neg,
    tree_norm_sq,
    tree_sub,
    tree_vdot_real,
)
from ..utils.loops import bounded_while
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


def drls_default_gamma(f, mf, Lf, alpha, lam):
    if mf is not None and mf > 0:
        return 1 / (alpha * mf)
    if is_convex(f):
        return alpha / Lf
    return alpha * (2 - lam) / (2 * Lf)


def drls_C(f, mf, Lf, gamma, lam):
    a = gamma * Lf if (mf is None or mf <= 0) else 1 / (gamma * mf)
    # jnp.maximum (not python max) so per-lane array Lf/gamma work batched
    m = jnp.maximum(a - lam / 2, 0) if is_convex(f) else 1
    return lam / ((1 + a) ** 2) * ((2 - lam) / 2 - a * m)


def _dre(f_u, g_v, x, u, res, gamma):
    """Douglas-Rachford envelope (``drls.jl:90-98``); note the reference's
    *unconjugated* dot product between (x-u) and res."""
    from ..utils.tree import tree_dot

    dot = jnp.real(tree_dot(tree_sub(x, u), res))
    return f_u + g_v - dot / gamma + tree_norm_sq(res) / (2 * gamma)


class DRLSState(NamedTuple):
    x: object
    u: object
    v: object
    w: object
    res: object
    xbar: object
    gamma: jnp.ndarray
    f_u: jnp.ndarray
    g_v: jnp.ndarray
    dstate: object
    tau: jnp.ndarray
    xbar_prev: object


class _TauCarry(NamedTuple):
    k: jnp.ndarray
    tau: jnp.ndarray
    x: object
    u: object
    v: object
    w: object
    res: object
    xbar: object
    f_u: jnp.ndarray
    g_v: jnp.ndarray
    u0: object
    u1: object
    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    abc_valid: jnp.ndarray
    dre: jnp.ndarray


@proxclass(meta_fields=("max_backtracks", "directions", "dre_sign", "backtrack_limit"))
class DRLSIteration:
    f: object
    g: object
    x0: object
    lam: object
    c: object
    gamma: object
    max_backtracks: int
    directions: object
    dre_sign: int
    backtrack_limit: object = None  # static: not-None = bounded tau-search lowering

    def init(self):
        x = self.x0
        u, f_u = prox(self.f, x, self.gamma)
        w = tree_map(lambda ul, xl: 2 * ul - xl, u, x)
        v, g_v = prox(self.g, w, self.gamma)
        res = tree_sub(u, v)
        xbar = tree_map(lambda xl, rl: xl - self.lam * rl, x, res)
        return DRLSState(
            x, u, v, w, res, xbar, jnp.asarray(self.gamma), f_u, g_v,
            self.directions.init_state(x), jnp.zeros((), real_dtype(x)), xbar,
        )

    def _direction(self, s):
        style = self.directions.style
        if style == QUASI_NEWTON:
            return tree_neg(self.directions.apply(s.dstate, s.res)), s.dstate
        if style == NESTEROV:
            beta, dstate = self.directions.next_coeff(s.dstate, s.gamma)
            d = tree_map(
                lambda xb, xbp, xl: beta * (xb - xbp) + (xb - xl),
                s.xbar, s.xbar_prev, s.x,
            )
            return d, dstate
        return tree_sub(s.xbar, s.x), s.dstate

    def step(self, s):
        quad = is_generalized_quadratic(self.f)
        R = s.gamma.dtype
        gamma, lam = s.gamma, self.lam

        DRE_curr = _dre(s.f_u, s.g_v, s.x, s.u, s.res, gamma)
        threshold = self.dre_sign * DRE_curr - self.c / gamma * tree_norm_sq(s.res)

        d, dstate = self._direction(s)
        x_d = tree_map(jnp.add, s.x, d)
        xbar_prev, res_prev = s.xbar, s.res

        # full step trial (tau = 1) (``drls.jl:152-160``)
        x = x_d
        u, f_u = prox(self.f, x, gamma)
        w = tree_map(lambda ul, xl: 2 * ul - xl, u, x)
        v, g_v = prox(self.g, w, gamma)
        res = tree_sub(u, v)
        xbar = tree_map(lambda xl, rl: xl - lam * rl, x, res)

        if self.directions.style == QUASI_NEWTON:
            dstate = self.directions.update(dstate, d, tree_sub(res, res_prev))

        carry = _TauCarry(
            k=jnp.asarray(1, jnp.int32), tau=jnp.ones((), R),
            x=x, u=u, v=v, w=w, res=res, xbar=xbar, f_u=f_u, g_v=g_v,
            u0=u, u1=u, a=jnp.zeros((), R), b=jnp.zeros((), R),
            c=jnp.zeros((), R), abc_valid=jnp.asarray(False),
            dre=_dre(f_u, g_v, x, u, res, gamma),
        )

        def cond(c_):
            return (c_.k <= self.max_backtracks) & (
                self.dre_sign * c_.dre > threshold
            )

        def body(c_):
            tau = jnp.where(
                c_.k >= self.max_backtracks, jnp.zeros((), R), c_.tau / 2
            )
            x = tree_lincomb(tau, x_d, 1 - tau, xbar_prev)
            if quad:
                # prox of a generalized quadratic is affine in its argument:
                # interpolate u and f_u along the segment (``drls.jl:172-184``).
                # The segment endpoint and coefficients are computed on the
                # first trial only (lax.cond runs a single branch, so later
                # trials pay no prox — ``drls.jl`` guards this with k == 1)
                def fresh_abc():
                    u0_new, c_val = prox(self.f, xbar_prev, gamma)
                    b_new = (
                        tree_vdot_real(
                            tree_sub(xbar_prev, x_d),
                            tree_sub(xbar_prev, u0_new),
                        )
                        / gamma
                    )
                    a_new = f_u - b_new - c_val
                    return u0_new, a_new, b_new, c_val

                u0, a, b, cc = jax.lax.cond(
                    c_.abc_valid,
                    lambda: (c_.u0, c_.a, c_.b, c_.c),
                    fresh_abc,
                )
                u = tree_lincomb(tau, c_.u1, 1 - tau, u0)
                f_u_new = a * tau**2 + b * tau + cc
                abc_valid = jnp.asarray(True)
                u1 = c_.u1
            else:
                u, f_u_new = prox(self.f, x, gamma)
                u0, u1 = c_.u0, c_.u1
                a, b, cc = c_.a, c_.b, c_.c
                abc_valid = c_.abc_valid
            w = tree_map(lambda ul, xl: 2 * ul - xl, u, x)
            v, g_v = prox(self.g, w, gamma)
            res = tree_sub(u, v)
            xbar = tree_map(lambda xl, rl: xl - lam * rl, x, res)
            return _TauCarry(
                c_.k + 1, tau, x, u, v, w, res, xbar, f_u_new, g_v,
                u0, u1, a, b, cc, abc_valid,
                _dre(f_u_new, g_v, x, u, res, gamma),
            )

        out = bounded_while(
            cond, body, carry,
            None if self.backtrack_limit is None else self.max_backtracks,
        )

        return DRLSState(
            out.x, out.u, out.v, out.w, out.res, out.xbar, gamma,
            out.f_u, out.g_v, dstate, out.tau, xbar_prev,
        )

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.v

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e} | {:.3e}",
            k, s.gamma, tree_inf_norm(s.res) / s.gamma, s.tau,
        )


def make_drls_iteration(
    *,
    x0,
    f=Zero(),
    g=Zero(),
    alpha=0.95,
    beta=0.5,
    lam=1.0,
    lambda_=None,
    mf=None,
    Lf=None,
    gamma=None,
    c=None,
    max_backtracks=20,
    directions=LBFGS(5),
    backtrack_limit=None,
):
    x0 = astree(x0)
    R = real_dtype(x0)
    if lambda_ is not None:
        lam = lambda_
    if gamma is None:
        gamma = drls_default_gamma(f, mf, Lf, alpha, lam)
    if c is None:
        c = beta * drls_C(f, mf, Lf, gamma, lam)
    dre_sign = 1 if (mf is None or mf <= 0) else -1
    return DRLSIteration(
        f=f, g=g, x0=x0, lam=rscalar(lam, R), c=rscalar(c, R),
        gamma=rscalar(gamma, R), max_backtracks=int(max_backtracks),
        directions=directions, dre_sign=dre_sign,
        backtrack_limit=None if backtrack_limit is None else int(backtrack_limit),
    )


def DRLS(*, maxit=1_000, tol=1e-8, stop=None, solution=None, verbose=False,
         freq=10, display=None, **kwargs):
    """Douglas-Rachford line-search solver (DRE merit + directions,
    ``drls.jl:231-255``)."""
    return IterativeAlgorithm(
        make_drls_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
