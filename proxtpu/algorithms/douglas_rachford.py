"""Douglas-Rachford splitting.

JAX port of ``/root/reference/src/algorithms/douglas_rachford.jl``
(step at lines 53-63): two proxes and three axpys per iteration; ``gamma``
is required (no default), matching the reference.

    minimize f(x) + g(x),   both prox-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..prox.base import Zero, prox, proxclass
from ..utils.tree import tree_inf_norm, tree_map, tree_sub
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class DouglasRachfordState(NamedTuple):
    x: object
    y: object
    z: object
    res: object


@proxclass
class DouglasRachfordIteration:
    f: object
    g: object
    x0: object
    gamma: object

    def init(self):
        return self.step(
            DouglasRachfordState(
                self.x0, self.x0, self.x0, tree_map(jnp.zeros_like, self.x0)
            )
        )

    def step(self, s):
        y, _ = prox(self.f, s.x, self.gamma)
        r = tree_map(lambda yl, xl: 2 * yl - xl, y, s.x)
        z, _ = prox(self.g, r, self.gamma)
        res = tree_sub(y, z)
        x = tree_sub(s.x, res)
        return DouglasRachfordState(x, y, z, res)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / self.gamma <= tol

    def default_solution(self, s):
        return s.y

    def default_display(self, k, s):
        jax.debug.print("{:5d} | {:.3e}", k, tree_inf_norm(s.res) / self.gamma)


def make_douglas_rachford_iteration(*, x0, f=Zero(), g=Zero(), gamma):
    x0 = astree(x0)
    R = real_dtype(x0)
    return DouglasRachfordIteration(f=f, g=g, x0=x0, gamma=rscalar(gamma, R))


def DouglasRachford(*, maxit=1_000, tol=1e-8, stop=None, solution=None,
                    verbose=False, freq=100, display=None, **kwargs):
    """Douglas-Rachford splitting solver for two nonsmooth terms
    (``douglas_rachford.jl:101-119``; ``gamma`` is required)."""
    return IterativeAlgorithm(
        make_douglas_rachford_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
