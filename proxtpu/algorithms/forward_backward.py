"""Forward-backward splitting (proximal gradient), fixed or adaptive step.

JAX port of ``/root/reference/src/algorithms/forward_backward.jl``:
one ``value_and_gradient`` + one ``prox`` per iteration, with optional
Armijo backtracking (plus the ``increase_gamma`` regret rule) as an inner
``lax.while_loop``.  Stopping criterion: ``||res||_inf / gamma <= tol``
(``forward_backward.jl:125-126``).

    minimize f(x) + g(x),   f smooth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.linops import IdentityOperator
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, lower_bound_smoothness_constant
from ..utils.tree import tree_inf_norm, tree_map, tree_sub
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class ForwardBackwardState(NamedTuple):
    x: object
    f_x: jnp.ndarray
    grad_f_x: object
    gamma: jnp.ndarray
    y: object
    z: object
    g_z: jnp.ndarray
    res: object


@proxclass(meta_fields=("adaptive", "backtrack_limit"))
class ForwardBackwardIteration:
    f: object
    g: object
    x0: object
    gamma: object
    minimum_gamma: object
    reduce_gamma: object
    increase_gamma: object
    adaptive: bool
    backtrack_limit: object = None  # static: None = while_loop, int = bounded

    def init(self):
        x = self.x0
        f_x, grad_f_x = value_and_gradient(self.f, x)
        if self.gamma is None:
            gamma = 1 / lower_bound_smoothness_constant(
                self.f, IdentityOperator(), x, grad_f_x
            )
        else:
            gamma = self.gamma
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return ForwardBackwardState(x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z))

    def step(self, s):
        if self.adaptive:
            gamma0 = s.gamma * self.increase_gamma
            bt = backtrack_stepsize(
                gamma0,
                self.f,
                IdentityOperator(),
                self.g,
                s.x,
                s.f_x,
                s.grad_f_x,
                s.y,
                s.z,
                s.g_z,
                s.res,
                minimum_gamma=self.minimum_gamma,
                reduce_gamma=self.reduce_gamma,
                max_backtracks=self.backtrack_limit,
            )
            x, f_x, grad_f_x, gamma = bt.z, bt.f_Az, bt.grad_f_Az, bt.gamma
        else:
            x = s.z
            f_x, grad_f_x = value_and_gradient(self.f, x)
            gamma = s.gamma
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return ForwardBackwardState(x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z))

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e}", k, s.gamma, tree_inf_norm(s.res) / s.gamma
        )


def make_forward_backward_iteration(
    *,
    x0,
    f=Zero(),
    g=Zero(),
    Lf=None,
    gamma=None,
    adaptive=None,
    minimum_gamma=1e-7,
    reduce_gamma=0.5,
    increase_gamma=1.0,
    backtrack_limit=None,
):
    x0 = astree(x0)
    R = real_dtype(x0)
    if gamma is None and Lf is not None:
        gamma = 1 / jnp.asarray(Lf, R)
    if adaptive is None:
        adaptive = gamma is None
    return ForwardBackwardIteration(
        f=f,
        g=g,
        x0=x0,
        gamma=rscalar(gamma, R),
        minimum_gamma=rscalar(minimum_gamma, R),
        reduce_gamma=rscalar(reduce_gamma, R),
        increase_gamma=rscalar(increase_gamma, R),
        adaptive=bool(adaptive),
        backtrack_limit=None if backtrack_limit is None else int(backtrack_limit),
    )


def ForwardBackward(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                    verbose=False, freq=100, display=None, **kwargs):
    """Constructs the forward-backward solver (two-stage kwargs UX,
    ``forward_backward.jl:161-180``)."""
    return IterativeAlgorithm(
        make_forward_backward_iteration,
        maxit=maxit, tol=tol, stop=stop, solution=solution,
        verbose=verbose, freq=freq, display=display, **kwargs,
    )


# Aliases (``forward_backward.jl:183-184``)
ProximalGradientIteration = ForwardBackwardIteration
ProximalGradient = ForwardBackward
