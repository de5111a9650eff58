"""Accelerated forward-backward splitting (FISTA).

JAX port of ``/root/reference/src/algorithms/fast_forward_backward.jl``:
FB step plus Nesterov extrapolation ``x = z + beta (z - z_prev)`` with a
pluggable coefficient sequence; the default is the stepsize-fed
``AdaptiveNesterovSequence(mf)`` which supports strong convexity
(``fast_forward_backward.jl:48,99-104``).

    minimize f(x) + g(x),   f convex smooth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.nesterov import AdaptiveNesterovSequence
from ..ops.linops import IdentityOperator
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, lower_bound_smoothness_constant
from ..utils.tree import tree_inf_norm, tree_map, tree_sub, tree_vdot_real
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class FastForwardBackwardState(NamedTuple):
    x: object
    f_x: jnp.ndarray
    grad_f_x: object
    gamma: jnp.ndarray
    y: object
    z: object
    g_z: jnp.ndarray
    res: object
    z_prev: object
    seq_state: object


@proxclass(meta_fields=("adaptive", "extrapolation", "backtrack_limit"))
class FastForwardBackwardIteration:
    f: object
    g: object
    x0: object
    gamma: object
    minimum_gamma: object
    reduce_gamma: object
    increase_gamma: object
    adaptive: bool
    extrapolation: object  # static sequence strategy
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
        return FastForwardBackwardState(
            x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z), x,
            self.extrapolation.init_state(x),
        )

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
            gamma, z = bt.gamma, bt.z
        else:
            gamma, z = s.gamma, s.z

        if getattr(self.extrapolation, "restart_aware", False):
            # O'Donoghue-Candès gradient-scheme signal: momentum points
            # against the gradient mapping -> reset the sequence.  z is
            # the freshly accepted prox point, s.x the extrapolated point
            # it came from, s.z_prev the previous prox point.
            rs = tree_vdot_real(tree_sub(s.x, z), tree_sub(z, s.z_prev))
            beta, seq_state = self.extrapolation.next_coeff(
                s.seq_state, gamma, restart=rs
            )
        else:
            beta, seq_state = self.extrapolation.next_coeff(s.seq_state, gamma)
        x = tree_map(lambda zl, zp: zl + beta * (zl - zp), z, s.z_prev)
        z_prev = z

        f_x, grad_f_x = value_and_gradient(self.f, x)
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return FastForwardBackwardState(
            x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z), z_prev, seq_state
        )

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e}", k, s.gamma, tree_inf_norm(s.res) / s.gamma
        )


def make_fast_forward_backward_iteration(
    *,
    x0,
    f=Zero(),
    g=Zero(),
    mf=0.0,
    Lf=None,
    gamma=None,
    adaptive=None,
    minimum_gamma=1e-7,
    reduce_gamma=0.5,
    increase_gamma=1.0,
    extrapolation_sequence=None,
    backtrack_limit=None,
):
    x0 = astree(x0)
    R = real_dtype(x0)
    if gamma is None and Lf is not None:
        gamma = 1 / jnp.asarray(Lf, R)
    if adaptive is None:
        adaptive = gamma is None
    extrapolation = (
        extrapolation_sequence
        if extrapolation_sequence is not None
        else AdaptiveNesterovSequence(float(mf))
    )
    return FastForwardBackwardIteration(
        f=f,
        g=g,
        x0=x0,
        gamma=rscalar(gamma, R),
        minimum_gamma=rscalar(minimum_gamma, R),
        reduce_gamma=rscalar(reduce_gamma, R),
        increase_gamma=rscalar(increase_gamma, R),
        adaptive=bool(adaptive),
        extrapolation=extrapolation,
        backtrack_limit=None if backtrack_limit is None else int(backtrack_limit),
    )


def FastForwardBackward(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                        verbose=False, freq=100, display=None, **kwargs):
    """Accelerated (FISTA) forward-backward solver with pluggable
    extrapolation sequences (``fast_forward_backward.jl:186-209``)."""
    return IterativeAlgorithm(
        make_fast_forward_backward_iteration,
        maxit=maxit, tol=tol, stop=stop, solution=solution,
        verbose=verbose, freq=freq, display=display, **kwargs,
    )


# Aliases (``fast_forward_backward.jl:208-209``)
FastProximalGradientIteration = FastForwardBackwardIteration
FastProximalGradient = FastForwardBackward
