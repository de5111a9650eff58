"""PANOCplus: PANOC for locally smooth f, interleaving the gamma
backtracking *inside* the tau line search.

JAX port of ``/root/reference/src/algorithms/panocplus.jl`` (step at
lines 168-240): a single ``lax.while_loop`` models the reference's
``can_update_direction`` / ``continue`` control flow with boolean carries.
Distinctive stopping criterion on the gradient-corrected residual
(``panocplus.jl:242-243``).

    minimize f(Ax) + g(x),   f locally smooth, A linear.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.lbfgs import LBFGS
from ..ops.linops import as_linop
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, f_model
from ..utils.loops import bounded_while
from ..utils.tree import (
    eps_of,
    tree_inf_norm,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
)
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm
from .fbs_common import (
    forward_backward_init,
    next_direction,
    update_direction,
)


class PANOCplusState(NamedTuple):
    x: object
    Ax: object
    f_Ax: jnp.ndarray
    grad_f_Ax: object
    At_grad_f_Ax: object
    gamma: jnp.ndarray
    y: object
    z: object
    g_z: jnp.ndarray
    res: object
    At_grad_f_Az: object
    dstate: object
    tau: jnp.ndarray


class _LSCarry(NamedTuple):
    done: jnp.ndarray
    can_update_direction: jnp.ndarray
    tau: jnp.ndarray
    tau_backtracks: jnp.ndarray
    trips_left: jnp.ndarray
    gamma: jnp.ndarray
    d: object
    x: object
    Ax: object
    f_Ax: jnp.ndarray
    grad_f_Ax: object
    At_grad_f_Ax: object
    y: object
    z: object
    g_z: jnp.ndarray
    res: object
    At_grad_f_Az: object
    dstate: object


@proxclass(meta_fields=("adaptive", "max_backtracks", "directions", "backtrack_limit"))
class PANOCplusIteration:
    f: object
    A: object
    g: object
    x0: object
    alpha: object
    beta: object
    gamma: object
    minimum_gamma: object
    adaptive: bool
    max_backtracks: int
    directions: object
    backtrack_limit: object = None  # static: None = while_loop, int = bounded gamma-search

    def init(self):
        x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res = forward_backward_init(
            self.f, self.A, self.g, self.x0, self.gamma, self.alpha
        )
        if self.adaptive:
            bt = backtrack_stepsize(
                gamma, self.f, self.A, self.g,
                x, f_Ax, At_grad, y, z, g_z, res,
                alpha=self.alpha, minimum_gamma=self.minimum_gamma,
                max_backtracks=self.backtrack_limit,
            )
            gamma, y, z, g_z, res = bt.gamma, bt.y, bt.z, bt.g_z, bt.res
            grad_f_Az = bt.grad_f_Az
        else:
            Az = self.A.matvec(z)
            _, grad_f_Az = value_and_gradient(self.f, Az)
        At_grad_f_Az = self.A.rmatvec(grad_f_Az)
        return PANOCplusState(
            x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res, At_grad_f_Az,
            self.directions.init_state(x), jnp.zeros((), gamma.dtype),
        )

    def step(self, s):
        eps = eps_of(s.x)
        R = s.gamma.dtype
        x_prev, res_prev = s.x, s.res

        FBE_x = f_model(s.f_Ax, s.At_grad_f_Ax, s.res, self.alpha / s.gamma) + s.g_z
        sigma = self.beta * (0.5 / s.gamma) * (1 - self.alpha)
        tol_fbe = 10 * eps * (1 + jnp.abs(FBE_x))
        threshold = FBE_x - sigma * tree_norm_sq(s.res) + tol_fbe

        def body(c):
            # trial point: fresh direction or tau-interpolation
            # (``panocplus.jl:178-192``)
            d_new = next_direction(self.directions, c.dstate, res_prev, res_prev)
            d = tree_where(c.can_update_direction, d_new, c.d)
            tau = jnp.where(c.can_update_direction, jnp.ones((), R), c.tau)
            x_full = tree_map(jnp.add, x_prev, d)
            x_interp = tree_map(
                lambda xp, rp, dl: (1 - tau) * (xp - rp) + tau * (xp + dl),
                x_prev, res_prev, d,
            )
            x = tree_where(c.can_update_direction, x_full, x_interp)
            tau_backtracks = jnp.where(
                c.can_update_direction,
                jnp.zeros((), jnp.int32),
                c.tau_backtracks + 1,
            )

            Ax = self.A.matvec(x)
            f_Ax, grad_f_Ax = value_and_gradient(self.f, Ax)
            At_grad_f_Ax = self.A.rmatvec(grad_f_Ax)
            y = tree_map(lambda xl, gl: xl - c.gamma * gl, x, At_grad_f_Ax)
            z, g_z = prox(self.g, y, c.gamma)
            res = tree_sub(x, z)
            f_Az_upp = f_model(f_Ax, At_grad_f_Ax, res, self.alpha / c.gamma)

            Az = self.A.matvec(z)
            f_Az, grad_f_Az = value_and_gradient(self.f, Az)
            At_grad_f_Az = self.A.rmatvec(grad_f_Az)

            if self.adaptive:
                tol = 10 * eps * (1 + jnp.abs(f_Az))
                shrink = (f_Az > f_Az_upp + tol) & (c.gamma >= self.minimum_gamma)
            else:
                shrink = jnp.asarray(False)

            gamma = jnp.where(shrink, c.gamma * 0.5, c.gamma)
            dstate = tree_where(shrink, self.directions.reset(c.dstate), c.dstate)

            FBE_new = f_Az_upp + g_z
            finish = (FBE_new <= threshold) | (
                tau_backtracks >= self.max_backtracks
            )
            done = jnp.logical_not(shrink) & finish
            tau_next = jnp.where(
                tau_backtracks >= self.max_backtracks - 1,
                jnp.zeros((), R), tau / 2,
            )
            tau_out = jnp.where(shrink | finish, tau, tau_next)
            can_update_direction = shrink
            trips_left = c.trips_left - 1
            if self.backtrack_limit is not None:
                # bounded-lowering budget exhaustion: the additive trip cap
                # below can undercount pathological shrink/tau interleavings,
                # so instead of committing a rejected trial, steer the final
                # budgeted trip to evaluate the pure-FB (tau=0) point —
                # mirroring the driver's own tau-exhaustion behavior — and
                # commit that, suppressing a same-trip shrink so the
                # committed state stays consistent with its gamma
                shrink_sup = shrink & (trips_left > 0)
                gamma = jnp.where(shrink_sup, c.gamma * 0.5, c.gamma)
                dstate = tree_where(
                    shrink_sup, self.directions.reset(c.dstate), c.dstate
                )
                done = (jnp.logical_not(shrink_sup) & finish) | (
                    trips_left <= 0
                )
                tau_out = jnp.where(
                    (trips_left <= 1) & jnp.logical_not(done),
                    jnp.zeros((), R), tau_out,
                )
                can_update_direction = shrink_sup & (trips_left > 1)

            return _LSCarry(
                done, can_update_direction, tau_out, tau_backtracks,
                trips_left, gamma, d,
                x, Ax, f_Ax, grad_f_Ax, At_grad_f_Ax, y, z, g_z, res,
                At_grad_f_Az, dstate,
            )

        cap = (
            None if self.backtrack_limit is None
            else self.max_backtracks + int(self.backtrack_limit) + 2
        )
        carry0 = _LSCarry(
            done=jnp.asarray(False),
            can_update_direction=jnp.asarray(True),
            tau=jnp.ones((), R),
            tau_backtracks=jnp.zeros((), jnp.int32),
            trips_left=jnp.asarray(
                jnp.iinfo(jnp.int32).max if cap is None else cap, jnp.int32
            ),
            gamma=s.gamma,
            d=s.res,  # placeholder; overwritten on first pass
            x=s.x, Ax=s.Ax, f_Ax=s.f_Ax, grad_f_Ax=s.grad_f_Ax,
            At_grad_f_Ax=s.At_grad_f_Ax, y=s.y, z=s.z, g_z=s.g_z, res=s.res,
            At_grad_f_Az=s.At_grad_f_Az, dstate=s.dstate,
        )
        # bounded lowering: trips <= max_backtracks tau-halvings plus the
        # gamma-halvings of the interleaved adaptive search (bounded by
        # backtrack_limit, which BatchedAlgorithm derives to cover the
        # minimum_gamma floor); the trips_left budget steering in ``body``
        # keeps the committed state honest if the additive cap undercounts
        out = bounded_while(
            lambda c: jnp.logical_not(c.done), body, carry0, cap,
        )

        dstate = update_direction(
            self.directions, out.dstate,
            tree_sub(out.x, x_prev), tree_sub(out.res, res_prev),
        )
        return PANOCplusState(
            out.x, out.Ax, out.f_Ax, out.grad_f_Ax, out.At_grad_f_Ax,
            out.gamma, out.y, out.z, out.g_z, out.res, out.At_grad_f_Az,
            dstate, out.tau,
        )

    def default_stopping_criterion(self, tol, s):
        # ||res/gamma - At grad f(Ax) + At grad f(Az)||_inf (``panocplus.jl:242-243``)
        v = tree_map(
            lambda r, gx, gz: r / s.gamma - gx + gz,
            s.res, s.At_grad_f_Ax, s.At_grad_f_Az,
        )
        return tree_inf_norm(v) <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e} | {:.3e}",
            k, s.gamma, tree_inf_norm(s.res) / s.gamma, s.tau,
        )


def make_panocplus_iteration(
    *,
    x0,
    f=Zero(),
    A=None,
    g=Zero(),
    alpha=0.95,
    beta=0.5,
    Lf=None,
    gamma=None,
    adaptive=None,
    minimum_gamma=1e-7,
    max_backtracks=20,
    backtrack_limit=None,
    directions=LBFGS(5),
):
    x0 = astree(x0)
    R = real_dtype(x0)
    if gamma is None and Lf is not None:
        gamma = alpha / jnp.asarray(Lf, R)
    if adaptive is None:
        adaptive = gamma is None
    # the reference backtracks whenever gamma was merely *estimated*, even
    # with adaptive=false (``panocplus.jl:104``: gamma === nothing || adaptive)
    adaptive = bool(adaptive) or gamma is None
    return PANOCplusIteration(
        f=f, A=as_linop(A), g=g, x0=x0,
        alpha=rscalar(alpha, R), beta=rscalar(beta, R),
        gamma=rscalar(gamma, R), minimum_gamma=rscalar(minimum_gamma, R),
        adaptive=bool(adaptive), max_backtracks=int(max_backtracks),
        backtrack_limit=None if backtrack_limit is None else int(backtrack_limit),
        directions=directions,
    )


def PANOCplus(*, maxit=1_000, tol=1e-8, stop=None, solution=None,
              verbose=False, freq=10, display=None, **kwargs):
    """PANOCplus solver: PANOC for locally smooth f (gamma backtracking
    interleaved inside the tau search, ``panocplus.jl:278-300``)."""
    return IterativeAlgorithm(
        make_panocplus_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
