"""PANOC: proximal averaged Newton-type method with FBE line search.

JAX port of ``/root/reference/src/algorithms/panoc.jl`` (step at
lines 138-255): hybrid update ``x = tau (x+d) + (1-tau) z`` backtracked on a
forward-backward-envelope sufficient decrease
``FBE <= FBE_x - sigma ||res||^2``, with an L-BFGS direction by default and
the quadratic-interpolation shortcut when ``is_generalized_quadratic(f)``
(``panoc.jl:217-237``) — resolved statically at trace time here, so the
cheap path compiles with *no* extra matvecs in the tau loop.

    minimize f(Ax) + g(x),   f smooth, A linear.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.lbfgs import LBFGS
from ..ops.linops import as_linop
from ..prox.base import Zero, is_generalized_quadratic, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, f_model
from ..utils.loops import bounded_while
from ..utils.tree import (
    eps_of,
    tree_inf_norm,
    tree_lincomb,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_vdot_real,
    tree_zeros_like,
)
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm
from .fbs_common import (
    forward_backward_init,
    next_direction,
    reset_direction_if,
    update_direction,
)


class PANOCState(NamedTuple):
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
    dstate: object
    tau: jnp.ndarray


class _TauCarry(NamedTuple):
    k: jnp.ndarray
    tau: jnp.ndarray
    x: object
    Ax: object
    f_Ax: jnp.ndarray
    grad_f_Ax: object
    At_grad_f_Ax: object
    y: object
    z: object
    g_z: jnp.ndarray
    res: object
    FBE_new: jnp.ndarray
    Az: object
    f_Az: jnp.ndarray
    grad_f_Az: object
    At_grad_f_Az: object
    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    az_valid: jnp.ndarray
    abc_valid: jnp.ndarray


@proxclass(meta_fields=("adaptive", "max_backtracks", "directions", "backtrack_limit"))
class PANOCIteration:
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
        return PANOCState(
            x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res,
            self.directions.init_state(x), jnp.zeros((), gamma.dtype),
        )

    def step(self, s):
        eps = eps_of(s.x)
        quad = is_generalized_quadratic(self.f)

        # --- gamma backtracking (adaptive) or quadratic model (fixed)
        if self.adaptive:
            bt = backtrack_stepsize(
                s.gamma, self.f, self.A, self.g,
                s.x, s.f_Ax, s.At_grad_f_Ax, s.y, s.z, s.g_z, s.res,
                alpha=self.alpha, minimum_gamma=self.minimum_gamma,
                max_backtracks=self.backtrack_limit,
            )
            gamma, y, z, g_z, res = bt.gamma, bt.y, bt.z, bt.g_z, bt.res
            Az, f_Az, grad_f_Az = bt.Az, bt.f_Az, bt.grad_f_Az
            f_Az_upp = bt.f_Az_upp
            dstate = reset_direction_if(
                self.directions, s.dstate, gamma != s.gamma, s.x
            )
            az_valid = jnp.asarray(True)
        else:
            gamma, y, z, g_z, res = s.gamma, s.y, s.z, s.g_z, s.res
            f_Az_upp = f_model(s.f_Ax, s.At_grad_f_Ax, res, self.alpha / gamma)
            Az = tree_zeros_like(s.Ax)
            f_Az = jnp.asarray(jnp.inf, f_Az_upp.dtype)
            grad_f_Az = tree_zeros_like(s.grad_f_Ax)
            dstate = s.dstate
            az_valid = jnp.asarray(False)

        FBE_x = f_Az_upp + g_z

        # --- direction, full trial step (one matvec pair, ``panoc.jl:172-198``)
        d = next_direction(self.directions, dstate, res, res)
        x_prev, res_prev = s.x, res

        Ad = self.A.matvec(d)
        x_d = tree_map(jnp.add, s.x, d)
        Ax_d = tree_map(jnp.add, s.Ax, Ad)
        f_Ax_d, grad_f_Ax_d = value_and_gradient(self.f, Ax_d)
        At_grad_f_Ax_d = self.A.rmatvec(grad_f_Ax_d)

        z_curr = z
        sigma = self.beta * (0.5 / gamma) * (1 - self.alpha)
        tol = 10 * eps * (1 + jnp.abs(FBE_x))
        threshold = FBE_x - sigma * tree_norm_sq(res) + tol

        y1 = tree_map(lambda xl, gl: xl - gamma * gl, x_d, At_grad_f_Ax_d)
        z1, g_z1 = prox(self.g, y1, gamma)
        res1 = tree_sub(x_d, z1)
        FBE_new = f_model(f_Ax_d, At_grad_f_Ax_d, res1, self.alpha / gamma) + g_z1

        R = gamma.dtype
        carry = _TauCarry(
            k=jnp.asarray(1, jnp.int32), tau=jnp.ones((), R),
            x=x_d, Ax=Ax_d, f_Ax=f_Ax_d, grad_f_Ax=grad_f_Ax_d,
            At_grad_f_Ax=At_grad_f_Ax_d, y=y1, z=z1, g_z=g_z1, res=res1,
            FBE_new=FBE_new, Az=Az, f_Az=f_Az, grad_f_Az=grad_f_Az,
            At_grad_f_Az=tree_zeros_like(At_grad_f_Ax_d),
            a=jnp.asarray(jnp.inf, R), b=jnp.asarray(jnp.inf, R),
            c=jnp.asarray(jnp.inf, R),
            az_valid=az_valid, abc_valid=jnp.asarray(False),
        )

        def cond(c_):
            return (c_.k <= self.max_backtracks) & (c_.FBE_new > threshold)

        def body(c_):
            # lazily compute A z_curr once (``panoc.jl:206-208``) — lax.cond
            # executes a single branch, so after the first trial no matvec
            # is paid (tree_where would evaluate both operands every trial)
            Az = jax.lax.cond(
                c_.az_valid, lambda: c_.Az, lambda: self.A.matvec(z_curr)
            )
            tau = jnp.where(
                c_.k >= self.max_backtracks, jnp.zeros((), R), c_.tau / 2
            )
            x = tree_lincomb(tau, x_d, 1 - tau, z_curr)
            Ax = tree_lincomb(tau, Ax_d, 1 - tau, Az)
            if quad:
                # interpolate f and its gradient along the segment — no
                # matvec per trial (``panoc.jl:217-237``); the segment-end
                # quantities and interpolation coefficients are computed on
                # the first trial only
                f_Az, grad_f_Az = jax.lax.cond(
                    c_.az_valid,
                    lambda: (c_.f_Az, c_.grad_f_Az),
                    lambda: value_and_gradient(self.f, Az),
                )

                def fresh_abc():
                    At_grad_f_Az = self.A.rmatvec(grad_f_Az)
                    c_new = f_Az
                    b_new = tree_vdot_real(Ax_d, grad_f_Az) - tree_vdot_real(
                        Az, grad_f_Az
                    )
                    a_new = f_Ax_d - b_new - c_new
                    return At_grad_f_Az, a_new, b_new, c_new

                At_grad_f_Az, a, b, cc = jax.lax.cond(
                    c_.abc_valid,
                    lambda: (c_.At_grad_f_Az, c_.a, c_.b, c_.c),
                    fresh_abc,
                )
                f_Ax = a * tau**2 + b * tau + cc
                grad_f_Ax = tree_lincomb(tau, grad_f_Ax_d, 1 - tau, grad_f_Az)
                At_grad_f_Ax = tree_lincomb(
                    tau, At_grad_f_Ax_d, 1 - tau, At_grad_f_Az
                )
                abc_valid = jnp.asarray(True)
                az_valid = jnp.asarray(True)
            else:
                f_Ax, grad_f_Ax = value_and_gradient(self.f, Ax)
                At_grad_f_Ax = self.A.rmatvec(grad_f_Ax)
                f_Az, grad_f_Az, At_grad_f_Az = c_.f_Az, c_.grad_f_Az, c_.At_grad_f_Az
                a, b, cc = c_.a, c_.b, c_.c
                abc_valid = c_.abc_valid
                az_valid = jnp.asarray(True)
            y = tree_map(lambda xl, gl: xl - gamma * gl, x, At_grad_f_Ax)
            z, g_z = prox(self.g, y, gamma)
            res = tree_sub(x, z)
            FBE_new = f_model(f_Ax, At_grad_f_Ax, res, self.alpha / gamma) + g_z
            return _TauCarry(
                c_.k + 1, tau, x, Ax, f_Ax, grad_f_Ax, At_grad_f_Ax, y, z, g_z,
                res, FBE_new, Az, f_Az, grad_f_Az, At_grad_f_Az, a, b, cc,
                az_valid, abc_valid,
            )

        # backtrack_limit also switches the tau-search to its bounded
        # lowering (trip count is intrinsically max_backtracks), making the
        # whole step compile fast under vmap (see utils/loops.py)
        out = bounded_while(
            cond, body, carry,
            None if self.backtrack_limit is None else self.max_backtracks,
        )

        dstate = update_direction(
            self.directions, dstate,
            tree_sub(out.x, x_prev), tree_sub(out.res, res_prev),
        )
        return PANOCState(
            out.x, out.Ax, out.f_Ax, out.grad_f_Ax, out.At_grad_f_Ax, gamma,
            out.y, out.z, out.g_z, out.res, dstate, out.tau,
        )

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e} | {:.3e}",
            k, s.gamma, tree_inf_norm(s.res) / s.gamma, s.tau,
        )


def make_panoc_iteration(
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
    return PANOCIteration(
        f=f, A=as_linop(A), g=g, x0=x0,
        alpha=rscalar(alpha, R), beta=rscalar(beta, R),
        gamma=rscalar(gamma, R), minimum_gamma=rscalar(minimum_gamma, R),
        adaptive=bool(adaptive), max_backtracks=int(max_backtracks),
        backtrack_limit=None if backtrack_limit is None else int(backtrack_limit),
        directions=directions,
    )


def PANOC(*, maxit=1_000, tol=1e-8, stop=None, solution=None, verbose=False,
          freq=10, display=None, **kwargs):
    """PANOC solver: quasi-Newton directions with an FBE line search
    (``panoc.jl:297-315``)."""
    return IterativeAlgorithm(
        make_panoc_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
