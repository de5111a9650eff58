"""Li-Lin accelerated proximal gradient for nonconvex problems.

JAX port of ``/root/reference/src/algorithms/li_lin.jl`` (Algorithm 2
of Li & Lin, NIPS 2015; step at lines 100-146): extrapolated
forward-backward step monitored against a nonmonotone moving average
``F_average`` (eta=0.8, delta=1e-3).  When the monitor fails, a plain
forward-backward step from ``x`` is computed and the better of the two
points is kept ("case 2").

Note: the reference's case-2 branch reads an undefined variable ``x``
(``li_lin.jl:112``) and would throw if ever reached; here the intended
``state.x`` is used (bug documented in SURVEY.md §2.4 — do not replicate).
The case-2 computation only runs when the monitor fails, via ``lax.cond``.

    minimize f(x) + g(x),   f smooth, possibly nonconvex.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.tree import (
    tree_inf_norm,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
)
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class LiLinState(NamedTuple):
    x: object
    y: object
    f_y: jnp.ndarray
    grad_f_y: object
    gamma: jnp.ndarray
    z: object
    g_z: jnp.ndarray
    res: object
    theta: jnp.ndarray
    F_average: jnp.ndarray
    q: jnp.ndarray


@proxclass(meta_fields=("theta_restart",))
class LiLinIteration:
    f: object
    g: object
    x0: object
    gamma: object
    delta: object
    eta: object
    theta_restart: bool = False

    def init(self):
        y = self.x0
        f_y, grad_f_y = value_and_gradient(self.f, y)
        y_forward = tree_map(lambda yl, gl: yl - self.gamma * gl, y, grad_f_y)
        z, g_z = prox(self.g, y_forward, self.gamma)
        Fy = f_y + self.g(y)
        res = tree_sub(y, z)
        R = self.gamma.dtype
        return LiLinState(
            self.x0, y, f_y, grad_f_y, self.gamma, z, g_z, res,
            jnp.ones((), R), jnp.asarray(Fy, R), jnp.ones((), R),
        )

    def step(self, s):
        R = s.gamma.dtype
        Fz = self.f(s.z) + s.g_z
        # NaN-safe orientation: a NaN Fz makes monitor_ok False and takes
        # the monitored branch (whose case1 = NaN <= Fv is also False, so
        # the plain FB step from x recovers a finite iterate) — matching
        # the reference's `Fz <= thresh` predicate.  Writing this as
        # `monitor_fail = Fz > thresh` would invert the branch under NaN
        # and lock the solve on the momentum branch propagating NaN.
        monitor_ok = Fz <= s.F_average - self.delta * tree_norm_sq(s.res)
        theta = s.theta
        if self.theta_restart:
            # extension safeguard (off by default — the reference
            # has no counterpart): the unbounded theta-recursion keeps the
            # extrapolation coefficient near 1, and on ~12% of random
            # indefinite box-QPs the monitored scheme limit-cycles forever
            # (measured, f64/CPU too).  A monitor failure
            # is direct evidence the momentum is unhelpful, so reset the
            # sequence (the Li-Lin analogue of O'Donoghue-Candes restart):
            # this step's case-1 weight becomes 0 (pure FB from z) and the
            # recursion restarts from theta=1.  Convergence theory is
            # unaffected (the monitor still enforces the same sufficient
            # decrease; theta is free in Li & Lin's Alg 2 analysis).
            theta = jnp.where(monitor_ok, theta, jnp.ones_like(theta))
        theta1 = (1 + jnp.sqrt(1 + 4 * theta**2)) / 2

        w1 = (theta - 1) / theta1  # case-1 extrapolation weight

        def fast(_):
            y = tree_map(lambda zl, xl: zl + w1 * (zl - xl), s.z, s.x)
            return y, s.z, jnp.asarray(Fz, R)

        def monitored(_):
            # plain FB step from x (case-2 candidate); fixes the reference's
            # undefined-variable bug by reading the state's x
            _, grad_f_x = value_and_gradient(self.f, s.x)
            x_forward = tree_map(
                lambda xl, gl: xl - s.gamma * gl, s.x, grad_f_x
            )
            v, g_v = prox(self.g, x_forward, s.gamma)
            Fv = self.f(v) + g_v
            case1 = Fz <= Fv
            y1 = tree_map(lambda zl, xl: zl + w1 * (zl - xl), s.z, s.x)
            w2 = theta / theta1
            y2 = tree_map(
                lambda zl, vl, xl: zl + w2 * (zl - vl) + w1 * (vl - xl),
                s.z, v, s.x,
            )
            y = tree_where(case1, y1, y2)
            x_new = tree_where(case1, s.z, v)
            Fx = jnp.where(case1, Fz, Fv).astype(R)
            return y, x_new, Fx

        y, x_new, Fx = jax.lax.cond(monitor_ok, fast, monitored, None)

        f_y, grad_f_y = value_and_gradient(self.f, y)
        y_forward = tree_map(lambda yl, gl: yl - s.gamma * gl, y, grad_f_y)
        z, g_z = prox(self.g, y_forward, s.gamma)
        res = tree_sub(y, z)

        q1 = self.eta * s.q + 1
        F_average = (self.eta * s.q * s.F_average + Fx) / q1
        return LiLinState(
            x_new, y, f_y, grad_f_y, s.gamma, z, g_z, res, theta1, F_average, q1
        )

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e}", k, s.gamma,
            tree_inf_norm(s.res) / s.gamma,
        )


def make_li_lin_iteration(
    *, x0, f=Zero(), g=Zero(), Lf=None, gamma=None, delta=1e-3, eta=0.8,
    theta_restart=False,
):
    x0 = astree(x0)
    R = real_dtype(x0)
    if gamma is None:
        if Lf is None:
            raise ValueError("You must specify either Lf or gamma")
        gamma = 1 / jnp.asarray(Lf, R)
    try:
        # feasible-start assert (``li_lin.jl:77``); skipped under tracing
        # (genuine errors from a broken f/g must propagate, so only the
        # tracer-concretization errors are caught)
        F0 = float(f(x0) + g(x0))
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError):
        F0 = 0.0
    if not jnp.isfinite(F0):
        raise ValueError("initial point must be feasible")
    return LiLinIteration(
        f=f, g=g, x0=x0, gamma=rscalar(gamma, R),
        delta=rscalar(delta, R), eta=rscalar(eta, R),
        theta_restart=bool(theta_restart),
    )


def LiLin(*, maxit=10_000, tol=1e-8, stop=None, solution=None, verbose=False,
          freq=100, display=None, **kwargs):
    """Li-Lin nonconvex accelerated proximal-gradient solver
    (``li_lin.jl:184-202``).

    Robustness note (measured): on ~12% of random
    indefinite box-QP instances the monitored scheme limit-cycles and
    never reaches the tolerance (also in f64; smaller gamma makes it
    worse).  ``theta_restart=True`` (extension, off by default) resets
    the extrapolation sequence on monitor failures and rescues roughly
    half of those; plain :func:`ForwardBackward` converged on ALL
    instances of the study family, with better objective values — prefer
    it when Li-Lin stalls."""
    return IterativeAlgorithm(
        make_li_lin_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )
