"""Work-optimal batched adaptive (backtracking) FB / FISTA.

Three ways to run Armijo-backtracking solvers over a batch, in increasing
fit to a batched accelerator:

1. nested ``while_loop`` under vmap — exact but can compile
   pathologically slowly (minutes even at tiny shapes);
2. ``backtrack_limit=T`` (:func:`proxtpu.utils.fb_tools.backtrack_stepsize`)
   — bounded masked ``fori_loop``; compiles fast but pays T masked trial
   evaluations per iteration;
3. THIS MODULE — the backtracking search *flattened into the outer loop*:
   every loop trip performs exactly one oracle evaluation (one
   ``value_and_gradient`` + one ``prox``) per lane, and each lane
   independently either COMMITS an accepted step (advancing its iterate and
   its iteration counter) or HALVES its stepsize and retries.  Uniform SIMD
   work per trip — the same cost per accepted iteration as the
   fixed-stepsize driver plus one evaluation per halving, which is the
   reference's own work profile (``fb_tools.jl:24-63``).

Semantics replicated exactly (pinned by ``tests/test_adaptive_flat.py``
against the single-problem driver, per lane):

* accept test ``f(z) <= f_model + 10 eps (1+|f(z)|)`` with the model at the
  *test* gamma while candidates may have been computed at the pre-increase
  gamma — the reference's regret-rule quirk
  (``forward_backward.jl:86-123`` passes last iteration's prox point into
  the first trial at the increased gamma);
* ``gamma < minimum_gamma`` floors the search (accept unconditionally);
* per-lane iteration counts = number of *accepted* steps, matching the
  driver's ``k``; ``maxit`` bounds accepted steps.

Total trips are bounded by ``maxit + log2(gamma0/minimum_gamma) +
maxit*log2(increase_gamma)`` — gamma only shrinks apart from the
post-accept increase — enforced with a defensive trip cap.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..prox.base import prox, value_and_gradient
from ..utils.shared import batch_axes, unwrap_shared
from ..utils.tree import eps_of


@partial(
    jax.jit,
    static_argnames=("maxit", "accel", "minimum_gamma", "reduce_gamma",
                     "increase_gamma", "trip_cap", "mf", "check_every"),
)
def _flat_adaptive_run(
    f, g, x0, gamma0, tol, maxit, accel=False,
    minimum_gamma=1e-7, reduce_gamma=0.5, increase_gamma=1.0,
    trip_cap=None, mf=0.0, check_every=1,
):
    """Shared flattened driver for FB (accel=False) and FISTA (accel=True,
    the stepsize-fed AdaptiveNesterovSequence(mf) — the driver's default).

    f, g: vmap-stacked function pytrees.  x0: (B, n).  gamma0: (B,).
    Returns (z, iters, done) like :func:`proxtpu.parallel.batch.batched_run_loop`.
    """
    B = x0.shape[0]
    dtype = x0.dtype
    eps = eps_of(x0)

    # Shared-marked f/g map with in_axes=None (lane-invariant data — e.g. a
    # shared design matrix makes the batched gradient one matmul)
    vvg = jax.vmap(
        lambda fi, u: value_and_gradient(unwrap_shared(fi), u),
        in_axes=(batch_axes(f), 0),
    )
    vprox = jax.vmap(
        lambda gi, u, gam: prox(unwrap_shared(gi), u, gam),
        in_axes=(batch_axes(g), 0, 0),
    )

    def candidates(x, grad, gamma):
        y = x - gamma[:, None] * grad
        z, g_z = vprox(g, y, gamma)
        res = x - z
        f_z, grad_z = vvg(f, z)
        return y, z, g_z, res, f_z, grad_z

    # --- init: mirrors ForwardBackwardIteration.init (candidates at gamma0)
    f_x0, grad_x0 = vvg(f, x0)
    y, z, g_z, res, f_z, grad_z = candidates(x0, grad_x0, gamma0)

    # state: base point (x, f_x, grad_x), committed-candidate quantities,
    # cand_gamma (gamma the candidates were computed at), test_gamma (gamma
    # the accept test runs at), FISTA extras (z_prev + the stepsize-fed
    # AdaptiveNesterovSequence state — the FastForwardBackward default,
    # which only equals the plain t-recursion under constant gamma), counters.
    init = dict(
        x=x0, f_x=f_x0, grad_x=grad_x0,
        y=y, z=z, g_z=g_z, res=res, f_z=f_z, grad_z=grad_z,
        cand_gamma=gamma0, test_gamma=gamma0 * increase_gamma,
        z_prev=x0,
        seq_step=-jnp.ones((B,), dtype), seq_theta=-jnp.ones((B,), dtype),
        k=jnp.ones((B,), jnp.int32),     # accepted steps (init counts as 1)
        done=jnp.max(jnp.abs(res), axis=1) / gamma0 <= tol,
        trips=jnp.asarray(0, jnp.int32),
    )

    if not 0.0 < reduce_gamma < 1.0:
        raise ValueError(
            f"reduce_gamma must be in (0, 1), got {reduce_gamma}"
        )
    if trip_cap is None:
        # trip budget = accepted steps + the gamma-descent allowance.
        # Descent trips are counted in units of log(1/reduce_gamma) (the
        # r4 formula hardcoded log2, i.e. reduce_gamma=0.5, and capped
        # the initial descent at 64 halvings — r5 review: reduce_gamma
        # near 1 or a tiny minimum_gamma then hit the cap before lanes
        # converged, returning uncommitted trial iterates):
        # - initial descent: from the largest starting gamma down to
        #   minimum_gamma (concrete gamma0 when available; a generous
        #   fallback otherwise);
        # - per-step undo: each accepted step's increase_gamma factor
        #   must be re-descended before the next acceptance.
        log_red = math.log(1.0 / reduce_gamma)
        try:
            gmax = float(jnp.max(gamma0))
            n_desc = int(math.ceil(
                max(0.0, math.log(gmax / minimum_gamma)) / log_red
            )) + 1
        except (TypeError, jax.errors.ConcretizationTypeError):
            n_desc = int(math.ceil(64 * math.log(2.0) / log_red)) + 1
        n_incr = int(math.ceil(maxit * max(
            0.0, math.log(increase_gamma)
        ) / log_red))
        cap = maxit + n_desc + n_incr
    else:
        cap = trip_cap

    def cond(s):
        return (
            (s["trips"] < cap)
            & jnp.logical_not(jnp.all(s["done"] | (s["k"] >= maxit)))
        )

    def body(s):
        # accept test at test_gamma with the current candidates (which may
        # have been computed at cand_gamma != test_gamma after an increase)
        fpr_sq = jnp.sum(jnp.abs(s["res"]) ** 2, axis=1)
        dots = jnp.sum(
            (jnp.conj(s["grad_x"]) * s["res"]).real
            if jnp.iscomplexobj(s["grad_x"]) else s["grad_x"] * s["res"],
            axis=1,
        )
        upp = s["f_x"] - dots + fpr_sq / (2 * s["test_gamma"])
        slack = 10 * eps * (1 + jnp.abs(s["f_z"]))
        accept = (s["f_z"] <= upp + slack) | (s["test_gamma"] < minimum_gamma)
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        commit = accept & active

        # --- committed lanes: advance the base point
        gamma_acc = s["test_gamma"]
        if accel:
            # AdaptiveNesterovSequence(mf).next_coeff fed the accepted
            # gamma, exactly like the driver (``fast_forward_backward.jl:
            # 99-104``): beta depends on the gamma history once
            # backtracking changes the stepsize mid-run; mf > 0 gives the
            # strongly-convex theta_init = sqrt(mf * gamma)
            # (``accel/nesterov.jl:56-103``).
            first = s["seq_step"] < 0
            theta_init = (
                jnp.sqrt(mf * gamma_acc) if mf > 0
                else jnp.ones((B,), dtype)
            )
            theta = jnp.where(first, theta_init, s["seq_theta"])
            step_prev = jnp.where(first, gamma_acc, s["seq_step"])
            bq = theta**2 / step_prev - mf
            delta = bq**2 + 4 * theta**2 / (step_prev * gamma_acc)
            theta_new = gamma_acc * (-bq + jnp.sqrt(delta)) / 2
            beta = (
                gamma_acc * theta * (1 - theta)
                / (step_prev * theta_new + gamma_acc * theta**2)
            )
            x_acc = s["z"] + beta[:, None] * (s["z"] - s["z_prev"])
            z_prev_new = jnp.where(commit[:, None], s["z"], s["z_prev"])
            seq_step_n = jnp.where(commit, gamma_acc, s["seq_step"])
            seq_theta_n = jnp.where(commit, theta_new, s["seq_theta"])
            f_acc, grad_acc = vvg(f, x_acc)
        else:
            x_acc = s["z"]
            f_acc, grad_acc = s["f_z"], s["grad_z"]
            z_prev_new = s["z_prev"]
            seq_step_n = s["seq_step"]
            seq_theta_n = s["seq_theta"]

        x_n = jnp.where(commit[:, None], x_acc, s["x"])
        f_n = jnp.where(commit, f_acc, s["f_x"])
        grad_n = jnp.where(commit[:, None], grad_acc, s["grad_x"])

        # new candidate gamma: accepted lanes evaluate at gamma_acc (fresh
        # candidates) and will be *tested* next trip at gamma_acc*increase;
        # halving lanes evaluate AND test at test_gamma*reduce
        cand_gamma_n = jnp.where(
            commit, gamma_acc, s["test_gamma"] * reduce_gamma
        )
        test_gamma_n = jnp.where(
            commit, gamma_acc * increase_gamma,
            s["test_gamma"] * reduce_gamma,
        )

        yn, zn, g_zn, resn, f_zn, grad_zn = candidates(
            x_n, grad_n, cand_gamma_n
        )
        upd = active[:, None]
        y_n = jnp.where(upd, yn, s["y"])
        z_n = jnp.where(upd, zn, s["z"])
        g_z_n = jnp.where(active, g_zn, s["g_z"])
        res_n = jnp.where(upd, resn, s["res"])
        f_z_n = jnp.where(active, f_zn, s["f_z"])
        grad_z_n = jnp.where(upd, grad_zn, s["grad_z"])

        k_n = s["k"] + commit.astype(jnp.int32)
        # stopping is evaluated on the driver's post-step state: fresh
        # candidates at the accepted gamma (only meaningful on commit trips)
        resnorm = jnp.max(jnp.abs(res_n), axis=1)
        newly_done = commit & (resnorm / cand_gamma_n <= tol)

        return dict(
            x=x_n, f_x=f_n, grad_x=grad_n,
            y=y_n, z=z_n, g_z=g_z_n, res=res_n, f_z=f_z_n, grad_z=grad_z_n,
            cand_gamma=jnp.where(active, cand_gamma_n, s["cand_gamma"]),
            test_gamma=jnp.where(active, test_gamma_n, s["test_gamma"]),
            z_prev=z_prev_new, seq_step=seq_step_n, seq_theta=seq_theta_n,
            k=k_n,
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )

    from .flat_ls import _blocked_while

    # the body freezes inactive lanes entirely, so blocking is EXACT (see
    # flat_ls._blocked_while): it only amortizes the per-while-trip cost
    s = _blocked_while(cond, body, init, check_every)
    return s["z"], s["k"], s["done"]


def batched_adaptive_fb(f, g, x0, tol, maxit=10_000, gamma0=None,
                        minimum_gamma=1e-7, reduce_gamma=0.5,
                        increase_gamma=1.0, check_every=1):
    """Flattened batched adaptive ForwardBackward.

    ``f``, ``g``: vmap-stacked smooth/prox function pytrees; ``x0``: (B, n);
    ``gamma0``: (B,) initial stepsizes (default: per-lane finite-difference
    Lipschitz lower bound, like the driver's cold start).
    Returns (z, iters, done) with per-lane accepted-iteration counts equal
    to the single-problem ``ForwardBackward(adaptive=True)`` driver's.
    """
    if gamma0 is None:
        gamma0 = _coldstart_gamma(f, x0)
    return _flat_adaptive_run(
        f, g, x0, jnp.asarray(gamma0, x0.dtype), tol, maxit, accel=False,
        minimum_gamma=float(minimum_gamma), reduce_gamma=float(reduce_gamma),
        increase_gamma=float(increase_gamma), check_every=int(check_every),
    )


def batched_adaptive_fista(f, g, x0, tol, maxit=10_000, gamma0=None,
                           minimum_gamma=1e-7, reduce_gamma=0.5,
                           increase_gamma=1.0, mf=0.0, check_every=1):
    """Flattened batched adaptive FastForwardBackward (the stepsize-fed
    AdaptiveNesterovSequence(mf) extrapolation, matching the driver's
    default; mf > 0 enables the strongly-convex sequence).  Same contract
    as :func:`batched_adaptive_fb`."""
    if gamma0 is None:
        gamma0 = _coldstart_gamma(f, x0)
    return _flat_adaptive_run(
        f, g, x0, jnp.asarray(gamma0, x0.dtype), tol, maxit, accel=True,
        minimum_gamma=float(minimum_gamma), reduce_gamma=float(reduce_gamma),
        increase_gamma=float(increase_gamma), mf=float(mf),
        check_every=int(check_every),
    )


def _coldstart_gamma(f, x0):
    """Per-lane 1 / lower_bound_smoothness_constant (``fb_tools.jl:7-19``)."""
    from ..ops.linops import IdentityOperator
    from ..utils.fb_tools import lower_bound_smoothness_constant

    def one(fi, x):
        fi = unwrap_shared(fi)
        _, grad = value_and_gradient(fi, x)
        return 1.0 / lower_bound_smoothness_constant(
            fi, IdentityOperator(), x, grad
        )

    return jax.vmap(one, in_axes=(batch_axes(f), 0))(f, x0)
