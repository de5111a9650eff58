"""Work-optimal batched tau-linesearch solvers (PANOC family).

The line-search family (PANOC / ZeroFPR / DRLS / PANOCplus) backtracks a
step parameter ``tau`` inside every outer iteration.  Batched under ``vmap``
that inner search must be lowered as a bounded masked loop
(:mod:`proxtpu.utils.loops`) — which pays ``max_backtracks`` masked trial
evaluations per iteration even though the median accepted ``tau`` needs 0-2
halvings.  This module flattens the search into the outer loop, exactly
like the gamma-machine of :mod:`proxtpu.parallel.adaptive_batch`: every
while-loop trip performs ONE uniform oracle evaluation per lane (one
forward matvec + one f evaluation + one adjoint matvec + one prox), and
each lane independently either COMMITS its accepted trial (advancing its
iterate, direction state and iteration counter, and setting up the tau=1
trial of its next iteration) or HALVES ``tau`` and retries.

The trick that keeps the work uniform: the per-trip forward matvec input is
*selected per lane* — a committing lane feeds its fresh quasi-Newton
direction ``d`` (producing ``A(x+d)`` for the next tau=1 trial), a halving
lane feeds the lincomb endpoint ``z`` (producing the lazily-needed ``Az``)
— so one batched matmul serves both phases.  The quadratic-f
interpolation shortcut of the reference (``panoc.jl:217-237``) is
replicated bit-for-bit: halving lanes interpolate ``f`` and its gradient
along the segment from cached endpoint quantities instead of re-evaluating.

Semantics are pinned per lane against the single-problem driver
(``tests/test_flat_ls.py``): identical trial sequence, accept tests
(``FBE <= FBE_x - sigma ||res||^2 + 10 eps (1+|FBE_x|)``), forced tau=0
commit after ``max_backtracks`` halvings (``panoc.jl:204-250``), iteration
counts (init counts as iteration 1) and solutions.

Adaptive stepsizes: PANOCplus interleaves its gamma search in the lanes
(``_flat_panocplus_run``); adaptive PANOC and adaptive ZeroFPR each have
a two-mode machine (``_flat_panoc_adaptive_run`` /
``_flat_zerofpr_adaptive_run``: per-lane gamma-search / tau-search
phases, one oracle round per trip either way).  The bounded lowering
remains only as the generic fallback (custom stop/solution, explicit
``backtrack_limit``).  Iterates are stacked 2-D ``(B, n)`` arrays; f/g/A
are vmap-stacked pytrees (every array leaf carries the batch axis).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..prox.base import is_generalized_quadratic, prox, value_and_gradient
from ..utils.shared import batch_axes, unwrap_shared
from ..utils.tree import eps_of


def _bwhere(pred, new, old):
    """Per-lane select over a pytree: ``pred`` is (B,), leaves are (B, ...)."""
    def sel(n, o):
        p = pred.reshape(pred.shape + (1,) * (n.ndim - pred.ndim))
        return jnp.where(p, n, o)

    return jax.tree.map(sel, new, old)


def _vdot(a, b):
    """Per-lane real(<a, b>) over (B, n) stacks (``tree_vdot_real``)."""
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        return jnp.sum(jnp.conj(a) * b, axis=1).real
    return jnp.sum(a * b, axis=1)


def _norm_sq(a):
    return _vdot(a, a)


def _inf_norm(a):
    return jnp.max(jnp.abs(a), axis=1)


def _f_model(f_x, grad, res, L):
    """Per-lane quadratic model, same formula as ``utils.fb_tools.f_model``."""
    return f_x - _vdot(grad, res) + (L / 2) * _norm_sq(res)


def _blocked_while(cond, body, carry, check_every):
    """Run ``check_every`` body trips per while-loop trip.

    The flat machines' bodies fully freeze inactive lanes (every update is
    masked on ``active``), so blocking is semantically EXACT — identical
    per-lane counts and solutions to ``check_every=1`` — and only
    amortizes the fixed per-while-trip pipeline cost (the same trade
    ``check_every`` makes in
    :func:`proxtpu.parallel.batch.batched_run_loop`, where it is
    approximate, and the fused kernels' iteration blocking).  At most
    ``check_every - 1`` masked no-op trips run after the last lane
    finishes.

    Exactness caveat: on CPU the blocked program is bit-identical to K=1
    (pinned in ``tests/test_flat_ls.py``); on an accelerator, XLA may compile the
    fori-in-while body with different fusion/reassociation, so knife-edge
    accept tests can flip (counts drift +-1, solutions by last-ULP) — the
    same compilation-level caveat as batch-size-dependent einsum tiling.

    Blocking pays where a trip is cheap next to the fixed per-trip cost
    (the adaptive-FISTA machine: one matvec pair per trip) and can lose
    where trips are oracle-heavy (blocking then only adds tail waste;
    ``benchmarks/flat_ls_bench.py --blocking`` measures it).  Default
    stays 1; `BatchedAlgorithm(check_every=K)` threads K
    into every flat runner.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if check_every == 1:
        return jax.lax.while_loop(cond, body, carry)
    return jax.lax.while_loop(
        cond,
        lambda c: jax.lax.fori_loop(
            0, check_every, lambda _, t: body(t), c
        ),
        carry,
    )


def _make_vmapped(f, A, g, directions):
    # Shared-marked f/A/g map with in_axes=None (lane-invariant): the
    # per-lane matvec against a Shared A lowers to ONE (B,n)@(n,m)
    # matmul instead of a batched GEMV stream
    ax_f, ax_A, ax_g = batch_axes(f), batch_axes(A), batch_axes(g)
    vvg = jax.vmap(
        lambda fi, u: value_and_gradient(unwrap_shared(fi), u),
        in_axes=(ax_f, 0),
    )
    vprox = jax.vmap(
        lambda gi, u, gam: prox(unwrap_shared(gi), u, gam),
        in_axes=(ax_g, 0, 0),
    )
    vmv = jax.vmap(
        lambda Ai, v: unwrap_shared(Ai).matvec(v), in_axes=(ax_A, 0)
    )
    vrmv = jax.vmap(
        lambda Ai, v: unwrap_shared(Ai).rmatvec(v), in_axes=(ax_A, 0)
    )
    vinit = jax.vmap(lambda x: directions.init_state(x))
    vupdate = jax.vmap(lambda ds, s, y: directions.update(ds, s, y))
    vapply = jax.vmap(lambda ds, v: directions.apply(ds, v))
    return vvg, vprox, vmv, vrmv, vinit, vupdate, vapply


@partial(
    jax.jit,
    static_argnames=("maxit", "max_backtracks", "directions", "trip_cap",
                     "check_every"),
)
def _flat_panoc_run(
    f, A, g, x0, gamma, tol, maxit, alpha, beta, max_backtracks,
    directions, trip_cap=None, check_every=1,
):
    """Flattened batched fixed-gamma PANOC.

    f, g: vmap-stacked function pytrees; A: vmap-stacked linop pytree;
    x0: (B, n); gamma: (B,).  Returns (z, iters, done) with per-lane counts
    equal to the single-problem ``PANOC(gamma=...)`` driver's.
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    eps = eps_of(x0)
    quad = is_generalized_quadratic(f)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions
    )
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )

    def vdirection(dstate, v):
        # fbs_common.next_direction: -(H v) for quasi-Newton, -v otherwise
        return -vapply(dstate, v) if qn else -v

    gcol = gamma[:, None]
    sigma = beta * (0.5 / gamma) * (1 - alpha)

    def fbe_and_thr(f_x, At_grad, res, g_z):
        fbe = _f_model(f_x, At_grad, res, alpha / gamma) + g_z
        thr = fbe - sigma * _norm_sq(res) + 10 * eps * (1 + jnp.abs(fbe))
        return fbe, thr

    # --- init: forward_backward_init + first tau=1 trial (``panoc.jl:91-109``)
    Ax0 = vmv(A, x0)
    f0, gr0 = vvg(f, Ax0)
    Atg0 = vrmv(A, gr0)
    y0 = x0 - gcol * Atg0
    z0, gz0 = vprox(g, y0, gamma)
    res0 = x0 - z0
    done0 = _inf_norm(res0) / gamma <= tol

    dstate0 = vinit(x0)
    d0 = vdirection(dstate0, res0)
    _, thr0 = fbe_and_thr(f0, Atg0, res0, gz0)

    Ad0 = vmv(A, d0)
    x_d0 = x0 + d0
    Ax_d0 = Ax0 + Ad0
    f_d0, gr_d0 = vvg(f, Ax_d0)
    Atg_d0 = vrmv(A, gr_d0)
    yT0 = x_d0 - gcol * Atg_d0
    zT0, gzT0 = vprox(g, yT0, gamma)
    resT0 = x_d0 - zT0
    fbeT0 = _f_model(f_d0, Atg_d0, resT0, alpha / gamma) + gzT0

    zeros_m = jnp.zeros_like(Ax0)
    zeros_s = jnp.zeros((B,), R)
    s = dict(
        # search context (tau=1 endpoint + lincomb endpoint + quad caches)
        x_d=x_d0, Ax_d=Ax_d0, f_d=f_d0, gr_d=gr_d0, Atg_d=Atg_d0,
        z_b=z0, x_b=x0, res_b=res0, thr=thr0,
        Az=zeros_m, f_Az=zeros_s, gr_Az=zeros_m, Atg_Az=jnp.zeros_like(x0),
        a=zeros_s, b=zeros_s, c=zeros_s,
        abc_valid=jnp.zeros((B,), bool),
        dstate=dstate0,
        # current trial
        tau=jnp.ones((B,), R), bt=jnp.ones((B,), jnp.int32),
        xT=x_d0, AxT=Ax_d0, f_T=f_d0, gr_T=gr_d0, Atg_T=Atg_d0,
        zT=zT0, gzT=gzT0, resT=resT0, fbeT=fbeT0,
        # outputs
        z_sol=z0, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        # accept test: FBE decrease, or the forced tau=0 trial after
        # max_backtracks halvings is committed unconditionally
        # (``panoc.jl:204-250``: cond k <= max_backtracks)
        accept = (s["fbeT"] <= s["thr"]) | (s["bt"] > max_backtracks)
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        commit = accept & active
        ccol = commit[:, None]

        # --- commit-side bookkeeping (masked; no oracle work)
        dstate_upd = vupdate(
            s["dstate"], s["xT"] - s["x_b"], s["resT"] - s["res_b"]
        )
        dstate = _bwhere(commit, dstate_upd, s["dstate"])
        d_new = vdirection(dstate, s["resT"])
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)
        _, thr_commit = fbe_and_thr(
            s["f_T"], s["Atg_T"], s["resT"], s["gzT"]
        )

        # --- ONE uniform oracle evaluation, inputs selected per lane:
        # committing lanes run the tau=1 trial of their NEXT iteration
        # (forward matvec of d, f at A(x+d), adjoint of its gradient);
        # halving lanes lazily materialize Az / f(Az) / At grad f(Az) on
        # their first halving (cached afterwards) and interpolate
        mv_in = jnp.where(ccol, d_new, s["z_b"])
        Av = vmv(A, mv_in)

        x_d = jnp.where(ccol, s["xT"] + d_new, s["x_d"])
        Ax_d = jnp.where(ccol, s["AxT"] + Av, s["Ax_d"])
        Az = jnp.where(s["abc_valid"][:, None], s["Az"], Av)

        tau = jnp.where(
            commit, jnp.ones((), R),
            jnp.where(s["bt"] >= max_backtracks, jnp.zeros((), R),
                      s["tau"] / 2),
        )
        bt = jnp.where(commit, 1, s["bt"] + 1)
        z_b = jnp.where(ccol, s["zT"], s["z_b"])
        tcol = tau[:, None]
        xT = jnp.where(ccol, x_d, tcol * x_d + (1 - tcol) * z_b)
        AxT = jnp.where(ccol, Ax_d, tcol * Ax_d + (1 - tcol) * Az)

        if quad:
            # interpolate f along the segment exactly like the driver
            # (``panoc.jl:217-237``): the f evaluation and adjoint matvec
            # feed the committing lanes' endpoint and the halving lanes'
            # first-trial Az quantities
            fin = jnp.where(ccol, Ax_d, Az)
            f_val, f_gr = vvg(f, fin)
            f_d = jnp.where(commit, f_val, s["f_d"])
            gr_d = jnp.where(ccol, f_gr, s["gr_d"])
            f_Az = jnp.where(s["abc_valid"], s["f_Az"], f_val)
            gr_Az = jnp.where(s["abc_valid"][:, None], s["gr_Az"], f_gr)
            gin = jnp.where(ccol, f_gr, gr_Az)
            Atg = vrmv(A, gin)
            Atg_d = jnp.where(ccol, Atg, s["Atg_d"])
            Atg_Az = jnp.where(s["abc_valid"][:, None], s["Atg_Az"], Atg)
            cc = jnp.where(s["abc_valid"], s["c"], f_Az)
            bb = jnp.where(
                s["abc_valid"], s["b"],
                _vdot(Ax_d, gr_Az) - _vdot(Az, gr_Az),
            )
            aa = jnp.where(s["abc_valid"], s["a"], f_d - bb - cc)
            f_T = jnp.where(commit, f_val, aa * tau**2 + bb * tau + cc)
            gr_T = jnp.where(ccol, f_gr, tcol * gr_d + (1 - tcol) * gr_Az)
            Atg_T = jnp.where(
                ccol, Atg, tcol * Atg_d + (1 - tcol) * Atg_Az
            )
            abc_valid = jnp.logical_not(commit)
        else:
            # non-quadratic f: evaluate at the trial point itself (the
            # committing lanes' tau=1 point IS their endpoint A(x+d))
            f_val, f_gr = vvg(f, AxT)
            Atg = vrmv(A, f_gr)
            f_d = jnp.where(commit, f_val, s["f_d"])
            gr_d = jnp.where(ccol, f_gr, s["gr_d"])
            Atg_d = jnp.where(ccol, Atg, s["Atg_d"])
            f_Az, gr_Az, Atg_Az = s["f_Az"], s["gr_Az"], s["Atg_Az"]
            aa, bb, cc = s["a"], s["b"], s["c"]
            abc_valid = jnp.logical_not(commit)
            f_T, gr_T, Atg_T = f_val, f_gr, Atg

        yT = xT - gcol * Atg_T
        zT, gzT = vprox(g, yT, gamma)
        resT = xT - zT
        fbeT = _f_model(f_T, Atg_T, resT, alpha / gamma) + gzT

        new = dict(
            x_d=x_d, Ax_d=Ax_d, f_d=f_d, gr_d=gr_d, Atg_d=Atg_d,
            z_b=z_b,
            x_b=jnp.where(ccol, s["xT"], s["x_b"]),
            res_b=jnp.where(ccol, s["resT"], s["res_b"]),
            thr=jnp.where(commit, thr_commit, s["thr"]),
            Az=Az, f_Az=f_Az, gr_Az=gr_Az, Atg_Az=Atg_Az,
            a=aa, b=bb, c=cc, abc_valid=abc_valid,
            dstate=dstate,
            tau=tau, bt=bt,
            xT=xT, AxT=AxT, f_T=f_T, gr_T=gr_T, Atg_T=Atg_T,
            zT=zT, gzT=gzT, resT=resT, fbeT=fbeT,
            z_sol=jnp.where(ccol, s["zT"], s["z_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        # freeze inactive lanes entirely (converged or at maxit);
        # done/trips are global bookkeeping and never roll back
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["z_sol"], s["k"], s["done"]


@partial(
    jax.jit,
    static_argnames=("maxit", "max_backtracks", "directions", "trip_cap",
                     "check_every"),
)
def _flat_zerofpr_run(
    f, A, g, x0, gamma, tol, maxit, alpha, beta, max_backtracks,
    directions, trip_cap=None, check_every=1,
):
    """Flattened batched fixed-gamma ZeroFPR.

    Each lane alternates a PREP trip (FB quantities at ``xbar``:
    ``res_xbar``, deferred quasi-Newton update, direction ``d`` —
    ``zerofpr.jl:181-198``) with TRIAL trips (``x = xbar + tau d`` FBE
    line search, ``zerofpr.jl:200-217``); every trip spends one uniform
    oracle slot (forward matvec + f eval + adjoint matvec + prox), with
    the matvec input selected per lane (PREP feeds ``xbar``, TRIAL feeds
    ``d`` — recomputing ``A d`` on halvings costs nothing extra since the
    batched matmul runs anyway).
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    eps = eps_of(x0)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions
    )
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )

    def vdirection(dstate, v_qn, v_fb):
        return -vapply(dstate, v_qn) if qn else -v_fb

    gcol = gamma[:, None]
    sigma = beta * (0.5 / gamma) * (1 - alpha)

    def thr_of(fbe_x, res):
        return fbe_x - sigma * _norm_sq(res) + 10 * eps * (1 + jnp.abs(fbe_x))

    # --- init: forward_backward_init at x0 (iteration 1)
    Ax0 = vmv(A, x0)
    f0, gr0 = vvg(f, Ax0)
    Atg0 = vrmv(A, gr0)
    y0 = x0 - gcol * Atg0
    xbar0, gxb0 = vprox(g, y0, gamma)
    res0 = x0 - xbar0
    done0 = _inf_norm(res0) / gamma <= tol
    fbe_x0 = _f_model(f0, Atg0, res0, alpha / gamma) + gxb0

    dstate0 = vinit(x0)
    s = dict(
        phase_prep=jnp.ones((B,), bool),
        xbar=xbar0, Axbar=Ax0,  # Axbar placeholder; PREP recomputes it
        res=res0, thr=thr_of(fbe_x0, res0),
        d=jnp.zeros_like(x0),
        tau=jnp.ones((B,), R), bt=jnp.ones((B,), jnp.int32),
        dstate=dstate0,
        xbar_prev=xbar0, res_xbar_prev=res0,
        is_prev_set=jnp.zeros((B,), bool),
        z_sol=xbar0, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        prep = s["phase_prep"]
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        pcol = prep[:, None]
        tcol = s["tau"][:, None]

        # --- one uniform oracle slot
        mv_in = jnp.where(pcol, s["xbar"], s["d"])
        Av = vmv(A, mv_in)
        Axbar = jnp.where(pcol, Av, s["Axbar"])
        x_t = s["xbar"] + jnp.where(pcol, jnp.zeros((), R), tcol) * s["d"]
        Ax_t = jnp.where(pcol, Av, s["Axbar"] + tcol * Av)
        f_t, gr_t = vvg(f, Ax_t)
        Atg_t = vrmv(A, gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(g, y_t, gamma)
        r_t = x_t - z_t

        # --- PREP outcome: res_xbar, deferred QN update, direction
        # (``zerofpr.jl:188-198``); r_t for a PREP lane IS res_xbar
        dstate_upd = vupdate(
            s["dstate"], s["xbar"] - s["xbar_prev"],
            r_t - s["res_xbar_prev"],
        )
        do_upd = prep & s["is_prev_set"]
        dstate = _bwhere(do_upd, dstate_upd, s["dstate"])
        d_new = vdirection(dstate, r_t, s["res"])

        # --- TRIAL outcome: FBE accept test (``zerofpr.jl:200-217``)
        fbe_t = _f_model(f_t, Atg_t, r_t, alpha / gamma) + gz_t
        trial = jnp.logical_not(prep)
        accept = trial & (
            (fbe_t <= s["thr"]) | (s["bt"] >= max_backtracks)
        )
        acol = accept[:, None]
        commit = accept & active
        newly_done = commit & (_inf_norm(r_t) / gamma <= tol)
        tau_next = jnp.where(
            s["bt"] >= max_backtracks - 1, jnp.zeros((), R), s["tau"] / 2
        )

        new = dict(
            # accept -> PREP next; PREP -> TRIAL next; reject -> TRIAL
            phase_prep=accept,
            xbar=jnp.where(acol, z_t, s["xbar"]),
            Axbar=Axbar,
            res=jnp.where(acol, r_t, s["res"]),
            thr=jnp.where(accept, thr_of(fbe_t, r_t), s["thr"]),
            d=jnp.where(pcol, d_new, s["d"]),
            tau=jnp.where(
                prep | accept, jnp.ones((), R),
                jnp.where(trial, tau_next, s["tau"]),
            ),
            bt=jnp.where(
                prep | accept, 1,
                jnp.where(trial, s["bt"] + 1, s["bt"]),
            ),
            dstate=dstate,
            xbar_prev=jnp.where(pcol, s["xbar"], s["xbar_prev"]),
            res_xbar_prev=jnp.where(pcol, r_t, s["res_xbar_prev"]),
            is_prev_set=s["is_prev_set"] | prep,
            z_sol=jnp.where(acol, z_t, s["z_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["z_sol"], s["k"], s["done"]



@partial(
    jax.jit,
    static_argnames=("maxit", "max_backtracks", "directions", "trip_cap",
                     "check_every", "estimate_gamma"),
)
def _flat_zerofpr_adaptive_run(
    f, A, g, x0, gamma, tol, maxit, alpha, beta, max_backtracks,
    directions, minimum_gamma, estimate_gamma=False, trip_cap=None,
    check_every=1,
):
    """Flattened batched ADAPTIVE ZeroFPR (gamma backtracking + tau search).

    Two per-lane modes, one matvec-pair oracle round per trip:

    * mode G: the trip evaluates ``f(A xbar)`` for the pending gamma
      candidates (matvec + f eval) and tests the quadratic model
      (``fb_tools.jl:24-63``); a failing lane halves gamma and builds new
      FB candidates from the cached base-point quantities (prox only); a
      passing lane seals the iteration's gamma and performs the PREP work
      in the same trip (adjoint at ``grad f(A xbar)``, ``res_xbar`` via
      the uniform prox, deferred quasi-Newton update, direction,
      ``zerofpr.jl:181-198``), entering mode T at tau=1;
    * mode T: the fixed machine's TRIAL body (``x = xbar + tau d`` FBE
      search, ``zerofpr.jl:200-217``); a committing lane becomes the next
      iteration's base point and re-enters mode G with its trial
      candidates (the driver's backtrack entry state).

    Parity discipline matches the other flat machines (exact counts on
    quadratic f, short-horizon zips + physical accuracy on non-quadratic;
    ``tests/test_flat_ls.py``).
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    eps = eps_of(x0)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions
    )
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )
    if qn:
        vreset = jax.vmap(lambda ds: directions.reset(ds))

    def vdirection(dstate, v_qn, v_fb):
        return -vapply(dstate, v_qn) if qn else -v_fb

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, alpha / gam)

    # --- init: forward_backward_init at x0 (candidates at gamma0; the
    # first G trip performs the driver's backtrack entry test)
    Ax0 = vmv(A, x0)
    f0, gr0 = vvg(f, Ax0)
    Atg0 = vrmv(A, gr0)
    if estimate_gamma:
        _, gr_eps = vvg(f, vmv(A, x0 + 1))
        L_est = jnp.sqrt(_norm_sq(vrmv(A, gr_eps - gr0))) / jnp.sqrt(
            jnp.asarray(float(n), R)
        )
        gamma = alpha / L_est
    gcol0 = gamma[:, None]
    y0 = x0 - gcol0 * Atg0
    xbar0, gxb0 = vprox(g, y0, gamma)
    res0 = x0 - xbar0
    done0 = _inf_norm(res0) / gamma <= tol
    upp0 = fmodel(f0, Atg0, res0, gamma)

    dstate0 = vinit(x0)
    s = dict(
        in_g=jnp.ones((B,), bool),
        # committed base point + caches (gamma candidates derive from it)
        x_b=x0, f_b=f0, Atg_b=Atg0,
        # pending gamma candidates / accepted-iteration quantities
        xbar=xbar0, g_xbar=gxb0, res=res0, upp=upp0,
        gamma=gamma, gamma_prev=gamma,
        Axbar=Ax0,  # valid after G-accept (set from the G-trip matvec)
        thr=jnp.zeros((B,), R),
        d=jnp.zeros_like(x0),
        tau=jnp.ones((B,), R), bt=jnp.ones((B,), jnp.int32),
        dstate=dstate0,
        xbar_prev=xbar0, res_xbar_prev=res0,
        is_prev_set=jnp.zeros((B,), bool),
        z_sol=xbar0, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 3) + 128
        if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]
        in_g = s["in_g"]
        in_t = jnp.logical_not(in_g)
        gco = in_g[:, None]
        tcol = s["tau"][:, None]

        # --- one uniform oracle round: G feeds xbar, T feeds d
        mv_in = jnp.where(gco, s["xbar"], s["d"])
        Av = vmv(A, mv_in)
        Axbar_g = Av  # for G lanes: A xbar of the pending candidates
        x_t = jnp.where(
            gco, s["xbar"], s["xbar"] + tcol * s["d"]
        )
        Ax_t = jnp.where(gco, Av, s["Axbar"] + tcol * Av)
        f_t, gr_t = vvg(f, Ax_t)
        Atg_t = vrmv(A, gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(g, y_t, gamma)
        r_t = x_t - z_t
        # for a G lane: f_t = f(A xbar), z_t = xbarbar, r_t = res_xbar

        # --- G decision (the driver's backtrack accept test)
        slack_g = 10 * eps * (1 + jnp.abs(f_t))
        acc_g = (f_t <= s["upp"] + slack_g) | (gamma < minimum_gamma)
        accG = in_g & acc_g & active
        halveG = in_g & jnp.logical_not(acc_g) & active

        # --- dstate: reset on gamma change (``zerofpr.jl: adaptive``),
        # then the deferred update with (xbar, res_xbar) deltas
        if qn:
            dstate = _bwhere(
                accG & (gamma != s["gamma_prev"]),
                vreset(s["dstate"]), s["dstate"],
            )
            dstate_upd = vupdate(
                dstate, s["xbar"] - s["xbar_prev"],
                r_t - s["res_xbar_prev"],
            )
            dstate = _bwhere(accG & s["is_prev_set"], dstate_upd, dstate)
        else:
            dstate = s["dstate"]
        d_new = vdirection(dstate, r_t, s["res"])

        sigma = beta * (0.5 / gamma) * (1 - alpha)
        fbe_x = s["upp"] + s["g_xbar"]
        thr_acc = fbe_x - sigma * _norm_sq(s["res"]) + 10 * eps * (
            1 + jnp.abs(fbe_x)
        )

        # halveG lanes: fresh FB candidates at gamma/2 from the base caches
        gam_h = gamma * 0.5
        y_h = s["x_b"] - gam_h[:, None] * s["Atg_b"]
        xbar_h, gxb_h = vprox(g, y_h, gam_h)
        res_h = s["x_b"] - xbar_h
        upp_h = fmodel(s["f_b"], s["Atg_b"], res_h, gam_h)

        # --- T decision (FBE accept; ``zerofpr.jl:200-217``)
        fbe_t = fmodel(f_t, Atg_t, r_t, gamma) + gz_t
        accept = in_t & ((fbe_t <= s["thr"]) | (s["bt"] >= max_backtracks))
        commit = accept & active
        halveT = in_t & jnp.logical_not(accept) & active
        ccol = commit[:, None]
        newly_done = commit & (_inf_norm(r_t) / gamma <= tol)
        tau_next = jnp.where(
            s["bt"] >= max_backtracks - 1, jnp.zeros((), R), s["tau"] / 2
        )

        accGc = accG[:, None]
        halveGc = halveG[:, None]

        new = dict(
            in_g=jnp.where(commit, True,
                           jnp.where(accG, False, s["in_g"])),
            x_b=jnp.where(ccol, x_t, s["x_b"]),
            f_b=jnp.where(commit, f_t, s["f_b"]),
            Atg_b=jnp.where(ccol, Atg_t, s["Atg_b"]),
            xbar=jnp.where(
                ccol, z_t, jnp.where(halveGc, xbar_h, s["xbar"])
            ),
            g_xbar=jnp.where(
                commit, gz_t, jnp.where(halveG, gxb_h, s["g_xbar"])
            ),
            res=jnp.where(
                ccol, r_t, jnp.where(halveGc, res_h, s["res"])
            ),
            upp=jnp.where(
                commit, fmodel(f_t, Atg_t, r_t, gamma),
                jnp.where(halveG, upp_h, s["upp"]),
            ),
            gamma=jnp.where(halveG, gam_h, gamma),
            gamma_prev=jnp.where(accG, gamma, s["gamma_prev"]),
            Axbar=jnp.where(accGc, Axbar_g, s["Axbar"]),
            thr=jnp.where(accG, thr_acc, s["thr"]),
            d=jnp.where(accGc, d_new, s["d"]),
            tau=jnp.where(
                accG | commit, jnp.ones((), R),
                jnp.where(halveT, tau_next, s["tau"]),
            ),
            bt=jnp.where(
                accG | commit, 1,
                jnp.where(halveT, s["bt"] + 1, s["bt"]),
            ),
            dstate=dstate,
            xbar_prev=jnp.where(accGc, s["xbar"], s["xbar_prev"]),
            res_xbar_prev=jnp.where(accGc, r_t, s["res_xbar_prev"]),
            is_prev_set=s["is_prev_set"] | accG,
            z_sol=jnp.where(ccol, z_t, s["z_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["z_sol"], s["k"], s["done"]

def _dot_real_unconj(a, b):
    """Per-lane real(sum(a .* b)) WITHOUT conjugation — the reference's DRE
    uses the unconjugated ``dot`` (``drls.jl:90-98``, see ``_dre``)."""
    d = jnp.sum(a * b, axis=1)
    return d.real if jnp.iscomplexobj(d) else d



@partial(
    jax.jit,
    static_argnames=("maxit", "max_backtracks", "directions", "trip_cap",
                     "check_every", "estimate_gamma"),
)
def _flat_panoc_adaptive_run(
    f, A, g, x0, gamma, tol, maxit, alpha, beta, max_backtracks,
    directions, minimum_gamma, estimate_gamma=False, trip_cap=None,
    check_every=1,
):
    """Flattened batched ADAPTIVE PANOC (gamma backtracking + tau search).

    The driver's step is a gamma-search at the iteration's base point
    (``fb_tools.jl:24-63`` via ``panoc.jl:141-163``) followed by the FBE
    tau-search; the bounded lowering pays ``backtrack_limit +
    max_backtracks`` masked trials per iteration for it.  This machine
    flattens BOTH searches into the outer loop with a per-lane mode flag:

    * mode G (gamma search): the pending trip holds FB candidates and
      ``f(Az)`` at the gamma under test; a failing lane halves gamma and
      re-evaluates (one prox + one forward matvec + one f eval); a passing
      lane seals the iteration's gamma (resetting its quasi-Newton state
      iff gamma changed, ``panoc.jl:160-162``), computes its direction,
      and evaluates the tau=1 trial (one forward matvec + f + adjoint +
      prox) — entering mode T;
    * mode T (tau search): exactly the fixed-gamma machine's trial/commit
      body; a committing lane advances its iterate, updates its direction
      state, and evaluates the FIRST gamma trial of its next iteration
      (``f(Az)`` at the incoming gamma — the driver's
      ``backtrack_stepsize`` entry test) — re-entering mode G.

    Every trip spends the same one-matvec-pair budget per lane regardless
    of mode.  Per-lane gamma decisions, counts, and solutions match the
    single-problem ``PANOC(adaptive=True)`` driver (pinned in
    ``tests/test_flat_ls.py`` with the same tolerance discipline as the
    other flat machines).
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    eps = eps_of(x0)
    quad = is_generalized_quadratic(f)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions
    )
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )
    if qn:
        vreset = jax.vmap(lambda ds: directions.reset(ds))

    def vdirection(dstate, v):
        return -vapply(dstate, v) if qn else -v

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, alpha / gam)

    # --- init: forward_backward_init at x0 (``panoc.jl:91-109``) and the
    # first gamma-trial evaluation (the driver's backtrack entry test)
    Ax0 = vmv(A, x0)
    f0, gr0 = vvg(f, Ax0)
    Atg0 = vrmv(A, gr0)
    if estimate_gamma:
        _, gr_eps = vvg(f, vmv(A, x0 + 1))
        L_est = jnp.sqrt(_norm_sq(vrmv(A, gr_eps - gr0))) / jnp.sqrt(
            jnp.asarray(float(n), R)
        )
        gamma = alpha / L_est
    gcol0 = gamma[:, None]
    y0 = x0 - gcol0 * Atg0
    z0, gz0 = vprox(g, y0, gamma)
    res0 = x0 - z0
    done0 = _inf_norm(res0) / gamma <= tol
    Az0 = vmv(A, z0)
    f_Az0, gr_Az0 = vvg(f, Az0)
    upp0 = fmodel(f0, Atg0, res0, gamma)

    dstate0 = vinit(x0)
    zeros_s = jnp.zeros((B,), R)
    s = dict(
        # accepted-iterate base + its caches (mode G works from these)
        x_b=x0, Ax_b=Ax0, f_b=f0, Atg_b=Atg0,
        z_b=z0, gz_b=gz0, res_b=res0, upp=upp0,
        gamma=gamma, gamma_prev=gamma,
        in_g=jnp.ones((B,), bool),
        thr=zeros_s,
        # tau-search context (valid in mode T)
        x_d=x0, Ax_d=Ax0, f_d=f0, gr_d=gr0, Atg_d=Atg0,
        Az=Az0, f_Az=f_Az0, gr_Az=gr_Az0,
        At_gz=jnp.zeros_like(x0),
        a=zeros_s, b=zeros_s, c=zeros_s,
        abc_valid=jnp.zeros((B,), bool),
        dstate=dstate0,
        tau=jnp.ones((B,), R), bt=jnp.ones((B,), jnp.int32),
        xT=x0, AxT=Ax0, f_T=f0, gr_T=gr0, Atg_T=Atg0,
        zT=z0, gzT=gz0, resT=res0, fbeT=zeros_s,
        z_sol=z0, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 3) + 128
        if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]

        # ------------------------------------------------ mode G decision
        slack_g = 10 * eps * (1 + jnp.abs(s["f_Az"]))
        acc_g = (s["f_Az"] <= s["upp"] + slack_g) | (gamma < minimum_gamma)
        halveG = s["in_g"] & jnp.logical_not(acc_g) & active
        accG = s["in_g"] & acc_g & active

        # ------------------------------------------------ mode T decision
        in_t = jnp.logical_not(s["in_g"])
        accept_t = (s["fbeT"] <= s["thr"]) | (s["bt"] > max_backtracks)
        commit = in_t & accept_t & active
        halveT = in_t & jnp.logical_not(accept_t) & active

        # --- direction-state bookkeeping: commit updates (``panoc.jl:252``),
        # gamma-accept resets iff gamma changed (``panoc.jl:160-162``)
        if qn:
            dstate = _bwhere(
                commit,
                vupdate(s["dstate"], s["xT"] - s["x_b"],
                        s["resT"] - s["res_b"]),
                s["dstate"],
            )
            dstate = _bwhere(
                accG & (gamma != s["gamma_prev"]), vreset(dstate), dstate
            )
        else:
            dstate = s["dstate"]

        # accG lanes seal this gamma: threshold + direction + tau=1 trial
        sigma = beta * (0.5 / gamma) * (1 - alpha)
        fbe_x = s["upp"] + s["gz_b"]
        thr_acc = fbe_x - sigma * _norm_sq(s["res_b"]) + 10 * eps * (
            1 + jnp.abs(fbe_x)
        )
        d_new = vdirection(dstate, s["res_b"])

        # halveG lanes: fresh FB candidates at gamma/2 (prox slot)
        gam_h = gamma * 0.5
        accGc = accG[:, None]
        halveGc = halveG[:, None]
        commitc = commit[:, None]

        # ---------------- the ONE uniform oracle round, inputs per lane
        # forward matvec: accG -> d (tau=1 endpoint), halveG -> z at
        # gamma/2, commit -> zT (next iteration's first gamma trial),
        # halveT -> z_b (lazy Az materialization, fixed-machine pattern)
        y_h = s["x_b"] - gam_h[:, None] * s["Atg_b"]
        gam_for_prox = jnp.where(halveG, gam_h, gamma)
        zh, gzh = vprox(g, jnp.where(halveGc, y_h, s["x_b"]), gam_for_prox)
        # (the non-halveG lanes' prox input is a placeholder; their prox
        # outputs are never read this round — the REAL tau=1 prox for accG
        # lanes happens below, after the adjoint)
        res_h = s["x_b"] - zh
        upp_h = fmodel(s["f_b"], s["Atg_b"], res_h, gam_h)

        mv_in = jnp.where(
            accGc, d_new,
            jnp.where(halveGc, zh, jnp.where(commitc, s["zT"], s["z_b"])),
        )
        Av = vmv(A, mv_in)
        x_d = jnp.where(accGc, s["x_b"] + d_new, s["x_d"])
        Ax_d = jnp.where(accGc, s["Ax_b"] + Av, s["Ax_d"])

        # Az cache: halveG -> fresh Az(gamma/2); commit -> Az(zT);
        # halveT without cache -> lazily materialized now
        need_lazy = halveT & jnp.logical_not(s["abc_valid"])
        Az = jnp.where(
            (halveG | commit | need_lazy)[:, None], Av, s["Az"]
        )

        # f evaluation input: accG -> Ax_d; G-halve/commit/lazy -> Az;
        # halveT(quad, cached) -> Az (value discarded); halveT(nonquad) ->
        # the trial point AxT (computed below) — handled in the branch
        tau = jnp.where(
            commit | accG, jnp.ones((), R),
            jnp.where(
                halveT & (s["bt"] >= max_backtracks), jnp.zeros((), R),
                jnp.where(halveT, s["tau"] / 2, s["tau"]),
            ),
        )
        tcol = tau[:, None]
        z_lin = jnp.where(commitc, s["zT"], s["z_b"])
        xT = jnp.where(
            accGc, x_d,
            jnp.where(commitc, s["xT"],
                      tcol * s["x_d"] + (1 - tcol) * z_lin),
        )
        AxT = jnp.where(
            accGc, Ax_d,
            jnp.where(commitc, s["AxT"],
                      tcol * s["Ax_d"] + (1 - tcol) * Az),
        )

        if quad:
            fin = jnp.where(accGc, Ax_d, Az)
            f_val, f_gr = vvg(f, fin)
            # update the interp cache from whatever this round evaluated
            f_d = jnp.where(accG, f_val, s["f_d"])
            gr_d = jnp.where(accGc, f_gr, s["gr_d"])
            f_Az_new = jnp.where(accG, s["f_Az"], f_val)
            gr_Az_new = jnp.where(accGc, s["gr_Az"], f_gr)
            # adjoint: accG -> at gr(Ax_d); halveT needing interp -> at
            # gr_Az (to build At_gz); others -> placeholder (discarded)
            gin = jnp.where(accGc, f_gr, gr_Az_new)
            Atg = vrmv(A, gin)
            Atg_d = jnp.where(accGc, Atg, s["Atg_d"])
            At_gz = jnp.where(
                (halveT & jnp.logical_not(s["abc_valid"]))[:, None]
                | halveGc | commitc,
                jnp.where(accGc, s["At_gz"], Atg),
                s["At_gz"],
            )
            cc = jnp.where(halveT & s["abc_valid"], s["c"], f_Az_new)
            bb = jnp.where(
                halveT & s["abc_valid"], s["b"],
                _vdot(s["Ax_d"], gr_Az_new) - _vdot(Az, gr_Az_new),
            )
            aa = jnp.where(
                halveT & s["abc_valid"], s["a"], s["f_d"] - bb - cc
            )
            f_T = jnp.where(
                accG, f_val,
                jnp.where(halveT, aa * tau**2 + bb * tau + cc, s["f_T"]),
            )
            gr_T = jnp.where(
                accGc, f_gr,
                jnp.where(halveT[:, None],
                          tcol * s["gr_d"] + (1 - tcol) * gr_Az_new,
                          s["gr_T"]),
            )
            Atg_T = jnp.where(
                accGc, Atg,
                jnp.where(halveT[:, None],
                          tcol * s["Atg_d"] + (1 - tcol) * At_gz,
                          s["Atg_T"]),
            )
            abc_valid = (halveT & True) | (s["abc_valid"] & in_t)
        else:
            fin = jnp.where(accGc, Ax_d,
                            jnp.where(halveT[:, None], AxT, Az))
            f_val, f_gr = vvg(f, fin)
            Atg = vrmv(A, f_gr)
            f_d = jnp.where(accG, f_val, s["f_d"])
            gr_d = jnp.where(accGc, f_gr, s["gr_d"])
            Atg_d = jnp.where(accGc, Atg, s["Atg_d"])
            f_Az_new = jnp.where((halveG | commit), f_val, s["f_Az"])
            gr_Az_new = jnp.where((halveG | commit)[:, None], f_gr,
                                  s["gr_Az"])
            f_T = jnp.where(accG | halveT, f_val, s["f_T"])
            gr_T = jnp.where((accG | halveT)[:, None], f_gr, s["gr_T"])
            Atg_T = jnp.where((accG | halveT)[:, None], Atg, s["Atg_T"])
            At_gz = s["At_gz"]
            aa, bb, cc = s["a"], s["b"], s["c"]
            abc_valid = s["abc_valid"]

        # G-mode rounds evaluated f at Az (halveG/commit): record f_Az
        if quad:
            f_Az_final = jnp.where((halveG | commit), f_val, f_Az_new)
            gr_Az_final = jnp.where((halveG | commit)[:, None], f_gr,
                                    gr_Az_new)
        else:
            f_Az_final, gr_Az_final = f_Az_new, gr_Az_new

        # tau-trial completion for accG + halveT lanes (prox slot #2 is
        # folded into the same vprox call? no — one prox per trip: the
        # halveG lanes used it above; accG/halveT lanes run theirs here.
        # Both groups are disjoint, so ONE more call keeps the per-trip
        # budget at a single prox only when no lane is in the other phase;
        # mixed batches pay two proxes (cheap elementwise) but still one
        # matvec pair.
        yT = xT - gcol * Atg_T
        zT, gzT = vprox(g, yT, gamma)
        resT = xT - zT
        fbeT = fmodel(f_T, Atg_T, resT, gamma) + gzT

        # ----------------------------------------- state transitions
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)

        new = dict(
            x_b=jnp.where(commitc, s["xT"], s["x_b"]),
            Ax_b=jnp.where(commitc, s["AxT"], s["Ax_b"]),
            f_b=jnp.where(commit, s["f_T"], s["f_b"]),
            Atg_b=jnp.where(commitc, s["Atg_T"], s["Atg_b"]),
            z_b=jnp.where(
                commitc, s["zT"], jnp.where(halveGc, zh, s["z_b"])
            ),
            gz_b=jnp.where(
                commit, s["gzT"], jnp.where(halveG, gzh, s["gz_b"])
            ),
            res_b=jnp.where(
                commitc, s["resT"], jnp.where(halveGc, res_h, s["res_b"])
            ),
            upp=jnp.where(
                commit,
                fmodel(s["f_T"], s["Atg_T"], s["resT"], gamma),
                jnp.where(halveG, upp_h, s["upp"]),
            ),
            gamma=jnp.where(halveG, gam_h, gamma),
            gamma_prev=jnp.where(accG, gamma, s["gamma_prev"]),
            in_g=jnp.where(commit | halveG, True,
                           jnp.where(accG, False, s["in_g"])),
            thr=jnp.where(accG, thr_acc, s["thr"]),
            x_d=x_d, Ax_d=Ax_d, f_d=f_d, gr_d=gr_d, Atg_d=Atg_d,
            Az=Az, f_Az=f_Az_final, gr_Az=gr_Az_final, At_gz=At_gz,
            a=aa, b=bb, c=cc, abc_valid=abc_valid,
            dstate=dstate,
            tau=tau,
            bt=jnp.where(accG, 1,
                         jnp.where(halveT, s["bt"] + 1, s["bt"])),
            xT=xT, AxT=AxT, f_T=f_T, gr_T=gr_T, Atg_T=Atg_T,
            zT=jnp.where((accG | halveT)[:, None], zT, s["zT"]),
            gzT=jnp.where(accG | halveT, gzT, s["gzT"]),
            resT=jnp.where((accG | halveT)[:, None], resT, s["resT"]),
            fbeT=jnp.where(accG | halveT, fbeT, s["fbeT"]),
            z_sol=jnp.where(commitc, s["zT"], s["z_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["z_sol"], s["k"], s["done"]

@partial(
    jax.jit,
    static_argnames=("check_every", "maxit", "max_backtracks", "directions", "dre_sign",
                     "trip_cap"),
)
def _flat_drls_run(
    f, g, x0, gamma, lam, c, tol, maxit, max_backtracks, directions,
    dre_sign, trip_cap=None, check_every=1,
):
    """Flattened batched DRLS (fixed gamma — DRLS has no adaptive mode).

    Every trip spends one uniform prox_f + prox_g slot per lane: a
    committing lane evaluates the tau=1 trial of its next iteration
    (prox_f at ``x + d``), a halving lane either evaluates its trial
    point directly (non-quadratic f) or materializes the interpolation
    endpoint ``u0 = prox_f(xbar_prev)`` on its first halving and
    interpolates afterwards (``drls.jl:172-184``); prox_g at ``2u - x``
    runs for every lane.  The quasi-Newton update happens on the commit
    trip with ``(d, res_tau1 - res_committed)`` — the reference updates at
    the tau=1 trial (``drls.jl:143-150``), which IS the commit trip here.
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    quad = is_generalized_quadratic(f)
    vprox_f = jax.vmap(
        lambda fi, u, gam: prox(unwrap_shared(fi), u, gam),
        in_axes=(batch_axes(f), 0, 0),
    )
    vprox_g = jax.vmap(
        lambda gi, u, gam: prox(unwrap_shared(gi), u, gam),
        in_axes=(batch_axes(g), 0, 0),
    )
    vinit = jax.vmap(lambda x: directions.init_state(x))
    vupdate = jax.vmap(lambda ds, s, y: directions.update(ds, s, y))
    vapply = jax.vmap(lambda ds, v: directions.apply(ds, v))
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )

    gcol = gamma[:, None]
    lcol = lam[:, None]

    def dre_of(f_u, g_v, x, u, res):
        return (
            f_u + g_v - _dot_real_unconj(x - u, res) / gamma
            + _norm_sq(res) / (2 * gamma)
        )

    def thr_of(dre, res):
        return dre_sign * dre - (c / gamma) * _norm_sq(res)

    def vdirection(dstate, res, xbar, x):
        # reference ``drls.jl:127-138``: -(H res) for quasi-Newton,
        # xbar - x (= -lam*res) for no acceleration
        return -vapply(dstate, res) if qn else xbar - x

    # --- init (iteration 1): DR quantities at x0 (``drls.jl:init``)
    u_i, f_u_i = vprox_f(f, x0, gamma)
    w_i = 2 * u_i - x0
    v_i, g_v_i = vprox_g(g, w_i, gamma)
    res_i = u_i - v_i
    xbar_i = x0 - lcol * res_i
    done0 = _inf_norm(res_i) / gamma <= tol
    thr0 = thr_of(dre_of(f_u_i, g_v_i, x0, u_i, res_i), res_i)

    # first tau=1 trial (of iteration 2's search)
    dstate0 = vinit(x0)
    d0 = vdirection(dstate0, res_i, xbar_i, x0)
    x_d0 = x0 + d0
    uT0, f_uT0 = vprox_f(f, x_d0, gamma)
    wT0 = 2 * uT0 - x_d0
    vT0, g_vT0 = vprox_g(g, wT0, gamma)
    resT0 = uT0 - vT0
    xbarT0 = x_d0 - lcol * resT0
    dreT0 = dre_of(f_uT0, g_vT0, x_d0, uT0, resT0)
    if qn:
        dstate0 = vupdate(dstate0, d0, resT0 - res_i)

    zeros_s = jnp.zeros((B,), R)
    s = dict(
        # search context
        x_d=x_d0, xbar_b=xbar_i, thr=thr0, f_u1=f_uT0,
        u0=uT0, u1=uT0, a=zeros_s, b=zeros_s, cH=zeros_s,
        abc_valid=jnp.zeros((B,), bool),
        dstate=dstate0,
        # current trial
        tau=jnp.ones((B,), R), bt=jnp.ones((B,), jnp.int32),
        xT=x_d0, uT=uT0, vT=vT0, resT=resT0, xbarT=xbarT0,
        f_uT=f_uT0, g_vT=g_vT0, dreT=dreT0,
        # outputs
        v_sol=v_i, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        accept = (dre_sign * s["dreT"] <= s["thr"]) | (
            s["bt"] > max_backtracks
        )
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        commit = accept & active
        ccol = commit[:, None]

        # --- commit-side (pre-oracle): new threshold, fresh direction
        thr_c = thr_of(s["dreT"], s["resT"])
        d_new = vdirection(s["dstate"], s["resT"], s["xbarT"], s["xT"])
        x_d_c = s["xT"] + d_new
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)

        # --- halve-side trial point
        tau_h = jnp.where(
            s["bt"] >= max_backtracks, jnp.zeros((), R), s["tau"] / 2
        )
        tcol = tau_h[:, None]
        x_h = tcol * s["x_d"] + (1 - tcol) * s["xbar_b"]

        # --- ONE uniform prox_f slot (commit: fresh tau=1 point; halving
        # quad: interpolation endpoint xbar_prev; halving non-quad: the
        # trial point itself)
        pf_in = jnp.where(ccol, x_d_c, s["xbar_b"] if quad else x_h)
        u_p, f_p = vprox_f(f, pf_in, gamma)

        if quad:
            avalid = s["abc_valid"]
            u0 = jnp.where(avalid[:, None], s["u0"], u_p)
            cH = jnp.where(avalid, s["cH"], f_p)
            bb = jnp.where(
                avalid, s["b"],
                _vdot(s["xbar_b"] - s["x_d"], s["xbar_b"] - u0) / gamma,
            )
            aa = jnp.where(avalid, s["a"], s["f_u1"] - bb - cH)
            u_trial_h = tcol * s["u1"] + (1 - tcol) * u0
            f_trial_h = aa * tau_h**2 + bb * tau_h + cH
        else:
            u0, aa, bb, cH = s["u0"], s["a"], s["b"], s["cH"]
            u_trial_h, f_trial_h = u_p, f_p

        uT = jnp.where(ccol, u_p, u_trial_h)
        f_uT = jnp.where(commit, f_p, f_trial_h)
        xT = jnp.where(ccol, x_d_c, x_h)
        wT = 2 * uT - xT
        vT, g_vT = vprox_g(g, wT, gamma)
        resT = uT - vT
        xbarT = xT - lcol * resT
        dreT = dre_of(f_uT, g_vT, xT, uT, resT)

        if qn:
            dstate_upd = vupdate(s["dstate"], d_new, resT - s["resT"])
            dstate = _bwhere(commit, dstate_upd, s["dstate"])
        else:
            dstate = s["dstate"]

        new = dict(
            x_d=jnp.where(ccol, x_d_c, s["x_d"]),
            xbar_b=jnp.where(ccol, s["xbarT"], s["xbar_b"]),
            thr=jnp.where(commit, thr_c, s["thr"]),
            f_u1=jnp.where(commit, f_p, s["f_u1"]),
            u0=jnp.where(ccol, u_p, u0),
            u1=jnp.where(ccol, u_p, s["u1"]),
            a=jnp.where(commit, jnp.zeros((), R), aa),
            b=jnp.where(commit, jnp.zeros((), R), bb),
            cH=jnp.where(commit, jnp.zeros((), R), cH),
            abc_valid=(
                jnp.logical_not(commit) if quad
                else jnp.zeros((B,), bool)
            ),
            dstate=dstate,
            tau=jnp.where(commit, jnp.ones((), R), tau_h),
            bt=jnp.where(commit, 1, s["bt"] + 1),
            xT=xT, uT=uT, vT=vT, resT=resT, xbarT=xbarT,
            f_uT=f_uT, g_vT=g_vT, dreT=dreT,
            v_sol=jnp.where(ccol, s["vT"], s["v_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["v_sol"], s["k"], s["done"]


def batched_drls(f, g, x0, gamma, lam, c, tol, maxit=1000,
                 max_backtracks=20, directions=None, dre_sign=1,
                 trip_cap=None, check_every=1):
    """Flattened batched DRLS (one prox_f + prox_g per loop trip; see
    ``_flat_drls_run``).

    ``f``/``g``: vmap-stacked function pytrees (f with accessible prox);
    ``x0``: (B, n); ``gamma``/``lam``/``c``: scalar or (B,).  Returns
    ``(v, iters, done)`` matching the single-problem ``DRLS(...)`` driver.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = jnp.asarray(x0)
    R = jnp.zeros((), x0.dtype).real.dtype
    B = x0.shape[0]
    gamma = jnp.broadcast_to(jnp.asarray(gamma, R), (B,))
    lam = jnp.broadcast_to(jnp.asarray(lam, R), (B,))
    c = jnp.broadcast_to(jnp.asarray(c, R), (B,))
    if trip_cap is not None and int(check_every) > 1:
        raise ValueError(
            "check_every > 1 cannot honor an explicit trip_cap exactly "
            "(the cap is only checked at block boundaries); set one or "
            "the other"
        )
    return _flat_drls_run(
        f, g, x0, gamma, lam, c, tol, maxit, int(max_backtracks),
        directions, int(dre_sign), trip_cap=trip_cap,
        check_every=int(check_every),
    )


@partial(
    jax.jit,
    static_argnames=("check_every", "maxit", "max_backtracks", "directions", "adaptive",
                     "estimate_gamma", "init_backtracks", "trip_cap"),
)
def _flat_panocplus_run(
    f, A, g, x0, gamma, tol, maxit, alpha, beta, max_backtracks,
    directions, adaptive, minimum_gamma, estimate_gamma=False,
    init_backtracks=40, trip_cap=None, check_every=1,
):
    """Flattened batched PANOCplus — fixed OR adaptive gamma.

    PANOCplus interleaves the gamma backtracking *inside* the tau line
    search (``panocplus.jl:168-240``), which makes it the natural fit for
    lane-flattening: every trip evaluates ONE trial per lane (full
    forward/adjoint pass at the trial point plus the ``Az`` pass the
    algorithm always needs), then each lane independently SHRINKS gamma
    (resetting its direction state and restarting its search at tau=1),
    COMMITS the trial as its next iterate, or HALVES tau.  The driver pays
    the same two matvec pairs per trial — the flat machine just stops
    paying for ``max_backtracks`` masked trials per iteration.

    The adaptive cold start (the reference's init-time
    ``backtrack_stepsize``, ``panocplus.jl:104``) runs once as a bounded
    masked fori over ``init_backtracks`` trials — waste at init only,
    never per iteration.
    """
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON

    B, n = x0.shape
    R = gamma.dtype
    eps = eps_of(x0)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions
    )
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(
            f"direction style {directions.style!r} not supported"
        )
    if qn:
        vreset = jax.vmap(lambda ds: directions.reset(ds))

    def vdirection(dstate, v):
        return -vapply(dstate, v) if qn else -v

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, alpha / gam)

    # --- init: forward_backward_init (+ adaptive gamma search) at x0
    Ax0 = vmv(A, x0)
    f0, gr0 = vvg(f, Ax0)
    Atg0 = vrmv(A, gr0)
    if estimate_gamma:
        # per-lane lower_bound_smoothness_constant (``fb_tools.jl:7-19``)
        _, gr_eps = vvg(f, vmv(A, x0 + 1))
        L_est = jnp.sqrt(_norm_sq(vrmv(A, gr_eps - gr0))) / jnp.sqrt(
            jnp.asarray(float(n), R)
        )
        gamma = alpha / L_est

    def fb_at(gam):
        gc = gam[:, None]
        y = x0 - gc * Atg0
        z, gz = vprox(g, y, gam)
        res = x0 - z
        upp = fmodel(f0, Atg0, res, gam)
        Az = vmv(A, z)
        f_Az, gr_Az = vvg(f, Az)
        return dict(gamma=gam, z=z, gz=gz, res=res, upp=upp,
                    f_Az=f_Az, gr_Az=gr_Az)

    c0 = fb_at(gamma)
    if adaptive:
        def accepted(c):
            tol_b = 10 * eps * (1 + jnp.abs(c["f_Az"]))
            return (c["f_Az"] <= c["upp"] + tol_b) | (
                c["gamma"] < minimum_gamma
            )

        def masked_trial(_, c):
            keep = accepted(c)
            new = fb_at(c["gamma"] * 0.5)
            return {k: _bwhere(keep, c[k], new[k]) for k in c}

        c0 = jax.lax.fori_loop(0, init_backtracks, masked_trial, c0)

    gamma0 = c0["gamma"]
    z0, gz0, res0 = c0["z"], c0["gz"], c0["res"]
    At_gz0 = vrmv(A, c0["gr_Az"])
    done0 = (
        _inf_norm(res0 / gamma0[:, None] - Atg0 + At_gz0) <= tol
    )
    fbe0 = c0["upp"] + gz0
    sigma0 = beta * (0.5 / gamma0) * (1 - alpha)
    thr0 = fbe0 - sigma0 * _norm_sq(res0) + 10 * eps * (1 + jnp.abs(fbe0))

    dstate0 = vinit(x0)
    s = dict(
        x_b=x0, res_b=res0, thr=thr0, gamma=gamma0, dstate=dstate0,
        d=vdirection(dstate0, res0),
        tau=jnp.ones((B,), R), bt=jnp.zeros((B,), jnp.int32),
        z_sol=z0, k=jnp.ones((B,), jnp.int32), done=done0,
        trips=jnp.asarray(0, jnp.int32),
    )

    cap = (
        maxit * (max_backtracks + 2) * (3 if adaptive else 1) + 4
        if trip_cap is None else trip_cap
    )

    def cond(s):
        return (s["trips"] < cap) & jnp.logical_not(
            jnp.all(s["done"] | (s["k"] >= maxit))
        )

    def body(s):
        active = jnp.logical_not(s["done"]) & (s["k"] < maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]
        tcol = s["tau"][:, None]

        # --- evaluate the pending trial (``panocplus.jl:178-207``)
        x_t = (1 - tcol) * (s["x_b"] - s["res_b"]) + tcol * (
            s["x_b"] + s["d"]
        )
        Ax_t = vmv(A, x_t)
        f_t, gr_t = vvg(f, Ax_t)
        Atg_t = vrmv(A, gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(g, y_t, gamma)
        res_t = x_t - z_t
        upp_t = fmodel(f_t, Atg_t, res_t, gamma)
        Az_t = vmv(A, z_t)
        f_Az_t, gr_Az_t = vvg(f, Az_t)
        At_gz_t = vrmv(A, gr_Az_t)

        # --- decide: shrink gamma / commit / halve tau
        if adaptive:
            tol_b = 10 * eps * (1 + jnp.abs(f_Az_t))
            shrink = (f_Az_t > upp_t + tol_b) & (gamma >= minimum_gamma)
        else:
            shrink = jnp.zeros((B,), bool)
        fbe_t = upp_t + gz_t
        finish = (fbe_t <= s["thr"]) | (s["bt"] >= max_backtracks)
        commit = jnp.logical_not(shrink) & finish & active
        shrink = shrink & active
        ccol = commit[:, None]

        if qn:
            dstate = _bwhere(
                commit,
                vupdate(s["dstate"], x_t - s["x_b"], res_t - s["res_b"]),
                s["dstate"],
            )
            dstate = _bwhere(shrink, vreset(dstate), dstate)
        else:
            dstate = s["dstate"]

        gamma_n = jnp.where(shrink, gamma * 0.5, gamma)
        x_b = jnp.where(ccol, x_t, s["x_b"])
        res_b = jnp.where(ccol, res_t, s["res_b"])
        sigma_n = beta * (0.5 / gamma_n) * (1 - alpha)
        thr = jnp.where(
            commit,
            fbe_t - sigma_n * _norm_sq(res_t)
            + 10 * eps * (1 + jnp.abs(fbe_t)),
            s["thr"],
        )

        fresh = commit | shrink
        d = jnp.where(
            fresh[:, None], vdirection(dstate, res_b), s["d"]
        )
        halve = jnp.logical_not(fresh) & active
        tau = jnp.where(
            fresh, jnp.ones((), R),
            jnp.where(
                halve & (s["bt"] >= max_backtracks - 1),
                jnp.zeros((), R),
                jnp.where(halve, s["tau"] / 2, s["tau"]),
            ),
        )
        bt = jnp.where(fresh, 0, jnp.where(halve, s["bt"] + 1, s["bt"]))

        newly_done = commit & (
            _inf_norm(res_t / gamma_n[:, None] - Atg_t + At_gz_t) <= tol
        )

        new = dict(
            x_b=x_b, res_b=res_b, thr=thr, gamma=gamma_n, dstate=dstate,
            d=d, tau=tau, bt=bt,
            z_sol=jnp.where(ccol, z_t, s["z_sol"]),
            k=s["k"] + commit.astype(jnp.int32),
            done=s["done"] | newly_done,
            trips=s["trips"] + 1,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["trips"] = new["trips"]
        out["done"] = new["done"]
        return out

    s = _blocked_while(cond, body, s, check_every)
    return s["z_sol"], s["k"], s["done"]


def batched_panocplus(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                      beta=0.5, max_backtracks=20, directions=None,
                      adaptive=False, minimum_gamma=1e-7,
                      init_backtracks=None, trip_cap=None, check_every=1):
    """Flattened batched PANOCplus — fixed or adaptive stepsize (see
    ``_flat_panocplus_run``).

    ``gamma``: scalar or (B,) *initial* stepsizes (for adaptive, the
    search start).  Returns ``(z, iters, done)`` matching the
    single-problem ``PANOCplus(...)`` driver per lane.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = jnp.asarray(x0)
    R = jnp.zeros((), x0.dtype).real.dtype
    B = x0.shape[0]
    estimate_gamma = gamma is None
    if estimate_gamma:
        adaptive = True  # factory semantics: estimated gamma forces adaptive
        gamma = jnp.zeros((B,), R)  # placeholder; computed in-graph
    else:
        gamma = jnp.broadcast_to(jnp.asarray(gamma, R), (B,))
    if init_backtracks is None:
        if (adaptive and not estimate_gamma
                and not isinstance(gamma, jax.core.Tracer)):
            import numpy as _np

            hi = float(_np.max(_np.asarray(gamma)))
            init_backtracks = max(
                2, int(_np.ceil(_np.log2(max(hi, minimum_gamma)
                                         / minimum_gamma))) + 2
            )
        else:
            init_backtracks = 40
    if trip_cap is not None and int(check_every) > 1:
        raise ValueError(
            "check_every > 1 cannot honor an explicit trip_cap exactly "
            "(the cap is only checked at block boundaries); set one or "
            "the other"
        )
    return _flat_panocplus_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, bool(adaptive),
        jnp.asarray(minimum_gamma, R), estimate_gamma=estimate_gamma,
        init_backtracks=int(init_backtracks), trip_cap=trip_cap,
        check_every=int(check_every),
    )


def batched_zerofpr(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                    beta=0.5, max_backtracks=20, directions=None,
                    trip_cap=None, check_every=1, adaptive=False,
                    minimum_gamma=1e-7, estimate_gamma=False):
    """Flattened batched ZeroFPR — fixed (default) or adaptive stepsize
    (one oracle evaluation per loop trip; see ``_flat_zerofpr_run`` /
    ``_flat_zerofpr_adaptive_run``).

    Same calling convention as :func:`batched_panoc`; returns
    ``(xbar, iters, done)`` matching ``ZeroFPR(...)`` per lane.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = jnp.asarray(x0)
    R = jnp.zeros((), x0.dtype).real.dtype
    gamma = jnp.broadcast_to(jnp.asarray(gamma, R), (x0.shape[0],))
    if trip_cap is not None and int(check_every) > 1:
        raise ValueError(
            "check_every > 1 cannot honor an explicit trip_cap exactly "
            "(the cap is only checked at block boundaries); set one or "
            "the other"
        )
    if adaptive:
        R = gamma.dtype
        return _flat_zerofpr_adaptive_run(
            f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
            int(max_backtracks), directions,
            jnp.asarray(minimum_gamma, R),
            estimate_gamma=bool(estimate_gamma), trip_cap=trip_cap,
            check_every=int(check_every),
        )
    return _flat_zerofpr_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, trip_cap=trip_cap,
        check_every=int(check_every),
    )


def batched_panoc(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                  beta=0.5, max_backtracks=20, directions=None,
                  trip_cap=None, check_every=1, adaptive=False,
                  minimum_gamma=1e-7, estimate_gamma=False):
    """Flattened batched PANOC — fixed (default) or adaptive stepsize
    (one oracle evaluation per loop trip; see module docstring and
    ``_flat_panoc_adaptive_run``).

    ``f``/``g``: vmap-stacked function pytrees; ``A``: vmap-stacked linop;
    ``x0``: (B, n); ``gamma``: scalar or (B,) stepsizes (for adaptive, the
    search start; ``estimate_gamma=True`` derives it per lane like the
    driver's cold start).
    Returns ``(z, iters, done)`` with per-lane accepted-iteration counts
    equal to the single-problem ``PANOC(...)`` driver's.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = jnp.asarray(x0)
    R = jnp.zeros((), x0.dtype).real.dtype
    gamma = jnp.broadcast_to(jnp.asarray(gamma, R), (x0.shape[0],))
    if trip_cap is not None and int(check_every) > 1:
        raise ValueError(
            "check_every > 1 cannot honor an explicit trip_cap exactly "
            "(the cap is only checked at block boundaries); set one or "
            "the other"
        )
    if adaptive:
        return _flat_panoc_adaptive_run(
            f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
            int(max_backtracks), directions,
            jnp.asarray(minimum_gamma, R),
            estimate_gamma=bool(estimate_gamma), trip_cap=trip_cap,
            check_every=int(check_every),
        )
    return _flat_panoc_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, trip_cap=trip_cap,
        check_every=int(check_every),
    )
