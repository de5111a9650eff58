"""Scenario batching: solve thousands of problem instances per device with vmap.

The reference solves one problem per call (SURVEY.md §2.6 — it has no
parallelism of any kind).  On an accelerator the natural "data parallelism"
for this domain is *scenario batching*: a stacked pytree of problem instances
(same shapes, different data) advanced in lockstep by one vmapped step
function, so every per-problem matvec becomes one big batched operation.

Per-problem early exit becomes a convergence mask in the while-loop carry:
converged lanes freeze (their state stops changing), the loop runs until all
lanes converge or ``maxit``, and per-lane iteration counts are returned —
exactly equivalent to running each problem alone (tested in
``tests/test_batch.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.shared import Shared, batch_axes, unwrap_shared


def stack_iterations(iterations):
    """Stack identically-structured iteration objects into one batched
    iteration (leaves gain a leading batch axis; static fields must agree).

    Shared-marked subtrees cannot be stacked: stacking B copies inside a
    Shared wrapper would batch data the drivers then treat as
    lane-invariant.  Build the batched iteration through one factory call
    with stacked kwargs (or :class:`BatchedAlgorithm`) instead."""
    iterations = list(iterations)  # accept generators; guard loop below
    for it in iterations:
        if any(
            isinstance(n, Shared)
            for n in jax.tree.leaves(
                it, is_leaf=lambda x: isinstance(x, Shared)
            )
        ):
            raise ValueError(
                "stack_iterations cannot stack Shared-marked problem data; "
                "call the factory once with stacked kwargs and keep the "
                "Shared operand outside the stack (see BatchedAlgorithm)"
            )
    return jax.tree.map(lambda *ls: jnp.stack(ls), *iterations)


def broadcast_hyperparams(iteration):
    """Normalize a batched iteration's leaves against the batch axis.

    * rank-0 leaves (factory-materialized hyperparameters like
      ``gamma``/``alpha``) are broadcast to ``(B,)``;
    * rank>=1 leaves whose leading dimension is NOT the batch size are
      wrapped in :class:`Shared` — the same lane-invariant convention the
      kernel dispatch applies to a bare 2-D ``A`` — so an unstacked operand
      (a shared design matrix, per-coordinate ``lam`` weights, ...) rides
      ``in_axes=None`` instead of crashing the vmap;
    * leaves already under a Shared marker stay untouched.

    The batch size comes from ``iteration.x0`` (always stacked ``(B, ...)``)
    when present; auto-Shared wrapping happens ONLY in that case — when x0
    is absent (or itself Shared) B falls back to the first non-Shared array
    leaf, which cannot distinguish an unstacked operand from the batch
    axis, so only the rank-0 broadcast is applied.  A lane-invariant leaf
    whose leading dim *coincidentally* equals B is indistinguishable from a
    stacked one — wrap it in ``Shared`` explicitly to disambiguate (and
    note the flip side: a mis-sliced per-lane leaf with the wrong leading
    dim is treated as lane-invariant rather than raising vmap's axis-size
    error)."""
    B = None
    x0 = getattr(iteration, "x0", None)
    # x0 may itself be a pytree (tuple iterates: Davis-Yin product spaces,
    # robust PCA) — infer B from its first non-Shared ARRAY LEAF, never
    # from the container (jnp.shape on a tuple would misread its length)
    x0_leaves = [] if x0 is None else [
        l for l in jax.tree.leaves(
            x0, is_leaf=lambda v: isinstance(v, Shared)
        ) if not isinstance(l, Shared)
    ]
    b_from_x0 = bool(x0_leaves) and jnp.ndim(x0_leaves[0]) > 0
    if b_from_x0:
        B = jnp.shape(x0_leaves[0])[0]
    else:
        for leaf in jax.tree.leaves(
            iteration, is_leaf=lambda x: isinstance(x, Shared)
        ):
            if not isinstance(leaf, Shared) and jnp.ndim(leaf) > 0:
                B = jnp.shape(leaf)[0]
                break
    if B is None:
        return iteration

    def fix(l):
        if isinstance(l, Shared):
            return l
        if jnp.ndim(l) == 0:
            return jnp.broadcast_to(l, (B,))
        if b_from_x0 and jnp.shape(l)[0] != B:
            return Shared(l)
        return l

    return jax.tree.map(
        fix, iteration, is_leaf=lambda x: isinstance(x, Shared)
    )


def _lane_finite(state):
    """(B,) bool per lane: every floating/complex leaf of the lane's state
    is finite.  One cheap reduction pass over the state pytree (the state
    is iterate-sized; the operators live in the iteration, not here).

    A state with no inexact leaves (nothing that *can* be non-finite) is
    vacuously all-finite: returns a scalar True, which broadcasts cleanly
    against the (B,) masks at both call sites."""
    ok = None
    for leaf in jax.tree.leaves(state):
        arr = jnp.asarray(leaf)
        if not jnp.issubdtype(arr.dtype, jnp.inexact):
            continue
        # exact per-element check (an abs-sum would overflow on large
        # but finite states and falsely kill healthy lanes)
        ok_l = jnp.all(jnp.isfinite(arr), axis=tuple(range(1, arr.ndim)))
        ok = ok_l if ok is None else ok & ok_l
    if ok is None:
        return jnp.asarray(True)
    return ok


def _freeze(done, old, new):
    """Per-lane select: lanes with done=True keep their old state."""
    def sel(o, n):
        mask = done.reshape(done.shape + (1,) * (n.ndim - done.ndim))
        return jnp.where(mask, o, n)

    return jax.tree.map(sel, old, new)


@partial(jax.jit, static_argnames=("stop", "check_every", "verbose",
                                   "freq", "halt_nonfinite"))
def _chunk_loop(iteration, state, k0, done, iters, chunk, maxit, tol,
                stop=None, check_every=1, verbose=False, freq=100,
                halt_nonfinite=False):
    """Advance a batch up to ``chunk`` iterations (or all-done/maxit) with
    per-lane freezing — the one shared core of both batched drivers.

    ``stop=None`` (the common case) keeps the jit cache key stable across
    calls; the default criterion is resolved inside the traced function.

    ``halt_nonfinite=True`` adds per-lane divergence detection (SURVEY §5
    failure detection, a batching hazard the reference cannot have):
    a lane whose state turns non-finite (e.g. a wrong user ``Lf``
    diverging one problem of the batch) is declared DEAD — frozen at its
    last finite state, ``done=False``, excluded from the all-lanes exit
    condition — so one diverged lane no longer burns the whole batch to
    ``maxit``.  Returns a 5th output ``dead`` in this mode.  Off by
    default: the finite check is one cheap pass over the state per step,
    but the semantics contract ("counts equal the single driver's") is
    cleanest without it.

    ``check_every=K`` runs K steps per while-loop trip — amortizing the
    fixed per-trip cost exactly like the kernels' iteration blocking.
    Blocking is semantically EXACT (round 4; it used to freeze lanes only
    at block boundaries): every inner step masks its update on the
    per-lane ``done`` flags, the way the flat line-search machines do, so
    per-lane counts and solutions equal K=1's at any K.  The price is one
    ``vstop`` evaluation and pytree select per inner step, both on-device
    and far below the per-trip fixed cost.
    """
    if stop is None:
        stop = lambda it, tol, s: it.default_stopping_criterion(tol, s)
    # Shared-marked problem data is lane-invariant: map it with
    # in_axes=None so XLA sees the operand once (per-lane matvecs against a
    # Shared operator lower to ONE (B,n)@(n,m) matmul instead of a
    # batched GEMV stream).  batch_axes depends only on the treedef, so it
    # is trace-time static here.  unwrap_shared strips per-leaf Shared
    # markers inside the lane functions: vmap passes Shared nodes through
    # unbatched, and a Shared-wrapped raw array must be a plain array by
    # the time the iteration's math touches it.
    it_axes = batch_axes(iteration)
    vstep = jax.vmap(lambda it, s: unwrap_shared(it).step(s),
                     in_axes=(it_axes, 0))
    vstop = jax.vmap(lambda it, s: stop(unwrap_shared(it), tol, s),
                     in_axes=(it_axes, 0))
    K = check_every

    def cond(carry):
        k, s, done, dead, iters = carry
        return (
            (k < k0 + chunk)
            & (k < maxit)
            & jnp.logical_not(jnp.all(done | dead))
        )

    def one_step(carry):
        k, s, done, dead, iters = carry
        # scalar maxit gate: matches K=1's while-cond exactly, so a block
        # that straddles maxit cannot step (or count) past it
        hit_max = k >= maxit
        frozen = done | dead | hit_max
        s_new = _freeze(frozen, s, vstep(iteration, s))
        k = jnp.where(hit_max, k, k + 1)
        if halt_nonfinite:
            # a lane whose step produced a non-finite state dies AND rolls
            # back to its pre-step (last finite) iterate — the returned
            # "solution" of a dead lane is always finite
            newly_dead = ~frozen & ~_lane_finite(s_new)
            dead = dead | newly_dead
            s_new = _freeze(newly_dead, s, s_new)
        newly_done = vstop(iteration, s_new)
        iters = jnp.where(frozen, iters, k)
        done = done | (newly_done & ~dead)
        return (k, s_new, done, dead, iters)

    def body(carry):
        if K == 1:
            k, s, done, dead, iters = one_step(carry)
        else:
            # exact masked K-block: every inner step freezes done lanes,
            # so counts/solutions equal K=1's (the flat machines'
            # frozen-lane contract, extended to the generic driver)
            k, s, done, dead, iters = jax.lax.fori_loop(
                0, K, lambda _, c: one_step(c), carry
            )
        if verbose:
            # batched analogue of the reference's per-freq display rows
            # (``ProximalAlgorithms.jl:118-121``): progress is the number
            # of converged lanes, printed from inside the jitted loop
            jax.lax.cond(
                k % freq < K,
                lambda: jax.debug.print(
                    "{:6d} | {:6d}/%d lanes converged" % done.shape[0],
                    k, jnp.sum(done),
                ),
                lambda: None,
            )
        return (k, s, done, dead, iters)

    dead0 = jnp.zeros_like(done)
    if halt_nonfinite:
        dead0 = dead0 | ~_lane_finite(state)
    k, state, done, dead, iters = jax.lax.while_loop(
        cond, body, (k0, state, done, dead0, iters)
    )
    iters = jnp.minimum(jnp.where(done | dead, iters, k), maxit)
    if halt_nonfinite:
        return k, state, done, iters, dead
    return k, state, done, iters


@partial(jax.jit, static_argnames=("stop", "solution", "check_every",
                                   "verbose", "freq", "halt_nonfinite"))
def batched_run_loop(iteration, maxit, tol, stop=None, solution=None,
                     check_every=1, verbose=False, freq=100,
                     halt_nonfinite=False):
    """Run a batched iteration until every lane converges (or maxit).

    ``iteration`` is a stacked pytree (leading batch axis on every leaf).
    Lane-invariant problem data should be wrapped in
    :class:`~proxtpu.utils.shared.Shared` instead of being materially
    stacked — a Shared operator's matvec lowers to one matmul across
    the whole batch.  Returns ``(solutions, iters, done)`` where
    ``iters[i]`` is the iteration count at which lane ``i`` converged
    (``maxit`` cap applies), matching the single-problem driver's count.

    ``check_every=K`` runs K steps per while-loop trip, amortizing the
    fixed per-loop-trip cost (the same iteration-blocking trade the fused
    kernels make).  Blocking is EXACT at any K (round 4): every inner step
    is masked on the per-lane ``done`` flags, so counts and solutions
    equal K=1's (see :func:`_chunk_loop`).

    ``halt_nonfinite=True`` (round 4, SURVEY §5 failure detection): a
    lane whose state turns non-finite (a diverging problem — e.g. a wrong
    user ``Lf``) is frozen at its last finite iterate and excluded from
    the all-lanes exit condition, so one diverged lane no longer burns
    the whole batch to ``maxit``.  Dead lanes report ``done=False`` with
    ``iters`` = the iteration at which they died.
    """
    stop_ = stop or (lambda it, tol, s: it.default_stopping_criterion(tol, s))
    solution_ = solution or (lambda it, s: it.default_solution(s))

    iteration = broadcast_hyperparams(iteration)
    it_axes = batch_axes(iteration)
    state = jax.vmap(
        lambda it: unwrap_shared(it).init(), in_axes=(it_axes,)
    )(iteration)
    done0 = jax.vmap(
        lambda it, s: stop_(unwrap_shared(it), tol, s), in_axes=(it_axes, 0)
    )(iteration, state)
    B = done0.shape[0]
    out = _chunk_loop(
        iteration, state, jnp.asarray(1, jnp.int32), done0,
        jnp.ones((B,), jnp.int32), maxit, maxit, tol, stop=stop,
        check_every=check_every, verbose=verbose, freq=freq,
        halt_nonfinite=halt_nonfinite,
    )
    k, state, done, iters = out[:4]
    return (
        jax.vmap(
            lambda it, s: solution_(unwrap_shared(it), s),
            in_axes=(it_axes, 0),
        )(iteration, state),
        iters,
        done,
    )


@partial(jax.jit, static_argnames=("maxit", "record", "record_every",
                                   "stop", "solution"))
def batched_run_recorded(iteration, maxit, tol, record, record_every=1,
                         stop=None, solution=None):
    """Batched solve with per-lane on-device history: returns
    ``(solutions, iters, done, RecordedTrace)``.

    The batched counterpart of
    :func:`proxtpu.algorithms.core.run_loop_recorded`:
    ``record(iteration, k, state) -> pytree`` is evaluated per lane (vmapped,
    Shared-aware) every ``record_every`` iterations, so every trace leaf
    gains a leading ``(slots, B)`` time-by-lane block — per-lane convergence
    curves for a whole sweep in one compiled loop, no host round-trips.

    Semantics are the exact ``check_every=1`` batched driver: converged
    lanes freeze, so their recorded values plateau at the frozen state from
    their convergence slot onward; ``trace.count`` is the number of slots
    written globally (the slowest lane's progress), and slot ``j`` of lane
    ``i`` is meaningful for iterations up to ``iters[i]``.  ``maxit`` and
    ``record_every`` are static (they size the buffers).
    """
    from ..algorithms.core import (  # local: avoid a circular import
        RecordedTrace, _trace_buffers, _trace_write,
    )

    stop_ = stop or (lambda it, tol, s: it.default_stopping_criterion(tol, s))
    solution_ = solution or (lambda it, s: it.default_solution(s))

    iteration = broadcast_hyperparams(iteration)
    it_axes = batch_axes(iteration)
    state = jax.vmap(
        lambda it: unwrap_shared(it).init(), in_axes=(it_axes,)
    )(iteration)
    vstep = jax.vmap(lambda it, s: unwrap_shared(it).step(s),
                     in_axes=(it_axes, 0))
    vstop = jax.vmap(lambda it, s: stop_(unwrap_shared(it), tol, s),
                     in_axes=(it_axes, 0))
    vrecord = jax.vmap(
        lambda it, k, s: record(unwrap_shared(it), k, s),
        in_axes=(it_axes, None, 0),
    )

    done0 = vstop(iteration, state)
    B = done0.shape[0]
    slots = maxit // record_every
    vals_shape = jax.eval_shape(
        lambda s: vrecord(iteration, jnp.asarray(1, jnp.int32), s), state
    )
    buf = _trace_buffers(slots, vals_shape)
    k_init = jnp.asarray(1, jnp.int32)
    buf = _trace_write(
        buf, vrecord(iteration, k_init, state), k_init, record_every
    )

    def cond(carry):
        k, s, done, iters, _ = carry
        return (k < maxit) & jnp.logical_not(jnp.all(done))

    def body(carry):
        k, s, done, iters, b = carry
        s = _freeze(done, s, vstep(iteration, s))
        k = k + 1
        b = _trace_write(b, vrecord(iteration, k, s), k, record_every)
        newly_done = vstop(iteration, s)
        iters = jnp.where(done, iters, k)
        done = done | newly_done
        return (k, s, done, iters, b)

    k, state, done, iters, buf = jax.lax.while_loop(
        cond, body, (k_init, state, done0, jnp.ones((B,), jnp.int32), buf)
    )
    iters = jnp.minimum(jnp.where(done, iters, k), maxit)
    trace = RecordedTrace(
        values=jax.tree.map(lambda b: b[:slots], buf),
        count=k // record_every,
    )
    return (
        jax.vmap(
            lambda it, s: solution_(unwrap_shared(it), s),
            in_axes=(it_axes, 0),
        )(iteration, state),
        iters,
        done,
        trace,
    )


# axes are recomputed at trace time from the treedef (which keys the jit
# cache), so Shared-containing iterations get their in_axes=None for free
@jax.jit
def _default_vinit(it):
    return jax.vmap(
        lambda i: unwrap_shared(i).init(), in_axes=(batch_axes(it),)
    )(it)


@jax.jit
def _default_vstop(it, tol, s):
    return jax.vmap(
        lambda i, t, u: unwrap_shared(i).default_stopping_criterion(t, u),
        in_axes=(batch_axes(it), None, 0),
    )(it, tol, s)


@jax.jit
def _default_vsol(it, s):
    return jax.vmap(
        lambda i, u: unwrap_shared(i).default_solution(u),
        in_axes=(batch_axes(it), 0),
    )(it, s)


def batched_run_segments(iteration, maxit, tol, *, segment, stop=None,
                         solution=None, callback=None, resume=None):
    """Segmented batched run: checkpoint/resume for long batched sweeps.

    Semantically identical to :func:`batched_run_loop` (the same
    ``_chunk_loop`` core advances the batch, so per-lane counts and
    solutions match exactly), but the while loop is cut into host-level
    segments of ``segment`` iterations.  After each segment ``callback``
    (if given) receives a snapshot dict — pass it to
    :func:`proxtpu.utils.checkpoint.save_state` to persist a long run;
    ``resume=snapshot`` restarts exactly where a previous run stopped.

    Costs one host sync per segment — size segments accordingly.

    The snapshot layout is ``{"state": <batched state pytree>,
    "k": int, "done": (B,) bool, "iters": (B,) int32}``.

    Returns ``(solutions, iters, done)`` like ``batched_run_loop``.
    """
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    stop_ = stop or (lambda it, tol, s: it.default_stopping_criterion(tol, s))
    solution_ = solution or (lambda it, s: it.default_solution(s))

    iteration = broadcast_hyperparams(iteration)
    it_axes = batch_axes(iteration)

    if resume is None:
        state = jax.vmap(
            lambda it: unwrap_shared(it).init(), in_axes=(it_axes,)
        )(iteration)
        done = jax.vmap(
            lambda it, s: stop_(unwrap_shared(it), tol, s),
            in_axes=(it_axes, 0),
        )(iteration, state)
        k = jnp.asarray(1, jnp.int32)
        iters = jnp.ones(done.shape, jnp.int32)
    else:
        state = resume["state"]
        k = jnp.asarray(resume["k"], jnp.int32)
        done = jnp.asarray(resume["done"])
        iters = jnp.asarray(resume["iters"], jnp.int32)

    while True:
        k, state, done, iters = _chunk_loop(
            iteration, state, k, done, iters, segment, maxit, tol, stop,
        )
        done_h = np.asarray(done)  # the per-segment host sync
        k_h = int(k)
        if callback is not None:
            callback({"state": state, "k": k_h, "done": done,
                      "iters": iters})
        if done_h.all() or k_h >= maxit:
            break

    return (
        jax.vmap(
            lambda it, s: solution_(unwrap_shared(it), s),
            in_axes=(it_axes, 0),
        )(iteration, state),
        iters,
        done,
    )


def _bucket(n, min_batch):
    b = max(min_batch, 1)
    while b < n:
        b *= 2
    return b


def compacting_batched_run(
    iteration, maxit, tol, stop=None, solution=None, chunk=256, min_batch=8
):
    """Batched run with lane compaction: after every ``chunk`` iterations,
    converged lanes are retired and the remaining lanes are gathered into a
    smaller (power-of-two-padded) batch, so a heavy convergence tail runs on
    a shrinking problem set instead of dragging the whole batch.

    Semantically identical to :func:`batched_run_loop` (per-lane solutions
    and iteration counts match exactly); each distinct bucket size compiles
    the chunk loop once.  One host sync per chunk.
    """
    # module-level jitted defaults keep the compile cache stable across calls
    vsol = _default_vsol if solution is None else jax.jit(
        lambda it, s: jax.vmap(
            lambda i, u: solution(unwrap_shared(i), u),
            in_axes=(batch_axes(it), 0),
        )(it, s)
    )
    vstop0 = _default_vstop if stop is None else jax.jit(
        lambda it, tol, s: jax.vmap(
            lambda i, t, u: stop(unwrap_shared(i), t, u),
            in_axes=(batch_axes(it), None, 0),
        )(it, tol, s)
    )

    iteration = broadcast_hyperparams(iteration)
    state = _default_vinit(iteration)
    done = vstop0(iteration, tol, state)
    B = done.shape[0]

    out_solution = None  # allocated from the first retired batch
    out_iters = np.zeros(B, np.int32)
    out_done = np.zeros(B, bool)
    lane_ids = np.arange(B)
    iters = jnp.ones(done.shape, jnp.int32)
    k0 = jnp.asarray(1, jnp.int32)

    active_iter, active_state = iteration, state
    while True:
        k0, active_state, done, iters = _chunk_loop(
            active_iter, active_state, k0, done, iters, chunk, maxit, tol,
            stop,
        )
        done_h = np.asarray(done)
        k_h = int(k0)
        finished = done_h | (k_h >= maxit)
        if finished.any():
            sols = vsol(active_iter, active_state)
            sols_h = jax.tree.map(np.asarray, sols)
            iters_h = np.asarray(iters)
            if out_solution is None:
                out_solution = jax.tree.map(
                    lambda l: np.zeros((B,) + l.shape[1:], l.dtype), sols_h
                )
            sel = np.nonzero(finished & (lane_ids >= 0))[0]
            ids = lane_ids[sel]
            out_solution = jax.tree.map(
                lambda o, l: (o.__setitem__(ids, l[sel]), o)[1],
                out_solution, sols_h,
            )
            out_iters[ids] = iters_h[sel]
            out_done[ids] = done_h[sel]
        live = np.nonzero(~finished)[0]
        if live.size == 0 or k_h >= maxit:
            break
        bucket = _bucket(live.size, min_batch)
        # pad by repeating the first live lane; padded lanes are marked done
        # so they freeze immediately and are never written back
        pad = np.concatenate([live, np.full(bucket - live.size, live[0])])
        take = lambda l: l[pad]
        # Shared subtrees are lane-invariant: they pass through compaction
        # untouched (no batch axis to gather)
        active_iter = jax.tree.map(
            lambda l: l if isinstance(l, Shared) else take(l),
            active_iter, is_leaf=lambda x: isinstance(x, Shared),
        )
        active_state = jax.tree.map(take, active_state)
        iters = iters[pad]
        done = jnp.asarray(
            np.concatenate(
                [np.zeros(live.size, bool), np.ones(bucket - live.size, bool)]
            )
        )
        # padding slots get a sentinel id so their stale copies are never
        # written back over the real lane's result
        lane_ids = np.concatenate(
            [lane_ids[live], np.full(bucket - live.size, -1)]
        )

    return (
        jax.tree.map(jnp.asarray, out_solution),
        jnp.asarray(out_iters),
        jnp.asarray(out_done),
    )


def _default_backtrack_limit(kwargs):
    """Trip budget for the bounded masked gamma-search: enough halvings to
    reach either Armijo acceptance or the ``minimum_gamma`` floor (at which
    the search accepts unconditionally, like the reference's
    ``fb_tools.jl:24-63``), i.e. ``ceil(log2(gamma0 / minimum_gamma))``.

    ``gamma0`` is resolved statically from ``gamma`` / ``1/Lf`` when
    concrete; otherwise (cold-start Lipschitz estimate, traced values) the
    floor-reaching budget is unknown and the historical default of 32 is
    kept — never lowered, so problems within 2^32 halvings of the floor are
    always searched to acceptance.  +4 slack covers ``increase_gamma``
    regret-rule excursions above ``gamma0``.
    """
    import math

    min_g = float(kwargs.get("minimum_gamma") or 1e-7)
    g0 = None
    try:
        if kwargs.get("gamma") is not None:
            g0 = float(np.max(np.asarray(kwargs["gamma"])))
        elif kwargs.get("Lf") is not None:
            g0 = 1.0 / float(np.min(np.asarray(kwargs["Lf"])))
    except Exception:  # traced / non-concrete
        g0 = None
    if g0 is None or g0 <= 0 or min_g <= 0:
        return 32
    return max(32, int(math.ceil(math.log2(max(g0 / min_g, 1.0)))) + 4)


class BatchedAlgorithm:
    """Batched counterpart of :class:`~proxtpu.algorithms.core.IterativeAlgorithm`.

    Construct from a solver factory's iteration maker, call with *stacked*
    problem kwargs (leading batch axis on every array):

        solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                                  maxit=1000, tol=1e-6)
        xs, iters, done = solver(x0=X0, f=batched_f, g=batched_g, Lf=Lfs)

    Non-batched kwargs are broadcast by the factory itself when scalar.

    ``verbose=True`` prints a progress row every ``freq`` iterations
    (iteration count + converged-lane count, via ``jax.debug.print``) —
    the batched analogue of the reference driver's verbose/freq contract;
    it forces the generic driver (the kernel fast paths have no display
    hook).

    ``use_kernels="auto"`` (default) routes recognized problem shapes —
    batched lasso FISTA, the shared-A lasso path, batched box-QP projected
    gradient, batched TV denoising and the flat line-search machines, with
    all options at defaults — to their specialized batched solvers
    (:mod:`proxtpu.kernels.dispatch`); the distinct-A lasso step there is
    the fused GPU kernel for float32 on a GPU.  Anything unrecognized runs
    the generic vmapped driver.  Pass ``use_kernels=False`` to force the
    generic path (exact per-lane count parity with single solves), or
    ``use_kernels="interpret"`` to run the lasso kernel in Pallas
    interpret mode on CPU.
    """

    def __init__(self, iteration_factory, *, maxit, tol, stop=None,
                 solution=None, use_kernels="auto", check_every=None,
                 verbose=False, freq=100, halt_nonfinite=False, **kwargs):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop
        self.solution = solution
        self.use_kernels = use_kernels
        # iteration block for the generic driver: the fixed per-trip cost
        # (op sequencing + convergence reduction + freeze) rivals the step
        # itself, so K>1 amortizes it.  Blocking does not change per-lane
        # counts: the generic driver masks every inner step on done (like
        # the flat machines); the specialized solvers ignore it (they have
        # their own iter_block policy).  None = auto: K=8 on both the
        # generic driver and the flat adaptive machine; +-1 knife-edge
        # count drift is possible from recompilation — pass
        # check_every=1 for strict count parity.
        self.check_every = check_every
        # batched analogue of the reference's verbose/freq contract: a
        # per-freq progress row (converged-lane count) from the generic
        # driver; the kernel fast paths have no display hook, so verbose
        # also disables kernel routing
        self.verbose = verbose
        self.freq = freq
        # per-lane divergence detection (generic driver only — the kernel
        # fast paths have no dead-lane carry, so the flag disables kernel
        # routing like verbose does); see batched_run_loop
        self.halt_nonfinite = halt_nonfinite
        self.kwargs = kwargs

    def _inject_backtrack_limit(self, merged):
        """Default ``backtrack_limit`` in ``merged`` (in place) when the
        iteration factory accepts one and the caller did not set it — the
        single injection policy shared by ``__call__`` and
        ``run_recorded`` (generic-path batched contexts lower bounded
        searches to their fixed-trip masked form; see ``__call__``)."""
        import inspect

        if "backtrack_limit" not in merged:
            try:
                params = inspect.signature(self.iteration_factory).parameters
            except (TypeError, ValueError):
                params = {}
            if "backtrack_limit" in params:
                merged["backtrack_limit"] = _default_backtrack_limit(merged)

    def __call__(self, **kwargs):
        import inspect

        merged = {**self.kwargs, **kwargs}
        # fast-path gate (round-5 review): if the caller passed a kwarg
        # the factory does not accept, a matcher could recognize the
        # problem STRUCTURE and silently drop the option (e.g. ``A=`` on
        # DRLS would solve the A-less problem) — skip the fast path so
        # the generic driver raises the factory's own TypeError instead
        try:
            params = inspect.signature(self.iteration_factory).parameters
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
            unknown_kwargs = not has_var_kw and any(
                k not in params for k in merged
            )
        except (TypeError, ValueError):
            unknown_kwargs = False
        if (self.use_kernels and not unknown_kwargs
                and not self.verbose and not self.halt_nonfinite):
            from ..kernels.dispatch import (
                match_flat_adaptive,
                match_flat_linesearch,
                match_kernel_solver,
                match_tv_solver,
            )

            interp = True if self.use_kernels == "interpret" else None
            run = match_kernel_solver(
                self.iteration_factory, merged,
                tol=self.tol, maxit=self.maxit,
                stop=self.stop, solution=self.solution,
                interpret=interp,
            )
            if run is None:
                run = match_tv_solver(
                    self.iteration_factory, merged,
                    tol=self.tol, maxit=self.maxit,
                    stop=self.stop, solution=self.solution,
                )
            if run is None:
                run = match_flat_adaptive(
                    self.iteration_factory, merged,
                    tol=self.tol, maxit=self.maxit,
                    stop=self.stop, solution=self.solution,
                    # blocking is exact on the flat machines; the
                    # adaptive trips are cheap, so block 8 of them
                    check_every=self.check_every or 8,
                )
            if run is None:
                run = match_flat_linesearch(
                    self.iteration_factory, merged,
                    tol=self.tol, maxit=self.maxit,
                    stop=self.stop, solution=self.solution,
                    # None = per-route auto (the matcher picks K=8 for
                    # the adaptive PANOC machine, K=1 elsewhere).
                    # Blocking is semantically exact (bit-identical on
                    # CPU); recompilation can flip knife-edge accepts
                    # (counts +-1) — pass check_every=1 for strict count
                    # parity.
                    check_every=self.check_every,
                )
            if run is not None:
                return run()
        # generic-path batched context: default every bounded search
        # (gamma-backtracking, tau-linesearch) to its fixed-trip masked
        # lowering — a nested while_loop under vmap can compile very
        # slowly, while the bounded form compiles in seconds and runs the
        # same search.  An explicit backtrack_limit
        # (including None) wins — and because it is injected AFTER the
        # dispatch attempts, the matchers see backtrack_limit only when the
        # USER provided it (they fall back then: the flat machines always
        # search to acceptance and cannot honor a truncated search).
        self._inject_backtrack_limit(merged)
        iteration = self.iteration_factory(**merged)
        # batched_run_loop broadcasts rank-0 hyperparameters itself.
        # auto check_every = 8: the masked K-block is exact, so blocking
        # the generic driver is free semantically
        return batched_run_loop(
            iteration, self.maxit, self.tol, stop=self.stop,
            solution=self.solution, check_every=self.check_every or 8,
            verbose=self.verbose, freq=self.freq,
            halt_nonfinite=self.halt_nonfinite,
        )

    def run_recorded(self, record, record_every=1, **kwargs):
        """Batched solve with per-lane on-device history: returns
        ``(solutions, iters, done, RecordedTrace)``.

        Always takes the generic vmapped driver (the kernel fast paths have
        no record hook — recording is a diagnostics mode), with the same
        bounded-search injection as ``__call__`` so line-search algorithms
        stay batchable.  See :func:`batched_run_recorded`.
        """
        merged = {**self.kwargs, **kwargs}
        self._inject_backtrack_limit(merged)
        iteration = self.iteration_factory(**merged)
        return batched_run_recorded(
            iteration, self.maxit, self.tol, record,
            record_every=record_every, stop=self.stop,
            solution=self.solution,
        )


def batch_problems(factory, problem_list):
    """Build a batched iteration from a list of per-problem kwargs dicts
    (each must produce an identically-structured iteration)."""
    return stack_iterations([factory(**kw) for kw in problem_list])
