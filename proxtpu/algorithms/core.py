"""Generic solver driver: jitted while-loop over pure init/step iterations.

JAX counterpart of ``IterativeAlgorithm``
(``/root/reference/src/ProximalAlgorithms.jl:58-123``).  The reference's
``for (k, state) in enumerate(iter)`` hot loop becomes a single
``lax.while_loop`` compiled once per problem *shape*; the state is a pytree
carry, stopping criteria are traced predicates, and verbose display goes
through ``jax.debug.print`` so it costs nothing when off.

The two-stage UX is preserved exactly: options at construction
(``solver = ForwardBackward(tol=1e-4)``), problem at call
(``x, it = solver(x0=x0, f=f, g=g, Lf=Lf)``), with call-site kwargs
overriding construction kwargs (``ProximalAlgorithms.jl:114-115``).

Iteration objects are frozen pytree dataclasses: array-valued fields (the
problem data) are traced leaves, booleans/strategies are static.  Each
iteration class provides:

* ``init() -> state`` and ``step(state) -> state`` (pure);
* ``default_stopping_criterion(tol, state)``, ``default_solution(state)``,
  ``default_display(k, state)``.

Because ``init``/``step`` are pure, power users can drive them manually (the
iterator-only usage of ``docs/src/guide/getting_started.jl:136-152``) via
:func:`states`, and whole solves batch with ``vmap`` (see
:mod:`proxtpu.parallel.batch`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


def _default_stop(iteration, tol, state):
    return iteration.default_stopping_criterion(tol, state)


def _default_solution(iteration, state):
    return iteration.default_solution(state)


def _default_display(k, iteration, state):
    iteration.default_display(k, state)


@partial(
    jax.jit,
    static_argnames=(
        "stop", "solution", "verbose", "freq", "display", "check_every",
    ),
)
def run_loop(iteration, maxit, tol, stop, solution, verbose, freq, display,
             initial_state=None, k0=1, check_every=1):
    """Run an iteration to convergence; returns (solution, iteration_count).

    Matches the reference loop semantics: the initial state counts as
    iteration 1, and the loop exits as soon as ``k >= maxit`` or the stopping
    criterion holds at state k.

    ``initial_state`` resumes from a previously captured state pytree
    (checkpoint/resume — the reference has none, SURVEY.md §5, but its
    all-state-in-one-struct design makes it natural; here the state is a
    pytree, so it round-trips through orbax/pickle for free).  ``k0`` is the
    iteration number of ``initial_state`` (the count a previous segment
    returned): the counter continues from there, so ``maxit`` bounds the
    *overall* solve and the returned count is the total across segments —
    not per-segment.

    ``check_every=K`` runs K steps per ``while_loop`` trip, amortizing the
    fixed per-trip cost (loop control and the host's read of the
    condition — iteration-bound single solves are trip-bound).  Blocking is
    semantically EXACT: each inner step is masked on a ``done`` flag, so
    iteration counts and solutions equal ``check_every=1``'s — at the price
    of one extra ``stop`` evaluation and pytree select per inner step (both
    on-device, far below the per-trip cost).  At most ``K - 1`` masked
    no-op steps run after convergence.  As with the flat machines, an
    accelerator's recompilation can flip knife-edge accepts (counts ±1, last-ULP
    solution drift); CPU is bit-identical (pinned in tests).
    """
    state = iteration.init() if initial_state is None else initial_state
    k_init = jnp.asarray(k0, jnp.int32)

    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")

    if check_every == 1:

        def cond(carry):
            k, s = carry
            return (k < maxit) & jnp.logical_not(stop(iteration, tol, s))

        def body(carry):
            k, s = carry
            s = iteration.step(s)
            k = k + 1
            if verbose:
                jax.lax.cond(
                    k % freq == 0,
                    lambda: display(k, iteration, s),
                    lambda: None,
                )
            return (k, s)

        k, state = jax.lax.while_loop(cond, body, (k_init, state))
    else:
        done0 = (k_init >= maxit) | stop(iteration, tol, state)

        def inner(_, carry):
            k, s, done = carry
            ran = jnp.logical_not(done)
            s_new = iteration.step(s)
            s = jax.tree.map(
                lambda old, new: jnp.where(done, old, new), s, s_new
            )
            k = jnp.where(done, k, k + 1)
            done = done | (k >= maxit) | stop(iteration, tol, s)
            if verbose:
                # same cadence as K=1: a step that actually ran displays
                # at k % freq == 0, even if it just converged
                jax.lax.cond(
                    ran & (k % freq == 0),
                    lambda: display(k, iteration, s),
                    lambda: None,
                )
            return (k, s, done)

        k, state, _ = jax.lax.while_loop(
            lambda c: jnp.logical_not(c[2]),
            lambda c: jax.lax.fori_loop(0, check_every, inner, c),
            (k_init, state, done0),
        )
    if verbose:
        display(k, iteration, state)
    return solution(iteration, state), k


class RecordedTrace(NamedTuple):
    """On-device iteration history returned by :func:`run_loop_recorded`.

    ``values`` is the pytree ``record`` returned, with a leading time axis of
    length ``maxit // record_every``; slot ``j`` holds the record taken at
    iteration ``k = (j + 1) * record_every``.  ``count`` is how many slots
    were actually written (the rest stay NaN for inexact dtypes / sentinel
    minima for exact ones), so ``values[:count]`` is the valid prefix.
    """

    values: Any
    count: jax.Array

    def valid(self):
        """Eager convenience: the written prefix of every leaf.

        Caveat on resume (``k0 > 1``): ``count`` is ``k // record_every``
        including slots *before* the resume point, which were never written
        this segment — so the returned prefix can lead with fill values
        (NaN for inexact dtypes) for those slots.  Concatenate the previous
        segment's trace over them, or slice from
        ``(k0 - 1) // record_every``."""
        n = int(self.count)
        return jax.tree.map(lambda v: v[:n], self.values)


def _trace_buffers(slots, vals_shape):
    """Preallocate (slots+1, *leaf) buffers.

    The one extra slot exists ONLY to absorb the degenerate resume write:
    with ``k0 > maxit`` the pre-loop write targets slot ``>= slots``, and
    XLA's ``dynamic_update_slice`` clamps the index — the spare slot keeps
    that clamped write from corrupting the last real slot.  Normal-cadence
    writes (an earlier sink-slot design for non-recording iterations was
    abandoned; ``lax.cond`` predication measured identical) always land in
    ``[0, slots)``."""

    def alloc(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.inexact):
            fill = jnp.nan
        elif leaf.dtype == jnp.bool_:
            fill = False
        else:
            fill = jnp.iinfo(leaf.dtype).min
        return jnp.full((slots + 1,) + tuple(leaf.shape), fill, leaf.dtype)

    return jax.tree.map(alloc, vals_shape)


def _trace_write(buf, vals, k, record_every):
    """Write ``vals`` at slot ``k // record_every - 1`` when ``k`` is a
    recording iteration.

    ``record_every == 1`` writes unconditionally (every iteration records —
    branchless, fuses into the loop body).  Sparser cadences predicate the
    write with ``lax.cond`` so non-recording iterations need not touch the
    buffers.  Scalar traces add a (slots, B) carry; whole-iterate traces
    add a (slots, B, N) carry that the loop carries every trip
    (``benchmarks/recording_bench.py`` measures both).  Record
    scalars/small summaries for production monitoring; whole-iterate
    capture is a diagnostics mode."""
    vals = jax.tree.map(jnp.asarray, vals)

    def write(b_tree):
        slot = jnp.maximum(k // record_every - 1, 0)
        return jax.tree.map(
            lambda b, v: jax.lax.dynamic_update_index_in_dim(
                b, v.astype(b.dtype), slot, axis=0
            ),
            b_tree, vals,
        )

    if record_every == 1:
        return write(buf)
    return jax.lax.cond(k % record_every == 0, write, lambda b: b, buf)


@partial(
    jax.jit,
    static_argnames=(
        "maxit", "stop", "solution", "record", "record_every",
        "verbose", "freq", "display",
    ),
)
def run_loop_recorded(iteration, maxit, tol, stop, solution, record,
                      record_every=1, verbose=False, freq=100, display=None,
                      initial_state=None, k0=1):
    """Like :func:`run_loop`, but additionally samples
    ``record(iteration, k, state)`` every ``record_every`` iterations into
    fixed-size on-device buffers and returns
    ``(solution, iteration_count, RecordedTrace)``.

    This is the jit-native counterpart of the reference's iterator
    combinators (``tee``/``sample``, ``src/utilities/iteration_tools.jl``)
    and of the guide's collect-the-iterates pattern
    (``docs/src/guide/getting_started.jl:146-152``): the history lives in
    the ``lax.while_loop`` carry, so there are no host callbacks and the
    loop stays a single compiled program.  ``record`` may return any pytree
    of arrays — scalars (objective, residual) or whole iterates.

    ``maxit`` and ``record_every`` are static (they size the buffers).  On
    resume (``k0 > 1``) slots before ``k0`` are left unwritten and ``count``
    still reports the highest slot written, i.e. ``k // record_every``.

    ``record`` is a *static* jit argument: its identity keys the compile
    cache.  For repeated solves, pass a module-level function (or a
    ``functools.partial`` bound once) — a fresh inline ``lambda`` per call
    recompiles the entire solve loop every invocation.
    """
    state = iteration.init() if initial_state is None else initial_state
    slots = maxit // record_every
    vals_shape = jax.eval_shape(
        lambda s: record(iteration, jnp.asarray(k0, jnp.int32), s), state
    )
    buf = _trace_buffers(slots, vals_shape)
    k_init = jnp.asarray(k0, jnp.int32)
    buf = _trace_write(
        buf, record(iteration, k_init, state), k_init, record_every
    )

    def cond(carry):
        k, s, _ = carry
        return (k < maxit) & jnp.logical_not(stop(iteration, tol, s))

    def body(carry):
        k, s, b = carry
        s = iteration.step(s)
        k = k + 1
        b = _trace_write(b, record(iteration, k, s), k, record_every)
        if verbose:
            jax.lax.cond(
                k % freq == 0,
                lambda: display(k, iteration, s),
                lambda: None,
            )
        return (k, s, b)

    k, state, buf = jax.lax.while_loop(cond, body, (k_init, state, buf))
    if verbose:
        display(k, iteration, state)
    trace = RecordedTrace(
        values=jax.tree.map(lambda b: b[:slots], buf),
        count=k // record_every,
    )
    return solution(iteration, state), k, trace


class IterativeAlgorithm:
    """Partial application of an iteration type plus run options.

    ``IterativeAlgorithm(IterCls, maxit=..., tol=..., **iter_kwargs)`` — call
    the result with the remaining problem kwargs to solve.
    """

    def __init__(
        self,
        iteration_factory,
        *,
        maxit,
        tol,
        stop=None,
        solution=None,
        verbose=False,
        freq=100,
        display=None,
        check_every=1,
        **kwargs,
    ):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop or _default_stop
        self.solution = solution or _default_solution
        self.verbose = verbose
        self.freq = freq
        self.display = display or _default_display
        # K steps per while-loop trip, exactly lane-frozen (see run_loop):
        # amortizes the per-trip quantum on trip-bound platforms without
        # changing counts or solutions
        self.check_every = check_every
        self.kwargs = kwargs

    def make_iteration(self, **kwargs):
        merged = {**self.kwargs, **kwargs}
        return self.iteration_factory(**merged)

    def run(self, resume_from=None, resume_iters=None, **kwargs):
        """Jittable run: returns (solution, iteration count) as arrays.

        ``resume_from`` continues from a captured state pytree (obtain one
        via :func:`states`, or checkpoint the carry with orbax/pickle);
        ``resume_iters`` is the iteration count of that state (e.g. the
        count the previous segment returned) so the counter and the
        ``maxit`` budget span the whole solve, not just this segment."""
        iteration = self.make_iteration(**kwargs)
        return run_loop(
            iteration,
            self.maxit,
            self.tol,
            self.stop,
            self.solution,
            self.verbose,
            self.freq,
            self.display,
            initial_state=resume_from,
            k0=1 if resume_iters is None else resume_iters,
            check_every=self.check_every,
        )

    def run_recorded(self, record, record_every=1, resume_from=None,
                     resume_iters=None, **kwargs):
        """Jittable run with on-device history: returns
        ``(solution, iteration_count, RecordedTrace)``.

        ``record(iteration, k, state) -> pytree`` is sampled every
        ``record_every`` iterations into preallocated buffers (see
        :func:`run_loop_recorded`).  ``record`` keys the jit cache by
        identity — for repeated solves define it once at module level (as
        the examples' top-level ``residual`` functions do) rather than
        inline, or every call recompiles the loop.  Example::

            x, it, tr = solver.run_recorded(
                lambda it, k, s: jnp.max(jnp.abs(s.res)) / s.gamma,
                record_every=10, x0=x0, f=f, g=g, Lf=Lf)
            residual_curve = tr.valid()
        """
        iteration = self.make_iteration(**kwargs)
        return run_loop_recorded(
            iteration,
            self.maxit,
            self.tol,
            self.stop,
            self.solution,
            record,
            record_every=record_every,
            verbose=self.verbose,
            freq=self.freq,
            display=self.display if self.verbose else None,
            initial_state=resume_from,
            k0=1 if resume_iters is None else resume_iters,
        )

    def __call__(self, resume_from=None, resume_iters=None, **kwargs):
        sol, k = self.run(resume_from=resume_from, resume_iters=resume_iters,
                          **kwargs)
        return sol, int(k)


def states(iteration, max_states=None):
    """Yield successive states eagerly (the power-user iterator path,
    cf. ``docs/src/guide/getting_started.jl:136-152``).

    Each ``step`` is jit-compiled once; states are immutable pytrees, so the
    reference's "don't mutate / don't collect" caveat vanishes.
    """
    init = jax.jit(lambda it: it.init())
    step = jax.jit(lambda it, s: it.step(s))
    state = init(iteration)
    k = 0
    while True:
        yield state
        k += 1
        if max_states is not None and k >= max_states:
            return
        state = step(iteration, state)
