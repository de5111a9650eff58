"""Pipelined dispatch of batched solves (the streaming execution model).

JAX dispatch is asynchronous, so a producer that keeps ``depth`` solves in
flight can overlap one call's host-side work (argument handling, dispatch)
with another's device compute.  :func:`stream_solve` packages that
pattern: it drains an iterable of problem payloads through a solve
callable, keeping up to ``depth`` calls in flight and yielding results IN
ORDER once fenced.  How much it overlaps depends on the solve: a
``while_loop`` whose condition the host reads back every trip keeps the
dispatching thread busy until the loop ends.

The reference has no counterpart (its benchmark harness is synchronous,
``/root/reference/benchmark/runbenchmarks.jl:43-76``).
"""

from __future__ import annotations

from collections import deque

import jax


def stream_solve(solve, problems, depth=2, fence=jax.block_until_ready):
    """Yield ``solve(p)`` for each payload ``p`` in ``problems``, in
    order, with up to ``depth`` additional solves dispatched ahead.

    ``solve`` must be an async-dispatching device function (a jitted
    solver); its output pytree is yielded as-is (device arrays — transfer
    only what you consume).  ``depth=0`` degrades to fully synchronous
    execution.

    ``fence(out)`` blocks until ``out``'s computation finished; the
    default is :func:`jax.block_until_ready`.  Pass a custom fence to also
    post-process while the pipeline drains.
    """
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")

    def _gen():
        q = deque()
        for p in problems:
            q.append(solve(p))
            if len(q) > depth:
                out = q.popleft()
                fence(out)
                yield out
        while q:
            out = q.popleft()
            fence(out)
            yield out

    # validate at call time, not at first next() (generator semantics
    # would otherwise defer the ValueError far from the call site)
    return _gen()
