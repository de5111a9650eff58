"""Profiling hooks (SURVEY.md §5 tracing/profiling).

The reference's cost accounting is oracle-call counts
(:class:`~proxtpu.utils.iteration_tools.Counting`) and the ``stopwatch``
combinator; the additions here are XLA-level:

* :func:`trace` — context manager around a solve writing a
  ``jax.profiler`` trace (open with TensorBoard / Perfetto) so the fused
  kernels, matmuls and collectives of the jitted while-loop are visible;
* :func:`compiled_stats` — FLOP/memory analysis of a jitted solver call
  from XLA's cost analysis, without running it.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir):
    """Profile everything inside the block into ``log_dir``::

        with trace("/tmp/prof"):
            x, it = solver(x0=x0, f=f, g=g, Lf=Lf)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compiled_stats(fn, *args, **kwargs):
    """Compile ``fn(*args, **kwargs)`` and return XLA's cost analysis as a
    dict (keys like ``flops``, ``bytes accessed``) plus the memory analysis
    object — the static cost of one solver call."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {
        "cost_analysis": dict(cost) if cost else {},
        "memory_analysis": compiled.memory_analysis(),
    }
