"""Shared set-up and timing core for the batched-solver benchmarks.

:func:`setup` picks the platform and turns on the compile cache; a
measurement that finds no GPU fails instead of carrying on on the CPU.
:func:`timed_solve` runs one warm (compile) call, then ``reps`` timed calls
fenced by ``jax.block_until_ready``; the median is the reported estimator,
with the 25/75 percentiles as spread.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup(platform=None):
    """Select the JAX platform, enable the compile cache and return the
    platform name.  Without ``platform`` the run must find a GPU;
    ``platform="cpu"`` runs on the CPU on purpose (plumbing checks and the
    CPU float64 regression baseline)."""
    import jax

    from proxtpu.utils.compile_cache import enable_compile_cache

    if platform:
        jax.config.update("jax_platforms", platform)
    found = jax.devices()[0].platform
    if not platform and found != "gpu":
        sys.exit(f"this benchmark measures the GPU; JAX found {jax.devices()}"
                 " (pass --platform cpu where the script offers it)")
    enable_compile_cache()
    return found


def timed_solve(run, reps, batch):
    """Time ``run()`` (returning ``(solution, iters, done)``) ``reps``
    times after one compile run, fencing each with
    ``jax.block_until_ready``.

    Returns ``(solution_host, record)`` where ``record`` carries the
    common benchmark fields; callers add/rename fields as their jsonl
    schema needs.
    """
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    t_compile = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    sol = np.asarray(out[0])
    iters = np.asarray(out[1])
    done = np.asarray(out[2])
    med = float(np.median(times))
    lo, hi = np.percentile(times, [25, 75])
    rec = {
        "problems_per_sec": batch / med,
        "median_s": med,
        "iqr_s": [float(lo), float(hi)],
        "compile_s": t_compile,
        "all_done": bool(done.all()),
        "done_frac": float(done.mean()),
        "iters_median": int(np.median(iters)),
        "iters_max": int(iters.max()),
    }
    return sol, rec
