"""GPU measurement: overhead of on-device trace recording.

``batched_run_recorded`` keeps per-lane convergence curves in the
while-loop carry ((slots, B) buffers, one branchless dynamic-index write
per iteration).  This measures what that write costs at the flagship shape
(256 distinct 200x400 lassos, f32, tol 1e-5, generic vmapped FISTA driver)
for three cadences, back-to-back in one process against the unrecorded
driver:

* record_every=1  — a (B,) residual scalar written every iteration;
* record_every=10 — the practical diagnostics cadence;
* record_every=10 with a FULL-ITERATE record ({"x": (B, N)}) — the
  collect-the-iterates pattern (getting_started.jl:146-152) on device.

Usage: python benchmarks/recording_bench.py [--quick]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import proxtpu  # noqa: F401
from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.parallel import batched_run_loop, batched_run_recorded
from proxtpu.prox import NormL1, make_least_squares
from proxtpu.utils.tree import tree_inf_norm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

M, N = 200, 400
BATCH = 256
TOL = 1e-5
MAXIT = 2000
DTYPE = np.float32


def build_iteration(batch):
    rng = np.random.default_rng(0)
    As = jnp.asarray(rng.standard_normal((batch, M, N)) / np.sqrt(M), DTYPE)
    bs = jnp.asarray(rng.standard_normal((batch, M)), DTYPE)
    lams = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmn,bm->bn", As, bs)), axis=1)
    Lfs = jnp.asarray(
        [np.linalg.norm(np.asarray(As[i]), 2) ** 2 for i in range(batch)],
        DTYPE,
    )
    return jax.vmap(
        lambda A, b, lam, Lf: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, DTYPE), f=make_least_squares(A, b),
            g=NormL1(lam), gamma=1.0 / Lf,
        )
    )(As, bs, lams, Lfs)


def residual(it, k, s):
    return tree_inf_norm(s.res) / s.gamma


def main():
    reps = 3 if "--quick" in sys.argv else 5
    batch = 64 if "--quick" in sys.argv else BATCH
    iteration = build_iteration(batch)
    platform = setup()

    variants = {
        "plain": lambda: batched_run_loop(iteration, MAXIT, TOL),
        "record_scalar_k1": lambda: batched_run_recorded(
            iteration, MAXIT, TOL, residual, record_every=1
        )[:3],
        "record_scalar_k10": lambda: batched_run_recorded(
            iteration, MAXIT, TOL, residual, record_every=10
        )[:3],
        "record_iterates_k10": lambda: batched_run_recorded(
            iteration, MAXIT, TOL, lambda it, k, s: {"x": s.x},
            record_every=10,
        )[:3],
    }

    results = {}
    sols = {}
    for name, run in variants.items():
        sol, rec = timed_solve(run, reps, batch)
        rec.update(name=name, platform=platform, batch=batch, tol=TOL)
        sols[name] = sol
        results[name] = rec
        print(json.dumps(rec))

    # recording must not perturb the solve
    for name in list(variants)[1:]:
        gap = float(np.max(np.abs(sols[name] - sols["plain"])))
        assert gap == 0.0, f"{name} diverged from plain: {gap}"
    base = results["plain"]["problems_per_sec"]
    for name, rec in results.items():
        print(f"# {name}: {rec['problems_per_sec']:.0f} p/s "
              f"({rec['problems_per_sec'] / base:.2f}x plain)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
