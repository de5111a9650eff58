"""Batched minimum-CVaR portfolios on one GPU.

A fourth measured problem family (after lasso, TV, SVM): B scenario
matrices (e.g. bootstrap resamples or rolling windows of the same
market) are solved as ONE batched Chambolle-Pock drive with
``SumLargest`` dual proxes — the tail-risk objective has no smooth or
kernel-shaped structure, so this measures the generic vmapped driver on
the widened prox catalogue, against a sequential loop of single solves
(the reference's one-problem-at-a-time execution model).

    python benchmarks/cvar_bench.py [--reps 5] [--batch 64] [--loop-n 8]

Prints one JSON line per variant.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

import jax.numpy as jnp  # noqa: E402

S, N_ASSETS, K = 250, 8, 25
TOL = 1e-5
MAXIT = 50_000


def scenario_batch(B, rng):
    """B bootstrap-style scenario-loss matrices from one factor model."""
    expo = rng.standard_normal((N_ASSETS, 3)) * 0.5
    mu = np.linspace(0.08, 0.01, N_ASSETS)
    Ls = np.empty((B, S, N_ASSETS), np.float32)
    for i in range(B):
        factors = rng.standard_normal((S, 3))
        R = (mu[None, :] + factors @ expo.T * 0.1
             + 0.05 * rng.standard_normal((S, N_ASSETS)))
        Ls[i] = -R.astype(np.float32)
    return jnp.asarray(Ls)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--loop-n", type=int, default=8,
                    help="single solves to time for the sequential baseline")
    args = ap.parse_args()
    setup()
    B = args.batch

    from proxtpu.algorithms import ChambollePock
    from proxtpu.algorithms.primal_dual import make_chambolle_pock_iteration
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import IndSimplex, SumLargest

    rng = np.random.default_rng(7)
    Ls = scenario_batch(B, rng)
    opnorms = np.array([np.linalg.norm(np.asarray(Ls[i]), 2)
                        for i in range(B)], np.float32)
    gam = jnp.asarray(0.9 / opnorms)

    common = dict(
        x0=jnp.full((B, N_ASSETS), 1.0 / N_ASSETS, jnp.float32),
        y0=jnp.zeros((B, S), jnp.float32),
        g=IndSimplex(1.0), h=SumLargest(K, 1.0 / K),
        L=Ls, gamma1=gam, gamma2=gam,
    )

    def run_batched(ce):
        def run():
            (xs, _ys), iters, done = BatchedAlgorithm(
                make_chambolle_pock_iteration, maxit=MAXIT, tol=TOL,
                use_kernels=False, check_every=ce,
            )(**common)
            return xs, iters, done

        sol, rec = timed_solve(run, args.reps, B)
        rec = {"variant": f"cvar_cp_batched_ce{ce}", "batch": B,
               "shape": [S, N_ASSETS], "k": K, "tol": TOL, **rec}
        print(json.dumps(rec), flush=True)
        return sol

    sols = {ce: run_batched(ce) for ce in (1, 8)}

    # sequential baseline: single CP solves, one lane at a time (compile
    # once — all lanes share shapes — then time loop-n lanes)
    solver = ChambollePock(maxit=MAXIT, tol=TOL)

    def one(i):
        (x, _y), it = solver(
            x0=jnp.full(N_ASSETS, 1.0 / N_ASSETS, jnp.float32),
            y0=jnp.zeros(S, jnp.float32),
            g=IndSimplex(1.0), h=SumLargest(K, 1.0 / K),
            L=Ls[i], gamma1=float(gam[i]), gamma2=float(gam[i]),
        )
        return np.asarray(x)

    one(0)  # warm the compile cache before timing
    t0 = time.perf_counter()
    xs_seq = [one(i) for i in range(min(args.loop_n, B))]
    dt = time.perf_counter() - t0
    pps = len(xs_seq) / dt
    print(json.dumps({
        "variant": "cvar_cp_sequential", "problems_per_sec": pps,
        "n_timed": len(xs_seq), "tol": TOL,
    }), flush=True)

    # parity: BOTH batched variants' lanes match the sequential solves to
    # tol-ball size (so the ce=8 headline number is parity-backed too)
    for ce, sol in sols.items():
        gap = max(
            float(np.max(np.abs(np.asarray(sol[i]) - xs_seq[i])))
            for i in range(len(xs_seq))
        )
        print(json.dumps(
            {f"max_abs_gap_batched_ce{ce}_vs_sequential": gap}), flush=True)


if __name__ == "__main__":
    main()
