"""Batched soft-margin SVM regularization path on one GPU.

A third headline problem family (after lasso and TV): the hinge loss is
nonsmooth AND composed with the data matrix, so every solve is a
primal-dual (Chambolle-Pock) run — this benchmarks the generic batched
driver on the AFBA factory with a Shared (lane-invariant) data matrix
against materially stacked copies, plus the check_every=8 trip-blocking
variant.

    python benchmarks/svm_bench.py [--reps 5] [--batch 256]

Prints one JSON line per variant.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

M, N = 400, 200  # samples x features
TOL = 1e-4
MAXIT = 100_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    setup()
    B = args.batch

    from proxtpu.algorithms.primal_dual import make_afba_iteration
    from proxtpu.parallel import BatchedAlgorithm, Shared
    from proxtpu.prox import HingeLoss, SqrNormL2

    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(N)
    A = ((rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32))
    y = np.sign(A @ w_true + 0.2 * rng.standard_normal(M)).astype(np.float32)
    A_j, y_j = jnp.asarray(A), jnp.asarray(y)
    lams = jnp.asarray(
        np.geomspace(0.01, 1.0, B).astype(np.float32)
    )
    opnorm = float(np.linalg.norm(A, 2))
    gam = jnp.full((B,), 0.9 / opnorm, jnp.float32)
    A_st = jnp.asarray(np.broadcast_to(A, (B, M, N)).copy())

    common = dict(
        x0=jnp.zeros((B, N), jnp.float32), y0=jnp.zeros((B, M), jnp.float32),
        g=SqrNormL2(lams), theta=2.0, gamma1=gam, gamma2=gam,
    )

    variants = {
        "svm_cp_shared": lambda ce: BatchedAlgorithm(
            make_afba_iteration, maxit=MAXIT, tol=TOL, use_kernels=False,
            check_every=ce,
        )(h=Shared(HingeLoss(y_j, 1.0 / M)), L=Shared(A_j), **common),
        "svm_cp_stacked": lambda ce: BatchedAlgorithm(
            make_afba_iteration, maxit=MAXIT, tol=TOL, use_kernels=False,
            check_every=ce,
        )(
            h=HingeLoss(jnp.broadcast_to(y_j, (B, M)), 1.0 / M),
            L=A_st, **common,
        ),
    }

    def run_variant(name, ce):
        def run():
            (xs, _ys), iters, done = variants[name](ce)
            return xs, iters, done

        sol, rec = timed_solve(run, args.reps, B)
        rec = {"variant": f"{name}_ce{ce}", **rec}
        print(json.dumps(rec), flush=True)
        return sol

    only = set(args.only.split(",")) if args.only else None
    sols = {}
    for name in ("svm_cp_shared", "svm_cp_stacked"):
        for ce in (1, 8):
            key = f"{name}_ce{ce}"
            if only and key not in only:
                continue
            sols[key] = run_variant(name, ce)

    if "svm_cp_shared_ce1" in sols and "svm_cp_stacked_ce1" in sols:
        gap = float(np.max(np.abs(
            sols["svm_cp_shared_ce1"] - sols["svm_cp_stacked_ce1"]
        )))
        print(json.dumps({"max_abs_gap_shared_vs_stacked": gap}), flush=True)


if __name__ == "__main__":
    main()
