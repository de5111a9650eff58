"""Batched low-rank matrix completion on one GPU.

A measured problem family with a completely different op mix from the
lasso/TV/SVM/CVaR/logistic suites: matrix-valued iterates and an
SVD-based prox (``NuclearNorm``) — every iteration runs B on-device
SVDs inside the vmapped FISTA step.

    minimize  1/2 ||P_Omega(X - M)||_F^2 + lam ||X||_*

B distinct instances (own rank-r truth, own 60%-observation mask) solved
as ONE batched drive; per-lane recovery error against the held-out
entries is the correctness check (the test-set analogue of
``tests/test_matrix_completion.py``).

Usage: python benchmarks/matrix_completion_bench.py [--reps 3] [--batch 64]
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

M_ROWS, N_COLS, RANK = 64, 48, 3
TOL = 1e-4
LAM = 0.5
MAXIT = 5000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--loop-n", type=int, default=8)
    args = ap.parse_args()
    setup()
    B = args.batch

    import proxtpu as pa
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import NuclearNorm, proxclass

    @proxclass
    class MaskedQuadratic:
        """f(X) = ||mask * (X - M)||_F^2 / 2 with hand gradient."""

        mask: object
        M: object

        is_convex = True
        is_generalized_quadratic = True

        def __call__(self, X):
            r = self.mask * (X - self.M)
            return 0.5 * jnp.sum(r * r)

        def value_and_gradient(self, X):
            r = self.mask * (X - self.M)
            return 0.5 * jnp.sum(r * r), r

    rng = np.random.default_rng(3)
    truths = np.empty((B, M_ROWS, N_COLS), np.float32)
    masks = np.empty((B, M_ROWS, N_COLS), np.float32)
    for i in range(B):
        truths[i] = (rng.standard_normal((M_ROWS, RANK))
                     @ rng.standard_normal((RANK, N_COLS)))
        masks[i] = rng.random((M_ROWS, N_COLS)) < 0.6
    obs = jnp.asarray(masks * truths)
    masks_j = jnp.asarray(masks)

    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "shape": [M_ROWS, N_COLS], "rank": RANK,
                      "observed_frac": 0.6, "lam": LAM, "tol": TOL}),
          flush=True)

    solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                              maxit=MAXIT, tol=TOL, use_kernels=False)

    def run():
        return solver(x0=jnp.zeros((B, M_ROWS, N_COLS), jnp.float32),
                      f=MaskedQuadratic(masks_j, obs),
                      g=NuclearNorm(LAM), Lf=1.0)

    sol, rec = timed_solve(run, args.reps, B)
    assert rec["all_done"], rec

    # recovery on the HELD-OUT entries, per lane (test-set error)
    rel = np.empty(B)
    for i in range(B):
        hold = (1.0 - masks[i]).astype(bool)
        diff = np.asarray(sol[i])[hold] - truths[i][hold]
        rel[i] = np.linalg.norm(diff) / max(np.linalg.norm(truths[i][hold]),
                                            1e-12)
    rec = {"variant": "matrix_completion_batched", "batch": B,
           "heldout_rel_err_median": float(np.median(rel)),
           "heldout_rel_err_max": float(np.max(rel)), **rec}
    print(json.dumps(rec), flush=True)
    assert np.median(rel) < 0.25, rel  # soft-thresholded SVD biases, but
    # the low-rank structure must be genuinely recovered on unseen entries

    # sequential baseline: one lane at a time (reference execution model)
    single = pa.FastForwardBackward(maxit=MAXIT, tol=TOL)
    def one(i):
        X, it = single(x0=jnp.zeros((M_ROWS, N_COLS), jnp.float32),
                       f=MaskedQuadratic(masks_j[i], obs[i]),
                       g=NuclearNorm(LAM), Lf=1.0)
        return np.asarray(X)
    one(0)  # compile
    t0 = time.perf_counter()
    for i in range(min(args.loop_n, B)):
        one(i)
    dt = time.perf_counter() - t0
    print(json.dumps({"variant": "matrix_completion_sequential",
                      "problems_per_sec": min(args.loop_n, B) / dt,
                      "n_timed": min(args.loop_n, B)}), flush=True)


if __name__ == "__main__":
    main()
