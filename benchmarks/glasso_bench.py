"""Batched graphical lasso on one GPU — the eigh-prox op mix.

A seventh measured problem family: matrix-valued iterates whose prox runs
B on-device EIGENDECOMPOSITIONS per iteration (``NegLogDet`` via ``Tilt``)
plus a weighted-l1 threshold — Douglas-Rachford splitting, no smooth term
(see ``examples/graphical_lasso.py``).  Complements the SVD-prox family
(``matrix_completion_bench.py``): together they bound how much batching
pays when a dense linear-algebra decomposition dominates the step
(XLA's batched eigh/SVD parallelize far less than batched matvecs).

B distinct instances (own sparse SPD precision, exact covariance as S)
solved as ONE batched DR drive; per-lane KKT residuals recomputed on the
host in f64 are the correctness gate (no accuracy-for-speed trade hides
in the throughput number).

Usage: python benchmarks/glasso_bench.py [--reps 3] [--batch 64] [--n 32]
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

# f32 attainability: at tol 1e-6 a lane can stall just above the
# threshold (the DR residual 2e-6 sits at f32 eigh roundoff for n=32);
# 1e-5 converges on every lane.
TOL = 1e-5
GAMMA = 2.0
MAXIT = 2000


def gen_problems(B, n, seed=0, density=0.12):
    rng = np.random.default_rng(seed)
    Ss = np.empty((B, n, n), np.float32)
    for i in range(B):
        P = np.zeros((n, n))
        idx = rng.random((n, n)) < density
        vals = rng.uniform(0.3, 0.8, (n, n)) * np.sign(
            rng.standard_normal((n, n))
        )
        P[idx] = vals[idx]
        P = (P + P.T) / 2
        np.fill_diagonal(P, np.abs(P).sum(axis=1) + 0.5)
        S = np.linalg.inv(P)
        Ss[i] = (S + S.T) / 2
    return jnp.asarray(Ss)


def kkt_residuals(Ss, thetas, lam):
    """Host-side f64 KKT block residuals per lane (diag / nonzero offdiag /
    zero offdiag bound violation)."""
    B, n, _ = Ss.shape
    eye = np.eye(n, dtype=bool)
    off = ~eye
    out = np.empty((B, 3))
    for i in range(B):
        T = np.asarray(thetas[i], np.float64)
        T = (T + T.T) / 2
        G = np.asarray(Ss[i], np.float64) - np.linalg.inv(T)
        nz = off & (np.abs(T) > 50 * TOL)
        z = off & ~nz
        out[i, 0] = np.abs(G[eye]).max()
        out[i, 1] = np.abs(G[nz] + lam * np.sign(T[nz])).max() if nz.any() else 0.0
        out[i, 2] = max(np.abs(G[z]).max() - lam, 0.0) if z.any() else 0.0
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--loop-n", type=int, default=8)
    args = ap.parse_args()
    setup()
    B, n, lam = args.batch, args.n, args.lam

    import proxtpu as pa
    from proxtpu.algorithms import make_douglas_rachford_iteration
    from proxtpu.parallel import BatchedAlgorithm, Shared
    from proxtpu.prox import NegLogDet, NormL1, Tilt

    Ss = gen_problems(B, n)
    offdiag = lam * (1.0 - jnp.eye(n, dtype=jnp.float32))

    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "n": n, "batch": B, "lam": lam, "tol": TOL,
                      "gamma": GAMMA}), flush=True)

    solver = BatchedAlgorithm(make_douglas_rachford_iteration,
                              maxit=MAXIT, tol=TOL, use_kernels=False)
    x0 = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (B, n, n))

    def run():
        # distinct S per lane (batched leaf); the weighted-l1 penalty is
        # lane-invariant -> Shared (mapped with in_axes=None)
        return solver(x0=x0, f=Tilt(NegLogDet(1.0), Ss),
                      g=Shared(NormL1(offdiag)), gamma=GAMMA)

    sol, rec = timed_solve(run, args.reps, B)
    assert rec["all_done"], rec

    kkt = kkt_residuals(Ss, sol, lam)
    rec = {"variant": "glasso_batched_dr", "batch": B, "n": n,
           "kkt_diag_max": float(kkt[:, 0].max()),
           "kkt_nz_max": float(kkt[:, 1].max()),
           "kkt_zero_violation_max": float(kkt[:, 2].max()), **rec}
    print(json.dumps(rec), flush=True)
    # f32 iterates, f64 recheck: the DR fixed-point tol is on the residual
    # ||y - z||/gamma, so the KKT blocks land within a small multiple
    assert kkt[:, 0].max() < 100 * TOL, kkt[:, 0].max()
    assert kkt[:, 1].max() < 100 * TOL, kkt[:, 1].max()
    assert kkt[:, 2].max() < 100 * TOL, kkt[:, 2].max()

    # sequential baseline: one lane at a time (reference execution model)
    single = pa.DouglasRachford(maxit=MAXIT, tol=TOL, gamma=GAMMA)

    def one(i):
        X, it = single(x0=jnp.eye(n, dtype=jnp.float32),
                       f=Tilt(NegLogDet(1.0), Ss[i]), g=NormL1(offdiag))
        return np.asarray(X)

    one(0)  # compile
    t0 = time.perf_counter()
    for i in range(min(args.loop_n, B)):
        one(i)
    dt = time.perf_counter() - t0
    print(json.dumps({"variant": "glasso_sequential",
                      "problems_per_sec": min(args.loop_n, B) / dt,
                      "n_timed": min(args.loop_n, B)}), flush=True)


if __name__ == "__main__":
    main()
