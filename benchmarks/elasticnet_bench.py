"""GPU measurement: batched elastic net through the batched-lasso route.

The batched lasso solvers take a ``lam2`` ridge epilogue (the combined
ElasticNet prox: soft threshold, then divide by ``1 + gamma*lam2`` —
bit-matching ``ElasticNet.prox``), so the reference's second problem
family (`test_elasticnet.jl`) rides the batched-lasso step (the fused
kernel for float32 on a GPU) instead of the generic vmapped driver.  This
measures, same-process / host-fenced / median-of-reps at the flagship
shape (256 x 200x400, f32, tol 1e-5, distinct per-lane (A, b), per-lane
lam1 and lam2):

* generic vmapped FISTA + combined ElasticNet prox (check_every=8) —
  what the family got before the kernel route;
* the dispatched kernel route (``BatchedAlgorithm`` with default
  ``use_kernels``) — auto-routes to ``solve_lasso_batch(lam2=...)``;
* the kernel route + adaptive restart (``AdaptiveRestartSequence``).

All three solve the identical problem set; solutions are cross-checked
within the tol-ball and residuals are host-rechecked in f64 against the
combined prox before any row is recorded.

Usage: python benchmarks/elasticnet_bench.py [--quick] [--out FILE]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from proxtpu.accel.nesterov import AdaptiveRestartSequence
from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.parallel import BatchedAlgorithm
from proxtpu.prox import ElasticNet, LeastSquaresLoss

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

M, N, BATCH, TOL = 200, 400, 256, 1e-5


def recheck_f64(A, b, lam1, lam2, Lf, xs):
    """Worst-lane f64 FB residual with the combined elastic-net prox."""
    A, b, lam1, lam2, Lf, xs = (np.asarray(v, np.float64)
                                for v in (A, b, lam1, lam2, Lf, xs))
    gam = (1.0 / Lf)[:, None]
    grad = np.einsum("bmn,bm->bn", A,
                     np.einsum("bmn,bn->bm", A, xs) - b)
    y = xs - gam * grad
    z = (np.sign(y) * np.maximum(np.abs(y) - gam * lam1[:, None], 0.0)
         / (1.0 + gam * lam2[:, None]))
    return float(np.max(np.max(np.abs(xs - z), axis=1) / gam[:, 0]))


def main():
    setup()
    reps = 2 if "--quick" in sys.argv else 5
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
    rows = []

    def emit(tag, run):
        sol, rec = timed_solve(run, reps, BATCH)
        rec = {"variant": tag, **rec}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        return sol, rec

    rng = np.random.default_rng(0)
    A = jnp.asarray((rng.standard_normal((BATCH, M, N)) / np.sqrt(M))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((BATCH, M)).astype(np.float32))
    lam1 = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    lam2 = jnp.asarray((0.05 + 0.2 * rng.random(BATCH)).astype(np.float32))
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(BATCH)], jnp.float32)
    kw = dict(x0=jnp.zeros((BATCH, N), jnp.float32),
              f=LeastSquaresLoss(A, b),
              g=ElasticNet(mu=lam1, lam=lam2), Lf=Lf)

    generic = BatchedAlgorithm(make_fast_forward_backward_iteration,
                               maxit=3000, tol=TOL, use_kernels=False,
                               check_every=8)
    kern = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=3000, tol=TOL)
    kern_r = BatchedAlgorithm(make_fast_forward_backward_iteration,
                              maxit=3000, tol=TOL,
                              extrapolation_sequence=AdaptiveRestartSequence())

    xs_g, _ = emit("elasticnet_generic_ce8", lambda: generic(**kw))
    xs_k, _ = emit("elasticnet_kernel", lambda: kern(**kw))
    xs_r, _ = emit("elasticnet_kernel_restart", lambda: kern_r(**kw))

    worst = max(recheck_f64(A, b, lam1, lam2, Lf, x)
                for x in (xs_g, xs_k, xs_r))
    gap_kg = float(np.max(np.abs(xs_k - xs_g)))
    gap_rg = float(np.max(np.abs(xs_r - xs_g)))
    summary = {"variant": "elasticnet_crosscheck",
               "worst_f64_recheck_res": worst,
               "max_abs_gap_kernel_vs_generic": gap_kg,
               "max_abs_gap_restart_vs_generic": gap_rg}
    print(json.dumps(summary), flush=True)
    rows.append(summary)
    assert worst <= 2 * TOL, worst

    if out_path:
        with open(out_path, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
