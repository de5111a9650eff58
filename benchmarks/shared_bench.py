"""GPU measurement: Shared (lane-invariant) operands vs materially stacked.

Workload: a regularization-path sweep at the flagship shape — ONE 200x400
design matrix and right-hand side, 256 per-lane ``lam`` values (f32,
tol 1e-5).  This is the most common batched use of the library, and the one
where stacking is maximally wasteful: every per-lane matvec of the stacked
problem streams its own copy of A as a batched GEMV, while the Shared
problem runs the whole batch as one (B,n)@(n,m) matmul per oracle call.

Paths measured back-to-back in one process:

* flat ZeroFPR / PANOC (the fastest line-search machines): Shared A vs
  stacked A;
* the generic vmapped FISTA driver: Shared f vs stacked f;
* the dispatch route of ``Shared(LeastSquaresLoss)`` -> multirhs kernel.

Usage: python benchmarks/shared_bench.py [--quick] [--only=a,b]
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
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.parallel.flat_ls import batched_panoc, batched_zerofpr
from proxtpu.prox import LeastSquaresLoss, NormL1, SqrDistance

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

M, N = 200, 400
BATCH = 256
TOL = 1e-5
MAXIT = 3000
DTYPE = np.float32


def gen_problem():
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(DTYPE)
    b = rng.standard_normal(M).astype(DTYPE)
    lam_max = float(np.max(np.abs(A.T @ b)))
    # log-spaced path from 0.02 to 0.5 of lam_max — a real lasso path
    lams = (lam_max * np.logspace(
        np.log10(0.02), np.log10(0.5), BATCH)).astype(DTYPE)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    return A, b, lams, Lf


def timed(tag, run, reps):
    sol, rec = timed_solve(run, reps, BATCH)
    rec = {"variant": tag, **rec}
    print(json.dumps(rec), flush=True)
    return sol, rec


def main():
    setup()
    quick = "--quick" in sys.argv
    only = None
    for a in sys.argv[1:]:
        if a.startswith("--only="):
            only = a.split("=", 1)[1].split(",")
    reps = 3 if quick else 5
    A_h, b_h, lams, Lf = gen_problem()
    A = jnp.asarray(A_h)
    b = jnp.asarray(b_h)
    g = NormL1(jnp.asarray(lams))
    x0 = jnp.zeros((BATCH, N), DTYPE)
    A_st = jnp.broadcast_to(A, (BATCH, M, N))
    b_st = jnp.broadcast_to(b, (BATCH, M))
    gamma = jnp.full((BATCH,), 0.95 / Lf, DTYPE)

    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "shape": [BATCH, M, N]}), flush=True)

    f_sq_shared = Shared(SqrDistance(b))
    f_sq_stacked = SqrDistance(b_st)
    Aop_shared = Shared(MatrixOperator(A))
    Aop_stacked = MatrixOperator(A_st)


    def pair(name, run_shared, run_stacked):
        if only and name not in only:
            return
        z_sh, rec_sh = timed(f"{name}_shared", run_shared, reps)
        z_st, rec_st = timed(f"{name}_stacked", run_stacked, reps)
        gap = float(np.max(np.abs(z_sh - z_st)))
        rec = {
            "solver": name,
            "speedup_shared_vs_stacked": rec_sh["problems_per_sec"]
            / rec_st["problems_per_sec"],
            "max_abs_solution_gap": gap,
        }
        print(json.dumps(rec), flush=True)

    pair(
        "flat_zerofpr",
        lambda: batched_zerofpr(
            f_sq_shared, Aop_shared, g, x0, gamma, TOL, maxit=MAXIT),
        lambda: batched_zerofpr(
            f_sq_stacked, Aop_stacked, g, x0, gamma, TOL, maxit=MAXIT),
    )
    pair(
        "flat_panoc",
        lambda: batched_panoc(
            f_sq_shared, Aop_shared, g, x0, gamma, TOL, maxit=MAXIT),
        lambda: batched_panoc(
            f_sq_stacked, Aop_stacked, g, x0, gamma, TOL, maxit=MAXIT),
    )

    generic = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=False,
    )
    f_ls_stacked = LeastSquaresLoss(A_st, b_st)
    pair(
        "generic_fista",
        lambda: generic(x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=g, Lf=Lf),
        lambda: generic(x0=x0, f=f_ls_stacked, g=g, Lf=Lf),
    )

    # dispatch: Shared f routes to the shared-A multirhs solver
    auto = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
    )
    if not only or "dispatch_multirhs" in only:
        timed(
            "dispatch_multirhs_shared_f",
            lambda: auto(x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=g,
                         Lf=Lf),
            reps,
        )


if __name__ == "__main__":
    main()
