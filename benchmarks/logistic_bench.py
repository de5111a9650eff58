"""GPU measurement: batched sparse logistic regression (nonquadratic f).

The reference's second headline problem family
(``test/problems/test_sparse_logistic_small.jl``): minimize
``sum softplus(-(Ax - b)) + lam ||x||_1``.  Unlike the lasso, f is NOT
generalized-quadratic, so the flat line-search machines take the full
oracle path (one real forward matvec + logistic evaluation + adjoint
matvec per tau-trial — no interpolation shortcut), which makes this the
honest generality check for the trial/commit design.

Workload: ONE 200x400 design matrix (the natural sparse-logistic setting —
one dataset, a lam path), 256 per-lane lam values, f32, tol 1e-5.
Paths, back-to-back in one process:

* flat ZeroFPR, Shared A vs stacked A;
* flat PANOC, Shared A;
* bounded-lowering PANOC (generic driver).

FISTA is deliberately absent: f32 FISTA stalls at a
gradient-noise floor of ``||res||_inf/gamma ~ 2e-3`` (f64-recomputed; the
f64 solve converges in 113-1009 iterations) — the logistic f at magnitude
~100 and x at ~4.5 leave tol<=1e-4 unattainable for the f32 fixed-point
map, while the quasi-Newton machines cross their (equally f32-computed)
threshold in <=90 iterations.  The cross-solver solution gap of ~2e-3
below IS that noise floor.  For reference-grade logistic tolerances enable
``jax_enable_x64``.

Usage: python benchmarks/logistic_bench.py [--quick] [--only=a,b]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import proxtpu  # noqa: F401  (registers the default matmul precision)
from proxtpu.algorithms.panoc import make_panoc_iteration
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.parallel.flat_ls import batched_panoc, batched_zerofpr
from proxtpu.prox import LogisticLoss, NormL1, Translate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

M, N = 200, 400
BATCH = 256
TOL = 1e-5
MAXIT = 2000
DTYPE = np.float32


def gen_problem():
    rng = np.random.default_rng(1)
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(DTYPE)
    b = rng.standard_normal(M).astype(DTYPE)
    # grad f(0) = A^T (sigmoid(-b) - 1); lam_max makes x=0 optimal above it
    lam_max = float(np.max(np.abs(
        A.T @ (1.0 / (1.0 + np.exp(b)) - 1.0))))
    lams = (lam_max * np.logspace(
        np.log10(0.05), np.log10(0.5), BATCH)).astype(DTYPE)
    # sigmoid' <= 1/4  =>  Lf <= ||A||^2 / 4
    Lf = float(np.linalg.norm(A, 2) ** 2) / 4.0
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
    gamma = jnp.full((BATCH,), 0.95 / Lf, DTYPE)

    # f(u) = sum softplus(-(u - b)): logistic loss with all-one labels and
    # offset b (``test_sparse_logistic_small.jl:20-23``)
    f_log = Translate(LogisticLoss(1.0), -b)

    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "shape": [BATCH, M, N], "Lf": Lf}), flush=True)

    results = {}

    def record(name, run):
        if only and name not in only:
            return None
        z, rec = timed(name, run, reps)
        results[name] = (z, rec)
        return z

    z_sh = record("flat_zerofpr_shared", lambda: batched_zerofpr(
        Shared(f_log), Shared(MatrixOperator(A)), g, x0, gamma, TOL,
        maxit=MAXIT))
    record("flat_zerofpr_stacked", lambda: batched_zerofpr(
        jax.vmap(lambda _: f_log)(jnp.arange(BATCH)),
        MatrixOperator(A_st), g, x0, gamma, TOL, maxit=MAXIT))
    z_p = record("flat_panoc_shared", lambda: batched_panoc(
        Shared(f_log), Shared(MatrixOperator(A)), g, x0, gamma, TOL,
        maxit=MAXIT))

    bounded = BatchedAlgorithm(
        make_panoc_iteration, maxit=MAXIT, tol=TOL, use_kernels=False
    )
    record("bounded_panoc_stacked", lambda: bounded(
        x0=x0, f=jax.vmap(lambda _: f_log)(jnp.arange(BATCH)),
        A=jax.vmap(MatrixOperator)(A_st), g=g, Lf=Lf, adaptive=False))

    if z_sh is not None and z_p is not None:
        # cross-solver agreement at tolerance level
        print(json.dumps({
            "gap_zerofpr_vs_panoc": float(np.max(np.abs(z_sh - z_p))),
        }), flush=True)
    for pairs in (("flat_zerofpr_shared", "flat_zerofpr_stacked"),
                  ("flat_panoc_shared", "bounded_panoc_stacked")):
        a_, b_ = pairs
        if a_ in results and b_ in results:
            print(json.dumps({
                "speedup": f"{a_} vs {b_}",
                "ratio": results[a_][1]["problems_per_sec"]
                / results[b_][1]["problems_per_sec"],
                "max_abs_solution_gap": float(np.max(np.abs(
                    results[a_][0] - results[b_][0]))),
            }), flush=True)


if __name__ == "__main__":
    main()
