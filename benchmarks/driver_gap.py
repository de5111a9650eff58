"""Measure the generic batched driver against the specialized paths on ONE GPU.

All paths run in ONE process, back-to-back, fenced by
``jax.block_until_ready``, median of ``--repeat`` runs, at the flagship
200x400 / batch-256 lasso:

  generic    batched_run_loop + FISTA iteration (LeastSquaresLoss oracle)
  xla        solve_lasso_batch(use_kernel=False) — the plain XLA step
  kernel     solve_lasso_batch(use_kernel=True) — the fused GPU step
  multirhs   solve_lasso_multirhs — one shared A (lam-path formulation)
  qp         the box-QP family (XLA projected gradient)

For each path it reports end-to-end problems/s *and* a fixed-iteration
(tol=0) per-iteration time.

Usage: python benchmarks/driver_gap.py [--repeat 5] [--batch 256] ...
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def timed(fn, repeat):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.min(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxit", type=int, default=2000)
    ap.add_argument("--fixed-it", type=int, default=512)
    ap.add_argument("--paths", default="generic,generic_k8,xla,kernel,qp")
    ap.add_argument("--skip-fixed", action="store_true",
                    help="skip the tol=0 fixed-iteration pass (halves the "
                    "number of compiles; per_iter_us reported as null)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from _timing import setup

    platform = setup()
    paths = set(args.paths.split(","))

    B, M, N = args.batch, args.m, args.n
    rng = np.random.default_rng(0)
    As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    bs = rng.standard_normal((B, M)).astype(np.float32)
    lams = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
            ).astype(np.float32)
    Lfs = np.array([np.linalg.norm(As[i], 2) ** 2 for i in range(B)],
                   np.float32)
    A, b = jnp.asarray(As), jnp.asarray(bs)
    lam, Lf = jnp.asarray(lams), jnp.asarray(Lfs)

    out = []

    def record(name, solve_fn, n_problems, mean_iters_fn=None):
        dt, dt_min = timed(lambda: solve_fn(args.tol, args.maxit),
                           args.repeat)
        if args.skip_fixed:
            dt_fix = None
        else:
            dt_fix, _ = timed(lambda: solve_fn(0.0, args.fixed_it),
                              args.repeat)
        res = solve_fn(args.tol, args.maxit)
        iters = np.asarray(res[1])
        done = np.asarray(res[2])
        rec = {
            "path": name,
            "problems_per_sec": round(n_problems / dt, 2),
            "problems_per_sec_best": round(n_problems / dt_min, 2),
            "per_iter_us": (None if dt_fix is None
                            else round(dt_fix / args.fixed_it * 1e6, 2)),
            "mean_iters": round(float(iters.mean()), 1),
            "frac_converged": round(float(done.mean()), 4),
            "platform": platform,
            "shape": f"{B}x{M}x{N}",
        }
        out.append(rec)
        print(json.dumps(rec), flush=True)

    from proxtpu.kernels.lasso import solve_lasso_batch

    if "xla" in paths:
        record("xla",
               lambda tol, maxit: solve_lasso_batch(
                   A, b, lam, Lf, tol, maxit=maxit, use_kernel=False), B)

    if "generic" in paths:
        from proxtpu.algorithms.fast_forward_backward import (
            make_fast_forward_backward_iteration,
        )
        from proxtpu.parallel.batch import batched_run_loop
        from proxtpu.prox import LeastSquaresLoss, NormL1

        iteration = jax.vmap(
            lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
                x0=jnp.zeros(N, jnp.float32),
                f=LeastSquaresLoss(Ai, bi),
                g=NormL1(li),
                gamma=1.0 / Li,
            )
        )(A, b, lam, Lf)
        record("generic",
               lambda tol, maxit: batched_run_loop(iteration, maxit, tol), B)

    if "generic_k8" in paths:
        from proxtpu.algorithms.fast_forward_backward import (
            make_fast_forward_backward_iteration,
        )
        from proxtpu.parallel.batch import batched_run_loop
        from proxtpu.prox import LeastSquaresLoss, NormL1

        iteration = jax.vmap(
            lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
                x0=jnp.zeros(N, jnp.float32),
                f=LeastSquaresLoss(Ai, bi),
                g=NormL1(li),
                gamma=1.0 / Li,
            )
        )(A, b, lam, Lf)
        record("generic_k8",
               lambda tol, maxit: batched_run_loop(
                   iteration, maxit, tol, check_every=8), B)

    if "multirhs_k8" in paths:
        from proxtpu.kernels.lasso import solve_lasso_multirhs

        A0 = jnp.asarray(As[0])
        Lf0 = float(Lfs[0])
        record("multirhs_k8",
               lambda tol, maxit: solve_lasso_multirhs(
                   A0, b, lam, Lf0, tol, maxit=maxit, iter_block=8), B)

    if "multirhs_k8_restart" in paths:
        from proxtpu.kernels.lasso import solve_lasso_multirhs

        A0 = jnp.asarray(As[0])
        Lf0 = float(Lfs[0])
        record("multirhs_k8_restart",
               lambda tol, maxit: solve_lasso_multirhs(
                   A0, b, lam, Lf0, tol, maxit=maxit, iter_block=8,
                   restart=True), B)

    if "kernel" in paths:
        record("kernel",
               lambda tol, maxit: solve_lasso_batch(
                   A, b, lam, Lf, tol, maxit=maxit, use_kernel=True), B)

    if "multirhs" in paths:
        from proxtpu.kernels.lasso import solve_lasso_multirhs

        A0 = jnp.asarray(As[0])
        Lf0 = float(Lfs[0])
        record("multirhs_sharedA",
               lambda tol, maxit: solve_lasso_multirhs(
                   A0, b, lam, Lf0, tol, maxit=maxit), B)

    if "qp" in paths:
        from proxtpu.kernels.box_qp import solve_box_qp_batch

        for nq in (128, 256):
            Bq = args.batch
            rngq = np.random.default_rng(1)
            Us = rngq.standard_normal((Bq, nq, nq)).astype(np.float32)
            Qs = np.einsum("bij,bkj->bik", Us, Us) / nq
            Qs = (0.5 * (Qs + np.transpose(Qs, (0, 2, 1)))).astype(np.float32)
            qs = rngq.standard_normal((Bq, nq)).astype(np.float32)
            Lips = np.array([np.linalg.norm(Qs[i], 2) for i in range(Bq)],
                            np.float32)
            Qj, qj = jnp.asarray(Qs), jnp.asarray(qs)
            Lipj = jnp.asarray(Lips)

            record(f"qp_xla_{Bq}x{nq}",
                   lambda tol, maxit: solve_box_qp_batch(
                       Qj, qj, -1.0, 1.0, Lipj, tol, maxit=maxit), Bq)

    return out


if __name__ == "__main__":
    main()
