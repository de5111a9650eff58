"""Batched TV-denoising throughput (the north star's second workload family).

Paths, measured back-to-back in one process (median of --repeat runs,
fenced by ``jax.block_until_ready``):

* generic — vmapped Chambolle-Pock through the batched driver (the path any
  algorithm gets for free);
* blocked — :func:`proxtpu.kernels.tv.solve_tv_batch`, the XLA step with
  K iterations per while-loop trip;
* mxu — the same harness with the stencils as bidiagonal matmuls
  (``formulation="mxu"``).

    python benchmarks/tv_bench.py [--repeat 5] [--batch 64] [--hw 64]

Prints one JSON line per path: images/s to the FPR tolerance, with mean
per-image iteration counts from the per-lane convergence masks.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAM = 0.12
TOL = 1e-4
MAXIT = 5000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--paths", default="generic,blocked")
    ap.add_argument("--iter-block", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _timing import setup

    platform = setup()

    from proxtpu.algorithms.primal_dual import make_chambolle_pock_iteration
    from proxtpu.kernels.tv import solve_tv_batch
    from proxtpu.ops.linops import Grad2DOperator
    from proxtpu.parallel.batch import batched_run_loop
    from proxtpu.prox import NormL21, SqrDistance

    BATCH, H, W = args.batch, args.hw, args.hw
    rng = np.random.default_rng(0)
    clean = np.zeros((BATCH, H, W), np.float32)
    clean[:, H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1.0
    noisy = jnp.asarray(
        clean + 0.15 * rng.standard_normal((BATCH, H, W)).astype(np.float32)
    )

    def timed(solve):
        xs, iters, done = jax.block_until_ready(solve())  # compile + warm
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            jax.block_until_ready(solve())
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), np.asarray(iters), np.asarray(done)

    paths = args.paths.split(",")
    results = {}

    if "generic" in paths:
        iteration = jax.vmap(
            lambda y: make_chambolle_pock_iteration(
                x0=jnp.zeros((H, W), jnp.float32),
                y0=jnp.zeros((2, H, W), jnp.float32),
                g=SqrDistance(y),
                h=NormL21(LAM, axis=0),
                L=Grad2DOperator((H, W)),
            )
        )(noisy)

        def solve_generic():
            sols, iters, done = batched_run_loop(iteration, MAXIT, TOL)
            return sols[0], iters, done

        dt, iters, done = timed(solve_generic)
        results["generic"] = BATCH / dt
        print(json.dumps({
            "metric": "batched_tv_denoise_images_per_sec",
            "path": "generic",
            "value": round(BATCH / dt, 2),
            "unit": f"images/s ({H}x{W}, CP to FPR {TOL}, batch={BATCH}, "
                    f"{platform})",
            "mean_it": round(float(iters.mean()), 1),
            "all_done": bool(done.all()),
        }), flush=True)

    if "blocked" in paths:
        def solve_blocked():
            return solve_tv_batch(
                noisy, LAM, TOL, maxit=MAXIT, iter_block=args.iter_block,
            )

        dt, iters, done = timed(solve_blocked)
        results["blocked"] = BATCH / dt
        rec = {
            "metric": "batched_tv_denoise_images_per_sec",
            "path": "blocked",
            "value": round(BATCH / dt, 2),
            "unit": f"images/s ({H}x{W}, CP to FPR {TOL}, batch={BATCH}, "
                    f"{platform}, K={args.iter_block})",
            "mean_it": round(float(iters.mean()), 1),
            "all_done": bool(done.all()),
        }
        if "generic" in results:
            rec["speedup_vs_generic"] = round(
                results["blocked"] / results["generic"], 2
            )
        print(json.dumps(rec), flush=True)

    if "mxu" in paths:
        # matmul-stencil formulation: gradient/divergence as bidiagonal
        # matmul contractions (proxtpu.kernels.tv.mxu_cp_step) through the
        # same iteration-blocked harness
        def solve_mxu():
            return solve_tv_batch(
                noisy, LAM, TOL, maxit=MAXIT, iter_block=args.iter_block,
                formulation="mxu",
            )

        dt, iters, done = timed(solve_mxu)
        results["mxu"] = BATCH / dt
        rec = {
            "metric": "batched_tv_denoise_images_per_sec",
            "path": "mxu_stencil",
            "value": round(BATCH / dt, 2),
            "unit": f"images/s ({H}x{W}, CP to FPR {TOL}, batch={BATCH}, "
                    f"{platform}, K={args.iter_block})",
            "mean_it": round(float(iters.mean()), 1),
            "all_done": bool(done.all()),
        }
        for other in ("generic", "blocked"):
            if other in results:
                rec[f"speedup_vs_{other}"] = round(
                    results["mxu"] / results[other], 2
                )
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
