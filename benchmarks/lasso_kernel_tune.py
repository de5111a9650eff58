"""Tune the fused FISTA step kernel on one GPU.

For each batch width it checks the default configuration against the plain
XLA step, then times 200 chained iterations of the kernel over a grid of
``block_rows`` x ``num_warps`` x ``num_stages`` x ``splits`` and of the XLA
step (median of 5, fenced by ``jax.block_until_ready``), and prints one
JSON line per point with the A-once bandwidth.  The defaults of
``proxtpu.kernels.lasso._kernel_config`` come from this sweep.

    python benchmarks/lasso_kernel_tune.py [--widths 256,64] [--m 200] [--n 400]
        [--rows 8,16,32] [--warps 4,8] [--stages 1,2,3] [--splits 1,2,4]
"""

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup  # noqa: E402

ITERS = 200


def ints(s):
    return [int(v) for v in s.split(",")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="256,64")
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--rows", default="8,16,32")
    ap.add_argument("--warps", default="4,8")
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--splits", default="1,2,4")
    args = ap.parse_args()
    setup()

    import jax
    import jax.numpy as jnp

    from proxtpu.kernels.lasso import (
        _kernel_config,
        fused_fista_step,
        xla_fista_step,
    )

    M, N = args.m, args.n

    def median_per_iter(step, x, zp):
        @jax.jit
        def run(x, zp):
            def body(_, c):
                x_new, z, _, _ = step(*c)
                return x_new, z
            return jax.lax.fori_loop(0, ITERS, body, (x, zp))

        jax.block_until_ready(run(x, zp))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(run(x, zp))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / ITERS

    for B in ints(args.widths):
        rng = np.random.default_rng(0)
        A = jnp.asarray((rng.standard_normal((B, M, N)) / np.sqrt(M))
                        .astype(np.float32))
        b = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
        x = jnp.asarray(0.1 * rng.standard_normal((B, N)), jnp.float32)
        zp = jnp.asarray(0.1 * rng.standard_normal((B, N)), jnp.float32)
        Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                          for i in range(B)], jnp.float32)
        gamma = 1.0 / Lf
        thr = 0.1 * gamma
        beta = jnp.full((B,), 0.3, jnp.float32)
        done = jnp.zeros((B,), jnp.float32)
        common = (gamma, thr, done)

        got = fused_fista_step(A, b, x, zp, beta, *common, restart=True)
        want = xla_fista_step(A, b, x, zp, beta, *common, restart=True)
        err = max(float(jnp.max(jnp.abs(g - w))) for g, w in zip(got, want))
        a_bytes = B * M * N * 4
        t_xla = median_per_iter(
            lambda x, zp: xla_fista_step(A, b, x, zp, beta, *common,
                                         restart=True), x, zp)
        print(json.dumps({"width": B, "step": "xla", "us_per_iter":
                          round(t_xla * 1e6, 3), "default_config":
                          _kernel_config(B, M, N), "kernel_max_err": err}),
              flush=True)
        for rows, warps, stages, splits in itertools.product(
                ints(args.rows), ints(args.warps), ints(args.stages),
                ints(args.splits)):
            t = median_per_iter(
                lambda x, zp: fused_fista_step(
                    A, b, x, zp, beta, *common, restart=True,
                    block_rows=rows, num_warps=warps, num_stages=stages,
                    splits=splits), x, zp)
            print(json.dumps({
                "width": B, "step": "kernel", "block_rows": rows,
                "num_warps": warps, "num_stages": stages, "splits": splits,
                "us_per_iter": round(t * 1e6, 3),
                "a_once_gb_per_s": round(a_bytes / t / 1e9, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
