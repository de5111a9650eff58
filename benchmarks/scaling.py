"""Multi-device scaling-efficiency harness for the dp-sharded batched solve.

Runs the batched lasso solver with the scenario batch sharded over a 1-axis
('dp') mesh of 1/2/4/.../N devices — weak scaling: a fixed per-device batch,
so perfect scaling doubles problems/s when the device count doubles.
Reports problems/s and efficiency vs the 1-device run:

    efficiency(d) = p/s(d) / (d * p/s(1))

On a multi-GPU host the mesh is the host's cards
(`python benchmarks/scaling.py --devices 1,2,4`); `--platform cpu` runs
it on 8 virtual CPU devices instead (plumbing validation only — virtual
devices share host cores, so "efficiency" there validates the sharded
program, not the interconnect).

Prints one JSON line per device count.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gen_problems(batch, m, n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    As = (rng.standard_normal((batch, m, n)) / np.sqrt(m)).astype(dtype)
    bs = rng.standard_normal((batch, m)).astype(dtype)
    lams = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
            ).astype(dtype)
    Lfs = np.array([np.linalg.norm(As[i], 2) ** 2 for i in range(batch)],
                   dtype=dtype)
    return As, bs, lams, Lfs


def run_at_device_count(d, batch_per_device, m, n, tol, maxit, repeat,
                        path="generic", tp=2):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from proxtpu.kernels.lasso import solve_lasso_batch
    from proxtpu.parallel import (
        sharded_solve_lasso_batch,
        sharded_solve_lasso_multirhs,
    )

    if path == "shared_tp":
        # 2-axis mesh: lanes over dp, the ONE design matrix row-sharded
        # over tp (the huge-matrix regularization-path composition)
        tp = min(tp, d)
        if d % tp:
            raise ValueError(f"device count {d} not divisible by tp={tp}")
        mesh = Mesh(
            np.asarray(jax.devices()[:d]).reshape(d // tp, tp),
            ("dp", "tp"),
        )
    else:
        mesh = Mesh(np.asarray(jax.devices()[:d]), ("dp",))
    B = batch_per_device * d
    As, bs, lams, Lfs = gen_problems(B, m, n)

    shard = lambda x, spec: jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, spec)
    )
    A = shard(As, P("dp", None, None))
    b = shard(bs, P("dp", None))
    lam = shard(lams, P("dp"))
    Lf = shard(Lfs, P("dp"))

    if path == "kernel":
        # the step lasso_step_route picks: the fused kernel for float32 on
        # a GPU, the XLA step on the CPU
        def run():
            return sharded_solve_lasso_batch(
                A, b, lam, Lf, tol, mesh=mesh, maxit=maxit,
            )
    elif path == "multirhs":
        # shared-A formulation: one design matrix, B right-hand sides
        A1 = jnp.asarray(As[0])
        Lf1 = float(np.linalg.norm(As[0], 2) ** 2)

        def run():
            return sharded_solve_lasso_multirhs(
                A1, b, lam, Lf1, tol, mesh=mesh, maxit=maxit, iter_block=8,
            )
    elif path == "shared":
        # Shared (lane-invariant) operand through the GENERIC driver under
        # plain GSPMD: lanes dp-sharded, the one design matrix replicated —
        # no shard_map, no kernel; XLA partitions the in_axes=None vmap
        from proxtpu.algorithms import make_fast_forward_backward_iteration
        from proxtpu.parallel import Shared, batched_run_loop
        from proxtpu.prox import LeastSquaresLoss, NormL1

        A1 = jnp.asarray(As[0])
        Lf1 = float(np.linalg.norm(As[0], 2) ** 2)
        iteration = make_fast_forward_backward_iteration(
            x0=shard(np.zeros((B, n), As.dtype), P("dp", None)),
            f=Shared(LeastSquaresLoss(A1, jnp.asarray(bs[0]))),
            g=NormL1(lam), Lf=Lf1,
        )

        def run():
            return batched_run_loop(iteration, maxit, tol, check_every=8)
    elif path == "shared_tp":
        # dp x tp composed: one A row-sharded over tp serving a
        # dp-sharded lam-path batch; GSPMD emits local matmuls + psum over
        # tp (parity pinned in tests/test_sharding.py and the dryrun)
        from proxtpu.algorithms import make_fast_forward_backward_iteration
        from proxtpu.parallel import Shared, batched_run_loop
        from proxtpu.prox import LeastSquaresLoss, NormL1

        A1 = shard(As[0], P("tp", None))
        b1 = shard(bs[0], P("tp"))
        Lf1 = float(np.linalg.norm(As[0], 2) ** 2)
        iteration = make_fast_forward_backward_iteration(
            x0=shard(np.zeros((B, n), As.dtype), P("dp", None)),
            f=Shared(LeastSquaresLoss(A1, b1)),
            g=NormL1(shard(lams, P("dp"))), Lf=Lf1,
        )

        def run():
            return batched_run_loop(iteration, maxit, tol, check_every=8)
    elif path == "flat_zerofpr":
        # flat trial/commit line-search machine under plain GSPMD dp
        # sharding (tests/test_sharding.py::test_flat_machines_dp_sharded
        # pins parity); the fastest distinct-A solver measured
        from proxtpu.ops.linops import MatrixOperator
        from proxtpu.parallel import batched_zerofpr
        from proxtpu.prox import NormL1, SqrDistance

        f = jax.vmap(SqrDistance)(b)
        Aop = jax.vmap(MatrixOperator)(A)
        gamma = 0.95 / Lf
        x0 = shard(np.zeros((B, n), As.dtype), P("dp", None))

        def run():
            return batched_zerofpr(
                f, Aop, NormL1(lam), x0, gamma, tol, maxit=maxit
            )
    else:
        def run():
            return solve_lasso_batch(
                A, b, lam, Lf, tol, maxit=maxit, use_kernel=False
            )

    with mesh:
        xs, iters, done = jax.block_until_ready(run())  # compile + warm
        times = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append(time.perf_counter() - t0)
    iters, done = np.asarray(iters), np.asarray(done)
    dt = float(np.median(times))
    return {
        "devices": d,
        "batch": B,
        "path": path,
        "problems_per_sec": round(B / dt, 2),
        "mean_iters": round(float(iters.mean()), 1),
        "converged": bool(done.all()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="comma-separated device counts (default 1,2,...,N)")
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxit", type=int, default=2000)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--platform", default=None)
    ap.add_argument(
        "--path", default="generic",
        choices=["generic", "kernel", "multirhs", "shared",
                 "shared_tp", "flat_zerofpr"],
        help="solver formulation: generic pure-XLA batched step, the "
             "routed batched-lasso step (fused kernel on a GPU), the "
             "shared-A multirhs solve (all dp-sharded via shard_map), "
             "the generic driver with a Shared operand under plain "
             "GSPMD (lanes dp-sharded, operand replicated), the dp x tp "
             "composition (Shared operand row-sharded over tp, lanes over "
             "dp; use --tp for the tp extent), or the flat ZeroFPR "
             "trial/commit machine under GSPMD dp",
    )
    ap.add_argument("--tp", type=int, default=2,
                    help="tp-axis extent for --path shared_tp (device "
                    "count must be divisible by it)")
    args = ap.parse_args()

    if args.platform == "cpu" and "XLA_FLAGS" not in os.environ:
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _timing import setup

    platform = setup(args.platform)
    n_dev = len(jax.devices())
    if args.devices:
        counts = [int(c) for c in args.devices.split(",")]
    else:
        counts = [1 << i for i in range(n_dev.bit_length()) if (1 << i) <= n_dev]

    base = None
    for d in counts:
        if d > n_dev:
            print(json.dumps({"devices": d, "skipped": "not enough devices"}))
            continue
        rec = run_at_device_count(
            d, args.batch_per_device, args.m, args.n, args.tol, args.maxit,
            args.repeat, path=args.path, tp=args.tp,
        )
        if base is None:
            base = rec["problems_per_sec"] / rec["devices"]
        rec["efficiency_vs_1dev"] = round(
            rec["problems_per_sec"] / (rec["devices"] * base), 3
        )
        rec["platform"] = platform
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
