"""Worker for the real multi-process test (NOT collected by pytest).

Run by ``tests/test_multiprocess.py`` as 2 OS processes, each owning 4
virtual CPU devices.  ``proxtpu.parallel.initialize_distributed`` brings up
the JAX distributed runtime (Gloo collectives between processes — the same
code path a multi-host cluster takes over the network), ``global_mesh`` builds an
8-device mesh spanning both processes, and the UNMODIFIED jitted batched
solver runs SPMD over it: the ``jnp.all(done)`` stopping reduction becomes
a real cross-process collective every convergence check.

Each process then solves the same batch locally (plain jit on its own
device 0) and asserts lane-for-lane parity of solutions AND iteration
counts — the multi-host program must change nothing but the device set.

Usage: python multiprocess_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from proxtpu.parallel import global_mesh, initialize_distributed

    n = initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=nprocs,
        process_id=pid,
    )
    assert n == nprocs, f"process_count {n} != {nprocs}"
    n_global = jax.device_count()
    assert n_global == 4 * nprocs

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from proxtpu.kernels.lasso import solve_lasso_batch

    # identical data in every process (same seed) — the sharded run sees it
    # dp-split across processes, the local run sees all of it
    rng = np.random.default_rng(11)
    B, M, N = 2 * n_global, 12, 20
    dtype = np.float32
    A_np = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(dtype)
    b_np = rng.standard_normal((B, M)).astype(dtype)
    lam_np = 0.1 * np.max(
        np.abs(np.einsum("bmn,bm->bn", A_np, b_np)), axis=1
    ).astype(dtype)
    Lf_np = np.array(
        [np.linalg.norm(A_np[i], 2) ** 2 for i in range(B)], dtype
    )
    tol, maxit = 1e-5, 3000

    mesh = global_mesh((n_global,), ("dp",))
    dp = NamedSharding(mesh, P("dp"))

    def gshard(x_np, spec):
        return jax.make_array_from_callback(
            x_np.shape, NamedSharding(mesh, spec), lambda idx: x_np[idx]
        )

    A = gshard(A_np, P("dp", None, None))
    b = gshard(b_np, P("dp", None))
    lam = gshard(lam_np, P("dp"))
    Lf = gshard(Lf_np, P("dp"))

    z_s, it_s, d_s = solve_lasso_batch(
        A, b, lam, Lf, tol, maxit=maxit, use_kernel=False
    )

    from jax.experimental import multihost_utils

    z_g = np.asarray(multihost_utils.process_allgather(z_s, tiled=True))
    it_g = np.asarray(multihost_utils.process_allgather(it_s, tiled=True))
    d_g = np.asarray(multihost_utils.process_allgather(d_s, tiled=True))

    # local reference on this process's device 0 (no mesh, no collectives)
    dev0 = jax.local_devices()[0]
    z_l, it_l, d_l = solve_lasso_batch(
        jax.device_put(A_np, dev0), jax.device_put(b_np, dev0),
        jax.device_put(lam_np, dev0), jax.device_put(Lf_np, dev0),
        tol, maxit=maxit, use_kernel=False,
    )

    assert bool(d_g.all()) and bool(np.asarray(d_l).all())
    np.testing.assert_array_equal(it_g, np.asarray(it_l))
    np.testing.assert_allclose(z_g, np.asarray(z_l), atol=1e-6)
    print(f"proc {pid}: multiprocess solve OK "
          f"(global devices={n_global}, batch={B})", flush=True)


if __name__ == "__main__":
    main()
