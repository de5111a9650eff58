"""Example: a full lasso regularization path in one batched solve.

The classic use of scenario batching: sweep the regularization strength
lambda over a grid and solve every point of the path simultaneously — one
vmapped FISTA drive, per-lambda iteration counts, warm data reuse.

    python examples/lasso_path.py
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from proxtpu.algorithms import make_fast_forward_backward_iteration
from proxtpu.parallel import Shared, batched_run_loop
from proxtpu.prox import LeastSquaresLoss, NormL1


def main():
    rng = np.random.default_rng(0)
    m, n, k = 100, 200, 10
    A = jnp.asarray((rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32))
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    b = A @ jnp.asarray(x_true) + 0.01 * jnp.asarray(
        rng.standard_normal(m).astype(np.float32)
    )

    lam_max = float(jnp.max(jnp.abs(A.T @ b)))
    lams = jnp.asarray(
        np.geomspace(lam_max, 1e-3 * lam_max, 64).astype(np.float32)
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)

    # the data is IDENTICAL across the path, so mark it Shared — the
    # batched driver maps it with in_axes=None and every per-lambda
    # matvec runs as one matmul instead of streaming one copy of A per
    # lane (see docs/scaling.md)
    iteration = make_fast_forward_backward_iteration(
        x0=jnp.zeros((lams.shape[0], n), jnp.float32),
        f=Shared(LeastSquaresLoss(A, b)),
        g=NormL1(lams),
        gamma=jnp.full((lams.shape[0],), 1.0 / Lf, jnp.float32),
    )

    xs, iters, done = batched_run_loop(iteration, maxit=5000, tol=1e-5)
    nnz = jnp.sum(jnp.abs(xs) > 1e-6, axis=1)

    print(f"{'lambda':>12} {'nnz':>5} {'iters':>6}")
    for i in range(0, 64, 8):
        print(f"{float(lams[i]):12.5f} {int(nnz[i]):5d} {int(iters[i]):6d}")
    print(f"all converged: {bool(jnp.all(done))}")

    # Because every path point shares the SAME design matrix, the whole
    # path also fits the shared-A matmul formulation — one (64,n)@(n,m)
    # matmul per iteration instead of 64 per-lane matvecs:
    from proxtpu.kernels import solve_lasso_multirhs

    Bmat = jnp.broadcast_to(b, (lams.shape[0], m))
    xs2, iters2, done2 = solve_lasso_multirhs(
        A, Bmat, lams, Lf, 1e-5, maxit=5000
    )
    agree = bool(jnp.max(jnp.abs(xs2 - xs)) < 1e-3)
    print(f"multirhs path: converged={bool(jnp.all(done2))}, "
          f"matches vmapped path: {agree}")


if __name__ == "__main__":
    main()
