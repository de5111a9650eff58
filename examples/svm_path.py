"""Example: a soft-margin SVM regularization path in one batched solve.

min_x (1/m) sum_i max(0, 1 - y_i <a_i, x>) + lam/2 ||x||^2

The hinge term is nonsmooth and composed with the data matrix, so each
solve is a primal-dual (Chambolle-Pock) run; the lam sweep becomes ONE
batched drive with the data matrix marked ``Shared`` (lane-invariant:
the per-lane matvecs lower to one matmul).

    python examples/svm_path.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from proxtpu.algorithms.primal_dual import make_afba_iteration
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.prox import HingeLoss, SqrNormL2


def main():
    rng = np.random.default_rng(0)
    m, n, B = 200, 50, 16
    w_true = rng.standard_normal(n)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sign(A @ w_true + 0.2 * rng.standard_normal(m)).astype(np.float32)
    A, y = jnp.asarray(A), jnp.asarray(y)

    lams = jnp.asarray(np.geomspace(1e-3, 1.0, B).astype(np.float32))
    opnorm = float(jnp.linalg.norm(A, 2))
    gam = jnp.full((B,), 0.9 / opnorm, jnp.float32)

    solver = BatchedAlgorithm(
        make_afba_iteration, maxit=50_000, tol=1e-4, use_kernels=False
    )
    (xs, _ys), iters, done = solver(
        x0=jnp.zeros((B, n), jnp.float32),
        y0=jnp.zeros((B, m), jnp.float32),
        g=SqrNormL2(lams),                    # per-lane ridge strength
        h=Shared(HingeLoss(y, 1.0 / m)),      # one dataset, all lanes
        L=Shared(A),
        theta=2.0, gamma1=gam, gamma2=gam,    # Chambolle-Pock stepsizes
    )

    margins = np.asarray(y)[None, :] * (np.asarray(xs) @ np.asarray(A).T)
    acc = (margins > 0).mean(axis=1)
    print(f"{'lam':>10} | {'iters':>6} | {'|x|':>8} | train acc")
    for i in range(B):
        print(
            f"{float(lams[i]):10.4f} | {int(iters[i]):6d} | "
            f"{float(jnp.linalg.norm(xs[i])):8.3f} | {acc[i]:.3f}"
        )
    assert bool(jnp.all(done))


if __name__ == "__main__":
    main()
