"""Example: multi-task (group) lasso — joint row-sparse recovery.

min_X  1/2 ||A X - B||_F^2 + lam * sum_i ||X[i, :]||_2

T regression tasks share the design matrix A and (unknown to the solver)
the same active feature set; the l2,1 penalty couples them so features
switch on/off jointly across tasks.  The iterate is the whole (n, T)
coefficient MATRIX — the solvers are generic over array iterates, so
FISTA runs on it unchanged, and every matmul carries all T tasks.

    python examples/multitask_lasso.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from proxtpu.algorithms import FastForwardBackward
from proxtpu.prox import LeastSquaresLoss, NormL21


def main(verbose=True):
    rng = np.random.default_rng(0)
    m, n, T, k = 80, 160, 6, 8
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    support = np.sort(rng.choice(n, k, replace=False))
    X_true = np.zeros((n, T), np.float32)
    X_true[support] = rng.standard_normal((k, T)) + np.sign(
        rng.standard_normal((k, 1))
    ) * 2.0
    B = A @ X_true + 0.01 * rng.standard_normal((m, T)).astype(np.float32)
    A, B = jnp.asarray(A), jnp.asarray(B)

    lam = 0.1 * float(jnp.max(jnp.linalg.norm(A.T @ B, axis=1)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)

    solver = FastForwardBackward(tol=1e-6, maxit=20_000)
    X, it = solver(
        x0=jnp.zeros((n, T), jnp.float32),
        f=LeastSquaresLoss(A, B),
        g=NormL21(lam, axis=1),   # rows are the groups: joint selection
        Lf=Lf,
    )

    row_norms = np.linalg.norm(np.asarray(X), axis=1)
    selected = np.sort(np.nonzero(row_norms > 0.1)[0])
    if verbose:
        print(f"iterations: {int(it)}")
        print(f"true support: {support.tolist()}")
        print(f"selected    : {selected.tolist()}")
        resid = float(jnp.linalg.norm(A @ X - B) / jnp.linalg.norm(B))
        print(f"relative residual: {resid:.4f}")
    return {
        "iterations": int(it),
        "support": support,
        "selected": selected,
        "X": np.asarray(X),
    }


if __name__ == "__main__":
    main()
