"""Example: reference-grade tolerances (1e-6 .. 1e-8) on an accelerator, fast.

The reference's accuracy class (``test/problems/test_lasso_small.jl:42-53``
solves to tol=1e-6) needs float64, which costs more per iteration than
float32 — a cold f64 batched solve re-pays hundreds of f32-reachable
iterations at that cost.  ``WarmStartedBatchedAlgorithm`` removes that waste: stage 1 solves
the batch in float32 to the f32 noise floor, stage 2 polishes in float64
from the warm iterate with the SAME stopping criterion
(``benchmarks/x64_batched.py`` measures warm against cold).

Requires ``jax_enable_x64`` (set before any jax op).

    python examples/reference_tolerances.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from proxtpu.accel import AdaptiveRestartSequence
from proxtpu.algorithms import make_fast_forward_backward_iteration
from proxtpu.parallel import Shared, WarmStartedBatchedAlgorithm
from proxtpu.prox import LeastSquaresLoss, NormL1


def main(m=40, n=80, path_points=16, tol=1e-8, verbose=True):
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), jnp.float64)
    b = jnp.asarray(rng.standard_normal(m), jnp.float64)
    lam_max = float(jnp.max(jnp.abs(A.T @ b)))
    lams = jnp.asarray(
        np.geomspace(0.5 * lam_max, 0.02 * lam_max, path_points), jnp.float64
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)

    # at tol <= 1e-8, adaptive restart caps the slow lanes' momentum
    # oscillation; at 1e-6 leave it off — too few polish iterations remain
    # to pay for the per-step restart check
    restart = (dict(extrapolation_sequence=AdaptiveRestartSequence())
               if tol <= 1e-8 else {})
    solver = WarmStartedBatchedAlgorithm(
        make_fast_forward_backward_iteration,
        maxit=100_000, tol=tol, use_kernels=False, **restart,
    )
    xs, iters, done = solver(
        x0=jnp.zeros((path_points, n), jnp.float64),
        f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf,
    )
    assert bool(jnp.all(done)), "every path point must converge"

    # recompute the stopping quantity on the host — each solution must
    # genuinely satisfy the f64 criterion
    A64, b64 = np.asarray(A), np.asarray(b)
    gam = 1.0 / Lf
    worst = 0.0
    for i in range(path_points):
        x = np.asarray(xs[i])
        y = x - gam * (A64.T @ (A64 @ x - b64))
        z = np.sign(y) * np.maximum(np.abs(y) - gam * float(lams[i]), 0.0)
        worst = max(worst, float(np.max(np.abs(x - z)) / gam))
    nnz = np.asarray(jnp.sum(jnp.abs(xs) > 10 * tol, axis=1))

    if verbose:
        print(f"solved {path_points}-point lasso path to tol={tol:g} in f64")
        print(f"per-lane iterations (warm stage included): "
              f"{np.asarray(iters).min()}..{np.asarray(iters).max()}")
        print(f"worst recomputed residual: {worst:.2e} (tol {tol:g})")
        print(f"support sizes along the path: {nnz.tolist()}")
    return {"iters": np.asarray(iters), "worst_residual": worst,
            "nnz": nnz, "xs": np.asarray(xs)}


if __name__ == "__main__":
    main()
