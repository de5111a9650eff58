"""Complex-dtype scenario batching.

The reference treats complex problems as first-class (``RealOrComplex``,
``real(dot(...))`` inner products, 4-dtype sweeps in
``test/problems/test_lasso_small.jl:16``); the single-problem drivers here
match that.  These tests extend the sweep to the batched paths:
the generic vmapped driver and the flat line-search machines must preserve
complex dtypes and reproduce the single driver's per-lane solutions, with
and without a Shared (lane-invariant) operand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms import PANOC, FastForwardBackward
from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.algorithms.panoc import make_panoc_iteration
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.prox import LeastSquaresLoss, NormL1, SqrDistance

B, M, N = 4, 24, 16
TOL = 1e-6
DTYPES = [jnp.complex64, jnp.complex128]


def complex_lasso(dtype):
    rng = np.random.default_rng(11)
    A = jnp.asarray(
        (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N)))
        / np.sqrt(2 * M), dtype,
    )
    b = jnp.asarray(
        rng.standard_normal(M) + 1j * rng.standard_normal(M), dtype
    )
    lam = jnp.asarray(
        0.1 + 0.2 * rng.random(B), jnp.real(jnp.zeros((), dtype)).dtype
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    return A, b, lam, Lf


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_batched_complex_matches_single(dtype):
    A, b, lam, Lf = complex_lasso(dtype)
    x0 = jnp.zeros((B, N), dtype)
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=5000, tol=TOL,
        use_kernels=False,
    )
    atol = 1e-4 if dtype == jnp.complex64 else 1e-6
    for f in (Shared(LeastSquaresLoss(A, b)),
              LeastSquaresLoss(jnp.broadcast_to(A, (B, M, N)),
                               jnp.broadcast_to(b, (B, M)))):
        xs, iters, done = solver(x0=x0, f=f, g=NormL1(lam), Lf=Lf)
        assert xs.dtype == jnp.dtype(dtype)
        assert bool(done.all())
        single = FastForwardBackward(maxit=5000, tol=TOL)
        for i in range(B):
            x, it = single(
                x0=jnp.zeros(N, dtype), f=LeastSquaresLoss(A, b),
                g=NormL1(lam[i]), Lf=Lf,
            )
            np.testing.assert_allclose(
                np.asarray(xs[i]), np.asarray(x), rtol=0, atol=atol
            )
            # c64 counts drift at the knife edge (rounding chaos over
            # hundreds of iterations); c128 matches tightly
            slack = 2 if dtype == jnp.complex128 else max(5, it // 10)
            assert abs(int(iters[i]) - it) <= slack


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_panoc_batched_complex_matches_single(dtype):
    A, b, lam, Lf = complex_lasso(dtype)
    x0 = jnp.zeros((B, N), dtype)
    solver = BatchedAlgorithm(make_panoc_iteration, maxit=1000, tol=TOL)
    atol = 1e-4 if dtype == jnp.complex64 else 1e-6
    xs, iters, done = solver(
        x0=x0, f=Shared(SqrDistance(b)), A=Shared(MatrixOperator(A)),
        g=NormL1(lam), Lf=Lf, adaptive=False,
    )
    assert xs.dtype == jnp.dtype(dtype)
    assert bool(done.all())
    single = PANOC(maxit=1000, tol=TOL)
    for i in range(B):
        x, it = single(
            x0=jnp.zeros(N, dtype), f=SqrDistance(b), A=A,
            g=NormL1(lam[i]), Lf=Lf, adaptive=False,
        )
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=atol
        )
        slack = 3 if dtype == jnp.complex128 else max(5, it // 10)
        assert abs(int(iters[i]) - it) <= slack


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_flat_adaptive_batched_complex_matches_single(dtype):
    """The two-mode adaptive flat machines preserve complex dtypes and
    match the single adaptive drivers per lane (gamma decisions are real
    scalars; iterates complex)."""
    from proxtpu.algorithms import ZeroFPR
    from proxtpu.algorithms.zerofpr import make_zerofpr_iteration

    A, b, lam, Lf = complex_lasso(dtype)
    x0 = jnp.zeros((B, N), dtype)
    gamma0 = 10.0 * 0.95 / Lf  # hot start: the gamma search engages
    atol = 1e-4 if dtype == jnp.complex64 else 1e-8
    solver = BatchedAlgorithm(make_zerofpr_iteration, maxit=1000, tol=TOL)
    xs, iters, done = solver(
        x0=x0, f=Shared(SqrDistance(b)), A=Shared(MatrixOperator(A)),
        g=NormL1(lam), gamma=jnp.full((B,), gamma0, x0.real.dtype),
        adaptive=True,
    )
    assert xs.dtype == jnp.dtype(dtype)
    assert bool(done.all())
    single = ZeroFPR(maxit=1000, tol=TOL)
    for i in range(B):
        x, it = single(
            x0=jnp.zeros(N, dtype), f=SqrDistance(b), A=A,
            g=NormL1(lam[i]), gamma=gamma0, adaptive=True,
        )
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=atol
        )
        slack = 2 if dtype == jnp.complex128 else max(5, it // 10)
        assert abs(int(iters[i]) - it) <= slack
