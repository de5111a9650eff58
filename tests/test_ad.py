"""AD seam — mirrors ``test/utilities/test_ad.jl``.

``value_and_gradient`` must (1) prefer a hand-written oracle when present,
(2) fall back to jax.value_and_grad, and (3) return the Zygote/Wirtinger
convention gradient for complex inputs, i.e. the conjugate of what
``jax.grad`` produces, so that ``x - gamma * grad`` is a descent step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.prox import Quadratic
from proxtpu.prox.base import value_and_gradient

DTYPES = [jnp.float32, jnp.float64, jnp.complex64, jnp.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
def test_autodiff_matches_hand_gradient(dtype):
    rng = np.random.default_rng(0)
    n = 6
    Qr = rng.standard_normal((n, n))
    Q = Qr @ Qr.T
    if jnp.issubdtype(dtype, jnp.complexfloating):
        Qc = rng.standard_normal((n, n))
        Q = Q + 1j * (Qc - Qc.T)  # Hermitian
    Q = jnp.asarray(Q, dtype)
    q = jnp.asarray(rng.standard_normal(n), dtype)
    x = jnp.asarray(rng.standard_normal(n), dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        x = x + 1j * jnp.asarray(rng.standard_normal(n), dtype)

    hand = Quadratic(Q, q)  # provides value_and_gradient
    auto = pa.AutoDifferentiable(
        lambda u: jnp.real(jnp.vdot(u, Q @ u)) / 2
        + jnp.real(jnp.vdot(q, u))
    )
    vh, gh = value_and_gradient(hand, x)
    va, ga = value_and_gradient(auto, x)
    np.testing.assert_allclose(float(vh), float(va), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(gh), np.asarray(ga), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_complex_gradient_is_descent_direction(dtype):
    rng = np.random.default_rng(1)
    n = 5
    x = jnp.asarray(
        rng.standard_normal(n) + 1j * rng.standard_normal(n), dtype
    )
    f = pa.AutoDifferentiable(lambda u: jnp.sum(jnp.abs(u) ** 2))
    val, grad = value_and_gradient(f, x)
    # descent: f(x - t*grad) < f(x) for small t
    t = 1e-3
    val2, _ = value_and_gradient(f, x - t * grad)
    assert float(val2) < float(val)
    # for |u|^2, Wirtinger gradient is 2u
    np.testing.assert_allclose(
        np.asarray(grad), 2 * np.asarray(x), rtol=1e-5
    )


def test_hand_oracle_preferred_over_ad():
    calls = []

    class Weird:
        def __call__(self, x):
            return jnp.sum(x**2)

        def value_and_gradient(self, x):
            calls.append(1)
            return jnp.sum(x**2), 99.0 * jnp.ones_like(x)  # deliberately wrong

    _, g = value_and_gradient(Weird(), jnp.ones(3))
    assert calls  # the hand oracle was used
    np.testing.assert_allclose(np.asarray(g), 99.0 * np.ones(3))


def test_quadratic_matrix_iterate():
    """Quadratic must keep supporting matrix-valued operands —
    pmatvec((n,n), (n,k)) is a matmul, not a mis-broadcast einsum — while
    preserving the batched-(B,n,n)/(B,n) per-lane matvec it was added for."""
    from proxtpu.utils.precision import pmatvec

    rng = np.random.default_rng(3)
    n, k, B = 5, 3, 4
    Q = jnp.asarray(rng.standard_normal((n, n)))
    X = jnp.asarray(rng.standard_normal((n, k)))
    np.testing.assert_allclose(np.asarray(pmatvec(Q, X)),
                               np.asarray(Q) @ np.asarray(X), atol=1e-12)
    # batched matrices x batched vectors: per-lane matvec
    Qb = jnp.asarray(rng.standard_normal((B, n, n)))
    xb = jnp.asarray(rng.standard_normal((B, n)))
    np.testing.assert_allclose(
        np.asarray(pmatvec(Qb, xb)),
        np.einsum("bij,bj->bi", np.asarray(Qb), np.asarray(xb)), atol=1e-12)
    # batched matrices x batched matrix iterates
    Xb = jnp.asarray(rng.standard_normal((B, n, k)))
    np.testing.assert_allclose(
        np.asarray(pmatvec(Qb, Xb)),
        np.einsum("bij,bjk->bik", np.asarray(Qb), np.asarray(Xb)),
        atol=1e-12)
    # the original Quadratic-with-matrix-gradient path
    grad_val = pmatvec(Q, X) + jnp.zeros((n, k))
    assert grad_val.shape == (n, k)
