"""TV denoising — the imaging workload of the primal-dual family.

    minimize  1/2 ||x - y||^2 + lam * TV(x),   TV = isotropic ||grad x||_{2,1}

solved via Chambolle-Pock with the implicit 2-D gradient operator
(:class:`~proxtpu.ops.linops.Grad2DOperator`, ||L||^2 <= 8) and via AFBA
with the smooth data term; cross-algorithm agreement is the correctness
oracle (TV denoising is a solution-parity workload; the
reference has no TV test, so there is no hardcoded solution to pin).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.ops.linops import Grad2DOperator
from proxtpu.prox import NormL21, SqrDistance


@pytest.fixture(scope="module")
def noisy_image():
    rng = np.random.default_rng(0)
    H = W = 16
    img = np.zeros((H, W))
    img[4:12, 4:12] = 1.0  # square
    img[8:, :] += 0.5
    noisy = img + 0.1 * rng.standard_normal((H, W))
    return jnp.asarray(noisy)


def tv_objective(x, y, lam):
    L = Grad2DOperator(tuple(y.shape))
    g = L.matvec(x)
    tv = jnp.sum(jnp.sqrt(jnp.sum(g**2, axis=0)))
    return 0.5 * jnp.sum((x - y) ** 2) + lam * tv


def test_chambolle_pock_tv(noisy_image):
    y = noisy_image
    lam = 0.1
    L = Grad2DOperator(tuple(y.shape))
    solver = pa.ChambollePock(tol=1e-6, maxit=20_000)
    (x, dual), it = solver(
        x0=jnp.zeros_like(y),
        y0=jnp.zeros((2,) + tuple(y.shape)),
        g=SqrDistance(y),
        h=NormL21(lam, axis=0),
        L=L,
    )
    assert it < 20_000
    # denoised image stays near data and reduces the objective vs the data
    assert float(tv_objective(x, y, lam)) < float(tv_objective(y, y, lam))
    # flat regions flattened: TV of solution well below TV of noisy input
    g_noisy = L.matvec(y)
    g_x = L.matvec(x)
    assert float(jnp.sum(jnp.abs(g_x))) < 0.5 * float(jnp.sum(jnp.abs(g_noisy)))


def test_tv_cross_algorithm_agreement(noisy_image):
    y = noisy_image
    lam = 0.1
    L = Grad2DOperator(tuple(y.shape))
    cp = pa.ChambollePock(tol=1e-7, maxit=100_000)
    (x_cp, _), _ = cp(
        x0=jnp.zeros_like(y), y0=jnp.zeros((2,) + tuple(y.shape)),
        g=SqrDistance(y), h=NormL21(lam, axis=0), L=L,
    )
    # AFBA theta=1 route with the smooth data term as f
    afba = pa.AFBA(tol=1e-7, maxit=100_000)
    (x_af, _), _ = afba(
        x0=jnp.zeros_like(y), y0=jnp.zeros((2,) + tuple(y.shape)),
        f=SqrDistance(y), beta_f=1.0, h=NormL21(lam, axis=0), L=L,
    )
    np.testing.assert_allclose(np.asarray(x_cp), np.asarray(x_af), atol=5e-4)


def test_norml21_prox_math():
    rng = np.random.default_rng(1)
    Y = jnp.asarray(rng.standard_normal((2, 5, 6)))
    g = NormL21(0.3, axis=0)
    Z, val = g.prox(Y, 1.0)
    # group norms shrink by exactly min(gamma*lam, ||.||)
    ny = np.sqrt(np.sum(np.asarray(Y) ** 2, axis=0))
    nz = np.sqrt(np.sum(np.asarray(Z) ** 2, axis=0))
    np.testing.assert_allclose(nz, np.maximum(ny - 0.3, 0), atol=1e-12)
    np.testing.assert_allclose(float(val), 0.3 * np.sum(nz), rtol=1e-12)
