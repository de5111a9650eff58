"""Soft-margin linear SVM on the primal-dual stack.

min_x (1/m) sum_i max(0, 1 - y_i <a_i, x>) + lam/2 ||x||^2

The hinge term is nonsmooth AND composed with the data matrix, so this is
native primal-dual territory (the reference's AFBA/Chambolle-Pock family,
``src/algorithms/primal_dual.jl``; the SVM problem family itself is a batched-build
build addition — the reference never exercises a hinge loss).  Correctness
is pinned three ways: two structurally different solver routes must agree
(Chambolle-Pock: everything nonsmooth; Vu-Condat: the ridge term used as
the SMOOTH f with beta_f = lam), the solution must satisfy the hinge
subgradient KKT condition, and no random perturbation may beat it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms import ChambollePock, VuCondat
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.algorithms.primal_dual import make_afba_iteration
from proxtpu.prox import HingeLoss, SqrNormL2, Zero

M, N = 40, 12
LAM = 0.1


def svm_data(dtype=np.float64, m=M, n=N, seed=12):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    y = np.sign(A @ w_true + 0.1 * rng.standard_normal(m))
    return (
        jnp.asarray(A, dtype), jnp.asarray(y, dtype),
        jnp.asarray(w_true, dtype),
    )


def svm_objective(A, y, lam, x):
    margins = np.asarray(y) * (np.asarray(A) @ np.asarray(x))
    return float(
        np.mean(np.maximum(0.0, 1.0 - margins))
        + lam / 2 * np.sum(np.asarray(x) ** 2)
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_svm_two_routes_agree(dtype):
    A, y, _ = svm_data(dtype)
    h = HingeLoss(y, 1.0 / M)
    tol = 1e-6 if dtype == np.float64 else 1e-4

    x_cp, it_cp = ChambollePock(maxit=50_000, tol=tol)(
        x0=jnp.zeros(N, dtype), y0=jnp.zeros(M, dtype),
        g=SqrNormL2(LAM), h=h, L=A,
    )
    x_vc, it_vc = VuCondat(maxit=50_000, tol=tol)(
        x0=jnp.zeros(N, dtype), y0=jnp.zeros(M, dtype),
        f=SqrNormL2(LAM), beta_f=LAM, g=Zero(), h=h, L=A,
    )
    xp_cp, xp_vc = np.asarray(x_cp[0]), np.asarray(x_vc[0])
    assert np.all(np.isfinite(xp_cp)) and np.all(np.isfinite(xp_vc))
    atol = 200 * tol
    np.testing.assert_allclose(xp_cp, xp_vc, atol=atol)

    F_cp = svm_objective(A, y, LAM, xp_cp)
    F_vc = svm_objective(A, y, LAM, xp_vc)
    np.testing.assert_allclose(F_cp, F_vc, rtol=1e-4, atol=10 * tol)

    # no random perturbation beats the solution (objective optimality)
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1e-2):
        for _ in range(20):
            u = xp_cp + scale * rng.standard_normal(N)
            assert svm_objective(A, y, LAM, u) >= F_cp - 5 * atol


def test_svm_kkt_subgradient():
    """lam*x* must lie in -A' @ partial(hinge)(Ax*)/m : coefficients are
    -y_i/m on violated margins, 0 on satisfied, in [-y_i/m, 0] at the
    boundary."""
    A, y, _ = svm_data(np.float64)
    h = HingeLoss(y, 1.0 / M)
    x, _ = ChambollePock(maxit=200_000, tol=1e-9)(
        x0=jnp.zeros(N, np.float64), y0=jnp.zeros(M, np.float64),
        g=SqrNormL2(LAM), h=h, L=A,
    )
    xs = np.asarray(x[0])
    Aa, ya = np.asarray(A), np.asarray(y)
    margins = ya * (Aa @ xs)
    # coefficient bounds per example (subgradient of mean hinge wrt Ax)
    bnd = 1e-6
    lo = np.where(margins < 1 + bnd, -ya / M, 0.0)
    hi = np.where(margins < 1 - bnd, -ya / M, 0.0)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    # need alpha in [lo, hi]^m with lam*x + A' alpha = 0 -> least-squares
    # for the boundary coefficients; verify with the dual iterate instead:
    # solve min ||lam x + A' a||, a in box, via projected gradient
    a = np.clip(-ya / M * (margins < 1), lo, hi)
    for _ in range(5000):
        grad = Aa @ (LAM * xs + Aa.T @ a)
        a = np.clip(a - 0.5 * grad, lo, hi)
    kkt = np.linalg.norm(LAM * xs + Aa.T @ a, np.inf)
    assert kkt <= 5e-6, kkt


def test_svm_lambda_path_batched():
    """A lam-path of SVMs in ONE batched solve: Shared data matrix, per-lane
    regularization — the generic driver composes with the primal-dual
    factory out of the box."""
    A, y, _ = svm_data(np.float32)
    B = 8
    lams = jnp.asarray(np.geomspace(0.01, 1.0, B).astype(np.float32))
    solver = BatchedAlgorithm(
        make_afba_iteration, maxit=30_000, tol=1e-4, use_kernels=False
    )
    # ChambollePock configuration = AFBA(theta=2, f=0, l=Ind0)
    gam1 = jnp.full((B,), 0.9 / float(jnp.linalg.norm(A, 2)), jnp.float32)
    xs, iters, done = solver(
        x0=jnp.zeros((B, N), jnp.float32), y0=jnp.zeros((B, M), jnp.float32),
        g=SqrNormL2(lams), h=Shared(HingeLoss(y, 1.0 / M)), L=Shared(A),
        theta=2.0, gamma1=gam1, gamma2=gam1,
    )
    assert bool(jnp.all(done))
    # per-lane parity vs single solves
    for i in (0, B // 2, B - 1):
        x_s, _ = ChambollePock(maxit=30_000, tol=1e-4)(
            x0=jnp.zeros(N, jnp.float32), y0=jnp.zeros(M, jnp.float32),
            g=SqrNormL2(float(lams[i])), h=HingeLoss(y, 1.0 / M), L=A,
            gamma1=float(gam1[i]), gamma2=float(gam1[i]),
        )
        np.testing.assert_allclose(
            np.asarray(x_s[0]), np.asarray(xs[0][i]), atol=5e-3
        )
    # heavier regularization shrinks the solution monotonically (sanity)
    norms = np.linalg.norm(np.asarray(xs[0]), axis=1)
    assert norms[0] > norms[-1]
