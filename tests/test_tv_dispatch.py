"""TV/Chambolle-Pock auto-dispatch: BatchedAlgorithm must route the batched
TV-denoising shape (CP + SqrDistance + NormL21 + Grad2DOperator, zero init)
to the fused solver (:func:`proxtpu.kernels.tv.solve_tv_batch`) and fall
back to the generic vmapped driver otherwise, with matching results either
way (same pattern as ``tests/test_dispatch.py`` for the lasso/box-QP
kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms.primal_dual import (
    make_afba_iteration,
    make_chambolle_pock_iteration,
)
from proxtpu.kernels.dispatch import match_tv_solver
from proxtpu.ops.linops import Grad2DOperator
from proxtpu.parallel.batch import BatchedAlgorithm, batched_run_loop
from proxtpu.prox import NormL21, SqrDistance

B, H, W = 4, 16, 24
LAM = 0.12
TOL = 1e-4
MAXIT = 4000


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(0)
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1.0
    return jnp.asarray(
        clean + 0.15 * rng.standard_normal((B, H, W)).astype(np.float32)
    )


def tv_kwargs(noisy, lam=LAM):
    return dict(
        x0=jnp.zeros((B, H, W), jnp.float32),
        y0=jnp.zeros((B, 2, H, W), jnp.float32),
        g=SqrDistance(noisy),
        h=NormL21(lam, axis=0),
        L=Grad2DOperator((H, W)),
    )


def generic_solve(noisy, lam=LAM):
    lam_v = jnp.broadcast_to(jnp.asarray(lam, jnp.float32), (B,))
    iteration = jax.vmap(
        lambda y, li: make_chambolle_pock_iteration(
            x0=jnp.zeros((H, W), jnp.float32),
            y0=jnp.zeros((2, H, W), jnp.float32),
            g=SqrDistance(y),
            h=NormL21(li, axis=0),
            L=Grad2DOperator((H, W)),
        )
    )(noisy, lam_v)
    return batched_run_loop(iteration, MAXIT, TOL)


def test_tv_matches_and_agrees_with_generic(noisy):
    kw = tv_kwargs(noisy)
    assert match_tv_solver(
        make_chambolle_pock_iteration, kw, tol=TOL, maxit=MAXIT
    ) is not None

    fast = BatchedAlgorithm(make_chambolle_pock_iteration, maxit=MAXIT,
                            tol=TOL)
    (x_f, y_f), it_f, d_f = fast(**kw)
    (x_s, y_s), it_s, d_s = generic_solve(noisy)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    assert x_f.shape == (B, H, W) and y_f.shape == (B, 2, H, W)
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_s), atol=1e-3)
    np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_s), atol=1e-3)
    # blocked counts are an upper bound sampled at iter_block boundaries
    it_f, it_s = np.asarray(it_f), np.asarray(it_s)
    assert np.all(it_f + 1 >= it_s) and np.all(it_f - it_s < 8)


def test_tv_afba_theta2_matches(noisy):
    """Plain AFBA with theta=2 and CP-default f/l routes too."""
    kw = dict(tv_kwargs(noisy), theta=2.0)
    assert match_tv_solver(
        make_afba_iteration, kw, tol=TOL, maxit=MAXIT
    ) is not None
    # theta=1 is a different algorithm: no match
    kw1 = dict(tv_kwargs(noisy), theta=1.0)
    assert match_tv_solver(
        make_afba_iteration, kw1, tol=TOL, maxit=MAXIT
    ) is None


def test_tv_interpret_kernel_path(noisy):
    """use_kernels='interpret' (which only changes the lasso step) keeps the
    TV route and its answers."""
    kw = tv_kwargs(noisy)
    fast = BatchedAlgorithm(make_chambolle_pock_iteration, maxit=MAXIT,
                            tol=TOL, use_kernels="interpret")
    (x_f, y_f), it_f, d_f = fast(**kw)
    assert bool(jnp.all(d_f))
    (x_s, _), _, _ = generic_solve(noisy)
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_s), atol=1e-3)


def test_tv_per_image_lam_matches(noisy):
    """Per-image regularization weights still dispatch and agree per
    lane."""
    lam = jnp.asarray([0.05, 0.1, 0.15, 0.2], jnp.float32)
    kw = tv_kwargs(noisy, lam=lam)
    assert match_tv_solver(
        make_chambolle_pock_iteration, kw, tol=TOL, maxit=MAXIT
    ) is not None
    fast = BatchedAlgorithm(make_chambolle_pock_iteration, maxit=MAXIT,
                            tol=TOL)
    (x_f, _), it_f, d_f = fast(**kw)
    assert bool(jnp.all(d_f))
    (x_s, _), _, d_s = generic_solve(noisy, lam=lam)
    assert bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_s), atol=1e-3)


def test_tv_fallbacks(noisy):
    kw = tv_kwargs(noisy)
    f = make_chambolle_pock_iteration
    # nonzero x0
    assert match_tv_solver(
        f, dict(kw, x0=jnp.ones((B, H, W), jnp.float32)),
        tol=TOL, maxit=MAXIT,
    ) is None
    # anisotropic-norm axis
    assert match_tv_solver(
        f, dict(kw, h=NormL21(LAM, axis=1)), tol=TOL, maxit=MAXIT
    ) is None
    # operator/image shape mismatch
    assert match_tv_solver(
        f, dict(kw, L=Grad2DOperator((H, W + 1))), tol=TOL, maxit=MAXIT
    ) is None
    # relaxation != 1 (manual-stepsize regime)
    assert match_tv_solver(
        f, dict(kw, lam=0.5, gamma1=0.3, gamma2=0.3), tol=TOL, maxit=MAXIT
    ) is None
    # custom stopping criterion
    assert match_tv_solver(
        f, kw, tol=TOL, maxit=MAXIT, stop=lambda it, tol, s: True
    ) is None
