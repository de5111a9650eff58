"""Batched TV/Chambolle-Pock solver: parity with the generic AFBA driver.

Two layers of evidence:
1. the batched step's math equals the generic AFBA(theta=2, f=0, l=Ind0)
   update (same xbar/ybar to f32 roundoff);
2. the iteration-blocked solver reaches the same fixed point as the
   generic batched driver with upper-bound iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms.primal_dual import make_chambolle_pock_iteration
from proxtpu.kernels.tv import (
    default_tv_stepsizes,
    reference_cp_step,
    solve_tv_batch,
)
from proxtpu.ops.linops import Grad2DOperator
from proxtpu.parallel.batch import batched_run_loop
from proxtpu.prox import NormL21, SqrDistance

B, H, W = 4, 16, 24
LAM = 0.12
TOL = 1e-4


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(0)
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1.0
    return jnp.asarray(
        clean + 0.15 * rng.standard_normal((B, H, W)).astype(np.float32)
    )


def generic_iteration(noisy):
    return jax.vmap(
        lambda y: make_chambolle_pock_iteration(
            x0=jnp.zeros((H, W), jnp.float32),
            y0=jnp.zeros((2, H, W), jnp.float32),
            g=SqrDistance(y),
            h=NormL21(LAM, axis=0),
            L=Grad2DOperator((H, W)),
        )
    )(noisy)


def test_reference_step_matches_generic_update(noisy):
    """The fused-step algebra IS the AFBA theta=2 update: starting from the
    same (x, y), one reference_cp_step must equal one generic _update."""
    iteration = generic_iteration(noisy)
    state1 = jax.vmap(lambda it: it.init())(iteration)  # update from (0, 0)
    state2 = jax.vmap(lambda it, s: it.step(s))(iteration, state1)

    g1, g2 = default_tv_stepsizes()
    g1v = jnp.full((B,), g1, jnp.float32)
    g2v = jnp.full((B,), g2, jnp.float32)
    lamv = jnp.full((B,), LAM, jnp.float32)
    x = jnp.zeros((B, H, W), jnp.float32)
    y = jnp.zeros((B, H, W), jnp.float32)

    # step 1 (the driver's init)
    x1, yx1, yy1, res1 = reference_cp_step(noisy, x, y, y, g1v, g2v, lamv)
    np.testing.assert_allclose(
        np.asarray(state1.x), np.asarray(x1), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(state1.y[:, 0]), np.asarray(yx1), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(state1.y[:, 1]), np.asarray(yy1), atol=2e-6
    )
    # the driver's stopping quantity: ||FPR_x||inf + ||FPR_y||inf
    fpr = jnp.max(jnp.abs(state1.FPR_x), axis=(1, 2)) + jnp.max(
        jnp.abs(state1.FPR_y), axis=(1, 2, 3)
    )
    np.testing.assert_allclose(np.asarray(fpr), np.asarray(res1), atol=2e-6)

    # step 2
    x2, yx2, yy2, _ = reference_cp_step(noisy, x1, yx1, yy1, g1v, g2v, lamv)
    np.testing.assert_allclose(
        np.asarray(state2.x), np.asarray(x2), atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(state2.y[:, 0]), np.asarray(yx2), atol=5e-6
    )


def test_per_lane_lam_sweep(noisy):
    """A per-image lam sweep (the natural batched use) denoises each image
    with ITS OWN lam: lane i of the sweep equals a uniform solve at
    lam_i."""
    lams = jnp.asarray([0.05, 0.12, 0.2, 0.3], jnp.float32)
    xs, _, d = solve_tv_batch(noisy, lams, TOL, maxit=5000, iter_block=8)
    assert bool(jnp.all(d))
    for i in [0, 3]:
        xi, _, di = solve_tv_batch(
            noisy, float(lams[i]), TOL, maxit=5000, iter_block=8,
        )
        assert bool(jnp.all(di))
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(xi[i]), atol=1e-5
        )


@pytest.mark.parametrize("iter_block", [1, 4, 8])
def test_iter_block_is_sampling_only(noisy, iter_block):
    """The trip length only changes when convergence is sampled: the
    solution stays in the tol-ball and counts are upper bounds of the
    every-iteration check, at most one block later."""
    x1, it1, d1 = solve_tv_batch(noisy, LAM, TOL, maxit=5000, iter_block=1)
    xk, itk, dk = solve_tv_batch(noisy, LAM, TOL, maxit=5000,
                                 iter_block=iter_block)
    assert bool(jnp.all(d1)) and bool(jnp.all(dk))
    np.testing.assert_allclose(np.asarray(xk), np.asarray(x1), atol=1e-3)
    assert np.all(np.asarray(itk) >= np.asarray(it1))
    assert np.all(np.asarray(itk) <= np.asarray(it1) + iter_block)


def test_per_lane_stepsizes_route_off_kernel(noisy):
    """Non-uniform per-image STEPSIZES run each lane with its own gamma,
    matching per-lane uniform solves."""
    g1s = jnp.asarray([0.3, 0.35, 0.3, 0.25], jnp.float32)
    xs, _, d = solve_tv_batch(noisy, LAM, TOL, maxit=5000, gamma1=g1s)
    assert bool(jnp.all(d))
    xi, _, di = solve_tv_batch(
        noisy, LAM, TOL, maxit=5000, gamma1=float(g1s[1]),
    )
    assert bool(jnp.all(di))
    np.testing.assert_allclose(
        np.asarray(xs[1]), np.asarray(xi[1]), atol=1e-5
    )


def test_solver_matches_generic_driver(noisy):
    iteration = generic_iteration(noisy)
    sols, iters, done = batched_run_loop(iteration, 5000, TOL)
    xs_gen = sols[0]
    assert bool(jnp.all(done))

    x, it, d = solve_tv_batch(noisy, LAM, TOL, maxit=5000, iter_block=8)
    assert bool(jnp.all(d))
    np.testing.assert_allclose(np.asarray(x), np.asarray(xs_gen), atol=1e-3)
    # sampled stopping: counts are an upper bound, within one block
    assert np.all(np.asarray(it) >= np.asarray(iters) - 1)
    assert np.all(np.asarray(it) <= np.asarray(iters) + 8)


def test_mxu_step_matches_reference_step(noisy):
    """The bidiagonal-matmul stencil (mxu_cp_step) is the same operator as
    the roll+mask stencil: D's zero last row IS the Neumann mask, D^T the
    masked backward-difference adjoint."""
    from proxtpu.kernels.tv import default_tv_stepsizes, mxu_cp_step

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((B, H, W)).astype(np.float32))
    yx = jnp.asarray(0.1 * rng.standard_normal((B, H, W)).astype(np.float32))
    yy = jnp.asarray(0.1 * rng.standard_normal((B, H, W)).astype(np.float32))
    g1d, g2d = default_tv_stepsizes(jnp.float32)
    g1 = jnp.full((B,), g1d, jnp.float32)
    g2 = jnp.full((B,), g2d, jnp.float32)
    lam = jnp.full((B,), LAM, jnp.float32)

    ref = reference_cp_step(noisy, x, yx, yy, g1, g2, lam)
    mxu = mxu_cp_step(noisy, x, yx, yy, g1, g2, lam)
    for r, m, name in zip(ref, mxu, ("x", "yx", "yy", "res")):
        np.testing.assert_allclose(np.asarray(m), np.asarray(r), atol=1e-6,
                                   err_msg=name)


def test_mxu_formulation_solves_to_tolerance(noisy):
    """solve_tv_batch(formulation='mxu') converges to the same solution as
    the roll formulation through the full iteration-blocked harness."""
    roll = solve_tv_batch(noisy, LAM, TOL, maxit=4000)
    mxu = solve_tv_batch(noisy, LAM, TOL, maxit=4000, formulation="mxu")
    assert bool(jnp.all(roll[2])) and bool(jnp.all(mxu[2]))
    np.testing.assert_allclose(np.asarray(mxu[0]), np.asarray(roll[0]),
                               atol=1e-4)
    assert int(np.max(np.abs(np.asarray(mxu[1]) - np.asarray(roll[1])))) <= 8


def test_tv_warm_start():
    """x0/y0 warm start: re-entering from a previous solve's
    (x, (B,2,H,W) dual) converges immediately, on both stencil
    formulations."""
    import numpy as np
    import jax.numpy as jnp
    from proxtpu.kernels.tv import solve_tv_batch

    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal((3, 24, 24)).astype(np.float32))
    (x, y), it, d = solve_tv_batch(b, 0.15, 1e-4, maxit=4000,
                                   return_dual=True)
    assert bool(np.asarray(d).all())
    for kw in (dict(formulation="roll"), dict(formulation="mxu")):
        (x2, _), it2, d2 = solve_tv_batch(b, 0.15, 1e-4, maxit=4000,
                                          return_dual=True, x0=x, y0=y, **kw)
        assert bool(np.asarray(d2).all())
        assert float(np.mean(np.asarray(it2))) <= 0.2 * float(
            np.mean(np.asarray(it)))
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-4)
