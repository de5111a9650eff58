"""Kernel-path auto-dispatch: BatchedAlgorithm must route recognized shapes
to the fused kernel solvers and fall back to the generic driver otherwise,
with matching results either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.algorithms.forward_backward import make_forward_backward_iteration
from proxtpu.kernels.dispatch import match_kernel_solver
from proxtpu.parallel.batch import BatchedAlgorithm
from proxtpu.prox import IndBox, LeastSquaresLoss, NormL1, Quadratic

B, M, N = 4, 16, 24
TOL = 1e-5


@pytest.fixture(scope="module")
def lasso():
    rng = np.random.default_rng(0)
    A = jnp.asarray((rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1),
        jnp.float32,
    )
    Lf = jnp.asarray(
        [np.linalg.norm(np.asarray(A[i]), 2) ** 2 for i in range(B)], jnp.float32
    )
    return A, b, lam, Lf


def lasso_kwargs(A, b, lam, Lf):
    return dict(
        x0=jnp.zeros((B, N), jnp.float32),
        f=LeastSquaresLoss(A, b),
        g=NormL1(lam),
        Lf=Lf,
    )


def test_lasso_matches_and_agrees_with_generic(lasso):
    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is not None

    fast = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL
    )
    xs_f, it_f, d_f = fast(**kw)
    # generic path: vmap-stacked per-lane iteration through the vmapped driver
    from proxtpu.parallel.batch import batched_run_loop

    iteration = jax.vmap(
        lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, jnp.float32),
            f=LeastSquaresLoss(Ai, bi),
            g=NormL1(li),
            gamma=1.0 / Li,
        )
    )(A, b, lam, Lf)
    xs_s, it_s, d_s = batched_run_loop(iteration, 3000, TOL)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s), atol=1e-4)
    # counts agree up to the ±1 f32 boundary (on CPU the dispatch runs
    # the XLA step)
    assert int(np.max(np.abs(np.asarray(it_f) - np.asarray(it_s)))) <= 1


def test_lasso_interpret_kernel_path(lasso):
    """use_kernels='interpret' runs the fused lasso kernel in Pallas
    interpret mode on CPU."""
    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    fast = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL,
        use_kernels="interpret",
    )
    xs, it, done = fast(**kw)
    assert bool(jnp.all(done))
    # fixed-point check per lane
    for i in range(B):
        x = np.asarray(xs[i], np.float64)
        Ai = np.asarray(A[i], np.float64)
        gi = 1.0 / float(Lf[i])
        y = x - gi * (Ai.T @ (Ai @ x - np.asarray(b[i], np.float64)))
        z = np.sign(y) * np.maximum(np.abs(y) - gi * float(lam[i]), 0)
        assert np.max(np.abs(x - z)) / gi <= 2 * TOL


def test_restart_sequence_routes_to_kernel_restart(lasso):
    """AdaptiveRestartSequence wrapping the default t-recursion is the one
    recognized non-default sequence: it maps onto the kernels' in-kernel
    O'Donoghue-Candès restart, with per-lane counts matching the generic
    driver running the same wrapped sequence."""
    import proxtpu as pa
    from proxtpu.parallel.batch import batched_run_loop

    A, b, lam, Lf = lasso
    seq = pa.AdaptiveRestartSequence(pa.FixedNesterovSequence())
    kw = dict(lasso_kwargs(A, b, lam, Lf), extrapolation_sequence=seq)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is not None

    fast = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL
    )
    xs_f, it_f, d_f = fast(**kw)
    iteration = jax.vmap(
        lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, jnp.float32),
            f=LeastSquaresLoss(Ai, bi),
            g=NormL1(li),
            gamma=1.0 / Li,
            extrapolation_sequence=seq,
        )
    )(A, b, lam, Lf)
    xs_s, it_s, d_s = batched_run_loop(iteration, 3000, TOL)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it_f) - np.asarray(it_s)))) <= 1
    # and the restart actually engaged: fewer iterations than plain FISTA
    _, it_plain, _ = fast(**lasso_kwargs(A, b, lam, Lf))
    assert float(np.mean(np.asarray(it_f))) < float(
        np.mean(np.asarray(it_plain))
    )

    # any other wrapped sequence falls back to the generic driver
    kw_other = dict(
        lasso_kwargs(A, b, lam, Lf),
        extrapolation_sequence=pa.AdaptiveRestartSequence(
            pa.SimpleNesterovSequence()),
    )
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw_other, tol=TOL, maxit=3000
    ) is None


def test_nonzero_x0_warm_starts_kernel(lasso):
    """A concrete nonzero x0 rides the kernels as a warm start: the
    dispatch matches, and restarting from the cold solution converges in
    ~1 iteration with the same fixed point."""
    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    fast = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL
    )
    xs_cold, it_cold, d_cold = fast(**kw)
    kw["x0"] = xs_cold
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is not None
    xs_warm, it_warm, d_warm = fast(**kw)
    assert bool(jnp.all(d_cold)) and bool(jnp.all(d_warm))
    assert int(np.max(np.asarray(it_warm))) <= 3
    np.testing.assert_allclose(np.asarray(xs_warm), np.asarray(xs_cold),
                               atol=1e-4)

    # wrong-shaped x0 still falls back
    kw["x0"] = jnp.zeros((B, N + 1), jnp.float32)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is None


def test_adaptive_falls_back(lasso):
    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    kw.pop("Lf")
    kw["adaptive"] = True
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is None


def test_custom_stop_falls_back(lasso):
    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000,
        stop=lambda it, tol, s: True,
    ) is None


def test_batched_algorithm_injects_bounded_search(lasso):
    """BatchedAlgorithm defaults backtrack_limit for factories that accept
    it (the batched context needs the bounded lowering to compile fast);
    explicit None wins."""
    from proxtpu.algorithms.panoc import make_panoc_iteration
    from proxtpu.prox import SqrDistance

    A, b, lam, Lf = lasso
    solver = BatchedAlgorithm(make_panoc_iteration, maxit=2000, tol=TOL)
    xs, it, done = solver(
        x0=jnp.zeros((B, N), jnp.float32),
        f=jax.vmap(SqrDistance)(b),
        A=A, g=NormL1(lam), Lf=Lf,
    )
    assert bool(jnp.all(done))
    # f32 line search is decision-chaotic across differently-compiled
    # programs (tau/L-BFGS thresholds flip on ULPs), so pin the *fixed
    # point* per lane rather than cross-program trajectory equality
    for i in range(B):
        x = np.asarray(xs[i], np.float64)
        Ai = np.asarray(A[i], np.float64)
        gi = 1.0 / float(Lf[i])
        y = x - gi * (Ai.T @ (Ai @ x - np.asarray(b[i], np.float64)))
        z = np.sign(y) * np.maximum(np.abs(y) - gi * float(lam[i]), 0)
        assert np.max(np.abs(x - z)) / gi <= 2 * TOL


def test_adaptive_routes_to_flat_machine():
    """BatchedAlgorithm with adaptive FB/FISTA dispatches to the flattened
    trial/commit machine — exact per-lane parity with the single driver
    (f64, explicit gamma0 to pin the knife-edge trials)."""
    import proxtpu as pa
    from proxtpu.algorithms import (
        make_fast_forward_backward_iteration,
        make_forward_backward_iteration,
    )
    from proxtpu.kernels.dispatch import match_flat_adaptive
    from proxtpu.prox import LeastSquaresLoss

    Bn, M_, N_ = 5, 10, 16
    rng = np.random.default_rng(9)
    A = jnp.asarray(rng.standard_normal((Bn, M_, N_)))
    b = jnp.asarray(rng.standard_normal((Bn, M_)))
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", np.asarray(A),
                                      np.asarray(b))), axis=1))
    f = jax.vmap(LeastSquaresLoss)(A, b)
    g = jax.vmap(NormL1)(lam)
    kw = dict(x0=jnp.zeros((Bn, N_)), f=f, g=g, adaptive=True, gamma=0.05)

    for factory, solver_name in [
        (make_forward_backward_iteration, "ForwardBackward"),
        (make_fast_forward_backward_iteration, "FastForwardBackward"),
    ]:
        assert match_flat_adaptive(factory, kw, tol=1e-6, maxit=5000) \
            is not None
        solver = BatchedAlgorithm(factory, maxit=5000, tol=1e-6)
        xs, it, done = solver(**kw)
        assert bool(jnp.all(done))
        single = getattr(pa, solver_name)(tol=1e-6, maxit=5000,
                                          adaptive=True)
        for i in range(Bn):
            x, k = single(x0=jnp.zeros(N_), f=LeastSquaresLoss(A[i], b[i]),
                          g=NormL1(lam[i]), gamma=0.05)
            assert k == int(it[i])
            np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(x),
                                       rtol=0, atol=1e-12)

    # fixed-stepsize solves do NOT route to the flat machine
    kw_fixed = dict(kw, adaptive=False)
    assert match_flat_adaptive(
        make_forward_backward_iteration, kw_fixed, tol=1e-6, maxit=5000
    ) is None


def test_box_qp_dispatch_matches_generic():
    rng = np.random.default_rng(2)
    n, Bq = 16, 4
    Qs, qs, Lips = [], [], []
    for _ in range(Bq):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = 2 * rng.random(n) - 1
        Q0 = (U @ np.diag(ev) @ U.T).astype(np.float32)
        Qs.append(0.5 * (Q0 + Q0.T))
        qs.append(rng.standard_normal(n).astype(np.float32))
        Lips.append(np.max(np.abs(ev)))
    Q = jnp.asarray(np.stack(Qs))
    q = jnp.asarray(np.stack(qs))
    gamma = jnp.asarray(0.95 / np.array(Lips, np.float32))

    kw = dict(
        x0=jnp.zeros((Bq, n), jnp.float32),
        f=Quadratic(Q, q),
        g=IndBox(-1.0, 1.0),
        gamma=gamma,
    )
    assert match_kernel_solver(
        make_forward_backward_iteration, kw, tol=1e-4, maxit=10_000
    ) is not None

    fast = BatchedAlgorithm(make_forward_backward_iteration, maxit=10_000,
                            tol=1e-4)
    xs_f, it_f, d_f = fast(**kw)
    from proxtpu.parallel.batch import batched_run_loop

    iteration = jax.vmap(
        lambda Qi, qi, gi: make_forward_backward_iteration(
            x0=jnp.zeros(n, jnp.float32),
            f=Quadratic(Qi, qi),
            g=IndBox(-1.0, 1.0),
            gamma=gi,
        )
    )(Q, q, gamma)
    xs_s, it_s, d_s = batched_run_loop(iteration, 10_000, 1e-4)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s), atol=2e-3)
    assert int(np.max(np.abs(np.asarray(it_f) - np.asarray(it_s)))) <= 1


def test_restart_sequence_shared_a_routes_multirhs_k1():
    """Shared-A + AdaptiveRestartSequence routes to solve_lasso_multirhs
    pinned at iter_block=1 (per-step restart = the generic driver's exact
    trajectory); per-lane counts match the generic driver +-1."""
    import proxtpu as pa
    from proxtpu.parallel.batch import batched_run_loop

    rng = np.random.default_rng(11)
    A0 = jnp.asarray((rng.standard_normal((M, N)) / np.sqrt(M))
                     .astype(np.float32))
    bb = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
    Lf0 = float(np.linalg.norm(np.asarray(A0), 2) ** 2)
    lam0 = jnp.asarray(0.1 * np.max(np.abs(np.asarray(bb) @ np.asarray(A0)),
                                    axis=1), jnp.float32)
    seq = pa.AdaptiveRestartSequence(pa.FixedNesterovSequence())
    kw = dict(x0=jnp.zeros((B, N), jnp.float32),
              f=LeastSquaresLoss(A0, bb), g=NormL1(lam0), Lf=Lf0,
              extrapolation_sequence=seq)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=4000
    ) is not None
    fast = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=4000, tol=TOL)
    xs_f, it_f, d_f = fast(**kw)
    iteration = jax.vmap(
        lambda bi, li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, jnp.float32), f=LeastSquaresLoss(A0, bi),
            g=NormL1(li), gamma=1.0 / Lf0, extrapolation_sequence=seq,
        )
    )(bb, lam0)
    xs_s, it_s, d_s = batched_run_loop(iteration, 4000, TOL)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it_f) - np.asarray(it_s)))) <= 1


def test_strongly_convex_mf_routes_to_kernel():
    """mf > 0 (static scalar) rides the kernel as a constant extrapolation
    coefficient: dispatch matches, per-lane counts track the generic
    driver, and the mf route converges in fewer iterations than plain
    FISTA (the whole point of the modulus)."""
    from proxtpu.parallel.batch import batched_run_loop

    rng = np.random.default_rng(13)
    Bn, M_, N_ = 4, 40, 20  # tall A -> genuinely strongly convex
    A = jnp.asarray((rng.standard_normal((Bn, M_, N_)) / np.sqrt(M_))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((Bn, M_)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(Bn)], jnp.float32)
    mf = min(float(np.linalg.svd(np.asarray(A[i]),
                                 compute_uv=False)[-1] ** 2)
             for i in range(Bn))
    kw = dict(x0=jnp.zeros((Bn, N_), jnp.float32),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf, mf=mf)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=4000
    ) is not None
    fast = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=4000, tol=TOL)
    xs_f, it_f, d_f = fast(**kw)
    iteration = jax.vmap(
        lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N_, jnp.float32), f=LeastSquaresLoss(Ai, bi),
            g=NormL1(li), gamma=1.0 / Li, mf=mf,
        )
    )(A, b, lam, Lf)
    xs_s, it_s, d_s = batched_run_loop(iteration, 4000, TOL)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it_f) - np.asarray(it_s)))) <= 1
    _, it_plain, _ = fast(**{k: v for k, v in kw.items() if k != "mf"})
    assert float(np.mean(np.asarray(it_f))) < float(
        np.mean(np.asarray(it_plain)))

    # per-lane (array) mf falls back to the generic driver
    kw_vec = dict(kw, mf=jnp.full((Bn,), mf, jnp.float32))
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw_vec, tol=TOL, maxit=4000
    ) is None


def test_elastic_net_routes_to_kernel(lasso):
    """ElasticNet g rides the lasso kernel route (round 5): lam=mu maps
    to the soft threshold, lam2 to the divide-epilogue; solutions agree
    with the generic driver and the matcher recognizes the shape."""
    from proxtpu.kernels.dispatch import match_kernel_solver
    from proxtpu.prox import ElasticNet

    A, b, lam, Lf = lasso
    rng = np.random.default_rng(9)
    lam2 = jnp.asarray(0.05 + 0.1 * rng.random(B), jnp.float32)
    kw = dict(x0=jnp.zeros((B, N), jnp.float32),
              f=LeastSquaresLoss(A, b),
              g=ElasticNet(mu=lam, lam=lam2), Lf=Lf)
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=3000
    ) is not None

    fast = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=3000, tol=TOL)
    xs_f, it_f, d_f = fast(**kw)
    slow = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=3000, tol=TOL, use_kernels=False)
    xs_s, it_s, d_s = slow(**kw)
    assert bool(jnp.all(d_f)) and bool(jnp.all(d_s))
    np.testing.assert_allclose(np.asarray(xs_f), np.asarray(xs_s),
                               atol=1e-4)
    # shared-A shorthand routes to multirhs with lam2
    kw2 = dict(kw, f=LeastSquaresLoss(A[0], b), Lf=float(Lf[0]))
    assert match_kernel_solver(
        make_fast_forward_backward_iteration, kw2, tol=TOL, maxit=3000
    ) is not None
    xs_m, it_m, d_m = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL)(**kw2)
    xs_g, it_g, d_g = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=TOL,
        use_kernels=False)(**kw2)
    assert bool(jnp.all(d_m)) and bool(jnp.all(d_g))
    np.testing.assert_allclose(np.asarray(xs_m), np.asarray(xs_g),
                               atol=1e-4)


def test_unknown_kwarg_skips_fast_path_and_raises(lasso):
    """r5 review: a kwarg the factory does not accept must NOT be
    silently dropped by a structural matcher — the generic path raises
    the factory's own TypeError (e.g. A= with DRLS used to silently
    solve the A-less problem)."""
    from proxtpu.algorithms.drls import make_drls_iteration
    from proxtpu.ops.linops import IdentityOperator
    from proxtpu.prox import SqrNormL2

    A, b, lam, Lf = lasso
    solver = BatchedAlgorithm(make_drls_iteration, maxit=50, tol=TOL)
    with pytest.raises(TypeError):
        solver(
            x0=jnp.zeros((B, N), jnp.float32),
            f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf,
            A=IdentityOperator(),
        )
    # mf on the momentum-less plain FB factory likewise raises
    solver2 = BatchedAlgorithm(make_forward_backward_iteration,
                               maxit=50, tol=TOL)
    with pytest.raises(TypeError):
        solver2(**lasso_kwargs(A, b, lam, Lf), mf=0.1)


def test_array_mf_matcher_returns_none(lasso):
    """r5 review: an array-valued mf must make match_flat_adaptive
    return None (generic fallback), not crash on array truthiness.
    (The factory itself also rejects array mf, so the end-to-end error
    belongs to the factory — the matcher must not preempt it with an
    opaque truthiness ValueError.)"""
    from proxtpu.kernels.dispatch import match_flat_adaptive

    A, b, lam, Lf = lasso
    kw = lasso_kwargs(A, b, lam, Lf)
    kw.pop("Lf")
    kw["adaptive"] = True
    kw["mf"] = jnp.full((B,), 0.1, jnp.float32)
    run = match_flat_adaptive(
        make_fast_forward_backward_iteration, kw, tol=TOL, maxit=100,
    )
    assert run is None


def test_f64_problems_skip_real_kernels():
    """The compiled kernel is float32-only — an f64 problem must route to
    the pure-XLA step (on CPU the guard is exercised by dtype alone; the
    route rule itself is pinned in tests/test_kernels.py)."""
    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((B, M, N)) / np.sqrt(M),
                    jnp.float64)
    b = jnp.asarray(rng.standard_normal((B, M)), jnp.float64)
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.einsum(
            "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1),
        jnp.float64)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(B)], jnp.float64)
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=4000, tol=1e-9,
    )
    xs, it, done = solver(x0=jnp.zeros((B, N), jnp.float64),
                          f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)
    assert bool(jnp.all(done))
    assert xs.dtype == jnp.float64
