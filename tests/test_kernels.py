"""Batched lasso solvers and the fused FISTA step kernel.

On the CPU the kernel runs in Pallas interpret mode: the fused step must
match the pure-XLA reference math elementwise, and the kernel-driven solver
must reproduce the XLA solver's and the generic batched driver's per-lane
iteration counts (up to the f32 last-bit boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.kernels.lasso import (
    fused_fb_prox_grad,
    fused_fista_step,
    lasso_step_route,
    reference_fb_prox_grad,
    solve_lasso_batch,
    xla_fista_step,
)

B, M, N = 5, 16, 24


@pytest.fixture(scope="module")
def data():
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


def test_fused_step_matches_reference(data):
    A, b, lam, Lf = data
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((B, N)).astype(np.float32))
    gamma = (1.0 / Lf).astype(jnp.float32)
    thr = gamma * lam
    z_k, r_k = fused_fb_prox_grad(A, b, x, gamma, thr, interpret=True)
    z_r, r_r = reference_fb_prox_grad(A, b, x, gamma, thr)
    np.testing.assert_allclose(np.asarray(z_k), np.asarray(z_r), atol=5e-6)
    np.testing.assert_allclose(np.asarray(r_k), np.asarray(r_r), atol=5e-6)


def test_kernel_solver_matches_xla_solver(data):
    A, b, lam, Lf = data
    z1, it1, d1 = solve_lasso_batch(
        A, b, lam, Lf, 1e-5, maxit=3000, use_kernel=True, interpret=True
    )
    z2, it2, d2 = solve_lasso_batch(
        A, b, lam, Lf, 1e-5, maxit=3000, use_kernel=False
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d2))
    # kernel and XLA reference round differently in the last f32 bit, which
    # can move a lane across the stopping threshold by one iteration
    assert int(np.max(np.abs(np.asarray(it1) - np.asarray(it2)))) <= 1
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z2), atol=1e-4)


def test_kernel_solver_matches_generic_driver(data):
    """The specialized kernel solver must agree with the generic
    batched_run_loop + FISTA path on solutions (same math, same stopping)."""
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.parallel.batch import batched_run_loop
    from proxtpu.prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = data
    iteration = jax.vmap(
        lambda Ai, bi, li, Li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, jnp.float32),
            f=LeastSquaresLoss(Ai, bi),
            g=NormL1(li),
            gamma=1.0 / Li,
        )
    )(A, b, lam, Lf)
    xs, iters, done = batched_run_loop(iteration, 3000, 1e-5)

    z, it, d = solve_lasso_batch(
        A, b, lam, Lf, 1e-5, maxit=3000, use_kernel=True, interpret=True
    )
    assert bool(jnp.all(d))
    # same fixed point to f32 solver tolerance, and same per-lane iteration
    # counts up to the f32 last-bit boundary effect
    np.testing.assert_allclose(np.asarray(z), np.asarray(xs), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it) - np.asarray(iters)))) <= 1


def test_multirhs_matches_per_lane_batch(data):
    """The shared-A matmul formulation must reproduce the distinct-A batch
    solver exactly when every lane carries the same A: same counts (+-1
    f32 boundary), same fixed points."""
    from proxtpu.kernels.lasso import solve_lasso_batch, solve_lasso_multirhs

    A, b, lam, Lf = data
    A0 = A[0]
    Lf0 = Lf[0]
    A_rep = jnp.broadcast_to(A0, A.shape)
    Lf_rep = jnp.broadcast_to(Lf0, Lf.shape)

    z1, i1, d1 = solve_lasso_multirhs(A0, b, lam, Lf0, 1e-5, maxit=3000)
    z2, i2, d2 = solve_lasso_batch(
        A_rep, b, lam, Lf_rep, 1e-5, maxit=3000, use_kernel=False
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d2))
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z2), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(i1) - np.asarray(i2)))) <= 1

    # iteration blocking: same fixed point, upper-bound counts
    z3, i3, d3 = solve_lasso_multirhs(
        A0, b, lam, Lf0, 1e-5, maxit=3000, iter_block=8
    )
    assert bool(jnp.all(d3))
    np.testing.assert_allclose(np.asarray(z3), np.asarray(z1), atol=5e-4)
    # FISTA's residual is non-monotone: a lane that dips under tol between
    # sample points keeps iterating until a *sampled* residual is under tol,
    # so counts are an upper bound (not necessarily within K)
    assert np.all(np.asarray(i3) >= np.asarray(i1) - 1)


def test_multirhs_dispatch():
    """BatchedAlgorithm routes shared-A LeastSquaresLoss + NormL1 to the
    multirhs solver."""
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.kernels.dispatch import match_kernel_solver
    from proxtpu.prox import LeastSquaresLoss, NormL1

    rng = np.random.default_rng(5)
    A0 = jnp.asarray((rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32))
    bb = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
    Lf0 = float(np.linalg.norm(np.asarray(A0), 2) ** 2)
    kw = dict(
        x0=jnp.zeros((B, N), jnp.float32),
        f=LeastSquaresLoss(A0, bb),
        g=NormL1(0.1),
        Lf=Lf0,
    )
    run = match_kernel_solver(
        make_fast_forward_backward_iteration, kw, tol=1e-5, maxit=3000
    )
    assert run is not None
    z, it, done = run()
    assert bool(jnp.all(done))
    # fixed-point check on lane 0
    x = np.asarray(z[0], np.float64)
    An = np.asarray(A0, np.float64)
    g0 = 1.0 / Lf0
    y = x - g0 * (An.T @ (An @ x - np.asarray(bb[0], np.float64)))
    zz = np.sign(y) * np.maximum(np.abs(y) - g0 * 0.1, 0)
    assert np.max(np.abs(x - zz)) / g0 <= 2e-5


# ---------------------------------------------------------------------------
# Mixed-precision two-stage solver (bf16-A warm start + f32 polish)
# ---------------------------------------------------------------------------


def _fb_residual(A, b, lam, Lf, z):
    gamma = 1.0 / Lf
    _, res = reference_fb_prox_grad(A, b, z, gamma, gamma * lam)
    return res / gamma


@pytest.mark.parametrize("use_kernel,interpret",
                         [(False, False), (True, True)],
                         ids=["xla", "kernel-interp"])
def test_mixed_solver_reaches_f32_tolerance(data, use_kernel, interpret):
    """The bf16 warm start must not degrade final quality: the mixed
    solution satisfies the SAME f32 stopping criterion as the plain
    solver and matches a tight-tolerance ground truth at least as well."""
    from proxtpu.kernels.lasso import solve_lasso_batch_mixed

    A, b, lam, Lf = data
    tol = 1e-5
    z_m, it_m, d_m = solve_lasso_batch_mixed(
        A, b, lam, Lf, tol, maxit=3000, use_kernel=use_kernel,
        interpret=interpret,
    )
    assert bool(jnp.all(d_m))
    # recomputed f32 fixed-point residual clears tol (ulp slack)
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z_m))) <= 1.1 * tol
    z_gt, _, d_gt = solve_lasso_batch(A, b, lam, Lf, 1e-7, maxit=30000,
                                      use_kernel=False)
    z_ref, _, _ = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                    use_kernel=False)
    assert bool(jnp.all(d_gt))
    err_m = float(jnp.max(jnp.abs(z_m - z_gt)))
    err_ref = float(jnp.max(jnp.abs(z_ref - z_gt)))
    assert err_m <= 3 * max(err_ref, 1e-6), (err_m, err_ref)


def test_mixed_solver_stage2_fewer_f32_iterations(data):
    """The point of the warm start: the f32 stage runs a fraction of the
    plain solver's iterations (total counts include the cheap bf16 steps)."""
    from proxtpu.kernels.lasso import solve_lasso_batch_mixed

    A, b, lam, Lf = data
    tol = 1e-5
    _, it_plain, _ = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                       use_kernel=False)
    _, it_mixed, d = solve_lasso_batch_mixed(A, b, lam, Lf, tol, maxit=3000,
                                             use_kernel=False)
    assert bool(jnp.all(d))
    # total (bf16 + f32) count stays below the plain count: the warm lanes
    # re-enter stage 2 close to the solution
    assert float(jnp.mean(np.asarray(it_mixed))) < float(
        jnp.mean(np.asarray(it_plain))
    )


# ---------------------------------------------------------------------------
# Per-lane adaptive restart (O'Donoghue & Candes gradient scheme)
# ---------------------------------------------------------------------------


def test_restart_converges_faster_same_quality(data):
    """restart=True must reach the SAME stopping criterion in strictly
    fewer iterations (the gradient scheme kills FISTA's momentum
    oscillation once the active set settles)."""
    A, b, lam, Lf = data
    tol = 1e-5
    z_p, it_p, d_p = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                       use_kernel=False)
    z_r, it_r, d_r = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                       use_kernel=False, restart=True)
    assert bool(jnp.all(d_p)) and bool(jnp.all(d_r))
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z_r))) <= 1.1 * tol
    assert float(jnp.mean(np.asarray(it_r))) < float(
        jnp.mean(np.asarray(it_p))
    )


def test_restart_kernel_matches_xla_counts(data):
    """The in-kernel restart signal (a per-lane register reduction) reproduces
    the XLA path's decisions; knife-edge trials (rs summed in a different
    f32 order) may flip single iterations."""
    A, b, lam, Lf = data
    tol = 1e-5
    _, it_x, d_x = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                     use_kernel=False, restart=True)
    z_k, it_k, d_k = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                       use_kernel=True, interpret=True,
                                       restart=True)
    assert bool(jnp.all(d_x)) and bool(jnp.all(d_k))
    assert int(np.max(np.abs(np.asarray(it_x) - np.asarray(it_k)))) <= 1
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z_k))) <= 1.1 * tol


def test_restart_blocked_and_multirhs(data):
    """The shared-A solver restarts per lane, with every step checked
    (iter_block=1) and with the check once per block (iter_block=4):
    both satisfy the residual criterion and restart cuts iterations."""
    from proxtpu.kernels.lasso import solve_lasso_multirhs

    A, b, lam, Lf = data
    tol = 1e-5
    A1 = A[0]
    Lf1 = float(np.linalg.norm(np.asarray(A1), 2) ** 2)
    A_rep = jnp.broadcast_to(A1, A.shape)
    Lf_rep = jnp.full(Lf.shape, Lf1, jnp.float32)
    for K in (1, 4):
        z_m, it_m, d_m = solve_lasso_multirhs(A1, b, lam, Lf1, tol,
                                              maxit=3000, iter_block=K,
                                              restart=True)
        _, it_p, d_p = solve_lasso_multirhs(A1, b, lam, Lf1, tol,
                                            maxit=3000, iter_block=K)
        assert bool(jnp.all(d_m)) and bool(jnp.all(d_p))
        assert float(jnp.max(_fb_residual(A_rep, b, lam, Lf_rep, z_m))) \
            <= 1.1 * tol
        assert float(jnp.mean(np.asarray(it_m))) < float(
            jnp.mean(np.asarray(it_p))
        )


def test_restart_multirhs_block_boundary(data):
    """With iter_block>1 the restart signal is checked once per block (the
    per-step reduction would break the matmul epilogue fusion); the delayed
    check must still cut iterations vs plain K-blocked and satisfy the
    same residual criterion."""
    from proxtpu.kernels.lasso import solve_lasso_multirhs

    A, b, lam, Lf = data
    A1 = A[0]
    Lf1 = float(np.linalg.norm(np.asarray(A1), 2) ** 2)
    tol = 1e-5
    z_r, it_r, d_r = solve_lasso_multirhs(
        A1, b, lam, Lf1, tol, maxit=3000, iter_block=8, restart=True)
    z_p, it_p, d_p = solve_lasso_multirhs(
        A1, b, lam, Lf1, tol, maxit=3000, iter_block=8)
    assert bool(jnp.all(d_r)) and bool(jnp.all(d_p))
    gamma = 1.0 / Lf1
    res = jnp.max(jnp.abs(
        z_r - jnp.sign(z_r - gamma * ((z_r @ A1.T - b) @ A1))
        * jnp.maximum(
            jnp.abs(z_r - gamma * ((z_r @ A1.T - b) @ A1))
            - gamma * lam[:, None], 0.0))) / gamma
    assert float(res) <= 1.1 * tol
    assert float(jnp.mean(np.asarray(it_r))) < float(
        jnp.mean(np.asarray(it_p))
    )


def test_compacting_exact_parity(data):
    """Lane compaction is pure scheduling: per-lane counts and solutions
    are BIT-identical to solve_lasso_batch (shared loop body), for both
    the XLA and the interpreted-kernel step, plain and restarted, and
    with a lane capped at maxit."""
    from proxtpu.kernels.lasso import solve_lasso_batch_compacting

    A, b, lam, Lf = data
    rng = np.random.default_rng(5)
    # spread difficulty so compaction actually triggers
    lam = lam * jnp.asarray((0.2 + 0.8 * rng.random(lam.shape[0])),
                            jnp.float32)
    for use_kernel, interp in ((False, False), (True, True)):
        for restart in (False, True):
            z1, i1, d1 = solve_lasso_batch(
                A, b, lam, Lf, 1e-5, maxit=3000, use_kernel=use_kernel,
                interpret=interp, restart=restart)
            z2, i2, d2 = solve_lasso_batch_compacting(
                A, b, lam, Lf, 1e-5, maxit=3000, use_kernel=use_kernel,
                interpret=interp, restart=restart, segment=40, min_batch=2)
            assert (np.asarray(i1) == np.asarray(i2)).all()
            assert (np.asarray(d1) == np.asarray(d2)).all()
            if use_kernel:
                # each lane's reductions run in its own program, so
                # they do not depend on the batch size
                np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
            else:
                # XLA's batched-einsum reduction tiling depends on the
                # batch size -> last-ULP differences after the gather
                np.testing.assert_allclose(np.asarray(z1), np.asarray(z2),
                                           atol=5e-7)

    # maxit cap: unconverged lanes report maxit and done=False
    z1, i1, d1 = solve_lasso_batch(A, b, lam, Lf, 1e-12, maxit=60,
                                   use_kernel=False)
    z2, i2, d2 = solve_lasso_batch_compacting(
        A, b, lam, Lf, 1e-12, maxit=60, use_kernel=False, segment=25,
        min_batch=2)
    assert (np.asarray(i1) == np.asarray(i2)).all()
    assert (np.asarray(d1) == np.asarray(d2)).all()
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))


def test_mixed_solver_restart_kernel_matches_xla(data):
    """Both mixed-solver step paths implement the unified IMMEDIATE
    restart semantic (reset before the coefficient): counts agree +-1,
    residual criterion holds."""
    from proxtpu.kernels.lasso import solve_lasso_batch_mixed

    A, b, lam, Lf = data
    tol = 1e-5
    z_x, it_x, d_x = solve_lasso_batch_mixed(
        A, b, lam, Lf, tol, maxit=3000, use_kernel=False, restart=True)
    z_k, it_k, d_k = solve_lasso_batch_mixed(
        A, b, lam, Lf, tol, maxit=3000, use_kernel=True, interpret=True,
        restart=True)
    assert bool(jnp.all(d_x)) and bool(jnp.all(d_k))
    assert int(np.max(np.abs(np.asarray(it_x) - np.asarray(it_k)))) <= 1
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z_k))) <= 1.1 * tol


def _lasso_problems(B_, M_, N_, seed=0, lam_frac=0.1):
    rng = np.random.default_rng(seed)
    A = jnp.asarray((rng.standard_normal((B_, M_, N_)) / np.sqrt(M_))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((B_, M_)).astype(np.float32))
    lam = jnp.asarray(lam_frac * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(B_)], jnp.float32)
    return A, b, lam, Lf


def _canonical_recheck(A, b, lam, Lf, x):
    """Worst-lane FB residual at the CANONICAL gamma = 1/Lf — the
    criterion every solve must satisfy regardless of its internal
    stepsize."""
    A, b, lam, Lf, x = map(np.asarray, (A, b, lam, Lf, x))
    gam = (1.0 / Lf)[:, None]
    y = x - gam * np.einsum("bmn,bm->bn", A,
                            np.einsum("bmn,bn->bm", A, x) - b)
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lam[:, None], 0.0)
    return float(np.max(np.max(np.abs(x - z), axis=1) / gam[:, 0]))


def test_step_mult_faster_same_certificate():
    """Over-relaxed restart FISTA (round 5): step_mult=1.5 converges in
    fewer iterations than restart-only on the well-conditioned workload,
    and the returned solutions satisfy the CANONICAL criterion (res at
    gamma=1/Lf <= tol) — guaranteed by the gradient-mapping lemma via the
    in-solver ``res * Lf <= tol`` rule, not just rechecked."""
    # aspect/conditioning matter: at M/N = 1/2 with M >= 80 the win is
    # uniform (mean -20%); skinnier/smaller instances can trigger the
    # safeguard on unlucky draws (covered by the safeguard test below)
    A, b, lam, Lf = _lasso_problems(6, 80, 160, seed=0)
    tol = 1e-5
    for kw in (dict(use_kernel=False),
               dict(use_kernel=True, interpret=True)):
        z_r, it_r, d_r = solve_lasso_batch(
            A, b, lam, Lf, tol, maxit=3000, restart=True, **kw)
        z_s, it_s, d_s = solve_lasso_batch(
            A, b, lam, Lf, tol, maxit=3000, restart=True, step_mult=1.5,
            **kw)
        assert bool(jnp.all(d_s))
        assert _canonical_recheck(A, b, lam, Lf, z_s) <= tol * 1.05
        # same fixed point (both inside the tol-ball)
        np.testing.assert_allclose(np.asarray(z_s), np.asarray(z_r),
                                   atol=5e-3)
        # mean count strictly improves on this workload (measured ~20%)
        assert float(jnp.mean(it_s)) < float(jnp.mean(it_r))


def test_step_mult_safeguard_rescues_divergence():
    """At lam = 0.02 lam_max the over-relaxed momentum DIVERGES without a
    safeguard (measured: crit 1e29 within 250 iterations); the
    runaway/stall triggers must cold-restart those lanes at the canonical
    stepsize so every lane still converges, within ~25% of the
    restart-only counts."""
    A, b, lam, Lf = _lasso_problems(8, 40, 160, seed=3, lam_frac=0.02)
    tol = 1e-5
    z_s, it_s, d_s = solve_lasso_batch(
        A, b, lam, Lf, tol, maxit=20000, restart=True, step_mult=1.5,
        use_kernel=False)
    z_r, it_r, d_r = solve_lasso_batch(
        A, b, lam, Lf, tol, maxit=20000, restart=True, use_kernel=False)
    assert bool(jnp.all(d_s)), np.asarray(it_s)
    assert _canonical_recheck(A, b, lam, Lf, z_s) <= tol * 1.05
    # bounded detection overhead: worst case = detection + textbook
    assert float(jnp.max(it_s)) <= 1.3 * float(jnp.max(it_r))


def test_step_mult_validation():
    A, b, lam, Lf = _lasso_problems(4, 16, 128)
    with pytest.raises(ValueError, match="outside"):
        solve_lasso_batch(A, b, lam, Lf, 1e-5, restart=True, step_mult=2.5)
    with pytest.raises(ValueError, match="requires restart"):
        solve_lasso_batch(A, b, lam, Lf, 1e-5, step_mult=1.5)
    with pytest.raises(ValueError, match="mf"):
        solve_lasso_batch(A, b, lam, Lf, 1e-5, restart=True, step_mult=1.5,
                          mf=0.5)


def test_step_mult_one_is_bitexact_default():
    """step_mult=1.0 must take the ORIGINAL code path — bit-identical
    results to not passing it at all (the parity tests pin that path)."""
    A, b, lam, Lf = _lasso_problems(5, 24, 128, seed=2)
    z1, it1, d1 = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=2000,
                                    restart=True, use_kernel=False)
    z2, it2, d2 = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=2000,
                                    restart=True, use_kernel=False,
                                    step_mult=1.0)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_array_equal(np.asarray(it1), np.asarray(it2))


def _en_problems(B_=6, M_=40, N_=160, seed=0):
    A, b, lam1, Lf = _lasso_problems(B_, M_, N_, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lam2 = jnp.asarray(0.05 + 0.1 * rng.random(B_), jnp.float32)
    return A, b, lam1, lam2, Lf


def test_elastic_net_kernel_matches_generic_driver():
    """The lam2 (elastic net) route: soft threshold + per-lane
    1/(1+gamma*lam2) shrink rides the fused kernel; counts/solutions
    match the generic FISTA driver with the combined ElasticNet prox
    (the XLA route near-exactly; kernel within f32 tail knife edges —
    elastic-net residuals plateau near the threshold, so reduction-order
    noise moves the crossing by more than lasso's +-1)."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import ElasticNet, LeastSquaresLoss

    A, b, lam1, lam2, Lf = _en_problems()
    B_, N_ = A.shape[0], A.shape[2]
    tol = 1e-5
    gen = BatchedAlgorithm(make_fast_forward_backward_iteration,
                           maxit=3000, tol=tol, use_kernels=False)
    xs_g, it_g, d_g = gen(x0=jnp.zeros((B_, N_), jnp.float32),
                          f=LeastSquaresLoss(A, b),
                          g=ElasticNet(mu=lam1, lam=lam2), Lf=Lf)
    assert bool(jnp.all(d_g))
    for kw, it_slack in ((dict(use_kernel=False), 3),
                         (dict(use_kernel=True, interpret=True), 30)):
        z, it, d = solve_lasso_batch(A, b, lam1, Lf, tol, maxit=3000,
                                     lam2=lam2, **kw)
        assert bool(jnp.all(d))
        np.testing.assert_allclose(np.asarray(z), np.asarray(xs_g),
                                   atol=1e-3)
        assert int(np.max(np.abs(np.asarray(it) - np.asarray(it_g)))) \
            <= it_slack


def test_elastic_net_multirhs_and_restart():
    """Shared-A elastic net rides the multirhs matmul formulation; restart
    composes with lam2 (measured ~3x count cut on this set)."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.kernels.lasso import solve_lasso_multirhs
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import ElasticNet, LeastSquaresLoss

    A, b, lam1, lam2, Lf = _en_problems()
    B_, N_ = A.shape[0], A.shape[2]
    tol = 1e-5
    A1, Lf1 = A[0], float(Lf[0])
    z_m, it_m, d_m = solve_lasso_multirhs(A1, b, lam1, Lf1, tol,
                                          maxit=3000, lam2=lam2)
    gen = BatchedAlgorithm(make_fast_forward_backward_iteration,
                           maxit=3000, tol=tol, use_kernels=False)
    xs_g, it_g, d_g = gen(x0=jnp.zeros((B_, N_), jnp.float32),
                          f=LeastSquaresLoss(A1, b),
                          g=ElasticNet(mu=lam1, lam=lam2), Lf=Lf1)
    assert bool(jnp.all(d_m)) and bool(jnp.all(d_g))
    np.testing.assert_allclose(np.asarray(z_m), np.asarray(xs_g),
                               atol=1e-3)
    # restart on the lam2 kernel route
    z_r, it_r, d_r = solve_lasso_batch(A, b, lam1, Lf, tol, maxit=3000,
                                       lam2=lam2, restart=True,
                                       use_kernel=True, interpret=True)
    assert bool(jnp.all(d_r))
    z_p, it_p, d_p = solve_lasso_batch(A, b, lam1, Lf, tol, maxit=3000,
                                       lam2=lam2, use_kernel=True,
                                       interpret=True)
    assert float(jnp.mean(it_r)) < 0.6 * float(jnp.mean(it_p))
    np.testing.assert_allclose(np.asarray(z_r), np.asarray(z_p), atol=1e-3)


def test_elastic_net_lam2_validation():
    A, b, lam1, lam2, Lf = _en_problems(4, 16, 128)
    with pytest.raises(ValueError, match="lam2"):
        solve_lasso_batch(A, b, lam1, Lf, 1e-5, lam2=lam2, mf=0.5)
    with pytest.raises(ValueError, match="lam2"):
        solve_lasso_batch(A, b, lam1, Lf, 1e-5, lam2=lam2, restart=True,
                          step_mult=1.5)


def test_packed_tail_solver():
    """Two-phase tail solver: both cond branches converge every lane to
    the shared criterion; solutions sit in the same tol-ball as the
    single-phase solve; phase-boundary restart may change counts."""
    from proxtpu.kernels.lasso import solve_lasso_batch_tail

    rng = np.random.default_rng(5)
    Bq, Mq, Nq = 8, 16, 160
    A = jnp.asarray((rng.standard_normal((Bq, Mq, Nq)) / np.sqrt(Mq))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((Bq, Mq)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(Bq)], jnp.float32)
    tol = 1e-5
    kw = dict(use_kernel=True, interpret=True)
    z0, i0, d0 = solve_lasso_batch(
        A, b, lam, Lf, tol, maxit=3000, restart=True, **kw)
    # narrow branch: k1 past the median, tail wide enough
    z1, i1, d1 = solve_lasso_batch_tail(
        A, b, lam, Lf, tol, maxit=3000, k1=int(np.median(np.asarray(i0))),
        tail=Bq // 2, restart=True, **kw)
    assert bool(jnp.all(d1))
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z1))) <= 1.1 * tol
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z0), atol=1e-3)
    # wide fallback branch: k1 tiny so the tail cannot fit
    z2, i2, d2 = solve_lasso_batch_tail(
        A, b, lam, Lf, tol, maxit=3000, k1=5, tail=1, restart=True, **kw)
    assert bool(jnp.all(d2))
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z2))) <= 1.1 * tol
    # k1 >= maxit degrades to the single-phase solve
    z3, i3, d3 = solve_lasso_batch_tail(
        A, b, lam, Lf, tol, maxit=100, k1=100, tail=4, restart=True, **kw)
    assert (np.asarray(i3) <= 100).all()
    # maxit < k1: phase 1 is capped at maxit
    z4, i4, d4 = solve_lasso_batch_tail(
        A, b, lam, Lf, 1e-12, maxit=7, k1=100, tail=4, restart=True, **kw)
    assert (np.asarray(i4) <= 7).all()
    with np.testing.assert_raises(ValueError):
        solve_lasso_batch_tail(A, b, lam, Lf, tol, tail=0, **kw)
    # scalar lam/Lf accepted (the narrow-branch gather broadcasts them)
    z5, i5, d5 = solve_lasso_batch_tail(
        A, b, 0.05, float(jnp.max(Lf)), tol, maxit=3000,
        k1=int(np.median(np.asarray(i0))), tail=4, restart=True, **kw)
    assert bool(jnp.all(d5))
    # the XLA step runs the same two phases to the same criterion
    z6, i6, d6 = solve_lasso_batch_tail(
        A, b, lam, Lf, tol, maxit=3000, k1=int(np.median(np.asarray(i0))),
        tail=Bq // 2, restart=True)
    assert bool(jnp.all(d6))
    assert float(jnp.max(_fb_residual(A, b, lam, Lf, z6))) <= 1.1 * tol
    np.testing.assert_allclose(np.asarray(z6), np.asarray(z1), atol=1e-3)


# ---------------------------------------------------------------------------
# The fused FISTA step kernel (interpret mode) against the XLA step
# ---------------------------------------------------------------------------

_SHAPES = {
    "N-not-pow2": (5, 16, 24),
    "N-pow2": (4, 16, 32),
    "M-not-multiple-of-rows": (3, 37, 50),
    "B1": (1, 20, 64),
}
_VARIANTS = {
    "plain": {},
    "restart": dict(restart=True),
    "shrink": dict(shrink=True),
    "frozen": dict(frozen=True),
    "restart-shrink-frozen": dict(restart=True, shrink=True, frozen=True),
}


def _step_operands(B_, M_, N_, seed=0, frozen=False, shrink=False):
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    A = f32(rng.standard_normal((B_, M_, N_)) / np.sqrt(M_))
    b = f32(rng.standard_normal((B_, M_)))
    x = f32(rng.standard_normal((B_, N_)))
    zp = f32(x + 0.1 * rng.standard_normal((B_, N_)))
    Lf = np.array([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                   for i in range(B_)])
    gamma = f32(1.0 / Lf)
    thr = f32(np.asarray(gamma) * 0.05)
    beta = f32(rng.random(B_))
    done = f32((np.arange(B_) % 2 == 1) if frozen else np.zeros(B_))
    shr = f32(1.0 + rng.random(B_)) if shrink else None
    return A, b, x, zp, beta, gamma, thr, done, shr


@pytest.mark.parametrize("variant", list(_VARIANTS))
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_fused_fista_step_matches_xla_step(shape, variant):
    """One full iteration (FB step, prox, optional elastic-net divide,
    restart signal and its immediate use, extrapolation, frozen-lane
    pass-through) agrees with the XLA step to f32 summation-order noise,
    for N a power of two or not, M not a multiple of the row tile, B=1."""
    opts = _VARIANTS[variant]
    restart = opts.get("restart", False)
    A, b, x, zp, beta, gamma, thr, done, shr = _step_operands(
        *_SHAPES[shape], frozen=opts.get("frozen", False),
        shrink=opts.get("shrink", False))
    got = fused_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                           restart=restart, interpret=True, block_rows=8)
    want = xla_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                          restart=restart)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=2e-6)
    if opts.get("frozen"):
        frozen = np.asarray(done) > 0
        np.testing.assert_array_equal(np.asarray(got[0])[frozen],
                                      np.asarray(x)[frozen])
        np.testing.assert_array_equal(np.asarray(got[1])[frozen],
                                      np.asarray(zp)[frozen])
        assert not np.asarray(got[2])[frozen].any()


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("shape", ["N-not-pow2", "M-not-multiple-of-rows"])
def test_fused_fista_step_row_splits(shape, splits):
    """Rows split across programs (partial gradients reduced in a second
    pass) give the same iteration as one program per lane."""
    A, b, x, zp, beta, gamma, thr, done, shr = _step_operands(
        *_SHAPES[shape], frozen=True, shrink=True)
    one = fused_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                           restart=True, interpret=True, block_rows=4)
    split = fused_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                             restart=True, interpret=True, block_rows=4,
                             splits=splits)
    for g, w in zip(split, one):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=2e-6)


@pytest.mark.parametrize("shape", [(256, 200, 400), (64, 200, 400),
                                   (1, 20, 64), (5, 37, 50),
                                   (1024, 200, 400), (8, 3000, 4000)])
def test_kernel_config_fits_tiles_and_splits_narrow_batches(shape):
    """Row tiles hold at most 16K elements of the power-of-two padded row,
    and rows are split across programs only while the grid is narrower
    than 256 programs, never into more splits than there are tiles."""
    from proxtpu.kernels.lasso import _kernel_config

    B_, M_, N_ = shape
    rows, warps, stages, splits = _kernel_config(B_, M_, N_)
    n_pad = 1 << (N_ - 1).bit_length()
    tiles = -(-M_ // rows)
    assert rows >= 1 and rows & (rows - 1) == 0
    assert rows * n_pad <= 16384 or rows == 1
    assert (warps, stages) == (4, 2)
    assert 1 <= splits <= tiles
    if B_ >= 256:
        assert splits == 1
    else:
        assert splits == tiles or B_ * splits > 128
        assert splits == 1 or B_ * splits <= 256


def test_fused_step_reads_narrow_storage(data):
    """A stored in bfloat16 is widened tile by tile inside the kernel: the
    step equals the XLA step on the widened operator."""
    A, b, lam, Lf = data
    A16 = A.astype(jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((B, N)),
                    jnp.float32)
    gamma = (1.0 / Lf).astype(jnp.float32)
    z_k, r_k = fused_fb_prox_grad(A16, b, x, gamma, gamma * lam,
                                  interpret=True)
    z_r, r_r = reference_fb_prox_grad(A16.astype(jnp.float32), b, x, gamma,
                                      gamma * lam)
    np.testing.assert_allclose(np.asarray(z_k), np.asarray(z_r), atol=5e-6)
    np.testing.assert_allclose(np.asarray(r_k), np.asarray(r_r), atol=5e-6)


@pytest.mark.parametrize("restart", [False, True])
def test_solver_kernel_parity_odd_shape(restart):
    """Whole solves on the kernel and on the XLA step agree at a shape
    with masked rows and columns: counts within 1, solutions 1e-4."""
    A, b, lam, Lf = _lasso_problems(6, 37, 50, seed=0)
    z_k, i_k, d_k = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=3000,
                                      use_kernel=True, interpret=True,
                                      restart=restart)
    z_x, i_x, d_x = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=3000,
                                      use_kernel=False, restart=restart)
    assert bool(jnp.all(d_k)) and bool(jnp.all(d_x))
    assert int(np.max(np.abs(np.asarray(i_k) - np.asarray(i_x)))) <= 1
    np.testing.assert_allclose(np.asarray(z_k), np.asarray(z_x), atol=1e-4)


def test_mf_kernel_route_matches_xla():
    """Strongly-convex (mf>0) constant coefficients ride the kernel: counts
    match the XLA step within 1 and mf cuts iterations vs the plain
    t-recursion."""
    rng = np.random.default_rng(13)
    Bq, Mq, Nq = 4, 320, 160            # tall A -> strongly convex
    A = jnp.asarray((rng.standard_normal((Bq, Mq, Nq)) / np.sqrt(Mq))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((Bq, Mq)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    sv = [np.linalg.svd(np.asarray(A[i]), compute_uv=False)
          for i in range(Bq)]
    Lf = jnp.asarray([s[0] ** 2 for s in sv], jnp.float32)
    mf = min(float(s[-1] ** 2) for s in sv)
    kw = dict(use_kernel=True, interpret=True)
    z1, i1, d1 = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=4000, mf=mf,
                                   **kw)
    z2, i2, d2 = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=4000, mf=mf,
                                   use_kernel=False)
    _, i3, d3 = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=4000, **kw)
    assert bool(jnp.all(d1)) and bool(jnp.all(d2)) and bool(jnp.all(d3))
    assert int(np.max(np.abs(np.asarray(i1) - np.asarray(i2)))) <= 1
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z2), atol=1e-4)
    assert float(np.mean(np.asarray(i1))) < float(np.mean(np.asarray(i3)))


# ---------------------------------------------------------------------------
# Route resolution
# ---------------------------------------------------------------------------


def test_route_cpu_is_xla(data):
    A = data[0]
    assert jax.default_backend() == "cpu"
    assert lasso_step_route(A) == "xla"
    assert lasso_step_route(A, use_kernel=False) == "xla"


def test_route_use_kernel_off_gpu_raises(data):
    A, b, lam, Lf = data
    with pytest.raises(ValueError, match="needs a GPU"):
        lasso_step_route(A, use_kernel=True)
    with pytest.raises(ValueError, match="needs a GPU"):
        solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=10, use_kernel=True)


def test_route_interpret_reaches_kernel(data):
    A = data[0]
    assert lasso_step_route(A, interpret=True) == "kernel"
    assert lasso_step_route(A, use_kernel=True, interpret=True) == "kernel"
    assert lasso_step_route(A, use_kernel=False, interpret=True) == "xla"


@pytest.mark.parametrize("dtype,want", [(np.float32, "kernel"),
                                        (np.float64, "xla")])
def test_route_on_gpu_keys_on_dtype(monkeypatch, dtype, want):
    """On a GPU the default picks the kernel for float32 only; f64 takes
    the XLA step, and demanding the kernel for f64 raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    A = jnp.zeros((2, 3, 4), dtype)
    assert lasso_step_route(A) == want
    if want == "xla":
        with pytest.raises(ValueError, match="float32"):
            lasso_step_route(A, use_kernel=True)


def test_batched_algorithm_interpret_runs_kernel(data):
    """``use_kernels="interpret"`` routes the flagship shape through the
    kernel (a pallas_call in the traced solve); the default on the CPU
    takes the XLA step (no pallas_call)."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.kernels.dispatch import match_kernel_solver
    from proxtpu.prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = data
    kw = dict(x0=jnp.zeros((B, N), jnp.float32), f=LeastSquaresLoss(A, b),
              g=NormL1(lam), Lf=Lf)
    def primitives(jaxpr):
        for eqn in jaxpr.eqns:
            yield eqn.primitive.name
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        yield from primitives(sub)

    for interpret, want in ((True, True), (None, False)):
        run = match_kernel_solver(make_fast_forward_backward_iteration, kw,
                                  tol=1e-5, maxit=50, interpret=interpret)
        assert run is not None
        names = set(primitives(jax.make_jaxpr(run)().jaxpr))
        assert ("pallas_call" in names) == want


# ---------------------------------------------------------------------------
# Compile cache helper
# ---------------------------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from proxtpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from pathlib import Path

    from proxtpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    root = Path(__file__).resolve().parents[1]
    try:
        first = enable_compile_cache()
        assert first == enable_compile_cache() == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# ---------------------------------------------------------------------------
# On the card (skip elsewhere)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu):
    """The compiled Triton kernel (no interpret mode) against the XLA step
    at full float32 precision, on the card."""
    A, b, x, zp, beta, gamma, thr, done, shr = _step_operands(
        16, 200, 400, frozen=True, shrink=True)
    got = fused_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                           restart=True)
    want = xla_fista_step(A, b, x, zp, beta, gamma, thr, done, shr,
                          restart=True)
    for g, w in zip(got, want):
        scale = max(1.0, float(jnp.max(jnp.abs(w))))
        assert float(jnp.max(jnp.abs(g - w))) <= 2e-5 * scale
    assert lasso_step_route(A) == "kernel"
