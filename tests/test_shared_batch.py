"""Lane-invariant (Shared) problem data in batched solves.

The reference has no batching (SURVEY.md §2.6); scenario batching is a batched-build
capability, and ``Shared`` is its operand-sharing axis: a
regularization-path sweep shares (A, b) across lanes and varies ``lam``,
a multi-RHS solve shares A — in both, stacking B identical copies of the
operand forces a batched-GEMV lowering where a lane-invariant operand makes
the same step a single matmul.

These tests pin the *semantics*: a Shared problem must produce the same
per-lane solutions (and iteration counts, up to summation-order roundoff of
matmul-vs-batched-GEMV lowering) as the materially stacked problem and as a
loop of single solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.algorithms import DouglasRachford, FastForwardBackward
from proxtpu.algorithms.douglas_rachford import make_douglas_rachford_iteration
from proxtpu.algorithms.drls import make_drls_iteration
from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.algorithms.panoc import make_panoc_iteration
from proxtpu.algorithms.panocplus import make_panocplus_iteration
from proxtpu.algorithms.zerofpr import make_zerofpr_iteration
from proxtpu.ops.linops import MatrixOperator, as_linop
from proxtpu.parallel import (
    BatchedAlgorithm,
    Shared,
    batch_axes,
    compacting_batched_run,
    unwrap_shared,
)
from proxtpu.prox.functions import (
    LeastSquaresLoss,
    NormL1,
    SqrDistance,
    make_least_squares,
)

B, M, N = 6, 48, 32
TOL = 1e-6


def lasso_problem(dtype=jnp.float64):
    rng = np.random.default_rng(7)
    A = jnp.asarray(
        rng.standard_normal((M, N)) / np.sqrt(M), dtype
    )
    b = jnp.asarray(rng.standard_normal(M), dtype)
    lam = jnp.asarray(0.05 + 0.25 * rng.random(B), dtype)
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    return A, b, lam, Lf


# ---------------------------------------------------------------------------
# the marker itself


def test_shared_is_transparent_pytree():
    A, b, _, _ = lasso_problem()
    f = Shared(LeastSquaresLoss(A, b))
    # attribute/call delegation
    assert f.A is A
    v, g = f.value_and_gradient(jnp.zeros(N))
    assert v.shape == ()
    # pytree round trip keeps the wrapper
    leaves, treedef = jax.tree.flatten(f)
    f2 = jax.tree.unflatten(treedef, leaves)
    assert isinstance(f2, Shared)
    assert jnp.array_equal(f2.A, A)
    # jit through
    out = jax.jit(lambda fn, x: fn.value_and_gradient(x)[0])(
        f, jnp.zeros(N)
    )
    assert np.isfinite(float(out))
    # unwrap
    assert isinstance(unwrap_shared(f), LeastSquaresLoss)
    assert unwrap_shared((f, 3))[0].__class__ is LeastSquaresLoss


def test_batch_axes_marks_shared_subtrees():
    A, b, _, _ = lasso_problem()
    f = Shared(LeastSquaresLoss(A, b))
    assert batch_axes(f) is None
    axes = batch_axes({"f": f, "x": jnp.zeros((B, N))})
    assert axes["f"] is None and axes["x"] == 0
    # vmap accepts the generated axes tree
    out = jax.vmap(
        lambda fn, x: fn.value_and_gradient(x)[0],
        in_axes=(batch_axes(f), 0),
    )(f, jnp.zeros((B, N)))
    assert out.shape == (B,)


# ---------------------------------------------------------------------------
# generic vmapped driver


def test_generic_driver_shared_matches_stacked_and_single():
    A, b, lam, Lf = lasso_problem()
    x0 = jnp.zeros((B, N))
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=5000, tol=TOL,
        use_kernels=False,
    )
    xs_sh, it_sh, dn_sh = solver(
        x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lam), Lf=Lf
    )
    f_st = LeastSquaresLoss(
        jnp.broadcast_to(A, (B, M, N)), jnp.broadcast_to(b, (B, M))
    )
    xs_st, it_st, dn_st = solver(x0=x0, f=f_st, g=NormL1(lam), Lf=Lf)
    assert bool(dn_sh.all()) and bool(dn_st.all())
    np.testing.assert_allclose(
        np.asarray(xs_sh), np.asarray(xs_st), rtol=0, atol=1e-9
    )
    # matmul-vs-batched-GEMV summation order can move the stopping test by
    # an ulp at the knife edge; counts agree within a step or two in f64
    assert int(np.max(np.abs(np.asarray(it_sh) - np.asarray(it_st)))) <= 2

    single = FastForwardBackward(maxit=5000, tol=TOL)
    for i in range(B):
        x, _ = single(
            x0=jnp.zeros(N), f=LeastSquaresLoss(A, b),
            g=NormL1(lam[i]), Lf=Lf,
        )
        np.testing.assert_allclose(
            np.asarray(xs_sh[i]), np.asarray(x), rtol=0, atol=1e-5
        )


def test_generic_driver_shared_douglas_rachford():
    """A prox-only splitting through the generic driver with a Shared f
    (exercises delegation of ``prox`` and the freeze machinery)."""
    A, b, lam, _ = lasso_problem()
    x0 = jnp.zeros((B, N))
    solver = BatchedAlgorithm(
        make_douglas_rachford_iteration, maxit=8000, tol=TOL,
        use_kernels=False,
    )
    f_sh = Shared(make_least_squares(A, b))
    xs_sh, it_sh, dn = solver(x0=x0, f=f_sh, g=NormL1(lam), gamma=1.0)
    assert bool(dn.all())
    single = DouglasRachford(maxit=8000, tol=TOL)
    for i in range(B):
        x, it = single(
            x0=jnp.zeros(N), f=make_least_squares(A, b),
            g=NormL1(lam[i]), gamma=1.0,
        )
        np.testing.assert_allclose(
            np.asarray(xs_sh[i]), np.asarray(x), rtol=0, atol=1e-6
        )
        assert abs(int(it_sh[i]) - it) <= 2


def test_compacting_run_keeps_shared_subtrees():
    A, b, lam, Lf = lasso_problem()
    iteration = make_fast_forward_backward_iteration(
        x0=jnp.zeros((B, N)), f=Shared(LeastSquaresLoss(A, b)),
        g=NormL1(lam), Lf=jnp.full((B,), Lf),
    )
    # batched_run_loop/compacting_batched_run broadcast rank-0
    # hyperparameters themselves (broadcast_hyperparams)
    from proxtpu.parallel import batched_run_loop

    xs, iters, done = batched_run_loop(iteration, 5000, TOL)
    xs_c, iters_c, done_c = compacting_batched_run(
        iteration, 5000, TOL, chunk=64, min_batch=2
    )
    assert bool(done.all()) and bool(done_c.all())
    np.testing.assert_allclose(
        np.asarray(xs), np.asarray(xs_c), rtol=0, atol=1e-9
    )
    np.testing.assert_array_equal(np.asarray(iters), np.asarray(iters_c))


# ---------------------------------------------------------------------------
# flat line-search machines (via the dispatch layer)


@pytest.mark.parametrize(
    "factory",
    [make_panoc_iteration, make_zerofpr_iteration, make_panocplus_iteration],
)
def test_flat_linesearch_shared_A_matches_stacked(factory):
    A, b, lam, Lf = lasso_problem()
    x0 = jnp.zeros((B, N))
    solver = BatchedAlgorithm(factory, maxit=1000, tol=TOL)
    f = Shared(SqrDistance(b))
    g = NormL1(lam)
    xs_sh, it_sh, dn_sh = solver(
        x0=x0, f=f, A=Shared(MatrixOperator(A)), g=g, Lf=Lf, adaptive=False
    )
    xs_st, it_st, dn_st = solver(
        x0=x0, f=Shared(SqrDistance(b)),
        A=jnp.broadcast_to(A, (B, M, N)), g=g, Lf=Lf, adaptive=False,
    )
    assert bool(dn_sh.all()) and bool(dn_st.all())
    # both runs are converged to tol; the matmul-vs-batched-GEMV rounding
    # difference is amplified chaotically by the L-BFGS directions, so the
    # two trajectories agree at tolerance level, not bitwise
    np.testing.assert_allclose(
        np.asarray(xs_sh), np.asarray(xs_st), rtol=0, atol=1e-5
    )
    assert int(np.max(np.abs(np.asarray(it_sh) - np.asarray(it_st)))) <= 5
    # a bare 2-D matrix is unambiguously lane-invariant: same route
    xs_2d, it_2d, _ = solver(
        x0=x0, f=f, A=A, g=g, Lf=Lf, adaptive=False
    )
    np.testing.assert_array_equal(np.asarray(xs_2d), np.asarray(xs_sh))


def test_flat_drls_shared_f():
    A, b, lam, Lf = lasso_problem()
    x0 = jnp.zeros((B, N))
    solver = BatchedAlgorithm(make_drls_iteration, maxit=500, tol=TOL)
    xs_sh, it_sh, dn = solver(
        x0=x0, f=Shared(make_least_squares(A, b)), g=NormL1(lam), Lf=Lf
    )
    assert bool(dn.all())
    fs = jax.vmap(lambda _: make_least_squares(A, b))(jnp.arange(B))
    xs_st, it_st, dn_st = solver(x0=x0, f=fs, g=NormL1(lam), Lf=Lf)
    assert bool(dn_st.all())
    np.testing.assert_allclose(
        np.asarray(xs_sh), np.asarray(xs_st), rtol=0, atol=1e-5
    )
    assert int(np.max(np.abs(np.asarray(it_sh) - np.asarray(it_st)))) <= 5


def test_flat_adaptive_shared_f():
    A, b, lam, _ = lasso_problem()
    x0 = jnp.zeros((B, N))
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=5000, tol=TOL
    )
    xs_sh, it_sh, dn = solver(
        x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lam),
        adaptive=True,
    )
    assert bool(dn.all())
    f_st = LeastSquaresLoss(
        jnp.broadcast_to(A, (B, M, N)), jnp.broadcast_to(b, (B, M))
    )
    xs_st, it_st, dn_st = solver(
        x0=x0, f=f_st, g=NormL1(lam), adaptive=True
    )
    assert bool(dn_st.all())
    np.testing.assert_allclose(
        np.asarray(xs_sh), np.asarray(xs_st), rtol=0, atol=1e-8
    )
    assert int(np.max(np.abs(np.asarray(it_sh) - np.asarray(it_st)))) <= 2


# ---------------------------------------------------------------------------
# kernel dispatch: Shared f routes the lam sweep to the multirhs kernel


def test_shared_f_routes_to_multirhs_kernel():
    from proxtpu.kernels.dispatch import match_kernel_solver

    A, b, lam, Lf = lasso_problem(jnp.float32)
    x0 = np.zeros((B, N), np.float32)
    kwargs = dict(
        x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lam), Lf=Lf
    )
    run = match_kernel_solver(
        make_fast_forward_backward_iteration, kwargs,
        tol=1e-5, maxit=5000, interpret=True,
    )
    assert run is not None
    xs, iters, done = run()
    assert bool(done.all())
    generic = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=5000, tol=1e-5,
        use_kernels=False,
    )
    xs_g, it_g, dn_g = generic(**kwargs)
    assert bool(dn_g.all())
    np.testing.assert_allclose(
        np.asarray(xs), np.asarray(xs_g), rtol=0, atol=2e-4
    )


# ---------------------------------------------------------------------------
# hygiene: dtype preservation + x0 immutability through the shared paths


def test_shared_dtype_and_x0_immutability():
    A, b, lam, Lf = lasso_problem(jnp.float32)
    x0 = jnp.ones((B, N), jnp.float32)
    x0_copy = np.asarray(x0).copy()
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=3000, tol=1e-5,
        use_kernels=False,
    )
    xs, _, dn = solver(
        x0=x0, f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lam), Lf=Lf
    )
    assert xs.dtype == jnp.float32
    assert bool(dn.all())
    np.testing.assert_array_equal(np.asarray(x0), x0_copy)


def test_as_linop_keeps_shared_marker():
    A, _, _, _ = lasso_problem()
    op = as_linop(Shared(A))
    assert isinstance(op, Shared)
    assert isinstance(unwrap_shared(op), MatrixOperator)
    op2 = as_linop(Shared(MatrixOperator(A)))
    assert isinstance(op2, Shared)


def test_batched_chambolle_pock_shared_L():
    """The primal-dual family through the generic driver with a Shared
    operator: batched CP solves the lasso dual formulation
    ``min lam||x||_1 + 0.5||Lx - b||^2`` with ONE shared L and per-lane
    lam, matching the single driver."""
    from proxtpu.algorithms.primal_dual import (
        ChambollePock,
        make_chambolle_pock_iteration,
    )

    A, b, lam, _ = lasso_problem()
    x0 = jnp.zeros((B, N))
    y0 = jnp.zeros((B, M))
    opn = float(np.linalg.norm(np.asarray(A), 2))
    g1 = 0.9 / opn
    solver = BatchedAlgorithm(
        make_chambolle_pock_iteration, maxit=20000, tol=1e-5,
        use_kernels=False,
    )
    (xs, ys), iters, done = solver(
        x0=x0, y0=y0, g=NormL1(lam), h=Shared(SqrDistance(b)),
        L=Shared(MatrixOperator(A)), gamma=(g1, g1),
    )
    assert bool(done.all())
    single = ChambollePock(maxit=20000, tol=1e-5)
    for i in range(B):
        (x, y), it = single(
            x0=jnp.zeros(N), y0=jnp.zeros(M), g=NormL1(lam[i]),
            h=SqrDistance(b), L=A, gamma=(g1, g1),
        )
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=1e-6
        )
        assert abs(int(iters[i]) - it) <= 2


def test_shared_pickles_and_refuses_stacking():
    """Checkpointing serializes iteration pytrees (utils/checkpoint.py), so
    Shared must pickle/deepcopy; and stack_iterations must refuse Shared
    members (stacking B copies inside the wrapper would batch data the
    drivers then treat as lane-invariant)."""
    import copy
    import pickle

    from proxtpu.parallel import stack_iterations

    A, b, _, _ = lasso_problem()
    s = Shared(LeastSquaresLoss(A, b))
    s2 = pickle.loads(pickle.dumps(s))
    assert isinstance(s2, Shared)
    np.testing.assert_array_equal(np.asarray(s2.A), np.asarray(A))
    assert isinstance(copy.deepcopy(s), Shared)
    with pytest.raises(ValueError, match="Shared"):
        stack_iterations([{"f": s}, {"f": s}])


# ---------------------------------------------------------------------------
# auto-Shared normalization: the generic driver accepts the same
# lane-invariant shorthands as the kernel dispatch (bare 2-D A kwarg,
# unmarked f holding a shared design matrix), so skipping dispatch
# (verbose=True, use_kernels=False) never changes *what* a call returns
# ---------------------------------------------------------------------------


def test_generic_driver_accepts_bare_2d_A_kwarg():
    """A 2-D ``A`` kwarg is unambiguously lane-invariant (a stacked per-lane
    A would be 3-D): broadcast_hyperparams auto-wraps it in Shared, so the
    generic vmapped path solves it identically to the dispatch path."""
    from proxtpu.prox.functions import SqrDistance

    rng = np.random.default_rng(3)
    Bn, M, N_ = 5, 18, 30
    A = jnp.asarray(
        (rng.standard_normal((M, N_)) / np.sqrt(M)).astype(np.float32)
    )
    b = jnp.asarray(rng.standard_normal(M).astype(np.float32))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    lam = jnp.asarray((0.05 + 0.2 * rng.random(Bn)).astype(np.float32))
    kw = dict(
        x0=jnp.zeros((Bn, N_), jnp.float32), f=Shared(SqrDistance(b)), A=A,
        g=NormL1(lam), Lf=Lf, adaptive=False,
    )
    # verbose=True skips the kernel dispatch -> pure generic path
    generic = BatchedAlgorithm(
        make_panoc_iteration, maxit=500, tol=1e-5, use_kernels=False
    )
    x_g, it_g, d_g = generic(**kw)
    assert bool(jnp.all(d_g))
    # per-lane parity vs single solves with the same bare-2-D A
    from proxtpu.algorithms import PANOC

    for i in range(Bn):
        x_s, k_s = PANOC(maxit=500, tol=1e-5)(
            x0=jnp.zeros(N_, jnp.float32), f=SqrDistance(b), A=A,
            g=NormL1(float(lam[i])), Lf=Lf, adaptive=False,
        )
        np.testing.assert_allclose(
            np.asarray(x_s), np.asarray(x_g[i]), atol=2e-4
        )


def test_generic_driver_accepts_unmarked_shared_f():
    """Unmarked ``LeastSquaresLoss(A_2d, b_batched)`` — the multirhs
    shorthand the dispatch accepts — must solve on the generic driver too
    (leaves without the leading batch axis are auto-marked Shared)."""
    from proxtpu.parallel import batched_run_loop

    rng = np.random.default_rng(4)
    Bn, M, N_ = 6, 20, 40
    A = jnp.asarray(
        (rng.standard_normal((M, N_)) / np.sqrt(M)).astype(np.float32)
    )
    b = jnp.asarray(rng.standard_normal((Bn, M)).astype(np.float32))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.asarray(b) @ np.asarray(A)), axis=1)
    )
    iteration = make_fast_forward_backward_iteration(
        x0=jnp.zeros((Bn, N_), jnp.float32),
        f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf,
    )
    xs, iters, done = batched_run_loop(iteration, 3000, 1e-5)
    assert bool(jnp.all(done))
    for i in range(Bn):
        x_s, k_s = FastForwardBackward(maxit=3000, tol=1e-5)(
            x0=jnp.zeros(N_, jnp.float32), f=LeastSquaresLoss(A, b[i]),
            g=NormL1(lam[i]), Lf=Lf,
        )
        assert abs(int(k_s) - int(iters[i])) <= 1
        np.testing.assert_allclose(
            np.asarray(x_s), np.asarray(xs[i]), atol=1e-5
        )


def test_stack_iterations_accepts_generators():
    """Generator inputs must survive the Shared guard loop (regression:
    the guard used to exhaust the generator before tree.map unpacked it)."""
    from proxtpu.parallel import stack_iterations

    rng = np.random.default_rng(5)
    M, N_ = 8, 12
    A = jnp.asarray(
        (rng.standard_normal((M, N_)) / np.sqrt(M)).astype(np.float32)
    )

    def make(i):
        b = jnp.asarray(rng.standard_normal(M).astype(np.float32))
        return make_fast_forward_backward_iteration(
            x0=jnp.zeros(N_, jnp.float32), f=LeastSquaresLoss(A, b),
            g=NormL1(0.1), Lf=float(np.linalg.norm(np.asarray(A), 2) ** 2),
        )

    stacked = stack_iterations(make(i) for i in range(3))
    assert stacked.x0.shape == (3, N_)
