"""Multi-device tests on the 8-virtual-CPU-device mesh.

The standard "multi-chip without a pod" fake (SURVEY.md §4): sharded-operator
solves and consensus splitting must produce the same solutions as their
single-device counterparts, with data actually distributed across devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import proxtpu as pa
from proxtpu.parallel import (
    ConsensusADMM,
    make_mesh,
    replicate,
    shard_batch,
    shard_matrix_operator,
    stack_functions,
)
from proxtpu.parallel.batch import batch_problems, batched_run_loop
from proxtpu.prox import NormL1, SqrNormL2, make_least_squares

TOL = 1e-6


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh((8,), ("tp",))


def big_lasso(seed=0, m=64, n=48):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.standard_normal((m, n)))
    b = jnp.asarray(rng.standard_normal(m))
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    return A, b, lam, Lf


def test_sharded_operator_matvecs(mesh):
    A, b, lam, Lf = big_lasso()
    op = shard_matrix_operator(A, mesh, row_axis="tp")
    x = jnp.asarray(np.random.default_rng(1).standard_normal(A.shape[1]))
    y = jnp.asarray(np.random.default_rng(2).standard_normal(A.shape[0]))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), np.asarray(A @ x))
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), np.asarray(A.T @ y))
    # A is actually distributed: each device holds a 1/8 stripe
    assert len(op.A.sharding.device_set) == 8


def test_sharded_panoc_matches_dense(mesh):
    A, b, lam, Lf = big_lasso()
    f = SqrNormL2(1.0)
    # f(Ax - b) composed via Translate on the operator output
    from proxtpu.prox import Translate

    fo = Translate(SqrNormL2(1.0), -replicate(b, mesh))
    g = NormL1(lam)
    x0 = replicate(jnp.zeros(A.shape[1]), mesh)

    op = shard_matrix_operator(A, mesh, row_axis="tp")
    solver = pa.PANOC(tol=TOL)
    x_sharded, it_sharded = solver(x0=x0, f=fo, A=op, g=g, Lf=Lf)

    x_dense, it_dense = pa.PANOC(tol=TOL)(
        x0=jnp.zeros(A.shape[1]), f=Translate(SqrNormL2(1.0), -b), A=A, g=g,
        Lf=Lf,
    )
    assert it_sharded == it_dense
    np.testing.assert_allclose(
        np.asarray(x_sharded), np.asarray(x_dense), atol=1e-10
    )


def test_consensus_admm_solves_blockwise_least_squares(mesh):
    # sum_i ||A_i x - b_i||^2/2 + lam ||x||_1 over 8 row-blocks == full lasso
    A, b, lam, Lf = big_lasso(m=64, n=16)
    B = 8
    blocks = [
        make_least_squares(A[i * 8 : (i + 1) * 8], b[i * 8 : (i + 1) * 8])
        for i in range(B)
    ]
    fs = stack_functions(blocks)
    fs = shard_batch(fs, mesh, "tp")
    solver = ConsensusADMM(tol=1e-7, maxit=20_000)
    x, it = solver(x0=jnp.zeros(16), fs=fs, g=NormL1(lam), gamma=1.0)

    x_ref, _ = pa.FastForwardBackward(tol=1e-10)(
        x0=jnp.zeros(16), f=make_least_squares(A, b), g=NormL1(lam), Lf=Lf
    )
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), atol=1e-5)


def test_dp_sharded_batch_solve(mesh):
    # scenario batch sharded across devices: same answers as unsharded batch
    from proxtpu.algorithms import make_fast_forward_backward_iteration

    problems = []
    for k in range(16):
        rng = np.random.default_rng(k)
        A = jnp.asarray(rng.standard_normal((8, 12)))
        b = jnp.asarray(rng.standard_normal(8))
        lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
        problems.append(
            dict(
                x0=jnp.zeros(12), f=make_least_squares(A, b), g=NormL1(lam),
                Lf=float(np.linalg.norm(np.asarray(A), 2) ** 2),
            )
        )
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    xs_plain, iters_plain, _ = batched_run_loop(iteration, 2000, TOL)

    iteration_sharded = shard_batch(iteration, mesh, "tp")
    xs_shard, iters_shard, _ = batched_run_loop(iteration_sharded, 2000, TOL)
    np.testing.assert_allclose(
        np.asarray(xs_shard), np.asarray(xs_plain), atol=1e-12
    )
    np.testing.assert_array_equal(
        np.asarray(iters_shard), np.asarray(iters_plain)
    )


def test_initialize_distributed_single_process_noop():
    """The all-default (and num_processes=1) paths are safe no-ops in a
    single-process environment and report the process count
    (proxtpu/parallel/distributed.py — the multi-host branch needs a real
    cluster)."""
    from proxtpu.parallel import initialize_distributed

    assert initialize_distributed() == 1
    assert initialize_distributed(num_processes=1) == 1


def test_global_mesh_runs_sharded_solve():
    """global_mesh spans all (virtual) devices; a dp-sharded batched solve
    runs under it and matches the unsharded result exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from proxtpu.kernels.lasso import solve_lasso_batch
    from proxtpu.parallel import global_mesh

    mesh = global_mesh((4, 2), ("dp", "tp"))
    assert mesh.devices.shape == (4, 2)

    rng = np.random.default_rng(0)
    B, M, N = 8, 16, 24
    A = jnp.asarray((rng.standard_normal((B, M, N)) / 4).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", np.asarray(A),
                                      np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(B)], jnp.float32)

    ref = solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=3000,
                            use_kernel=False)
    shard = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    with mesh:
        out = solve_lasso_batch(
            shard(A, P("dp", None, None)), shard(b, P("dp", None)),
            shard(lam, P("dp")), shard(Lf, P("dp")),
            1e-5, maxit=3000, use_kernel=False,
        )
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Kernel paths under shard_map (proxtpu/parallel/sharded_kernels.py): each
# device runs the fused solver on its local lanes — per-lane parity with the
# single-device solvers, data actually distributed.
# ---------------------------------------------------------------------------


def _lasso_batch(B=16, M=16, N=24, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = jnp.asarray((rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(dtype))
    b = jnp.asarray(rng.standard_normal((B, M)).astype(dtype))
    lam = jnp.asarray(
        0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", np.asarray(A),
                                      np.asarray(b))), axis=1).astype(dtype))
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(B)], A.dtype)
    return A, b, lam, Lf


@pytest.fixture(scope="module")
def dp_mesh():
    from proxtpu.parallel import default_dp_mesh

    return default_dp_mesh(8, axis="dp")


def test_sharded_lasso_kernel_parity(dp_mesh):
    """The fused step kernel under shard_map (interpret mode on the CPU
    mesh) matches the single-device solver lane for lane, with lanes
    actually distributed over the 8 devices."""
    from proxtpu.kernels.lasso import solve_lasso_batch
    from proxtpu.parallel import sharded_solve_lasso_batch

    A, b, lam, Lf = _lasso_batch()
    tol = 1e-5
    z1, it1, d1 = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                    use_kernel=False)
    z8, it8, d8 = sharded_solve_lasso_batch(
        A, b, lam, Lf, tol, mesh=dp_mesh, maxit=3000, use_kernel=True,
        interpret=True,
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    assert len(z8.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(z8), np.asarray(z1), atol=1e-5)
    assert int(np.max(np.abs(np.asarray(it8) - np.asarray(it1)))) <= 1


def test_sharded_multirhs_parity(dp_mesh):
    from proxtpu.kernels.lasso import solve_lasso_multirhs
    from proxtpu.parallel import sharded_solve_lasso_multirhs

    rng = np.random.default_rng(5)
    M, N, B = 24, 32, 16
    A = jnp.asarray((rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32))
    Bmat = jnp.asarray(rng.standard_normal((B, M)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(
        np.abs(np.asarray(Bmat) @ np.asarray(A)), axis=1).astype(np.float32))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    tol = 1e-5
    z1, it1, d1 = solve_lasso_multirhs(A, Bmat, lam, Lf, tol, maxit=3000)
    z8, it8, d8 = sharded_solve_lasso_multirhs(
        A, Bmat, lam, Lf, tol, mesh=dp_mesh, maxit=3000,
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    np.testing.assert_allclose(np.asarray(z8), np.asarray(z1), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(it8), np.asarray(it1))


def test_sharded_box_qp_parity(dp_mesh):
    from proxtpu.kernels.box_qp import solve_box_qp_batch
    from proxtpu.parallel import sharded_solve_box_qp_batch

    rng = np.random.default_rng(6)
    n, B = 16, 16
    Qs, qs, Lips = [], [], []
    for _ in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = 2 * rng.random(n) - 1
        Q0 = (U @ np.diag(ev) @ U.T).astype(np.float32)
        Qs.append(0.5 * (Q0 + Q0.T))
        qs.append(rng.standard_normal(n).astype(np.float32))
        Lips.append(np.max(np.abs(ev)))
    Q = jnp.asarray(np.stack(Qs))
    q = jnp.asarray(np.stack(qs))
    Lip = jnp.asarray(np.array(Lips, np.float32))
    tol = 1e-4
    x1, it1, d1 = solve_box_qp_batch(Q, q, -1.0, 1.0, Lip, tol,
                                     maxit=20_000)
    x8, it8, d8 = sharded_solve_box_qp_batch(
        Q, q, -1.0, 1.0, Lip, tol, mesh=dp_mesh, maxit=20_000,
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it8) - np.asarray(it1)))) <= 1


def test_sharded_lasso_restart_and_warm_start(dp_mesh):
    """restart= and x0= flow through the shard_map wrappers with parity
    against the unsharded solvers."""
    from proxtpu.kernels.lasso import solve_lasso_batch, solve_lasso_multirhs
    from proxtpu.parallel import (
        sharded_solve_lasso_batch,
        sharded_solve_lasso_multirhs,
    )

    rng = np.random.default_rng(7)
    B_, M_, N_ = 16, 12, 20
    A = jnp.asarray((rng.standard_normal((B_, M_, N_)) / np.sqrt(M_))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((B_, M_)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(B_)], jnp.float32)
    tol = 1e-5

    z1, i1, d1 = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                   use_kernel=False, restart=True)
    z8, i8, d8 = sharded_solve_lasso_batch(
        A, b, lam, Lf, tol, mesh=dp_mesh, maxit=3000, use_kernel=False,
        restart=True)
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    assert int(np.max(np.abs(np.asarray(i1) - np.asarray(i8)))) <= 1
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z8), atol=1e-5)

    # warm start from the solution: every lane finishes immediately
    _, iw, dw = sharded_solve_lasso_batch(
        A, b, lam, Lf, tol, mesh=dp_mesh, maxit=3000, use_kernel=False,
        x0=z8)
    assert bool(jnp.all(dw)) and int(np.max(np.asarray(iw))) <= 3

    A0, Lf0 = A[0], float(Lf[0])
    zm, im, dm = solve_lasso_multirhs(A0, b, lam, Lf0, tol, maxit=3000,
                                      restart=True)
    zs, is_, ds = sharded_solve_lasso_multirhs(
        A0, b, lam, Lf0, tol, mesh=dp_mesh, maxit=3000, restart=True)
    assert bool(jnp.all(dm)) and bool(jnp.all(ds))
    assert int(np.max(np.abs(np.asarray(im) - np.asarray(is_)))) <= 1
    np.testing.assert_allclose(np.asarray(zm), np.asarray(zs), atol=1e-5)


def test_sharded_tv_parity(dp_mesh):
    """The batched TV/Chambolle-Pock solver under shard_map, per-image
    lam, matches the single-device solver."""
    from proxtpu.kernels.tv import solve_tv_batch
    from proxtpu.parallel import sharded_solve_tv_batch

    rng = np.random.default_rng(6)
    B, H, W = 8, 16, 16
    b = jnp.asarray(rng.standard_normal((B, H, W)).astype(np.float32))
    lam = jnp.asarray((0.05 + 0.2 * rng.random(B)).astype(np.float32))
    tol = 1e-3
    x1, it1, d1 = solve_tv_batch(b, lam, tol, maxit=4000, iter_block=4)
    x8, it8, d8 = sharded_solve_tv_batch(
        b, lam, tol, mesh=dp_mesh, maxit=4000, iter_block=4,
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    assert len(x8.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(it8), np.asarray(it1))


def test_generic_driver_shared_operand_dp_sharded(dp_mesh):
    """GSPMD composition of Shared with data parallelism: batched leaves
    sharded over dp, the Shared design matrix replicated — the generic
    driver's solutions must match the unsharded run exactly, with outputs
    actually distributed."""
    from jax.sharding import NamedSharding
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.parallel import Shared, batched_run_loop
    from proxtpu.prox import LeastSquaresLoss, NormL1

    rng = np.random.default_rng(7)
    B, M, N = 16, 24, 32
    A = jnp.asarray((rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(M).astype(np.float32))
    lam = jnp.asarray((0.1 + 0.2 * rng.random(B)).astype(np.float32))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    iteration = make_fast_forward_backward_iteration(
        x0=jnp.zeros((B, N), jnp.float32), f=Shared(LeastSquaresLoss(A, b)),
        g=NormL1(lam), Lf=jnp.full((B,), Lf, jnp.float32),
    )
    # materialize the driver's normalization so the shardings below attach
    # to the exact tree batched_run_loop will see
    from proxtpu.parallel.batch import broadcast_hyperparams

    iteration = broadcast_hyperparams(iteration)
    xs1, it1, d1 = batched_run_loop(iteration, 3000, 1e-5)

    dp = lambda *tail: NamedSharding(dp_mesh, P("dp", *tail))
    repl = NamedSharding(dp_mesh, P())
    sharded_iter = jax.tree.map(
        lambda l: l if isinstance(l, Shared)
        else jax.device_put(
            l, dp(*([None] * (jnp.ndim(l) - 1))) if jnp.ndim(l) else repl
        ),
        iteration, is_leaf=lambda x: isinstance(x, Shared),
    )
    # replicate the Shared subtree's leaves explicitly
    from proxtpu.parallel import unwrap_shared  # noqa: F401

    sharded_iter = jax.tree.map(
        lambda l: jax.device_put(l, repl)
        if isinstance(l, jax.Array) and l.sharding.device_set != set(dp_mesh.devices.flat)
        else l,
        sharded_iter,
    )
    xs8, it8, d8 = batched_run_loop(sharded_iter, 3000, 1e-5)
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    assert len(xs8.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(xs8), np.asarray(xs1), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(it8), np.asarray(it1))


def test_flat_machines_dp_sharded(dp_mesh):
    """The flat trial/commit machines under plain GSPMD dp sharding: lanes
    distributed over the mesh, identical per-lane counts and solutions to
    the unsharded run (the machines are pure jit programs over stacked
    arrays — XLA partitions every vmapped op along the batch axis; the
    global `all(done)` reduce becomes a psum)."""
    from proxtpu.ops.linops import MatrixOperator
    from proxtpu.parallel import Shared, batched_panoc, batched_zerofpr
    from proxtpu.prox import SqrDistance

    rng = np.random.default_rng(21)
    B, M, N = 16, 24, 40
    A = jnp.asarray(rng.standard_normal((B, M, N)) / np.sqrt(M))
    b = jnp.asarray(rng.standard_normal((B, M)))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1))
    Lf = jnp.asarray(
        [float(np.linalg.norm(np.asarray(A[i]), 2) ** 2) for i in range(B)]
    )
    f = jax.vmap(SqrDistance)(b)
    g = NormL1(lam)
    Aop = jax.vmap(MatrixOperator)(A)
    x0 = jnp.zeros((B, N))
    gamma = 0.95 / Lf

    dp = lambda *tail: NamedSharding(dp_mesh, P("dp", *tail))
    shard = lambda arr, spec: jax.device_put(jnp.asarray(arr), spec)

    for fn in (batched_zerofpr, batched_panoc):
        z0, k0, d0 = fn(f, Aop, g, x0, gamma, 1e-6, maxit=400)
        z1, k1, d1 = fn(
            jax.tree.map(lambda l: shard(l, dp()) if l.ndim == 1
                         else shard(l, dp(*([None] * (l.ndim - 1)))), f),
            jax.tree.map(lambda l: shard(l, dp(None, None)), Aop),
            jax.tree.map(lambda l: shard(l, dp()), g),
            shard(x0, dp(None)), shard(gamma, dp()), 1e-6, maxit=400,
        )
        assert bool(jnp.all(d1))
        assert np.array_equal(np.asarray(k0), np.asarray(k1)), fn.__name__
        np.testing.assert_allclose(
            np.asarray(z0), np.asarray(z1), atol=1e-12
        )
        # lanes actually live distributed across the mesh
        assert len(z1.sharding.device_set) == 8

    # Shared-operand variant: one (A, b), per-lane lam, dp-sharded lanes
    A1, b1 = A[0], b[0]
    f_sh = Shared(SqrDistance(b1))
    Aop_sh = Shared(MatrixOperator(A1))
    gam1 = jnp.full((B,), 0.95 / float(Lf[0]))
    z0, k0, d0 = batched_zerofpr(f_sh, Aop_sh, g, x0, gam1, 1e-6, maxit=400)
    z1, k1, d1 = batched_zerofpr(
        f_sh, Aop_sh, jax.tree.map(lambda l: shard(l, dp()), g),
        shard(x0, dp(None)), shard(gam1, dp()), 1e-6, maxit=400,
    )
    assert bool(jnp.all(d1))
    assert np.array_equal(np.asarray(k0), np.asarray(k1))
    np.testing.assert_allclose(np.asarray(z0), np.asarray(z1), atol=1e-12)


def test_generic_driver_shared_operand_dp_x_tp_sharded():
    """dp x tp composition: ONE design matrix
    tensor-sharded over 'tp' (row stripes) serving a batch of lanes
    data-sharded over 'dp' — the huge-matrix regularization-path layout.
    GSPMD turns the Shared matvec into local matmuls + a psum over tp and
    keeps lanes on their dp shard; solutions must match the fully
    replicated run exactly.  The operator seam that makes this free is the
    same matvec-only contract as the reference's
    ``fb_tools.jl:21-22``."""
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.parallel import Shared, batched_run_loop, make_mesh
    from proxtpu.prox import LeastSquaresLoss, NormL1

    mesh2 = make_mesh((4, 2), ("dp", "tp"))
    rng = np.random.default_rng(11)
    B, M, N = 16, 24, 32
    A = jnp.asarray((rng.standard_normal((M, N)) / np.sqrt(M))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal(M).astype(np.float32))
    lam = jnp.asarray((0.1 + 0.2 * rng.random(B)).astype(np.float32))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)

    def make_it(A_, b_, lam_, x0_):
        return make_least_squares_iteration(A_, b_, lam_, x0_)

    def make_least_squares_iteration(A_, b_, lam_, x0_):
        return make_fast_forward_backward_iteration(
            x0=x0_, f=Shared(LeastSquaresLoss(A_, b_)), g=NormL1(lam_),
            Lf=jnp.full((B,), Lf, jnp.float32),
        )

    # replicated baseline
    it_ref = make_it(A, b, lam, jnp.zeros((B, N), jnp.float32))
    xs1, i1, d1 = batched_run_loop(it_ref, 3000, 1e-5)

    # dp x tp: lanes over dp, the one A row-sharded over tp
    put = lambda v, *spec: jax.device_put(v, NamedSharding(mesh2, P(*spec)))
    it_sh = make_it(
        put(A, "tp", None), put(b, "tp"), put(lam, "dp"),
        put(jnp.zeros((B, N), jnp.float32), "dp", None),
    )
    xs2, i2, d2 = batched_run_loop(it_sh, 3000, 1e-5)
    assert bool(jnp.all(d1)) and bool(jnp.all(d2))
    # outputs live on the full 8-device mesh
    assert len(xs2.sharding.device_set) == 8
    # unlike pure dp (which keeps each lane's arithmetic intact), tp
    # splits the M-contraction across devices: the psum reassociates the
    # sum, so last-ULP residual drift can flip knife-edge stops — counts
    # agree except possibly such flips, solutions within the tol-ball
    same = np.asarray(i1) == np.asarray(i2)
    assert same.mean() >= 0.75, (np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(xs2), np.asarray(xs1), atol=1e-3)
    # every sharded lane satisfies the stopping criterion, recomputed in
    # f64 on the host
    A64, b64 = np.asarray(A, np.float64), np.asarray(b, np.float64)
    gam = 1.0 / Lf
    for i in range(B):
        x = np.asarray(xs2[i], np.float64)
        y = x - gam * (A64.T @ (A64 @ x - b64))
        z = np.sign(y) * np.maximum(np.abs(y) - gam * float(lam[i]), 0.0)
        assert np.max(np.abs(x - z)) / gam <= 1.2e-5


def test_sharded_lasso_kernel_restart_parity(dp_mesh):
    """Restarted FISTA on the fused step under shard_map (interpret mode)
    matches the single-device XLA solve lane for lane."""
    from proxtpu.kernels.lasso import solve_lasso_batch
    from proxtpu.parallel import sharded_solve_lasso_batch

    A, b, lam, Lf = _lasso_batch(seed=4)
    tol = 1e-5
    z1, it1, d1 = solve_lasso_batch(A, b, lam, Lf, tol, maxit=3000,
                                    use_kernel=False, restart=True)
    z8, it8, d8 = sharded_solve_lasso_batch(
        A, b, lam, Lf, tol, mesh=dp_mesh, maxit=3000, use_kernel=True,
        interpret=True, restart=True,
    )
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    np.testing.assert_allclose(np.asarray(z8), np.asarray(z1), atol=1e-4)
    assert int(np.max(np.abs(np.asarray(it8) - np.asarray(it1)))) <= 1


@pytest.mark.parametrize("wrapper", ["lasso", "multirhs", "box_qp", "tv"])
def test_sharded_wrappers_validate_batch(dp_mesh, wrapper):
    """A batch that the mesh axis does not divide raises a clear
    ValueError up front, not an opaque error inside shard_map."""
    from proxtpu import parallel as par

    bad = 12  # not a multiple of the 8-device axis
    f32 = lambda *shape: jnp.ones(shape, jnp.float32)
    calls = {
        "lasso": lambda: par.sharded_solve_lasso_batch(
            f32(bad, 4, 6), f32(bad, 4), f32(bad), f32(bad), 1e-5,
            mesh=dp_mesh, maxit=5),
        "multirhs": lambda: par.sharded_solve_lasso_multirhs(
            f32(4, 6), f32(bad, 4), 0.1, 1.0, 1e-5, mesh=dp_mesh, maxit=5),
        "box_qp": lambda: par.sharded_solve_box_qp_batch(
            f32(bad, 3, 3), f32(bad, 3), -1.0, 1.0, f32(bad), 1e-4,
            mesh=dp_mesh, maxit=5),
        "tv": lambda: par.sharded_solve_tv_batch(
            f32(bad, 4, 4), 0.1, 1e-3, mesh=dp_mesh, maxit=5),
    }
    with pytest.raises(ValueError, match="not divisible"):
        calls[wrapper]()
