"""Scenario batching: batched solve must equal a loop of single solves.

The consistency oracle SURVEY.md §4 prescribes for the batched build: per-lane
solutions and iteration counts from ``batched_run_loop`` match the
single-problem driver exactly (converged lanes freeze).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration,
    make_forward_backward_iteration,
    make_panoc_iteration,
)
from proxtpu.parallel import (
    batch_problems,
    batched_run_loop,
    compacting_batched_run,
)
from proxtpu.prox import NormL1, make_least_squares

TOL = 1e-6


def random_lasso(k, m=8, n=12, dtype=jnp.float64):
    rng = np.random.default_rng(k)
    A = jnp.asarray(rng.standard_normal((m, n)), dtype)
    b = jnp.asarray(rng.standard_normal(m), dtype)
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    return dict(
        x0=jnp.zeros(n, dtype), f=make_least_squares(A, b), g=NormL1(lam),
        Lf=Lf,
    )


@pytest.mark.parametrize(
    "factory,solver_name",
    [
        (make_forward_backward_iteration, "ForwardBackward"),
        (make_fast_forward_backward_iteration, "FastForwardBackward"),
        (make_panoc_iteration, "PANOC"),
    ],
)
def test_batched_matches_loop(factory, solver_name):
    problems = [random_lasso(k) for k in range(6)]
    iteration = batch_problems(factory, problems)
    xs, iters, done = batched_run_loop(iteration, 2000, TOL)
    assert bool(jnp.all(done))

    solver = getattr(pa, solver_name)(tol=TOL, maxit=2000)
    for i, kw in enumerate(problems):
        x, it = solver(**kw)
        assert it == int(iters[i])
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=1e-12
        )


def test_batched_per_lane_counts_differ():
    # different conditioning -> different convergence speed per lane
    problems = [random_lasso(k, m=6 + k, n=10) for k in range(4)]
    # pad to equal shapes not possible here: use same shapes, different data
    problems = [random_lasso(k) for k in range(4)]
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    xs, iters, done = batched_run_loop(iteration, 2000, TOL)
    assert len(set(int(i) for i in iters)) > 1


def test_batched_maxit_cap():
    problems = [random_lasso(k) for k in range(3)]
    iteration = batch_problems(make_forward_backward_iteration, problems)
    xs, iters, done = batched_run_loop(iteration, 5, TOL)
    assert not bool(jnp.any(done))
    assert all(int(i) == 5 for i in iters)


def test_check_every_blocking():
    """check_every=K is EXACT on the generic driver (round 4): every inner
    step is masked on the per-lane done flags, so counts, solutions and
    done flags are bit-identical to K=1 on CPU."""
    problems = [random_lasso(k) for k in range(6)]
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    xs1, i1, d1 = batched_run_loop(iteration, 3000, TOL)
    for K in (4, 8):
        xsk, ik, dk = batched_run_loop(iteration, 3000, TOL, check_every=K)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(ik))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(dk))
        np.testing.assert_array_equal(np.asarray(xs1), np.asarray(xsk))


def test_check_every_exact_at_maxit_cap():
    """A K-block straddling maxit must not step or count past it: capped
    lanes report iters == maxit and the same iterate as K=1."""
    problems = [random_lasso(k) for k in range(4)]
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    # maxit=10 caps every lane; 10 is not a multiple of K=4
    xs1, i1, d1 = batched_run_loop(iteration, 10, TOL)
    xs4, i4, d4 = batched_run_loop(iteration, 10, TOL, check_every=4)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i4))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d4))
    np.testing.assert_array_equal(np.asarray(xs1), np.asarray(xs4))


@pytest.mark.parametrize("maxit,chunk", [(2000, 100), (50, 20)])
def test_compacting_run_matches_plain(maxit, chunk):
    """Lane compaction is an optimization only: per-lane solutions, iteration
    counts and done flags must match batched_run_loop exactly, including the
    maxit-capped case."""
    problems = [random_lasso(k) for k in range(12)]
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    xs1, i1, d1 = batched_run_loop(iteration, maxit, TOL)
    xs2, i2, d2 = compacting_batched_run(
        iteration, maxit, TOL, chunk=chunk, min_batch=4
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_allclose(np.asarray(xs1), np.asarray(xs2), atol=0)


def test_batched_algorithm_check_every():
    """check_every=K on BatchedAlgorithm threads into the generic driver's
    exact masked K-block: identical counts and solutions to K=1."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel.batch import BatchedAlgorithm
    from proxtpu.prox import LeastSquaresLoss, NormL1

    rng = np.random.default_rng(6)
    Bn, M_, N_ = 4, 14, 22
    A = jnp.asarray((rng.standard_normal((Bn, M_, N_)) / np.sqrt(M_))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((Bn, M_)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = jnp.asarray([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                      for i in range(Bn)], jnp.float32)
    kw = dict(x0=jnp.zeros((Bn, N_), jnp.float32),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)
    # use_kernels=False forces the generic driver, where check_every lives
    one = BatchedAlgorithm(make_fast_forward_backward_iteration,
                           maxit=4000, tol=1e-5, use_kernels=False)
    blk = BatchedAlgorithm(make_fast_forward_backward_iteration,
                           maxit=4000, tol=1e-5, use_kernels=False,
                           check_every=8)
    xs1, it1, d1 = one(**kw)
    xs8, it8, d8 = blk(**kw)
    assert bool(jnp.all(d1)) and bool(jnp.all(d8))
    # round 4: the masked K-block is exact — counts and solutions match
    # the per-step driver bit-for-bit on CPU
    np.testing.assert_array_equal(np.asarray(it1), np.asarray(it8))
    np.testing.assert_array_equal(np.asarray(xs1), np.asarray(xs8))


def test_auto_shared_only_with_x0_batch_inference():
    """broadcast_hyperparams auto-wraps unstacked leaves in Shared only
    when the batch size came from x0; with no x0 field the fallback
    first-leaf inference must NOT auto-share (it cannot distinguish an
    unstacked operand from the batch axis)."""
    from proxtpu.parallel.batch import broadcast_hyperparams
    from proxtpu.utils.shared import Shared

    class Bag:
        pass

    import jax

    jax.tree_util.register_pytree_node(
        Bag,
        lambda bg: ((bg.a, bg.b), None),
        lambda aux, ch: (lambda bg: (setattr(bg, "a", ch[0]),
                                     setattr(bg, "b", ch[1]), bg)[2])(Bag()),
    )
    bg = Bag()
    bg.a = jnp.zeros((4, 3))   # first leaf -> B inferred as 4
    bg.b = jnp.zeros((7, 3))   # mismatched leading dim
    out = broadcast_hyperparams(bg)
    # no x0 => no auto-Share: the mismatched leaf passes through unwrapped
    assert not isinstance(out.b, Shared)


def test_broadcast_hyperparams_tuple_x0():
    """B must come from x0's ARRAY LEAVES, not the container: a tuple
    iterate (Davis-Yin / robust-PCA product space) must not misread B as
    the tuple length (regression: jnp.shape on a tuple)."""
    from proxtpu.algorithms.davis_yin import make_davis_yin_iteration
    from proxtpu.parallel.batch import broadcast_hyperparams
    from proxtpu.prox import NormL1, SqrNormL2, Zero
    from proxtpu.utils.shared import Shared

    Bn = 5
    it = jax.vmap(
        lambda x: make_davis_yin_iteration(
            x0=(x, x), f=SqrNormL2(1.0), g=NormL1(0.1), h=Zero(), gamma=0.5,
        )
    )(jnp.zeros((Bn, 7)))
    out = broadcast_hyperparams(it)
    # rank-0 hyperparameters gained EXACTLY the (Bn,) batch axis
    assert out.gamma.shape == (Bn,)
    # x0's own leaves stayed unwrapped and batched
    assert not isinstance(out.x0[0], Shared)
    assert out.x0[0].shape == (Bn, 7)


def test_batched_new_prox_matches_loop():
    """The widened prox catalogue batches out of the box: per-lane
    NormL1plusL2 (lam1 sweep) and NormLinf problems through
    batched_run_loop match the single-problem driver exactly."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.prox import NormL1plusL2, NormLinf

    rng = np.random.default_rng(3)
    m, n = 8, 12
    A = jnp.asarray(rng.standard_normal((m, n)))
    b = jnp.asarray(rng.standard_normal(m))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    for gmk in (
        lambda i: NormL1plusL2(0.02 + 0.03 * i, 0.05),
        lambda i: NormLinf(0.1 + 0.2 * i),
    ):
        problems = [
            dict(x0=jnp.zeros(n), f=make_least_squares(A, b), g=gmk(i),
                 Lf=Lf)
            for i in range(5)
        ]
        iteration = batch_problems(
            make_fast_forward_backward_iteration, problems
        )
        xs, iters, done = batched_run_loop(iteration, 3000, TOL)
        assert bool(jnp.all(done))
        solver = pa.FastForwardBackward(tol=TOL, maxit=3000)
        for i, kw in enumerate(problems):
            x, it = solver(**kw)
            assert it == int(iters[i]), type(kw["g"]).__name__
            np.testing.assert_allclose(
                np.asarray(xs[i]), np.asarray(x), rtol=0, atol=1e-12
            )


def test_halt_nonfinite_dead_lane():
    """Divergence detection (round 4, SURVEY §5 failure detection): one
    lane given a catastrophically wrong Lf diverges to non-finite; with
    halt_nonfinite=True the batch exits as soon as every lane is done OR
    dead (instead of burning maxit), the healthy lanes' solutions and
    counts are EXACTLY those of the clean run, and the dead lane reports
    done=False."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import LeastSquaresLoss, NormL1

    rng = np.random.default_rng(21)
    Bn, M_, N_ = 6, 20, 30
    A = jnp.asarray((rng.standard_normal((Bn, M_, N_)) / np.sqrt(M_))
                    .astype(np.float32))
    b = jnp.asarray(rng.standard_normal((Bn, M_)).astype(np.float32))
    lam = jnp.asarray(0.1 * np.max(np.abs(np.einsum(
        "bmn,bm->bn", np.asarray(A), np.asarray(b))), axis=1), jnp.float32)
    Lf = np.array([np.linalg.norm(np.asarray(A[i]), 2) ** 2
                   for i in range(Bn)], np.float32)
    Lf_bad = Lf.copy()
    Lf_bad[2] = Lf[2] / 1e3  # gamma 1000x too big -> divergence

    maxit = 5000
    kw = dict(x0=jnp.zeros((Bn, N_), jnp.float32),
              f=LeastSquaresLoss(A, b), g=NormL1(lam))
    solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                              maxit=maxit, tol=1e-5, use_kernels=False,
                              halt_nonfinite=True)
    xs, it, done = solver(**kw, Lf=jnp.asarray(Lf_bad))
    done = np.asarray(done)
    assert not done[2]                     # the poisoned lane is dead
    assert done[[0, 1, 3, 4, 5]].all()     # the rest converged
    assert int(np.asarray(it)[2]) < maxit  # it died early, not at maxit
    # the dead lane froze at its LAST FINITE iterate
    assert bool(jnp.all(jnp.isfinite(xs[2])))
    # healthy lanes: exact parity with the clean run
    clean = BatchedAlgorithm(make_fast_forward_backward_iteration,
                             maxit=maxit, tol=1e-5, use_kernels=False)
    xs_c, it_c, d_c = clean(**kw, Lf=jnp.asarray(Lf))
    for i in (0, 1, 3, 4, 5):
        assert int(np.asarray(it)[i]) == int(np.asarray(it_c)[i])
        np.testing.assert_array_equal(np.asarray(xs[i]), np.asarray(xs_c[i]))

    # WITHOUT the flag the same batch burns to maxit (done=False lane
    # never exits the all-done condition)
    plain = BatchedAlgorithm(make_fast_forward_backward_iteration,
                             maxit=maxit, tol=1e-5, use_kernels=False)
    _, it_p, d_p = plain(**kw, Lf=jnp.asarray(Lf_bad))
    assert not bool(np.asarray(d_p)[2])
    assert int(np.asarray(it_p)[2]) == maxit


def test_lane_finite_no_inexact_leaves():
    """A state pytree with no floating/complex leaves is
    vacuously finite — _lane_finite must return a broadcastable True, not
    None (which made ``~_lane_finite(s)`` a trace-time TypeError under
    halt_nonfinite=True)."""
    from proxtpu.parallel.batch import _lane_finite

    ok = _lane_finite({"k": jnp.zeros((4,), jnp.int32),
                       "flag": jnp.ones((4,), bool)})
    assert bool(ok)                       # scalar True
    dead = jnp.zeros((4,), bool) | ~ok    # broadcasts against (B,) masks
    assert not bool(jnp.any(dead))
    # mixed pytree still reduces per lane
    ok2 = _lane_finite({"k": jnp.zeros((3,), jnp.int32),
                        "x": jnp.asarray([1.0, jnp.nan, 2.0])})
    np.testing.assert_array_equal(np.asarray(ok2), [True, False, True])
