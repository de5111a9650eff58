"""Bounded (fori_loop) adaptive backtracking: exact parity with the
data-dependent while_loop, single and batched.

The reference's ``backtrack_stepsize!`` is a data-dependent loop bounded by
``minimum_gamma`` (``/root/reference/src/utilities/fb_tools.jl:24-63``); the
batched build adds a fixed-trip masked formulation (``backtrack_limit=T``)
because a nested while_loop under vmap can compile pathologically slowly.  These tests
pin the two modes to identical results, and batched-adaptive solves to the
single-problem driver per lane (SURVEY.md §4's batch-consistency oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration,
    make_forward_backward_iteration,
    make_panoc_iteration,
    make_zerofpr_iteration,
)
from proxtpu.parallel import batch_problems, batched_run_loop
from proxtpu.prox import NormL1, make_least_squares

from problems import LASSO_A, LASSO_B, LASSO_XSTAR, lasso_lam

TOL = 1e-6
# gamma0 ~ 1/L with minimum_gamma=1e-7: 32 halvings cover any ratio < 4e9,
# so the bounded search is exactly equivalent to the while_loop here.
LIMIT = 32


def lasso_problem(dtype=jnp.float64, adaptive=True, **kw):
    A = jnp.asarray(LASSO_A, dtype)
    b = jnp.asarray(LASSO_B, dtype)
    return dict(
        x0=jnp.zeros(A.shape[1], dtype),
        f=make_least_squares(A, b),
        g=NormL1(lasso_lam()),
        adaptive=adaptive,
        **kw,
    )


@pytest.mark.parametrize(
    "solver_name,factory_kw",
    [
        ("ForwardBackward", {}),
        ("ForwardBackward", {"increase_gamma": 1.2}),  # regret rule backtracks often
        ("FastForwardBackward", {}),
        ("ZeroFPR", {}),
        ("PANOC", {}),
        ("PANOCplus", {}),
    ],
)
def test_bounded_backtracking_matches_while_loop(solver_name, factory_kw):
    """backtrack_limit=T must reproduce the unbounded search: same counts
    (up to the one-ULP compile-fusion boundary — bounded and unbounded are
    different XLA programs) and the same solution to ~ULP accuracy."""
    kw = lasso_problem(**factory_kw)
    solver = getattr(pa, solver_name)(tol=TOL, maxit=3000)
    x_ref, it_ref = solver(**kw)
    x_bnd, it_bnd = solver(backtrack_limit=LIMIT, **kw)
    assert abs(it_bnd - it_ref) <= 1
    np.testing.assert_allclose(
        np.asarray(x_bnd), np.asarray(x_ref), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(x_bnd), LASSO_XSTAR, rtol=0, atol=1e-4
    )


def random_lasso(k, m=8, n=12, dtype=jnp.float64):
    rng = np.random.default_rng(k)
    A = jnp.asarray(rng.standard_normal((m, n)), dtype)
    b = jnp.asarray(rng.standard_normal(m), dtype)
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    return dict(
        x0=jnp.zeros(n, dtype), f=make_least_squares(A, b), g=NormL1(lam),
        adaptive=True, backtrack_limit=LIMIT,
    )


@pytest.mark.parametrize(
    "factory,solver_name",
    [
        (make_forward_backward_iteration, "ForwardBackward"),
        (make_fast_forward_backward_iteration, "FastForwardBackward"),
        (make_panoc_iteration, "PANOC"),
        (make_zerofpr_iteration, "ZeroFPR"),
    ],
)
def test_batched_adaptive_matches_loop(factory, solver_name):
    """Adaptive (backtracking) solves batch: per-lane counts and solutions
    match the single-problem driver."""
    problems = [random_lasso(k) for k in range(5)]
    iteration = batch_problems(factory, problems)
    xs, iters, done = batched_run_loop(iteration, 3000, TOL)
    assert bool(jnp.all(done))

    solver = getattr(pa, solver_name)(tol=TOL, maxit=3000)
    for i, kw in enumerate(problems):
        x, it = solver(**kw)
        assert it == int(iters[i]), f"lane {i}: {it} != {int(iters[i])}"
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=1e-12
        )


@pytest.mark.parametrize(
    "solver_name,extra",
    [
        ("PANOC", {"Lf": None}),
        ("ZeroFPR", {"Lf": None}),
        ("PANOCplus", {"Lf": None}),
        ("DRLS", {"Lf": None}),
    ],
)
def test_bounded_tau_search_matches_while_loop(solver_name, extra):
    """backtrack_limit also lowers the tau-linesearch as a bounded masked
    loop (fixed-stepsize solvers included) — results must be bit-identical
    to the while-loop lowering."""
    import numpy as _np

    Lf = float(_np.linalg.norm(LASSO_A, 2) ** 2)
    kw = lasso_problem(adaptive=False, Lf=Lf)
    kw.pop("adaptive")
    solver = getattr(pa, solver_name)(tol=TOL, maxit=3000)
    x_ref, it_ref = solver(**kw)
    x_bnd, it_bnd = solver(backtrack_limit=LIMIT, **kw)
    # different XLA programs fuse differently (one-ULP drift), so assert
    # near-equality rather than bit equality
    assert abs(it_bnd - it_ref) <= 1
    np.testing.assert_allclose(
        np.asarray(x_bnd), np.asarray(x_ref), rtol=0, atol=1e-9
    )


@pytest.mark.parametrize(
    "factory_name,solver_name",
    [("make_panoc_iteration", "PANOC"), ("make_drls_iteration", "DRLS")],
)
def test_batched_linesearch_bounded(factory_name, solver_name):
    """Line-search solvers batch with the bounded tau-search: per-lane
    parity with the single driver (fixed stepsize)."""
    import proxtpu.algorithms as alg

    factory = getattr(alg, factory_name)
    problems = []
    for k in range(4):
        kw = random_lasso(k)
        kw.pop("adaptive")
        kw.pop("backtrack_limit")
        rng = np.random.default_rng(100 + k)
        A = kw["f"].A
        kw["Lf"] = float(np.linalg.norm(np.asarray(A), 2) ** 2)
        kw["backtrack_limit"] = LIMIT
        problems.append(kw)
    iteration = batch_problems(factory, problems)
    xs, iters, done = batched_run_loop(iteration, 3000, TOL)
    assert bool(jnp.all(done))

    solver = getattr(pa, solver_name)(tol=TOL, maxit=3000)
    for i, kw in enumerate(problems):
        x, it = solver(**kw)
        assert it == int(iters[i])
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x), rtol=0, atol=1e-12
        )


def test_resume_counter_spans_segments():
    """resume_iters continues the iteration budget across segments: a solve
    split at k=50 returns the same total count and solution as one run
    (resumed runs must not get a fresh maxit budget)."""
    from proxtpu.algorithms.core import run_loop

    kw = lasso_problem(adaptive=False, Lf=float(np.linalg.norm(LASSO_A, 2) ** 2))
    solver = pa.ForwardBackward(tol=TOL, maxit=10_000)
    x_ref, it_ref = solver(**kw)
    assert it_ref > 60

    # segment 1: run exactly 50 iterations by cranking tol to 0
    seg1 = pa.ForwardBackward(tol=0.0, maxit=50)
    iteration = seg1.make_iteration(**kw)
    state = iteration.init()
    sol1, k1 = run_loop(
        iteration, 50, 0.0, seg1.stop, lambda it, s: s, False, 100,
        seg1.display,
    )
    assert int(k1) == 50
    # segment 2: resume with the global counter
    x2, it2 = solver(resume_from=sol1, resume_iters=int(k1), **kw)
    assert it2 == it_ref
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x_ref))
