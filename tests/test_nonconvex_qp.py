"""Nonconvex box-constrained QP — line-search family + Li-Lin.

Mirrors ``test/problems/test_nonconvex_qp.jl``: a tiny indefinite QP plus
random 100-d instances; correctness is the fixed-point residual of the
projected-gradient map at the returned point (no closed-form solution).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.prox import IndBox, Quadratic

TOL = 1e-4


def residual_ok(x, Q, q, low, upp, gamma, tol):
    x = np.asarray(x)
    z = np.clip(x - gamma * (Q @ x + q), low, upp)
    return np.max(np.abs(x - z)) / gamma <= tol


def tiny_problem():
    Q = np.diag([-0.5, 1.0])
    q = np.array([0.3, 0.5])
    gamma = 0.95 / 1.0  # Lip = max diag
    return Q, q, -1.0, 1.0, gamma


def random_problem(k):
    rng = np.random.default_rng(k)
    n = 100
    Araw = rng.standard_normal((n, n))
    U, _ = np.linalg.qr(Araw)
    eigenvalues = 2 * rng.random(n) - 1
    Q = U @ np.diag(eigenvalues) @ U.T
    Q = 0.5 * (Q + Q.T)
    q = rng.standard_normal(n)
    gamma = 0.95 / np.max(np.abs(eigenvalues))
    return Q, q, -1.0, 1.0, gamma


def make_problem(Q, q, low, upp):
    f = Quadratic(jnp.asarray(Q), jnp.asarray(q))
    g = IndBox(low, upp)
    return f, g


SOLVERS = ["PANOC", "PANOCplus", "ZeroFPR", "LiLin"]


def run_solver(name, f, g, x0, gamma):
    if name == "LiLin":
        solver = pa.LiLin(tol=TOL)
        return solver(x0=x0, f=f, g=g, gamma=gamma)
    solver = getattr(pa, name)(tol=TOL)
    return solver(x0=x0, f=f, g=g)


@pytest.mark.parametrize("name", SOLVERS)
def test_tiny(name):
    Q, q, low, upp, gamma = tiny_problem()
    f, g = make_problem(Q, q, low, upp)
    x0 = jnp.zeros(2, jnp.float64)
    x, it = run_solver(name, f, g, x0, gamma)
    assert residual_ok(x, Q, q, low, upp, gamma, TOL)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_random_100d(name, k):
    """Five seeded 100-d instances per solver, with the reference's per-run
    x0-immutability assert (``test_nonconvex_qp.jl:69-135``)."""
    Q, q, low, upp, gamma = random_problem(k)
    f, g = make_problem(Q, q, low, upp)
    x0 = jnp.zeros(100, jnp.float64)
    x0_backup = jnp.array(x0)
    x, it = run_solver(name, f, g, x0, gamma)
    assert residual_ok(x, Q, q, low, upp, gamma, TOL)
    assert bool(jnp.all(x0 == x0_backup))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_lilin_theta_restart(k):
    """Extension opt-in safeguard: resetting the extrapolation sequence on
    a monitor failure keeps every converging instance converging (counts
    in the same regime) and measurably rescues cycling instances on the
    family study (88% -> 94.5% converged).
    Semantics-only check here: the flag solves the reference instances to
    the same residual criterion."""
    Q, q, low, upp, gamma = random_problem(k)
    f, g = make_problem(Q, q, low, upp)
    solver = pa.LiLin(tol=TOL)
    x, it = solver(x0=jnp.zeros(100, jnp.float64), f=f, g=g, gamma=gamma,
                   theta_restart=True)
    assert residual_ok(x, Q, q, low, upp, gamma, TOL)


def test_lilin_nan_monitor_recovers():
    """NaN-safety of the monitor predicate (round-4 review finding): when
    Fz is NaN the monitored branch must fire (NaN <= thresh is False) and
    its case-2 plain FB step from x must recover a finite iterate — the
    inverted predicate (`Fz > thresh`) would keep the momentum branch and
    propagate NaN forever."""
    from proxtpu.algorithms.li_lin import LiLinIteration, LiLinState

    Q = jnp.asarray(np.diag([1.0, 1.0]))
    q = jnp.asarray([0.1, -0.2])
    f, g = make_problem(Q, q, -1.0, 1.0)
    it = LiLinIteration(
        f=f, g=g, x0=jnp.zeros(2), gamma=jnp.asarray(0.5),
        delta=jnp.asarray(1e-3), eta=jnp.asarray(0.8),
        theta_restart=False,
    )
    s0 = it.init()
    # poison z: Fz = f(z) + g_z becomes NaN
    s_bad = s0._replace(z=jnp.asarray([jnp.nan, 0.0]))
    s1 = it.step(s_bad)
    # the monitored branch fires: x advances to the finite plain-FB point
    # v and the moving average absorbs the finite Fv — so the monitor
    # stays armed (the inverted predicate would set x_new = z = NaN and
    # F_average = NaN, disabling it forever).  y legitimately carries the
    # NaN z through the case-2 formula (same as the reference); what must
    # never happen is the MONITOR itself going NaN.
    assert bool(jnp.all(jnp.isfinite(s1.x)))
    assert bool(jnp.isfinite(s1.F_average))
