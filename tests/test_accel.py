"""Acceleration-operator unit tests.

Mirrors ``test/accel/test_lbfgs.jl`` (golden directions to 16 digits on a
fixed 10x10 quadratic, incl. structured/pytree iterates),
``test_anderson.jl`` / ``test_broyden.jl`` (10 accelerated fixed-point steps
minimize a 5-d quadratic to sqrt(eps)), and ``test_nesterov.jl`` (FISTA
O(1/k^2) bound; adaptive-vs-fixed/constant equivalence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.accel import (
    LBFGS,
    AdaptiveNesterovSequence,
    AndersonAcceleration,
    Broyden,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    SimpleNesterovSequence,
)

Q10 = np.array([
    [32.0, 13.1, -4.9, -3.0, 6.0, 2.2, 2.6, 3.4, -1.9, -7.5],
    [13.1, 18.3, -5.3, -9.5, 3.0, 2.1, 3.9, 3.0, -3.6, -4.4],
    [-4.9, -5.3, 7.7, 2.1, -0.4, -3.4, -0.8, -3.0, 5.3, 5.5],
    [-3.0, -9.5, 2.1, 20.1, 1.1, 0.8, -12.4, -2.5, 5.5, 2.1],
    [6.0, 3.0, -0.4, 1.1, 3.8, 0.6, 0.5, 0.9, -0.4, -2.0],
    [2.2, 2.1, -3.4, 0.8, 0.6, 7.8, 2.9, -1.3, -4.3, -5.1],
    [2.6, 3.9, -0.8, -12.4, 0.5, 2.9, 14.5, 1.7, -4.9, 1.2],
    [3.4, 3.0, -3.0, -2.5, 0.9, -1.3, 1.7, 6.6, -0.8, 2.7],
    [-1.9, -3.6, 5.3, 5.5, -0.4, -4.3, -4.9, -0.8, 7.9, 5.7],
    [-7.5, -4.4, 5.5, 2.1, -2.0, -5.1, 1.2, 2.7, 5.7, 16.1],
])
q10 = np.array([2.9, 0.8, 1.3, -1.1, -0.5, -0.3, 1.0, -0.3, 0.7, -2.1])

XS = [
    np.array([1.0, .01, .02, .03, .04, .05, .06, .07, .08, .09]),
    np.array([.09, 1.0, .01, .02, .03, .04, .05, .06, .07, .08]),
    np.array([.08, .09, 1.0, .01, .02, .03, .04, .05, .06, .07]),
    np.array([.07, .08, .09, 1.0, .01, .02, .03, .04, .05, .06]),
    np.array([.06, .07, .08, .09, 1.0, .01, .02, .03, .04, .05]),
]

DIRS_REF = [
    np.array([-3.476000000000000e+01, -1.367700000000000e+01, 2.961000000000000e+00,
              3.756000000000000e+00, -5.618000000000001e+00, -1.571000000000000e+00,
              -4.121000000000000e+00, -3.709000000000000e+00, 4.010000000000000e-01,
              7.639999999999999e+00]),
    np.array([-6.861170733797231e-01, -1.661270665201917e+00, 2.217225828759783e-01,
              5.615134140894827e-01, -1.922426760799171e-01, -8.961101045874649e-02,
              -3.044802963260585e-01, -1.996235459345302e-01, 1.267604425710271e-01,
              3.360845247013288e-01]),
    np.array([-1.621334774299757e-01, 2.870743130038511e-01, -5.485761164147891e-01,
              9.992734938824949e-02, -1.332550298134261e-02, 5.326252573648003e-02,
              -6.299408068289100e-02, 1.525398352758626e-02, -7.776943954825602e-02,
              -2.335884953507600e-02]),
    np.array([-2.008976150849174e-01, 2.237224648542354e-01, 4.811889625788801e-02,
              -6.855884193567087e-01, -2.729265954345345e-02, 3.651730112313705e-02,
              6.325330777317102e-02, 2.871281112230844e-02, -1.285590864125103e-01,
              -3.204963735369062e-03]),
    np.array([-2.317011191832649e-01, 2.980080835636926e-02, -1.267017945785352e-01,
              4.328230970765587e-02, -2.437461022925742e-01, 1.349716200511426e-02,
              -7.155992987801297e-04, -3.513449694839536e-03, -5.603489763638488e-02,
              5.612114259243499e-02]),
]

H5 = np.array([
    [0.63287, 0.330934, -0.156908, -0.294776, 0.10761],
    [0.330934, 0.673201, 0.0459778, 0.231011, -0.235265],
    [-0.156908, 0.0459778, 0.635812, -0.232261, -0.388775],
    [-0.294776, 0.231011, -0.232261, 0.726854, -0.0691783],
    [0.10761, -0.235265, -0.388775, -0.0691783, 0.336262],
])
l5 = np.array([1.0, 2.0, 3.0, 4.0, 5.0])

DTYPES = [jnp.float32, jnp.float64, jnp.complex64, jnp.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lbfgs_golden(dtype):
    Q = jnp.asarray(Q10, dtype)
    q = jnp.asarray(q10, dtype)
    strat = LBFGS(3)
    rtol = 1e-5 if jnp.finfo(jnp.real(jnp.zeros((), dtype))).bits == 32 else 1e-12

    H = strat.init_state(jnp.zeros(10, dtype))
    x = jnp.asarray(XS[0], dtype)
    grad = Q @ x + q
    d = -strat.apply(H, grad)
    np.testing.assert_allclose(np.asarray(d), DIRS_REF[0].astype(np.asarray(d).dtype), rtol=rtol)

    for i in range(1, 5):
        x_prev, grad_prev = x, grad
        x = jnp.asarray(XS[i], dtype)
        grad = Q @ x + q
        H = strat.update(H, x - x_prev, grad - grad_prev)
        d = strat.apply(H, -grad)
        np.testing.assert_allclose(np.asarray(d), DIRS_REF[i].astype(np.asarray(d).dtype), rtol=rtol)

    H = strat.reset(H)
    np.testing.assert_array_equal(np.asarray(strat.apply(H, x)), np.asarray(x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lbfgs_pytree(dtype):
    """Structured (pytree) iterates — the ArrayPartition test
    (``test_lbfgs.jl:135-166``)."""
    Q = jnp.asarray(Q10, dtype)
    q = jnp.asarray(q10, dtype)
    strat = LBFGS(3)
    rtol = 1e-5 if jnp.finfo(jnp.real(jnp.zeros((), dtype))).bits == 32 else 1e-12

    x = {"a": jnp.asarray(XS[0], dtype), "b": jnp.asarray(XS[0], dtype)}
    H = strat.init_state(x)
    gl = Q @ x["a"] + q
    grad = {"a": gl, "b": gl}
    d = jax.tree.map(lambda v: -v, strat.apply(H, grad))
    for part in ("a", "b"):
        np.testing.assert_allclose(np.asarray(d[part]), DIRS_REF[0].astype(np.asarray(d[part]).dtype), rtol=rtol)

    for i in range(1, 5):
        x_prev, grad_prev = x, grad
        xi = jnp.asarray(XS[i], dtype)
        gi = Q @ xi + q
        x = {"a": xi, "b": xi}
        grad = {"a": gi, "b": gi}
        H = strat.update(
            H,
            jax.tree.map(jnp.subtract, x, x_prev),
            jax.tree.map(jnp.subtract, grad, grad_prev),
        )
        d = strat.apply(H, jax.tree.map(lambda v: -v, grad))
        for part in ("a", "b"):
            np.testing.assert_allclose(np.asarray(d[part]), DIRS_REF[i].astype(np.asarray(d[part]).dtype), rtol=rtol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("make", [lambda: AndersonAcceleration(5), lambda: Broyden()],
                         ids=["anderson", "broyden"])
def test_fixed_point_acceleration(dtype, make):
    """10 accelerated gradient steps minimize the 5-d quadratic to sqrt(eps)
    (``test_anderson.jl:34-48``, ``test_broyden.jl:33-47``)."""
    H5j = jnp.asarray(H5, dtype)
    l5j = jnp.asarray(l5, dtype)
    f = lambda x: jnp.dot(x, H5j @ x) / 2 + jnp.dot(x, l5j)
    grad = lambda x: H5j @ x + l5j
    x_star = jnp.linalg.solve(H5j, -l5j)
    f_star = f(x_star)

    acc = make()
    x = jnp.zeros(5, dtype)
    st = acc.init_state(x)
    g = grad(x)
    for _ in range(10):
        d = acc.apply(st, g)
        x = x - d
        g_prev = g
        g = grad(x)
        st = acc.update(st, -d, g - g_prev)

    eps = float(jnp.finfo(dtype).eps)
    assert float(f(x)) <= float(f_star) + (1 + abs(float(f_star))) * np.sqrt(eps)

    st = acc.reset(st)
    np.testing.assert_array_equal(np.asarray(acc.apply(st, x)), np.asarray(x))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("seq_cls", [SimpleNesterovSequence, FixedNesterovSequence])
def test_nesterov_fista_bound(dtype, seq_cls):
    """Iterates satisfy the Beck-Teboulle Thm 4.4 O(1/k^2) bound
    (``test_nesterov.jl:57``)."""
    H5j = jnp.asarray(H5, dtype)
    l5j = jnp.asarray(l5, dtype)
    f = lambda x: float(jnp.dot(x, H5j @ x) / 2 + jnp.dot(x, l5j))
    grad = lambda x: H5j @ x + l5j
    x_star = jnp.linalg.solve(H5j, -l5j)
    f_star = f(x_star)
    Lip = float(jnp.linalg.norm(H5j, 2))
    gamma = 1 / Lip
    x = jnp.zeros(5, dtype)
    y = x
    err0 = float(jnp.linalg.norm(x_star - x)) ** 2

    seq = seq_cls()
    st = seq.init_state(x)
    for it in range(1, 101):
        coeff, st = seq.next_coeff(st)
        if it == 1:
            assert float(coeff) == 0.0
        x_prev = x
        x = y - gamma * grad(y)
        y = x + coeff * (x - x_prev)
        assert f(x) - f_star <= 2 / (gamma * (it + 1) ** 2) * err0 + 1e-5


def test_adaptive_matches_fixed():
    """AdaptiveNesterovSequence(0) with constant stepsize reproduces the fixed
    sequence; m>0 reproduces the constant sequence (``test_nesterov.jl:63-81``)."""
    gamma = jnp.asarray(1.7)
    x = jnp.zeros(5)
    ada = AdaptiveNesterovSequence(0.0)
    fixed = FixedNesterovSequence()
    sa, sf = ada.init_state(x), fixed.init_state(x)
    for _ in range(20):
        ba, sa = ada.next_coeff(sa, gamma)
        bf, sf = fixed.next_coeff(sf)
        np.testing.assert_allclose(float(ba), float(bf), rtol=1e-12)

    m = 1.0
    ada = AdaptiveNesterovSequence(m)
    sa = ada.init_state(x)
    expected = (1 - np.sqrt(m * 1.7)) / (1 + np.sqrt(m * 1.7))
    for _ in range(20):
        ba, sa = ada.next_coeff(sa, gamma)
        np.testing.assert_allclose(float(ba), expected, rtol=1e-12)


# ---------------------------------------------------------------------------
# AdaptiveRestartSequence (O'Donoghue & Candes; extension, no reference
# counterpart — the reference pins textbook sequences)
# ---------------------------------------------------------------------------


def _small_lasso(dtype=jnp.float64):
    A = jnp.array([[1., -2., 3., -4., 5.], [2., -1., 0., -1., 3.],
                   [-1., 0., 4., -3., 2.], [-1., -1., -1., 1., 3.]], dtype)
    b = jnp.array([1., 2., 3., 4.], dtype)
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    xstar = jnp.array([-3.877278911564627e-01, 0, 0, 2.174149659863943e-02,
                       6.168435374149660e-01], dtype)
    return A, b, lam, Lf, xstar


def test_adaptive_restart_fewer_iterations_same_optimum():
    import proxtpu as pa
    from proxtpu.prox import NormL1, make_least_squares

    A, b, lam, Lf, xstar = _small_lasso()
    kw = dict(x0=jnp.zeros(5, A.dtype), f=make_least_squares(A, b),
              g=NormL1(lam), Lf=Lf)
    x_p, it_p = pa.FastForwardBackward(tol=1e-6)(**kw)
    x_r, it_r = pa.FastForwardBackward(
        tol=1e-6,
        extrapolation_sequence=pa.AdaptiveRestartSequence(
            pa.FixedNesterovSequence()),
    )(**kw)
    assert float(jnp.max(jnp.abs(x_r - xstar))) <= 1e-5
    assert int(it_r) < int(it_p)  # 59 vs 142 at this problem


def test_adaptive_restart_wraps_any_sequence_and_restarts_state():
    import proxtpu as pa

    seq = pa.AdaptiveRestartSequence(pa.SimpleNesterovSequence())
    st = seq.init_state(jnp.zeros(3))
    beta1, st = seq.next_coeff(st, None, restart=jnp.asarray(-1.0))
    # k advanced: next beta without restart is nonzero
    beta2, st = seq.next_coeff(st, None, restart=jnp.asarray(-1.0))
    assert float(beta2) > 0
    # positive signal resets to the initial state -> beta back to k=1 value
    beta3, st = seq.next_coeff(st, None, restart=jnp.asarray(1.0))
    np.testing.assert_allclose(float(beta3), float(beta1))


def test_adaptive_restart_batched_per_lane():
    """Under the batched driver each lane restarts independently: per-lane
    counts match the corresponding single solves exactly."""
    import proxtpu as pa
    from proxtpu.parallel import batch_problems, batched_run_loop
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.prox import NormL1, make_least_squares

    rng = np.random.default_rng(0)
    problems, singles = [], []
    seq = pa.AdaptiveRestartSequence(pa.FixedNesterovSequence())
    for i in range(4):
        A = jnp.asarray((rng.standard_normal((12, 20)) / np.sqrt(12))
                        .astype(np.float32))
        b = jnp.asarray(rng.standard_normal(12).astype(np.float32))
        lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
        Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
        kw = dict(x0=jnp.zeros(20, jnp.float32),
                  f=make_least_squares(A, b), g=NormL1(lam), Lf=Lf,
                  extrapolation_sequence=seq)
        problems.append(kw)
        singles.append(
            pa.FastForwardBackward(tol=1e-5, maxit=3000,
                                   extrapolation_sequence=seq)(
                **{k: v for k, v in kw.items()
                   if k != "extrapolation_sequence"})
        )
    iteration = batch_problems(make_fast_forward_backward_iteration,
                               problems)
    sols, iters, done = batched_run_loop(iteration, 3000, 1e-5)
    assert bool(jnp.all(done))
    for i, (x_i, it_i) in enumerate(singles):
        assert int(iters[i]) == int(it_i), i
        np.testing.assert_allclose(np.asarray(sols[i]), np.asarray(x_i),
                                   atol=1e-6)
