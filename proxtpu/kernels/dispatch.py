"""Automatic specialized-solver dispatch for batched solves.

The generic vmapped driver (:func:`proxtpu.parallel.batch.batched_run_loop`)
runs *any* algorithm on *any* problem, but a few workloads have specialized
batched solvers: batched lasso-FISTA (:mod:`proxtpu.kernels.lasso`, whose
distinct-A step is the fused GPU kernel that reads each operator once per
iteration), the shared-A lasso path, batched box-QP projected gradient
(:mod:`proxtpu.kernels.box_qp`) and batched TV denoising
(:mod:`proxtpu.kernels.tv`).

:func:`match_kernel_solver` recognizes those problem shapes structurally
(factory + function classes + default options) and returns a ready-to-run
closure, or ``None`` when the problem does not match exactly — the caller
then falls back to the generic driver.  Matching is deliberately
conservative: any nonstandard option (adaptive steps, custom stopping/
solution, or a custom extrapolation sequence other than
``AdaptiveRestartSequence`` around the default t-recursion) disables the
fast path.  A concrete ``x0`` of any value rides the solvers as a warm
start (f64-exact trajectory parity with the generic driver).

Semantics of the fast path vs the generic driver (pinned by
``tests/test_kernels.py`` / ``tests/test_dispatch.py``): identical fixed
points and stopping rule; per-lane iteration counts match up to the f32
last-bit boundary (±1), and up to ``iter_block-1`` *sampling* slack on the
iteration-blocked TV solver (counts are then an upper bound — lanes are
never reported converged before they are).

Reference semantics anchor: the driver contract of
``/root/reference/src/ProximalAlgorithms.jl:114-123`` (the dispatch changes
how a solve runs, never what it returns).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _concrete_all_zero(x):
    try:
        return not bool(np.any(np.asarray(x)))
    except Exception:
        return False


def _scalar_or_vec(v, B, dtype):
    """Broadcast a scalar / (B,) parameter to a (B,) array, or None."""
    arr = jnp.asarray(v)
    if arr.ndim == 0:
        return jnp.full((B,), arr, dtype)
    if arr.shape == (B,):
        return arr.astype(dtype)
    return None


def match_flat_adaptive(factory, kwargs, *, tol, maxit, stop=None,
                        solution=None, check_every=1):
    """Route batched *adaptive* FB/FISTA to the flattened trial/commit
    machine (:mod:`proxtpu.parallel.adaptive_batch`) — one oracle
    evaluation per loop trip instead of T masked trials per iteration,
    with exact per-lane parity with the single-problem driver on CPU.
    ``check_every`` (BatchedAlgorithm defaults this route to 8) blocks K
    trips per while trip — exact semantics, but a recompiled blocked body
    can flip knife-edge accepts (counts drift +-1; see
    flat_ls._blocked_while).  Returns a runner or ``None``."""
    if stop is not None or solution is not None:
        return None
    name = getattr(factory, "__name__", "")
    accel = name == "make_fast_forward_backward_iteration"
    if not accel and name != "make_forward_backward_iteration":
        return None
    gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
    adaptive = kwargs.get("adaptive")
    if adaptive is None:
        adaptive = gamma is None and Lf is None
    if not adaptive:
        return None
    if "backtrack_limit" in kwargs:
        # user-truncated gamma search: only the generic driver honors it
        return None
    if kwargs.get("extrapolation_sequence") is not None:
        return None
    x0 = kwargs.get("x0")
    f, g = kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        return None
    B = x0.shape[0]
    # every array leaf of the stacked f/g must carry the batch axis
    # (leaves under a Shared marker are lane-invariant and exempt)
    from ..utils.shared import lane_arrays

    for leaf in lane_arrays((f, g)):
        shp = jnp.shape(leaf)
        if len(shp) == 0 or shp[0] != B:
            return None

    # real dtype for the stepsize state (complex iterates keep real
    # gammas, like match_flat_linesearch), and _scalar_or_vec-style
    # validation so a mis-shaped gamma/Lf falls back to the generic
    # driver instead of raising a broadcast error here (r5 review)
    R = np.dtype(x0.dtype).type(0).real.dtype
    gamma0 = None
    if gamma is not None:
        gamma0 = _scalar_or_vec(gamma, B, R)
        if gamma0 is None:
            return None
    elif Lf is not None:
        Lfv = _scalar_or_vec(Lf, B, R)
        if Lfv is None:
            return None
        gamma0 = 1.0 / Lfv

    from ..parallel.adaptive_batch import (
        batched_adaptive_fb,
        batched_adaptive_fista,
    )

    run_fn = batched_adaptive_fista if accel else batched_adaptive_fb
    opts = dict(
        maxit=maxit, gamma0=gamma0,
        minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)),
        reduce_gamma=float(kwargs.get("reduce_gamma", 0.5)),
        increase_gamma=float(kwargs.get("increase_gamma", 1.0)),
        check_every=int(check_every),
    )
    if accel:
        # array-valued mf (per-lane strong convexity) has no flat route;
        # fall back instead of tripping over array truthiness (r5 review)
        mf_val = kwargs.get("mf", 0.0)
        if mf_val is not None and np.ndim(mf_val) != 0:
            return None
        opts["mf"] = float(mf_val or 0.0)

    return lambda: run_fn(f, g, x0, tol, **opts)


def match_flat_linesearch(factory, kwargs, *, tol, maxit, stop=None,
                          solution=None, check_every=None):
    """Route batched *fixed-stepsize* tau-linesearch solvers to the
    flattened trial/commit machines (:mod:`proxtpu.parallel.flat_ls`) —
    one oracle evaluation per loop trip instead of ``max_backtracks``
    masked trials per iteration, with exact per-lane iteration-count
    parity with the single-problem driver.  Returns a runner or ``None``."""
    if stop is not None or solution is not None:
        return None
    name = getattr(factory, "__name__", "")
    _FLAT_LS = {
        "make_panoc_iteration": "batched_panoc",
        "make_zerofpr_iteration": "batched_zerofpr",
        "make_drls_iteration": "batched_drls",
        "make_panocplus_iteration": "batched_panocplus",
    }
    if name not in _FLAT_LS:
        return None
    gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
    if name == "make_drls_iteration":
        return _match_flat_drls(kwargs, tol=tol, maxit=maxit,
                                check_every=check_every or 1)
    panocplus = name == "make_panocplus_iteration"
    adaptive = kwargs.get("adaptive")
    if adaptive is None:
        # factory semantics: gamma derives from Lf first, then
        # adaptive defaults to (gamma is None)
        adaptive = gamma is None and Lf is None
    adaptive = bool(adaptive)
    # every family handles adaptive now: PANOCplus interleaves the gamma
    # search in the lanes; PANOC and ZeroFPR have two-mode flat machines
    # (_flat_panoc_adaptive_run / _flat_zerofpr_adaptive_run)
    panoc_like = name in ("make_panoc_iteration", "make_zerofpr_iteration")
    if not panocplus and not adaptive and gamma is None and Lf is None:
        # explicit adaptive=False with no stepsize: the driver runs FIXED
        # gamma at the init-time Lipschitz estimate — only the generic
        # driver reproduces that
        return None
    if adaptive and "backtrack_limit" in kwargs:
        # a user-truncated gamma search commits possibly-unaccepted steps;
        # the flat machines always search to acceptance / minimum_gamma —
        # only the generic driver honors the truncation
        return None
    x0 = kwargs.get("x0")
    f, g = kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        return None
    B = x0.shape[0]
    from ..utils.shared import Shared, lane_arrays

    for leaf in lane_arrays((f, g)):
        shp = jnp.shape(leaf)
        if len(shp) == 0 or shp[0] != B:
            return None

    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON
    from ..accel.lbfgs import LBFGS

    directions = kwargs.get("directions")
    if directions is None:
        directions = LBFGS(5)
    if getattr(directions, "style", None) not in (
        QUASI_NEWTON, NO_ACCELERATION,
    ):
        return None

    # the linear operator: None -> identity; (B, m, n) array or a
    # MatrixOperator holding one -> stacked matvec; a Shared operator /
    # (m, n) array -> lane-invariant matvec (one matmul per trip);
    # anything else is out
    from ..ops.linops import IdentityOperator, MatrixOperator, as_linop

    A = kwargs.get("A")
    if A is None:
        Aop = IdentityOperator()
    elif isinstance(A, Shared):
        inner = as_linop(A).value  # Shared(as_linop(...)) unwrapped
        if not hasattr(inner, "matvec"):
            return None
        Aop = Shared(inner)
    else:
        arr = A.A if isinstance(A, MatrixOperator) else A
        try:
            arr = jnp.asarray(arr)
        except Exception:
            return None
        if arr.ndim == 2:
            # a 2-D matrix is unambiguously lane-invariant (per-lane A is
            # always 2-D here) — same convention as the multirhs solver
            Aop = Shared(MatrixOperator(arr))
        elif arr.ndim == 3 and arr.shape[0] == B:
            Aop = MatrixOperator(arr)
        else:
            return None

    alpha = float(kwargs.get("alpha", 0.95))
    beta = float(kwargs.get("beta", 0.5))
    # same derivation as the factory (gamma = alpha / Lf), per lane, in the
    # real dtype underlying x0 (factory's rscalar(gamma, R))
    R = jnp.zeros((), x0.dtype).real.dtype
    if gamma is not None:
        gamma_v = jnp.broadcast_to(jnp.asarray(gamma, R), (B,))
    elif Lf is not None:
        gamma_v = alpha / jnp.broadcast_to(jnp.asarray(Lf, R), (B,))
    else:
        gamma_v = None  # PANOCplus only: estimated in-graph per lane

    from .. import parallel as _par

    runner = getattr(_par, _FLAT_LS[name])
    max_backtracks = int(kwargs.get("max_backtracks", 20))
    extra = {}
    if panocplus:
        extra = dict(
            adaptive=bool(adaptive) or gamma_v is None,
            minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)),
        )
    elif panoc_like and adaptive:
        extra = dict(
            adaptive=True,
            minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)),
        )
        if gamma_v is None:
            # driver cold start: per-lane Lipschitz lower bound in-graph
            extra["estimate_gamma"] = True
            gamma_v = jnp.ones((B,), R)

    if check_every is None:
        # blocking is exact on the flat machines; the adaptive PANOC
        # machine's gamma trips are cheap, so it blocks K=8 trips
        check_every = 8 if (
            name == "make_panoc_iteration" and extra.get("adaptive")
        ) else 1
    return lambda: runner(
        f, Aop, g, x0, gamma_v, tol, maxit=maxit, alpha=alpha, beta=beta,
        max_backtracks=max_backtracks, directions=directions,
        check_every=int(check_every), **extra,
    )


def _match_flat_drls(kwargs, *, tol, maxit, check_every=1):
    """DRLS leg of :func:`match_flat_linesearch` (no linear operator; f has
    accessible prox; gamma/c derived per lane exactly like the factory,
    ``drls.jl:11-22``)."""
    x0, f, g = kwargs.get("x0"), kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        return None
    B = x0.shape[0]
    from ..utils.shared import lane_arrays

    for leaf in lane_arrays((f, g)):
        shp = jnp.shape(leaf)
        if len(shp) == 0 or shp[0] != B:
            return None

    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON
    from ..accel.lbfgs import LBFGS

    directions = kwargs.get("directions")
    if directions is None:
        directions = LBFGS(5)
    if getattr(directions, "style", None) not in (
        QUASI_NEWTON, NO_ACCELERATION,
    ):
        return None

    mf = kwargs.get("mf")
    if mf is not None and jnp.ndim(mf) != 0:
        return None  # per-lane strong-convexity constants: generic driver
    gamma, Lf, c = kwargs.get("gamma"), kwargs.get("Lf"), kwargs.get("c")
    if gamma is None and Lf is None and (mf is None or mf <= 0):
        return None
    alpha = float(kwargs.get("alpha", 0.95))
    beta = float(kwargs.get("beta", 0.5))
    lam = kwargs.get("lambda_")
    if lam is None:
        lam = kwargs.get("lam", 1.0)

    R = jnp.zeros((), x0.dtype).real.dtype
    lam_v = jnp.broadcast_to(jnp.asarray(lam, R), (B,))
    # per-lane stepsizes through the SAME helpers the factory uses
    # (drls_default_gamma / drls_C are array-safe), so the fast path can
    # never drift from the driver's formulas (``drls.jl:11-22``)
    from ..algorithms.drls import drls_C, drls_default_gamma

    needs_lf = Lf is None and (mf is None or mf <= 0)
    Lf_v = (
        None if Lf is None
        else jnp.broadcast_to(jnp.asarray(Lf, R), (B,))
    )
    if gamma is None:
        if needs_lf:
            return None  # factory would fail deriving gamma without Lf
        gamma_v = jnp.broadcast_to(
            jnp.asarray(drls_default_gamma(f, mf, Lf_v, alpha, lam_v), R),
            (B,),
        )
    else:
        gamma_v = jnp.broadcast_to(jnp.asarray(gamma, R), (B,))
    if c is None:
        if needs_lf:
            return None  # factory would fail deriving c without Lf
        c_v = beta * drls_C(f, mf, Lf_v, gamma_v, lam_v)
    else:
        c_v = jnp.broadcast_to(jnp.asarray(c, R), (B,))
    dre_sign = 1 if (mf is None or mf <= 0) else -1
    max_backtracks = int(kwargs.get("max_backtracks", 20))

    from .. import parallel as _par

    return lambda: _par.batched_drls(
        f, g, x0, gamma_v, lam_v, c_v, tol, maxit=maxit,
        max_backtracks=max_backtracks, directions=directions,
        dre_sign=dre_sign, check_every=int(check_every),
    )


def match_tv_solver(factory, kwargs, *, tol, maxit, stop=None,
                    solution=None, iter_block=8):
    """Route batched TV denoising via Chambolle-Pock to the iteration-blocked
    batched solver (:func:`proxtpu.kernels.tv.solve_tv_batch`), or ``None``.

    Recognized shape: ``make_chambolle_pock_iteration`` (or plain AFBA /
    Vu-Condat with ``theta=2``, ``f``/``l`` at their CP defaults — the
    degenerate case of ``/root/reference/src/algorithms/primal_dual.jl:157-158``)
    with ``g = SqrDistance(b)`` over stacked (B, H, W) images,
    ``h = NormL21(lam, axis=0)``, ``L = Grad2DOperator((H, W))``, zero
    ``x0``/``y0``, relaxation ``lam = 1`` and default or explicitly-uniform
    stepsizes.  Matching is conservative — anything else falls back to the
    generic vmapped driver.

    The fast path returns the same ``(xbar, ybar)`` solution structure and
    stopping rule as the generic driver; per-lane iteration counts are an
    upper bound with up to ``iter_block - 1`` sampling slack (see module
    docstring).
    """
    if stop is not None or solution is not None:
        return None
    name = getattr(factory, "__name__", "")
    is_cp = name == "make_chambolle_pock_iteration"
    if not is_cp:
        if name not in ("make_afba_iteration", "make_vu_condat_iteration"):
            return None
        # plain AFBA must reduce to the CP configuration
        from ..prox.base import IndZero, Zero

        theta = kwargs.get("theta", 1.0)
        if name == "make_afba_iteration":
            try:
                if float(theta) != 2.0:
                    return None
            except (TypeError, ValueError):
                return None
        f, l = kwargs.get("f"), kwargs.get("l")
        if f is not None and not isinstance(f, Zero):
            return None
        if l is not None and not isinstance(l, IndZero):
            return None
    for k in ("beta_f", "beta_l"):
        v = kwargs.get(k)
        if v is not None and float(v) != 0.0:
            return None
    relax = kwargs.get("lam", 1.0)
    try:
        if float(relax) != 1.0:
            return None
    except (TypeError, ValueError):
        return None

    from ..ops.linops import Grad2DOperator
    from ..prox.functions import NormL21, SqrDistance

    g, h, L = kwargs.get("g"), kwargs.get("h"), kwargs.get("L")
    if not isinstance(g, SqrDistance) or not isinstance(h, NormL21):
        return None
    if not isinstance(L, Grad2DOperator):
        return None
    if int(getattr(h, "axis", 0)) != 0:
        return None
    b = jnp.asarray(g.b)
    if b.ndim != 3:
        return None
    B, H, W = b.shape
    if tuple(L.shape) != (H, W):
        return None
    x0, y0 = kwargs.get("x0"), kwargs.get("y0")
    if x0 is None or y0 is None:
        return None
    if jnp.shape(x0) != (B, H, W) or jnp.shape(y0) != (B, 2, H, W):
        return None
    if not (_concrete_all_zero(x0) and _concrete_all_zero(y0)):
        return None

    lam = h.lam
    if jnp.ndim(lam) not in (0, 1):
        return None
    if jnp.ndim(lam) == 1 and jnp.shape(lam) != (B,):
        return None

    gamma = kwargs.get("gamma")
    gamma1 = kwargs.get("gamma1")
    gamma2 = kwargs.get("gamma2")
    if gamma is not None:
        try:
            gamma1, gamma2 = gamma
        except (TypeError, ValueError):
            return None
    for gv in (gamma1, gamma2):
        if gv is not None and jnp.shape(gv) not in ((), (B,)):
            return None

    from .tv import solve_tv_batch

    return lambda: solve_tv_batch(
        b, lam, tol, maxit=maxit, iter_block=iter_block, gamma1=gamma1,
        gamma2=gamma2, return_dual=True,
    )


def match_kernel_solver(factory, kwargs, *, tol, maxit, stop=None,
                        solution=None, interpret=None):
    """Return ``run() -> (xs, iters, done)`` for a dispatchable batched
    problem, or ``None``.

    Recognized shapes:

    * ``make_fast_forward_backward_iteration`` + ``LeastSquaresLoss``/
      ``LeastSquares`` (stacked A (B,M,N), b (B,M), lam=1) + ``NormL1`` +
      fixed stepsize (``Lf`` or ``gamma``) + concrete x0 + default Nesterov
      sequence  →  :func:`~proxtpu.kernels.lasso.solve_lasso_batch`, whose
      step is chosen by :func:`~proxtpu.kernels.lasso.lasso_step_route`
      (the fused kernel for float32 on a GPU, the XLA step otherwise;
      ``interpret=True`` runs the kernel in Pallas interpret mode).  A
      shared (2-D) A routes to the shared-A solver instead.
    * ``make_forward_backward_iteration`` + ``Quadratic`` (stacked Q, q) +
      ``IndBox`` (scalar bounds) + fixed per-lane ``gamma`` + concrete x0
      →  batched box-QP projected gradient.
    """
    if stop is not None or solution is not None:
        return None
    # option defaults only — any customization falls back to the generic path
    if kwargs.get("adaptive"):
        return None
    # One recognized non-default sequence: AdaptiveRestartSequence wrapping
    # the default t-recursion (FixedNesterovSequence, or AdaptiveNesterov
    # with m=0, which reproduces it under the fixed stepsize required here)
    # maps onto the solvers' per-lane O'Donoghue-Candès restart.
    restart = False
    seq = kwargs.get("extrapolation_sequence")
    if seq is not None:
        from ..accel.nesterov import (
            AdaptiveNesterovSequence,
            AdaptiveRestartSequence,
            FixedNesterovSequence,
        )

        inner = getattr(seq, "sequence", None)
        if isinstance(seq, AdaptiveRestartSequence) and (
            isinstance(inner, FixedNesterovSequence)
            or (
                isinstance(inner, AdaptiveNesterovSequence)
                and float(inner.m) == 0.0
            )
        ):
            restart = True
        else:
            return None
    # mf > 0 (a static scalar strong-convexity modulus) rides the FISTA
    # solver: under the fixed stepsize required here the driver's
    # AdaptiveNesterovSequence(m=mf) coefficient is constant, and
    # solve_lasso_batch(mf=...) draws it with the same sequence ops
    # (bit-faithful, f64-verified).  Array-valued mf or mf combined with a
    # custom sequence falls back to the generic driver.
    try:
        mf_raw = kwargs.get("mf", 0.0)
        mf = 0.0 if mf_raw is None else float(mf_raw)
    except (TypeError, ValueError):
        return None  # array-valued mf: generic driver
    mf = mf if mf > 0.0 else None
    if mf is not None and seq is not None:
        return None
    x0 = kwargs.get("x0")
    if x0 is None:
        return None
    # any CONCRETE x0 rides the solvers (warm start — exact trajectory
    # parity with the generic driver, f64-verified; f32 counts can drift a
    # few % by rounding chaos, solutions agree to solver tolerance).  A
    # traced x0 falls back to the generic driver.
    try:
        x0_pass = None if not np.asarray(x0).any() else jnp.asarray(x0)
    except Exception:
        return None

    f = kwargs.get("f")
    g = kwargs.get("g")
    name = getattr(factory, "__name__", "")

    # interpret=True runs the lasso kernel in Pallas interpret mode; any
    # other value leaves the step to lasso_step_route
    interpret = interpret is True

    if name == "make_fast_forward_backward_iteration":
        from ..prox.functions import (
            ElasticNet,
            LeastSquares,
            LeastSquaresLoss,
            NormL1,
        )
        from ..utils.shared import Shared

        # a Shared (lane-invariant) f is the regularization-path workload:
        # one (A, b), per-lane lam — unwrap it and broadcast b so it routes
        # to the shared-A matmul formulation below
        if isinstance(f, Shared):
            f = f.value
        if isinstance(g, Shared):
            g = g.value
        if not isinstance(f, (LeastSquares, LeastSquaresLoss)):
            return None
        # ElasticNet rides the same solvers: its combined prox is the soft
        # threshold followed by a per-lane 1/(1+gamma*lam2) shrink (one
        # extra per-lane operand of the step)
        if isinstance(g, ElasticNet):
            g_l1, g_lam2 = g.mu, g.lam
        elif isinstance(g, NormL1):
            g_l1, g_lam2 = g.lam, None
        else:
            return None
        if g_lam2 is not None and mf is not None:
            return None  # lam2+mf not validated; generic driver
        A, b = jnp.asarray(f.A), jnp.asarray(f.b)
        if A.ndim == 2 and b.ndim == 1:
            try:
                b = jnp.broadcast_to(b, (np.shape(x0)[0], b.shape[0]))
            except Exception:
                return None

        if A.ndim == 2 and b.ndim == 2:
            # shared design matrix, many right-hand sides -> the matmul
            # formulation (solve_lasso_multirhs)
            B = b.shape[0]
            flam = np.asarray(getattr(f, "lam", 1.0))
            if not bool(np.all(flam == 1.0)):
                return None
            lam = _scalar_or_vec(g_l1, B, A.dtype)
            lam2 = (None if g_lam2 is None
                    else _scalar_or_vec(g_lam2, B, A.dtype))
            if g_lam2 is not None and lam2 is None:
                return None  # unbroadcastable lam2: generic driver
            Lf, gamma = kwargs.get("Lf"), kwargs.get("gamma")
            if gamma is not None:
                Lfs = jnp.asarray(gamma)
                Lfs = 1.0 / Lfs if Lfs.ndim == 0 else None
            elif Lf is not None:
                Lfs = jnp.asarray(Lf)
                Lfs = Lfs if Lfs.ndim == 0 else None
            else:
                Lfs = None
            if lam is None or Lfs is None:
                return None

            from .lasso import solve_lasso_multirhs

            if np.shape(x0) != (b.shape[0], A.shape[1]):
                return None
            if mf is not None:
                return None  # multirhs has no mf route yet
            return lambda: solve_lasso_multirhs(
                A, b, lam, Lfs, tol, maxit=maxit, iter_block=1,
                restart=restart, x0=x0_pass, lam2=lam2,
            )

        if A.ndim != 3 or b.ndim != 2 or A.shape[:1] != b.shape[:1]:
            return None
        B = A.shape[0]
        flam = np.asarray(getattr(f, "lam", 1.0))
        if not bool(np.all(flam == 1.0)):
            return None
        lam = _scalar_or_vec(g_l1, B, A.dtype)
        if lam is None:
            return None
        lam2 = (None if g_lam2 is None
                else _scalar_or_vec(g_lam2, B, A.dtype))
        if g_lam2 is not None and lam2 is None:
            return None  # unbroadcastable lam2: generic driver
        Lf, gamma = kwargs.get("Lf"), kwargs.get("gamma")
        if gamma is not None:
            Lfv = _scalar_or_vec(gamma, B, A.dtype)
            Lfv = None if Lfv is None else 1.0 / Lfv
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, A.dtype)
        else:
            return None  # adaptive-free solve needs an explicit stepsize
        if Lfv is None:
            return None

        if np.shape(x0) != (A.shape[0], A.shape[2]):
            return None

        from .lasso import solve_lasso_batch

        def run():
            return solve_lasso_batch(
                A, b, lam, Lfv, tol, maxit=maxit,
                use_kernel=True if interpret else None, interpret=interpret,
                restart=restart, x0=x0_pass, mf=mf, lam2=lam2,
            )

        return run

    if name == "make_forward_backward_iteration":
        from ..prox.functions import IndBox, Quadratic

        if seq is not None:
            return None  # plain FB has no momentum to restart
        if mf is not None:
            return None  # plain FB has no extrapolation for mf to tune
        if not isinstance(f, Quadratic):
            return None
        if not isinstance(g, IndBox):
            return None
        Q, q = jnp.asarray(f.Q), jnp.asarray(f.q)
        if Q.ndim != 3 or q.ndim != 2 or Q.shape[1] != Q.shape[2]:
            return None
        B = Q.shape[0]
        # host-side value check: jnp.asarray + bool() would cost two
        # device round-trips per call
        lo, hi = np.asarray(g.low), np.asarray(g.high)
        if lo.ndim != 0 or hi.ndim != 0 or not (
            bool(np.isfinite(lo)) and bool(np.isfinite(hi))
        ):
            return None
        gamma = kwargs.get("gamma")
        Lf = kwargs.get("Lf")
        if gamma is not None:
            gv = _scalar_or_vec(gamma, B, Q.dtype)
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, Q.dtype)
            gv = None if Lfv is None else 1.0 / Lfv
        else:
            return None
        if gv is None:
            return None
        Lip = 0.95 / gv  # the solver sets gamma = 0.95 / Lip per lane
        if np.shape(x0) != tuple(q.shape):
            return None

        from .box_qp import solve_box_qp_batch

        return lambda: solve_box_qp_batch(
            Q, q, lo, hi, Lip, tol, maxit=maxit, x0=x0_pass,
        )

    return None
