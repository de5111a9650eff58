"""Batched lasso FISTA: the fused GPU step kernel and the solvers around it.

The hot op of the batched FB/FISTA solvers is, per problem lane i:

    z_i = soft_threshold(x_i - gamma_i * A_i^T (A_i x_i - b_i), gamma_i*lam_i)
    res_i = ||x_i - z_i||_inf

The plain XLA step (:func:`reference_fb_prox_grad`) runs it as two batched
matvecs, so every A_i crosses device memory *twice* per iteration.  The step
is bound by that traffic: at 0.5 flop per byte it gets nothing from tensor
cores.  :func:`fused_fista_step` is one Pallas kernel (Triton route) that
reads each A_i once: one program per lane walks the rows of A_i in
``(block_rows, N_pad)`` tiles, forms ``r_tile = A_tile x - b_tile`` and
accumulates ``grad += A_tile^T r_tile`` in registers, then applies the
prox, the restart signal, the Nesterov extrapolation and the frozen-lane
pass-through before it writes the carries back in place.  N is padded to a
power of two in registers only (masked loads); device memory keeps the dense
(B, M, N) array.  All arithmetic is float32 multiply-and-reduce on the CUDA
cores, never a TF32 ``dot``.

:func:`lasso_step_route` decides, once per solve, which of the two steps a
solver runs.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def lasso_step_route(A, use_kernel=None, interpret=False):
    """The FB step a distinct-A lasso solve runs: ``"kernel"`` or ``"xla"``.

    ``use_kernel=None`` picks the fused kernel for float32 operators on a
    GPU (and for any operator when ``interpret=True``), the XLA step
    otherwise.  ``use_kernel=True`` without ``interpret`` raises off a GPU
    (the kernel is compiled for the card; the CPU runs it only in
    interpret mode) and for non-float32 operators."""
    dtype = jnp.dtype(A.dtype)
    on_gpu = jax.default_backend() == "gpu"
    if use_kernel is None:
        use_kernel = interpret or (on_gpu and dtype == jnp.float32)
    if not use_kernel:
        return "xla"
    if interpret:
        return "kernel"
    if not on_gpu:
        raise ValueError(
            "use_kernel=True needs a GPU (the fused step is compiled for "
            f"the card; backend is {jax.default_backend()!r}); pass "
            "interpret=True to run it in Pallas interpret mode"
        )
    if dtype != jnp.float32:
        raise ValueError(f"the fused step is float32-only, got {dtype}")
    return "kernel"


def _kernel_config(B, M, N):
    """(block_rows, num_warps, num_stages, splits) of :func:`fused_fista_step`
    for a (B, M, N) operator: 32-row tiles of at most 16K elements, four
    warps, two pipeline stages, and rows split across programs until the
    grid has at least 256 programs (tuned on an H100 at 256x200x400 and
    64x200x400, where 64 lanes run fastest with 4 splits)."""
    n_pad = pl.next_power_of_2(N)
    block_rows = max(1, min(32, 16384 // n_pad, pl.next_power_of_2(M)))
    tiles = pl.cdiv(M, block_rows)
    splits = max(1, min(tiles, 256 // B))
    return block_rows, 4, 2, splits


def _fista_epilogue(x, zp, grad, beta, gamma, thr, frozen, shrink, restart,
                    rsum, rmax):
    """Prox + restart + extrapolation + freeze of one FISTA iteration, for
    the kernel (1-D lane vectors, scalar parameters, full reductions) and
    for XLA (``(B, N)`` arrays, ``(B, 1)`` parameters, row reductions).

    ``shrink`` (optional) is the elastic-net prox denominator
    ``1 + gamma*lam2``: the soft threshold is DIVIDED by it, which
    bit-matches ``ElasticNet.prox``.  ``rs = <x - z, z - z_prev>`` is the
    O'Donoghue-Candès gradient-scheme restart signal; with ``restart`` a
    triggering lane's extrapolation coefficient is zeroed for THIS step
    (``accel.AdaptiveRestartSequence`` semantics).  Frozen lanes pass
    their carries through and report ``res = rs = 0``."""
    y = x - gamma * grad
    z = jnp.sign(y) * jnp.maximum(jnp.abs(y) - thr, 0.0)
    if shrink is not None:
        z = z / shrink
    rs = rsum((x - z) * (z - zp))
    if restart:
        beta = jnp.where(rs > 0, jnp.zeros_like(beta), beta)
    x_new = z + beta * (z - zp)
    res = rmax(jnp.abs(x - z))
    zero = jnp.zeros_like(res)
    return (jnp.where(frozen, x, x_new), jnp.where(frozen, zp, z),
            jnp.where(frozen, zero, res), jnp.where(frozen, zero, rs))


def _fista_kernel(A_ref, b_ref, x_ref, zp_ref, beta_ref, gamma_ref, thr_ref,
                  done_ref, *rest, M, N, block_rows, splits, restart,
                  with_shrink):
    """One program per lane (and per row split when ``splits > 1``): a loop
    over row tiles of A_i reads each tile once and accumulates the
    gradient in registers.  With one split the program finishes the whole
    iteration; with several it writes its partial gradient and the
    epilogue runs in XLA."""
    if with_shrink:
        shr_ref, *outs = rest
    else:
        shr_ref, outs = None, rest
    lane = pl.program_id(0)
    n_pad = pl.next_power_of_2(N)
    cmask = jnp.arange(n_pad) < N
    # the row slice of a (B, N) array; an int32 start, like the lane index
    cols = pl.ds(jnp.int32(0), n_pad)

    def row_vec(ref):
        return plgpu.load(ref.at[lane, cols], mask=cmask, other=0.0)

    x = row_vec(x_ref)
    tiles = pl.cdiv(M, block_rows)
    if splits > 1:
        tiles = pl.cdiv(tiles, splits)
        row0 = pl.program_id(1) * tiles * block_rows
    else:
        row0 = 0

    def tile(t, grad):
        r0 = row0 + t * block_rows
        rmask = r0 + jnp.arange(block_rows) < M
        A = plgpu.load(
            A_ref.at[lane, pl.ds(r0, block_rows), cols],
            mask=rmask[:, None] & cmask[None, :], other=0.0,
        ).astype(x.dtype)
        b = plgpu.load(b_ref.at[lane, pl.ds(r0, block_rows)], mask=rmask,
                       other=0.0)
        r = jnp.sum(A * x[None, :], axis=1) - b
        return grad + jnp.sum(A * r[:, None], axis=0)

    grad = jax.lax.fori_loop(0, tiles, tile, jnp.zeros((n_pad,), x.dtype))
    if splits > 1:
        (g_ref,) = outs
        plgpu.store(g_ref.at[lane, pl.program_id(1), cols], grad, mask=cmask)
        return

    xo_ref, zo_ref, res_ref, rs_ref = outs
    x_new, z, res, rs = _fista_epilogue(
        x, row_vec(zp_ref), grad, beta_ref[lane], gamma_ref[lane],
        thr_ref[lane], done_ref[lane] > 0,
        None if shr_ref is None else shr_ref[lane], restart,
        jnp.sum, jnp.max,
    )
    plgpu.store(xo_ref.at[lane, cols], x_new, mask=cmask)
    plgpu.store(zo_ref.at[lane, cols], z, mask=cmask)
    res_ref[lane] = res
    rs_ref[lane] = rs


@partial(jax.jit, static_argnames=("restart", "interpret", "block_rows",
                                   "num_warps", "num_stages", "splits"))
def fused_fista_step(A, b, x, z_prev, beta, gamma, thr, done, shrink=None,
                     restart=False, interpret=False, block_rows=None,
                     num_warps=None, num_stages=None, splits=None):
    """One complete FISTA iteration for the batch in one pass over A.

    Args:
      A: (B, M, N) stacked operators (float32, or narrower storage such as
        bfloat16 that the kernel widens on load).
      b: (B, M) offsets.  x, z_prev: (B, N) extrapolated point and previous
        prox point; both are aliased to the outputs, so a ``while_loop``
        carry is updated in place.
      beta, gamma, thr, done: (B,) extrapolation coefficient, stepsize,
        threshold ``gamma * lam`` and frozen-lane mask (nonzero = frozen).
      shrink: optional (B,) elastic-net prox denominator ``1 + gamma*lam2``.
      restart: zero the extrapolation of lanes whose restart signal fires.
      interpret: run in Pallas interpret mode (CPU tests).
      block_rows, num_warps, num_stages, splits: tuning overrides (rows per
        tile, Triton warps and pipeline stages, programs per lane); default
        from :func:`_kernel_config`.

    Returns ``(x_new, z, res_inf, restart_sig)``; frozen lanes pass their
    carries through with ``res_inf = restart_sig = 0``.  The plain FB step
    is this call with ``beta = 0``, ``z_prev = x`` and no frozen lane.
    """
    B, M, N = A.shape
    dtype = x.dtype
    cfg = _kernel_config(B, M, N)
    block_rows = block_rows or cfg[0]
    num_warps = num_warps or cfg[1]
    num_stages = num_stages or cfg[2]
    splits = splits or cfg[3]
    vec = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (B,))
    operands = [A, b.astype(dtype), x, z_prev, vec(beta), vec(gamma),
                vec(thr), vec(done)]
    if shrink is not None:
        operands.append(vec(shrink))
    kernel = partial(_fista_kernel, M=M, N=N, block_rows=block_rows,
                     splits=splits, restart=restart,
                     with_shrink=shrink is not None)
    params = plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages)
    cost = pl.CostEstimate(
        flops=4 * B * M * N, transcendentals=0,
        bytes_accessed=B * M * N * A.dtype.itemsize
        + (B * M + 5 * B * N) * dtype.itemsize,
    )
    if splits > 1:
        partial_grads = pl.pallas_call(
            kernel, grid=(B, splits),
            out_shape=jax.ShapeDtypeStruct((B, splits, N), dtype),
            backend="triton", compiler_params=params, cost_estimate=cost,
            interpret=interpret, name="fista_grad",
        )(*operands)
        return _xla_epilogue(x, z_prev, jnp.sum(partial_grads, axis=1),
                             *operands[4:8], shrink=shrink, restart=restart)
    return tuple(pl.pallas_call(
        kernel, grid=(B,),
        out_shape=[jax.ShapeDtypeStruct((B, N), dtype),
                   jax.ShapeDtypeStruct((B, N), dtype),
                   jax.ShapeDtypeStruct((B,), dtype),
                   jax.ShapeDtypeStruct((B,), dtype)],
        input_output_aliases={2: 0, 3: 1},
        backend="triton", compiler_params=params, cost_estimate=cost,
        interpret=interpret, name="fista_step",
    )(*operands))


def _xla_epilogue(x, zp, grad, beta, gamma, thr, done, shrink=None,
                  restart=False):
    """:func:`_fista_epilogue` on (B, N) arrays with (B,) parameters."""
    B = x.shape[0]
    col = lambda v: None if v is None else jnp.broadcast_to(
        jnp.asarray(v, x.dtype), (B,))[:, None]
    x_new, z, res, rs = _fista_epilogue(
        x, zp, grad, col(beta), col(gamma), col(thr), col(done) > 0,
        col(shrink), restart, partial(jnp.sum, axis=1, keepdims=True),
        partial(jnp.max, axis=1, keepdims=True),
    )
    return x_new, z, res[:, 0], rs[:, 0]


def xla_fista_step(A, b, x, z_prev, beta, gamma, thr, done, shrink=None,
                   restart=False):
    """The plain XLA counterpart of :func:`fused_fista_step` (same
    arguments and results): two batched matvecs, so A is read twice."""
    hi = jax.lax.Precision.HIGHEST
    r = jnp.einsum("bmn,bn->bm", A, x, precision=hi) - b
    grad = jnp.einsum("bmn,bm->bn", A, r, precision=hi)
    return _xla_epilogue(x, z_prev, grad, beta, gamma, thr, done,
                         shrink=shrink, restart=restart)


def reference_fb_prox_grad(A, b, x, gamma, thr, shrink=None):
    """Pure-XLA reference of the fused step (same math, two A reads).
    ``shrink`` (B,) is the optional elastic-net prox denominator
    ``1 + gamma*lam2`` (divided, bit-matching ``ElasticNet.prox``)."""
    r = jnp.einsum("bmn,bn->bm", A, x,
                   precision=jax.lax.Precision.HIGHEST) - b
    grad = jnp.einsum("bmn,bm->bn", A, r,
                      precision=jax.lax.Precision.HIGHEST)
    y = x - gamma[:, None] * grad
    z = jnp.sign(y) * jnp.maximum(jnp.abs(y) - thr[:, None], 0.0)
    if shrink is not None:
        z = z / shrink[:, None]
    return z, jnp.max(jnp.abs(x - z), axis=1)


def fused_fb_prox_grad(A, b, x, gamma, thr, shrink=None, interpret=False):
    """One fused FB step ``(z, res_inf)``: :func:`fused_fista_step` with
    ``beta = 0``, ``z_prev = x`` and no frozen lane."""
    _, z, res, _ = fused_fista_step(A, b, x, x, 0.0, gamma, thr, 0.0,
                                    shrink, interpret=interpret)
    return z, res


def _fb_step(route, interpret):
    """``(A, b, x, gamma, thr, shrink=None) -> (z, res)`` on ``route``."""
    if route == "kernel":
        return partial(fused_fb_prox_grad, interpret=interpret)
    return reference_fb_prox_grad


def _full_step(route, interpret):
    """One full FISTA iteration (:func:`fused_fista_step`'s signature) on
    ``route``."""
    if route == "kernel":
        return partial(fused_fista_step, interpret=interpret)
    return xla_fista_step


def _mf_beta_pair(gamma, mf, dtype):
    """Per-lane (beta1, beta_const) for the strongly-convex (mf>0) FISTA
    variant, drawn with the SAME sequence ops as the generic driver's
    ``AdaptiveNesterovSequence`` (bit-faithful: f32 rounds step 1
    differently from steps 2+, hence the pair)."""
    from ..accel.nesterov import AdaptiveNesterovSequence

    seq = AdaptiveNesterovSequence(m=float(mf))

    def _two_betas(g):
        st = seq.init_state(jnp.zeros((), dtype))
        b1, st = seq.next_coeff(st, g)
        b2, _ = seq.next_coeff(st, g)
        return b1, b2

    return jax.vmap(_two_betas)(gamma)


def _validate_step_mult(step_mult, restart, mf):
    if step_mult == 1.0:
        return
    if not (0.0 < step_mult < 2.0):
        raise ValueError(
            f"step_mult={step_mult} outside (0, 2): forward-backward on the "
            f"L-smooth quadratic diverges at gamma >= 2/L"
        )
    if step_mult > 1.0 and not restart:
        raise ValueError(
            "step_mult > 1 requires restart=True: Nesterov momentum at "
            "gamma > 1/L is unstable without the gradient-scheme restart "
            "(measured: divergence on the flagship workload)"
        )
    if mf is not None:
        raise ValueError("step_mult is not supported with mf (the "
                         "strongly-convex constant-beta variant)")


@partial(
    jax.jit,
    static_argnames=("maxit", "use_kernel", "interpret", "restart", "mf",
                     "step_mult", "stall_patience"),
)
def solve_lasso_batch(
    A, b, lam, Lf, tol, maxit=1000, use_kernel=None, interpret=False,
    restart=False, x0=None, mf=None, step_mult=1.0, stall_patience=100,
    lam2=None,
):
    """Batched FISTA lasso/elastic-net solver over distinct operators
    A (B, M, N).

    ``use_kernel`` chooses the FB step through :func:`lasso_step_route`:
    ``None`` (default) runs the fused kernel for float32 operators on a
    GPU and the XLA step otherwise; ``True`` demands the kernel (compiled
    on a GPU, or in Pallas interpret mode with ``interpret=True``);
    ``False`` forces the XLA step.

    ``lam2`` (scalar or (B,), optional) adds the ridge term
    ``lam2/2 ||x||^2`` to the regularizer — the elastic net of the
    reference's second problem family (`test_elasticnet.jl`).  Its
    combined prox is the soft threshold followed by a per-lane divide by
    ``1 + gamma*lam2``, one extra scalar operand of the step.  ``Lf``
    stays the least-squares smoothness constant (the ridge enters through
    the prox).  Composes with ``restart``; not supported with
    ``mf``/``step_mult`` (the strongly-convex coefficient and
    over-relaxation analyses were only validated for the pure-l1 prox).

    Per-lane convergence freezing matches
    :func:`proxtpu.parallel.batch.batched_run_loop` semantics: converged
    lanes stop changing, per-lane iteration counts are reported.  Stopping
    rule is the FB-family criterion ``||x - z||_inf / gamma <= tol``.

    ``restart=True`` enables per-lane O'Donoghue-Candès adaptive restart
    (gradient scheme: reset the Nesterov sequence when
    ``<x - z, z - z_prev> > 0``) — same fixed point and stopping rule,
    usually far fewer iterations once a lane's active set settles and the
    problem turns locally strongly convex.  Off by default because the
    iteration-count parity tests pin the textbook sequence.

    ``mf`` (static Python float > 0) runs the strongly-convex FISTA
    variant: under the fixed stepsize the generic driver's
    ``AdaptiveNesterovSequence(m=mf)`` coefficient is constant, so the
    solver draws the per-lane (beta1, beta_rest) pair by running the SAME
    sequence ops (bit-faithful to the driver — f32 rounds step 1
    differently from steps 2+, hence the pair) and skips the t-recursion.
    Mutually exclusive with ``restart`` (resetting a constant sequence is
    a no-op).

    ``step_mult`` (static float in (0, 2), default 1.0) over-relaxes the
    stepsize to ``gamma = step_mult / Lf``.  Forward-backward on the
    least-squares term converges for any gamma < 2/L, and on sparse
    solutions the momentum+restart combination at gamma ~ 1.5/L cuts
    MEAN iteration counts 15-25% on the flagship 256x200x400 batch.  The
    stopping rule becomes the CANONICAL criterion
    ``||x - z||_inf * Lf <= tol``, which (a) equals the textbook
    ``||res||_inf / gamma <= tol`` when step_mult == 1 and (b) certifies
    it at gamma > 1/L via the gradient-mapping monotonicity lemma
    ``gamma1 ||G_gamma1|| <= gamma2 ||G_gamma2||`` for gamma1 <= gamma2
    (Beck, First-Order Methods, Thm 10.9) — returned solutions satisfy
    the same criterion as step_mult=1 solves.  Requires ``restart=True``:
    without the restart the momentum diverges.  SAFEGUARD: over-relaxation
    is only stable when the active-set-reduced problem is well conditioned
    (at lam = 0.02 lam_max, gamma = 1.5/L DIVERGES — crit reaches 1e29
    within 250 iterations — on ~45% of instances), so each lane watches
    for runaway (crit > 10x its best) or ``stall_patience`` consecutive
    non-improving iterations and then cold-restarts the TEXTBOOK solve
    (canonical gamma, fresh momentum, iterate back to x0); worst-case
    lane cost = textbook + detection (~5-25%).  WHEN TO USE: batched wall
    time is governed by the slowest lane, so on large batches one
    safeguard-triggering lane erases the mean win (flagship batch: max
    lane 285 -> 367), while well-conditioned batches (M/N >~ 1/2 at
    moderate aspect) win uniformly.  Off by default; the textbook path is
    untouched when step_mult == 1.
    """
    B, M, N = A.shape
    dtype = A.dtype
    _validate_step_mult(step_mult, restart, mf)
    if lam2 is not None and (mf is not None or step_mult != 1.0):
        raise ValueError(
            "lam2 (elastic net) composes with restart only; the mf and "
            "step_mult analyses were validated for the pure-l1 prox"
        )
    if mf is not None and restart:
        raise ValueError(
            "restart needs the t-recursion; mf>0 uses a constant "
            "extrapolation coefficient (restart would be a no-op)"
        )
    route = lasso_step_route(A, use_kernel, interpret)
    vec = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (B,))
    gamma0 = vec(1.0 / Lf)                      # canonical 1/L (criterion)
    gamma = vec(step_mult / Lf)                 # step
    thr = (gamma * lam).astype(dtype)
    shrink = None if lam2 is None else (1.0 + gamma * vec(lam2)).astype(dtype)
    if step_mult != 1.0:
        return _solve_lasso_batch_overrelaxed(
            A, b, jnp.asarray(lam), gamma0, gamma, tol, maxit=maxit,
            route=route, interpret=interpret, x0=x0,
            stall_patience=stall_patience,
        )

    x0 = jnp.zeros((B, N), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, N)
    z0, res0 = _fb_step(route, interpret)(A, b, x0, gamma, thr, shrink)
    # state: (k, x, z_prev, t, done, iters); the init FB step counts as
    # iteration 1.  The first extrapolation coefficient is beta = 0 (t=1),
    # so the next point is z0 itself: carry x = z0 with the t-sequence
    # already advanced once, matching the generic FISTA driver's counts.
    done0 = res0 / gamma <= tol
    t0 = jnp.ones((B,), dtype)
    t1 = (1 + jnp.sqrt(1 + 4 * t0 * t0)) / 2
    beta_const = None
    if mf is not None:
        beta1, beta_const = _mf_beta_pair(gamma, mf, dtype)
        # the mf>0 sequence has NO zero first coefficient: the generic
        # driver extrapolates step 1 as z0 + beta1*(z0 - x0)
        x_init = z0 + beta1[:, None] * (z0 - x0)
    else:
        x_init = z0
    init = (
        jnp.asarray(1, jnp.int32),
        x_init,
        z0,
        t1,
        done0,
        jnp.ones((B,), jnp.int32),
    )

    def cond(c):
        k, done = c[0], c[4]
        return (k < maxit) & jnp.logical_not(jnp.all(done))

    body = _make_fista_body(A, b, gamma, thr, tol, route=route,
                            interpret=interpret, restart=restart,
                            beta_const=beta_const, shrink=shrink)
    k, x, z, t, done, iters = jax.lax.while_loop(cond, body, init)
    iters = jnp.where(done, iters, k)
    return z, iters, done


def _make_fista_body(A, b, gamma, thr, tol, *, route, interpret, restart,
                     beta_const=None, shrink=None):
    """The one-iteration while-loop body over the carry
    ``(k, x, z_prev, t, done, iters)`` — shared by :func:`solve_lasso_batch`
    and the compacting driver so the trajectories are bit-identical.
    ``beta_const`` ((B,) array) replaces the t-recursion with a constant
    per-lane extrapolation coefficient (the strongly-convex mf>0 path)."""
    dtype = A.dtype
    step = _full_step(route, interpret)

    def body(c):
        k, x, z_prev, t, done, iters = c
        if beta_const is not None:
            beta, t_new = beta_const, t
        else:
            t_new = (1 + jnp.sqrt(1 + 4 * t * t)) / 2
            beta = (t - 1) / t_new
        x_new, z, res, rs = step(A, b, x, z_prev, beta, gamma, thr,
                                 done.astype(dtype), shrink, restart=restart)
        if restart:
            # immediate (paper) semantic, matching
            # accel.AdaptiveRestartSequence: the step zeroed the
            # triggering lane's beta for THIS extrapolation (t reset to 1
            # before the coefficient), so its carry advances from
            # 1 -> (1+sqrt(5))/2
            phi = (1 + jnp.sqrt(jnp.full_like(t_new, 5.0))) / 2
            t_new = jnp.where(rs > 0, phi, t_new)
        newly_done = res / gamma <= tol
        k = k + 1
        iters = jnp.where(done, iters, k)
        return (k, x_new, z, jnp.where(done, t, t_new),
                done | newly_done, iters)

    return body


def _solve_lasso_batch_overrelaxed(
    A, b, lam, gamma0, gamma_init, tol, *, maxit, route, interpret, x0,
    stall_patience,
):
    """Over-relaxed restart-FISTA with the per-lane stall safeguard (see
    :func:`solve_lasso_batch` ``step_mult`` docs).  The per-lane gamma
    lives in the while-loop carry so a stalling lane can fall back to the
    canonical 1/Lf mid-solve; the step takes per-lane gamma/thr as
    per-call operands."""
    B, M, N = A.shape
    dtype = A.dtype
    step = _full_step(route, interpret)

    def full_step(x, zp, beta, gam, dm):
        return step(A, b, x, zp, beta, gam, (gam * lam).astype(dtype), dm,
                    restart=True)

    x0 = jnp.zeros((B, N), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, N)
    z0, res0 = _fb_step(route, interpret)(A, b, x0, gamma_init,
                                          (gamma_init * lam).astype(dtype))
    crit0 = res0 / gamma0
    done0 = crit0 <= tol
    t1 = jnp.ones((B,), dtype)
    t1 = (1 + jnp.sqrt(1 + 4 * t1 * t1)) / 2
    init = (
        jnp.asarray(1, jnp.int32), z0, z0, t1, done0,
        jnp.ones((B,), jnp.int32),
        gamma_init,                      # per-lane stepsize (may back off)
        crit0,                           # best criterion value seen
        jnp.zeros((B,), jnp.int32),      # iterations since improvement
    )

    def cond(c):
        return (c[0] < maxit) & jnp.logical_not(jnp.all(c[4]))

    def body(c):
        k, x, z_prev, t, done, iters, gam, best, since = c
        t_new = (1 + jnp.sqrt(1 + 4 * t * t)) / 2
        beta = (t - 1) / t_new
        x_new, z, res, rs = full_step(x, z_prev, beta, gam,
                                      done.astype(dtype))
        # immediate-restart t carry (rs > 0 lanes had beta zeroed in-step)
        phi = jnp.asarray((1 + jnp.sqrt(5.0)) / 2, t_new.dtype)
        t_new = jnp.where(rs > 0, phi, t_new)
        crit = res / gamma0              # canonical ||G_{1/L}|| certificate
        newly_done = crit <= tol
        # Stall/runaway safeguard.  An over-relaxed lane fails by
        # DIVERGING (crit reaches 1e29 within 250 iterations at
        # lam = 0.02 lam_max — not a bounded limit cycle), so two
        # triggers: `runaway` (crit blew 10x past the best seen — fires
        # within ~20 iterations of the instability) and `stall_patience`
        # consecutive non-improving iterations (the slow-cycle catch-all;
        # the 0.999 relative margin keeps f32 noise from resetting the
        # counter).  A triggered lane COLD-RESTARTS the textbook solve:
        # canonical gamma, fresh momentum, iterate back to x0 (the
        # diverged iterate is garbage — converging from it costs ~10x
        # more than restarting).  `gam > gamma0` makes the trigger
        # one-shot; crit is gamma-independent so `best` stays comparable
        # across the backoff.
        improved = crit < best * 0.999
        runaway = crit > best * 10.0
        best = jnp.where((~done) & improved, crit, best)
        since = jnp.where(done | improved, 0, since + 1)
        stall = (~done) & ((since >= stall_patience) | runaway) & \
            (gam > gamma0)
        gam = jnp.where(stall, gamma0, gam)
        t_new = jnp.where(stall, jnp.ones_like(t_new), t_new)
        since = jnp.where(stall, 0, since)
        x_new = jnp.where(stall[:, None], x0, x_new)
        z = jnp.where(stall[:, None], x0, z)
        k = k + 1
        iters = jnp.where(done, iters, k)
        return (k, x_new, z, jnp.where(done, t, t_new),
                done | newly_done, iters, gam, best, since)

    out = jax.lax.while_loop(cond, body, init)
    k, x, z, t, done, iters = out[:6]
    iters = jnp.where(done, iters, k)
    return z, iters, done


@partial(jax.jit, static_argnames=("route", "interpret", "restart"))
def _fista_segment(A, b, gamma, thr, tol, k, x, z_prev, t, done, iters,
                   k_end, route="xla", interpret=False, restart=False):
    """Run FISTA from an arbitrary carry until ``k == k_end`` or all lanes
    converge; the compacting driver's inner compiled program (one compile
    per distinct batch size)."""

    def cond(c):
        return (c[0] < k_end) & jnp.logical_not(jnp.all(c[4]))

    body = _make_fista_body(A, b, gamma, thr, tol, route=route,
                            interpret=interpret, restart=restart)
    return jax.lax.while_loop(cond, body, (k, x, z_prev, t, done, iters))


def solve_lasso_batch_compacting(
    A, b, lam, Lf, tol, maxit=1000, use_kernel=None, interpret=False,
    restart=False, segment=64, min_batch=32, x0=None,
):
    """Batched FISTA with convergence-tail lane compaction.

    Identical per-lane trajectory, stopping rule and iteration counts as
    :func:`solve_lasso_batch` (the loop body is shared): bit-identical on
    the kernel path (each lane's reductions run in its own program, so
    they do not depend on the batch size); on the XLA path solutions can
    differ in the last f32 ULP because the batched einsum's reduction
    tiling depends on the batch size.  The difference is otherwise pure
    *scheduling*: every ``segment`` iterations the per-lane ``done`` flags
    are pulled to the host, and once at most half the lanes remain active
    the batch is gathered down to the next power of two — so the
    convergence tail streams only the unconverged lanes' operators instead
    of re-reading the full batch every iteration (``min_batch`` bounds the
    shrink, below which the per-trip fixed cost dominates).

    This is a host-side driver (a Python loop around one jitted segment
    program per live batch size, ≤ log2(B/min_batch)+1 compiles) — it
    cannot be called from inside ``jit``.  Use it when the iteration-count
    spread across lanes is large (heavy tails pay the full-batch stream
    for a handful of stragglers); for tight spreads the host syncs buy
    nothing and :func:`solve_lasso_batch` is preferable.

    No reference counterpart (the reference solves one problem per call);
    the compaction policy mirrors the generic driver's
    (``proxtpu/parallel/batch.py``, power-of-two shrink at ≤50%
    occupancy).
    """
    B, M, N = A.shape
    dtype = A.dtype
    segment = max(1, int(segment))  # segment <= 0 would spin forever
    route = lasso_step_route(A, use_kernel, interpret)
    gamma_full = (1.0 / jnp.asarray(Lf)).astype(dtype) * jnp.ones((B,), dtype)
    thr_full = (gamma_full * jnp.asarray(lam)).astype(dtype)

    x0 = jnp.zeros((B, N), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, N)
    z0, res0 = _fb_step(route, interpret)(A, b, x0, gamma_full, thr_full)
    done0 = res0 / gamma_full <= tol
    t1 = (1 + jnp.sqrt(5.0)) / 2 * jnp.ones((B,), dtype)

    # device-side live state (shrinks at compaction points)
    cur = {
        "A": jnp.asarray(A), "b": jnp.asarray(b),
        "gamma": gamma_full, "thr": thr_full,
        "x": z0, "z_prev": z0, "t": t1, "done": done0,
        "iters": jnp.ones((B,), jnp.int32),
    }
    k = jnp.asarray(1, jnp.int32)
    idx = np.arange(B)          # live lane -> original index
    live = B                    # number of REAL lanes among the first `live`

    # host-side result buffers
    out_z = np.zeros((B, N), dtype)
    out_it = np.zeros((B,), np.int32)
    out_done = np.zeros((B,), bool)

    def flush(mask_h):
        """Copy finished live lanes' results out (mask over live lanes)."""
        sel = np.nonzero(mask_h[:live])[0]
        if sel.size:
            orig = idx[sel]
            out_z[orig] = np.asarray(cur["z_prev"])[sel]
            out_it[orig] = np.asarray(cur["iters"])[sel]
            out_done[orig] = True

    while int(k) < maxit:
        k_end = jnp.asarray(min(int(k) + segment, maxit), jnp.int32)
        k, x, z_prev, t, done, iters = _fista_segment(
            cur["A"], cur["b"], cur["gamma"], cur["thr"], tol,
            k, cur["x"], cur["z_prev"], cur["t"], cur["done"], cur["iters"],
            k_end, route=route, interpret=interpret, restart=restart,
        )
        cur.update(x=x, z_prev=z_prev, t=t, done=done, iters=iters)
        done_h = np.asarray(done)     # host sync (once per segment)
        active = int(np.sum(~done_h[:live]))
        if active == 0:
            break
        Bc = cur["A"].shape[0]
        target = max(min_batch, 1 << int(np.ceil(np.log2(active))))
        if target < Bc:
            # flush finished lanes, gather the active ones (+ padding
            # duplicates of lane 0 marked done, which the step freezes)
            flush(done_h)
            act = np.nonzero(~done_h[:live])[0]
            pad = np.zeros(target - act.size, np.int64)
            sel = jnp.asarray(np.concatenate([act, pad]))
            for key in ("A", "b", "gamma", "thr", "x", "z_prev", "t",
                        "iters"):
                cur[key] = jnp.take(cur[key], sel, axis=0)
            cur["done"] = jnp.asarray(
                np.concatenate([np.zeros(act.size, bool),
                                np.ones(pad.size, bool)]))
            idx = idx[act]
            live = act.size

    # final flush: everything still live (converged or stopped at maxit)
    done_h = np.asarray(cur["done"])
    orig = idx[:live]
    out_z[orig] = np.asarray(cur["z_prev"])[:live]
    out_it[orig] = np.asarray(cur["iters"])[:live]
    out_done[orig] = done_h[:live]
    # solve_lasso_batch's final clamp: unconverged lanes report k
    out_it[~out_done] = min(maxit, int(k))
    return jnp.asarray(out_z), jnp.asarray(out_it), jnp.asarray(out_done)


@partial(jax.jit, static_argnames=("maxit", "iter_block", "restart"))
def solve_lasso_multirhs(A, Bmat, lam, Lf, tol, maxit=2000, iter_block=1,
                         restart=False, x0=None, lam2=None):
    """Batched FISTA for many lasso instances sharing ONE design matrix:

        min_x  ||A x_i - b_i||^2 / 2 + lam_i ||x_i||_1,   i = 1..B

    (lasso paths, multi-target regression, scenario sweeps over b).  Unlike
    the distinct-A batch — whose per-lane matvecs are bandwidth-bound
    multiply-reduces — the shared-A step is two real matrix products,
    (B,N)@(N,M) and (B,M)@(M,N), and A is read once per iteration for the
    whole batch instead of once per lane.

    Same iterate trajectory, stopping rule (``||x-z||_inf / gamma <= tol``)
    and per-lane freezing as :func:`solve_lasso_batch`; pure XLA (XLA fuses
    the prox/extrapolation elementwise epilogue around the matmuls).

    Args:
      A: (M, N) shared design matrix.  Bmat: (B, M) right-hand sides.
      lam: scalar or (B,) l1 weights.  Lf: scalar ``opnorm(A)^2``.
      iter_block: FISTA iterations per while-loop trip.  K>1 amortizes
        the per-trip fixed cost (convergence reduction, lane freezing,
        loop control) over K steps; convergence is then *sampled* every
        K iterations, so counts become upper bounds (a lane is never
        reported converged before it is).  K=1 checks every iteration.
      restart: per-lane O'Donoghue-Candès gradient restart, checked once
        per ``iter_block`` (on the block's last step) so the restart
        reduction does not break the fused matmul chain of the other
        K-1 steps.  With ``iter_block=1`` this is the textbook per-step
        restart.

    Returns (z, iters, done) exactly like :func:`solve_lasso_batch`.
    """
    M, N = A.shape
    B = Bmat.shape[0]
    dtype = A.dtype
    gamma = (1.0 / jnp.asarray(Lf)).astype(dtype)  # scalar: shared A
    thr = jnp.broadcast_to((gamma * jnp.asarray(lam)).astype(dtype), (B,))
    # optional elastic-net ridge: prox epilogue z / (1 + gamma*lam2) — XLA
    # fuses the extra elementwise op into the matmul epilogue, so the
    # shared-A formulation covers the elastic net at lasso speed
    # (divide, not multiply-by-reciprocal: bit-matches ElasticNet.prox)
    shrink = None if lam2 is None else (
        1.0 + gamma * jnp.broadcast_to(jnp.asarray(lam2, dtype), (B,))
    ).astype(dtype)
    K = iter_block

    hi = jax.lax.Precision.HIGHEST

    def step_fn(X):
        R = jnp.matmul(X, A.T, precision=hi) - Bmat          # (B, M)
        G = jnp.matmul(R, A, precision=hi)                   # (B, N)
        Y = X - gamma * G
        Z = jnp.sign(Y) * jnp.maximum(jnp.abs(Y) - thr[:, None], 0.0)
        if shrink is not None:
            Z = Z / shrink[:, None]
        return Z, jnp.max(jnp.abs(X - Z), axis=1)

    def fista_k(x, z_prev, t):
        def one(c, check):
            x, z_prev, t, _res = c
            z, res = step_fn(x)
            if restart and check:
                # O'Donoghue-Candès gradient signal, evaluated ONLY on the
                # last step of each K-block: the per-step (B,N) reduction +
                # select breaks XLA's matmul-epilogue fusion, while the
                # delayed check keeps the fused matmul chain for
                # the first K-1 steps and still kills a wrong-way momentum
                # within one block (restart tolerates delayed checks: the
                # signal stays positive while the momentum overshoots).
                # Reset BEFORE drawing the coefficient (immediate restart,
                # = AdaptiveRestartSequence semantics).
                rs = jnp.sum((x - z) * (z - z_prev), axis=1)
                t = jnp.where(rs > 0, jnp.ones_like(t), t)
            t_new = (1 + jnp.sqrt(1 + 4 * t * t)) / 2
            beta = ((t - 1) / t_new)[:, None]
            x_new = z + beta * (z - z_prev)
            return (x_new, z, t_new, res)

        c = (x, z_prev, t, jnp.zeros((B,), dtype))
        c = jax.lax.fori_loop(0, K - 1, lambda _, cc: one(cc, False), c)
        return one(c, True)

    x0 = jnp.zeros((B, N), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, N)
    z0, res0 = step_fn(x0)
    done0 = res0 / gamma <= tol
    t1 = (1 + jnp.sqrt(5.0)) / 2 * jnp.ones((B,), dtype)
    init = (jnp.asarray(1, jnp.int32), z0, z0, t1, done0,
            jnp.ones((B,), jnp.int32))

    def cond(c):
        return (c[0] < maxit) & jnp.logical_not(jnp.all(c[4]))

    def body(c):
        k, x, z_prev, t, done, iters = c
        xn, zn, tn, res = fista_k(x, z_prev, t)
        keep = done[:, None]
        x_new = jnp.where(keep, x, xn)
        z_new = jnp.where(keep, z_prev, zn)
        t_new = jnp.where(done, t, tn)
        k = k + K
        newly_done = res / gamma <= tol
        iters = jnp.where(done, iters, k)
        return (k, x_new, z_new, t_new, done | newly_done, iters)

    k, x, z, t, done, iters = jax.lax.while_loop(cond, body, init)
    iters = jnp.minimum(jnp.where(done, iters, k), maxit)
    return z, iters, done


@partial(
    jax.jit,
    static_argnames=("maxit", "warm_maxit", "use_kernel", "interpret",
                     "warm_dtype", "restart"),
)
def solve_lasso_batch_mixed(
    A, b, lam, Lf, tol, maxit=1000, warm_tol=None, warm_maxit=None,
    use_kernel=None, interpret=False, warm_dtype=jnp.bfloat16,
    restart=False,
):
    """Two-stage mixed-precision batched FISTA: bf16-A warm start, f32 polish.

    The per-iteration cost of the distinct-A step is the A stream itself,
    so storing A in bfloat16 halves the bytes per iteration for as long as
    the iterates are far from the solution.  Stage 1 iterates on the
    bf16-cast operator (compute stays f32; only the *storage* narrows)
    until the residual clears ``warm_tol``; stage 2 restarts the Nesterov
    sequence from the warm iterate and polishes with the exact f32
    operator to ``tol``.  The final stopping criterion is identical to
    :func:`solve_lasso_batch` (``||x - z||_inf / gamma <= tol`` at the f32
    operator), so solution quality is unchanged — only the path to it is
    cheaper.  ``use_kernel``/``interpret`` choose the step as in
    :func:`solve_lasso_batch` (the kernel widens bf16 tiles on load).

    ``warm_tol`` defaults to ``max(tol * 30, 1e-2)``, i.e. at least
    1e-2: the bf16 operator perturbs the fixed point by roughly the bf16
    relative error (~4e-3), so driving stage 1 below ~1e-2 wastes cheap
    iterations converging to the *wrong* fixed point.  ``warm_maxit``
    (default ``maxit``) bounds stage 1; lanes that hit it simply enter
    stage 2 earlier.  Iteration counts report stage-1 + stage-2 steps.

    Returns (z, iters, done) like :func:`solve_lasso_batch`.
    """
    B, M, N = A.shape
    dtype = A.dtype
    if warm_tol is None:
        warm_tol = jnp.maximum(jnp.asarray(tol) * 30.0, 1e-2)
    if warm_maxit is None:
        warm_maxit = maxit
    route = lasso_step_route(A, use_kernel, interpret)
    gamma = jnp.broadcast_to((1.0 / jnp.asarray(Lf)).astype(dtype), (B,))
    thr = (gamma * jnp.asarray(lam)).astype(dtype)
    # warm_dtype=float32 isolates the two-stage/restart effect from the
    # narrow-storage effect
    A16 = A.astype(warm_dtype)
    # the kernel widens narrow tiles itself; the XLA step gets a widened A
    widen = (lambda A_: A_) if route == "kernel" else \
        (lambda A_: A_.astype(dtype))
    fb, step = _fb_step(route, interpret), _full_step(route, interpret)

    def one_step(A_, x):
        return fb(widen(A_), b, x, gamma, thr)

    def full_step(A_, x, zp, beta, dm):
        return step(widen(A_), b, x, zp, beta, gamma, thr, dm,
                    restart=restart)

    def fista_stage(A_, x_init, z_init, stop_tol, stage_maxit, k0, iters0,
                    done0):
        init = (k0, x_init, z_init, jnp.ones((B,), dtype), done0, iters0)

        def cond(c):
            return (c[0] < k0 + stage_maxit) & jnp.logical_not(
                jnp.all(c[4])
            )

        def body(c):
            k, x, z_prev, t, done, iters = c
            t_new = (1 + jnp.sqrt(1 + 4 * t * t)) / 2
            beta = (t - 1) / t_new
            x_new, z, res, rs = full_step(A_, x, z_prev, beta,
                                          done.astype(dtype))
            if restart:
                # the triggering lane's t carry advances from the reset
                # value 1 -> (1+sqrt(5))/2 (immediate semantic)
                phi = jnp.asarray((1 + jnp.sqrt(5.0)) / 2, t_new.dtype)
                t_new = jnp.where(rs > 0, phi, t_new)
            newly_done = res / gamma <= stop_tol
            k = k + 1
            iters = jnp.where(done, iters, k)
            return (k, x_new, z, jnp.where(done, t, t_new),
                    done | newly_done, iters)

        k, x, z, t, done, iters = jax.lax.while_loop(cond, body, init)
        return k, x, z, jnp.where(done, iters, k), done

    # stage 1: bf16 A-stream to warm_tol (init FB step counts as iter 1,
    # matching solve_lasso_batch)
    x0 = jnp.zeros((B, N), dtype)
    z0, res0 = one_step(A16, x0)
    done0 = res0 / gamma <= warm_tol
    k1, x1, z1, it1, _ = fista_stage(
        A16, z0, z0, warm_tol, warm_maxit - 1, jnp.asarray(1, jnp.int32),
        jnp.ones((B,), jnp.int32), done0,
    )

    # stage 2: f32 polish from the warm iterate, Nesterov restart.  Start
    # from z1 (the last prox point — feasible and closest to the fixed
    # point); lanes already below tol at the f32 operator finish in one
    # residual evaluation.
    z2_init, res2 = one_step(A, z1)
    done2 = res2 / gamma <= tol
    k2 = k1 + 1
    it2 = jnp.where(done2, k2, it1)
    k, x, z, iters, done = fista_stage(
        A, z2_init, z2_init, tol, maxit, k2, it2, done2,
    )
    iters = jnp.minimum(iters, maxit + warm_maxit)
    return z, iters, done


def solve_lasso_batch_tail(
    A, b, lam, Lf, tol, maxit=2000, k1=192, tail=64, restart=True,
    use_kernel=None, interpret=False,
):
    """Two-phase batched FISTA: a full-width bulk, then a NARROW
    continuation for the unconverged tail.

    Batched wall time is set by the slowest lane, while the per-iteration
    cost grows with the live batch width.  On the flagship 256-lane batch
    192 iterations leave a few dozen lanes running while the slowest needs
    ~285, so running the last ~90 iterations at full width streams mostly
    finished lanes.  This solver:

    1. runs :func:`solve_lasso_batch` for ``k1`` iterations (same stopping
       rule — converged lanes freeze);
    2. counts the unconverged lanes ON DEVICE (no host sync) and takes a
       ``lax.cond``:
       - if ``<= tail``: gathers the ``tail`` slowest lanes (unconverged
         first, by a stable argsort of the done mask — already-converged
         fill lanes freeze after one residual check) and continues them
         warm-started at width ``tail``;
       - else: continues ALL lanes warm-started at full width (the safe
         fallback — same cost as not tailing, plus ``k1``'s phase-boundary
         restart).
    3. scatters the tail solutions back.

    Everything is traceable (designed to live under ONE outer ``jax.jit``,
    so the whole two-phase solve is a single executable).  Same stopping
    criterion per phase; the warm restart at the phase boundary resets
    Nesterov momentum.  Reported per-lane iteration counts are
    ``k1 + phase2`` for tail lanes — comparable but not identical to the
    single-phase counts.  ``use_kernel``/``interpret`` choose the step as
    in :func:`solve_lasso_batch`.

    Returns ``(xs (B, N), iters (B,), done (B,))``.
    """
    B, M, N = A.shape
    if not 0 < tail <= B:
        raise ValueError(f"tail must be in (0, {B}], got {tail}")
    k1 = min(k1, maxit)  # a small maxit caps phase 1, not the reverse
    # scalar lam/Lf are accepted — the gather below needs (B,) arrays
    lam = jnp.broadcast_to(jnp.asarray(lam, A.dtype), (B,))
    Lf = jnp.broadcast_to(jnp.asarray(Lf, A.dtype), (B,))
    solve = partial(solve_lasso_batch, tol=tol, restart=restart,
                    use_kernel=use_kernel, interpret=interpret)
    xs1, it1, dn1 = solve(A, b, lam, Lf, maxit=k1)
    if k1 >= maxit:
        return xs1, it1, dn1
    n_unconverged = B - jnp.sum(dn1)
    order = jnp.argsort(dn1, stable=True)  # False (unconverged) first
    idx = order[:tail]

    def narrow(_):
        xs2, it2, dn2 = solve(A[idx], b[idx], lam[idx], Lf[idx],
                              maxit=maxit - k1, x0=xs1[idx])
        # keep the CERTIFIED phase-1 solution for fill lanes that were
        # already done — the phase-2 re-check of an at-threshold residual
        # can land just above tol, and phase 2 must not replace a
        # certified iterate with an uncertified one
        xs2 = jnp.where(dn1[idx][:, None], xs1[idx], xs2)
        xs = xs1.at[idx].set(xs2)
        iters = it1.at[idx].add(jnp.where(dn1[idx], 0, it2))
        done = dn1.at[idx].set(dn1[idx] | dn2)
        return xs, iters, done

    def wide(_):
        xs2, it2, dn2 = solve(A, b, lam, Lf, maxit=maxit - k1, x0=xs1)
        xs = jnp.where(dn1[:, None], xs1, xs2)
        iters = jnp.where(dn1, it1, it1 + it2)
        done = dn1 | dn2
        return xs, iters, done

    return jax.lax.cond(n_unconverged <= tail, narrow, wide, None)
