"""Batched TV denoising by Chambolle-Pock.

The TV workload solves

    min_x  ||x - b||^2 / 2 + lam * ||grad x||_{2,1}

per image via Chambolle-Pock = AFBA(theta=2, f=0, l=Ind0)
(``/root/reference/src/algorithms/primal_dual.jl:157-158``; step algebra at
lines 173-211).  With theta=2 and lam_relax=1 the update degenerates to the
textbook CP iteration:

    xbar = prox_g(x - g1 * L^T y)            g = ||. - b||^2/2
    ybar = proj_{|.|<=lam}(y + g2 * L (2 xbar - x))   (prox of (lam|.|_{2,1})^*)
    x, y <- xbar, ybar

where L is the forward-difference 2-D gradient (Neumann boundary,
:class:`proxtpu.ops.linops.Grad2DOperator`) and the dual prox is the
pointwise projection onto the radius-lam 2-ball (the Moreau route the
generic driver takes through ``convex_conjugate(NormL21)`` — identical
math).

:func:`solve_tv_batch` runs the step as plain XLA (the roll/mask stencil
chain fuses into a few elementwise kernels) and advances ``iter_block``
iterations per while-loop trip.  Stopping rule matches the AFBA driver:
``||xbar - x||_inf + ||ybar - y||_inf <= tol``, sampled once per trip
(counts are an upper bound).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def reference_cp_step(b, x, yx, yy, g1, g2, lam):
    """One batched CP iteration with roll+mask stencils:
    ``(xbar, ybar_x, ybar_y, res)``."""
    H, W = b.shape[1], b.shape[2]
    row_mask = (jnp.arange(H) < H - 1).astype(b.dtype)[None, :, None]
    col_mask = (jnp.arange(W) < W - 1).astype(b.dtype)[None, None, :]
    g1b = g1[:, None, None]
    g2b = g2[:, None, None]
    lamb = lam[:, None, None]

    dxm = yx * row_mask
    dym = yy * col_mask
    div = (dxm - jnp.roll(dxm, 1, axis=1)) + (dym - jnp.roll(dym, 1, axis=2))
    t = x + g1b * div
    xbar = (t + g1b * b) / (1 + g1b)
    mid = 2 * xbar - x
    gx = (jnp.roll(mid, -1, axis=1) - mid) * row_mask
    gy = (jnp.roll(mid, -1, axis=2) - mid) * col_mask
    vx = yx + g2b * gx
    vy = yy + g2b * gy
    nrm = jnp.sqrt(vx * vx + vy * vy)
    scale = jnp.where(nrm > lamb, lamb / jnp.maximum(nrm, 1e-30), 1.0)
    ybx = vx * scale
    yby = vy * scale
    res = jnp.max(jnp.abs(xbar - x), axis=(1, 2)) + jnp.maximum(
        jnp.max(jnp.abs(ybx - yx), axis=(1, 2)),
        jnp.max(jnp.abs(yby - yy), axis=(1, 2)),
    )
    return xbar, ybx, yby, res


def _diff_matrix(n, dtype):
    """The (n, n) forward-difference matrix D: D[i,i] = -1, D[i,i+1] = +1
    for i < n-1, last row zero (the Neumann boundary is the zero row, so
    ``D @ U`` IS the masked forward difference and ``D^T`` the masked
    backward-difference adjoint — no separate boundary masks needed)."""
    d = np.zeros((n, n), np.float64)
    i = np.arange(n - 1)
    d[i, i] = -1.0
    d[i, i + 1] = 1.0
    return jnp.asarray(d, dtype)


def mxu_cp_step(b, x, yx, yy, g1, g2, lam, Dh=None, Dw=None):
    """One batched CP iteration with the gradient stencil as matmuls.

    Identical math to :func:`reference_cp_step`, but the four roll+mask
    stencils are expressed as batched contractions against bidiagonal
    difference matrices:  ``grad = (Dh @ U, U @ Dw^T)`` and
    ``L^T y = Dh^T @ Yx + Yy @ Dw``.  Contractions run at the library
    matmul precision (:func:`proxtpu.utils.precision.get_matmul_precision`)
    so reduced-precision passes cannot stall the fixed point.
    """
    from ..utils.precision import get_matmul_precision

    H, W = b.shape[1], b.shape[2]
    dtype = b.dtype
    if Dh is None:
        Dh = _diff_matrix(H, dtype)
    if Dw is None:
        Dw = _diff_matrix(W, dtype)
    prec = get_matmul_precision()
    g1b = g1[:, None, None]
    g2b = g2[:, None, None]
    lamb = lam[:, None, None]

    # L^T y = Dh^T @ Yx + Yy @ Dw  (div = -L^T y)
    lty = jnp.einsum("kh,bkw->bhw", Dh, yx, precision=prec) + jnp.einsum(
        "bhk,kw->bhw", yy, Dw, precision=prec
    )
    t = x - g1b * lty
    xbar = (t + g1b * b) / (1 + g1b)
    mid = 2 * xbar - x
    gx = jnp.einsum("hk,bkw->bhw", Dh, mid, precision=prec)
    gy = jnp.einsum("bhk,wk->bhw", mid, Dw, precision=prec)
    vx = yx + g2b * gx
    vy = yy + g2b * gy
    nrm = jnp.sqrt(vx * vx + vy * vy)
    scale = jnp.where(nrm > lamb, lamb / jnp.maximum(nrm, 1e-30), 1.0)
    ybx = vx * scale
    yby = vy * scale
    res = jnp.max(jnp.abs(xbar - x), axis=(1, 2)) + jnp.maximum(
        jnp.max(jnp.abs(ybx - yx), axis=(1, 2)),
        jnp.max(jnp.abs(yby - yy), axis=(1, 2)),
    )
    return xbar, ybx, yby, res


def default_tv_stepsizes(dtype=jnp.float32):
    """The AFBA theta=2 default stepsizes for L = Grad2D (||L|| = sqrt(8),
    beta_f = beta_l = 0): g1 = 1/||L||, g2 = 0.99/||L||
    (``primal_dual.jl:334-427`` Vu-Condat branch)."""
    nmL = 8.0 ** 0.5
    return 1.0 / nmL, 0.99 / nmL


@partial(
    jax.jit,
    static_argnames=("maxit", "iter_block", "return_dual", "formulation"),
)
def solve_tv_batch(b, lam, tol, maxit=5000, iter_block=8, gamma1=None,
                   gamma2=None, return_dual=False, formulation="roll",
                   x0=None, y0=None):
    """Batched TV denoising by iteration-blocked Chambolle-Pock.

    Matches the generic vmapped AFBA/CP driver's trajectory and stopping
    rule (``||FPR_x||_inf + ||FPR_y||_inf <= tol``); one while-loop trip
    runs ``iter_block`` iterations and convergence is sampled at the end
    of each trip, so per-lane counts are an upper bound (lanes are never
    reported converged before they are), and the iteration count includes
    the init step — iteration 1 — exactly like the driver.

    ``lam``/``gamma1``/``gamma2`` may be scalars or per-image (B,) vectors.

    ``formulation`` selects the step: ``"roll"`` (shift+mask stencils,
    :func:`reference_cp_step`) or ``"mxu"`` (:func:`mxu_cp_step`,
    bidiagonal-matmul stencils).

    Returns ``(x, iters, done)``, or ``((x, y), iters, done)`` with the
    (B, 2, H, W) dual field when ``return_dual=True`` — the same solution
    structure as the generic AFBA driver's ``default_solution``
    (``(xbar, ybar)``), which the kernel dispatch layer requires.
    """
    B, H, W = b.shape
    dtype = b.dtype
    g1d, g2d = default_tv_stepsizes(dtype)
    g1 = jnp.broadcast_to(
        jnp.asarray(g1d if gamma1 is None else gamma1, dtype), (B,)
    )
    g2 = jnp.broadcast_to(
        jnp.asarray(g2d if gamma2 is None else gamma2, dtype), (B,)
    )
    lam_v = jnp.broadcast_to(jnp.asarray(lam, dtype), (B,))

    if formulation == "mxu":
        Dh = _diff_matrix(H, dtype)
        Dw = _diff_matrix(W, dtype)
        one_step = lambda b_, x, yx, yy: mxu_cp_step(
            b_, x, yx, yy, g1, g2, lam_v, Dh=Dh, Dw=Dw
        )
    else:
        one_step = lambda b_, x, yx, yy: reference_cp_step(
            b_, x, yx, yy, g1, g2, lam_v
        )

    def step_fn(b_, x, yx, yy, K):
        def one(_, c):
            x, yx, yy, _ = c
            return one_step(b_, x, yx, yy)

        return jax.lax.fori_loop(
            0, K, one, (x, yx, yy, jnp.zeros((B,), dtype)),
        )

    # warm start: x0 is the primal image, y0 the (B, 2, H, W) dual field
    # (the shape return_dual emits, so a previous solve re-enters directly)
    x0 = jnp.zeros((B, H, W), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, H, W)
    if y0 is None:
        yx0 = yy0 = jnp.zeros((B, H, W), dtype)
    else:
        y0 = jnp.asarray(y0, dtype).reshape(B, 2, H, W)
        yx0, yy0 = y0[:, 0], y0[:, 1]
    # init = one driver step (iteration 1)
    x, yx, yy, res = step_fn(b, x0, yx0, yy0, 1)
    done0 = res <= tol
    init = (jnp.asarray(1, jnp.int32), x, yx, yy, done0,
            jnp.ones((B,), jnp.int32))
    K = iter_block

    def cond(c):
        return (c[0] < maxit) & jnp.logical_not(jnp.all(c[4]))

    def body(c):
        k, x, yx, yy, done, iters = c
        xn, yxn, yyn, res = step_fn(b, x, yx, yy, K)
        keep = done[:, None, None]
        x = jnp.where(keep, x, xn)
        yx = jnp.where(keep, yx, yxn)
        yy = jnp.where(keep, yy, yyn)
        k = k + K
        newly_done = res <= tol
        iters = jnp.where(done, iters, k)
        return (k, x, yx, yy, done | newly_done, iters)

    k, x, yx, yy, done, iters = jax.lax.while_loop(cond, body, init)
    iters = jnp.minimum(jnp.where(done, iters, k), maxit)
    if return_dual:
        return (x, jnp.stack([yx, yy], axis=1)), iters, done
    return x, iters, done
