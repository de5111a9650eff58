"""Batched box-constrained QP projected gradient.

Per problem lane i:

    z_i = clip(x_i - gamma_i * (Q_i x_i + q_i), lo, hi)
    res_i = ||x_i - z_i||_inf

the projected-gradient step of the nonconvex box-QP family
(``test/problems/test_nonconvex_qp.jl``), run as one batched matvec per
iteration in XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def reference_pg_box_step(Q, q, x, gamma, lo, hi):
    """One batched projected-gradient step ``(z, res_inf)``."""
    grad = jnp.einsum("bij,bj->bi", Q, x,
                      precision=jax.lax.Precision.HIGHEST) + q
    z = jnp.clip(x - gamma[:, None] * grad, lo[:, None], hi[:, None])
    return z, jnp.max(jnp.abs(x - z), axis=1)


@partial(jax.jit, static_argnames=("maxit",))
def solve_box_qp_batch(Q, q, lo, hi, Lip, tol, maxit=10_000, x0=None):
    """Batched projected-gradient solver for box QPs.

    ``gamma = 0.95 / Lip`` per lane (the nonconvex-QP test convention);
    stopping rule ``||x - z||_inf / gamma <= tol`` with per-lane freezing.
    """
    B, n, _ = Q.shape
    dtype = Q.dtype
    gamma = (0.95 / jnp.asarray(Lip)).astype(dtype)
    gamma = jnp.broadcast_to(gamma, (B,))
    lo_v = jnp.broadcast_to(jnp.asarray(lo, dtype), (B,))
    hi_v = jnp.broadcast_to(jnp.asarray(hi, dtype), (B,))
    x0 = jnp.zeros((B, n), dtype) if x0 is None else \
        jnp.asarray(x0, dtype).reshape(B, n)
    z0, res0 = reference_pg_box_step(Q, q, x0, gamma, lo_v, hi_v)
    done0 = res0 / gamma <= tol
    init = (jnp.asarray(1, jnp.int32), z0, done0, jnp.ones((B,), jnp.int32))

    def cond(c):
        k, x, done, iters = c
        return (k < maxit) & jnp.logical_not(jnp.all(done))

    def body(c):
        k, x, done, iters = c
        z, res = reference_pg_box_step(Q, q, x, gamma, lo_v, hi_v)
        newly_done = res / gamma <= tol
        x = jnp.where(done[:, None], x, z)
        k = k + 1
        iters = jnp.where(done, iters, k)
        return (k, x, done | newly_done, iters)

    k, x, done, iters = jax.lax.while_loop(cond, body, init)
    iters = jnp.where(done, iters, k)
    return x, iters, done
