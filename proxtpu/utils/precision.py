"""Matmul precision policy for convergence-critical matvecs.

A float32 matrix product may run at reduced precision by default (TF32 on
a GPU's tensor cores, about three decimal digits), which stalls fixed-point
iterations around 1e-3 — solvers then never reach tolerances like 1e-6.
Every dense matvec in the library therefore routes through :func:`pdot`,
which pins ``Precision.HIGHEST`` by default: full float32 on the GPU, with
no TF32.

Lower it globally with :func:`set_matmul_precision` ("default" lets the
backend pick its fastest float32 product for applications that only need
coarse solutions; "high" is the middle ground).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PRECISION = jax.lax.Precision.HIGHEST

_NAMES = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def set_matmul_precision(precision):
    """Set the library-wide matvec precision ("default" | "high" | "highest"
    or a ``jax.lax.Precision``).  Returns the previous setting.

    The setting is read at *trace* time, so already-compiled programs would
    silently keep the old precision; to make the change take effect
    immediately this drops JAX's compilation caches (``jax.clear_caches``)
    whenever the value actually changes.  Subsequent solver calls recompile
    at the new precision.
    """
    global _PRECISION
    prev = _PRECISION
    if isinstance(precision, str):
        precision = _NAMES[precision]
    _PRECISION = precision
    if precision is not prev:
        # The global is not part of any jit cache key; invalidate compiled
        # code that baked in the previous precision.
        jax.clear_caches()
    return prev


def get_matmul_precision():
    return _PRECISION


def pdot(a, b):
    """Precision-pinned matmul/matvec: ``a @ b`` at the library precision."""
    return jnp.matmul(a, b, precision=_PRECISION)


def pmatvec(a, x):
    """Precision-pinned matvec with matching leading batch dims:
    ``a[..., i, j] x[..., j] -> y[..., i]`` when ``x`` has one fewer dim
    than ``a`` (the vector/batched-vector case), plain ``matmul``
    otherwise (matrix-valued iterates: ``(n, n) @ (n, k)``, batched
    ``(B, n, n) @ (B, n, k)``).

    Rationale: ``jnp.matmul`` treats a 2-D second operand as a matrix, so
    an eagerly stacked ``(B, n, n) @ (B, n)`` (e.g. a batched
    :class:`Quadratic` built outside ``vmap``) mis-contracts — that case
    (``x.ndim == a.ndim - 1``) routes through einsum.  When ``x.ndim >=
    a.ndim`` the operand IS a matrix (or matrix stack) and matmul
    semantics are what the caller means — this preserves the pre-existing
    support for matrix iterates.  The one shape this cannot disambiguate
    is a *shared* 2-D ``a`` against an eagerly stacked ``(B, n)`` vector
    batch, which reads as an ``(n, B)``-matrix contraction; express that
    as a stacked/``Shared`` operand or per-lane ``vmap`` instead."""
    a = jnp.asarray(a)
    x = jnp.asarray(x)
    if x.ndim >= a.ndim:
        return jnp.matmul(a, x, precision=_PRECISION)
    return jnp.einsum("...ij,...j->...i", a, x, precision=_PRECISION)
