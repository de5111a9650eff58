"""Type-I Anderson acceleration with fixed-shape ring buffers.

Port of ``/root/reference/src/accel/anderson.jl``: memory-M ring buffers of
(s, y) pairs with no curvature condition, applying

    d = v + (S - Y) pinv(Y^H Y) Y^H v            (``anderson.jl:49-60``)

The reference materialises S/Y by hcat-ing only the active columns; here the
buffers are fixed (n, M) matrices whose inactive columns are zero — the
pseudo-inverse annihilates the corresponding zero rows/cols, so no dynamic
shapes are needed.  The reference's dense ``pinv(Y'Y)`` (marked
``# TODO: optimize``) is kept as an M×M pinv, which is tiny and fine on an accelerator.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..prox.base import proxclass
from .base import QUASI_NEWTON
from .flatten import flatten_like, unflatten_like


class AndersonState(NamedTuple):
    S: jnp.ndarray  # (n, M)
    Y: jnp.ndarray  # (n, M)
    currmem: jnp.ndarray
    curridx: jnp.ndarray


@proxclass(meta_fields=("mem",))
class AndersonAcceleration:
    mem: int = 5

    style = QUASI_NEWTON

    def init_state(self, x):
        flat, _ = flatten_like(x)
        n = flat.shape[0]
        M = self.mem
        return AndersonState(
            S=jnp.zeros((n, M), flat.dtype),
            Y=jnp.zeros((n, M), flat.dtype),
            currmem=jnp.zeros((), jnp.int32),
            curridx=jnp.zeros((), jnp.int32),
        )

    def reset(self, state):
        return state._replace(
            S=jnp.zeros_like(state.S),
            Y=jnp.zeros_like(state.Y),
            currmem=jnp.zeros((), jnp.int32),
            curridx=jnp.zeros((), jnp.int32),
        )

    def update(self, state, s, y):
        M = self.mem
        s_flat, _ = flatten_like(s)
        y_flat, _ = flatten_like(y)
        slot = state.curridx % M
        return AndersonState(
            S=state.S.at[:, slot].set(s_flat),
            Y=state.Y.at[:, slot].set(y_flat),
            currmem=jnp.minimum(state.currmem + 1, M),
            curridx=slot + 1,
        )

    def apply(self, state, v):
        v_flat, spec = flatten_like(v)
        # Column-normalize Y before the M x M pinv solve: algebraically the
        # same coefficients, but far better conditioned in float32 (the
        # reference forms pinv(Y'Y) directly, ``anderson.jl:57``).
        col = jnp.sqrt(jnp.real(jnp.sum(state.Y.conj() * state.Y, axis=0)))
        scale = jnp.where(col == 0, 1, col)
        Yn = state.Y / scale[None, :].astype(state.Y.dtype)
        G = Yn.conj().T @ Yn
        rhs = Yn.conj().T @ v_flat
        coef = (jnp.linalg.pinv(G) @ rhs) / scale.astype(state.Y.dtype)
        d = v_flat + (state.S - state.Y) @ coef
        # fresh operator acts as the identity (``anderson.jl:52-53``)
        d = jnp.where(state.currmem == 0, v_flat, d)
        return unflatten_like(d, spec)
