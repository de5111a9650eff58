"""Linear-operator abstraction.

The reference accepts anything supporting ``mul!``/``adjoint`` as the ``A``
argument of f(Ax)+g(x) problems (``src/utilities/fb_tools.jl:21``,
``src/algorithms/panoc.jl:42`` with default ``A = I``).  The JAX
counterpart is a tiny pytree-operator protocol:

* ``matvec(x)``  — A x
* ``rmatvec(y)`` — A^H y
* ``opnorm()``   — ||A||_2 (exact for dense, power-iteration for implicit)

Operators are pytree dataclasses so they pass through jit/vmap; a *batch* of
operators is a stacked pytree.  Sharded variants live in
:mod:`proxtpu.parallel.sharded_ops`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..prox.base import proxclass
from ..utils.precision import pdot


@proxclass
class IdentityOperator:
    """A = I; works on arbitrary pytrees."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def opnorm(self):
        return 1.0


@proxclass
class ZeroOperator:
    """A = 0 (the default ``L = 0*I`` when h is Zero in AFBA,
    ``src/algorithms/primal_dual.jl:84-88``)."""

    def matvec(self, x):
        return jax.tree.map(jnp.zeros_like, x)

    def rmatvec(self, y):
        return jax.tree.map(jnp.zeros_like, y)

    def opnorm(self):
        return 0.0


@proxclass
class MatrixOperator:
    """Dense matrix operator; matvecs are plain (batched) matrix products."""

    A: object

    def matvec(self, x):
        return pdot(self.A, x)

    def rmatvec(self, y):
        return pdot(self.A.conj().T, y)

    def opnorm(self):
        return jnp.linalg.norm(self.A, 2)


@proxclass
class VStackOperator:
    """A = vcat(ops...) : x -> concat([op @ x for op in ops]).

    Used e.g. by the Chambolle-Pock LP formulation with L = [A; I]
    (``test/problems/test_linear_programs.jl:163``).  ``sizes`` are the static
    output lengths of each block.
    """

    ops: tuple

    def matvec(self, x):
        return jnp.concatenate([op.matvec(x) for op in self.ops])

    def rmatvec(self, y):
        sizes = [op.A.shape[0] if hasattr(op, "A") else None for op in self.ops]
        parts, start = [], 0
        out = None
        for op, m in zip(self.ops, sizes):
            if m is None:
                raise ValueError("VStackOperator.rmatvec requires sized blocks")
            part = op.rmatvec(jax.lax.dynamic_slice_in_dim(y, start, m))
            out = part if out is None else out + part
            start += m
        return out

    def opnorm(self):
        # exact: stack dense blocks (all blocks must be dense here)
        mats = [op.A for op in self.ops]
        return jnp.linalg.norm(jnp.concatenate(mats, axis=0), 2)


@proxclass(meta_fields=("shape",))
class Grad2DOperator:
    """Discrete 2-D gradient (forward differences, Neumann boundary).

    Maps an (H, W) image to a (2, H, W) field of (dx, dy) differences; the
    canonical ``L`` of TV-denoising via Chambolle-Pock.  ||L||^2 <= 8.
    """

    shape: tuple

    def matvec(self, x):
        dx = jnp.diff(x, axis=0, append=x[-1:, :])
        dy = jnp.diff(x, axis=1, append=x[:, -1:])
        return jnp.stack([dx, dy])

    def rmatvec(self, y):
        # negative divergence (adjoint of forward differences w/ Neumann bc)
        dx, dy = y[0], y[1]
        dx = dx.at[-1, :].set(0)
        dy = dy.at[:, -1].set(0)
        div_x = jnp.diff(dx, axis=0, prepend=jnp.zeros_like(dx[:1, :]))
        div_y = jnp.diff(dy, axis=1, prepend=jnp.zeros_like(dy[:, :1]))
        return -(div_x + div_y)

    def opnorm(self):
        return jnp.sqrt(8.0)


def as_linop(A):
    """Coerce None / arrays / operators to the operator protocol.

    A :class:`~proxtpu.utils.shared.Shared`-marked operand stays marked:
    the wrapper is re-applied outside the coercion so batched drivers keep
    seeing the lane-invariant annotation."""
    from ..utils.shared import Shared

    if isinstance(A, Shared):
        return Shared(as_linop(A.value))
    if A is None:
        return IdentityOperator()
    if hasattr(A, "matvec"):  # already an operator (may also carry .shape)
        return A
    if isinstance(A, (jnp.ndarray, jax.Array)) or hasattr(A, "shape"):
        return MatrixOperator(jnp.asarray(A))
    return A


def power_iteration_opnorm(op, x_like, iters=50, key=None):
    """Estimate ||A||_2 by power iteration on A^H A (jittable).

    The reference computes exact ``opnorm(L)`` (``primal_dual.jl:342``);
    for implicit/sharded operators we estimate it instead (SURVEY.md §3.3).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    v = jax.tree.map(
        lambda l: jax.random.normal(key, l.shape, jnp.real(l).dtype).astype(l.dtype),
        x_like,
    )

    def body(_, v):
        w = op.rmatvec(op.matvec(v))
        from ..utils.tree import tree_norm, tree_scale

        nrm = tree_norm(w)
        return tree_scale(1 / jnp.where(nrm == 0, 1, nrm), w)

    v = jax.lax.fori_loop(0, iters, body, v)
    from ..utils.tree import tree_norm

    return tree_norm(op.matvec(v)) / jnp.maximum(tree_norm(v), 1e-30)
