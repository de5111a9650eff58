"""Lane-invariant (shared) problem data for batched solves.

The batched drivers (:mod:`proxtpu.parallel.batch`,
:mod:`proxtpu.parallel.flat_ls`, :mod:`proxtpu.parallel.adaptive_batch`)
map a step function over a *stacked* problem pytree — every array leaf
carries a leading batch axis, and each lane's matvec lowers to one slice of
a batched GEMV.  But the most common batched workloads share their largest
operand across lanes: a regularization-path sweep shares (A, b) and varies
``lam``; a multi-right-hand-side solve shares A and varies b.  Stacking B
identical copies of A wastes device memory *and* bandwidth — XLA sees a
batched dot_general and streams the operand B times, where a lane-invariant
A makes the very same step a single ``(B, n) @ (n, m)`` matmul.

``Shared(obj)`` marks a problem object (a function, a linear operator, or
any pytree) as identical across lanes.  It is:

* a registered pytree node — it traces through ``jit`` and survives inside
  iteration objects built by the algorithm factories;
* a transparent attribute/call proxy — ``Shared(f).value_and_gradient``,
  ``Shared(A).matvec``, ``is_convex(Shared(f))`` all delegate to the
  wrapped object, so every oracle and trait in the library works unchanged;
* an axis marker — :func:`batch_axes` builds the ``jax.vmap`` ``in_axes``
  pytree that maps ordinary leaves over axis 0 and leaves Shared subtrees
  unmapped (``None``), which is what turns the per-lane matvec into one
  matmul.

Mixed sharing (e.g. shared design matrix, per-lane right-hand side) is
expressed through the explicit-composition API the algorithms already have:
``PANOC`` solves ``f(A x) + g(x)``, so pass ``A=Shared(op)`` with a batched
``f`` — no per-leaf marking needed.

The reference has no batching at all (SURVEY.md §2.6); this is a batched-build
capability.  The closest reference analogue is its genericity over implicit
operators (``fb_tools.jl:21-22``), which Shared preserves: anything with
``matvec``/``rmatvec`` can be shared.
"""

from __future__ import annotations

import jax

__all__ = ["Shared", "batch_axes", "unwrap_shared", "lane_arrays"]


class Shared:
    """Mark a problem object as identical across batch lanes.

    Wrap a whole function/operator object: ``Shared(LeastSquaresLoss(A, b))``,
    ``Shared(MatrixOperator(A))``.  All attribute access and calls delegate
    to the wrapped value, and the batched drivers map it with
    ``in_axes=None`` so XLA sees the lane-invariant operand once.
    """

    __slots__ = ("value",)

    def __init__(self, value):
        object.__setattr__(self, "value", value)

    def __getattr__(self, name):
        if name in ("value", "__setstate__", "__getstate__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "value"), name)

    def __call__(self, *args, **kwargs):
        return object.__getattribute__(self, "value")(*args, **kwargs)

    def __repr__(self):
        return f"Shared({object.__getattribute__(self, 'value')!r})"


def _shared_flatten(s):
    return (object.__getattribute__(s, "value"),), None


def _shared_unflatten(aux, children):
    return Shared(children[0])


jax.tree_util.register_pytree_node(Shared, _shared_flatten, _shared_unflatten)


def _is_shared(x):
    return isinstance(x, Shared)


def batch_axes(tree, axis=0):
    """``jax.vmap``-style ``in_axes`` pytree for a possibly-Shared tree.

    Ordinary leaves map over ``axis``; every subtree under a
    :class:`Shared` node is unmapped (``None``).  A top-level ``Shared``
    returns plain ``None``.  The result depends only on the treedef, so it
    is safe to compute at trace time inside ``jit``.
    """
    if isinstance(tree, Shared):
        return None
    return jax.tree.map(
        lambda x: None if isinstance(x, Shared) else axis,
        tree,
        is_leaf=_is_shared,
    )


def unwrap_shared(tree):
    """Strip every :class:`Shared` wrapper (one level), returning the plain
    pytree — e.g. to run a single lane of a shared problem."""
    if isinstance(tree, Shared):
        return object.__getattribute__(tree, "value")
    return jax.tree.map(
        lambda x: object.__getattribute__(x, "value") if isinstance(x, Shared)
        else x,
        tree,
        is_leaf=_is_shared,
    )


def lane_arrays(tree):
    """The leaves of ``tree`` that carry a batch axis (i.e. are NOT under a
    Shared node) — what shape-validation in the dispatch matchers checks."""
    nodes = jax.tree.leaves(tree, is_leaf=_is_shared)
    return [n for n in nodes if not isinstance(n, Shared)]
