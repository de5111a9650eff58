"""Function-oracle protocol (the ProximalCore.jl equivalent, in JAX).

The whole solver suite is written against two oracles, mirroring the protocol
the reference is built on (``/root/reference/src/ProximalAlgorithms.jl:5-6``,
``docs/src/guide/custom_objectives.jl:13,54-61``):

* ``prox(f, x, gamma) -> (z, f_z)`` — proximal mapping plus the function value
  at the prox point;
* ``value_and_gradient(f, x) -> (f_x, grad_f_x)`` — smooth-term oracle.

Functions are frozen dataclasses registered as JAX pytrees: array parameters
(weights, offsets) are pytree *leaves* so they trace through ``jit``/``vmap``,
while class-level traits are static.  The reference's compile-time traits
``is_convex``/``is_generalized_quadratic`` (``src/algorithms/drls.jl:15,20``,
``src/algorithms/panoc.jl:217``) become static Python attributes resolved at
trace time, so they select code paths with zero runtime cost.

Complex-gradient convention: JAX's ``jax.grad`` of a real-valued function of a
complex input returns the *conjugate* of the Wirtinger-style gradient that
Julia/Zygote produce.  ``value_and_gradient`` conjugates it back so that
``x - gamma * grad`` is always a descent step, matching the reference
semantics exactly (verified against ``test/utilities/test_ad.jl``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..utils.tree import tree_zeros_like


def proxclass(cls=None, *, meta_fields=()):
    """Decorator: frozen dataclass registered as a JAX pytree.

    Fields listed in ``meta_fields`` are static (hashable, part of the treedef);
    everything else is a data leaf and traces through jit/vmap.
    """

    if cls is None:
        return partial(proxclass, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


# ---------------------------------------------------------------------------
# traits


def is_convex(f) -> bool:
    return bool(getattr(f, "is_convex", False))


def is_generalized_quadratic(f) -> bool:
    return bool(getattr(f, "is_generalized_quadratic", False))


def is_smooth(f) -> bool:
    return hasattr(f, "value_and_gradient") or callable(f)


# ---------------------------------------------------------------------------
# oracles


def prox(g, x, gamma):
    """Proximal mapping: argmin_z g(z) + ||z - x||^2 / (2 gamma).

    Returns ``(z, g_z)``: the prox point and the function value there
    (mirrors ``ProximalCore.prox``).
    """
    return g.prox(x, gamma)


def _conj_if_complex(grad):
    return jax.tree.map(
        lambda l: jnp.conj(l) if jnp.iscomplexobj(l) else l, grad
    )


def value_and_gradient(f, x):
    """Value and gradient of a smooth term.

    Dispatch order (mirrors the reference's method-extension seam,
    ``src/ProximalAlgorithms.jl:27-40``):

    1. ``f.value_and_gradient(x)`` if the object provides a hand-written
       oracle (the ``Quadratic`` fixture in ``test/runtests.jl:13-16`` and
       the benchmark overloads in ``benchmark/benchmarks.jl:11-27`` rely on
       this being overridable);
    2. otherwise automatic differentiation via ``jax.value_and_grad``,
       conjugated for complex inputs to match the Zygote convention.
    """
    vag = getattr(f, "value_and_gradient", None)
    if vag is not None:
        return vag(x)
    val, grad = jax.value_and_grad(lambda u: f(u))(x)
    return val, _conj_if_complex(grad)


# ---------------------------------------------------------------------------
# the two ProximalCore primitives


@proxclass
class Zero:
    """The identically-zero function; prox is the identity.

    Reference: ``ProximalCore.Zero`` — the default objective term of every
    algorithm (e.g. ``src/algorithms/forward_backward.jl:39-40``).
    """

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        from ..utils.tree import real_dtype_of

        return jnp.zeros((), real_dtype_of(x))

    def value_and_gradient(self, x):
        return self(x), tree_zeros_like(x)

    def prox(self, x, gamma):
        return x, self(x)


@proxclass
class IndZero:
    """Indicator of the singleton {0}; prox maps everything to 0.

    Reference: ``ProximalCore.IndZero`` — the default ``l`` term of the
    primal-dual algorithm (``src/algorithms/primal_dual.jl:84``).
    """

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        from ..utils.tree import real_dtype_of, tree_inf_norm

        R = real_dtype_of(x)
        return jnp.where(
            tree_inf_norm(x) == 0, jnp.zeros((), R), jnp.asarray(jnp.inf, R)
        )

    def prox(self, x, gamma):
        from ..utils.tree import real_dtype_of

        return tree_zeros_like(x), jnp.zeros((), real_dtype_of(x))


@proxclass(meta_fields=("fn",))
class AutoDifferentiable:
    """Wrap a plain callable as a smooth term differentiated with jax.grad.

    Mirrors ``ProximalAlgorithms.AutoDifferentiable`` — the AD backend
    argument collapses away because JAX *is* the backend
    (``src/ProximalAlgorithms.jl:20-25``).
    """

    fn: object

    def __call__(self, x):
        return self.fn(x)

    def value_and_gradient(self, x):
        val, grad = jax.value_and_grad(self.fn)(x)
        return val, _conj_if_complex(grad)


def convex_conjugate(f):
    """Convex conjugate f*(y) = sup_x <y,x> - f(x).

    Special-cases the Zero/IndZero pair (they are conjugate to each other),
    otherwise returns a :class:`~proxtpu.prox.combinators.Conjugate` wrapper
    whose prox is computed through the Moreau decomposition.
    Reference: ``ProximalCore.convex_conjugate`` used at
    ``src/algorithms/primal_dual.jl:187,194``.
    """
    if isinstance(f, Zero):
        return IndZero()
    if isinstance(f, IndZero):
        return Zero()
    from .combinators import Conjugate
    from .functions import SqrNormL2

    if isinstance(f, Conjugate):
        return f.f
    if isinstance(f, SqrNormL2):
        # (lam/2 ||x||^2)* = 1/(2 lam) ||y||^2 — keeps the conjugate smooth,
        # which AFBA requires of l* (``primal_dual.jl:187``)
        return SqrNormL2(1 / f.lam)
    return Conjugate(f)
