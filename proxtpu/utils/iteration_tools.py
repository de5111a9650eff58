"""Iterator combinators over eager state streams.

The reference's ``IterationTools`` module (``src/utilities/iteration_tools.jl``:
``halt``, ``tee``, ``sample``, ``stopwatch``, ``loop``) powers its
verbosity/termination mechanics.  The batched build's hot path is the jitted
``lax.while_loop`` driver, which never materializes intermediate states; these
combinators serve the *power-user* path instead — the eager generator of
states from :func:`proxtpu.algorithms.core.states` — for debugging,
visualization and custom stopping logic, with identical semantics to the
reference.
"""

from __future__ import annotations

import time

import jax


def halt(iterable, fun):
    """Yield items until ``fun(item)`` is true; the triggering item is the
    last one yielded (``iteration_tools.jl:9-40``)."""
    for item in iterable:
        yield item
        if fun(item):
            return


def tee(iterable, fun):
    """Call ``fun(item)`` on every item as a side effect
    (``iteration_tools.jl:44-64``)."""
    for item in iterable:
        fun(item)
        yield item


def sample(iterable, period):
    """Yield every ``period``-th item (``iteration_tools.jl:68-100``)."""
    for k, item in enumerate(iterable, start=1):
        if k % period == 0:
            yield item


def stopwatch(iterable):
    """Pair every item with nanoseconds elapsed since iteration started
    (``iteration_tools.jl:104-133``)."""
    t0 = time.perf_counter_ns()
    for item in iterable:
        yield (time.perf_counter_ns() - t0, item)


def loop(iterable):
    """Drain the iterable, returning the last item
    (``iteration_tools.jl:137-145``)."""
    item = None
    for item in iterable:
        pass
    return item


class Counting:
    """Oracle-call counting wrapper (the cost metric of this domain).

    Mirrors the ``Counting`` wrapper of the reference docs
    (``docs/src/guide/custom_objectives.jl:99-137``) with trace-aware
    semantics: under ``jit`` every oracle is traced once per compiled step,
    so the counters report *calls per iteration*; multiply by the iteration
    count for totals.  In eager mode (or through :func:`states`) they count
    every actual call, exactly like the reference.
    """

    def __init__(self, f, _store=None):
        self.f = f
        self._store = _store if _store is not None else _CountStore()

    @property
    def eval_count(self):
        return self._store.eval

    @property
    def gradient_count(self):
        return self._store.gradient

    @property
    def prox_count(self):
        return self._store.prox

    @property
    def is_convex(self):
        return bool(getattr(self.f, "is_convex", False))

    @property
    def is_generalized_quadratic(self):
        return bool(getattr(self.f, "is_generalized_quadratic", False))

    def __call__(self, x):
        self._store.eval += 1
        return self.f(x)

    def value_and_gradient(self, x):
        self._store.gradient += 1
        from ..prox.base import value_and_gradient

        return value_and_gradient(self.f, x)

    def prox(self, x, gamma):
        self._store.prox += 1
        from ..prox.base import prox

        return prox(self.f, x, gamma)

    def reset(self):
        self._store.eval = self._store.gradient = self._store.prox = 0


class _CountStore:
    """Shared mutable counters (hashable by identity, so it can live in the
    static half of the pytree; every unflattened Counting copy points back at
    the same store, which is how counts survive jit round-trips without
    mutating the original wrapper)."""

    __slots__ = ("eval", "gradient", "prox")

    def __init__(self):
        self.eval = self.gradient = self.prox = 0


def _counting_flatten(c):
    return (c.f,), c._store


def _counting_unflatten(store, children):
    return Counting(children[0], _store=store)


jax.tree_util.register_pytree_node(
    Counting, _counting_flatten, _counting_unflatten
)
