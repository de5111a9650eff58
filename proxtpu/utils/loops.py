"""Loop lowerings for data-dependent-but-bounded searches.

A ``lax.while_loop`` nested inside a vmapped solver step can compile
pathologically slowly (minutes-to-hours even at tiny shapes — seen for both
the gamma-backtracking and the tau-linesearch loops).  Every such
search in this library is *bounded* (``max_backtracks`` for the
tau-searches, the ``minimum_gamma`` floor for gamma), so it can be lowered
as a fixed-trip ``fori_loop`` whose body is masked by the original
condition: once the while-loop would have exited, later trips compute and
discard.  Results are identical whenever the while-loop exits within the
trip bound — which the bound guarantees here — and the fixed-trip form
compiles like any other loop under vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bounded_while(cond, body, init, max_trips):
    """``lax.while_loop(cond, body, init)`` lowered as ``max_trips`` masked
    fori trips.  ``max_trips=None`` keeps the plain while_loop (cheapest for
    single-problem solves: zero body evaluations once the condition fails).
    """
    if max_trips is None:
        return jax.lax.while_loop(cond, body, init)

    def masked(_, c):
        new = body(c)
        keep = cond(c)
        return jax.tree.map(
            lambda o, n: jnp.where(keep, n, o), c, new
        )

    return jax.lax.fori_loop(0, int(max_trips), masked, init)
