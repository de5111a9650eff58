"""Direction-strategy protocol (the src/accel trait layer, in JAX).

The reference dispatches line-search direction computation through an
``acceleration_style`` trait (``src/accel/traits.jl:1-11``) with three
styles.  Here a strategy is a *static* frozen dataclass (hashable — it lives
in the static part of an iteration's pytree) exposing:

* ``style``                      — "quasi_newton" | "nesterov" | "none"
* ``init_state(x)``              — fixed-shape pytree of buffers
* quasi-Newton: ``apply(state, v) -> H v``, ``update(state, s, y) -> state``,
  ``reset(state) -> state``
* nesterov: ``next_coeff(state) -> (beta, state)``

All state transitions are pure and fixed-shape, so they live inside jitted
``lax.while_loop`` carries and batch transparently under ``vmap``.
"""

from __future__ import annotations

QUASI_NEWTON = "quasi_newton"
NESTEROV = "nesterov"
NO_ACCELERATION = "none"


def acceleration_style(strategy) -> str:
    return getattr(strategy, "style", NO_ACCELERATION)
