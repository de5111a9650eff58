"""proxtpu — a batched, accelerator-native suite of non-smooth first-order solvers.

Built from scratch in JAX (XLA/pjit/Pallas) with the capabilities of
ProximalAlgorithms.jl (reference mounted read-only at /root/reference; see
SURVEY.md for the structural analysis that drives this design).

Layer map (mirrors SURVEY.md §1, re-architected for batched accelerators):

* :mod:`proxtpu.prox`       — function-oracle protocol + prox library (L0)
* :mod:`proxtpu.utils`      — FB toolkit, pytree vector ops, iteration tools (L1)
* :mod:`proxtpu.accel`      — L-BFGS / Anderson / Broyden / Nesterov (L2)
* :mod:`proxtpu.algorithms` — the solver suite + jitted while-loop driver (L3)
* :mod:`proxtpu.ops`        — linear-operator protocol
* :mod:`proxtpu.parallel`   — vmap scenario batching, sharded operators,
  consensus splitting over device meshes (new capabilities)
* :mod:`proxtpu.kernels`    — batched solvers for the hot problem families,
  with the fused GPU step kernel of the distinct-A lasso
"""

from . import accel, algorithms, ops, parallel, prox, utils
from .accel import (
    LBFGS,
    AdaptiveNesterovSequence,
    AdaptiveRestartSequence,
    AndersonAcceleration,
    Broyden,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    NesterovExtrapolation,
    NoAcceleration,
    SimpleNesterovSequence,
)
from .algorithms import *  # noqa: F401,F403
from .prox.base import (
    AutoDifferentiable,
    IndZero,
    Zero,
    convex_conjugate,
    prox,
    value_and_gradient,
)
from .utils.precision import get_matmul_precision, set_matmul_precision
from .utils.shared import Shared
from .utils.fb_tools import (
    backtrack_stepsize,
    f_model,
    lower_bound_smoothness_constant,
)

__version__ = "0.5.0"
