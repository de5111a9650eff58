"""Parallel execution: scenario batching, sharded operators, consensus.

These are *new* capabilities relative to the reference, which has no
parallelism of any kind (SURVEY.md §2.6).  Three orthogonal axes:

* **batch** (the domain's "DP"): vmap a stacked pytree of problem instances
  — thousands of lasso/QP solves per device, per-lane convergence masks;
* **sharded_ops** ("TP"): shard a huge A over mesh axes; XLA emits the
  psum/all-gather collectives for ``A x`` / ``A^H y``;
* **consensus** ("PP/EP" analogue): consensus-ADMM over blocks sharded
  across devices, coupling through one mean collective per iteration.
"""

from ..utils.shared import Shared, batch_axes, unwrap_shared
from .adaptive_batch import (
    batched_adaptive_fb,
    batched_adaptive_fista,
)
from .flat_ls import (
    batched_drls,
    batched_panoc,
    batched_panocplus,
    batched_zerofpr,
)
from .batch import (
    BatchedAlgorithm,
    batch_problems,
    batched_run_loop,
    batched_run_recorded,
    batched_run_segments,
    broadcast_hyperparams,
    compacting_batched_run,
    stack_iterations,
)
from .distributed import global_mesh, initialize_distributed
from .consensus import (
    ConsensusADMM,
    ConsensusADMMIteration,
    make_consensus_admm_iteration,
    stack_functions,
)
from .sharded_ops import (
    ShardedMatrixOperator,
    make_mesh,
    replicate,
    shard_batch,
    shard_matrix_operator,
)
from .warm import (
    WarmStartedAlgorithm,
    WarmStartedBatchedAlgorithm,
    cast_problem,
)
from .stream import stream_solve
from .sharded_kernels import (
    default_dp_mesh,
    sharded_solve_box_qp_batch,
    sharded_solve_lasso_batch,
    sharded_solve_lasso_multirhs,
    sharded_solve_tv_batch,
)

__all__ = [
    "BatchedAlgorithm",
    "WarmStartedAlgorithm",
    "WarmStartedBatchedAlgorithm",
    "cast_problem",
    "Shared",
    "batch_axes",
    "unwrap_shared",
    "batched_adaptive_fb",
    "batched_adaptive_fista",
    "batched_drls",
    "batched_panoc",
    "batched_panocplus",
    "batched_zerofpr",
    "batch_problems",
    "batched_run_loop",
    "batched_run_recorded",
    "batched_run_segments",
    "broadcast_hyperparams",
    "compacting_batched_run",
    "stack_iterations",
    "ConsensusADMM",
    "ConsensusADMMIteration",
    "make_consensus_admm_iteration",
    "stack_functions",
    "ShardedMatrixOperator",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_matrix_operator",
    "global_mesh",
    "initialize_distributed",
    "default_dp_mesh",
    "sharded_solve_box_qp_batch",
    "sharded_solve_lasso_batch",
    "sharded_solve_lasso_multirhs",
    "sharded_solve_tv_batch",
    "stream_solve",
]
