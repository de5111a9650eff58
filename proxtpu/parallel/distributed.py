"""Multi-host initialization and mesh construction.

On a multi-host GPU cluster, JAX needs one ``jax.distributed.initialize()``
per process before devices are visible; after that, meshes span *all*
hosts' devices and the same jitted solver programs run SPMD with XLA's
NCCL collectives over NVLink (within a host) and the network (across
hosts) — no code changes in the solvers (SURVEY.md §5: "communication
backend").

This module is exercised in CI only in its single-process form (no
multi-host hardware in the dev environment); the mesh-building logic is the
same one the virtual-device tests use.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, auto=False):
    """Initialize multi-host JAX.

    With all-default arguments this is a deliberate no-op (safe in
    single-process dev environments).  Pass ``auto=True`` on a cluster
    JAX can detect (e.g. a SLURM allocation) to run the bare
    ``jax.distributed.initialize()`` auto-detection; explicit coordinator
    address / process counts (for manual clusters) take precedence over
    ``auto``.  Returns
    ``jax.process_count()``.
    """
    if auto and coordinator_address is None and num_processes is None:
        jax.distributed.initialize()
    elif coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    ):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count()


def global_mesh(axis_shape, axis_names, devices=None):
    """Build a mesh over all global devices (all hosts' cards).

    ``axis_shape`` is the logical mesh shape, e.g. ``(num_hosts, 8)`` with
    names ``("dp", "tp")`` so data-parallel traffic crosses hosts while
    operator shards ride NVLink — lay the fast-changing axis innermost so
    collectives over it stay within a host.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs.reshape(axis_shape), axis_names)
