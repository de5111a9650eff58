"""Sharded linear operators: the "tensor parallelism" of this domain.

The reference's only operator contract is a single-core ``mul!``
(``src/utilities/fb_tools.jl:21``).  On an accelerator mesh the two matvecs ``A x`` and
``A^H y`` are where FLOPs and communication live (SURVEY.md §5): shard ``A``
over a mesh axis with ``jax.sharding.NamedSharding`` and let GSPMD/XLA insert
the collectives (NCCL over NVLink on a multi-GPU host) — ``A x`` with row-sharded A is a local matmul
producing a row-sharded result; ``A^H y`` is a local matmul followed by a
``psum`` (all-reduce) that XLA emits automatically.  Global reductions for
stopping criteria (norms of sharded residuals) are likewise partial
reductions + psum, all inside one jitted while-loop.

No hand-written collectives are needed for correctness; explicit
``with_sharding_constraint`` annotations pin the layouts so the partitioner
cannot make a pathological choice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..prox.base import proxclass
from ..utils.precision import pdot


def make_mesh(axis_sizes, axis_names):
    """Build a Mesh from the available devices (real GPUs or the virtual CPU
    devices created by --xla_force_host_platform_device_count)."""
    import numpy as np

    n = int(np.prod(axis_sizes))
    devs = np.asarray(jax.devices()[:n]).reshape(axis_sizes)
    return Mesh(devs, axis_names)


@proxclass(meta_fields=("mesh", "row_axis", "col_axis"))
class ShardedMatrixOperator:
    """Dense operator with A sharded over mesh axes.

    ``row_axis`` shards the output dimension m (so ``matvec`` is purely local
    and ``rmatvec`` ends in an all-reduce); ``col_axis`` shards the input
    dimension n (the transpose layout).  Both may be set for 2-D sharding of
    a huge A.  Sharding constraints keep x/y layouts pinned: x follows
    ``col_axis``, y follows ``row_axis``.
    """

    A: object
    mesh: object
    row_axis: object
    col_axis: object

    def _cstr(self, v, axis):
        if self.mesh is None:
            return v
        return jax.lax.with_sharding_constraint(
            v, NamedSharding(self.mesh, P(axis))
        )

    def matvec(self, x):
        x = self._cstr(x, self.col_axis)
        return self._cstr(pdot(self.A, x), self.row_axis)

    def rmatvec(self, y):
        y = self._cstr(y, self.row_axis)
        return self._cstr(pdot(self.A.conj().T, y), self.col_axis)

    def opnorm(self):
        from ..ops.linops import power_iteration_opnorm

        x_like = jnp.zeros((self.A.shape[1],), self.A.dtype)
        return power_iteration_opnorm(self, x_like)


def shard_matrix_operator(A, mesh, row_axis=None, col_axis=None):
    """Place A on the mesh with the requested row/col sharding and wrap it.

    Typical use for a tall A (m >> n): ``row_axis='tp'`` — each device holds
    a horizontal stripe of A; the FISTA/PANOC step's ``A^H grad`` becomes a
    local matmul + psum over the interconnect.
    """
    A = jnp.asarray(A)
    sharding = NamedSharding(mesh, P(row_axis, col_axis))
    A = jax.device_put(A, sharding)
    return ShardedMatrixOperator(A, mesh, row_axis, col_axis)


def replicate(tree, mesh):
    """Replicate a pytree across the mesh (for x0, b, scalars)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda l: jax.device_put(l, sharding), tree)


def shard_batch(tree, mesh, axis_name, batch_dim=0):
    """Shard the leading (batch) axis of every leaf over a mesh axis — the
    data-parallel layout for scenario batching (batch lanes spread across
    chips, each chip vmapping its local lanes)."""

    def put(l):
        spec = [None] * l.ndim
        spec[batch_dim] = axis_name
        return jax.device_put(l, NamedSharding(mesh, P(*spec)))

    return jax.tree.map(put, tree)
