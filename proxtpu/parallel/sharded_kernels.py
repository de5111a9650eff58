"""Multi-device batched solvers: the specialized solvers under shard_map.

The batched solvers of :mod:`proxtpu.kernels` run one device's batch; on a
multi-GPU host the scenario batch is data-parallel over the ``dp`` mesh
axis and each device runs the SAME solver on its local lanes.  GSPMD
cannot partition a ``pallas_call`` automatically, so these wrappers place
the whole solver body (while-loop, step calls, convergence bookkeeping)
inside ``jax.shard_map``: every device iterates on its own lanes and stops
when *its* lanes converge — no per-trip cross-device collective at all,
which is exactly the right communication structure for scenario batching
(lanes are independent; the only "collective" is the caller's final
gather).

Per-lane semantics are identical to the single-device solvers: the
while-loop's ``jnp.all(done)`` becomes a *local* all, so a device whose
lanes finish early stops early instead of spinning until the global slowest
lane — per-lane iterates, counts and flags are unchanged (pinned by
``tests/test_sharding.py``).

The reference has no distributed story at all (SURVEY.md §2.6).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def _mesh_axis_size(mesh, axis):
    return mesh.shape[axis]


def default_dp_mesh(n_devices=None, axis="dp"):
    """A 1-axis mesh over the first ``n_devices`` (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def sharded_solve_lasso_batch(
    A, b, lam, Lf, tol, *, mesh, axis="dp", maxit=1000, use_kernel=None,
    interpret=False, restart=False, x0=None,
):
    """:func:`proxtpu.kernels.lasso.solve_lasso_batch` data-parallel over
    ``axis``: A (B, M, N), b (B, M), lam/Lf (B,) sharded on the batch dim,
    each device solving its own lanes (``use_kernel``/``interpret`` choose
    the step as in the single-device solver).

    B must be divisible by the mesh axis size.  Returns (z, iters, done)
    with the same sharding on the batch dim.
    """
    from ..kernels.lasso import solve_lasso_batch

    nd = _mesh_axis_size(mesh, axis)
    if A.shape[0] % nd:
        raise ValueError(
            f"batch {A.shape[0]} not divisible by mesh axis {axis}={nd}"
        )

    body = partial(
        solve_lasso_batch, tol=tol, maxit=maxit, use_kernel=use_kernel,
        interpret=interpret, restart=restart,
    )
    if x0 is not None:
        return jax.shard_map(
            lambda A_, b_, l_, L_, x_: body(A_, b_, l_, L_, x0=x_),
            mesh=mesh,
            in_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis),
                      P(axis, None)),
            out_specs=(P(axis, None), P(axis), P(axis)),
            check_vma=False,
        )(A, b, lam, Lf, x0)
    return jax.shard_map(
        lambda A_, b_, l_, L_: body(A_, b_, l_, L_),
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)),
        # pallas_call inside shard_map has no varying-mesh-axes annotation;
        # every out is dp-sharded by construction
        check_vma=False,
    )(A, b, lam, Lf)


def sharded_solve_lasso_multirhs(
    A, Bmat, lam, Lf, tol, *, mesh, axis="dp", maxit=2000, iter_block=1,
    restart=False, x0=None,
):
    """:func:`proxtpu.kernels.lasso.solve_lasso_multirhs` (shared design
    matrix, matmul formulation) with the RHS batch sharded over
    ``axis`` and A replicated on every device — each device runs the
    (B_local, N) @ (N, M) matmuls on its own lanes."""
    from ..kernels.lasso import solve_lasso_multirhs

    nd = _mesh_axis_size(mesh, axis)
    if Bmat.shape[0] % nd:
        raise ValueError(
            f"batch {Bmat.shape[0]} not divisible by mesh axis {axis}={nd}"
        )

    import jax.numpy as jnp

    B = Bmat.shape[0]
    lam_v = jnp.broadcast_to(jnp.asarray(lam, A.dtype), (B,))
    Lf_s = jnp.asarray(Lf, A.dtype)
    if Lf_s.ndim != 0:
        # shared-A formulation: one Lipschitz constant; a per-lane (B,)
        # value would otherwise surface as an opaque spec mismatch
        # inside shard_map
        raise ValueError(
            f"Lf must be a scalar for the shared-A multirhs wrapper, "
            f"got shape {Lf_s.shape}"
        )
    body = partial(solve_lasso_multirhs, tol=tol, maxit=maxit,
                   iter_block=iter_block, restart=restart)
    if x0 is not None:
        return jax.shard_map(
            lambda A_, B_, l_, L_, x_: body(A_, B_, l_, L_, x0=x_),
            mesh=mesh,
            in_specs=(P(None, None), P(axis, None), P(axis), P(),
                      P(axis, None)),
            out_specs=(P(axis, None), P(axis), P(axis)),
            check_vma=False,
        )(A, Bmat, lam_v, Lf_s, x0)
    return jax.shard_map(
        lambda A_, B_, l_, L_: body(A_, B_, l_, L_),
        mesh=mesh,
        in_specs=(P(None, None), P(axis, None), P(axis), P()),
        out_specs=(P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )(A, Bmat, lam_v, Lf_s)


def sharded_solve_box_qp_batch(
    Q, q, lo, hi, Lip, tol, *, mesh, axis="dp", maxit=20_000, x0=None,
):
    """:func:`proxtpu.kernels.box_qp.solve_box_qp_batch` data-parallel over
    ``axis``."""
    from ..kernels.box_qp import solve_box_qp_batch

    nd = _mesh_axis_size(mesh, axis)
    if Q.shape[0] % nd:
        raise ValueError(
            f"batch {Q.shape[0]} not divisible by mesh axis {axis}={nd}"
        )
    for name, v in (("lo", lo), ("hi", hi)):
        if np.ndim(v) != 0:
            # lo/hi ride the closure REPLICATED; a per-lane (B,) value
            # would silently apply the full-batch vector to every local
            # shard (or break broadcasting) inside shard_map
            raise ValueError(
                f"{name} must be lane-uniform (scalar) in the sharded "
                f"wrapper, got shape {np.shape(v)}"
            )

    body = lambda Q_, q_, L_, **kw: solve_box_qp_batch(
        Q_, q_, lo, hi, L_, tol, maxit=maxit, **kw,
    )
    if x0 is not None:
        return jax.shard_map(
            lambda Q_, q_, L_, x_: body(Q_, q_, L_, x0=x_),
            mesh=mesh,
            in_specs=(P(axis, None, None), P(axis, None), P(axis),
                      P(axis, None)),
            out_specs=(P(axis, None), P(axis), P(axis)),
            check_vma=False,
        )(Q, q, Lip, x0)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )(Q, q, Lip)


def sharded_solve_tv_batch(
    b, lam, tol, *, mesh, axis="dp", maxit=5000, iter_block=8,
    gamma1=None, gamma2=None, formulation="roll", x0=None, y0=None,
):
    """:func:`proxtpu.kernels.tv.solve_tv_batch` (batched Chambolle-Pock TV
    denoiser) data-parallel over ``axis``: b (B, H, W) and a scalar or
    per-image (B,) ``lam`` sharded on the batch dim, each device denoising
    its own images.  Stepsizes (``gamma1``/``gamma2``) must be
    lane-uniform here; they ride the closure replicated.
    """
    import jax.numpy as jnp

    from ..kernels.tv import solve_tv_batch

    nd = _mesh_axis_size(mesh, axis)
    if b.shape[0] % nd:
        raise ValueError(
            f"batch {b.shape[0]} not divisible by mesh axis {axis}={nd}"
        )
    for name, v in (("gamma1", gamma1), ("gamma2", gamma2)):
        if v is not None and np.ndim(v) != 0:
            # stepsizes ride the closure replicated (docstring contract);
            # validate instead of surfacing an opaque broadcast error
            # deep inside the sharded trace
            raise ValueError(
                f"{name} must be lane-uniform (scalar) in the sharded "
                f"wrapper, got shape {np.shape(v)}"
            )
    lam_v = jnp.broadcast_to(jnp.asarray(lam, b.dtype), (b.shape[0],))

    body = partial(
        solve_tv_batch, tol=tol, maxit=maxit, iter_block=iter_block,
        gamma1=gamma1, gamma2=gamma2, formulation=formulation,
    )
    args = [b, lam_v]
    specs = [P(axis, None, None), P(axis)]
    kw_names = []
    if x0 is not None:
        args.append(x0)
        specs.append(P(axis, None, None))
        kw_names.append("x0")
    if y0 is not None:
        args.append(y0)
        specs.append(P(axis, None, None, None))
        kw_names.append("y0")

    def run(b_, l_, *rest):
        return body(b_, l_, **dict(zip(kw_names, rest)))

    return jax.shard_map(
        run,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(P(axis, None, None), P(axis), P(axis)),
        check_vma=False,
    )(*args)
