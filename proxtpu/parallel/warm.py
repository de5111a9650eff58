"""Precision warm-starting: solve cheap in f32, polish to tolerance in f64.

A float64 iteration costs more than a float32 one (twice the bytes of
every operand, and a lower float64 rate on most accelerators), and a cold
f64 solve to a reference-grade tolerance re-pays, at that cost, the
several hundred iterations an f32 solve covers.
Two-stage warm-starting removes that waste: stage 1 runs the batched solve
in float32 to an f32-attainable tolerance (``warm_tol``, default 1.2e-5),
stage 2 re-launches the SAME algorithm in the request dtype from the warm
iterate and polishes to ``tol``.  Stage 2 is an ordinary fresh solve — its
momentum/line-search state initializes from scratch, which doubles as the
Nesterov restart that is much of the benefit of two-staging.

The final stopping criterion is stage 2's, evaluated entirely in the
request dtype — solution quality is identical to a cold f64 solve at the
same tolerance (parity asserted in ``tests/test_warm.py`` and in
``benchmarks/x64_batched.py``).

This is the batched-XLA-path counterpart of the fused kernels'
``solve_lasso_batch_mixed`` (bf16 -> f32, ``proxtpu/kernels/lasso.py``);
the fused lasso kernel itself is float32-only, so reference tolerances
(1e-6 .. 1e-8) always take this route.  Reference anchor: the tol=1e-6
oracle of ``/root/reference/test/problems/test_lasso_small.jl:42-53`` is
the accuracy class this path exists to serve on an accelerator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .batch import BatchedAlgorithm

__all__ = ["cast_problem", "WarmStartedAlgorithm",
           "WarmStartedBatchedAlgorithm"]


def cast_problem(tree, dtype=jnp.float32):
    """Cast every wide floating/complex array leaf of a problem pytree to
    the narrow dtype (f64 -> ``dtype``, c128 -> its complex counterpart).

    Non-inexact leaves (index arrays, flags) and already-narrow leaves pass
    through untouched; ``Shared`` markers are registered pytree nodes, so
    shared operands are cast in place without losing their lane-invariant
    marking."""
    complex_dtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128

    def cast(leaf):
        try:
            arr = jnp.asarray(leaf)
        except (TypeError, ValueError):
            return leaf  # callables / non-array options pass through
        if jnp.issubdtype(arr.dtype, jnp.complexfloating):
            return arr.astype(complex_dtype)
        if jnp.issubdtype(arr.dtype, jnp.floating):
            return arr.astype(dtype)
        return leaf

    return jax.tree.map(cast, tree)


class WarmStartedBatchedAlgorithm:
    """Two-stage batched solver: f32 warm start, request-dtype polish.

    Same construction/call contract as :class:`BatchedAlgorithm`::

        solver = WarmStartedBatchedAlgorithm(
            make_fast_forward_backward_iteration,
            maxit=20000, tol=1e-6, warm_tol=1e-4)
        xs, iters, done = solver(x0=x0_f64, f=Shared(f), g=g, Lf=Lf)

    Stage 1 solves ``cast_problem(kwargs, float32)`` to ``warm_tol``
    (bounded by ``warm_maxit``; lanes that cap simply enter stage 2 from
    wherever they got); stage 2 solves the original-dtype problem from the
    stage-1 solution as ``x0``.  Returned ``iters`` is the per-lane total
    across both stages; ``done`` is stage 2's.  The stage-1 solution must
    be ``x0``-shaped (true for the forward-backward family, whose
    ``default_solution`` is the iterate itself) — algorithms with
    structured solutions (primal-dual pairs) need a custom ``solution``
    that returns the warm-startable part.

    ``warm_tol`` defaults to 1.2e-5 — just above the f32 FB-residual noise
    floor measured at the flagship scale (tol=1e-5 converges every lane in
    f32), so stage 1 extracts everything f32 can reach and stage 2 only
    polishes (``benchmarks/x64_batched.py`` measures warm against cold;
    ``--warm-tol-sweep`` sweeps ``warm_tol`` over 1e-4, 3e-5 and
    1.2e-5).  If
    stage 1 stalls above ``warm_tol`` on a harder problem class (f32
    attainability is problem-dependent), it exits at ``warm_maxit`` and
    stage 2 still finishes the job — correctness never depends on the
    warm stage; raise ``warm_tol`` to stop paying for the stall.

    For tolerances at or below 1e-8, compose with adaptive restart —
    ``extrapolation_sequence=AdaptiveRestartSequence()`` — which caps
    the slow lanes' momentum oscillation (worst lane 4.3k -> 1.9k
    iterations on the flagship lam-path; ``x64_batched.py --restart``).
    At tol 1e-6 plain warm can be faster: the restart signal is a
    per-step (B,) reduction in the generic driver, and too few polish
    iterations remain to amortize it.
    """

    def __init__(self, iteration_factory, *, maxit, tol, warm_tol=1.2e-5,
                 warm_maxit=None, warm_dtype=jnp.float32, stop=None,
                 solution=None, use_kernels=True, check_every=None,
                 verbose=False, freq=100, **kwargs):
        self.warm = BatchedAlgorithm(
            iteration_factory,
            maxit=maxit if warm_maxit is None else warm_maxit,
            tol=warm_tol, stop=stop, solution=solution,
            use_kernels=use_kernels, check_every=check_every,
            verbose=verbose, freq=freq, **cast_problem(kwargs, warm_dtype),
        )
        self.polish = BatchedAlgorithm(
            iteration_factory, maxit=maxit, tol=tol, stop=stop,
            solution=solution, use_kernels=use_kernels,
            check_every=check_every, verbose=verbose, freq=freq, **kwargs,
        )
        self.warm_dtype = warm_dtype

    def __call__(self, x0, **kwargs):
        warm_kwargs = cast_problem(kwargs, self.warm_dtype)
        xs_warm, it1, _done1 = self.warm(
            x0=cast_problem(x0, self.warm_dtype), **warm_kwargs
        )
        # cast the warm solution back leaf-by-leaf to x0's dtypes (pytree
        # iterates are first-class in BatchedAlgorithm, so x0 may be a
        # tuple/dict of arrays with heterogeneous dtypes), DISCARDING any
        # lane the f32 stage blew up (overflowed cast or diverged
        # iterate): a NaN/Inf warm start would poison the polish stage,
        # and the documented contract is that correctness never depends
        # on the warm stage — such lanes fall back to the cold x0 (r5
        # review)
        def _finite_per_lane(w):
            flat = jnp.reshape(w, (jnp.shape(w)[0], -1))
            return jnp.all(jnp.isfinite(flat), axis=1)

        def _take_warm(w_, o_):
            o_arr = jnp.asarray(o_)
            w_cast = jnp.asarray(w_, o_arr.dtype)
            ok = _finite_per_lane(w_cast)
            ok = ok.reshape(ok.shape + (1,) * (w_cast.ndim - 1))
            return jnp.where(ok, w_cast, jnp.broadcast_to(o_arr,
                                                          w_cast.shape))
        x1 = jax.tree.map(_take_warm, xs_warm, x0)
        xs, it2, done = self.polish(x0=x1, **kwargs)
        return xs, it1 + it2, done


class WarmStartedAlgorithm:
    """Single-problem counterpart of :class:`WarmStartedBatchedAlgorithm`:
    f32 warm stage, request-dtype polish, same stopping criterion.

    Takes the solver FACTORY (``pa.ZeroFPR``, ``pa.FastForwardBackward``,
    ...) plus the driver options::

        solver = WarmStartedAlgorithm(pa.ZeroFPR, maxit=5000, tol=1e-6)
        x, it = solver(x0=x0_f64, f=f, g=g, Lf=Lf)

    Motivation: on the reference's own lasso_medium workload most of a
    cold f64 solve's iterations are reachable in f32, where each costs
    less.  Warm-starting moves those iterations to f32 and leaves only the polish in f64.  The
    returned iteration count is the two stages' total; the solution must
    be x0-shaped (true for every 2-term solver; primal-dual pairs need a
    custom ``solution``)."""

    def __init__(self, solver_factory, *, maxit, tol, warm_tol=1.2e-5,
                 warm_maxit=None, warm_dtype=jnp.float32, **opts):
        # construction-time problem kwargs (the two-stage UX allows e.g.
        # f=/g= here) must reach the warm stage narrowed too, like the
        # batched class; cast_problem leaves non-array options untouched
        self.warm = solver_factory(
            maxit=maxit if warm_maxit is None else warm_maxit,
            tol=warm_tol, **cast_problem(opts, warm_dtype))
        self.polish = solver_factory(maxit=maxit, tol=tol, **opts)
        self.warm_dtype = warm_dtype

    def __call__(self, x0, **problem):
        xw, it1 = self.warm(
            x0=cast_problem(x0, self.warm_dtype),
            **cast_problem(problem, self.warm_dtype))
        x1 = jax.tree.map(
            lambda w, o: jnp.asarray(w, jnp.asarray(o).dtype), xw, x0)
        x, it2 = self.polish(x0=x1, **problem)
        return x, it1 + it2
