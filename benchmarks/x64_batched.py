"""GPU measurement: BATCHED solves at reference-grade tolerances via x64.

``jax_enable_x64`` reaches the reference's tol=1e-6 for every solver in
the 10-solver matrix.  This measures the *batched* paths in float64 on
the card, which is what a user who needs reference tolerances at batch
throughput would actually run:

* flagship lasso batch (256 x 200x400) — generic FISTA driver and flat
  ZeroFPR at tol 1e-6 and 1e-8, x64 vs the f32 run at 1e-5;
* the logistic lam-path (the f32 noise-floor case of
  ``logistic_bench.py``) — flat ZeroFPR at tol 1e-6 in x64.

The fused lasso kernel is float32-only; x64 runs take the pure-XLA paths
(``use_kernels=False`` / the flat machines).

Usage: python benchmarks/x64_batched.py [--quick]
       python benchmarks/x64_batched.py --stream
           (streaming rows: warm lam-path through stream_solve)
       python benchmarks/x64_batched.py --restart
           (adaptive-restart rows: AdaptiveRestartSequence on the
           cold/warm f64 paths)
       python benchmarks/x64_batched.py --warm-tol-sweep
           (records the warm_tol sweep behind
           WarmStartedBatchedAlgorithm's 1.2e-5 default — cold reference
           row + warm rows at warm_tol in {1e-4, 3e-5, 1.2e-5} for tol
           1e-6 and 1e-8 on the flagship lam-path)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import proxtpu  # noqa: F401
from proxtpu.algorithms.fast_forward_backward import (
    make_fast_forward_backward_iteration,
)
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import (
    BatchedAlgorithm,
    Shared,
    WarmStartedBatchedAlgorithm,
)
from proxtpu.parallel.flat_ls import batched_zerofpr
from proxtpu.prox import LeastSquaresLoss, LogisticLoss, NormL1, SqrDistance, Translate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup, timed_solve  # noqa: E402

M, N, BATCH = 200, 400, 256


def timed(tag, run, reps):
    _, rec = timed_solve(run, reps, BATCH)
    rec = {"variant": tag, **rec}
    print(json.dumps(rec), flush=True)
    return rec


def warm_tol_sweep(reps):
    """The sweep behind the warm_tol=1.2e-5 default of
    ``proxtpu/parallel/warm.py``: one shared
    flagship lam-path, cold f64 reference + warm rows at three stage-1
    tolerances, for final tol 1e-6 and 1e-8."""
    rng = np.random.default_rng(0)
    dt = np.float64
    A = jnp.asarray(rng.standard_normal((M, N)) / np.sqrt(M), dt)
    b = jnp.asarray(rng.standard_normal(M), dt)
    lam_max = float(np.max(np.abs(np.asarray(A).T @ np.asarray(b))))
    lams = jnp.asarray(
        lam_max * np.logspace(np.log10(0.02), np.log10(0.5), BATCH), dt
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    kw = dict(x0=jnp.zeros((BATCH, N), dt),
              f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf)
    for tol in (1e-6, 1e-8):
        gen = BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=20000, tol=tol,
            use_kernels=False, check_every=8,
        )
        timed(f"sweep_cold_f64_tol{tol:g}", lambda: gen(**kw), reps)
        for wt in (1e-4, 3e-5, 1.2e-5):
            ws = WarmStartedBatchedAlgorithm(
                make_fast_forward_backward_iteration, maxit=20000,
                tol=tol, warm_tol=wt, use_kernels=False, check_every=8,
            )
            timed(f"sweep_warm_tol{tol:g}_wt{wt:g}", lambda: ws(**kw),
                  reps)


def stream_mode(reps):
    """Streaming rows: the f64 warm-started flagship lam-path drained
    through ``stream_solve`` (depth 2) vs fencing each solve (same
    solutions, same convergence gate).  Rows ``x64_stream_*``."""
    from proxtpu.parallel import stream_solve

    rng = np.random.default_rng(0)
    dt = np.float64
    A = jnp.asarray(rng.standard_normal((M, N)) / np.sqrt(M), dt)
    b = jnp.asarray(rng.standard_normal(M), dt)
    lam_max = float(np.max(np.abs(np.asarray(A).T @ np.asarray(b))))
    lams = jnp.asarray(
        lam_max * np.logspace(np.log10(0.02), np.log10(0.5), BATCH), dt
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    kw = dict(x0=jnp.zeros((BATCH, N), dt),
              f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf)
    for tol in (1e-6, 1e-8):
        ws = WarmStartedBatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=20000, tol=tol,
            warm_tol=1.2e-5, use_kernels=False, check_every=8,
        )
        xs, it, done = ws(**kw)
        np.asarray(xs)
        assert bool(jnp.all(done))
        import time as _t
        ts = []
        for _ in range(reps):
            t0 = _t.perf_counter()
            out = ws(**kw)
            np.asarray(out[0])
            ts.append(_t.perf_counter() - t0)
        print(json.dumps({
            "variant": f"x64_stream_fenced_each_tol{tol:g}",
            "problems_per_sec": BATCH / float(np.median(ts)),
        }), flush=True)
        n_stream = 4
        list(stream_solve(lambda _p: ws(**kw), range(n_stream), depth=2))
        ts = []
        for _ in range(reps):
            t0 = _t.perf_counter()
            list(stream_solve(
                lambda _p: ws(**kw), range(n_stream), depth=2))
            ts.append((_t.perf_counter() - t0) / n_stream)
        print(json.dumps({
            "variant": f"x64_stream_depth2_tol{tol:g}",
            "problems_per_sec": BATCH / float(np.median(ts)),
            "n_stream": n_stream,
        }), flush=True)


def restart_mode(reps):
    """O'Donoghue-Candès adaptive restart on the reference-tolerance
    path (rows ``x64_restart_*``).  AdaptiveRestartSequence cuts f64
    iterations on the flagship lam-path, while its signal check adds a
    (B,) reduction to every step of the generic driver; the net is
    decided by the iteration cut.  Parity: same stopping criterion,
    every lane's done flag asserted; trajectory differs (distinct
    tol-ball member)."""
    from proxtpu.accel import AdaptiveRestartSequence

    rng = np.random.default_rng(0)
    dt = np.float64
    A = jnp.asarray(rng.standard_normal((M, N)) / np.sqrt(M), dt)
    b = jnp.asarray(rng.standard_normal(M), dt)
    lam_max = float(np.max(np.abs(np.asarray(A).T @ np.asarray(b))))
    lams = jnp.asarray(
        lam_max * np.logspace(np.log10(0.02), np.log10(0.5), BATCH), dt
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    kw = dict(x0=jnp.zeros((BATCH, N), dt),
              f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf)
    seq = AdaptiveRestartSequence()
    for tol in (1e-6, 1e-8):
        cold = BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=40000, tol=tol,
            use_kernels=False, check_every=8)
        warm = WarmStartedBatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=40000, tol=tol,
            use_kernels=False, check_every=8)
        cold_r = BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=40000, tol=tol,
            use_kernels=False, check_every=8, extrapolation_sequence=seq)
        warm_r = WarmStartedBatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=40000, tol=tol,
            use_kernels=False, check_every=8, extrapolation_sequence=seq)
        timed(f"x64_restart_ref_cold_plain_tol{tol:g}",
              lambda: cold(**kw), reps)
        timed(f"x64_restart_cold_tol{tol:g}", lambda: cold_r(**kw), reps)
        timed(f"x64_restart_ref_warm_plain_tol{tol:g}",
              lambda: warm(**kw), reps)
        timed(f"x64_restart_warm_tol{tol:g}", lambda: warm_r(**kw), reps)
    # streamed warm-restart at 1e-8 (the regime where restart wins):
    # depth-2 stream_solve drain, same protocol as stream_mode
    from proxtpu.parallel import stream_solve
    import time as _t
    ws = WarmStartedBatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=40000, tol=1e-8,
        use_kernels=False, check_every=8, extrapolation_sequence=seq)
    xs, _, done = ws(**kw)
    np.asarray(xs)
    assert bool(jnp.all(done))
    n_stream = 4
    list(stream_solve(lambda _p: ws(**kw), range(n_stream), depth=2))
    ts = []
    for _ in range(reps):
        t0 = _t.perf_counter()
        list(stream_solve(lambda _p: ws(**kw), range(n_stream), depth=2))
        ts.append((_t.perf_counter() - t0) / n_stream)
    print(json.dumps({
        "variant": "x64_restart_warm_stream_depth2_tol1e-08",
        "problems_per_sec": BATCH / float(np.median(ts)),
        "n_stream": n_stream,
    }), flush=True)


def main():
    setup()
    reps = 2 if "--quick" in sys.argv else 3
    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "x64": True}), flush=True)
    if "--stream" in sys.argv:
        stream_mode(reps)
        return
    if "--restart" in sys.argv:
        restart_mode(reps)
        return
    if "--warm-tol-sweep" in sys.argv:
        warm_tol_sweep(reps)
        return

    # --- lasso lam-path, shared (A, b)
    rng = np.random.default_rng(0)
    for dt, tag in ((np.float64, "f64"), (np.float32, "f32")):
        A = jnp.asarray(rng.standard_normal((M, N)) / np.sqrt(M), dt)
        b = jnp.asarray(rng.standard_normal(M), dt)
        lam_max = float(np.max(np.abs(np.asarray(A).T @ np.asarray(b))))
        lams = jnp.asarray(
            lam_max * np.logspace(np.log10(0.02), np.log10(0.5), BATCH), dt
        )
        Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
        x0 = jnp.zeros((BATCH, N), dt)
        gamma = jnp.full((BATCH,), 0.95 / Lf, dt)
        tols = (1e-6, 1e-8) if dt == np.float64 else (1e-5,)
        for tol in tols:
            gen = BatchedAlgorithm(
                make_fast_forward_backward_iteration, maxit=20000, tol=tol,
                use_kernels=False, check_every=8,
            )
            kw = dict(x0=x0, f=Shared(LeastSquaresLoss(A, b)),
                      g=NormL1(lams), Lf=Lf)
            cold = timed(f"lasso_generic_fista_{tag}_tol{tol:g}",
                         lambda: gen(**kw), reps)
            timed(f"lasso_flat_zerofpr_{tag}_tol{tol:g}",
                  lambda: batched_zerofpr(
                      Shared(SqrDistance(b)), Shared(MatrixOperator(A)),
                      NormL1(lams), x0, gamma, tol, maxit=5000), reps)
            if dt == np.float64:
                # f32 warm start + f64 polish.
                # Same stopping rule in the f64 stage; parity vs the cold
                # f64 solve is asserted below before the row is recorded.
                ws = WarmStartedBatchedAlgorithm(
                    make_fast_forward_backward_iteration, maxit=20000,
                    tol=tol, use_kernels=False, check_every=8,
                )
                rec = timed(f"lasso_warm_f32f64_fista_tol{tol:g}",
                            lambda: ws(**kw), reps)
                xs_w, _, d_w = ws(**kw)
                xs_c, _, d_c = gen(**kw)
                assert bool(jnp.all(d_w)) and bool(jnp.all(d_c))
                gap = float(jnp.max(jnp.abs(xs_w - xs_c)))
                # both are tol-ball members of the same criterion; their
                # mutual distance is O(tol) x conditioning, not 0
                print(json.dumps({"variant": rec["variant"] + "_paritygap",
                                  "max_abs_gap_vs_cold": gap,
                                  "tol": tol}), flush=True)

                # warm flat ZeroFPR: f32 stage to the f32 noise floor,
                # f64 polish from the warm iterate with the SAME flat
                # machine and stopping rule
                A32, b32 = A.astype(jnp.float32), b.astype(jnp.float32)
                lams32 = lams.astype(jnp.float32)
                gamma32 = gamma.astype(jnp.float32)

                def warm_zerofpr():
                    xw, it1, _d1 = batched_zerofpr(
                        Shared(SqrDistance(b32)),
                        Shared(MatrixOperator(A32)), NormL1(lams32),
                        jnp.zeros((BATCH, N), jnp.float32), gamma32,
                        1.2e-5, maxit=5000)
                    xs, it2, d = batched_zerofpr(
                        Shared(SqrDistance(b)), Shared(MatrixOperator(A)),
                        NormL1(lams), xw.astype(dt), gamma, tol,
                        maxit=5000)
                    return xs, it1 + it2, d

                timed(f"lasso_warm_f32f64_flat_zerofpr_tol{tol:g}",
                      warm_zerofpr, reps)

    # --- logistic lam-path at tol 1e-6 in f64 (f32 noise floor ~2e-3)
    A = jnp.asarray(rng.standard_normal((M, N)) / np.sqrt(M), np.float64)
    b = jnp.asarray(rng.standard_normal(M), np.float64)
    lam_max = float(np.max(np.abs(
        np.asarray(A).T @ (1 / (1 + np.exp(np.asarray(b))) - 1))))
    lams = jnp.asarray(
        lam_max * np.logspace(np.log10(0.05), np.log10(0.5), BATCH),
        np.float64,
    )
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2) / 4
    f_log = Translate(LogisticLoss(1.0), -b)
    gamma = jnp.full((BATCH,), 0.95 / Lf, np.float64)
    timed("logistic_flat_zerofpr_f64_tol1e-06", lambda: batched_zerofpr(
        Shared(f_log), Shared(MatrixOperator(A)), NormL1(lams),
        jnp.zeros((BATCH, N), np.float64), gamma, 1e-6, maxit=5000), reps)


if __name__ == "__main__":
    main()
