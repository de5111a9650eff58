"""GPU measurement: flat trial/commit PANOC vs bounded-lowering batched PANOC.

Flagship shape (256 x 200x400 lasso, f32, tol 1e-5): the bounded lowering
pays ``max_backtracks`` masked tau-trials per iteration; the flat machine
pays one oracle evaluation per trip (accepted trial or halving).  Both
variants measured back-to-back in one process.

Usage: python benchmarks/flat_ls_bench.py [--quick] [--blocking] [--adaptive]

``--blocking`` instead measures check_every trip blocking on the flat
machines (K=1 vs K=8): exact semantics, the K>1 variants only amortize
the per-while-trip fixed cost.

``--adaptive`` measures the two-mode gamma+tau flat machines for adaptive
PANOC/ZeroFPR against the bounded lowering, from a deliberately 10x-hot
gamma start so the gamma search does real work.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import proxtpu  # noqa: F401
from proxtpu.algorithms.panoc import make_panoc_iteration
from proxtpu.algorithms.panocplus import make_panocplus_iteration
from proxtpu.algorithms.zerofpr import make_zerofpr_iteration
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import BatchedAlgorithm
from proxtpu.parallel.flat_ls import (
    batched_panoc,
    batched_panocplus,
    batched_zerofpr,
)
from proxtpu.prox import NormL1, SqrDistance

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _timing import setup  # noqa: E402

M, N = 200, 400
BATCH = 256
TOL = 1e-5
MAXIT = 2000
DTYPE = np.float32


def gen_problems(batch):
    rng = np.random.default_rng(0)
    As = (rng.standard_normal((batch, M, N)) / np.sqrt(M)).astype(DTYPE)
    bs = rng.standard_normal((batch, M)).astype(DTYPE)
    lams = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
    Lfs = np.array(
        [np.linalg.norm(As[i], 2) ** 2 for i in range(batch)], dtype=DTYPE
    )
    return As, bs, lams.astype(DTYPE), Lfs


def timed(tag, run, reps):
    # warmup + compile
    t0 = time.perf_counter()
    out = run()
    z = np.asarray(jax.block_until_ready(out)[0])
    t_compile = time.perf_counter() - t0
    iters = np.asarray(out[1])
    done = np.asarray(out[2])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    lo, hi = np.percentile(times, [25, 75])
    rec = {
        "variant": tag,
        "problems_per_sec": BATCH / med,
        "median_s": med,
        "iqr_s": [float(lo), float(hi)],
        "compile_s": t_compile,
        "all_done": bool(done.all()),
        "iters_median": int(np.median(iters)),
        "iters_max": int(iters.max()),
    }
    print(json.dumps(rec), flush=True)
    return z, rec


def blocking_sweep(reps):
    """check_every K=1 vs K=8 on the flat machines + the adaptive-gamma
    machine, back-to-back."""
    from proxtpu.parallel.adaptive_batch import batched_adaptive_fista
    from proxtpu.prox import LeastSquaresLoss

    As, bs, lams, Lfs = gen_problems(BATCH)
    f = jax.vmap(SqrDistance)(jnp.asarray(bs))
    g = jax.vmap(NormL1)(jnp.asarray(lams))
    A = jnp.asarray(As)
    x0 = jnp.zeros((BATCH, N), DTYPE)
    Lf = jnp.asarray(Lfs)
    Aop = MatrixOperator(A)
    fq = jax.vmap(LeastSquaresLoss)(A, jnp.asarray(bs))

    print(json.dumps({"devices": [str(d) for d in jax.devices()]}),
          flush=True)
    runs = {}
    for K in (1, 8):
        runs[f"flat_zerofpr_K{K}"] = lambda K=K: batched_zerofpr(
            f, Aop, g, x0, 0.95 / Lf, TOL, maxit=MAXIT, check_every=K)
        runs[f"flat_panoc_K{K}"] = lambda K=K: batched_panoc(
            f, Aop, g, x0, 0.95 / Lf, TOL, maxit=MAXIT, check_every=K)
        runs[f"flat_adaptive_fista_K{K}"] = lambda K=K: (
            batched_adaptive_fista(fq, g, x0, TOL, maxit=4 * MAXIT,
                                   check_every=K))
    sols = {}
    for tag, run in runs.items():
        sols[tag], _ = timed(tag, run, reps)
    for base in ("flat_zerofpr", "flat_panoc", "flat_adaptive_fista"):
        gap = float(np.max(np.abs(sols[f"{base}_K1"] - sols[f"{base}_K8"])))
        print(json.dumps({"solver": base, "max_abs_gap_K1_vs_K8": gap}),
              flush=True)


def adaptive_sweep(reps):
    """Adaptive PANOC/ZeroFPR: flat two-mode machines vs bounded lowering
    """
    As, bs, lams, Lfs = gen_problems(BATCH)
    f = jax.vmap(SqrDistance)(jnp.asarray(bs))
    g = jax.vmap(NormL1)(jnp.asarray(lams))
    A = jnp.asarray(As)
    x0 = jnp.zeros((BATCH, N), DTYPE)
    Lf = jnp.asarray(Lfs)
    Aop = MatrixOperator(A)
    Aop_st = jax.vmap(MatrixOperator)(A)
    gamma0 = 10.0 * 0.95 / Lf  # hot start: the search must halve ~3-4x

    print(json.dumps({"devices": [str(d) for d in jax.devices()]}),
          flush=True)
    for name, flat_fn, factory in (
        ("panoc", batched_panoc, make_panoc_iteration),
        ("zerofpr", batched_zerofpr, make_zerofpr_iteration),
    ):
        z_f, _ = timed(f"flat_{name}_adaptive", lambda fn=flat_fn: fn(
            f, Aop, g, x0, gamma0, TOL, maxit=MAXIT, adaptive=True), reps)
        bounded = BatchedAlgorithm(
            factory, maxit=MAXIT, tol=TOL, use_kernels=False
        )
        z_b, _ = timed(f"bounded_{name}_adaptive", lambda b=bounded: b(
            x0=x0, f=f, g=g, A=Aop_st, adaptive=True, gamma=gamma0,
            backtrack_limit=24), reps)
        print(json.dumps({
            "solver": name,
            "max_abs_gap_flat_vs_bounded": float(np.max(np.abs(z_f - z_b))),
        }), flush=True)


def main():
    setup()
    quick = "--quick" in sys.argv
    if "--blocking" in sys.argv:
        blocking_sweep(3 if quick else 5)
        return
    if "--adaptive" in sys.argv:
        adaptive_sweep(3 if quick else 5)
        return
    only = None
    for a in sys.argv[1:]:
        if a.startswith("--only="):
            only = a.split("=", 1)[1].split(",")
    reps = 3 if quick else 5
    As, bs, lams, Lfs = gen_problems(BATCH)
    f = jax.vmap(SqrDistance)(jnp.asarray(bs))
    g = jax.vmap(NormL1)(jnp.asarray(lams))
    A = jnp.asarray(As)
    x0 = jnp.zeros((BATCH, N), DTYPE)
    Lf = jnp.asarray(Lfs)
    Aop_stacked = jax.vmap(MatrixOperator)(A)
    Aop = MatrixOperator(A)

    print(json.dumps({"devices": [str(d) for d in jax.devices()]}), flush=True)

    FLAT = {
        "panoc": lambda: batched_panoc(
            f, Aop, g, x0, 0.95 / Lf, TOL, maxit=MAXIT),
        "zerofpr": lambda: batched_zerofpr(
            f, Aop, g, x0, 0.95 / Lf, TOL, maxit=MAXIT),
        "panocplus": lambda: batched_panocplus(
            f, Aop, g, x0, 0.95 / Lf, TOL, maxit=MAXIT),
        "panocplus_adaptive": lambda: batched_panocplus(
            f, Aop, g, x0, 10.0 / Lf, TOL, maxit=MAXIT, adaptive=True),
    }
    GENERIC = {
        "panoc": make_panoc_iteration,
        "zerofpr": make_zerofpr_iteration,
        "panocplus": make_panocplus_iteration,
    }

    for name, run_flat in FLAT.items():
        if only and name not in only:
            continue
        z_flat, rec_flat = timed(f"flat_{name}", run_flat, reps)
        gname = name.replace("_adaptive", "")
        generic = BatchedAlgorithm(
            GENERIC[gname], maxit=MAXIT, tol=TOL, use_kernels=False
        )
        gkw = dict(x0=x0, f=f, g=g, A=Aop_stacked)
        if name.endswith("_adaptive"):
            gkw.update(adaptive=True, gamma=10.0 / Lf)
        else:
            gkw.update(Lf=Lf)

        def run_generic(gkw=gkw, generic=generic):
            return generic(**gkw)

        z_gen, rec_gen = timed(f"bounded_lowering_{name}", run_generic, reps)
        gap = float(np.max(np.abs(z_flat - z_gen)))
        print(json.dumps({
            "solver": name,
            "max_abs_solution_gap": gap,
            "speedup_flat_vs_bounded": rec_flat["problems_per_sec"]
            / rec_gen["problems_per_sec"],
        }), flush=True)


if __name__ == "__main__":
    main()
