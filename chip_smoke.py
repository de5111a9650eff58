"""Smoke test of proxtpu on one NVIDIA GPU: the main path, end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-device path only

Phases on one card (every line that carries a number also carries the card's
``nvidia-smi`` name and power limit):

1. kernel check — the fused FISTA step compiled for the card at 256x200x400
   and 64x200x400 (float32) against the plain XLA step at full float32;
2. main path — the flagship batch (256 lasso problems of 200x400, seed 0,
   tol 1e-5) through ``BatchedAlgorithm`` with adaptive restart, every lane
   rechecked in float64, iteration counts against the XLA step;
3. streaming — six solves through ``stream_solve`` (depth 2), then the
   two-phase tail solver;
4. the other routed families at real sizes, on XLA: the shared-A lambda
   path, flat ZeroFPR, box-QP, TV Chambolle-Pock and a float64 lasso;
5. kernel against XLA — the whole flagship solve timed both ways.

``--four`` runs the flagship batch at 1024 lanes dp-sharded over four cards
(``sharded_solve_lasso_batch`` and the GSPMD generic driver) and
``__graft_entry__.dryrun_multichip(4)``, each compared with one device.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.  Without a GPU the script exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_enable_x64", True)   # phase 4's float64 lasso

import jax.numpy as jnp

from proxtpu.utils.compile_cache import enable_compile_cache

M, N, BATCH, TOL, MAXIT = 200, 400, 256, 1e-5, 2000
SHARED = (256, 1000, 500)      # lambdas, rows, columns of the shared-A path
QP = (256, 256)                # box-QP lanes, n
TV = (16, 256, 256)            # images, height, width
F32 = np.float32


def card():
    """The card's name and power limit, from a child that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return " | ".join(line.strip() for line in out.stdout.splitlines())


def say(msg):
    print(f"[{CARD}] {msg}", flush=True)


def lasso_batch(batch, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((batch, M, N)) / np.sqrt(M)).astype(dtype)
    b = rng.standard_normal((batch, M)).astype(dtype)
    lam = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(dtype)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(batch)],
                  dtype)
    return A, b, lam, Lf


def lasso_residual(A, b, lam, gamma, x):
    """Per-lane ``||x - prox(x - gamma grad f(x))||_inf / gamma`` in float64
    (``f = ||A x - b||^2 / 2``, ``g = lam ||.||_1``; ``A`` (B, M, N) or a
    shared (M, N))."""
    A, b, lam, gamma, x = (np.asarray(v, np.float64)
                           for v in (A, b, lam, gamma, x))
    gamma = np.broadcast_to(gamma, x.shape[:1])[:, None]
    lam = np.broadcast_to(lam, x.shape[:1])[:, None]
    if A.ndim == 2:
        grad = (x @ A.T - b) @ A
    else:
        grad = np.einsum("bmn,bm->bn", A, np.einsum("bmn,bn->bm", A, x) - b)
    y = x - gamma * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gamma * lam, 0.0)
    return np.max(np.abs(x - z), axis=1) / gamma[:, 0]


def check_lasso(name, A, b, lam, Lf, out, tol, bound=1.1):
    xs, iters, done = (np.asarray(v) for v in out)
    assert xs.shape == (len(lam), A.shape[-1]), (name, xs.shape)
    assert np.all(np.isfinite(xs)), name
    assert done.all(), f"{name}: {int((~done).sum())} lanes not done"
    worst = float(np.max(lasso_residual(A, b, lam, 1.0 / Lf, xs)))
    assert worst <= bound * tol, f"{name}: recheck {worst:.3e} > {bound}*tol"
    say(f"{name}: all {done.size} lanes done, max iters {int(iters.max())}, "
        f"float64 recheck {worst:.3e} <= {bound}*{tol:g}")
    return iters


def compare_counts(name, it_a, it_b):
    """Per-lane iteration counts of two runs of the same solves.  The
    kernel sums each gradient in another order than XLA does, and in f32
    that flips knife-edge restart decisions of a few lanes, whose
    trajectories then part; so the bulk of the lanes and the slowest lane
    must agree within 2."""
    d = np.abs(np.asarray(it_a, int) - np.asarray(it_b, int))
    within = float(np.mean(d <= 2))
    say(f"{name}: per-lane |d iters| histogram "
        f"{np.bincount(np.minimum(d, 20)).tolist()} (last bin >= 20), "
        f"{100 * within:.1f}% of lanes within 2, max iters "
        f"{int(np.max(it_a))} vs {int(np.max(it_b))}")
    assert within >= 0.95, within
    assert abs(int(np.max(it_a)) - int(np.max(it_b))) <= 2


def close(name, got, want, rel=2e-5):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    bound = rel * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"
    return err


def wall(f):
    t0 = time.perf_counter()
    jax.block_until_ready(f())
    return time.perf_counter() - t0


def phase_kernel(data):
    from proxtpu.kernels.lasso import (
        fused_fista_step,
        lasso_step_route,
        reference_fb_prox_grad,
        xla_fista_step,
    )

    for B in (BATCH, BATCH // 4):
        A, b, lam, Lf = (jnp.asarray(v[:B]) for v in data)
        assert lasso_step_route(A) == "kernel"
        rng = np.random.default_rng(1)
        x = jnp.asarray(0.1 * rng.standard_normal((B, N)), jnp.float32)
        zp = jnp.asarray(0.1 * rng.standard_normal((B, N)), jnp.float32)
        gamma = (1.0 / Lf).astype(jnp.float32)
        thr = gamma * lam
        step = jax.jit(lambda x, zp, beta, done: fused_fista_step(
            A, b, x, zp, beta, gamma, thr, done, restart=True))
        compiled = step.lower(x, zp, gamma, gamma).compile()
        say(f"kernel {B}x{M}x{N} memory_analysis: "
            f"{compiled.memory_analysis()}")
        zeros = jnp.zeros((B,), jnp.float32)
        # the FB step: beta = 0, z_prev = x, no frozen lane
        _, z_k, res_k, _ = compiled(x, x, zeros, zeros)
        z_r, res_r = reference_fb_prox_grad(A, b, x, gamma, thr)
        ez = close(f"FB step z at B={B}", z_k, z_r)
        er = close(f"FB step residual at B={B}", res_k, res_r)
        # the full iteration: momentum, restart, every other lane frozen
        beta = jnp.full((B,), 0.4, jnp.float32)
        done = jnp.asarray(np.arange(B) % 2, jnp.float32)
        got = compiled(x, zp, beta, done)
        want = xla_fista_step(A, b, x, zp, beta, gamma, thr, done,
                              restart=True)
        errs = [close(f"full step output {i} at B={B}", g, w)
                for i, (g, w) in enumerate(zip(got, want))]
        say(f"kernel {B}x{M}x{N} vs XLA at HIGHEST: FB step max|dz| {ez:.3e}"
            f" max|dres| {er:.3e}; full step max errors "
            f"{', '.join(f'{e:.3e}' for e in errs)} (bound 2e-5*max(1,|ref|))")


def phase_main(data):
    from proxtpu.accel import AdaptiveRestartSequence, FixedNesterovSequence
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.kernels.lasso import lasso_step_route, solve_lasso_batch
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = (jnp.asarray(v) for v in data)
    assert lasso_step_route(A) == "kernel"
    solver = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        extrapolation_sequence=AdaptiveRestartSequence(
            FixedNesterovSequence()),
    )
    kw = dict(x0=jnp.zeros((BATCH, N), jnp.float32),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)
    out = solver(**kw)
    it_k = check_lasso("BatchedAlgorithm (fused kernel)", *data, out, TOL)
    xla = solve_lasso_batch(A, b, lam, Lf, TOL, maxit=MAXIT, restart=True,
                            use_kernel=False)
    it_x = check_lasso("same batch on the XLA step", *data, xla, TOL)
    compare_counts("fused kernel vs XLA step", it_k, it_x)
    # the yardstick for that comparison: the XLA step against itself, the
    # same lanes solved as two half-width batches
    half = BATCH // 2
    it_h = np.concatenate([np.asarray(solve_lasso_batch(
        A[s], b[s], lam[s], Lf[s], TOL, maxit=MAXIT, restart=True,
        use_kernel=False)[1]) for s in (slice(0, half), slice(half, None))])
    d = np.abs(it_h.astype(int) - np.asarray(it_x, int))
    say(f"XLA step at width {half} vs width {BATCH} (same lanes): per-lane "
        f"|d iters| histogram {np.bincount(np.minimum(d, 20)).tolist()} "
        f"(last bin >= 20), {100 * float(np.mean(d <= 2)):.1f}% of lanes "
        f"within 2")


def phase_stream(data):
    from proxtpu.kernels.lasso import solve_lasso_batch, solve_lasso_batch_tail
    from proxtpu.parallel import stream_solve

    # block_until_ready waits for the device: dispatch of a long matmul
    # chain returns before the work is done, the fence only after
    @jax.jit
    def chain(x):
        for _ in range(24):
            x = jnp.tanh(x @ x)
        return x

    big = jnp.full((4096, 4096), 1e-3, jnp.float32)
    jax.block_until_ready(chain(big))
    t0 = time.perf_counter()
    y = chain(big)
    t1 = time.perf_counter()
    ready_early = y.is_ready()
    jax.block_until_ready(y)
    t2 = time.perf_counter()
    assert y.is_ready()
    say(f"block_until_ready: dispatch returned in {1e3 * (t1 - t0):.3f} ms "
        f"(ready then: {ready_early}), fence returned after "
        f"{1e3 * (t2 - t0):.3f} ms with the result ready")

    A, b, lam, Lf = (jnp.asarray(v) for v in data)
    solve = jax.jit(lambda A, b, lam, Lf: solve_lasso_batch(
        A, b, lam, Lf, TOL, maxit=MAXIT, restart=True))
    jax.block_until_ready(solve(A, b, lam, Lf))
    t0 = time.perf_counter()
    outs = list(stream_solve(lambda p: solve(*p), [(A, b, lam, Lf)] * 6,
                             depth=2))
    dt = time.perf_counter() - t0
    for i, out in enumerate(outs):
        assert all(leaf.is_ready() for leaf in out)
        check_lasso(f"stream_solve output {i}", *data, out, TOL)
    say(f"stream_solve: 6 solves of {BATCH} problems, depth 2, "
        f"{1e3 * dt:.3f} ms in all")

    tail = jax.jit(lambda A, b, lam, Lf: solve_lasso_batch_tail(
        A, b, lam, Lf, TOL, maxit=MAXIT, k1=192, tail=BATCH // 4,
        restart=True))
    check_lasso(f"solve_lasso_batch_tail (k1=192, tail={BATCH // 4})", *data,
                tail(A, b, lam, Lf), TOL)


def phase_families(data):
    from proxtpu.accel import AdaptiveRestartSequence, FixedNesterovSequence
    from proxtpu.algorithms import (
        make_chambolle_pock_iteration,
        make_fast_forward_backward_iteration,
        make_forward_backward_iteration,
        make_zerofpr_iteration,
    )
    from proxtpu.kernels.lasso import solve_lasso_multirhs
    from proxtpu.ops.linops import Grad2DOperator
    from proxtpu.parallel import BatchedAlgorithm, Shared
    from proxtpu.prox import (
        IndBox,
        LeastSquaresLoss,
        NormL1,
        NormL21,
        Quadratic,
        SqrDistance,
    )

    rng = np.random.default_rng(0)

    # shared-A lambda path: one design matrix, a geometric lambda grid
    L, Ms, Ns = SHARED
    As = (rng.standard_normal((Ms, Ns)) / np.sqrt(Ms)).astype(F32)
    bs = rng.standard_normal(Ms).astype(F32)
    lmax = float(np.max(np.abs(As.T @ bs)))
    lams = np.geomspace(0.9 * lmax, 1e-3 * lmax, L).astype(F32)
    Lfs = F32(np.linalg.norm(As, 2) ** 2)
    kw = dict(x0=jnp.zeros((L, Ns), jnp.float32),
              f=Shared(LeastSquaresLoss(jnp.asarray(As), jnp.asarray(bs))),
              g=NormL1(jnp.asarray(lams)), Lf=Lfs)
    out = BatchedAlgorithm(make_fast_forward_backward_iteration,
                           maxit=5000, tol=TOL)(**kw)
    # the dispatcher routes this shape to the shared-A solver
    direct = solve_lasso_multirhs(
        jnp.asarray(As), jnp.broadcast_to(jnp.asarray(bs), (L, Ms)),
        jnp.asarray(lams), Lfs, TOL, maxit=5000)
    assert np.array_equal(np.asarray(out[1]), np.asarray(direct[1]))
    check_lasso(f"shared-A lambda path ({L} x {Ms}x{Ns})", As,
                np.broadcast_to(bs, (L, Ms)), lams, np.full(L, Lfs), out,
                TOL)

    # flat ZeroFPR on the flagship shape (fixed gamma = 0.95 / Lf)
    A, b, lam, Lf = data
    zf = BatchedAlgorithm(make_zerofpr_iteration, maxit=MAXIT, tol=TOL)
    xs, iters, done = (np.asarray(v) for v in zf(
        x0=jnp.zeros((BATCH, N), jnp.float32), f=SqrDistance(jnp.asarray(b)),
        A=jnp.asarray(A), g=NormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf)))
    assert done.all() and np.all(np.isfinite(xs))
    # the returned prox point's residual is at most the certified one
    gam = 0.95 / Lf.astype(np.float64)
    worst = float(np.max(lasso_residual(A, b, lam, gam, xs)))
    assert worst <= 1.1 * TOL, worst
    say(f"flat ZeroFPR ({BATCH} x {M}x{N}): all lanes done, max iters "
        f"{int(iters.max())}, float64 recheck {worst:.3e} <= 1.1*{TOL:g}")

    # box-constrained nonconvex QP
    (Bq, n), tol_q = QP, 1e-4
    U = np.linalg.qr(rng.standard_normal((Bq, n, n)))[0]
    ev = 2 * rng.random((Bq, n)) - 1
    Q = np.einsum("bij,bj,bkj->bik", U, ev, U)
    Q = (0.5 * (Q + np.swapaxes(Q, 1, 2))).astype(F32)
    q = rng.standard_normal((Bq, n)).astype(F32)
    Lip = np.max(np.abs(ev), axis=1).astype(F32)
    xq, itq, dq = (np.asarray(v) for v in BatchedAlgorithm(
        make_forward_backward_iteration, maxit=20_000, tol=tol_q)(
            x0=jnp.zeros((Bq, n), jnp.float32),
            f=Quadratic(jnp.asarray(Q), jnp.asarray(q)), g=IndBox(-1.0, 1.0),
            gamma=jnp.asarray(0.95 / Lip)))
    assert dq.all() and np.all(np.isfinite(xq))
    g64 = 0.95 / Lip.astype(np.float64)
    x64 = xq.astype(np.float64)
    step = np.clip(x64 - g64[:, None] * (np.einsum(
        "bij,bj->bi", Q.astype(np.float64), x64) + q), -1.0, 1.0)
    worst = float(np.max(np.max(np.abs(x64 - step), axis=1) / g64))
    # the returned point is one projected-gradient step past the certified
    # one; the step map is (1 + gamma ||Q||) <= 1.95 Lipschitz
    assert worst <= 2 * tol_q, worst
    say(f"box-QP ({Bq} x n={n}): all lanes done, max iters "
        f"{int(itq.max())}, float64 recheck {worst:.3e} <= 2*{tol_q:g}")

    # TV denoising by Chambolle-Pock
    (Bt, H, W), lam_tv, tol_tv = TV, 0.1, 1e-3
    clean = np.zeros((Bt, H, W), F32)
    clean[:, H // 4:3 * H // 4, W // 4:3 * W // 4] = 1.0
    noisy = (clean + 0.1 * rng.standard_normal((Bt, H, W))).astype(F32)
    (xt, yt), itt, dt = BatchedAlgorithm(
        make_chambolle_pock_iteration, maxit=20_000, tol=tol_tv)(
            x0=jnp.zeros((Bt, H, W), jnp.float32),
            y0=jnp.zeros((Bt, 2, H, W), jnp.float32),
            g=SqrDistance(jnp.asarray(noisy)), h=NormL21(lam_tv, axis=0),
            L=Grad2DOperator((H, W)))
    xt, yt, dt = np.asarray(xt, np.float64), np.asarray(yt, np.float64), \
        np.asarray(dt)
    assert dt.all() and np.all(np.isfinite(xt))
    worst = float(np.max(tv_residual(noisy.astype(np.float64), xt, yt,
                                     lam_tv)))
    assert worst <= 2 * tol_tv, worst
    say(f"TV Chambolle-Pock ({Bt} x {H}x{W}): all images done, max iters "
        f"{int(np.max(np.asarray(itt)))}, float64 one-step recheck "
        f"{worst:.3e} <= 2*{tol_tv:g}")

    # float64 lasso at a reference tolerance
    A64, b64, lam64, Lf64 = lasso_batch(BATCH, seed=0, dtype=np.float64)
    out = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=20_000, tol=1e-8,
        extrapolation_sequence=AdaptiveRestartSequence(
            FixedNesterovSequence()))(
        x0=jnp.zeros((BATCH, N), jnp.float64),
        f=LeastSquaresLoss(jnp.asarray(A64), jnp.asarray(b64)),
        g=NormL1(jnp.asarray(lam64)), Lf=jnp.asarray(Lf64))
    assert np.asarray(out[0]).dtype == np.float64
    check_lasso("float64 lasso at tol 1e-8", A64, b64, lam64, Lf64, out,
                1e-8)


def tv_residual(b, x, y, lam):
    """One Chambolle-Pock step from (x, y) in float64; per-image
    ``||xbar - x||_inf + ||ybar - y||_inf`` (the driver's criterion)."""
    from proxtpu.kernels.tv import default_tv_stepsizes

    g1, g2 = default_tv_stepsizes()
    yx, yy = y[:, 0], y[:, 1]
    dxm, dym = yx.copy(), yy.copy()
    dxm[:, -1, :] = 0.0
    dym[:, :, -1] = 0.0
    div = (dxm - np.roll(dxm, 1, axis=1)) + (dym - np.roll(dym, 1, axis=2))
    xbar = (x + g1 * div + g1 * b) / (1 + g1)
    mid = 2 * xbar - x
    gx = np.roll(mid, -1, axis=1) - mid
    gy = np.roll(mid, -1, axis=2) - mid
    gx[:, -1, :] = 0.0
    gy[:, :, -1] = 0.0
    vx, vy = yx + g2 * gx, yy + g2 * gy
    nrm = np.sqrt(vx * vx + vy * vy)
    scale = np.where(nrm > lam, lam / np.maximum(nrm, 1e-30), 1.0)
    return (np.max(np.abs(xbar - x), axis=(1, 2))
            + np.maximum(np.max(np.abs(vx * scale - yx), axis=(1, 2)),
                         np.max(np.abs(vy * scale - yy), axis=(1, 2))))


def phase_timing(data):
    from proxtpu.kernels.lasso import solve_lasso_batch

    for B in (BATCH, BATCH // 4):
        A, b, lam, Lf = (jnp.asarray(v[:B]) for v in data)
        runs = {
            "kernel": lambda: solve_lasso_batch(
                A, b, lam, Lf, TOL, maxit=MAXIT, restart=True),
            "xla": lambda: solve_lasso_batch(
                A, b, lam, Lf, TOL, maxit=MAXIT, restart=True,
                use_kernel=False),
        }
        for f in runs.values():
            wall(f)
        times = {k: [] for k in runs}
        for _ in range(5):
            for k, f in runs.items():
                times[k].append(wall(f))
        med = {k: float(np.median(v)) for k, v in times.items()}
        say(f"flagship solve {B}x{M}x{N} f32 tol {TOL:g} restart, median of "
            f"5: fused kernel {1e3 * med['kernel']:.3f} ms, XLA step "
            f"{1e3 * med['xla']:.3f} ms ({med['xla'] / med['kernel']:.3f}x); "
            f"runs kernel {[round(1e3 * t, 3) for t in times['kernel']]} "
            f"xla {[round(1e3 * t, 3) for t in times['xla']]}")


def phase_four():
    import __graft_entry__
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from proxtpu.accel import AdaptiveRestartSequence, FixedNesterovSequence
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.kernels.lasso import solve_lasso_batch
    from proxtpu.parallel import BatchedAlgorithm, sharded_solve_lasso_batch
    from proxtpu.prox import LeastSquaresLoss, NormL1

    devs = jax.devices()
    assert len(devs) == 4, devs
    data = lasso_batch(4 * BATCH)
    A, b, lam, Lf = (jnp.asarray(v) for v in data)
    mesh = Mesh(np.asarray(devs), ("dp",))

    one = solve_lasso_batch(A, b, lam, Lf, TOL, maxit=MAXIT, restart=True)
    it_one = check_lasso(f"{4 * BATCH} lanes on one card (fused kernel)",
                         *data, one, TOL)
    shard = sharded_solve_lasso_batch(A, b, lam, Lf, TOL, mesh=mesh,
                                      maxit=MAXIT, restart=True)
    assert len(shard[0].sharding.device_set) == 4
    it_sh = check_lasso(f"{4 * BATCH} lanes dp-sharded, {BATCH} per card "
                        "(sharded_solve_lasso_batch)", *data, shard, TOL)
    assert np.array_equal(it_sh, it_one)
    err = close("sharded vs one card", shard[0], one[0], rel=1e-6)
    say(f"sharded_solve_lasso_batch vs one card: counts identical, "
        f"max|dx| {err:.3e}")

    kw = dict(x0=jnp.zeros((4 * BATCH, N), jnp.float32),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)
    generic = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=False, extrapolation_sequence=AdaptiveRestartSequence(
            FixedNesterovSequence()))
    ref = generic(**kw)
    # the generic driver certifies its f32 residual at the extrapolated
    # point and returns the prox point one FB step on: in exact arithmetic
    # no larger, in f32 up to a few percent of tol above it on the worst
    # of 1024 lanes
    it_ref = check_lasso("generic driver on one card", *data, ref, TOL,
                         bound=1.2)
    dp = lambda v: jax.device_put(
        v, NamedSharding(mesh, P("dp", *([None] * (v.ndim - 1)))))
    kw_sh = dict(x0=dp(kw["x0"]), f=LeastSquaresLoss(dp(A), dp(b)),
                 g=NormL1(dp(lam)), Lf=dp(Lf))
    with mesh:
        gs = generic(**kw_sh)
    assert len(gs[0].sharding.device_set) == 4
    it_gs = check_lasso("generic driver, GSPMD dp over 4 cards", *data, gs,
                        TOL, bound=1.2)
    err = close("GSPMD vs one card", gs[0], ref[0], rel=1e-3)
    say(f"GSPMD generic driver vs one card: max|dx| {err:.3e}")
    compare_counts("GSPMD generic driver vs one card", it_gs, it_ref)

    __graft_entry__.dryrun_multichip(4)
    say("dryrun_multichip(4): dp x tp Shared operand, tp row-sharded PANOC, "
        "consensus ADMM, flat ZeroFPR and halt_nonfinite all match one "
        "device")


def main():
    global CARD
    four = "--four" in sys.argv[1:]
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        sys.exit(2)
    CARD = card()
    print(f"card: {CARD}", flush=True)
    enable_compile_cache()
    if four:
        phase_four()
    else:
        data = lasso_batch(BATCH)
        for phase in (phase_kernel, phase_main, phase_stream,
                      phase_families, phase_timing):
            t0 = time.perf_counter()
            phase(data)
            say(f"{phase.__name__} passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


CARD = None

if __name__ == "__main__":
    main()
