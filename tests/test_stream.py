"""Tests for :func:`proxtpu.parallel.stream_solve` (pipelined dispatch).

Semantics only (CPU): order preservation, depth handling, parity with
sequential execution, fence invocation.  How much a stream overlaps is a
device property that only a run on the card can show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proxtpu.kernels.lasso import solve_lasso_batch
from proxtpu.parallel import stream_solve


def _gen(B, m, n, seed):
    rng = np.random.default_rng(seed)
    As = (rng.standard_normal((B, m, n)) / np.sqrt(m)).astype(np.float32)
    bs = rng.standard_normal((B, m)).astype(np.float32)
    lams = 0.1 * np.max(
        np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1
    ).astype(np.float32)
    Lfs = np.array(
        [np.linalg.norm(As[i], 2) ** 2 for i in range(B)], np.float32
    )
    return tuple(map(jnp.asarray, (As, bs, lams, Lfs)))


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_stream_solve_matches_sequential(depth):
    problems = [_gen(4, 12, 16, seed) for seed in range(5)]

    def solve(p):
        A, b, lam, Lf = p
        return solve_lasso_batch(
            A, b, lam, Lf, 1e-6, maxit=2000, use_kernel=False
        )

    streamed = list(stream_solve(solve, problems, depth=depth))
    assert len(streamed) == len(problems)
    for p, out in zip(problems, streamed):
        xs_ref, iters_ref, done_ref = solve(p)
        np.testing.assert_array_equal(
            np.asarray(out[0]), np.asarray(xs_ref)
        )
        np.testing.assert_array_equal(
            np.asarray(out[1]), np.asarray(iters_ref)
        )
        assert np.asarray(out[2]).all()


def test_stream_solve_order_and_fence_calls():
    seen = []

    def solve(i):
        return {"i": jnp.asarray([i]), "big": jnp.zeros((8, 8)) + i}

    def fence(out):
        seen.append(int(np.asarray(out["i"])[0]))

    outs = list(stream_solve(solve, range(7), depth=2, fence=fence))
    assert [int(np.asarray(o["i"])[0]) for o in outs] == list(range(7))
    assert seen == list(range(7))  # fenced in order, exactly once each


def test_stream_solve_depth_validation():
    with pytest.raises(ValueError):
        list(stream_solve(lambda p: p, [1], depth=-1))


def test_stream_solve_default_fence_handles_scalars():
    outs = list(
        stream_solve(lambda i: (jnp.asarray(i), jnp.zeros(16)), range(3))
    )
    assert len(outs) == 3


def test_stream_solve_default_fence_blocks():
    """The default fence leaves every yielded output ready."""
    outs = list(stream_solve(
        lambda i: {"x": jnp.full((64, 64), float(i)) @ jnp.ones((64, 64))},
        range(4), depth=2))
    for i, out in enumerate(outs):
        assert out["x"].is_ready()
        assert float(out["x"][0, 0]) == 64.0 * i
