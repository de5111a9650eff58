"""Consensus splitting across devices — block/"pipeline" parallelism for
block-separable problems.

Solves  minimize  sum_i f_i(x) + g(x)  by consensus ADMM: each of B blocks
(e.g. row-blocks of a huge least-squares) holds a local copy x_i advanced by
its own prox, coupled through the consensus average (SURVEY.md §2.6: the
consensus-averaging collective is the batched analogue of the reference's
nonexistent distributed layer).

Layout: block quantities are stacked on a leading axis (B, ...) which can be
sharded over a mesh axis (``shard_batch``); the per-block proxes vmap into
one batched op, and ``jnp.mean(x, 0)`` over the sharded axis compiles to
a local partial mean + psum over the device interconnect.  The iteration plugs into the standard
jitted while-loop driver.

    x_i <- prox_{gamma f_i}(z - u_i)
    xbar <- mean_i(x_i + u_i)
    z    <- prox_{gamma/B g}(xbar)
    u_i  <- u_i + x_i - z

(scaled-dual consensus ADMM; Boyd et al. 2011, §7.1-7.2.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..algorithms.common import astree, real_dtype, rscalar
from ..algorithms.core import IterativeAlgorithm
from ..prox.base import Zero, prox, proxclass
from ..utils.tree import tree_inf_norm, tree_map, tree_sub


class ConsensusADMMState(NamedTuple):
    x: object      # (B, ...) block-local iterates
    z: object      # (...) consensus point
    u: object      # (B, ...) scaled duals
    res_primal: jnp.ndarray
    res_dual: jnp.ndarray


@proxclass(meta_fields=("num_blocks",))
class ConsensusADMMIteration:
    fs: object     # stacked pytree of block functions (leading axis B)
    g: object      # shared regularizer applied to the consensus point
    x0: object     # (...) initial consensus point
    gamma: object
    num_blocks: int

    def init(self):
        B = self.num_blocks
        z = self.x0
        x = tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), z)
        u = tree_map(jnp.zeros_like, x)
        R = self.gamma.dtype
        return self.step(
            ConsensusADMMState(
                x, z, u, jnp.asarray(jnp.inf, R), jnp.asarray(jnp.inf, R)
            )
        )

    def step(self, s):
        B = self.num_blocks
        vprox = jax.vmap(lambda f, v: prox(f, v, self.gamma)[0])
        arg = tree_map(lambda zl, ul: zl[None] - ul, s.z, s.u)
        x = vprox(self.fs, arg)
        xbar_pu = tree_map(lambda xl, ul: jnp.mean(xl + ul, 0), x, s.u)
        z, _ = prox(self.g, xbar_pu, self.gamma / B)
        u = tree_map(lambda ul, xl, zl: ul + xl - zl[None], s.u, x, z)
        res_primal = tree_inf_norm(tree_map(lambda xl, zl: xl - zl[None], x, z))
        res_dual = tree_inf_norm(tree_sub(z, s.z)) / self.gamma
        return ConsensusADMMState(x, z, u, res_primal, res_dual)

    def default_stopping_criterion(self, tol, s):
        return (s.res_primal <= tol) & (s.res_dual <= tol)

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        jax.debug.print(
            "{:5d} | {:.3e} | {:.3e}", k, s.res_primal, s.res_dual
        )


def make_consensus_admm_iteration(*, x0, fs, g=None, gamma, num_blocks=None):
    """``fs`` is a stacked pytree of B block functions (build with
    ``jax.tree.map(lambda *ls: jnp.stack(ls), *block_fns)``)."""
    g = Zero() if g is None else g
    x0 = astree(x0)
    R = real_dtype(x0)
    if num_blocks is None:
        num_blocks = jax.tree.leaves(fs)[0].shape[0]
    return ConsensusADMMIteration(
        fs=fs, g=g, x0=x0, gamma=rscalar(gamma, R),
        num_blocks=int(num_blocks),
    )


def ConsensusADMM(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                  verbose=False, freq=100, display=None, **kwargs):
    """Consensus-ADMM solver over stacked (optionally device-sharded) blocks."""
    return IterativeAlgorithm(
        make_consensus_admm_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )


def stack_functions(fns):
    """Stack identically-structured prox functions along a new leading axis."""
    return jax.tree.map(lambda *ls: jnp.stack(ls), *fns)
