"""Forward-backward toolkit: quadratic model, Lipschitz estimate, backtracking.

Functional JAX port of the shared toolkit at
``/root/reference/src/utilities/fb_tools.jl`` used by five algorithms
(SURVEY.md §1 L1).  The reference's in-place ``backtrack_stepsize!`` becomes a
pure ``lax.while_loop`` whose carry holds the candidate stepsize and all
recomputed forward/prox quantities — data-dependent, bounded below by
``minimum_gamma`` exactly like the reference (``fb_tools.jl:24-63``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..prox.base import prox, value_and_gradient
from .tree import (
    eps_of,
    tree_map,
    tree_norm_sq,
    tree_size,
    tree_sub,
    tree_vdot_real,
)


def f_model(f_x, grad_f_x, res, L):
    """Quadratic upper model f(x) - <grad, res> + L/2 ||res||^2
    (``fb_tools.jl:3-5``)."""
    return f_x - tree_vdot_real(grad_f_x, res) + (L / 2) * tree_norm_sq(res)


def lower_bound_smoothness_constant(f, A, x, grad_f_Ax):
    """Finite-difference lower bound on the Lipschitz constant of
    grad(f o A), used to initialise gamma when neither Lf nor gamma is given
    (``fb_tools.jl:7-19``)."""
    from .tree import real_dtype_of

    xeps = tree_map(lambda l: l + 1, x)
    _, grad_f_Axeps = value_and_gradient(f, A.matvec(xeps))
    diff = A.rmatvec(tree_sub(grad_f_Axeps, grad_f_Ax))
    n = jnp.asarray(float(tree_size(x)), real_dtype_of(x))
    return jnp.sqrt(tree_norm_sq(diff)) / jnp.sqrt(n)


class BacktrackResult(NamedTuple):
    gamma: jnp.ndarray
    y: object
    z: object
    g_z: jnp.ndarray
    res: object
    Az: object
    f_Az: jnp.ndarray
    grad_f_Az: object
    f_Az_upp: jnp.ndarray


def backtrack_stepsize(
    gamma,
    f,
    A,
    g,
    x,
    f_Ax,
    At_grad_f_Ax,
    y,
    z,
    g_z,
    res,
    *,
    alpha=1.0,
    minimum_gamma=1e-7,
    reduce_gamma=0.5,
    max_backtracks=None,
):
    """Armijo-style sufficient-decrease backtracking on the quadratic model.

    Halve ``gamma`` until ``f(Az) <= f_model(...) + 10 eps (1+|f(Az)|)`` or
    ``gamma < minimum_gamma`` — a faithful functional port of
    ``backtrack_stepsize!`` (``fb_tools.jl:24-63``).  The incoming
    ``y/z/g_z/res`` must be consistent with the *incoming* gamma, exactly as
    in the reference call sites; they are only recomputed once gamma shrinks.

    ``max_backtracks=None`` (default) runs a data-dependent
    ``lax.while_loop`` — exact reference semantics, and cheapest for
    single-problem solves (zero body executions when the model already
    holds).  ``max_backtracks=T`` (a static int) runs a *bounded*
    ``lax.fori_loop`` of exactly T masked trials instead: once the accept
    condition (or the ``minimum_gamma`` floor) is hit, later trials are
    computed but discarded via ``where``-selects.  The result is identical
    whenever the while-loop would have stopped within T halvings — and the
    reference itself bounds the search by ``minimum_gamma``
    (``fb_tools.jl:24-63``), so ``T >= log2(gamma0/minimum_gamma)`` makes
    the two modes exactly equivalent.  The bounded form is what makes
    ``adaptive=True`` batchable: a nested data-dependent while-loop under
    ``vmap`` can compile pathologically slowly (minutes at tiny shapes), while
    the fixed-trip loop compiles like any other scan.
    """
    eps = eps_of(x)

    f_Az_upp0 = f_model(f_Ax, At_grad_f_Ax, res, alpha / gamma)
    Az0 = A.matvec(z)
    f_Az0, grad_f_Az0 = value_and_gradient(f, Az0)

    def accept(c):
        tol = 10 * eps * (1 + jnp.abs(c.f_Az))
        return (c.f_Az <= c.f_Az_upp + tol) | (c.gamma < minimum_gamma)

    def trial(c):
        gamma = c.gamma * reduce_gamma
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, At_grad_f_Ax)
        z, g_z = prox(g, y, gamma)
        res = tree_sub(x, z)
        f_Az_upp = f_model(f_Ax, At_grad_f_Ax, res, alpha / gamma)
        Az = A.matvec(z)
        f_Az, grad_f_Az = value_and_gradient(f, Az)
        return BacktrackResult(gamma, y, z, g_z, res, Az, f_Az, grad_f_Az, f_Az_upp)

    init = BacktrackResult(
        jnp.asarray(gamma), y, z, jnp.asarray(g_z), res, Az0, f_Az0, grad_f_Az0,
        jnp.asarray(f_Az_upp0),
    )

    if max_backtracks is None:
        return jax.lax.while_loop(
            lambda c: jnp.logical_not(accept(c)), trial, init
        )

    def masked_trial(_, c):
        new = trial(c)
        keep = accept(c)  # already accepted -> discard this trial
        return jax.tree.map(
            lambda old, cand: jnp.where(keep, old, cand), c, new
        )

    return jax.lax.fori_loop(0, int(max_backtracks), masked_trial, init)
