"""Example: graphical lasso — sparse inverse covariance estimation.

    minimize_{Theta > 0}  tr(S Theta) - logdet(Theta) + lam * ||Theta||_1,off

Douglas-Rachford splitting over a MATRIX iterate:

* f = Tilt(NegLogDet(1), S): prox diagonalizes (on-device ``eigh``) and
  shifts eigenvalues by (w + sqrt(w^2 + 4 gamma))/2 — every iterate stays
  inside the PD cone, no line search, no barrier parameter schedule;
* g = NormL1(lam * (1 - I)): the weighted-l1 prox thresholds off-diagonal
  entries only (``ProximalOperators.NormL1`` with an array lambda).

The lam PATH is the batched story: `vmap` over the regularization value
turns the path sweep into one batched eigh-prox drive — the same scenario
batching every other family uses (``docs/scaling.md``).

    python examples/graphical_lasso.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# the KKT certificate checks entries at 1e-6; run the example in f64
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from proxtpu.algorithms import DouglasRachfordIteration
import proxtpu as pa
from proxtpu.prox import NegLogDet, NormL1, Tilt


def make_problem(n=20, density=0.1, seed=0):
    """Sparse SPD precision matrix and its exact covariance."""
    rng = np.random.default_rng(seed)
    P = np.zeros((n, n))
    idx = rng.random((n, n)) < density
    vals = rng.uniform(0.3, 0.8, (n, n)) * np.sign(rng.standard_normal((n, n)))
    P[idx] = vals[idx]
    P = (P + P.T) / 2
    np.fill_diagonal(P, np.abs(P).sum(axis=1) + 0.5)
    S = np.linalg.inv(P)
    return jnp.asarray(P), jnp.asarray((S + S.T) / 2)


def solve_glasso(S, lam, gamma=2.0, tol=1e-8, maxit=3000):
    n = S.shape[0]
    f = Tilt(NegLogDet(1.0), S)
    g = NormL1(lam * (1.0 - jnp.eye(n, dtype=S.dtype)))
    x0 = jnp.eye(n, dtype=S.dtype)
    return pa.DouglasRachford(gamma=gamma, tol=tol, maxit=maxit)(
        x0=x0, f=f, g=g
    )


def solve_glasso_path(S, lams, gamma=2.0, iters=500):
    """One vmapped DR drive over the whole lam path (fixed iteration
    budget; per-lam convergence is checked by the caller via KKT)."""
    n = S.shape[0]
    eye = jnp.eye(n, dtype=S.dtype)

    def run(lam):
        it = DouglasRachfordIteration(
            f=Tilt(NegLogDet(1.0), S),
            g=NormL1(lam * (1.0 - eye)),
            x0=eye,
            gamma=gamma,
        )
        s = it.init()
        s = jax.lax.fori_loop(0, iters, lambda _, st: it.step(st), s)
        return s.y

    return jax.vmap(run)(lams)


def main(verbose=True):
    P, S = make_problem()
    n = S.shape[0]
    off = ~np.eye(n, dtype=bool)
    true_edges = off & (np.abs(np.asarray(P)) > 1e-12)

    lams = jnp.asarray(np.geomspace(0.005, 0.3, 16))
    thetas = solve_glasso_path(S, lams)

    rows = []
    for i, lam in enumerate(np.asarray(lams)):
        T = np.asarray((thetas[i] + thetas[i].T) / 2)
        est_edges = off & (np.abs(T) > 1e-5)
        tp = int((est_edges & true_edges).sum())
        fp = int((est_edges & ~true_edges).sum())
        rows.append((float(lam), int(est_edges.sum()) // 2, tp, fp))
        if verbose:
            print(
                f"lam={lam:8.4f}  edges={rows[-1][1]:3d}  "
                f"true-pos={tp // 2:3d}  false-pos={fp // 2:3d}"
            )

    # single solve at a moderate lam, with the KKT certificate
    lam = 0.05
    theta, it = solve_glasso(S, lam)
    T = np.asarray((theta + theta.T) / 2)
    G = np.asarray(S) - np.linalg.inv(T)
    kkt_diag = float(np.max(np.abs(G[np.eye(n, dtype=bool)])))
    nz = off & (np.abs(T) > 1e-6)
    kkt_nz = float(np.max(np.abs(G[nz] + lam * np.sign(T[nz])))) if nz.any() else 0.0
    kkt_z = float(np.max(np.abs(G[off & ~nz]))) if (off & ~nz).any() else 0.0

    if verbose:
        print(
            f"\nlam={lam}: {int(it)} DR iterations, "
            f"KKT diag {kkt_diag:.2e} | nonzero {kkt_nz:.2e} | "
            f"zero-bound {kkt_z:.3f} <= lam={lam}"
        )

    return {
        "iterations": int(it),
        "kkt_diag": kkt_diag,
        "kkt_nz": kkt_nz,
        "kkt_zero_bound_ok": kkt_z <= lam + 1e-6,
        "path": rows,
        "min_eig": float(np.linalg.eigvalsh(T).min()),
    }


if __name__ == "__main__":
    main()
