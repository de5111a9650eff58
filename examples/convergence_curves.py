"""Example: compare solver convergence curves with on-device recording.

Solves one lasso instance with three solvers and records the fixed-point
residual ``||x - z||_inf / gamma`` every iteration *inside* the compiled
loop (``run_recorded`` — no host callbacks, no eager stepping), then prints
the curves side by side.  The quasi-Newton line-search solvers reach the
same solution in ~10x fewer iterations than FISTA — the trade every user
of this library should see once.

    python examples/convergence_curves.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

import proxtpu as pa
from proxtpu.prox import NormL1, make_least_squares
from proxtpu.utils.tree import tree_inf_norm

TOL = 1e-5  # attainable in float32 (the default dtype); tighten under jax_enable_x64
MAXIT = 1000


def residual(iteration, k, state):
    return tree_inf_norm(state.res) / state.gamma


def main(verbose=True):
    rng = np.random.default_rng(3)
    m, n = 60, 120
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m))
    b = jnp.asarray(rng.standard_normal(m))
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    problem = dict(
        x0=jnp.zeros(n), f=make_least_squares(A, b), g=NormL1(lam), Lf=Lf
    )

    solvers = {
        "FISTA": pa.FastForwardBackward(tol=TOL, maxit=MAXIT),
        "PANOC": pa.PANOC(tol=TOL, maxit=MAXIT),
        "ZeroFPR": pa.ZeroFPR(tol=TOL, maxit=MAXIT),
    }
    out = {}
    for name, solver in solvers.items():
        x, it, tr = solver.run_recorded(residual, **problem)
        out[name] = dict(
            x=np.asarray(x), it=int(it), curve=np.asarray(tr.valid())
        )

    # all solvers agree on the minimizer
    ref = out["FISTA"]["x"]
    for name, r in out.items():
        gap = float(np.max(np.abs(r["x"] - ref)))
        # agreement at the tol-ball (f32-safe; ~1e-7 under x64)
        assert gap < 2e-3, f"{name} disagrees with FISTA by {gap}"

    if verbose:
        ks = [1, 2, 5, 10, 20, 50, 100, 200, 500, MAXIT]
        print(f"{'iter':>6} | " + " | ".join(f"{s:>10}" for s in out))
        for k in ks:
            row = []
            for r in out.values():
                c = r["curve"]
                row.append(f"{c[k - 1]:10.2e}" if k <= len(c) else " " * 10)
            print(f"{k:>6} | " + " | ".join(row))
        print("iterations to tol=%g: " % TOL
              + ", ".join(f"{s}={r['it']}" for s, r in out.items()))
    return out


if __name__ == "__main__":
    main()
