"""Example: batched 1-D total-variation denoising with the TV prox.

    minimize  1/2 ||x - y||^2 + lam * sum_i |x_{i+1} - x_i|

The solution is ONE prox evaluation: ``TotalVariation1D(lam).prox(y, 1.0)``.
Upstream, ``ProximalOperators.TotalVariation1D`` computes this with Condat's
sequential taut-string scan — one signal at a time.  The batched prox is
a dual FGP with adaptive restart (fixed-shape ``lax`` loop), so a whole
BATCH of signals denoises as one vectorized ``vmap`` call
(``benchmarks/tv1d_bench.py`` measures it against the taut string).

    python examples/tv1d_denoising.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from proxtpu.prox import TotalVariation1D


def main(verbose=True):
    rng = np.random.default_rng(0)
    B, N, pieces = 64, 512, 8
    steps = np.cumsum(rng.standard_normal((B, pieces)), axis=1)
    clean = np.repeat(steps, N // pieces, axis=1)
    noisy = clean + 0.3 * rng.standard_normal((B, N))

    tv = TotalVariation1D(0.3)
    denoise = jax.jit(jax.vmap(lambda y: tv.prox(y, 1.0)[0]))
    x = np.asarray(denoise(jnp.asarray(noisy)))

    def snr(u):
        return 10 * np.log10(np.mean(clean**2) / np.mean((u - clean) ** 2))

    out = {"snr_noisy": snr(noisy), "snr_denoised": snr(x)}
    if verbose:
        print(f"batch of {B} signals, length {N}")
        print(f"SNR noisy:    {out['snr_noisy']:6.2f} dB")
        print(f"SNR denoised: {out['snr_denoised']:6.2f} dB")
    return out


if __name__ == "__main__":
    main()
