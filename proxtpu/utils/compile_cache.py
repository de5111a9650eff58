"""JAX's persistent compilation cache for the program's entry scripts.

A run on a fresh machine compiles every solver program again; the cache
keeps compiled executables on disk between processes of one checkout.
:func:`enable_compile_cache` is called by the entry scripts (``bench.py``,
``chip_smoke.py``, the benchmark scripts), never on ``import proxtpu``.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``.jax_cache`` at the root
    of the checkout: a fixed path, because the directory is part of what a
    later process must find again.
    """
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
