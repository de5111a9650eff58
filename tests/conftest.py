"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Tests run on a simulated 8-device CPU mesh (multi-device sharding without
a multi-GPU host); the GPU path is exercised by ``chip_smoke.py`` and by
the ``gpu``-marked tests, which skip on the CPU and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  float64 is
enabled because the reference test suite sweeps
Float32/Float64/ComplexF32/ComplexF64.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Keep the process under vm.max_map_count (default 65530, same on GitHub
# runners): every jitted XLA executable holds mmap'd JIT-code regions, and
# the full suite compiles thousands of programs — left alone, the process
# crosses the map limit after ~165 tests and the NEXT compile dies inside
# LLVM (SIGSEGV/SIGABRT in backend_compile_and_load; measured 58k+ maps
# right before the crash).  Dropping the compilation caches at module
# boundaries unmaps dead executables; cross-module cache reuse is near zero
# (each module compiles its own shapes), so this costs seconds, not minutes.
# ---------------------------------------------------------------------------

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_code_maps():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the fused kernel is compiled for the card")
