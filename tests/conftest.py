"""Test configuration: CPU platform with 8 virtual devices for sharding tests,
f64 enabled before jax initializes. jax.config.update('jax_platforms', ...)
holds the suite on the CPU whatever JAX_PLATFORMS says; the GPU path is
checked on the card by chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# No persistent compile cache under pytest: serializing an executable for the
# cache WRITE segfaults (zstd path in jax's put_executable_and_time) once a
# single process has compiled a few hundred executables -- reproduced twice at
# the same test, 40 min into the suite, and never in short-lived processes.
# CLI runs (one config per process) keep the cache; the suite always
# cold-compiles, which is slower but deterministic.
os.environ.setdefault("HELFEM_TPU_CACHE", "0")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_jit_code():
    """Release compiled executables between test modules. Every XLA:CPU
    JIT executable holds multiple mmap'd code regions; a full-suite process
    accumulates past vm.max_map_count (65530 default: one test module alone
    reaches ~15k maps) after which mmap fails and LLVM SEGFAULTS -- the
    suite died twice at ~75% inside backend_compile. clear_caches() +
    gc drops the maps (measured 820 -> 462 after 60 compiles)."""
    yield
    jax.clear_caches()
    gc.collect()

