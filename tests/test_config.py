"""Persistent compile cache location (utils/config.py:cache_dir)."""

import os

import jax
import pytest

from helfem_tpu.utils import config

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/jc"}, "/somewhere/jc"),
    ({}, os.path.join(CHECKOUT, ".jax_cache")),
    ({"HELFEM_TPU_CACHE": "0"}, None),
    ({"HELFEM_TPU_CACHE": "0", "JAX_COMPILATION_CACHE_DIR": "/somewhere/jc"}, None),
], ids=["jax-env", "default", "off", "off-beats-jax-env"])
def test_cache_dir(environ, expected):
    assert config.cache_dir(environ) == expected


def test_off_switch_disables_jax_env_cache(monkeypatch):
    monkeypatch.setenv("HELFEM_TPU_CACHE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/jc")
    before = jax.config.jax_enable_compilation_cache
    try:
        config.setup_x64()
        assert jax.config.jax_enable_compilation_cache is False
    finally:
        jax.config.update("jax_enable_compilation_cache", before)
