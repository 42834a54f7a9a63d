"""Global configuration: float64 discipline + persistent compile cache.

Everything in this suite lives or dies on f64 (the reference needs
stabilization tricks even *within* f64). We therefore enable jax x64 mode at
import time, before any arrays are created. A persistent compilation cache
amortizes the (minutes-long, at the big discretizations) compiles across
processes.
"""

import os

import jax

# checkout root: the directory that holds the helfem_tpu package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir(environ=None) -> str | None:
    """Directory of JAX's persistent compile cache, or None for no cache.

    HELFEM_TPU_CACHE=0 switches the cache off. Otherwise JAX's own
    JAX_COMPILATION_CACHE_DIR wins when it is set; the default is the fixed
    <checkout>/.jax_cache/. JAX keys every entry by backend platform and
    version, so one directory serves the CPU and the GPU."""
    env = os.environ if environ is None else environ
    if env.get("HELFEM_TPU_CACHE") == "0":
        return None
    return env.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_CHECKOUT, ".jax_cache")


def setup_x64() -> None:
    jax.config.update("jax_enable_x64", True)
    path = cache_dir()
    if path is None:
        # also drops a cache JAX picked up from JAX_COMPILATION_CACHE_DIR
        jax.config.update("jax_enable_compilation_cache", False)
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
