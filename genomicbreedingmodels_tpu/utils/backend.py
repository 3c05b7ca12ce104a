"""Which device JAX runs on, and where the persistent compile cache lives.

The one place in the package that asks for the platform: the sampler's
kernel choice and the benchmark's sizes both go through `platform()`.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: fixed, so that one process finds what an earlier one
# compiled (the directory is part of the cache key). Listed in .gitignore.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def platform() -> str:
    """Platform of JAX's default device: "gpu", "cpu", ..."""
    import jax

    return jax.devices()[0].platform


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and no other
    directory is set here."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
