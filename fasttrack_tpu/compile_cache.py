"""Where JAX keeps its persistent compilation cache.

Every entry script (benches, drivers, tools, the test configuration) calls
`enable_compile_cache()` once before its first compile, so all of them share
one cache. The directory is part of the cache's key, so it is fixed:

- `JAX_COMPILATION_CACHE_DIR`, when set, is used as it is;
- otherwise `.jax_cache` at the root of the checkout (git-ignored).
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The compilation cache directory this process should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` and cache
    every program that took at least half a second to compile. Returns the
    directory."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
