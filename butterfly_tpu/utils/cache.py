"""Persistent XLA compilation cache.

Cold compiles of the larger applies cost seconds each; the persistent cache
makes every executable a one-time cost across processes (benchmark runs,
examples, the chip smoke test).

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (and no
other directory), else `.jax_cache/` at the root of this checkout, which
`.gitignore` lists. A fixed path matters: the directory is part of the
cache key, so a cache that moves never hits.

(The reference has no analogue — its "compile" is cc at build time.)
"""

from __future__ import annotations

import os

__all__ = ["enable_persistent_compile_cache", "compile_cache_dir"]

_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


def enable_persistent_compile_cache() -> str:
    """Idempotently point JAX's compilation cache at `compile_cache_dir()`.
    Call before the first jit compile. Returns the cache path."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
