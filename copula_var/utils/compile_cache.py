"""Persistent XLA compilation cache helper.

Compiles of the scan-heavy fits and the solve programs are identical run
to run; one cache directory shared by every entry point makes the second
invocation of any benchmark, test tier or driver run near-free. The
reference has no analog (numba caches per-process in memory only)."""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The cache directory: `$JAX_COMPILATION_CACHE_DIR` when set, else
    the fixed `<repo>/.jax_cache` (the path is part of the cache key, so
    it must not move between runs)."""
    return os.environ.get(_ENV) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        ".jax_cache",
    )


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads
    it and no other directory is set here. Idempotent."""
    import jax

    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir()
