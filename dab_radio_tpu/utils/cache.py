"""Persistent XLA compilation cache for the entry points.

The 16-stream fused round compiles for minutes; the on-disk cache makes a
second run of the same program start in seconds. Where the environment sets
JAX_COMPILATION_CACHE_DIR, JAX reads it itself and no directory is set here.
Otherwise the cache lives at a fixed `.jax_cache/` inside the checkout
(listed in .gitignore): the path is part of the cache key, so it must not
move between runs.
"""

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
