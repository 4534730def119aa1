"""Placement of JAX's persistent compilation cache."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here; otherwise the cache lives in
    <checkout>/.jax_cache.  The cache is on for every backend."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
