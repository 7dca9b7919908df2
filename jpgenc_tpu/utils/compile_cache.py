"""Persistent XLA compilation cache location (one rule for every launcher)."""
from __future__ import annotations

import os

#: the checkout's own cache directory (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    else is set here; otherwise the cache goes to <checkout>/.jax_cache.
    Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
