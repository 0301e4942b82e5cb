"""Persistent XLA compilation cache (EXTENSION — no reference analogue).

The reference has no compilation step; here the first build/query of each
process pays XLA trace+compile for every new shape. Enabling the on-disk
cache lets every later process reuse the compiled executables.
"""

from __future__ import annotations

import os

#: Cache location when ``JAX_COMPILATION_CACHE_DIR`` is not set: a fixed
#: directory in the checkout (git-ignored), so every run from one checkout
#: finds what the earlier ones compiled.
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turns on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and
    that directory is used as it is. Otherwise the cache goes to
    :data:`DEFAULT_DIR`. Apply before any compilation.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return DEFAULT_DIR
