"""Persistent XLA compilation cache setup.

Compile time dominates short runs (tests, CLI apps, the chip smoke test);
the JAX persistent cache makes every recompile of an unchanged computation a
disk hit.  Call :func:`enable` before building any computation.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, used as
is; otherwise the fixed ``<checkout>/.jax_cache`` (listed in .gitignore).
A fixed path matters: the path is part of the cache key, so a directory
that moves between runs never hits.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
