"""Persistent XLA compilation cache for the command-line entry points.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
directory is set here. Otherwise compiled programs are kept in one
fixed directory inside the checkout (`.jax_cache/`, git-ignored): a
fixed path, because the path is part of the cache key, so a directory
that moves between runs never hits.

The test suite turns the persistent cache off (`tests/conftest.py`).
"""
from __future__ import annotations

import os
import pathlib

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    cache every program regardless of its compile time. Returns the
    directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
