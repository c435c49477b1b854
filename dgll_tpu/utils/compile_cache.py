"""Persistent XLA compilation cache for the entry points.

With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory itself and
nothing is set here. Otherwise the cache lives at ``<checkout>/.jax_cache``: a
fixed path, because the cache is only found again at the same path. Call
:func:`enable_compile_cache` before the first compilation of the process.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
