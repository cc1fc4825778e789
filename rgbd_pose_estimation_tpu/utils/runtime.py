"""Process set-up shared by the CLI, the benchmark and the chip smoke test."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
    reads it itself). Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``: the path is part of the cache key, so a
    directory that moved between runs would never hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
