"""Process-wide JAX settings shared by every entry point (the CLI, bench.py,
chip_smoke.py and the test configuration)."""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_cache_dir() -> str:
    """`<checkout>/.jax_cache`: a fixed path, so later runs find the
    entries again (the path is part of the cache key; .gitignore lists it)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def setup_jax() -> str:
    """Persistent compilation cache and matmul precision for this process;
    returns the cache directory in use.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache is `<checkout>/.jax_cache`.
    Every compile is cached, however short: a solve compiles dozens of small
    programs whose total dominates a cold start.

    f32 matmuls run at HIGHEST precision: at DEFAULT the GPU may use TF32
    (10 mantissa bits), which the small per-factor products of the residual
    and Jacobian code cannot afford."""
    cache = os.environ.get(CACHE_ENV)
    if not cache:
        cache = checkout_cache_dir()
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_default_matmul_precision", "highest")
    return cache
