"""Persistent XLA compilation cache.

A carve compiles one program per (shape, seam count); the persistent cache
makes a repeat run of the CLI or the bench with the same shapes skip the
compile.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its
cache there and this module sets nothing.  Otherwise the cache lives at a
fixed path inside the checkout, `.jax_cache/` (listed in `.gitignore`).
Enabled by the CLI and bench entry points; library users can call
`enable_compilation_cache()` themselves.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "cache_dir"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
