"""Persistent compilation cache.

The only expensive state in this package is XLA compilation: a cold
process compiles each program shape anew (tens of seconds for the 1080p
batch program).  ``enable_compilation_cache`` keeps compiled executables
on disk so a restarted pipeline or benchmark starts without recompiling.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, so nothing here overrides it), otherwise one
fixed directory inside the checkout.  The directory is part of the cache
key, so it never depends on a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache. Returns the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
