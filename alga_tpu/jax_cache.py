"""One directory for JAX's persistent compile cache and the GCPS
capacity-hint files.

A second process then starts with both compiled executables and converged
capacities.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself
and the program uses that directory and sets no other; otherwise the
directory is `<repo>/.jax_cache/` (listed in `.gitignore`).  The path is
fixed: it is part of the cache's key, so a moving directory never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; safe to
    call repeatedly, before or after backend init.  Returns the dir."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
