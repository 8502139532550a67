"""Where JAX keeps its persistent compilation cache, for every entry point.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX itself reads it and
no other directory is set here. When it is not set, the cache lives at one
fixed path inside the checkout (`<repo>/.jax_cache`, listed in `.gitignore`),
so every process of every run finds the entries the others wrote: the path is
part of the cache key, and a directory named from a pid, a temp name or the
time would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the cache uses: the env var's, else the checkout's."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent cache on for programs that take at least
    `min_compile_time_secs` to compile; returns the directory in use."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return d
