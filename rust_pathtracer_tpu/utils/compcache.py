"""Persistent XLA compilation cache.

Repeat runs (bench, CLI, chip_smoke) reuse compiled accelerator
programs instead of recompiling the bounce loops.  Call early, before
the first jit execution.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
this module sets no directory.  Otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (listed in .gitignore).  CPU programs are
not cached: their executables are specific to the host's instruction
set.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache",
)


def cache_dir() -> tuple[str, bool]:
    """(directory, whether this module must set it): the environment's
    ``JAX_COMPILATION_CACHE_DIR`` if set, else DEFAULT_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return (env, False) if env else (DEFAULT_DIR, True)


def enable() -> str:
    """Turn the persistent cache on for accelerator backends; returns
    the directory in use ("" on the CPU)."""
    import jax

    if jax.default_backend() == "cpu":
        return ""
    path, must_set = cache_dir()
    if must_set:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
