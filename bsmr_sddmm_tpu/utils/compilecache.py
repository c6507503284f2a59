"""Persistent XLA compilation cache for the entry points.

Every distinct plan-shape bucket costs a fresh XLA compile at run time.
A disk cache keyed by XLA's own fingerprint lets repeated runs (bench.py,
chip_smoke.py, the CLI, the replica suite) reuse executables across
processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no directory of its own. Otherwise the cache goes to the
checkout's ``.jax_cache/`` (gitignored), a fixed path: the path is part
of the cache key, so a directory that moves never hits.

Opt-in per entry point (like utils.hostmem.tune_malloc): the library
never mutates global JAX config on import.
"""

from __future__ import annotations

import os

#: the in-checkout default cache directory
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory."""
    import jax
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = DEFAULT_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # cache every compile that took >= 1 s, whichever process wrote it
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
