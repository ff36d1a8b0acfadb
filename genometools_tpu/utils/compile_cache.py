"""Placement of JAX's persistent compilation cache.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory of its own.  Otherwise every entry point of the
repository (CLI, bench, smoke test, scripts) keeps the cache at one
fixed path, ``<checkout>/.jax_cache``, so that every process of one
checkout finds the programs the others compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX at the cache directory chosen by the rule above and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(CHECKOUT_CACHE)
