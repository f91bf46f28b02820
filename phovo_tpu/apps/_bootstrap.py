"""Shared app bootstrap."""

from __future__ import annotations

import os
from pathlib import Path

# The one cache directory the program chooses itself: inside the checkout
# (listed in .gitignore), at a fixed path so that a later run finds it.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str | None:
    """Persist XLA compilations across runs; returns the directory in use.

    The multi-level alignment programs take tens of seconds to compile; the
    persistent cache (keyed on program + compiler version) makes every run
    after the first start fast. When JAX_COMPILATION_CACHE_DIR is set, JAX
    reads it itself and nothing here overrides it; otherwise the cache goes
    to CACHE_DIR.
    """
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    # CPU backend: LoadedExecutable.serialize() C-aborts for some CPU
    # executables in this jax build, and a write aborted mid-entry leaves a
    # corrupt cache file that later SEGFAULTS readers of the same key
    # (observed deterministically in the test suite once a CLI test flipped
    # the cache on mid-run).  CPU compiles are fast; the cache exists for
    # the accelerator's tens-of-seconds compiles.
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(CACHE_DIR)
