"""The persistent XLA compilation cache: one rule for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another directory.  Otherwise the cache lives at a fixed path in
the checkout (``.jax_cache``, listed in ``.gitignore``): the path is part
of what a later process must find again, so it never moves.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR


def disable_compile_cache() -> None:
    """Compile everything afresh (cold-compile measurements)."""
    import jax
    jax.config.update("jax_enable_compilation_cache", False)
