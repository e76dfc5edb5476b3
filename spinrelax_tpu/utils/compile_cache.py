"""Persistent XLA compilation cache for the CLI surface and chip runs.

Every ``spinrelax`` CLI invocation is a fresh Python process, and each
jitted program pays XLA compilation again.  JAX's persistent
compilation cache serialises compiled executables to disk keyed on
(program HLO, jaxlib version, backend), so later processes deserialise
instead of recompiling.

Where the cache lives is decided outside the program:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no directory of its own.
- otherwise ``<checkout>/.jax_cache`` — a fixed path, because the path
  is part of what a later process must find again.
- ``SPINRELAX_NO_COMPILE_CACHE=1`` disables the cache (the test suite
  sets it: ``enable_default`` mutates PROCESS-GLOBAL jax config, and
  in-process callers of ``cli.main`` would otherwise inherit it).

Enabled by the entry points only (CLI, chip_smoke.py, bench.py) —
importing the library must stay side-effect free.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str | None:
    """The directory compiled programs go to (None when disabled)."""
    if os.environ.get("SPINRELAX_NO_COMPILE_CACHE"):
        return None
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_default() -> bool:
    """Point jax at the on-disk compilation cache.  Returns True when the
    cache was enabled."""
    path = cache_dir()
    if path is None:
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program that took a noticeable compile; tiny programs
    # recompile faster than a cache round-trip.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return True
