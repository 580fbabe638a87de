"""Persistent XLA compilation cache, enabled for the whole framework.

The registration flows compile many mid-sized programs (the fused-ICP
loop per (capacity, variant) pair, normal estimation, the NN searches),
and the fused chains take seconds each to compile.  JAX's persistent
compilation cache removes every repeat compile across processes.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: there, and nowhere else is set in
  code;
* otherwise the fixed path ``<checkout>/.jax_cache`` (the directory that
  holds the package), so every process run from one checkout shares it.

CPU-only processes (``JAX_PLATFORMS=cpu``) leave the cache off unless
``JAX_COMPILATION_CACHE_DIR`` or ``CWIPC_JAX_CACHE=1`` asks for it: CPU
compiles are cheap, and XLA:CPU's loader logs a machine-feature warning
for every cached executable it loads.  ``CWIPC_JAX_CACHE=0`` disables the
cache everywhere.
"""

from __future__ import annotations

import os
from typing import Optional


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: next to the package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_persistent_cache() -> Optional[str]:
    """Turn on the persistent compilation cache (idempotent).

    Returns the cache directory in effect, or None when the cache is off.
    """
    flag = os.environ.get("CWIPC_JAX_CACHE", "")
    if flag == "0":
        return None
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        if flag != "1" and os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
            return None
        cache_dir = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program: the register flow's program set is dozens of
    # small-to-mid programs.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
