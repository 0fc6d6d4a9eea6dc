"""Persistent XLA compilation cache, on for every entry point.

A fresh process otherwise compiles again every program it dispatches,
which for a whole-genome ``ld-genome`` run or a short ``h2`` run can cost
more than the device work.  JAX's persistent cache keys each executable
on the computation's fingerprint and the jaxlib/backend versions, so it
cannot change a result.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads that variable itself and
  this module sets no directory at all.
* otherwise ``<checkout>/.jax_cache``: one fixed path, because a process
  finds earlier entries only under the same directory.

Opt-out: set ``NLDSC_NO_COMPILE_CACHE=1``.
"""

from __future__ import annotations

import os
from pathlib import Path

#: cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str | None:
    """Point JAX at the persistent compilation cache; idempotent.

    Returns the cache directory in use, or None when opted out or when the
    checkout's cache directory cannot be created.
    """
    if os.environ.get("NLDSC_NO_COMPILE_CACHE"):
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    try:
        CHECKOUT_CACHE_DIR.mkdir(exist_ok=True)
    except OSError:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
