"""Persistent XLA compilation cache placement.

The reference simulator starts in milliseconds (a C++ binary); a JAX
process pays a cold XLA compile for every decoder shape.  The persistent
compilation cache amortizes that across processes: the first run of a
given (codec, batch) shape compiles and stores the executable, later
runs load it.

Called from lut_ldpc_tpu/__init__.py.  Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself and
  nothing here sets a directory;
- otherwise ``build/jax_cache`` in the repository checkout.  The path is
  fixed because it is part of every entry's key: a directory that moves
  never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "jax_cache")


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        except OSError:  # read-only checkout: run without a cache
            return
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache even fast compiles: a BER sweep touches many small shapes
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
