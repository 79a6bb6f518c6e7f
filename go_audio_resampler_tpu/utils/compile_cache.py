"""Where JAX's persistent compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``,
``benchmarks/run_all.py``, ``chip_smoke.py`` and the test suite):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; the program
  sets no directory of its own and leaves that one in charge.
- otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The
  path is fixed — the cache key includes it, so a directory derived from
  a temp name, a pid or the time would never hit.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: Repository root: utils/ -> package -> checkout.
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The directory the compilation cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable(min_compile_time_secs: float = 0.0) -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Programs that compile in under ``min_compile_time_secs`` are not
    written (the test suite uses this to skip trivial CPU programs).
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
