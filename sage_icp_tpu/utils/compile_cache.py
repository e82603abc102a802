"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench.py, chip_smoke.py, the test
suite): if JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
nothing is set here; otherwise the cache lives in a FIXED directory
inside the checkout (listed in .gitignore). The cache key includes the
path, so a temporary or per-process directory would never hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def configure_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at its directory; returns the path.

    min_compile_secs: programs that compiled faster than this are not
    written to the cache (only applied when the directory is ours)."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return DEFAULT_DIR
