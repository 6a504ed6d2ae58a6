"""JAX's persistent compile cache, placed in one way for every entry point.

The CLI, bench.py, chip_smoke.py and the tools call `enable_compile_cache()`
before their first compile; library code and tests set no cache. Where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
here. Otherwise the cache goes to `<checkout>/.jax_cache` (gitignored): a
fixed path, since a cache whose directory moves never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
