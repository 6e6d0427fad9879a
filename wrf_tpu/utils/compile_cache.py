"""JAX's persistent compilation cache, in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this module sets
no other directory.  Otherwise the cache lives at a fixed path inside the
checkout (``<repo>/.jax_cache``, gitignored): the path is part of what a
later run looks up, so it never depends on the process, the time or a
temporary directory.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"

#: default cache directory: ``.jax_cache`` at the root of the checkout
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on for every compile; returns its path."""
    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
