"""Where JAX keeps its persistent compilation cache.

Every entry point calls `enable_compile_cache()` before its first compile.
If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
else is set here.  Otherwise the cache goes to the fixed path
`<repo>/.jax_cache` (listed in .gitignore): the path is part of what makes
a cache entry hit, so it must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """-> the directory the compile cache uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
