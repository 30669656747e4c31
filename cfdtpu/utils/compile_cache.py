"""Where JAX keeps its persistent compilation cache.

The step executables take tens of seconds to compile at production
mesh sizes, so every entry point (main.py, bench.py, chip_smoke.py)
keeps compiled programs on disk. The caller decides where: a set
JAX_COMPILATION_CACHE_DIR is left to JAX, which reads it itself.
Otherwise the cache lives at <repo root>/.jax_cache, a fixed path, so
that later runs from the same checkout hit it.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def use_compile_cache() -> str:
    """Enable the persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
