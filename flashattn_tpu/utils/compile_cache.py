"""Persistent compilation cache shared by every entry point.

`enable_compile_cache()` is called once at the top of each script
(`chip_smoke.py`, `bench.py`, `benchmarks/*.py`, `examples/*.py`) before the
first compile. If `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its
cache there and nothing else is touched. Otherwise the cache lives at a fixed
path inside the checkout, so a later run from the same checkout finds it
(the path is part of the cache key: a directory that moves never hits).
"""

from __future__ import annotations

import os
import pathlib

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
