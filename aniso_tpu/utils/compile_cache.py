"""Where JAX keeps its persistent compilation cache for this program.

The 512^2 programs take tens of seconds to compile, so every entry point
(the CLI, `chip_smoke.py`, `bench.py`, `examples/demo.py` and the
benchmark drivers) calls `setup_compile_cache()` before its first
compilation.  The cache key includes the directory, so it stays at one
fixed path.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Use `<repo>/.jax_cache` unless JAX_COMPILATION_CACHE_DIR is set.

    With the variable set this sets nothing, and JAX's own reading of it
    applies.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
