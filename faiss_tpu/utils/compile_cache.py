"""Persistent XLA compile cache placement, shared by chip_smoke.py and
bench.py.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
is set in code. Otherwise the cache lives at a fixed ``<repo>/.jax_cache``
(listed in .gitignore): the path is part of JAX's cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives for this process."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return it. Sets nothing when the environment variable is set."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
