"""Persistent compilation cache location.

``JAX_COMPILATION_CACHE_DIR``, when it is set, is honoured as JAX honours it
and no other directory is set in code.  Otherwise the cache lives at a fixed
``.jax_cache/`` in the checkout (listed in ``.gitignore``): a fixed path,
because the path is part of what a later process looks up, and a directory
that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The checkout's own cache directory (used when the env var is unset).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where compiled programs are kept: the env var's directory if set,
    else ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn the persistent cache on (call before the first compile) and
    return its directory."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d


__all__ = ["cache_dir", "enable_persistent_cache"]
