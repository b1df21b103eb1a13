"""Persistent XLA compilation cache -- one location for every entry point.

First compiles of the full pipeline take minutes; repeats from the cache
take seconds. Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives
there and nothing else is configured. Otherwise it lives at a fixed
``<repo>/.jax_cache`` (listed in .gitignore): a fixed path keeps cache keys
stable between runs, and the checkout is the one directory every run of the
repo can write.
"""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Set and activate the persistent compilation cache; returns the path.

    Safe to call before or after the first jax import/backend use (the cache
    config is read per-compile, not at import).
    """
    path = os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                                 default_cache_dir())
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
