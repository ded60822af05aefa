"""The persistent XLA compile cache, set in one place.

A 4K stitch step takes tens of seconds to compile; entry points that
compile it (bench.py, chip_smoke.py, __graft_entry__.py) keep the
compiled programs in one cache directory: ``JAX_COMPILATION_CACHE_DIR``
when it is set, otherwise ``<repo>/.jax_cache`` (listed in .gitignore).
The path is part of the cache's key, so it stays fixed.
"""

import os

__all__ = ["enable_compile_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache():
    """Point JAX's persistent compile cache at the directory above and
    return it.  Call before the first compile."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
