"""Where JAX's persistent compilation cache lives.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache goes to `<repo>/_build/jaxcache`, a path
fixed by this file's location, so every run from one checkout finds what
earlier runs compiled.
"""

import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO, "_build", "jaxcache")


def configure() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
