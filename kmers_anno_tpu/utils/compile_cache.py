"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# the checkout root: a fixed path, so a later run from the same checkout
# finds what an earlier one compiled (the path is part of the cache key)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here (an empty value leaves the cache off).  Otherwise
    the cache lives in ``<checkout>/.jax_cache``.

    returns the directory in use, or None when the cache is off.
    """
    if CACHE_ENV in os.environ:
        return os.environ[CACHE_ENV] or None
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
