"""Platform selection and the persistent compilation cache.

Entry points call :func:`apply_platform_env` before their first jax backend
use, so that ``JAX_PLATFORMS`` binds even when jax was imported earlier and
the compile cache is on for every process of the program.
"""

from __future__ import annotations

import os

#: the checkout's root: ``ibu_jax/utils/`` is two levels below it
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def apply_platform_env() -> None:
    """Honor ``JAX_PLATFORMS`` by pinning it into jax config, and enable the
    persistent compilation cache.

    Must run before the first jax backend initialization. The platform pin
    is a no-op when the env var is unset (jax's default platform is used).
    """
    value = os.environ.get("JAX_PLATFORMS")
    if value:
        import jax

        jax.config.update("jax_platforms", value)
    enable_compile_cache()


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` in the
    checkout. The path is part of each entry's key, so it stays fixed."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Turn on jax's persistent compilation cache in
    :func:`compile_cache_dir`, so that sorts and other large computations
    compile once across the program's processes."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
