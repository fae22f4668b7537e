"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module leaves the directory alone. Where it is unset, the cache lives in a
fixed directory of the checkout, ``<checkout>/.jax_cache`` (listed in
``.gitignore``): the path is part of the cache's key, so it must not move
between runs.

:func:`enable` runs when ``smh_tpu.ops.pipeline`` is imported, before the
first jit compilation of the framework. Idempotent.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable(min_compile_secs: float = 0.3) -> str:
    """Turn on the persistent compilation cache; returns its directory.

    ``min_compile_secs`` is below jax's 1.0 default: the warmup ladder and
    the suite are dominated by many sub-second to few-second bucket
    compiles, not a few giant ones.
    """
    import jax

    path = jax.config.jax_compilation_cache_dir
    if not path and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
