"""JAX persistent compilation cache for the scripts that drive the step
(``bench.py``, ``chip_smoke.py``, ``tools/``)."""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout that holds this package
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache(root: Path | str | None = None) -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache lives at
    ``<root>/.jax_cache`` (``root`` defaults to the checkout; the directory
    is git-ignored).  The path is fixed: it is part of what a later process
    must find to reuse an entry."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = Path(root if root is not None else CHECKOUT) / ".jax_cache"
    path.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(path)
