"""Cold-path control: the persistent directory of built kernels
(``roaringbitmap_tpu.runtime.warmup``).

The JAX package points JAX's persistent compilation cache at
``ROARING_TPU_COMPILE_CACHE``.  The port's persistent compiled artifacts
are the ``nvcc`` kernel libraries (``ops.build``) and the native ingest
library (``native``); with the knob set they are built into, and loaded
from, that directory instead of ``ops/_build/`` and ``native/_build/``
beside the sources::

    ROARING_TPU_COMPILE_CACHE=/var/cache/rb_cuda  python serve.py

Both stay named by the hash of their source and flags, so one directory
serves any number of checkouts and an edited source still builds anew.
Unset, nothing changes.  ``enable_compile_cache(path)`` sets the
directory from code (it wins over the environment);
``enable_compile_cache()`` reads the environment.
"""

from __future__ import annotations

import os

ENV_COMPILE_CACHE = "ROARING_TPU_COMPILE_CACHE"

#: the directory set by ``enable_compile_cache(path)``, or None
_explicit: str | None = None


def _resolve(spec: str) -> str:
    path = os.path.abspath(os.path.expanduser(spec))
    os.makedirs(path, exist_ok=True)
    return path


def enable_compile_cache(path: str | None = None) -> str | None:
    """Build and load the kernel libraries from ``path`` (or from
    ``$ROARING_TPU_COMPILE_CACHE`` when ``path`` is None).  Returns the
    resolved directory, or None when neither is set."""
    global _explicit
    if path is not None:
        _explicit = _resolve(path)
    return compile_cache_dir()


def compile_cache_dir() -> str | None:
    """The directory of built kernels: the one set by code, else the
    environment's, else None (the default directories beside the
    sources)."""
    if _explicit is not None:
        return _explicit
    spec = os.environ.get(ENV_COMPILE_CACHE)
    return _resolve(spec) if spec else None


def disable_compile_cache() -> None:
    """Forget a directory set by code (the environment still applies)."""
    global _explicit
    _explicit = None


def build_dir():
    """The kernels' build directory in force (``ops.build.build_dir``)."""
    from ..ops import build

    return build.build_dir()
