"""Where the port's kernels are built: warm restarts skip the `nvcc` build.

Counterpart of `cloudtik_tpu/utils/compile_cache.py`.  The JAX package
caches XLA executables; the port's counterpart of an XLA compile is the
`nvcc` build of its CUDA kernels (`ops/_kernels.py`), which a restarted
process would otherwise run again into a fresh checkout.  This module is
the ONE place `TIK_COMPILE_CACHE_DIR` is read: `ensure_compile_cache`
points `_kernels.BUILD_DIR` at the directory it names, and every surface
that launches kernels at boot (`Trainer`, `tik-serve`) calls it, so the
second incarnation of a job on a host loads the libraries the first one
built.

The values are the reference's: a path sets the directory; "1"/"on"/
"true"/"default" set `<TIK_HOME>/cache/torch_kernels`; unset (or an
"off"/"0"/"none" value) keeps the in-tree `build/torch_kernels`.  Unlike
the reference, "off" cannot mean uncached: a kernel must be built
somewhere, so off means the checkout's own directory.  The libraries are
keyed by a hash of their source and flags, so one directory serves every
checkout and version that shares it, and concurrent builders (the ranks of
one host) each write their own temporary file and rename it into place.

The executors carry the variable to every node, as they carry
`TIK_TRACEPARENT`.  Setting the directory is fail-soft: one that cannot be
created or written logs a warning and keeps the in-tree default.  It moves
only where a kernel is built; it never skips a kernel.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

CACHE_DIR_ENV = "TIK_COMPILE_CACHE_DIR"

_DISABLE_VALUES = frozenset(("", "0", "off", "false", "none", "disabled"))
_DEFAULT_VALUES = frozenset(("1", "on", "true", "default"))

_lock = threading.Lock()
_applied: Optional[str] = None


def default_cache_dir() -> str:
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "cache", "torch_kernels")


def cache_dir() -> Optional[str]:
    """The cache directory the environment asks for, or None when it asks
    for none (the kernels then build in the checkout's own directory)."""
    raw = os.environ.get(CACHE_DIR_ENV)
    if raw is None:
        return None
    value = raw.strip()
    if value.lower() in _DISABLE_VALUES:
        return None
    if value.lower() in _DEFAULT_VALUES:
        return default_cache_dir()
    return os.path.expanduser(value)


def _point_at(directory: Path) -> None:
    from cloudtik_tpu_torch.ops import _kernels
    _kernels.BUILD_DIR = directory


def _unapply() -> None:
    """Put the build back in the checkout.  Caller holds `_lock`."""
    global _applied
    from cloudtik_tpu_torch.ops import _kernels
    _point_at(_kernels.DEFAULT_BUILD_DIR)
    _applied = None


def ensure_compile_cache(directory: Optional[str] = None) -> Optional[str]:
    """Idempotently point the kernel build at the cache directory.

    Returns the directory in use, or None when the kernels build in the
    checkout (no cache asked for, or the asked one is unusable).
    Re-applies when the resolved directory changed since the last call.
    With no cache asked for and none applied, leaves `BUILD_DIR` as it is.
    """
    global _applied
    directory = directory if directory is not None else cache_dir()
    if directory is None:
        with _lock:
            if _applied is not None:
                _unapply()
        return None
    with _lock:
        if _applied == directory:
            return directory
        try:
            os.makedirs(directory, exist_ok=True)
            # a build writes a temporary file beside the library
            with tempfile.NamedTemporaryFile(dir=directory):
                pass
        except OSError as e:
            logger.warning(
                "kernel build cache %s unusable (%s: %s); building in "
                "the checkout", directory, type(e).__name__, e)
            _unapply()
            return None
        _point_at(Path(directory))
        _applied = directory
        return directory
