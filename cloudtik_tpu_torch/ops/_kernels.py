"""Build and load the port's CUDA kernels.

Each source under `cloudtik_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
`ctypes`.  Libraries live in `BUILD_DIR`, keyed by a hash of the source
and the flags: `build/torch_kernels/` at the root of the checkout, or the
directory `TIK_COMPILE_CACHE_DIR` names (`utils/compile_cache.py`, applied
at the boot of a trainer or a server).  They are built at the first launch
on a CUDA tensor (or by `build_all()`, which starts one `nvcc` per source
at once).  Each builder writes its own temporary file and renames it into
place, so processes that build into one directory at once leave one whole
library for each source.  Nothing happens at import: the CPU tests import
every module on a machine with no `nvcc`.  Each build that compiled
something calls the functions in `BUILD_LISTENERS` with its wall seconds
and the sources it built (the step profiler books them to the `compile`
bucket).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
BUILD_DIR = DEFAULT_BUILD_DIR

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source stem -> the C functions it exports, with their ctypes signatures
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES: Dict[str, Dict[str, Tuple[list, object]]] = {
    "flash_fwd": {
        "tik_flash_fwd": ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _F, _I, _P], _I),
        "tik_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_bwd": {
        "tik_flash_bwd_dq": ([_I, _I] + [_P] * 7 + [_I] * 5 + [_P] * 5
                             + [_F, _I, _P], _I),
        "tik_flash_bwd_dkv": ([_I, _I] + [_P] * 8 + [_I] * 5 + [_P] * 6
                              + [_F, _I, _P], _I),
        "tik_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "nms": {
        "tik_nms": ([_P, _P, _P, _P, _I, _I, _I, _F, _P], _I),
        "tik_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "roi_align": {
        "tik_roi_align": ([_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I,
                           _I, _F, _P], _I),
        "tik_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# fn(seconds, [source, ...]) after each build that compiled something
BUILD_LISTENERS: List[Callable[[float, List[str]], None]] = []


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str,
           target: Path) -> Tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path,
            target: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    log_tmp = tmp.with_suffix(".logtmp")
    log_tmp.write_text(log)
    os.replace(log_tmp, target.with_suffix(".log"))
    os.replace(tmp, target)   # atomic: a reader never sees half a library
    return log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every missing library, one `nvcc` per source, all started
    together.  Returns {source: nvcc output} for the ones built now."""
    names = list(_SIGNATURES) if names is None else names
    with _lock:
        todo = [(n, _target(n)) for n in names if not _target(n).exists()]
        if not todo:
            return {}
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [(n, *_start(n, nvcc, t), t) for n, t in todo]
        logs = {}
        errors = []
        for n, proc, tmp, t in procs:   # wait for all before raising
            try:
                logs[n] = _finish(n, proc, tmp, t)
            except KernelBuildError as e:
                errors.append(str(e))
        seconds = time.perf_counter() - t0
        for listener in list(BUILD_LISTENERS):
            listener(seconds, [n for n, _ in todo])
        if errors:
            raise KernelBuildError("\n".join(errors))
        return logs


def build_logs() -> Dict[str, str]:
    """{source: nvcc output} of every built library, kept beside it: ptxas
    prints each kernel's registers and spills there (`-Xptxas -v`)."""
    logs = {}
    for name in _SIGNATURES:
        log = _target(name).with_suffix(".log")
        if log.exists():
            logs[name] = log.read_text()
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.tik_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
