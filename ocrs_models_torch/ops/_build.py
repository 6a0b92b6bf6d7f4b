"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kernels/lib<name>.so``,
and loaded with ``ctypes``. Sources are built at first use, one ``nvcc``
per source, all started together; a library newer than its source is
reused. Nothing here runs at import time, so the CPU tests import the
package on machines without ``nvcc``.

Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code, since a refused launch never runs
and a later ``synchronize`` does not report it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    """Where the compiler's output (``-Xptxas -v``: registers, spills) goes."""
    return BUILD_DIR / f"{name}.log"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _stale(name: str) -> bool:
    lib = lib_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build() -> dict[str, Path]:
    """Compile every source whose library is missing or stale, in
    parallel. Returns each name's library path; raises with the compiler
    output if any build fails."""
    names = sources()
    todo = [n for n in names if _stale(n)]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            log = open(log_path(name), "w")
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp)
        failed = []
        for name, (proc, log, tmp) in procs.items():
            try:
                rc = proc.wait(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = -1
            finally:
                log.close()
            if rc == 0:
                os.replace(tmp, lib_path(name))
            else:
                failed.append(f"{name} (rc {rc}):\n{log_path(name).read_text()}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first call builds
    every stale source, so one process compiles all kernels at once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.ocrs_error_string.argtypes = [ctypes.c_int]
            lib.ocrs_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ocrs_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
