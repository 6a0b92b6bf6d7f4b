"""ctypes bindings for the host geometry core ``_native/geometry.cpp``.

The library is compiled with ``g++`` into ``build/native/`` at first use
(and again when the source is newer). Where no C++ toolchain is present,
:func:`available` is False and the callers in ``components.py`` and
``polygon.py`` run their numpy versions; :func:`backend` names which one
runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "geometry.cpp"
_LIB_PATH = Path(__file__).resolve().parents[2] / "build" / "native" / "libgeometry.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            # No fused multiply-add, so results round like the numpy twins.
            ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
            timeout=240,
        )
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        stale = not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime
        if stale and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _load_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.cc_label.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p]
        lib.cc_label.restype = ctypes.c_int
        lib.min_area_rect.argtypes = [f64p, ctypes.c_int, f64p]
        lib.min_area_rect.restype = None
        lib.polygon_offset.argtypes = [f64p, ctypes.c_int, ctypes.c_double, f64p]
        lib.polygon_offset.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def backend() -> str:
    """``"native"`` when the C++ core is loaded, else ``"numpy"``."""
    return "native" if available() else "numpy"


def cc_label(mask: np.ndarray) -> tuple[np.ndarray, int]:
    lib = get_lib()
    m = np.ascontiguousarray(mask > 0, dtype=np.uint8)
    h, w = m.shape
    labels = np.empty((h, w), dtype=np.int32)
    n = lib.cc_label(m, h, w, labels)
    return labels, int(n)


def min_area_rect(pts: np.ndarray) -> np.ndarray:
    lib = get_lib()
    p = np.ascontiguousarray(pts, dtype=np.float64).reshape(-1, 2)
    out = np.empty(8, dtype=np.float64)
    lib.min_area_rect(p, len(p), out)
    return out.reshape(4, 2)


def polygon_offset(poly: np.ndarray, dist: float) -> np.ndarray:
    """Offset towards the interior by ``dist`` (negative = outward)."""
    lib = get_lib()
    p = np.ascontiguousarray(poly, dtype=np.float64).reshape(-1, 2)
    out = np.empty((len(p), 2), dtype=np.float64)
    n = lib.polygon_offset(p, len(p), float(dist), out)
    return out[:n]
