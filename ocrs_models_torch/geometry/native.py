"""ctypes bindings for the host geometry core ``_native/geometry.cpp``.

The library is compiled with ``g++`` into ``build/native/`` at first use
(and again when the source is newer). Where no C++ toolchain is present,
:func:`available` is False and the callers in ``components.py``,
``polygon.py`` and ``raster.py`` run their numpy versions; :func:`backend`
names which one runs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.native import load_library

_SRC = Path(__file__).resolve().parent / "_native" / "geometry.cpp"
_load_failed = False


def _bind(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.cc_label.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p]
    lib.cc_label.restype = ctypes.c_int
    lib.min_area_rect.argtypes = [f64p, ctypes.c_int, f64p]
    lib.min_area_rect.restype = None
    lib.polygon_offset.argtypes = [f64p, ctypes.c_int, ctypes.c_double, f64p]
    lib.polygon_offset.restype = ctypes.c_int
    lib.fill_polygon.argtypes = [f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    lib.fill_polygon.restype = None
    lib.convex_clip_area.argtypes = [f64p, ctypes.c_int, f64p, ctypes.c_int]
    lib.convex_clip_area.restype = ctypes.c_double


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _load_failed
    if _load_failed:
        return None
    try:
        # No fused multiply-add, so results round like the numpy twins.
        return load_library(_SRC, "geometry", _bind, ["-ffp-contract=off"])
    except (RuntimeError, OSError):
        _load_failed = True
        return None


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


def fill_polygon(poly: np.ndarray, h: int, w: int, out: np.ndarray) -> None:
    """Fill ``poly`` into the C-contiguous uint8 ``[h, w]`` mask ``out``
    (Pillow's rule)."""
    lib = get_lib()
    p = np.ascontiguousarray(poly, dtype=np.float64).reshape(-1, 2)
    lib.fill_polygon(p, len(p), h, w, out)


def convex_clip_area(a: np.ndarray, b: np.ndarray) -> float:
    """Area of polygon ``a`` clipped by the convex polygon ``b``."""
    lib = get_lib()
    aa = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 2)
    bb = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 2)
    return float(lib.convex_clip_area(aa, len(aa), bb, len(bb)))
