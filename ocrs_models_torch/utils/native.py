"""Build and load the port's host C++ cores (``geometry/_native``,
``data/_native``): each is compiled with ``g++`` into ``build/native/`` at
first use, and again when its source is newer, then loaded through ctypes
once per process."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def load_library(src: Path, name: str, bind: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """``build/native/lib{name}.so``, compiled from ``src`` (``g++ -O3`` and
    ``flags``) if it is missing or older than ``src``, loaded, and passed
    to ``bind`` to set its functions' signatures. Raises ``RuntimeError``
    naming ``src`` when the build fails, ``OSError`` when the load does."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = BUILD_DIR / f"lib{name}.so"
        if not path.exists() or path.stat().st_mtime < src.stat().st_mtime:
            path.parent.mkdir(parents=True, exist_ok=True)
            # A per-process name and an atomic rename: concurrent workers
            # never load a half-written library.
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", "-std=c++17",
                                "-o", str(tmp), str(src)],
                               check=True, capture_output=True, timeout=240)
            except (subprocess.SubprocessError, OSError) as e:
                detail = getattr(e, "stderr", b"") or b""
                raise RuntimeError(f"building {src.name} with g++ failed: {e} "
                                   f"{detail.decode(errors='replace')[-2000:]}") from e
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _loaded[name] = lib
        return lib
