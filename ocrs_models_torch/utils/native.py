"""Build and load the port's host C++ cores (``geometry/_native``,
``data/_native``): each is compiled with ``g++`` into ``build/native/`` at
first use, and again when its source is newer, then loaded through ctypes
once per process. :func:`build_root` says where ``build/`` is, for these
and for the CUDA kernels (``ops/_build.py``)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

BUILD_ENV = "OCRS_TORCH_BUILD_DIR"
_PACKAGE_PARENT = Path(__file__).resolve().parents[2]
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    """The directory the port builds its libraries into, read at each
    build: ``$OCRS_TORCH_BUILD_DIR`` when set; else ``build/`` beside the
    package (in a checkout, its git-ignored ``build/``) when that can be
    written; else ``ocrs_models_torch/`` in the user's cache directory
    (``$XDG_CACHE_HOME``, else ``~/.cache``), as for a package installed
    where it cannot write."""
    override = os.environ.get(BUILD_ENV)
    if override:
        return Path(override)
    beside = _PACKAGE_PARENT / "build"
    if os.access(beside if beside.exists() else _PACKAGE_PARENT, os.W_OK):
        return beside
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "ocrs_models_torch"


def load_library(src: Path, name: str, bind: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """``lib{name}.so`` in :func:`build_root`'s ``native/``, compiled from ``src`` (``g++ -O3`` and
    ``flags``) if it is missing or older than ``src``, loaded, and passed
    to ``bind`` to set its functions' signatures. Raises ``RuntimeError``
    naming ``src`` when the build fails, ``OSError`` when the load does."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = build_root() / "native" / f"lib{name}.so"
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
