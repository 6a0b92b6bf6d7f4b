"""The port as an installed package: every native source it builds at run
time ships in the wheel (``pyproject.toml``'s package data), and both
loaders (``ops/_build.py`` for the CUDA kernels, ``utils/native.py`` for
the host C++ cores) build into ``utils.native.build_root()``: the
``OCRS_TORCH_BUILD_DIR`` override, else ``build/`` beside the package
when it can be written, else the user's cache directory."""

import fnmatch
import os
import stat
import tomllib
from pathlib import Path

import pytest

from ocrs_models_torch.ops import _build
from ocrs_models_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "ocrs_models_torch"


def _package_data() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["ocrs_models_torch"]


@pytest.mark.parametrize(
    "source",
    sorted(str(p.relative_to(PACKAGE)) for ext in ("*.cu", "*.cuh", "*.cpp")
           for p in PACKAGE.rglob(ext)),
)
def test_every_native_source_is_package_data(source):
    assert any(fnmatch.fnmatch(source, glob) for glob in _package_data()), source


def test_the_build_root_is_the_checkouts_build_by_default(monkeypatch):
    monkeypatch.delenv(native.BUILD_ENV, raising=False)
    assert native.build_root() == ROOT / "build"
    assert _build.lib_path("gru_fwd") == ROOT / "build" / "kernels" / "libgru_fwd.so"


def test_a_read_only_package_builds_in_the_user_cache(monkeypatch, tmp_path):
    monkeypatch.delenv(native.BUILD_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(native.os, "access", lambda path, mode: False)
    assert native.build_root() == tmp_path / "ocrs_models_torch"
    assert _build.log_path("gru_wide") == tmp_path / "ocrs_models_torch" / "kernels" / "gru_wide.log"


def test_the_override_receives_the_kernel_builds(monkeypatch, tmp_path):
    # A stand-in for nvcc that writes the library it is asked for: build()
    # must put every kernel's library and log under the override, whatever
    # the package directory allows.
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv(native.BUILD_ENV, str(tmp_path / "override"))
    monkeypatch.setattr(native.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    built = _build.build()
    assert sorted(built) == _build.sources()
    for name, path in built.items():
        assert path == tmp_path / "override" / "kernels" / f"lib{name}.so"
        assert path.read_text() == "built\n" and _build.log_path(name).exists()
    assert not list((tmp_path / "override" / "kernels").glob("*.tmp"))


def test_the_override_receives_the_host_core_builds(monkeypatch, tmp_path):
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int ocrs_probe() { return 7; }\n')
    monkeypatch.setenv(native.BUILD_ENV, str(tmp_path / "override"))
    monkeypatch.setattr(native.os, "access", lambda path, mode: False)
    monkeypatch.setattr(native, "_loaded", {})
    lib = native.load_library(src, "probe_override", lambda lib: None)
    assert lib.ocrs_probe() == 7
    assert (tmp_path / "override" / "native" / "libprobe_override.so").exists()
    assert not os.path.exists(ROOT / "build" / "native" / "libprobe_override.so")
