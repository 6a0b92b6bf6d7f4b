"""The port stands alone and never hides the device: it imports nothing of
JAX, flax, PIL or the JAX package; its entry points refuse to run on the
CPU unless asked; its kernel wrappers never launch (or count) on CPU
tensors and refuse other devices rather than falling back."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ocrs_models_torch.ops import BiGRU, gru_recurrence, stage1
from ocrs_models_torch.ops import _build
from ocrs_models_torch.pipeline import OcrPipeline

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "PIL", "ocrs_models_tpu")
PORT_FILES = sorted((ROOT / "ocrs_models_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_pil_or_the_jax_package(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_pipeline_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        OcrPipeline()


def test_cpu_tensors_use_plain_versions_and_count_no_launch():
    stage1.launches = 0
    gru_recurrence.launches = 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 1, 16, 12)).astype(np.float32))
    conv = torch.nn.Conv2d(1, 32, 3, padding=1)
    with torch.no_grad():
        y = stage1(x, conv.weight, conv.bias)
        out = BiGRU(8, 4)(torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32)))
    assert y.shape == (2, 32, 8, 6) and out.shape == (2, 5, 8)
    assert stage1.launches == 0
    assert gru_recurrence.launches == 0


def test_wrappers_refuse_other_devices():
    # A tensor on neither the CPU nor a CUDA device must not quietly run
    # the plain version.
    x = torch.empty((1, 1, 8, 8), device="meta")
    w = torch.empty((32, 1, 3, 3), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        stage1(x, w, torch.empty(32, device="meta"))
    px = torch.empty((3, 2, 12), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        gru_recurrence(px, px, torch.empty((2, 4, 12), device="meta"), torch.empty((2, 12), device="meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_stale", lambda name: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_every_kernel_source_has_its_note():
    names = _build.sources()
    assert names == ["gru_fwd", "stage1_fwd"]
    for name in names:
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert "Replaces:" in text and "ocrs_models_tpu/ops/pallas/" in text
        assert "Bound on an H100" in text and "Design:" in text
        assert "cudaGetLastError" in text
