"""The port stands alone and never hides the device: it imports nothing of
JAX, flax, PIL or the JAX package; its entry points refuse to run on the
CPU unless asked; its kernel wrappers never launch (or count) on CPU
tensors and refuse other devices rather than falling back."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ocrs_models_torch.ops import (
    KERNELS,
    BiGRU,
    ctc_alpha,
    ctc_beta,
    ctc_loss,
    gru_bwd,
    gru_recurrence,
    stage1,
    stage1_bwd,
)
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


def test_layout_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ocrs_models_torch.training import eval_layout, train_layout

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_layout.main(["synthetic", "--max-epochs", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_layout.main(["page.json", "out.png", "--checkpoint", "layout.pt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        OcrPipeline(use_layout_model=True, layout_state_dict={})


def test_cpu_tensors_use_plain_versions_and_count_no_launch():
    for kernel in KERNELS:
        kernel.launches = 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 1, 16, 12)).astype(np.float32))
    conv = torch.nn.Conv2d(1, 32, 3, padding=1)
    gru = BiGRU(8, 4)
    y = stage1(x, conv.weight, conv.bias)
    out = gru(torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32)))
    log_probs = torch.log_softmax(out, -1)
    loss = ctc_loss(log_probs, torch.tensor([[1, 2], [3, 0]]), torch.tensor([5, 4]),
                    torch.tensor([2, 1]))
    (loss + y.sum()).backward()
    assert y.shape == (2, 32, 8, 6) and out.shape == (2, 5, 8)
    assert conv.weight.grad is not None and gru.weight_hh_l0.grad is not None
    assert {k.__name__: k.launches for k in KERNELS} == {k.__name__: 0 for k in KERNELS}


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
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    ys = meta(3, 2, 4)
    emit, ns = meta(2, 3, 5), meta(2, 5)
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    for call in (
        lambda: stage1_bwd(x, w, meta(32), meta(1, 32, 4, 4)),
        lambda: gru_bwd(px, px, ys, ys, ys, ys, meta(2, 4, 12), meta(2, 12)),
        lambda: ctc_alpha(emit, ns, ns, lens),
        lambda: ctc_beta(emit, ns, emit, ns, meta(2), lens),
    ):
        with pytest.raises(RuntimeError, match="unsupported device"):
            call()


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_stale", lambda name: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_every_kernel_source_has_its_note():
    names = _build.sources()
    assert names == ["ctc_alpha", "ctc_beta", "gru_bwd", "gru_bwd_wide", "gru_fwd", "gru_grid",
                     "gru_grid_f32", "gru_wide", "stage1_bwd", "stage1_fwd"]
    # One source a wrapper, but the wide route's two share gru_wide.cu,
    # gru_grid.cu (its bf16 grid form), gru_grid_f32.cu (its f32 grid form)
    # and gru_bwd_wide.cu (its bf16 backward's coefficients and dW above
    # 512).
    wrappers = {k.__name__ for k in KERNELS}
    assert names == sorted(wrappers - {"gru_wide_fwd", "gru_wide_bwd"}
                           | {"gru_wide", "gru_grid", "gru_grid_f32", "gru_bwd_wide"})
    for name in names:
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert "Replaces:" in text and "ocrs_models_tpu/ops/pallas/" in text
        assert "Bound on an H100" in text and "Design:" in text
        assert "cudaGetLastError" in text
