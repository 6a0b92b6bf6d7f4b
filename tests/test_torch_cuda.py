"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a GPU they skip. The
file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from ocrs_models_torch.models import RecognitionModel
from ocrs_models_torch.ops import (
    BiGRU,
    gru_recurrence,
    gru_recurrence_reference,
    stage1,
    stage1_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The CUDA device, with the kernels built; skips without a GPU
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    from ocrs_models_torch.ops import _build

    _build.build()
    return torch.device("cuda", 0)


def _no_tf32():
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=False, allow_tf32=False
    )


@pytest.mark.parametrize("shape", [(32, 64, 256), (32, 64, 800), (3, 15, 13), (1, 2, 2)])
def test_stage1_kernel_matches_plain(dev, shape):
    n, h, w = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.rand((n, 1, h, w), generator=g) - 0.5).to(dev)
    weight = (torch.randn((32, 1, 3, 3), generator=g) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=g) * 0.1).to(dev)
    with _no_tf32():
        want = stage1_reference(x, weight, bias)
    before = stage1.launches
    got = stage1(x, weight, bias)
    torch.cuda.synchronize()
    assert stage1.launches == before + 1
    assert got.shape == (n, 32, h // 2, w // 2) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(33, 40, 256), (5, 3, 48), (1, 17, 8)])
def test_gru_kernel_matches_plain(dev, shape):
    t, n, h = shape
    g = torch.Generator().manual_seed(sum(shape))
    k = 1.0 / h**0.5
    px_f = torch.randn((t, n, 3 * h), generator=g).to(dev)
    px_b = torch.randn((t, n, 3 * h), generator=g).to(dev)
    w_hh = ((torch.rand((2, h, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    before = gru_recurrence.launches
    got = gru_recurrence(px_f, px_b, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_recurrence.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_bigru_matches_cudnn_gru(dev):
    torch.manual_seed(0)
    port = BiGRU(128, 256, 2).to(dev)
    ref = torch.nn.GRU(128, 256, num_layers=2, bidirectional=True, batch_first=True).to(dev)
    ref.load_state_dict(port.state_dict(), strict=True)
    xs = torch.randn((16, 65, 128), device=dev)
    with torch.no_grad(), _no_tf32():
        want, _ = ref(xs)
        got = port(xs)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_recognition_on_card_matches_cpu(dev):
    torch.manual_seed(1)
    model = RecognitionModel(n_classes=97).eval()
    x = torch.rand((4, 1, 64, 96)) - 0.5
    with torch.no_grad():
        want = model(x)
        with _no_tf32():
            got = copy.deepcopy(model).to(dev)(x.to(dev)).cpu()
    assert got.shape == (4, 25, 97) and np.isfinite(got.numpy()).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernels_refuse_autograd(dev):
    w = torch.randn((32, 1, 3, 3), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        stage1(torch.rand((1, 1, 8, 8), device=dev), w, torch.zeros(32, device=dev))
