"""The port's CUDA kernels against their plain PyTorch versions, in float32
and bfloat16, the recognition trainer, and the layout model, step and
trainer against the CPU, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a GPU they skip. The
file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import json

import numpy as np
import pytest
import torch

from ocrs_models_torch.data import SyntheticLayout, collate_layout
from ocrs_models_torch.data.layout_synth import SyntheticDocLayout
from ocrs_models_torch.models import LayoutModel, RecognitionModel
from ocrs_models_torch.models.layout import Dropout
from ocrs_models_torch.ops import (
    BiGRU,
    ctc_alpha,
    ctc_alpha_chain_probe,
    ctc_alpha_reference,
    ctc_beta,
    ctc_beta_reference,
    gru_bwd,
    gru_bwd_chain_bf16_reference,
    gru_bwd_coefficients_reference,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_fwd,
    gru_recurrence_reference,
    stage1_bwd,
    stage1_bwd_reference,
    stage1_fwd,
    stage1_reference,
)
from ocrs_models_torch.ops.ctc import NEG_INF
from ocrs_models_torch.pipeline import OcrPipeline
from ocrs_models_torch.training import train_layout
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import make_layout_steps, make_recognition_steps, numerics

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
    before = stage1_fwd.launches
    got = stage1_fwd(x, weight, bias)
    torch.cuda.synchronize()
    assert stage1_fwd.launches == before + 1
    assert got.shape == (n, 32, h // 2, w // 2) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _gru_case(t, n, h, dev, seed, dy_scale=1.0):
    g = torch.Generator().manual_seed(seed)
    k = 1.0 / h**0.5
    px_f = torch.randn((t, n, 3 * h), generator=g).to(dev)
    px_b = torch.randn((t, n, 3 * h), generator=g).to(dev)
    w_hh = ((torch.rand((2, h, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    dy_f = (torch.randn((t, n, h), generator=g) * dy_scale).to(dev)
    dy_b = (torch.randn((t, n, h), generator=g) * dy_scale).to(dev)
    return px_f, px_b, w_hh, b_hh, dy_f, dy_b


# T=1 and T=2: no exchange between the blocks of a cluster, then one.
# N=259: 34 clusters, more than the card holds at once, and a ragged last
# batch tile. H=8, 48, 64: clusters of 1, 2 (ragged unit tile) and 2.
# N=12 and N=20 at T=193: the trainer's short last batch and its default
# batch at its 768-wide bucket.
GRU_SHAPES = [(33, 40, 256), (5, 3, 48), (1, 17, 8), (2, 20, 256), (1, 3, 64), (2, 5, 64),
              (7, 259, 256), (201, 128, 256), (193, 12, 256), (193, 20, 256)]


@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_gru_kernel_matches_plain(dev, shape):
    t, n, h = shape
    px_f, px_b, w_hh, b_hh, _, _ = _gru_case(t, n, h, dev, sum(shape))
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    before = gru_fwd.launches
    got = gru_fwd(px_f, px_b, w_hh, b_hh)
    again = gru_fwd(px_f, px_b, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_fwd.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # bit-identical reruns
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_gru_kernels_on_two_streams_do_not_disturb_each_other(dev):
    # Two calls in flight at once on two streams, each with its own
    # inputs, must give what each gives alone (bit for bit: the kernels
    # share no scratch in device memory between calls).
    cases = [_gru_case(65, 72, 256, dev, 11), _gru_case(40, 100, 256, dev, 12)]
    alone = []
    for px_f, px_b, w_hh, b_hh, dy_f, dy_b in cases:
        ys = gru_fwd(px_f, px_b, w_hh, b_hh)
        alone.append((ys, gru_bwd(px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    together = [None, None]
    for _ in range(3):  # interleave the launches of the two streams
        for i, (px_f, px_b, w_hh, b_hh, dy_f, dy_b) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                ys = gru_fwd(px_f, px_b, w_hh, b_hh)
                together[i] = (ys, gru_bwd(px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh))
    torch.cuda.synchronize()
    for (ys_a, grads_a), (ys_t, grads_t) in zip(alone, together):
        for a, b in zip((*ys_a, *grads_a), (*ys_t, *grads_t)):
            assert torch.equal(a, b)


def test_gru_kernels_refuse_a_hidden_size_beyond_one_cluster(dev):
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(2, 4, 264, dev, 13)
    with pytest.raises(ValueError, match="H <= 256"):
        gru_fwd(px_f, px_b, w_hh, b_hh)
    ys = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    with pytest.raises(ValueError, match="H <= 256"):
        gru_bwd(px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)


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


def test_recognition_gradients_on_card_match_cpu(dev):
    # One training step's loss and gradients through all six kernels
    # against the same step on the CPU (plain versions). Gradients are
    # compared in relative L2 per tensor, 1e-2: a max-pool window whose
    # candidates are within the last bits of the two conv orders may route
    # its gradient to the other candidate.
    torch.manual_seed(2)
    cpu_model = RecognitionModel(n_classes=97, gru_hidden=32)
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(2)
    batch = {
        "image": rng.uniform(-0.5, 0.5, (6, 1, 64, 96)).astype(np.float32),
        "text": rng.integers(1, 97, (6, 16)),
        "text_len": np.asarray([16, 5, 0, 9, 3, 12]),
        "image_width": np.asarray([96, 96, 80, 64, 96, 40]),
        "sample_weight": np.asarray([1, 1, 1, 1, 0, 0], np.float32),
    }
    losses, grads = [], []
    for m in (cpu_model, card_model):
        train_step, _ = make_recognition_steps(m)
        _, metrics = train_step(create_train_state(m), batch, 0.0)
        losses.append(metrics["loss"].item())
        grads.append({n: p.grad.detach().cpu() for n, p in m.named_parameters()})
    assert np.isfinite(losses).all()
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for name, g in grads[0].items():
        rel = float((grads[1][name] - g).norm() / g.norm())
        assert rel <= 1e-2, (name, rel)


def _stage1_bwd_case(shape, dev, seed):
    n, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((n, 1, h, w), generator=g) - 0.5).to(dev)
    weight = (torch.randn((32, 1, 3, 3), generator=g) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=g) * 0.1).to(dev)
    dy = torch.randn((n, 32, h // 2, w // 2), generator=g).to(dev)
    return x, weight, bias, dy


# (5, 64, 262), (7, 33, 131): widths whose pooled width (131, 65) is no
# multiple of the 32-column tile, odd sizes, and more (image, tile, row)
# items than blocks, so a block's walk crosses images and tiles.
# (128, 64, 1024): the wide training shape.
@pytest.mark.parametrize("shape", [(32, 64, 256), (3, 15, 13), (2, 16, 200), (1, 2, 2),
                                   (128, 64, 1024), (5, 64, 262), (7, 33, 131)])
def test_stage1_bwd_kernel_matches_plain(dev, shape):
    x, weight, bias, dy = _stage1_bwd_case(shape, dev, sum(shape) + 1)
    with _no_tf32():
        want = stage1_bwd_reference(x, weight, bias, dy)
    before = stage1_bwd.launches
    got = stage1_bwd(x, weight, bias, dy)
    again = stage1_bwd(x, weight, bias, dy)
    torch.cuda.synchronize()
    assert stage1_bwd.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bit-identical reruns
    # Sums over the windows in another order: 1e-3 of the largest entry (a
    # near-tie routed differently moves one |dy * x| <= ~2).
    scale = max(t.abs().max().item() for t in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * scale + 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_bwd_kernel_ties_take_the_first_window_position(dev, dtype):
    # A zero image: every window holds four equal pre-activations (the
    # bias). Channels with bias > 0 send dy to position (0, 0) only;
    # channels with bias <= 0 get no gradient. (In bf16 the bias is rounded
    # first; no entry of linspace(-1, 1, 32) rounds to 0.)
    x = torch.zeros((2, 1, 8, 8), device=dev, dtype=dtype)
    weight = torch.randn((32, 1, 3, 3), device=dev)
    bias = torch.linspace(-1, 1, 32, device=dev)
    dy = torch.rand((2, 32, 4, 4), device=dev).to(dtype)
    dw, db = stage1_bwd(x, weight, bias, dy)
    torch.testing.assert_close(db, torch.where(bias > 0, dy.float().sum((0, 2, 3)), 0.0))
    assert (dw == 0).all()
    want = stage1_bwd_reference(x, weight, bias, dy)
    torch.testing.assert_close(db, want[1])


@pytest.mark.parametrize("shape", GRU_SHAPES + [(65, 20, 256)])
def test_gru_bwd_kernel_matches_plain(dev, shape):
    t, n, h = shape
    # Cotangents of order 1 up to 65 steps; at T=201 of order 0.1, as the
    # training step's are, so that atol 1e-3 means the same relative error.
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(
        t, n, h, dev, sum(shape) + 2, dy_scale=1.0 if t <= 65 else 0.1)
    ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
    args = (px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    want = gru_bwd_reference(*args)
    before = gru_bwd.launches
    got = gru_bwd(*args)
    again = gru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_bwd.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bit-identical reruns
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-5)


def test_gru_bwd_kernel_matches_its_phases_plain_versions(dev):
    # The kernel against the composition of its phases' plain versions
    # (which read the saved ys, as the kernel does), same tolerances.
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(33, 40, 256, dev, 5)
    ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
    args = (px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    want = gru_bwd_phases_reference(*args)
    got = gru_bwd(*args)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-5)


def _ctc_case(t_len, n, s, dev, seed):
    rng = np.random.default_rng(seed)
    emit = torch.from_numpy(rng.normal(-3.0, 1.0, (n, t_len, s)).astype(np.float32)).to(dev)
    skip = torch.from_numpy(np.where(rng.random((n, s)) < 0.5, 0.0, NEG_INF).astype(np.float32)).to(dev)
    alpha0 = torch.full((n, s), NEG_INF, device=dev)
    alpha0[:, : min(2, s)] = emit[:, 0, : min(2, s)]
    lens = rng.integers(1, t_len + 1, n).astype(np.int32)
    lens[-1] = t_len  # no frozen step
    lens[1 % n] = 1  # every step after the first frozen
    d = -torch.from_numpy(rng.random((n, s)).astype(np.float32)).to(dev)
    d[0] = 0.0
    return emit, skip, alpha0, torch.from_numpy(lens).to(dev), d


def _beta_operands(alphas, d):
    seed = torch.where(d != 0, torch.log(d.abs()) - alphas[:, -1], torch.full_like(d, NEG_INF))
    sign = torch.where(d < 0, -1.0, 1.0).amin(dim=1).contiguous()
    return seed.contiguous(), sign


# S = 1, 13, 31, 32: one warp per sample; 33, 49, 97, 129, 161: blocks of 2
# to 6 warps; 1023: the largest block. (65, 256, 49) and (257, 128, 97) are
# the training shapes. Lengths 1 and T are in every case.
@pytest.mark.parametrize("t_len,n,s", [(20, 4, 13), (65, 9, 129), (3, 2, 1), (11, 6, 31),
                                       (11, 6, 32), (11, 6, 33), (65, 256, 49), (257, 128, 97),
                                       (257, 3, 161), (9, 5, 1023), (1, 3, 49), (2, 3, 5)])
def test_ctc_kernels_match_plain(dev, t_len, n, s):
    emit, skip, alpha0, lens, d = _ctc_case(t_len, n, s, dev, t_len + n + s)
    before = (ctc_alpha.launches, ctc_beta.launches)
    alphas = ctc_alpha(emit, skip, alpha0, lens)
    final = ctc_alpha(emit, skip, alpha0, lens, final_only=True)
    torch.testing.assert_close(alphas, ctc_alpha_reference(emit, skip, alpha0, lens), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(final, alphas[:, -1], rtol=0, atol=0)
    seed, sign = _beta_operands(alphas, d)
    got = ctc_beta(emit, skip, alphas, seed, sign, lens)
    want = ctc_beta_reference(emit, skip, alphas, seed, sign, lens)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta.launches) == (before[0] + 2, before[1] + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (got[0][0] == 0).all() and (got[1][0] == 0).all()
    assert (got[0][:, 0] == 0).all()  # step 0's gradient goes to dalpha0


# S = 1, 2, 31, 32: one warp per sample (lanes 0 and 1 take NEG_INF for
# their missing neighbours); 33, 64, 65, 129: blocks of 2 to 5 warps; 512
# and 513: the last with an 8-row ring and the first with a 4-row one; 1024:
# the largest block. T = 20 wraps both rings. Lengths 0 (acts as 1), 1, 2,
# T and T + 3: from every sample another step on is frozen.
@pytest.mark.parametrize("s", [1, 2, 31, 32, 33, 64, 65, 129, 512, 513, 1024])
def test_ctc_alpha_kernel_matches_plain_with_frozen_rows(dev, s):
    t_len = 20
    emit, skip, alpha0, _, _ = _ctc_case(t_len, 5, s, dev, s + 7)
    lens = torch.tensor([0, 1, 2, t_len, t_len + 3], dtype=torch.int32, device=dev)
    before = ctc_alpha.launches
    alphas = ctc_alpha(emit, skip, alpha0, lens)
    again = ctc_alpha(emit, skip, alpha0, lens)
    final = ctc_alpha(emit, skip, alpha0, lens, final_only=True)
    torch.cuda.synchronize()
    assert ctc_alpha.launches == before + 3
    assert torch.equal(alphas, again)  # bit-identical reruns
    assert torch.equal(final, alphas[:, -1])
    torch.testing.assert_close(alphas, ctc_alpha_reference(emit, skip, alpha0, lens),
                               rtol=1e-6, atol=1e-4)
    for i, length in enumerate(lens.tolist()):
        last = min(max(length, 1), t_len) - 1
        assert torch.equal(alphas[i, last:], alphas[i, last].expand(t_len - last, s))
    assert torch.equal(alphas[:, 0], alpha0)


def test_ctc_alpha_refuses_more_positions_than_a_block_holds(dev):
    emit, skip, alpha0, lens, _ = _ctc_case(3, 2, 1025, dev, 4)
    with pytest.raises(RuntimeError, match="ctc_alpha: CUDA error"):
        ctc_alpha(emit, skip, alpha0, lens)


def test_ctc_alpha_chain_probe_times_its_steps(dev):
    # The warp path (S=13), the block paths with an 8-row and a 4-row ring
    # (S=129, 513); the probe is no launch of the kernel.
    before = ctc_alpha.launches
    for t_len, s in ((9, 13), (257, 129), (20, 513)):
        got = ctc_alpha_chain_probe(t_len, s, dev)
        assert got["steps"] == t_len - 1 and got["cycles"] > 0 and got["ns"] >= 0
    assert ctc_alpha.launches == before


def test_ctc_beta_refuses_more_positions_than_a_block_holds(dev):
    emit, skip, alpha0, lens, d = _ctc_case(3, 2, 1025, dev, 3)
    alphas = ctc_alpha_reference(emit, skip, alpha0, lens)
    seed, sign = _beta_operands(alphas, d)
    with pytest.raises(RuntimeError, match="ctc_beta: CUDA error"):
        ctc_beta(emit, skip, alphas, seed, sign, lens)


def test_ctc_beta_and_stage1_bwd_on_two_streams_do_not_disturb_each_other(dev):
    # Two calls of ctc_alpha, ctc_beta and stage1_bwd in flight at once on
    # two streams, each with its own inputs, must give what each gives
    # alone, bit for bit: the partial sums of stage1_bwd are scratch of one
    # call, and no kernel keeps a counter or a buffer in device memory
    # between calls.
    alpha_cases, ctc_cases, s1_cases = [], [], []
    for seed, (t_len, n, s), shape in ((21, (129, 140, 97), (64, 64, 512)),
                                       (22, (65, 200, 49), (96, 64, 256))):
        emit, skip, alpha0, lens, d = _ctc_case(t_len, n, s, dev, seed)
        alphas = ctc_alpha(emit, skip, alpha0, lens)
        alpha_cases.append((emit, skip, alpha0, lens))
        ctc_cases.append((emit, skip, alphas, *_beta_operands(alphas, d), lens))
        s1_cases.append(_stage1_bwd_case(shape, dev, seed))
    # ... and a bf16 stage1_bwd beside them (another kernel, its own scratch).
    s1_bf16 = [(x.to(BF16), w, b, dy.to(BF16)) for x, w, b, dy in s1_cases]

    def run(i):
        return (ctc_alpha(*alpha_cases[i]), *ctc_beta(*ctc_cases[i]), *stage1_bwd(*s1_cases[i]),
                *stage1_bwd(*s1_bf16[i]))

    alone = [run(0), run(1)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    together = [None, None]
    for _ in range(3):  # interleave the launches of the two streams
        for i in range(2):
            with torch.cuda.stream(streams[i]):
                together[i] = run(i)
    torch.cuda.synchronize()
    for got_alone, got_together in zip(alone, together):
        for a, b in zip(got_alone, got_together):
            assert torch.equal(a, b)


def test_device_prefetch_copies_pinned_host_batches(dev, monkeypatch):
    from ocrs_models_torch.data.loader import device_prefetch

    pinned = []
    pin_memory = torch.Tensor.pin_memory

    def record(t, *args, **kwargs):
        out = pin_memory(t, *args, **kwargs)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", record)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.uniform(-0.5, 0.5, (8, 1, 64, 256)).astype(np.float32),
                "text": rng.integers(0, 97, (8, 64)).astype(np.int32)} for _ in range(4)]
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):  # copies go on the current stream
        out = list(device_prefetch(iter(batches), dev, depth=2))
    side.synchronize()
    assert pinned == [True] * 8
    for (host, on_card), want in zip(out, batches):
        assert host is want
        for key, value in want.items():
            assert on_card[key].device == dev
            assert np.array_equal(on_card[key].cpu().numpy(), value)


def test_train_rec_trains_one_epoch_on_the_card(dev, tmp_path, monkeypatch, capsys):
    # 40 lines (2 steps of 20) and 10 validation lines (1 batch): every
    # kernel launches, as many times as the steps and batches need.
    from ocrs_models_torch.ops import KERNELS
    from ocrs_models_torch.training import train_rec

    monkeypatch.chdir(tmp_path)
    for kernel in KERNELS:
        kernel.launches = 0
    state = train_rec.main(["synthetic", "-", "--max-images", "40", "--max-epochs", "1"])
    counts = {k.__name__: k.launches for k in KERNELS}
    per_step = {"stage1_fwd": 1, "stage1_bwd": 1, "gru_fwd": 2, "gru_bwd": 2, "ctc_alpha": 1,
                "ctc_beta": 1}
    per_batch = {"stage1_fwd": 1, "gru_fwd": 2, "ctc_alpha": 1}
    assert counts == {k: 2 * per_step[k] + per_batch.get(k, 0) for k in per_step}
    assert state.step == 2 and next(state.model.parameters()).is_cuda
    assert state.model.dtype == torch.bfloat16  # the trainer's default, as the JAX trainer's
    out = capsys.readouterr().out
    assert "Model param count 2426913" in out and "Epoch 0 validation loss" in out
    lines = (tmp_path / "text-recognition-metrics.jsonl").read_text().splitlines()
    (record,) = [r for r in map(json.loads, lines) if "epoch" in r]
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["val_loss"])
    assert (tmp_path / "text-rec-checkpoint.pt").exists()


# -------------------------------------------------------------------- bf16
#
# The bf16 kernels against their bf16 plain versions on the card, at the
# trainer's and the server's shapes (N = 12, 20, 128, 256; T = 65 to 257),
# odd widths, and reruns. Both sides hold the same rounding points; what
# differs is the order of f32 sums, which may put a value on the other
# side of a bf16 rounding.

BF16 = torch.bfloat16


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference, in bf16 ulps of the larger magnitude."""
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


# (128, 64, 800): the serving chunk; (256, 64, 256), (20, 64, 512), (12, 64,
# 1024): the training step's and the trainer's; (3, 15, 13): odd sizes; the
# float32 test's shapes; widths that do not fill the 64-column tiles or
# whose pooled width is no multiple of 8 (250, 1000, 33: rows not 16-byte
# aligned), N = 1, and H = 62 (a tile of 4 pooled rows cut short).
STAGE1_BF16_SHAPES = [(128, 64, 800), (256, 64, 256), (20, 64, 512), (12, 64, 1024), (3, 15, 13),
                      (32, 64, 256), (32, 64, 800), (1, 2, 2), (4, 64, 250), (4, 64, 1000),
                      (2, 64, 33), (1, 64, 256), (6, 62, 256)]


@pytest.mark.parametrize("shape", STAGE1_BF16_SHAPES)
def test_stage1_bf16_kernel_matches_plain(dev, shape):
    # At least 99% of the outputs equal, the rest within one bf16 ulp.
    x, weight, bias, _ = _stage1_bwd_case(shape, dev, sum(shape) + 3)
    x = x.to(BF16)
    with _no_tf32():
        want = stage1_reference(x, weight, bias)
    before = stage1_fwd.launches
    got = stage1_fwd(x, weight, bias)
    again = stage1_fwd(x, weight, bias)
    torch.cuda.synchronize()
    assert stage1_fwd.launches == before + 2
    assert got.dtype == BF16 and got.shape == want.shape and torch.equal(got, again)
    assert (got == want).float().mean().item() >= 0.99
    assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("shape", [(256, 64, 256), (128, 64, 1024), (20, 64, 512),
                                   (12, 64, 768), (5, 64, 262), (3, 15, 13), (32, 64, 256),
                                   (2, 16, 200), (1, 2, 2), (7, 33, 131), (4, 64, 250),
                                   (4, 64, 1000), (2, 64, 33), (1, 64, 256), (6, 62, 256)])
def test_stage1_bwd_bf16_kernel_matches_plain(dev, shape):
    # dW, db float32 within 1e-3 of the largest entry, as in float32.
    x, weight, bias, dy = _stage1_bwd_case(shape, dev, sum(shape) + 4)
    x, dy = x.to(BF16), dy.to(BF16)
    with _no_tf32():
        want = stage1_bwd_reference(x, weight, bias, dy)
    before = stage1_bwd.launches
    got = stage1_bwd(x, weight, bias, dy)
    again = stage1_bwd(x, weight, bias, dy)
    torch.cuda.synchronize()
    assert stage1_bwd.launches == before + 2
    scale = max(t.abs().max().item() for t in want)
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-3 * scale + 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_wrappers_put_one_and_two_kernels_on_the_device(dev, dtype):
    # The wrappers pass weight and bias to the kernels as they are: the
    # forward is one device launch, the backward two (the partial sums and
    # the pass that adds them into dW and db), in both dtypes.
    from torch.profiler import ProfilerActivity, profile

    from ocrs_models_torch.profile_kernels import device_launches

    x, weight, bias, dy = _stage1_bwd_case((8, 64, 256), dev, 31)
    x, dy = x.to(dtype), dy.to(dtype)
    for fn, want in ((lambda: stage1_fwd(x, weight, bias), 1),
                     (lambda: stage1_bwd(x, weight, bias, dy), 2)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        assert device_launches(prof) == 3 * want


# (65, 256): the headline step; (257, 128): the wide step; (201, 128): the
# serving chunk; (193, 20), (129, 12): the trainer's batches; (7, 259, 256),
# (5, 3, 48), (1, 17, 8): more clusters than the card holds, ragged tiles.
# Besides the bounds on the largest difference, the share of bf16 outputs
# exactly equal to the plain version's: at these shapes 0.983-1.0 for ys
# and 0.968-1.0 for dpx, where a kernel that exchanges the unrounded state
# (forward) or multiplies the unrounded dph (backward chain) reads 0.877-
# 0.914 and 0.866-0.892; and dW within 1e-3 of its max, read at most 6.2e-4,
# where a `dw` phase that skips the rounding of dph reads 1.4e-3 to 1.8e-3
# (measured on one H100, with copies of the kernels with the rounding taken
# out). N=37, 65, 255: batch tiles ragged for every row choice of the
# tensor-core kernels (16, 32, 48, 64 rows per block).
GRU_BF16_SHAPES = [(65, 256, 256), (257, 128, 256), (201, 128, 256), (193, 20, 256),
                   (129, 12, 256), (7, 259, 256), (5, 3, 48), (1, 17, 8), (65, 37, 256),
                   (65, 65, 256), (65, 255, 256)]


@pytest.mark.parametrize("shape", GRU_BF16_SHAPES)
def test_gru_bf16_kernel_matches_plain(dev, shape):
    # ys within 2e-2 (a few bf16 ulps at 1: a rounding of h that flips
    # feeds the next steps' products), and at least 95% of it equal.
    t, n, h = shape
    px_f, px_b, w_hh, b_hh, _, _ = _gru_case(t, n, h, dev, sum(shape) + 5)
    px_f, px_b = px_f.to(BF16), px_b.to(BF16)
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    before = gru_fwd.launches
    got = gru_fwd(px_f, px_b, w_hh, b_hh)
    again = gru_fwd(px_f, px_b, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_fwd.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == BF16 and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=2e-2)
        assert (a == c).float().mean().item() >= 0.95


@pytest.mark.parametrize("shape", GRU_BF16_SHAPES)
def test_gru_bwd_bf16_kernel_matches_plain(dev, shape):
    # dpx (bf16) within 2e-2 and at least 95% of it equal, dW and db
    # (float32) within 1e-3 of their largest entry; cotangents of order 0.1
    # beyond 65 steps, as above.
    t, n, h = shape
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(
        t, n, h, dev, sum(shape) + 6, dy_scale=1.0 if t <= 65 else 0.1)
    px_f, px_b, dy_f, dy_b = (v.to(BF16) for v in (px_f, px_b, dy_f, dy_b))
    ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
    args = (px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    want = gru_bwd_reference(*args)
    before = gru_bwd.launches
    got = gru_bwd(*args)
    again = gru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_bwd.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[0].dtype == got[1].dtype == BF16 and got[2].dtype == got[3].dtype == torch.float32
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2e-2)
        assert (a == b).float().mean().item() >= 0.95
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item() + 1e-5)


def test_gru_bf16_kernels_run_the_headline_batch_in_one_round(dev):
    # N=256, H=256 (the headline step): the bf16 kernels pick enough rows
    # per block that their clusters all fit on the card at once.
    from ocrs_models_torch.ops.gru import max_active_clusters

    got = max_active_clusters(256, 256, dtype=BF16)
    for name in ("gru_fwd", "gru_bwd"):
        assert got[name]["rows_per_block"] in (16, 32, 48, 64)
        assert 0 < got[name]["launched"] <= got[name]["max_active"], got


@pytest.mark.parametrize("shape", [(65, 256, 256), (33, 37, 256), (5, 3, 48)])
def test_gru_bwd_bf16_chain_matches_its_plain_version(dev, shape):
    # The chain's own outputs: bf16(dhn), which it hands to `dw`, within
    # 2e-2 and at least 95% equal, as dpx; db, which it sums from the
    # unrounded dph, within 1e-3 of its largest entry.
    t, n, h = shape
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, sum(shape) + 7)
    px_f, px_b, dy_f, dy_b = (v.to(BF16) for v in (px_f, px_b, dy_f, dy_b))
    ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
    coef = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
    _, _, dhn_want, db_want = gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh)
    scratch = {}
    _, _, _, db = gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, scratch_out=scratch)
    torch.cuda.synchronize()
    dhn = scratch["dhn"]
    assert dhn.dtype == BF16 and dhn.shape == dhn_want.shape == (2, t, n, h)
    torch.testing.assert_close(dhn.float(), dhn_want.float(), rtol=0, atol=2e-2)
    assert (dhn == dhn_want).float().mean().item() >= 0.95
    torch.testing.assert_close(db, db_want, rtol=0, atol=1e-3 * db_want.abs().max().item())


def test_bf16_tensors_on_float32_only_paths_raise(dev):
    # No wrapper casts: a bf16 CUDA tensor where a kernel takes float32
    # only (the CTC recursions, the weights of stage 1 and the biGRU) or a
    # dtype no kernel takes (float16) is refused, and nothing launches.
    emit, skip, alpha0, lens, _ = _ctc_case(9, 3, 13, dev, 21)
    x, weight, bias, dy = _stage1_bwd_case((2, 16, 16), dev, 22)
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(3, 4, 32, dev, 23)
    before = {f.__name__: f.launches for f in (ctc_alpha, stage1_fwd, stage1_bwd, gru_fwd)}
    with pytest.raises(ValueError, match="float32"):
        ctc_alpha(emit.to(BF16), skip, alpha0, lens)
    with pytest.raises(ValueError, match="float32"):
        stage1_fwd(x.to(BF16), weight.to(BF16), bias)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stage1_fwd(x.half(), weight, bias)
    with pytest.raises(ValueError, match="bfloat16"):
        stage1_bwd(x.to(BF16), weight, bias, dy)  # dy float32 beside a bf16 x
    with pytest.raises(ValueError, match="float32"):
        gru_fwd(px_f.to(BF16), px_b.to(BF16), w_hh.to(BF16), b_hh)
    with pytest.raises(ValueError, match="bfloat16"):
        gru_fwd(px_f.to(BF16), px_b, w_hh, b_hh)
    assert before == {f.__name__: f.launches for f in (ctc_alpha, stage1_fwd, stage1_bwd, gru_fwd)}


def test_recognition_bf16_on_card_matches_its_plain_versions(dev):
    # The bf16 model with the kernels against the same model on the card
    # with every kernel's plain version: log-probs within 5e-2.
    from unittest import mock

    torch.manual_seed(3)
    model = RecognitionModel(n_classes=97, dtype=BF16).to(dev).eval()
    x = (torch.rand((20, 1, 64, 512)) - 0.5).to(dev)
    with torch.no_grad(), _no_tf32():
        got = model(x)
        with mock.patch("ocrs_models_torch.models.recognition.stage1", stage1_reference), \
                mock.patch("ocrs_models_torch.ops.gru.gru_recurrence", gru_recurrence_reference):
            want = model(x)
    assert got.dtype == torch.float32 and got.shape == (20, 129, 97)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=5e-2)



# ------------------------------------------------------------------ layout
# The layout model runs plain PyTorch products (the JAX layout model reaches
# no Pallas kernel); these hold the card against the CPU on the same weights.


def _layout_model(dtype=torch.float32, seed=0, **kwargs) -> LayoutModel:
    torch.manual_seed(seed)
    return LayoutModel(dtype=dtype, **kwargs)


def _layout_boxes(n_pages=4, n_words=500, seed=0) -> torch.Tensor:
    ds = SyntheticLayout(size=n_pages, n_words=n_words, seed=seed)
    return torch.from_numpy(np.stack([ds[i][0] for i in range(n_pages)]))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_layout_forward_on_the_card_matches_the_cpu(dev, dtype):
    # Full width: f32 (TF32 off) probabilities within 1e-4 of the CPU's;
    # bf16 within 2e-2 (the same rounding points, cuBLAS's f32 sums in
    # another order).
    model = _layout_model(dtype, return_probs=True).eval()
    boxes = _layout_boxes()
    with torch.no_grad(), numerics():
        want = model(boxes)
        got = copy.deepcopy(model).to(dev)(boxes.to(dev)).cpu()
    assert got.shape == (4, 500, 2) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 if dtype == torch.float32 else 2e-2)


def test_layout_train_step_on_the_card_matches_the_cpu(dev):
    # One f32 step from the same weights, dropout at 0: loss 1e-5 relative,
    # gradient norms 1e-4.
    model = _layout_model()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    ds = SyntheticLayout(size=6, n_words=500, seed=1)
    batch = collate_layout([ds[i] for i in range(6)], batch_multiple=4)
    out = []
    for device in (torch.device("cpu"), dev):
        m = copy.deepcopy(model).to(device)
        train, _ = make_layout_steps(m)
        out.append(train(create_train_state(m), batch, 1e-3)[1])
    cpu, card = out
    torch.testing.assert_close(card["loss"].cpu(), cpu["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(card["grad_norm"].cpu(), cpu["grad_norm"], rtol=1e-4, atol=0)
    for k, v in cpu["grad_norms"].items():
        torch.testing.assert_close(card["grad_norms"][k].cpu(), v, rtol=1e-4, atol=0)


def test_layout_grouping_on_the_card_matches_the_cpu(dev):
    ds = SyntheticDocLayout(size=4, n_words=700, seed=3, normalize_coords=False)
    page_quads = []
    for i in range(4):
        b = ds[i][0]
        b = b[b[:, 2] > b[:, 0]].astype(np.float64)
        page_quads.append(np.stack([b[:, [0, 1]], b[:, [2, 1]], b[:, [2, 3]], b[:, [0, 3]]], 1))
    sd = _layout_model().state_dict()
    lines = [OcrPipeline(layout_state_dict=sd, use_layout_model=True,
                         device=d)._group_lines_layout_batch(page_quads) for d in ("cpu", dev)]
    assert sum(len(p) for p in lines[0]) > 0
    assert [[m for _, m in p] for p in lines[1]] == [[m for _, m in p] for p in lines[0]]


def test_train_layout_cli_on_the_card(dev, tmp_path, monkeypatch):
    # Two bf16 epochs on 16 document pages: finite losses, a checkpoint.
    monkeypatch.chdir(tmp_path)
    state = train_layout.main(["synthetic-doc", "--max-images", "16", "--batch-size", "8",
                               "--max-epochs", "2"])
    assert state.step == 4 and state.model.dtype == BF16
    records = [json.loads(line) for line in
               (tmp_path / "text-layout-metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in records if "epoch" in r for k in ("train_loss", "val_loss")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / "text-layout-checkpoint.pt").exists()
