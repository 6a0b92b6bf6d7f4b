"""The port's CUDA kernels against their plain PyTorch versions, in float32
and bfloat16, the recognition trainer, the layout model, step and trainer,
detection training (step, balanced BCE, trainer and inference CLIs)
against the CPU, the ONNX export of models on the card against their
forward, the recognition step's collective path on a one-rank NCCL
group against its plain step, and the device components, bounds, resize
and line crops against the CPU, on the card.

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

from ocrs_models_torch.data import (
    SyntheticDetection,
    SyntheticLayout,
    collate_detection,
    collate_layout,
)
from ocrs_models_torch.data import device_pipeline as pre
from ocrs_models_torch.data.layout_synth import SyntheticDocLayout
from ocrs_models_torch.export.onnx_check import check_model
from ocrs_models_torch.export.onnx_eval import run_graph
from ocrs_models_torch.export.onnx_proto import parse_model
from ocrs_models_torch.geometry.device import (
    component_bounds_device,
    connected_components_device,
)
from ocrs_models_torch.models import DetectionModel, LayoutModel, RecognitionModel
from ocrs_models_torch.models import layout as layout_module
from ocrs_models_torch.models.layout import Dropout
from ocrs_models_torch.ops import (
    BiGRU,
    ctc_alpha,
    ctc_alpha_chain_probe,
    ctc_alpha_reference,
    ctc_beta,
    ctc_beta_chain_probe,
    ctc_beta_reference,
    ctc_design,
    gru_bwd,
    gru_bwd_chain_bf16_reference,
    gru_bwd_coefficients_reference,
    gru_bwd_coef_wide_f32,
    gru_bwd_dw_bf16_reference,
    gru_bwd_dw_reference,
    gru_bwd_dw_wide_f32,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_fwd,
    gru_recurrence_reference,
    gru_route,
    gru_wide_bwd,
    gru_wide_fwd,
    stage1_bwd,
    stage1_bwd_reference,
    stage1_fwd,
    stage1_reference,
)
from ocrs_models_torch.ops.ctc import NEG_INF, wide_slots
from ocrs_models_torch.ops import _build
from ocrs_models_torch.ops.gru import (
    GRID_F32_MAX_HIDDEN,
    GRID_F32_RESIDENT_HIDDEN,
    GRID_F32_STAGES,
    GRID_GATE_UNITS,
    GRID_MAX_HIDDEN,
    GRID_MAX_UNITS,
    GRID_RESIDENT_HIDDEN,
    H100_SMEM,
    _bwd_lib,
    _bwd_wide_lib,
    _dph,
    _grid_f32_lib,
    _grid_lib,
    bwd_phases,
    bwd_wide_f32_smem,
    grid_f32_kernel_smem,
    grid_f32_plan,
    grid_f32_smem,
    grid_kernel_smem,
    grid_limits,
    grid_plan,
    grid_smem,
    wide_form,
)
from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss
from ocrs_models_torch.pipeline import OcrPipeline
from ocrs_models_torch.training import eval_detection, train_detection, train_layout
from ocrs_models_torch.training.export_utils import export_weights
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import (
    make_detection_steps,
    make_layout_steps,
    make_recognition_steps,
    numerics,
)
from ocrs_models_torch.utils.render import read_png, write_png

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


# The wide route (gru_wide.cu; gru_bwd.cu's coef and dW phases around its
# chain). Its persistent form, one launch for all T steps in clusters of
# ceil(H/32) blocks: H=12 (padded to 16), 264 (9 unit tiles, the last
# ragged), 320 and 512, each at N=1, 259 (ragged batch tile, more clusters
# than one round) and 128, and at T=1 (no exchange), 2 and 257 (the wide
# training step's T at N=128). H=1024: the grid form, gru_grid_f32.cu in
# f32 and gru_grid.cu in bf16 (both below). Tolerances those
# of the cluster rows, but for the share of bf16 dpx equal to the plain
# version's at T=257, H=512: 93%, not 95%. There two float32 summation
# orders alone disagree on 4-5% of dpx's bf16 roundings: the plain version
# with float64 products reads 95.5-95.9% equal to the float32 plain
# version, the per-step kernel 95.0-95.1%, and a chain that multiplies the
# unrounded dph 86.5% (measured on one H100 by
# tests/torch_fixtures/wide_gru_equal_share.py); the persistent kernels
# read 94.9-95.0% (chip_smoke.py phase 18).
WIDE_SHAPES = [(5, 3, 12), (33, 40, 264), (7, 259, 512), (3, 4, 1024), (257, 128, 512),
               (1, 1, 264), (2, 259, 264), (257, 128, 264), (1, 1, 320), (2, 259, 320),
               (257, 128, 320), (1, 1, 512), (2, 259, 512), (2, 4, 1024)]


def _launch_calls(fn) -> dict:
    """The runtime's launch calls of one ``fn()`` by name, read from the
    profiler's host events (exact, unlike its device records): a cluster
    launch is ``cudaLaunchKernelExC``, every other kernel ``cudaLaunchKernel``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"cudaLaunchKernel": 0, "cudaLaunchKernelExC": 0}
    for e in prof.events():
        if e.name in out:
            out[e.name] += 1
    return out


def _wide_form(h: int, dtype: torch.dtype) -> str:
    """The route's form: "wide" (persistent), "grid" (above 512, up to
    GRID_MAX_HIDDEN in bf16 and GRID_F32_MAX_HIDDEN in f32) or
    "stepwise"."""
    padded = h + -h % 8
    if padded <= 512:
        return "wide"
    widest = GRID_MAX_HIDDEN if dtype == BF16 else GRID_F32_MAX_HIDDEN
    return "grid" if padded <= widest else "stepwise"


def _wide_calls(fn, *args):
    """Two calls of ``fn`` through the routing wrapper: their results, and
    the launches each route counted."""
    counts = lambda: (gru_fwd.launches, gru_bwd.launches, gru_wide_fwd.launches,  # noqa: E731
                      gru_wide_bwd.launches)
    before = counts()
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    return got, again, tuple(a - b for a, b in zip(counts(), before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_gru_wide_route_matches_plain(dev, shape, dtype):
    t, n, h = shape
    form = _wide_form(h, dtype)
    assert gru_route(h, dtype) == form
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(
        t, n, h, dev, sum(shape) + 8, dy_scale=1.0 if t <= 65 else 0.1)
    px_f, px_b, dy_f, dy_b = (v.to(dtype) for v in (px_f, px_b, dy_f, dy_b))
    got, again, launched = _wide_calls(gru_fwd, px_f, px_b, w_hh, b_hh)
    assert launched == (0, 0, 2, 0)
    # One recurrence kernel a call in the persistent form (a cluster
    # launch) and in the grid form (a cooperative launch), T in the
    # per-step form.
    calls = _launch_calls(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
    if form != "stepwise":
        assert calls["cudaLaunchKernelExC"] == 1
    else:
        assert calls["cudaLaunchKernelExC"] == 0 and calls["cudaLaunchKernel"] >= t
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    for a, b, c in zip(got, again, want):
        assert a.dtype == dtype and a.shape == (t, n, h) and torch.equal(a, b)
        if dtype == BF16:
            torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=2e-2)
            assert (a == c).float().mean().item() >= 0.95
        else:
            torch.testing.assert_close(a, c, rtol=0, atol=1e-4)
    args = (px_f, px_b, *got, dy_f, dy_b, w_hh, b_hh)
    got, again, launched = _wide_calls(gru_bwd, *args)
    assert launched == (0, 0, 0, 2)
    calls = _launch_calls(lambda: gru_bwd(*args))
    assert calls["cudaLaunchKernelExC"] == (0 if form == "stepwise" else 1)
    want = gru_bwd_reference(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bit-identical reruns
    assert got[0].dtype == dtype and got[2].dtype == got[3].dtype == torch.float32
    for a, b in zip(got[:2], want[:2]):
        if dtype == BF16:
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2e-2)
            assert (a == b).float().mean().item() >= (0.93 if t * h >= 257 * 512 else 0.95)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    scale = 1e-3 if dtype == BF16 else 1e-4
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=scale * b.abs().max().item() + 1e-5)


# The grid form (gru_grid.cu; bf16, padded 512 < H <= GRID_MAX_HIDDEN):
# H=520 (17 unit tiles of 32, the last of 8 units), 1024 (32 tiles, two
# row tiles at N=259: R=144, three passes) and GRID_RESIDENT_HIDDEN (1440:
# 60 tiles of 24 units, one row tile), the whole W slice resident; then
# the streamed plans, part of W through the ring: 1448 (24 units), 1451
# (padded to 1456: its chain streams 8 chunks through 6 stages), 2048 (32
# units), 4096 (64), 5280 (80 units, the forward's wgmma n = 240) and the
# per-gate plans past it (W_hh from device memory, one wgmma a gate and
# the chain on wgmma, passes of 128 rows at every batch): 5288 (88 units,
# a contraction that is no multiple of 16), 5816 (96 units, the same) and
# GRID_MAX_HIDDEN (6336: 96 units, 66 unit tiles, 132 blocks), at N=3 (one
# m16 tile of a pass) and 259, T=1 (no product), 2 (one) and 9; and one
# width of each other U a streamed plan takes, 2560, 3072, 3584 and 4608
# (40, 48, 56 and 72 units: odd unit groups, 5, 7 and 9, in the gate math
# and the exchange), at T=2, N=259 (R > 64: the forward's warpgroups split
# the rows) and T=9, N=3 (they split the contraction). Tolerances of the
# wide route's bf16 rows: ys
# and dpx 2e-2 and 95% equal (93% in the streamed plans, phase 18's gate
# above H=264: their sums run over up to 3H = 15,840 terms), dW and db
# 1e-3 of their largest entry (dW at N=3: see the test). In the streamed
# plans ys and dpx also within one bf16 rounding step (2^-8 of the value):
# their dpx reach |4| at T=9, N=259 (H=4096), where a rounding that flips
# between two f32 sum orders moves an entry by 0.03125.
GRID_SHAPES = [(t, n, h) for h in (520, 1024, GRID_RESIDENT_HIDDEN, 1448, 1451, 2048, 4096,
                                   5280, 5288, 5816, GRID_MAX_HIDDEN)
               for t, n in ((1, 3), (2, 259), (9, 3), (9, 259))] + [
    (t, n, h) for h in (2560, 3072, 3584, 4608) for t, n in ((2, 259), (9, 3))]


def test_grid_shapes_run_every_plan_of_the_grid_form():
    # The card tests' widths take each block shape grid_plan gives in the
    # grid form's range (the units a block and whether R passes 64 rows,
    # which picks the kernels' variants), at N=3 and 259 alike. Needs no
    # card: it holds the list above.
    def kinds(widths, batches):
        return {(p.units, p.rows > 64, p.fwd.streamed > 0) for p in
                (grid_plan(n, h) for h in widths for n in batches)}

    assert kinds(range(520, GRID_MAX_HIDDEN + 1, 8), (3, 259)) == kinds(
        {h for _, _, h in GRID_SHAPES}, (3, 259))
    assert {(grid_plan(n, h).units, n > 64) for t, n, h in GRID_SHAPES if t >= 2} >= {
        (u, big) for u in range(24, GRID_MAX_UNITS + 1, 8) for big in (False, True)}
    assert {grid_plan(n, h).units for _, n, h in GRID_SHAPES} > {GRID_GATE_UNITS + 8, GRID_MAX_UNITS}


def _form_calls(fn, *args):
    """``fn(*args)`` once, and the wide wrappers' calls of each form it
    made."""
    before = {w.__name__: dict(w.forms) for w in (gru_wide_fwd, gru_wide_bwd)}
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {w.__name__: {k: v - before[w.__name__][k] for k, v in w.forms.items()}
                 for w in (gru_wide_fwd, gru_wide_bwd)}


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_gru_grid_form_matches_plain(dev, shape):
    t, n, h = shape
    assert gru_route(h, BF16) == "grid"
    plan = grid_plan(n, h)
    assert wide_form(n, h + -h % 8, BF16, dev.index) == ("grid", plan)
    streamed = h > GRID_RESIDENT_HIDDEN
    assert (plan.fwd.streamed > 0 and plan.chain.streamed > 0) == streamed
    min_equal = 0.93 if streamed else 0.95
    rtol = 2**-8 if streamed else 0.0
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, sum(shape) + 19)
    px_f, px_b, dy_f, dy_b = (v.to(BF16) for v in (px_f, px_b, dy_f, dy_b))
    ys, forms = _form_calls(gru_fwd, px_f, px_b, w_hh, b_hh)
    assert forms["gru_wide_fwd"]["grid"] == 1 and sum(forms["gru_wide_fwd"].values()) == 1
    again = gru_fwd(px_f, px_b, w_hh, b_hh)
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    for a, b, c in zip(ys, again, want):
        assert a.dtype == BF16 and a.shape == (t, n, h) and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=rtol, atol=2e-2)
        assert (a == c).float().mean().item() >= min_equal
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    grads, forms = _form_calls(gru_bwd, *args)
    assert forms["gru_wide_bwd"]["grid"] == 1 and sum(forms["gru_wide_bwd"].values()) == 1
    scratch = {}
    for a, b in zip(grads, gru_bwd(*args, scratch_out=scratch)):
        assert torch.equal(a, b)  # no atomics: bit-identical reruns
    want = gru_bwd_reference(*args)
    for a, b in zip(grads[:2], want[:2]):
        assert a.dtype == BF16
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=2e-2)
        assert (a == b).float().mean().item() >= min_equal
    # db end to end. dW end to end at N=259; at N=3 a dW entry sums 3T
    # products, and one bf16 rounding of dph that flips between the
    # kernel's sums and the plain version's moves it by one bf16 ulp of
    # that dph (2.1e-3 of the largest entry, read at T=9, H=1024): there dW
    # is held against the plain dW phase on the bf16(dph) that the chain
    # hands on (dpx and dhn), 1e-5 of its largest entry, and that dhn
    # against the chain's plain version as dpx is held. So too from 5280
    # up at T=2, N=259, where only the first step of the chain has rows
    # with h_prev != 0: their dph rounds the coefficients' sums over H >=
    # 5280 terms, and the flips leave 19 of 167M dW entries up to 1.08
    # times 1e-3 of the largest end to end at 5280 (PERF.md; T=9 holds).
    db_want = want[3]
    torch.testing.assert_close(grads[3], db_want, rtol=0, atol=1e-3 * db_want.abs().max().item() + 1e-5)
    if n >= 259 and (h < 5280 or t >= 9):
        torch.testing.assert_close(grads[2], want[2], rtol=0,
                                   atol=1e-3 * want[2].abs().max().item() + 1e-6)
    else:
        _assert_dw_on_the_chains_dph(px_f, px_b, ys, dy_f, dy_b, w_hh, b_hh, grads, scratch,
                                     rtol, min_equal)
    # Device launches a call: the forward's W_hh cast (two) and one
    # cooperative launch; the backward's cast, coef, the chain (one
    # cooperative launch), dw and dw_sum; a streamed plan adds one to each,
    # the layout of the streamed chunks, and a width that is not a multiple
    # of 8 its pads and slices (more launches, of its own).
    fwd_calls = _launch_calls(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
    bwd_calls = _launch_calls(lambda: gru_bwd(*args))
    if h % 8 == 0:
        assert fwd_calls == {"cudaLaunchKernel": 2 + streamed, "cudaLaunchKernelExC": 1}
        assert bwd_calls == {"cudaLaunchKernel": 5 + streamed, "cudaLaunchKernelExC": 1}
    else:
        assert fwd_calls["cudaLaunchKernelExC"] == bwd_calls["cudaLaunchKernelExC"] == 1
        assert fwd_calls["cudaLaunchKernel"] > 2 + streamed
        assert bwd_calls["cudaLaunchKernel"] > 5 + streamed


# The f32 grid form (gru_grid_f32.cu; padded 512 < H <= GRID_F32_MAX_HIDDEN):
# H=520 (33 unit tiles of 16, the last of 8 units; two row tiles at N=259),
# 1000 (a contraction that is no multiple of 16, 3000 in the chain), 1024,
# 1051 (padded to 1056) and GRID_F32_RESIDENT_HIDDEN (1056: 66 unit tiles,
# 132 blocks, 3 ring stages), all of W_hh resident; then its streamed
# plans: 1064 (24 units, 45 unit tiles, the last of 8 units; a contraction
# of 1064 = 66.5 k16 steps, 3192 in the chain), 1448, 1451 (padded to
# 1456), 2048 (32 units) and GRID_F32_MAX_HIDDEN (2112: 66 unit tiles of
# 32, 132 blocks); at N=1 and 3 (one warp's strip, mostly rows past N: the
# other warps still walk the ring), 259 (three passes of up to 128 rows,
# the last of 16, each streaming the slice) and T=1 (no product), 2 (one)
# and 9. Tolerances of the per-step form's f32 rows: ys 1e-4, dpx 1e-3,
# dW and db 1e-4 of their largest entry.
GRID_F32_SHAPES = [(t, n, h) for h in (520, 1000, 1024, 1051, GRID_F32_RESIDENT_HIDDEN, 1064,
                                       1448, 1451, 2048, GRID_F32_MAX_HIDDEN)
                   for t, n in ((1, 3), (2, 259), (9, 1), (9, 3), (9, 259))]


@pytest.mark.parametrize("shape", GRID_F32_SHAPES)
def test_gru_f32_grid_form_matches_plain(dev, shape):
    t, n, h = shape
    assert gru_route(h) == "grid"
    plan = grid_f32_plan(n, h)
    assert wide_form(n, h + -h % 8, torch.float32, dev.index) == ("grid", plan)
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, sum(shape) + 21)
    ys, forms = _form_calls(gru_fwd, px_f, px_b, w_hh, b_hh)
    assert forms["gru_wide_fwd"]["grid"] == 1 and sum(forms["gru_wide_fwd"].values()) == 1
    again = gru_fwd(px_f, px_b, w_hh, b_hh)
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    for a, b, c in zip(ys, again, want):
        assert a.dtype == torch.float32 and a.shape == (t, n, h) and torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    grads, forms = _form_calls(gru_bwd, *args)
    assert forms["gru_wide_bwd"]["grid"] == 1 and sum(forms["gru_wide_bwd"].values()) == 1
    for a, b in zip(grads, gru_bwd(*args)):
        assert torch.equal(a, b)  # no atomics: bit-identical reruns
    want = gru_bwd_reference(*args)
    for a, b in zip(grads[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    for a, b in zip(grads[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-5)
    # Device launches a call: the forward's one cooperative launch and
    # nothing else; the backward's coef, the chain (one cooperative
    # launch), dw and dw_sum, and before coef and dw each their pre-pass
    # (gru_bwd_wide.cu's tf32 hi and lo of W_hh^T and ys^T, the wgmma
    # products' shared-memory operands); a streamed plan adds, before each
    # cooperative launch, the layout of its streamed chunks. A width that
    # is not a multiple of 8 adds its pads and slices.
    streamed = int(plan.fwd.streamed > 0)
    assert streamed == (h > GRID_F32_RESIDENT_HIDDEN) == (plan.chain.streamed > 0)
    fwd_calls = _launch_calls(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
    bwd_calls = _launch_calls(lambda: gru_bwd(*args))
    assert fwd_calls["cudaLaunchKernelExC"] == bwd_calls["cudaLaunchKernelExC"] == 1
    if h % 8 == 0:
        assert fwd_calls["cudaLaunchKernel"] == streamed
        assert bwd_phases(h) == "gru_bwd_wide"
        assert bwd_calls["cudaLaunchKernel"] == 5 + streamed


def test_grid_f32_plan_counts_the_kernels_shared_memory(dev):
    # grid_f32_plan's fit rests on grid_f32_kernel_smem (grid_f32_smem for
    # the resident plans); the kernels ask the runtime for their own
    # (gru_grid_f32.cu's grid_f32_smem): the same bytes at every padded
    # width the f32 grid form takes, every A stage count the resident plans
    # are built for and each streamed plan's resident k16 steps and W ring
    # (and a ring one stage longer and shorter), within what this card's
    # blocks may use at the plan's.
    lib = _grid_f32_lib()
    smem = grid_limits(dev.index)[1]
    for h in range(520, GRID_F32_MAX_HIDDEN + 1, 8):
        plan = grid_f32_plan(128, h, *grid_limits(dev.index))
        assert plan == grid_f32_plan(128, h)  # an H100's numbers
        for kind, name in enumerate(("fwd", "chain")):
            split = plan.fwd if name == "fwd" else plan.chain
            if h <= GRID_F32_RESIDENT_HIDDEN:
                for stages in GRID_F32_STAGES:
                    assert lib.ocrs_gru_grid_f32_smem(kind, 16, split.resident, 0, stages) == \
                        grid_f32_smem(name, h, stages), h
            for ring in {split.stages, split.stages + 1, max(split.stages - 1, 0)}:
                assert lib.ocrs_gru_grid_f32_smem(kind, plan.units, split.resident, ring,
                                                  plan.stages) == grid_f32_kernel_smem(
                    name, plan.units, split.resident, ring, plan.stages), h
            got = grid_f32_kernel_smem(name, plan.units, split.resident, split.stages, plan.stages)
            assert got <= min(smem, H100_SMEM), h


@pytest.mark.parametrize("t,n", [(3, 5), (9, 128)])
def test_gru_f32_above_the_grid_form_runs_one_launch_a_step(dev, t, n):
    # GRID_F32_MAX_HIDDEN + 8 (2120): 67 unit tiles of 32 units in both
    # directions outnumber the SMs, so f32 runs the per-step form there (gru_wide.cu,
    # one launch a step), held at the per-step form's f32 tolerances, with
    # bit-identical reruns.
    h = GRID_F32_MAX_HIDDEN + 8
    assert gru_route(h) == "stepwise" and grid_f32_plan(n, h) is None
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, 29)
    ys, forms = _form_calls(gru_fwd, px_f, px_b, w_hh, b_hh)
    assert forms["gru_wide_fwd"]["stepwise"] == 1
    calls = _launch_calls(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
    assert calls["cudaLaunchKernelExC"] == 0 and calls["cudaLaunchKernel"] >= t
    for a, b, c in zip(ys, gru_fwd(px_f, px_b, w_hh, b_hh),
                       gru_recurrence_reference(px_f, px_b, w_hh, b_hh)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    grads, forms = _form_calls(gru_bwd, *args)
    assert forms["gru_wide_bwd"]["stepwise"] == 1
    for a, b in zip(grads, gru_bwd(*args)):
        assert torch.equal(a, b)
    want = gru_bwd_reference(*args)
    for a, b in zip(grads[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    for a, b in zip(grads[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-5)


def _assert_dw_on_the_chains_dph(px_f, px_b, ys, dy_f, dy_b, w_hh, b_hh, grads, scratch,
                                 rtol, min_equal):
    """dW against the plain dW phase on the bf16(dph) the chain handed on
    (its dpx and ``scratch["dhn"]``), 1e-5 of the largest entry, and that
    dhn against the chain's plain version at dpx's tolerance and equal
    share."""
    dhn = scratch["dhn"]
    dw_want = gru_bwd_dw_bf16_reference(*ys, grads[0], grads[1], dhn)
    torch.testing.assert_close(grads[2], dw_want, rtol=0,
                               atol=1e-5 * dw_want.abs().max().item() + 1e-6)
    coef = gru_bwd_coefficients_reference(px_f, px_b, *ys, w_hh, b_hh)
    dhn_want = gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh)[2]
    assert dhn.dtype == BF16 and dhn.shape == dhn_want.shape
    torch.testing.assert_close(dhn.float(), dhn_want.float(), rtol=rtol, atol=2e-2)
    assert (dhn == dhn_want).float().mean().item() >= min_equal


def test_grid_plan_counts_the_kernels_shared_memory(dev):
    # grid_plan's fit rests on grid_kernel_smem (and grid_smem where the
    # whole slice is resident); the kernels ask the runtime for their own
    # (gru_grid.cu's fwd_smem, chain_smem, with the plan's resident k16
    # steps, ring stages and rows a pass): the same bytes, at every width
    # the grid form takes on an H100, at passes of 64 rows (N=3) and of 128
    # where the streamed kernels take them (N=128), within what this card's
    # blocks may use.
    lib = _grid_lib()
    smem = grid_limits(dev.index)[1]
    for h, n in ((h, n) for h in range(520, GRID_MAX_HIDDEN + 1, 8) for n in (3, 128)):
        plan = grid_plan(n, h)
        sizes = [lib.ocrs_gru_grid_smem(kind, plan.units, split.resident, split.stages,
                                        split.pass_rows)
                 for kind, split in enumerate((plan.fwd, plan.chain))]
        assert sizes == [grid_kernel_smem(kind, plan.units, split.resident, split.stages,
                                          split.pass_rows)
                         for kind, split in (("fwd", plan.fwd), ("chain", plan.chain))], h
        assert max(sizes) <= min(smem, H100_SMEM), h
        if h <= GRID_RESIDENT_HIDDEN:
            assert max(sizes) == grid_smem(h, plan.units), h


@pytest.mark.parametrize("t,n", [(3, 5), (9, 128)])
def test_gru_bf16_above_the_grid_form_runs_one_launch_a_step(dev, t, n):
    # GRID_MAX_HIDDEN + 8 (6344): no plan of the grid form (67 unit tiles
    # of 96 units a direction outnumber the SMs), so bf16 runs the
    # per-step form there, as f32 does above GRID_F32_MAX_HIDDEN (its coef
    # and dW phases gru_bwd_wide.cu's).
    h = GRID_MAX_HIDDEN + 8
    assert gru_route(h, BF16) == "stepwise" and grid_plan(n, h) is None
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, 23)
    px_f, px_b, dy_f, dy_b = (v.to(BF16) for v in (px_f, px_b, dy_f, dy_b))
    ys, forms = _form_calls(gru_fwd, px_f, px_b, w_hh, b_hh)
    assert forms["gru_wide_fwd"]["stepwise"] == 1
    calls = _launch_calls(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
    assert calls["cudaLaunchKernelExC"] == 0 and calls["cudaLaunchKernel"] >= t
    for a, c in zip(ys, gru_recurrence_reference(px_f, px_b, w_hh, b_hh)):
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=2e-2)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    grads, forms = _form_calls(gru_bwd, *args)
    assert forms["gru_wide_bwd"]["stepwise"] == 1
    want = gru_bwd_reference(*args)
    for a, b in zip(grads[:2], want[:2]):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2e-2)
    scratch = {}
    again = gru_bwd(*args, scratch_out=scratch)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    # db end to end; dW end to end at T=9, N=128 (1024 rows a dW entry).
    # At T=3, N=5, 15 rows, dW is held as the grid form's test holds it at
    # N=3 (the flips of bf16(dph), whose sums run over 3H terms, left 20 of
    # 168M entries up to 1.1 times 1e-3 of the largest end to end at H =
    # 5288: PERF.md).
    torch.testing.assert_close(grads[3], want[3], rtol=0, atol=1e-3 * want[3].abs().max().item() + 1e-5)
    if n >= 128:
        torch.testing.assert_close(grads[2], want[2], rtol=0,
                                   atol=1e-3 * want[2].abs().max().item() + 1e-5)
    else:
        _assert_dw_on_the_chains_dph(px_f, px_b, ys, dy_f, dy_b, w_hh, b_hh, grads, scratch,
                                     0.0, 0.93)


@pytest.mark.parametrize("h", [520, 1024, 1448, 4096])
@pytest.mark.parametrize("t,n", [(9, 259), (2, 3)])
def test_bf16_coef_and_dw_on_wgmma_match_their_plain_versions(dev, t, n, h):
    # gru_bwd_wide.cu's coefficients and dW/db (bf16 above 512) against
    # gru_bwd_coefficients_reference and gru_bwd_dw_bf16_reference on the
    # same bf16 operands: the products of bf16 values are exact in f32, so
    # only the order of the f32 sums differs, within 1e-5 of the largest
    # entry (coef: the gates through sigmoid and tanh of those sums); db is
    # the chain's partials summed in order. Reruns are bit-identical, and
    # the grouped tile order (1, the wrapper's) gives the same bits as the
    # plain one (0). At N=259, T=9: 2331 rows, 19 row tiles of coef (two
    # groups of its grouped order, the last of 3) and 37 stages of dW, the
    # last ragged; at N=3, T=2 one stage, mostly zero-filled; H=4096: 32 k
    # tiles of dW (three groups, the last of 8).
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, h + t)
    px_f, px_b = px_f.to(BF16), px_b.to(BF16)
    ys_f, ys_b = ((torch.rand((t, n, h), device=dev) * 2 - 1).to(BF16) for _ in range(2))
    dpx_f, dpx_b = ((torch.randn((t, n, 3 * h), device=dev) * 0.1).to(BF16) for _ in range(2))
    dhn = (torch.randn((2, t, n, h), device=dev) * 0.1).to(BF16)
    lib = _bwd_wide_lib()
    p = _build.ptr
    stream = _build.stream_ptr(dev)
    w16 = w_hh.to(BF16)

    def coef(order=1):
        out = torch.empty((2, t * n, 5, h), device=dev)
        _build.check(lib, lib.ocrs_gru_bwd_coef_wide_bf16(
            dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(w16), p(b_hh), p(out), t, n, h,
            order, stream), "coef")
        return out

    parts = 3
    dbp = torch.randn((parts, 2, 3 * h), device=dev)

    def dw(splits, order=1):
        dwp = torch.empty((splits, 2, h, 3 * h), device=dev)
        out, db = torch.empty_like(w_hh), torch.empty_like(b_hh)
        _build.check(lib, lib.ocrs_gru_bwd_dw_wide_bf16(
            dev.index, p(ys_f), p(ys_b), p(dpx_f), p(dpx_b), p(dhn), p(dwp), p(dbp), parts,
            p(out), p(db), splits, t, n, h, order, stream), "dw")
        return out, db

    got = coef()
    assert torch.equal(got, coef()) and torch.equal(got, coef(order=0))
    want = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    dw_want = gru_bwd_dw_bf16_reference(ys_f, ys_b, dpx_f, dpx_b, dhn)
    db_want = dbp[0] + dbp[1] + dbp[2]
    for splits in (1, 2):
        dw_got, db_got = dw(splits)
        assert all(torch.equal(a, b) for a, b in zip((dw_got, db_got), dw(splits)))
        assert all(torch.equal(a, b) for a, b in zip((dw_got, db_got), dw(splits, order=0)))
        torch.testing.assert_close(dw_got, dw_want, rtol=0, atol=1e-5 * dw_want.abs().max().item())
        assert torch.equal(db_got, db_want)


@pytest.mark.parametrize("h", [520, 1064, 2048, 2120])
@pytest.mark.parametrize("t,n", [(9, 259), (2, 3)])
def test_f32_coef_and_dw_on_wgmma_match_their_plain_versions(dev, t, n, h):
    # gru_bwd_wide.cu's f32 coefficients and dW/db (3xTF32 on wgmma, the
    # wide backward's above 512) against gru_bwd_coefficients_reference and
    # gru_bwd_dw_reference on the dph that dpx and coef's r give, both in
    # f32: coef within 1e-4 of its largest entry (the gates of 3xTF32 sums:
    # the tensor cores' f32 sums truncate, so at H=2048, T=9, N=259 coef
    # reads 1.3e-5 against float64, the f32 plain version 1.3e-6: grid_probe
    # --f32-phase-readings, PERF.md) and bit for
    # bit gru_bwd.cu's mma.sync coef (the same split, the same k8 steps in
    # the same order, the same gate epilogue), dW and db within the f32
    # wide tests' 1e-4 of their largest entry + 1e-5.
    # Reruns are bit-identical, and the grouped tile order (1, the
    # wrappers') gives the same bits as the plain one (0), with 1 and 2
    # ranges of rows. At N=259, T=9: 2331 rows, 19 row tiles of coef (two
    # groups, the last of 3) and 146 stages of dW, the last ragged; at
    # H=1064 the last unit tile (64 units) and k tile (192) of dW ragged,
    # 2120 too (in coef 34 unit tiles, 12 k tiles of dW: two groups of its
    # grouped order); at N=3, T=2 one stage, mostly zero-filled.
    px_f, px_b, w_hh, b_hh, _, _ = _gru_case(t, n, h, dev, h + t + 1)
    ys_f, ys_b = ((torch.rand((t, n, h), device=dev) * 2 - 1) for _ in range(2))
    dpx_f, dpx_b = ((torch.randn((t, n, 3 * h), device=dev) * 0.1) for _ in range(2))
    got = gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
    assert torch.equal(got, gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh))
    assert torch.equal(got, gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh, order=0))
    want = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())
    lib, p = _bwd_lib(), _build.ptr
    old = torch.empty_like(got)
    _build.check(lib, lib.ocrs_gru_bwd_coef(
        dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(w_hh), p(b_hh), p(old), t, n, h,
        _build.stream_ptr(dev)), "gru_bwd.cu coef")
    assert torch.equal(got, old)
    dw_want, db_want = gru_bwd_dw_reference(ys_f, ys_b, _dph(dpx_f, dpx_b, want))
    for splits in (1, 2):
        dw, db = gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, got, splits)
        for again in (gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, got, splits),
                      gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, got, splits, order=0)):
            assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
        for a, b in ((dw, dw_want), (db, db_want)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-5)


def test_f32_wgmma_phases_ask_for_the_shared_memory_their_mirror_counts(dev):
    # bwd_wide_f32_smem (what the CPU tests hold against the card's 227 KB)
    # is what gru_bwd_wide.cu's f32 kernels ask the runtime for, within
    # what this card's blocks may use.
    lib = _bwd_wide_lib()
    smem = grid_limits(dev.index)[1]
    for kind, name in enumerate(("coef", "dw")):
        assert lib.ocrs_gru_bwd_wide_f32_smem(kind) == bwd_wide_f32_smem(name)
        assert bwd_wide_f32_smem(name) <= min(smem, H100_SMEM)


@pytest.mark.parametrize("shape", [(33, 40, 264), (2, 259, 512), (7, 4, 1024)])
def test_gru_wide_bf16_chain_hands_on_its_plain_versions_dhn(dev, shape):
    # What the bf16 wide chain hands gru_bwd.cu's dW phase, bf16(dhn), and
    # its db partials summed, against the chain's plain version, as the
    # cluster chain's test holds it: in both forms, and at N=259 where the
    # persistent chain's batch tiles (and so db's partials) are ragged.
    t, n, h = shape
    px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, 14)
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


@pytest.mark.parametrize("h", [264, 512, 1024, GRID_F32_MAX_HIDDEN + 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gru_wide_kernels_on_two_streams_do_not_disturb_each_other(dev, dtype, h):
    # As the cluster kernels' test: each call's state and scratch are its
    # own, so two calls in flight at once give what each gives alone (in
    # the persistent form at H=264 and 512; at 1024 in the grid form,
    # gru_grid_f32.cu in f32 and gru_grid.cu in bf16, whose step counters
    # and state are the call's own and whose cooperative launches each hold
    # all their blocks at once; at 2120 the per-step form in f32, one
    # launch a step with the state in the call's scratch, and the grid form
    # in bf16, W_hh partly streamed).
    cases = []
    for t, n, seed in ((33, 72, 15), (20, 100, 16)):
        px_f, px_b, w_hh, b_hh, dy_f, dy_b = _gru_case(t, n, h, dev, seed)
        cases.append((px_f.to(dtype), px_b.to(dtype), w_hh, b_hh, dy_f.to(dtype), dy_b.to(dtype)))
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


def _ctc_case(t_len, n, s, dev, seed, dense=False):
    """Random CTC operands; ``alpha0`` as the loss builds it (finite at
    positions 0 and 1 only), or, ``dense``, drawn at every position."""
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
    if dense:
        alpha0 = torch.from_numpy(rng.normal(-3.0, 1.0, (n, s)).astype(np.float32)).to(dev)
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
# the largest block of one position a thread; 1025, 2049: two and four a
# thread with a ring; 12001, 30001: the state in device memory (from 1025
# on, alpha0 at every position, so that every position a thread holds has
# a value to carry into its frozen rows). T = 20 wraps both rings. Lengths
# 0 (acts as 1), 1, 2, T and T + 3: from every sample another step on is
# frozen.
@pytest.mark.parametrize("s", [1, 2, 31, 32, 33, 64, 65, 129, 512, 513, 1024, 1025, 2049,
                               12001, 30001])
def test_ctc_alpha_kernel_matches_plain_with_frozen_rows(dev, s):
    t_len = 20
    emit, skip, alpha0, _, _ = _ctc_case(t_len, 5, s, dev, s + 7, dense=s > 1024)
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


# Above S = 1024 a thread owns 2 ceil(S / 2048) positions, one in each of
# its slots (csrc/ctc_step.cuh, "Wide samples"; ops.ctc.wide_slots). S =
# 1025 and 2049 are the training step's label arrays 512 and 1024 wide;
# they, 4097 and alpha at 6001 keep the state and a ring of inputs in
# shared memory; beta at 6001 and both at 12001 and 30001 the state in
# device memory. The loss's own alpha0 reaches position j only at step
# j / 2, so at a short T most positions would hold NEG_INF throughout:
# alpha0 is drawn at every position (`dense`), and at T = 700 the loss's
# alpha0 reaches the last of 1025 positions through the recursion itself.
# The sample of length T (it has a cotangent) must carry live values in
# every slot: finite states and nonzero gradients at 90% of them (dense),
# 20% (T = 700: position j is reached at about step j / 1.5). Lengths 1
# and T are in every case, and sample 0 has no cotangent.
@pytest.mark.parametrize("t_len,n,s,dense,designs", [
    (20, 4, 1025, True, ("ring", "ring")), (700, 3, 1025, False, ("ring", "ring")),
    (20, 3, 2049, True, ("ring", "ring")), (9, 3, 4097, True, ("ring", "ring")),
    (9, 3, 6001, True, ("ring", "global")), (5, 3, 12001, True, ("global", "global")),
    (3, 3, 30001, True, ("global", "global")),
])
def test_ctc_kernels_bit_equal_to_plain_past_a_block_of_positions(dev, t_len, n, s, dense,
                                                                  designs):
    emit, skip, alpha0, lens, d = _ctc_case(t_len, n, s, dev, s, dense)
    assert (ctc_design("ctc_alpha", s, dev), ctc_design("ctc_beta", s, dev)) == designs
    before = (ctc_alpha.launches, ctc_beta.launches)
    alphas = ctc_alpha(emit, skip, alpha0, lens)
    final = ctc_alpha(emit, skip, alpha0, lens, final_only=True)
    seed, sign = _beta_operands(alphas, d)
    got = ctc_beta(emit, skip, alphas, seed, sign, lens)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta.launches) == (before[0] + 2, before[1] + 1)
    want_a = ctc_alpha_reference(emit, skip, alpha0, lens)
    assert torch.equal(alphas, want_a) and torch.equal(final, want_a[:, -1])
    want = ctc_beta_reference(emit, skip, alphas, seed, sign, lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and (got[0][:, 0] == 0).all()
    assert lens[-1].item() == t_len and d[-1].abs().min() > 0
    least = 0.9 if dense else 0.2
    for slot in wide_slots(s):
        cols = slice(slot.start, slot.stop)
        assert (want_a[-1, 1:, cols] > NEG_INF / 2).float().mean().item() >= least, slot
        assert (want[0][-1, 1:, cols] != 0).float().mean().item() >= least, slot


def test_ctc_kernels_refuse_more_states_than_32_bit_offsets_hold(dev):
    # T * S = 2^31: refused by the wrappers before anything is checked or
    # allocated (a broadcast tensor stands for the 8.6 GB of emissions).
    emit = torch.zeros(1, device=dev).expand(1, 2**16, 2**15)
    small = torch.zeros((1, 2**15), device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    before = (ctc_alpha.launches, ctc_beta.launches)
    with pytest.raises(ValueError, match="32-bit offsets"):
        ctc_alpha(emit, small, small, lens)
    with pytest.raises(ValueError, match="32-bit offsets"):
        ctc_beta(emit, small, emit, small, torch.ones(1, device=dev), lens)
    assert (ctc_alpha.launches, ctc_beta.launches) == before


def test_ctc_alpha_chain_probe_times_its_steps(dev):
    # The warp path (S=13), the block paths with an 8-row and a 4-row ring
    # (S=129, 513), and past 1024 positions (1025, 4097); the probe is no
    # launch of the kernel. With the state in device memory (30001) there
    # is no chain alone to time.
    before = (ctc_alpha.launches, ctc_beta.launches)
    for t_len, s in ((9, 13), (257, 129), (20, 513), (20, 1025), (9, 4097)):
        for probe in (ctc_alpha_chain_probe, ctc_beta_chain_probe):
            got = probe(t_len, s, dev)
            assert got["steps"] == t_len - 1 and got["cycles"] > 0 and got["ns"] >= 0
    for probe in (ctc_alpha_chain_probe, ctc_beta_chain_probe):
        with pytest.raises(RuntimeError, match="CUDA error"):
            probe(3, 30001, dev)
    assert (ctc_alpha.launches, ctc_beta.launches) == before


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
    assert counts == {k: 2 * per_step.get(k, 0) + per_batch.get(k, 0) for k in counts}
    assert counts["gru_wide_fwd"] == counts["gru_wide_bwd"] == 0  # H=256: the cluster route
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


def test_layout_train_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    # One f32 step from the same weights, dropout at 0: loss 1e-5 relative,
    # gradient norms 1e-4. The weights are the ones these limits were set
    # on, PyTorch's default initialisers from seed 0: flax's (the shipped
    # ones since PR 11) draw larger kernels, whose sharper attention moves
    # one layer's gradient norm by 1.8e-4 between cuBLAS's and the CPU's
    # float32 sums.
    monkeypatch.setattr(layout_module, "flax_init_", lambda model: model)
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


# --------------------------------------------------------------- detection
# The detector, its balanced BCE and its step run cuDNN convolutions and
# plain PyTorch ops (the JAX detector reaches no Pallas kernel); these hold
# the card against the CPU on the same weights.


def _det_batch(n=4, size=(256, 192), seed=1) -> dict:
    ds = SyntheticDetection(size=n, page_size=size, seed=seed)
    batch = collate_detection([ds[i] for i in range(n)])
    return {k: batch[k] for k in ("image", "mask", "sample_weight")}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_detection_train_step_on_the_card_matches_the_cpu(dev, dtype):
    # Full width at 256x192, one step from the same weights: f32 (TF32
    # off) loss 1e-4 relative, grad norm 1e-3, module norms 2e-2 (a max-pool
    # window whose candidates tie within float noise routes its gradient
    # to the other one); bf16 loss 1e-2, grad norm 1e-1, module norms
    # 2.5e-1; parameters within 2 lr (Adam's first step is about +-lr).
    torch.manual_seed(0)
    model = DetectionModel(dtype=dtype)
    batch = _det_batch()
    out = []
    for device in (torch.device("cpu"), dev):
        m = copy.deepcopy(model).to(device)
        train, _ = make_detection_steps(m)
        metrics = train(create_train_state(m), batch, 1e-3)[1]
        out.append((metrics, {k: v.float().cpu() for k, v in m.state_dict().items()}))
    (cpu, cpu_sd), (card, card_sd) = out
    loss, norm, module = (1e-4, 1e-3, 2e-2) if dtype == torch.float32 else (1e-2, 1e-1, 2.5e-1)
    assert card["pred"].is_cuda and card["pred"].dtype == torch.float32
    torch.testing.assert_close(card["loss"].cpu(), cpu["loss"], rtol=loss, atol=0)
    torch.testing.assert_close(card["grad_norm"].cpu(), cpu["grad_norm"], rtol=norm, atol=0)
    for k, v in cpu["grad_norms"].items():
        torch.testing.assert_close(card["grad_norms"][k].cpu(), v, rtol=module, atol=0)
    for k, v in cpu_sd.items():
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert float((card_sd[k] - v).abs().max()) <= 2e-3 + 1e-6, k


def test_balanced_bce_on_the_card_matches_the_cpu_without_a_sync(dev):
    # Value and gradient 1e-5 of the CPU's; no host sync anywhere in it.
    gen = torch.Generator().manual_seed(0)
    pred = torch.rand((3, 1, 200, 150), generator=gen)
    target = (torch.rand((3, 1, 200, 150), generator=gen) > 0.8).float()
    weight = torch.tensor([1.0, 1.0, 0.0])
    p_cpu = pred.clone().requires_grad_()
    want = balanced_cross_entropy_loss(p_cpu, target, weight)
    want.backward()
    p_card = pred.to(dev).requires_grad_()
    target, weight = target.to(dev), weight.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = balanced_cross_entropy_loss(p_card, target, weight)
        got.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(p_card.grad.cpu(), p_cpu.grad, rtol=0, atol=1e-5)


def test_train_detection_and_eval_detection_on_the_card(dev, tmp_path, monkeypatch):
    # Two bf16 epochs on 8 pages at 256x192: finite losses; then
    # eval_detection on a page saved as PNG, from the trainer's --export,
    # writes its four PNGs.
    monkeypatch.chdir(tmp_path)
    args = ["synthetic", "-", "--max-images", "8", "--mask-height", "256"]
    state = train_detection.main([*args, "--max-epochs", "2"])
    assert state.step == 4 and state.model.dtype == BF16
    records = [json.loads(line) for line in
               (tmp_path / "text-detection-metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in records if "epoch" in r for k in ("train_loss", "val_loss")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert train_detection.main([*args, "--export", "det.pt"]) is None
    page = SyntheticDetection(size=1, page_size=(300, 260), seed=4)[0]["image"]
    write_png(str(tmp_path / "page.png"), ((page[..., 0] + 0.5) * 255).round().astype(np.uint8))
    eval_detection.main(["det.pt", "page.png", "out"])
    for part, shape in (("input", (800, 600)), ("text-probs", (800, 600)),
                        ("text-regions", (300, 260)), ("text-words", (300, 260, 3))):
        assert read_png(str(tmp_path / f"out-{part}.png")).shape[:len(shape)] == shape, part


# ------------------------------------------------------------------- export

EXPORT_CASES = {
    # kind: (model, input name, input, output name, atol)
    "detection": (lambda: DetectionModel(), "image", (2, 1, 128, 96), "mask", 2e-4),
    "recognition": (lambda: RecognitionModel(n_classes=97), "line_image", (3, 1, 64, 96),
                    "chars", 2e-4),
    "layout": (lambda: LayoutModel(), "word_boxes", (2, 40, 4), "preds", 5e-4),
}


@pytest.mark.parametrize("kind", EXPORT_CASES)
def test_export_of_a_model_on_the_card_matches_its_forward(dev, kind, tmp_path):
    # A model living on the card exports through export_weights; the numpy
    # evaluator on the host agrees with the card's float32 forward (TF32
    # off) within the CPU tests' bounds (tests/test_torch_export.py). The
    # recognizer's forward runs stage1_fwd and gru_fwd.
    make, name, shape, out, atol = EXPORT_CASES[kind]
    torch.manual_seed(0)
    model = make().to(dev).eval()
    kwargs = {"height": shape[2], "width": shape[3]} if kind == "detection" else {}
    export_weights(create_train_state(model), str(tmp_path / "m.onnx"), kind, **kwargs)
    graph = parse_model((tmp_path / "m.onnx").read_bytes())
    check_model(graph)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(shape, generator=g)
    x = x * 500 if kind == "layout" else x - 0.5
    launches = stage1_fwd.launches, gru_fwd.launches
    with torch.no_grad(), numerics():
        want = model(x.to(dev)).cpu().numpy()
    if kind == "recognition":
        assert (stage1_fwd.launches - launches[0], gru_fwd.launches - launches[1]) == (1, 2)
        want = want.transpose(1, 0, 2)  # [N, T, C] -> the graph's [T, N, C]
    got = run_graph(graph, {name: x.numpy()})[out]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_world1_nccl_recognition_step_equals_the_plain_step(dev, tmp_path):
    # A one-rank NCCL process group (a spawned process): the collective
    # recognition step bit-equal to the plain one (tests/torch_parallel_workers.py).
    from ocrs_models_torch.parallel import spawn
    from torch_parallel_workers import world1_recognition_rank

    (r,) = spawn(world1_recognition_rank, 1, dev, timeout=600, store_dir=str(tmp_path))
    assert r["backend"] == "nccl" and r["mesh_size"] == 1
    assert r["equal"], r["losses"]


# ------------------------------------------ components and preprocessing

def _mask_batch(kind):
    if kind == "random-64x96":
        return np.random.default_rng(0).uniform(size=(3, 64, 96)) < 0.55
    pages = SyntheticDetection(size=2, page_size=(800, 600), seed=3)
    return np.stack([pages[i]["mask"][..., 0] > 0.5 for i in range(2)])


@pytest.mark.parametrize("kind", ["random-64x96", "targets-800x600"])
def test_connected_components_and_bounds_on_card_equal_cpu(dev, kind):
    masks = _mask_batch(kind)
    want = connected_components_device(masks, device="cpu")
    got = connected_components_device(masks, device=dev)
    assert got.device == dev and torch.equal(got.cpu(), want)
    counts = [len(torch.unique(m[m > 0])) for m in want]
    for k in (1, 4, max(counts) + 1):
        boxes, valid = component_bounds_device(got, k, device=dev)
        want_boxes, want_valid = component_bounds_device(want, k, device="cpu")
        assert torch.equal(valid.cpu(), want_valid) and torch.equal(boxes.cpu(), want_boxes)
    assert max(counts) > 4


@pytest.mark.parametrize("case", [(150, 600, 64, 256), (100, 30, 64, 19), (37, 411, 64, 710)])
def test_batch_resize_on_card_matches_cpu(dev, case):
    h, w, out_h, out_w = case
    x = torch.rand((4, 1, h, w), generator=torch.Generator().manual_seed(h)) - 0.5
    got = pre.batch_resize(x, out_h, out_w, device=dev)
    assert got.device == dev
    torch.testing.assert_close(got.cpu(), pre.batch_resize(x, out_h, out_w, device="cpu"),
                               rtol=0, atol=1e-5)


def test_line_crops_and_photometric_on_card_match_cpu(dev):
    crops = torch.randint(0, 256, (16, 1, 96, 700), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    want = pre.prepare_line_crops(crops, 64, 800, device="cpu")
    got = pre.prepare_line_crops(crops, 64, 800, device=dev)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    # Draws from a CPU generator: the same jitter on both devices.
    jit = pre.photometric_augment(got, torch.Generator().manual_seed(1), device=dev)
    jit_cpu = pre.photometric_augment(want, torch.Generator().manual_seed(1), device="cpu")
    torch.testing.assert_close(jit.cpu(), jit_cpu, rtol=0, atol=1e-5)
    on_card = pre.photometric_augment(got, torch.Generator(dev).manual_seed(1), device=dev)
    assert on_card.device == dev and -0.5 <= on_card.min() <= on_card.max() <= 0.5
