#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, recognition training step,
recognition trainer and layout model (served and trained) on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``ocrs_models_torch/csrc`` (nvcc, sm_90a,
   one process per source, in parallel) and the host geometry core; print
   how many thread block clusters of the biGRU kernels the card holds at
   once (``cudaOccupancyMaxActiveClusters``) beside how many they launch.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: stage 1 at [128, 1, 64, W] for W in {256, 800}
   (atol 1e-5), the biGRU recurrence at T=201, N=128 and T=65, N=256,
   H=256 (atol 1e-4: error accumulates over 201 steps). Time kernel, plain
   version and the library yardstick (F.conv2d + relu + max_pool2d; cuDNN
   nn.GRU) with CUDA events; for the biGRU kernels also the time per step
   and the device launches of one call (torch.profiler), for stage 1 its
   device time, both times' shares of its bound and its device launches
   per call, which must be 1 (no weight cast or copy). Then the bf16
   variants at the same shapes against their bf16 plain versions: stage 1
   at least 99% equal and the rest within one bf16 ulp or 1e-5, ``ys``
   within 2e-2 and at least 95% equal; bounds take bf16 bytes and the
   bf16 peak. The bf16 biGRU rows also give the rows per block, the
   clusters launched and how many the card holds at once, and the device
   time (``gru_bwd``'s by phase: ``coef``, ``chain``, ``dw_bf16``,
   ``dw_sum``).
4. Hold the full recognition forward (kernels) against the same model
   with the kernels' plain versions swapped in: log-probs at atol 1e-4,
   5e-2 for the bf16 model.
5. The main path: ``OcrPipeline.run_batch`` on 16 synthetic pages at the
   shipped widths (detection 800x600, CRNN 32-64-128 channels, 2-layer
   biGRU H=256, 97 classes; random weights from a fixed seed),
   det_batch=8, rec_batch=128. Launch counts are zeroed just before it and
   read just after; every kernel must have launched. Detection
   probabilities are checked against the CPU on two pages.
6. ``_recognize_crops`` on 128 crops in each width bucket (256, 512, 768,
   800), so every recognition shape runs whatever detection found.
   Serving launches only the forward kernels. Phases 5 and 6 run an f32
   and a bf16 pipeline on the same weights and print their agreement.
7. Hold each backward kernel against its plain version at the training
   step's largest shapes: stage-1 backward at x [256,1,64,256] and
   [128,1,64,1024] (with the device time of its two passes, their share of
   its bound, its device launches per call, which must be 2, and the grid
   it chose); the biGRU backward at T=65,
   N=256 and T=257, N=128, H=256; the CTC alpha and beta recursions at
   T=257, N=128, S=129 with ragged lengths, repeated labels, an empty
   label and an infeasible row, and at the training step's two shapes
   (N=256, T=65 and N=128, T=257; S=49 and 97, and S=129 as the step pads
   its labels). Time kernel, plain version and the library yardstick
   (autograd backward of conv2d+relu+max_pool2d; cuDNN nn.GRU backward;
   F.ctc_loss forward and backward) with CUDA events, the short CTC
   kernels also on the device's own clock (torch.profiler); for both CTC
   kernels also ``chain_ms``, their dependent steps alone as timed by the
   kernel's clocks on one block with no global access in the loop. Then
   the bf16 stage-1 and biGRU backward at the same shapes (dW within 1e-3
   of its max; ``dpx`` within 2e-2 and at least 95% equal).
8. The training step (``training.steps.make_recognition_steps``) at full
   width (CRNN 32-64-128, 2-layer biGRU H=256, 97 classes, TF32 off, Adam
   with clip 4.0, lr 1e-3), in f32 and in bf16: one step against the same
   step with every kernel's plain version swapped in, from the same
   weights (bf16: loss 1e-2, each module's gradient norm 5e-2); the headline
   batch 256 x 64x256 (one warm-up step, then timed steps on which the
   loss must fall, launch counts zeroed just before and read just after);
   the wide bucket 128 x 64x1024; in f32 ``grad_accum=4`` and ``eval_step``.
9. The trainer CLI (``training/train_rec.py``) on synthetic lines, in a
   temporary directory, with exact launch counts for each run: three
   epochs at the JAX trainer's defaults (bf16, 512 augmented lines, batch 20;
   every loss finite, epoch 2's train loss below epoch 0's, a checkpoint
   and three metrics records); a resume from the checkpoint for exactly
   one more epoch, the Adam step restored; ``--validate-only``; then two
   epochs each at batch 128 (2048 lines) in bf16 without and with
   augmentation and in f32 (``--no-bf16``) without, printing epoch 1's
   crops/s beside phase 8's wide step rate of the same dtype; then the host's work alone at batch 128 (the
   loader's rate at two threads and one, ms per line drawn, per batch
   collated and per batch scored).

10. The layout model in serving (``OcrPipeline(use_layout_model=True)``,
    float32 with TF32 off, the full-width ``LayoutModel(return_probs=True)``
    from a fixed seed, its ``classify`` bias shifted so that a quarter of
    the words are predicted line starts and a quarter line ends): 16 ``SyntheticDocLayout`` pages' word quads
    (hundreds of words each, some past the model's 500) through
    ``_group_lines_layout_batch``, one ``[16, 500, 4]`` forward, on the card
    and on the CPU (probabilities within 1e-4, the line groupings equal);
    the forward's time (CUDA events, device time); ``run_batch`` with the
    layout model on phase 5's pages (counts zeroed just before, read just
    after: every recognition chunk launches its kernels) and its pages/s.
11. Layout training (``training.steps.make_layout_steps``, plain PyTorch
    products: the JAX layout model reaches no Pallas kernel): one step on
    the card against the CPU from the same weights, f32, dropout 0 (loss
    1e-5 relative, gradient norms 1e-4); ``grad_accum=4`` against one step
    at batch 64 (loss 1e-5); 10 timed steps in bf16 and in f32 at batch 64 x
    500 words (median [min, max] by CUDA events, pages/s; the loss must
    fall; no port kernel launches); then the trainer CLI
    (``training/train_layout.py``) on ``synthetic-doc`` at its defaults
    (bf16, batch 64) cut to 32 pages: three epochs, a resume for one more
    with the Adam step restored, ``--validate-only``, ``--export
    layout.pt``, and ``eval_layout`` on a ``write_corpus`` page, whose PNG
    must decode with ``zlib``.

Prints the nvidia-smi line, throughput lines, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 1234
N_PAGES = 16
DET_BATCH = 8
REC_BATCH = 128
BUCKET_WIDTHS = (256, 512, 768, 800)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, bf16 dense on the tensor cores
PROFILE_CALLS = 10  # calls per profiler window
BF16 = torch.bfloat16


def _cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(fn, calls: int = PROFILE_CALLS) -> tuple[float, dict, dict]:
    """What one call of ``fn`` puts on the device (``torch.profiler`` over
    ``calls`` calls after a warm-up): the number of kernels, copies and
    sets it launches; by name, the device time of one launch in ms; and by
    name, the number of device records the profiler delivered. Each of
    ``fn``'s kernels runs once a call, so the time is the mean over the
    records: the profiler now and then delivers fewer than there were
    launches, and now and then none for a whole window, which is then
    profiled again, up to three times. If no window delivers a record, the
    device times are not measured: both dicts come back empty, every device
    time read from them is None (null in the kernels line), and the launch
    count, read from the host's runtime calls, stands."""
    from torch.profiler import ProfilerActivity, profile

    from ocrs_models_torch.profile_kernels import device_launches, device_records

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = device_records(prof)
        if records:
            break
    else:
        print(f"the profiler delivered no device record in 3 windows of {calls} calls: "
              "device time not measured", flush=True)
    return (device_launches(prof) / calls, {k: sum(v) / len(v) for k, v in records.items()},
            {k: len(v) for k, v in records.items()})


def _device_ms(times: dict, part: str) -> float | None:
    """Device time per call of the kernels whose name contains ``part``;
    None where the profiler delivered no record at all."""
    if not times:
        return None
    found = [ms for name, ms in times.items() if part in name]
    if not found:
        raise AssertionError(f"no kernel named *{part}* ran on the device: {sorted(times)}")
    return sum(found)


def _ms_sum(*parts: float | None) -> float | None:
    return None if any(p is None for p in parts) else sum(parts)


def _fmt(value: float | None, digits: int = 4) -> str:
    return "not measured" if value is None else f"{value:.{digits}f}"


def _no_tf32():
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=True, deterministic=False, allow_tf32=False
    )


_HEADLINE_KEYS = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "us_per_step",
                  "device_launches_per_call")
_STAGE1_BWD_EXTRA = ("device_ms", "second_pass_ms", "device_launches_per_call", "grid")


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """The largest difference in bf16 ulps of the larger magnitude, and the
    largest absolute difference among the elements more than one ulp apart
    (0 if there is none)."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)
    ulps = diff / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    beyond = diff[ulps > 1]
    return float(ulps.max()), float(beyond.max()) if beyond.numel() else 0.0


def _equal_share(got, want) -> float:
    """The share of elements of ``got`` (one tensor or several) exactly
    equal to ``want``'s."""
    pairs = list(zip(got, want)) if isinstance(got, (tuple, list)) else [(got, want)]
    equal = sum(int((a == b).sum()) for a, b in pairs)
    return equal / sum(a.numel() for a, _ in pairs)


def _bound(n_bytes: float, n_flops: float, flops_per_s: float = F32_FLOPS_PER_S
           ) -> tuple[float, str]:
    """The least time in ms for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_page(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A greyscale page in [-0.5, 0.5]: white paper with paragraphs of
    text-like ink strokes (words of vertical bars joined at the baseline)."""
    page = np.full((h, w), 0.5, np.float32)
    y = int(rng.integers(40, 80))
    while y < h - 60:
        line_h = int(rng.integers(14, 30))
        x = int(rng.integers(30, 80))
        right = w - int(rng.integers(30, 120))
        while x < right - 40:
            word_w = int(rng.integers(20, 120))
            for sx in range(x, min(x + word_w, right), int(rng.integers(3, 7))):
                top = y + int(rng.integers(0, line_h // 2))
                page[top : y + line_h, sx : sx + 2] = -0.5
            page[y + line_h - 2 : y + line_h, x : x + word_w] = -0.5
            x += word_w + int(rng.integers(8, 20))
        y += line_h + int(rng.integers(8, 30))
        if rng.random() < 0.15:
            y += int(rng.integers(30, 90))  # paragraph break
    page += rng.normal(0, 0.03, page.shape).astype(np.float32)
    return np.clip(page, -0.5, 0.5)[..., None]


def synthetic_crop(rng: np.random.Generator, w: int) -> np.ndarray:
    crop = synthetic_page(rng, 64, w + 160)[:, 80 : 80 + w]
    crop[:, :, 0] = np.roll(crop[:, :, 0], -int(rng.integers(0, 20)), axis=0)
    return np.ascontiguousarray(crop)


def check_stage1(dev, gen) -> dict:
    from ocrs_models_torch.ops import stage1_fwd as stage1
    from ocrs_models_torch.ops import stage1_reference

    weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
    err = 0.0
    for w in (256, 800):
        x = (torch.rand((REC_BATCH, 1, 64, w), generator=gen) - 0.5).to(dev)
        with _no_tf32():
            want = stage1_reference(x, weight, bias)
        got = stage1(x, weight, bias)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        print(f"stage1 [128,1,64,{w}]: max_abs_err {e:.3e}", flush=True)
        if not (got.shape == want.shape and e <= 1e-5):
            raise AssertionError(f"stage1 disagrees with its plain version at W={w}: {e}")
        err = max(err, e)
    # Times at the widest bucket, the main path's largest stage-1 launch.
    with _no_tf32(), torch.inference_mode():
        ms = _cuda_time_ms(lambda: stage1(x, weight, bias), iters=50)
        plain_ms = _cuda_time_ms(lambda: stage1_reference(x, weight, bias), iters=50)
        library_ms = _cuda_time_ms(
            lambda: F.max_pool2d(F.relu(F.conv2d(x, weight, bias, padding=1)), 2), iters=50
        )
    launches, times, _ = _device_profile(lambda: stage1(x, weight, bias))
    device_ms = _device_ms(times, "stage1_fwd_kernel")
    n, _, h, w = x.shape
    n_bytes = x.numel() * 4 + 32 * 10 * 4 + n * 32 * (h // 2) * (w // 2) * 4
    n_flops = n * 32 * h * w * 19  # 9 FMAs + bias per conv output
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    _stage1_line("stage1_fwd", f"[{n},1,{h},{w}]", ms, device_ms, bound_ms, launches, 1)
    return {
        "name": "stage1_fwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/stage1_fwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/stage1_kernel.py:201",
        "shape": f"x [{n},1,{h},{w}] f32 -> [{n},32,{h // 2},{w // 2}]",
        "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "device_launches_per_call": launches,
    }


def _stage1_line(name: str, shape: str, ms: float, device_ms: float | None, bound_ms: float,
                 launches: float, want_launches: int, extra: str = "") -> None:
    """Print a stage-1 kernel's times, their shares of its bound and its
    device launches per call; fail unless the wrapper put exactly
    ``want_launches`` kernels on the device (no weight cast or copy)."""
    dev = "not measured" if device_ms is None else \
        f"{device_ms:.4f} ms ({100 * bound_ms / device_ms:.0f}%)"
    print(f"{name} {shape}: {ms:.4f} ms ({100 * bound_ms / ms:.0f}% of its bound "
          f"{bound_ms:.4f}), on the device {dev}{extra}, {launches:g} device launches per call",
          flush=True)
    if launches != want_launches:
        raise AssertionError(f"{name}: {launches:g} device launches per call, not {want_launches}")


def _gru_weights(gen, dev, hid=256):
    k = 1.0 / hid**0.5
    w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    return w_hh, b_hh


def _cudnn_gru(dev, gen, t_len, n, hid, dtype, backward: bool):
    """cuDNN's bidirectional GRU layer (F=128, so it also computes its input
    projection) in ``dtype``, forward or backward alone, as a callable."""
    lib_gru = torch.nn.GRU(128, hid, bidirectional=True).to(dev, dtype)
    xs = torch.randn((t_len, n, 128), generator=gen).to(dev, dtype)
    if not backward:
        return lambda: lib_gru(xs)
    xs.requires_grad_(True)
    ys, _ = lib_gru(xs)
    dys = torch.randn(ys.shape, generator=gen).to(dev, dtype)
    ins = [xs, *lib_gru.parameters()]
    return lambda: torch.autograd.grad(ys, ins, dys, retain_graph=True)


def check_gru(dev, gen) -> dict:
    """biGRU forward kernel vs the plain recurrence at the serving path's
    largest shape (T=201, N=128) and the training headline's (T=65,
    N=256), H=256: atol 1e-4 (error accumulates over up to 201 steps)."""
    from ocrs_models_torch.ops import gru_fwd as gru_recurrence
    from ocrs_models_torch.ops import gru_recurrence_reference

    hid = 256
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    out = {}
    # T = 800 // 4 + 1 at the widest serving bucket, 256 // 4 + 1 in training.
    for t_len, n in ((201, REC_BATCH), (65, 256)):
        px_f = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
        px_b = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
        with torch.inference_mode():
            want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
            got = gru_recurrence(px_f, px_b, w_hh, b_hh)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            print(f"gru [T={t_len},N={n},H={hid}]: max_abs_err {err:.3e}", flush=True)
            if not err <= 1e-4:
                raise AssertionError(f"gru_fwd disagrees with its plain version at T={t_len}: {err}")
            ms = _cuda_time_ms(lambda: gru_recurrence(px_f, px_b, w_hh, b_hh), iters=10)
            plain_ms = _cuda_time_ms(
                lambda: gru_recurrence_reference(px_f, px_b, w_hh, b_hh), iters=3, warmup=1
            )
            launches = _device_profile(lambda: gru_recurrence(px_f, px_b, w_hh, b_hh))[0]
            with _no_tf32():
                library_ms = _cuda_time_ms(
                    _cudnn_gru(dev, gen, t_len, n, hid, torch.float32, False), iters=10)
        n_bytes = 4 * (2 * t_len * n * 3 * hid + 2 * hid * 3 * hid + 2 * 3 * hid
                       + 2 * t_len * n * hid)
        n_flops = 2 * t_len * 2 * n * hid * 3 * hid
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        print(f"gru_fwd [T={t_len},N={n}]: {ms:.4f} ms, {1e3 * ms / t_len:.3f} us per step, "
              f"{launches:g} device launches per call", flush=True)
        out[t_len] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, us_per_step=1e3 * ms / t_len,
                          device_launches_per_call=launches,
                          shape=f"px [{t_len},{n},{3 * hid}] x2, w_hh [2,{hid},{3 * hid}] f32")
    wide, head = out[201], out[65]
    return {
        "name": "gru_fwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/gru_fwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:139",
        "shape": wide["shape"], "max_abs_err": max(wide["err"], head["err"]),
        "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        "us_per_step": wide["us_per_step"],
        "device_launches_per_call": wide["device_launches_per_call"],
        "headline": {k: head[k] for k in _HEADLINE_KEYS},
    }


def _headline(row: dict) -> dict:
    """A bf16 row's second shape, without the fields that name the kernel."""
    return {k: v for k, v in row.items() if k not in ("name", "dtype", "route", "source",
                                                      "replaces")}


def check_stage1_bf16(dev, gen) -> dict:
    """bf16 stage-1 forward kernel vs its bf16 plain version at the serving
    chunks [128, 1, 64, 256] and [128, 1, 64, 800]: at least 99% of the
    outputs equal and the rest within one bf16 ulp (both sum exact bf16
    products in f32, in another order, and round once), or within 1e-5,
    the float32 check's bound: where the ten terms nearly cancel, sums in
    another order differ by a few f32 ulps of the terms, which can be more
    than a bf16 ulp of the small result. Timed at W=800, the main path's
    largest stage-1 launch."""
    from ocrs_models_torch.ops import stage1_fwd, stage1_reference

    weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
    err, share, ulps, beyond = 0.0, 1.0, 0.0, 0.0
    for w in (256, 800):
        x = (torch.rand((REC_BATCH, 1, 64, w), generator=gen) - 0.5).to(dev).to(BF16)
        with _no_tf32():
            want = stage1_reference(x, weight, bias)
        got = stage1_fwd(x, weight, bias)
        torch.cuda.synchronize()
        e, sh = (got.float() - want.float()).abs().max().item(), _equal_share(got, want)
        u, b = _bf16_ulps(got, want)
        print(f"stage1_fwd bf16 [128,1,64,{w}]: max_abs_err {e:.3e}, equal {sh:.6f}, "
              f"max {u:g} ulp, beyond one ulp at most {b:.3e} apart", flush=True)
        if not (got.dtype == BF16 and sh >= 0.99 and b <= 1e-5):
            raise AssertionError(f"bf16 stage1_fwd disagrees with its plain version at W={w}")
        err, share, ulps, beyond = max(err, e), min(share, sh), max(ulps, u), max(beyond, b)
    wb, bb = weight.to(BF16), bias.to(BF16)
    with _no_tf32(), torch.inference_mode():
        ms = _cuda_time_ms(lambda: stage1_fwd(x, weight, bias), iters=50)
        plain_ms = _cuda_time_ms(lambda: stage1_reference(x, weight, bias), iters=50)
        library_ms = _cuda_time_ms(
            lambda: F.max_pool2d(F.relu(F.conv2d(x, wb, bb, padding=1)), 2), iters=50)
    launches, times, _ = _device_profile(lambda: stage1_fwd(x, weight, bias))
    device_ms = _device_ms(times, "stage1_fwd_kernel")
    n, _, h, w = x.shape
    bound_ms, bound_by = _bound(2 * x.numel() + 4 * 32 * 10 + 2 * n * 32 * (h // 2) * (w // 2),
                                n * 32 * h * w * 19, BF16_FLOPS_PER_S)
    _stage1_line("stage1_fwd bf16", f"[{n},1,{h},{w}]", ms, device_ms, bound_ms, launches, 1)
    return {
        "name": "stage1_fwd", "dtype": "bf16", "route": "cuda",
        "source": "ocrs_models_torch/csrc/stage1_fwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/stage1_kernel.py:201",
        "shape": f"x [{n},1,{h},{w}] bf16 -> [{n},32,{h // 2},{w // 2}] bf16",
        "max_abs_err": err, "equal_share": share, "max_ulps": ulps,
        "max_abs_err_beyond_one_ulp": beyond, "ms": ms,
        "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "device_launches_per_call": launches,
    }


def check_gru_bf16(dev, gen) -> dict:
    """bf16 biGRU forward kernel vs its bf16 plain version at the shapes of
    the f32 check (the serving chunk's T=201, N=128 and the training
    headline's T=65, N=256; H=256): ys within 2e-2 (a bf16 rounding of h
    that flips feeds the following steps) and at least 95% of it equal (a
    kernel that exchanges the unrounded state reads 88%:
    tests/test_torch_cuda.py)."""
    from ocrs_models_torch.ops import gru_fwd, gru_recurrence_reference
    from ocrs_models_torch.ops.gru import max_active_clusters

    hid = 256
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    rows = []
    for t_len, n in ((201, REC_BATCH), (65, 256)):
        clusters = max_active_clusters(n, hid, dtype=BF16)["gru_fwd"]
        px_f, px_b = (torch.randn((t_len, n, 3 * hid), generator=gen).to(dev).to(BF16)
                      for _ in range(2))
        with torch.inference_mode():
            want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
            got = gru_fwd(px_f, px_b, w_hh, b_hh)
            torch.cuda.synchronize()
            err, share = _err(got, want), _equal_share(got, want)
            print(f"gru_fwd bf16 [T={t_len},N={n},H={hid}]: max_abs_err {err:.3e}, "
                  f"equal {share:.6f}", flush=True)
            if not (got[0].dtype == BF16 and err <= 2e-2 and share >= 0.95):
                raise AssertionError(f"bf16 gru_fwd disagrees with its plain version at "
                                     f"T={t_len}: {err}, {share}")
            ms = _cuda_time_ms(lambda: gru_fwd(px_f, px_b, w_hh, b_hh), iters=10)
            plain_ms = _cuda_time_ms(
                lambda: gru_recurrence_reference(px_f, px_b, w_hh, b_hh), iters=3, warmup=1)
            launches, times, _ = _device_profile(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))
            with _no_tf32():
                library_ms = _cuda_time_ms(_cudnn_gru(dev, gen, t_len, n, hid, BF16, False),
                                           iters=10)
        n_bytes = 2 * (2 * t_len * n * 3 * hid + 2 * t_len * n * hid) + 4 * (2 * hid * 3 * hid
                                                                             + 2 * 3 * hid)
        bound_ms, bound_by = _bound(n_bytes, 2 * t_len * 2 * n * hid * 3 * hid, BF16_FLOPS_PER_S)
        device_ms = _device_ms(times, "gru_fwd")
        print(f"gru_fwd bf16 [T={t_len},N={n}]: {ms:.4f} ms, device {_fmt(device_ms)} ms, "
              f"{1e3 * ms / t_len:.3f} us per step, {launches:g} device launches per call, "
              f"{clusters['rows_per_block']} rows per block, clusters {clusters['launched']} "
              f"launched / {clusters['max_active']} max active", flush=True)
        rows.append({
            "name": "gru_fwd", "dtype": "bf16", "route": "cuda",
            "source": "ocrs_models_torch/csrc/gru_fwd.cu",
            "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:139",
            "shape": f"px [{t_len},{n},{3 * hid}] x2 bf16, w_hh [2,{hid},{3 * hid}] f32",
            "max_abs_err": err, "equal_share": share, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "us_per_step": 1e3 * ms / t_len, "device_launches_per_call": launches,
            "rows_per_block": clusters["rows_per_block"], "clusters": clusters["launched"],
            "max_active_clusters": clusters["max_active"],
        })
    wide, head = rows
    return {**wide, "max_abs_err": max(wide["max_abs_err"], head["max_abs_err"]),
            "equal_share": min(wide["equal_share"], head["equal_share"]),
            "headline": _headline(head)}


def check_recognition(pipe, gen) -> float:
    """Full recognition forward with the kernels vs the same model with the
    kernels' plain versions swapped in, on the card: log-probs within 1e-4
    in float32, 5e-2 in bf16 (where a bf16 rounding that flips in stage 1 or
    the biGRU moves the convolutions' inputs by one bf16 ulp)."""
    from ocrs_models_torch.ops import gru_recurrence_reference, stage1_reference

    model = pipe.rec_model
    x = (torch.rand((REC_BATCH, 1, 64, 800), generator=gen) - 0.5).to(pipe.device)
    with pipe._numerics():
        got = model(x)
        with mock.patch("ocrs_models_torch.models.recognition.stage1", stage1_reference), \
                mock.patch("ocrs_models_torch.ops.gru.gru_recurrence", gru_recurrence_reference):
            want = model(x)
    torch.cuda.synchronize()
    if got.shape != (REC_BATCH, 201, 97) or not torch.isfinite(got).all():
        raise AssertionError(f"recognition output shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs().max().item()
    dtype = "bf16" if model.dtype == BF16 else "f32"
    tol = 5e-2 if model.dtype == BF16 else 1e-4
    print(f"recognition forward {dtype} [128,1,64,800] vs plain ops: max_abs_err {err:.3e}",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{dtype} recognition log-probs disagree with plain ops: {err}")
    return err


def _err(got, want) -> float:
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def check_stage1_bwd(dev, gen) -> dict:
    """Stage-1 backward kernel vs autograd of the plain forward. The sums
    run over ~1M pool windows per channel; where two pre-activations of a
    window are within the last bits of the two conv orders the maximum may
    differ, so the tolerance is 1e-2 of the largest |dW| (measured, see
    PERF.md)."""
    from ocrs_models_torch.ops import stage1_bwd, stage1_bwd_grid, stage1_bwd_reference

    weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
    out = {}
    for n, w in ((256, 256), (128, 1024)):
        x = (torch.rand((n, 1, 64, w), generator=gen) - 0.5).to(dev)
        dy = torch.randn((n, 32, 32, w // 2), generator=gen).to(dev)
        with _no_tf32():
            want = stage1_bwd_reference(x, weight, bias, dy)
        got = stage1_bwd(x, weight, bias, dy)
        again = stage1_bwd(x, weight, bias, dy)
        torch.cuda.synchronize()
        err = _err(got, want)
        scale = max(t.abs().max().item() for t in want)
        print(f"stage1_bwd [{n},1,64,{w}]: max_abs_err {err:.3e} (max |dW| {scale:.3e})", flush=True)
        if not err <= 1e-2 * scale:
            raise AssertionError(f"stage1_bwd disagrees with its plain version at W={w}: {err}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("stage1_bwd is not deterministic")
        with _no_tf32():
            ms = _cuda_time_ms(lambda: stage1_bwd(x, weight, bias, dy), iters=20)
            plain_ms = _cuda_time_ms(lambda: stage1_bwd_reference(x, weight, bias, dy), iters=5)
            wr = weight.clone().requires_grad_(True)
            br = bias.clone().requires_grad_(True)
            y = F.max_pool2d(F.relu(F.conv2d(x, wr, br, padding=1)), 2)
            library_ms = _cuda_time_ms(
                lambda: torch.autograd.grad(y, (wr, br), dy, retain_graph=True), iters=5)
            del y
        launches, times, _ = _device_profile(lambda: stage1_bwd(x, weight, bias, dy))
        first, second = _device_ms(times, "stage1_bwd_partial"), _device_ms(times, "stage1_bwd_finish")
        grid = stage1_bwd_grid(dev, n, 64, w)
        n_bytes = 4 * (x.numel() + dy.numel() + 2 * 32 * 10)
        n_flops = 2 * n * 32 * 32 * (w // 2) * (4 * 9 + 10)
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        _stage1_line("stage1_bwd", f"[{n},1,64,{w}]", ms, _ms_sum(first, second), bound_ms,
                     launches, 2, f" ({_fmt(second)} ms the second pass), grid {grid} x 256 "
                     "threads")
        out[w] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by, device_ms=_ms_sum(first, second),
                      second_pass_ms=second, device_launches_per_call=launches, grid=grid,
                      shape=f"x [{n},1,64,{w}], dy [{n},32,32,{w // 2}]")
    wide, head = out[1024], out[256]
    return {
        "name": "stage1_bwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/stage1_bwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/stage1_kernel.py:223",
        "shape": wide["shape"], "max_abs_err": max(wide["err"], head["err"]),
        "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        **{k: wide[k] for k in _STAGE1_BWD_EXTRA},
        "headline": {k: head[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                          *_STAGE1_BWD_EXTRA)},
    }


def check_gru_bwd(dev, gen) -> dict:
    """biGRU backward kernel vs autograd of the plain recurrence: dpx atol
    1e-3 (errors carried back over up to 257 steps), dW_hh and db_hh
    within 1e-4 of their largest entry (sums over T*N rows)."""
    from ocrs_models_torch.ops import gru_bwd, gru_bwd_reference, gru_fwd

    hid = 256
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    out = {}
    for t_len, n in ((65, 256), (257, 128)):
        px_f = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
        px_b = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
        dy_f = (torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev)
        dy_b = (torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev)
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        args = (px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
        want = gru_bwd_reference(*args)
        got = gru_bwd(*args)
        torch.cuda.synchronize()
        err_dpx = _err(got[:2], want[:2])
        err_dw = _err(got[2:], want[2:])
        scale = max(t.abs().max().item() for t in want[2:])
        print(f"gru_bwd [T={t_len},N={n},H={hid}]: dpx max_abs_err {err_dpx:.3e}, "
              f"dW/db max_abs_err {err_dw:.3e} (max {scale:.3e})", flush=True)
        if not (err_dpx <= 1e-3 and err_dw <= 1e-4 * scale):
            raise AssertionError(f"gru_bwd disagrees with its plain version at T={t_len}")
        again = gru_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("gru_bwd is not deterministic")
        ms = _cuda_time_ms(lambda: gru_bwd(*args), iters=5)
        plain_ms = _cuda_time_ms(lambda: gru_bwd_reference(*args), iters=2, warmup=1)
        launches = _device_profile(lambda: gru_bwd(*args))[0]
        print(f"gru_bwd [T={t_len},N={n}]: {ms:.4f} ms, {1e3 * ms / t_len:.3f} us per step, "
              f"{launches:g} device launches per call", flush=True)
        with _no_tf32():
            library_ms = _cuda_time_ms(
                _cudnn_gru(dev, gen, t_len, n, hid, torch.float32, True), iters=5)
        h3 = 3 * hid
        n_bytes = 4 * (2 * t_len * n * h3 * 2 + 2 * t_len * n * hid * 2
                       + 2 * 2 * hid * h3 + 2 * 2 * h3)
        n_flops = 2 * 3 * 2 * t_len * n * hid * h3
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        out[t_len] = dict(err=max(err_dpx, err_dw), ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                          us_per_step=1e3 * ms / t_len, device_launches_per_call=launches,
                          shape=f"px [{t_len},{n},{h3}] x2, dy [{t_len},{n},{hid}] x2")
    wide, head = out[257], out[65]
    return {
        "name": "gru_bwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/gru_bwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:171",
        "shape": wide["shape"], "max_abs_err": max(wide["err"], head["err"]),
        "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        "us_per_step": wide["us_per_step"],
        "device_launches_per_call": wide["device_launches_per_call"],
        "headline": {k: head[k] for k in _HEADLINE_KEYS},
    }


def check_stage1_bwd_bf16(dev, gen) -> dict:
    """bf16 stage-1 backward kernel vs its bf16 plain version at the f32
    check's shapes, the training headline x [256,1,64,256] and the wide
    step's x [128,1,64,1024]: dW, db within 1e-3 of the largest |dW| (the
    GPU tests' bound: both sum exact products in f32, in another order)."""
    from ocrs_models_torch.ops import stage1_bwd, stage1_bwd_grid, stage1_bwd_reference

    weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
    rows = []
    for n, w in ((128, 1024), (256, 256)):
        x = (torch.rand((n, 1, 64, w), generator=gen) - 0.5).to(dev).to(BF16)
        dy = torch.randn((n, 32, 32, w // 2), generator=gen).to(dev).to(BF16)
        with _no_tf32():
            want = stage1_bwd_reference(x, weight, bias, dy)
        got = stage1_bwd(x, weight, bias, dy)
        again = stage1_bwd(x, weight, bias, dy)
        torch.cuda.synchronize()
        err, share = _err(got, want), _equal_share(got, want)
        scale = max(t.abs().max().item() for t in want)
        print(f"stage1_bwd bf16 [{n},1,64,{w}]: max_abs_err {err:.3e} (max |dW| {scale:.3e}), "
              f"equal {share:.4f}", flush=True)
        if not (err <= 1e-3 * scale and all(t.dtype == torch.float32 for t in got)):
            raise AssertionError(f"bf16 stage1_bwd disagrees with its plain version at W={w}: "
                                 f"{err}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("bf16 stage1_bwd is not deterministic")
        with _no_tf32():
            ms = _cuda_time_ms(lambda: stage1_bwd(x, weight, bias, dy), iters=20)
            plain_ms = _cuda_time_ms(lambda: stage1_bwd_reference(x, weight, bias, dy), iters=5)
            wr = weight.to(BF16).requires_grad_(True)
            br = bias.to(BF16).requires_grad_(True)
            y = F.max_pool2d(F.relu(F.conv2d(x, wr, br, padding=1)), 2)
            library_ms = _cuda_time_ms(
                lambda: torch.autograd.grad(y, (wr, br), dy, retain_graph=True), iters=5)
            del y
        launches, times, _ = _device_profile(lambda: stage1_bwd(x, weight, bias, dy))
        first = _device_ms(times, "stage1_bwd_partial")
        second = _device_ms(times, "stage1_bwd_finish")
        n_bytes = 2 * (x.numel() + dy.numel()) + 4 * 2 * 32 * 10
        bound_ms, bound_by = _bound(n_bytes, 2 * n * 32 * 32 * (w // 2) * (4 * 9 + 10),
                                    BF16_FLOPS_PER_S)
        grid = stage1_bwd_grid(dev, n, 64, w, BF16)
        _stage1_line("stage1_bwd bf16", f"[{n},1,64,{w}]", ms, _ms_sum(first, second), bound_ms,
                     launches, 2, f" ({_fmt(second)} ms the second pass), grid {grid} x 256 "
                     "threads")
        rows.append({
            "name": "stage1_bwd", "dtype": "bf16", "route": "cuda",
            "source": "ocrs_models_torch/csrc/stage1_bwd.cu",
            "replaces": "ocrs_models_tpu/ops/pallas/stage1_kernel.py:223",
            "shape": f"x [{n},1,64,{w}], dy [{n},32,32,{w // 2}] bf16",
            "max_abs_err": err, "equal_share": share, "ms": ms,
            "device_ms": _ms_sum(first, second),
            "second_pass_ms": second, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_launches_per_call": launches, "grid": grid,
        })
    wide, head = rows
    return {**wide, "max_abs_err": max(wide["max_abs_err"], head["max_abs_err"]),
            "equal_share": min(wide["equal_share"], head["equal_share"]),
            "headline": _headline(head)}


def check_gru_bwd_bf16(dev, gen) -> dict:
    """bf16 biGRU backward kernel vs its bf16 plain version (the phases with
    the Pallas kernel's rounding points) at the f32 check's shapes, the wide
    step's T=257, N=128 and the headline's T=65, N=256; H=256: dpx within
    2e-2 and at least 95% of it equal, dW and db within 1e-3 of their
    largest entry (the bounds tests/test_torch_cuda.py gives its reasons
    for)."""
    from ocrs_models_torch.ops import gru_bwd, gru_bwd_reference, gru_fwd
    from ocrs_models_torch.ops.gru import max_active_clusters

    hid = 256
    h3 = 3 * hid
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    rows = []
    for t_len, n in ((257, 128), (65, 256)):
        clusters = max_active_clusters(n, hid, dtype=BF16)["gru_bwd"]
        px_f, px_b = (torch.randn((t_len, n, h3), generator=gen).to(dev).to(BF16)
                      for _ in range(2))
        dy_f, dy_b = ((torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev).to(BF16)
                      for _ in range(2))
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        args = (px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
        want = gru_bwd_reference(*args)
        got = gru_bwd(*args)
        again = gru_bwd(*args)
        torch.cuda.synchronize()
        err_dpx, err_dw = _err(got[:2], want[:2]), _err(got[2:], want[2:])
        scale = max(t.abs().max().item() for t in want[2:])
        share = _equal_share(got[:2], want[:2])
        print(f"gru_bwd bf16 [T={t_len},N={n},H={hid}]: dpx max_abs_err {err_dpx:.3e} (equal "
              f"{share:.4f}), dW/db max_abs_err {err_dw:.3e} (max {scale:.3e})", flush=True)
        if not (got[0].dtype == BF16 and err_dpx <= 2e-2 and share >= 0.95
                and err_dw <= 1e-3 * scale):
            raise AssertionError(f"bf16 gru_bwd disagrees with its plain version at T={t_len}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("bf16 gru_bwd is not deterministic")
        ms = _cuda_time_ms(lambda: gru_bwd(*args), iters=5)
        plain_ms = _cuda_time_ms(lambda: gru_bwd_reference(*args), iters=2, warmup=1)
        launches, times, _ = _device_profile(lambda: gru_bwd(*args))
        with _no_tf32():
            library_ms = _cuda_time_ms(_cudnn_gru(dev, gen, t_len, n, hid, BF16, True), iters=5)
        n_bytes = 2 * (2 * t_len * n * h3 * 2 + 2 * t_len * n * hid * 2) + 4 * (2 * 2 * hid * h3
                                                                                + 2 * 2 * h3)
        bound_ms, bound_by = _bound(n_bytes, 2 * 3 * 2 * t_len * n * hid * h3, BF16_FLOPS_PER_S)
        phase_ms = {k: _device_ms(times, f"gru_bwd_{k}")
                    for k in ("coef", "chain", "dw_bf16", "dw_sum")}
        device_ms = _ms_sum(*phase_ms.values())
        print(f"gru_bwd bf16 [T={t_len},N={n}]: {ms:.4f} ms, device {_fmt(device_ms)} ms ("
              + ", ".join(f"{k} {_fmt(v)}" for k, v in phase_ms.items())
              + f"), {1e3 * ms / t_len:.3f} us per step, {launches:g} device launches per call, "
              f"{clusters['rows_per_block']} rows per block, clusters {clusters['launched']} "
              f"launched / {clusters['max_active']} max active", flush=True)
        rows.append({
            "name": "gru_bwd", "dtype": "bf16", "route": "cuda",
            "source": "ocrs_models_torch/csrc/gru_bwd.cu",
            "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:171",
            "shape": f"px [{t_len},{n},{h3}] x2, dy [{t_len},{n},{hid}] x2 bf16",
            "max_abs_err": max(err_dpx, err_dw), "max_abs_err_dpx": err_dpx,
            "max_abs_err_dw": err_dw, "equal_share": share, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "us_per_step": 1e3 * ms / t_len,
            "device_launches_per_call": launches, "phase_ms": phase_ms,
            "rows_per_block": clusters["rows_per_block"], "clusters": clusters["launched"],
            "max_active_clusters": clusters["max_active"],
        })
    wide, head = rows
    return {**wide, "max_abs_err": max(wide["max_abs_err"], head["max_abs_err"]),
            "equal_share": min(wide["equal_share"], head["equal_share"]),
            "headline": _headline(head)}


def _ctc_case(dev, gen, n, t_len, label_width, label_len, input_len, repeats=False) -> dict:
    """Random log-probs and labels of the given lengths, in label arrays
    ``label_width`` wide, and the operands the loss builds from them."""
    from ocrs_models_torch.ops import ctc_operands

    n_cls = 97
    rng = np.random.default_rng(SEED)
    labels = np.zeros((n, label_width), np.int64)
    for i, ll in enumerate(label_len):
        labels[i, :ll] = rng.integers(1, n_cls, ll)
    if repeats:
        labels[1, :6] = [5, 5, 5, 7, 7, 9]
    log_probs = torch.log_softmax(torch.randn((n, t_len, n_cls), generator=gen), -1).to(dev)
    labels_t = torch.from_numpy(labels).to(dev)
    label_len_t = torch.from_numpy(np.asarray(label_len, np.int64)).to(dev)
    input_len_t = torch.from_numpy(np.asarray(input_len, np.int64)).to(dev)
    emit, skip, alpha0, lens = ctc_operands(log_probs, labels_t, input_len_t, label_len_t)
    return dict(log_probs=log_probs, labels=labels_t, label_len=label_len_t,
                input_len=input_len_t, input_len_np=np.asarray(input_len),
                emit=emit, skip=skip, alpha0=alpha0, lens=lens)


def _check_ctc_case(case: dict, gen, what: str, zero_rows=()) -> dict:
    """Both CTC kernels against their plain versions on one case, then
    their times: alphas atol 1e-3 (log values down to ~-1e3), demit and
    dalpha0 atol 1e-5 (posteriors in [0, 1]). ``zero_rows`` carry no
    cotangent and must get no gradient."""
    from ocrs_models_torch.ops import (ctc_alpha, ctc_alpha_chain_probe, ctc_alpha_reference,
                                       ctc_beta, ctc_beta_chain_probe, ctc_beta_reference)
    from ocrs_models_torch.ops.ctc import NEG_INF

    emit, skip, alpha0, lens = (case[k] for k in ("emit", "skip", "alpha0", "lens"))
    n, t_len, s = emit.shape
    dev = emit.device
    want_a = ctc_alpha_reference(emit, skip, alpha0, lens)
    got_a = ctc_alpha(emit, skip, alpha0, lens)
    got_final = ctc_alpha(emit, skip, alpha0, lens, final_only=True)
    d_last = -torch.rand((n, s), generator=gen).to(dev)
    for row in zero_rows:
        d_last[row] = 0.0
    mag = d_last.abs()
    seed = torch.where(mag > 0, torch.log(mag) - got_a[:, -1], torch.full_like(mag, NEG_INF))
    sign = torch.where(d_last < 0, -1.0, 1.0).amin(dim=1).contiguous()
    want_b = ctc_beta_reference(emit, skip, got_a, seed, sign, lens)
    got_b = ctc_beta(emit, skip, got_a, seed, sign, lens)
    torch.cuda.synchronize()
    err_a = max((got_a - want_a).abs().max().item(),
                (got_final - want_a[:, -1]).abs().max().item())
    err_b = _err(got_b, want_b)
    print(f"ctc_alpha {what} [N={n},T={t_len},S={s}]: max_abs_err {err_a:.3e}; "
          f"ctc_beta: max_abs_err {err_b:.3e}", flush=True)
    if not (err_a <= 1e-3 and err_b <= 1e-5):
        raise AssertionError(f"CTC kernels disagree with their plain versions ({what}): {err_a}, {err_b}")
    if not all(torch.isfinite(t).all() for t in (*got_b, got_a)) or \
            any(got_b[0][row].abs().max() != 0 for row in zero_rows):
        raise AssertionError(f"ctc_beta ({what}): non-finite values, or a gradient on a zero row")

    def alpha():
        return ctc_alpha(emit, skip, alpha0, lens)

    def beta():
        return ctc_beta(emit, skip, got_a, seed, sign, lens)

    ms_a, ms_b = _cuda_time_ms(alpha, iters=20), _cuda_time_ms(beta, iters=20)
    plain_a = _cuda_time_ms(lambda: ctc_alpha_reference(emit, skip, alpha0, lens), iters=2, warmup=1)
    plain_b = _cuda_time_ms(
        lambda: ctc_beta_reference(emit, skip, got_a, seed, sign, lens), iters=2, warmup=1)
    launches_a, times_a, records_a = _device_profile(alpha)
    launches_b, times_b, records_b = _device_profile(beta)
    dev_a, dev_b = _device_ms(times_a, "ctc_alpha_kernel"), _device_ms(times_b, "ctc_beta_kernel")
    records = {name: sum(n for k, n in recs.items() if name in k)
               for name, recs in (("ctc_alpha", records_a), ("ctc_beta", records_b))}
    # Yardstick: torch's own CTC loss (cuDNN or native CUDA) on the same
    # log-probs, forward, then backward alone.
    lp = case["log_probs"].transpose(0, 1).detach().requires_grad_(True)
    ctc_args = (lp, case["labels"], case["input_len"], case["label_len"])
    lib_a = _cuda_time_ms(lambda: F.ctc_loss(*ctc_args, reduction="sum", zero_infinity=True), iters=20)
    loss = F.ctc_loss(*ctc_args, reduction="sum", zero_infinity=True)
    lib_b = _cuda_time_ms(lambda: torch.autograd.grad(loss, lp, retain_graph=True), iters=20)
    # The chains alone: each recursion's dependent steps of the longest
    # sample, timed by the kernel's own clocks on one block with no global
    # access in the loop. No recursion of that many steps can be faster,
    # whatever the bytes bound says.
    steps = int(np.clip(case["input_len_np"], 1, t_len).max()) - 1
    probes = {"ctc_alpha": ctc_alpha_chain_probe(steps + 1, s, dev),
              "ctc_beta": ctc_beta_chain_probe(steps + 1, s, dev)}
    active = int(np.minimum(case["input_len_np"], t_len).sum())
    state_bytes = 4 * n * t_len * s
    out = {}
    for name, ms, dev_ms, launches, plain_ms, lib_ms, n_bytes, n_flops, err in (
        ("ctc_alpha", ms_a, dev_a, launches_a, plain_a, lib_a,
         2 * state_bytes + 4 * (3 * n * s + n), 14 * (active - n) * s, err_a),
        ("ctc_beta", ms_b, dev_b, launches_b, plain_b, lib_b,
         3 * state_bytes + 4 * (4 * n * s + 2 * n), 20 * active * s, err_b),
    ):
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        out[name] = {
            "shape": f"emit [{n},{t_len},{s}] f32", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "us_per_step": None if dev_ms is None else 1e3 * dev_ms / max(steps, 1),
            "device_launches_per_call": launches,
        }
    for name, lib_what in (("ctc_alpha", "forward"), ("ctc_beta", "backward")):
        k = out[name]
        k.update(chain_ms=probes[name]["ns"] / 1e6,
                 chain_cycles_per_step=probes[name]["cycles"] / max(steps, 1))
        print(f"{name} {what}: {k['ms']:.4f} ms by events over wrapper calls, "
              f"{_fmt(k['device_ms'])} ms on the device ({records[name]:g} records of "
              f"{PROFILE_CALLS} calls), {_fmt(k['us_per_step'], 3)} us per step of {steps}; "
              f"the chain alone chain_ms {k['chain_ms']:.4f} "
              f"({k['chain_cycles_per_step']:.0f} cycles per step); "
              f"bound_ms {k['bound_ms']:.4f} ({k['bound_by']}); F.ctc_loss {lib_what} "
              f"{k['library_ms']:.4f} ms", flush=True)
    return out


def check_ctc(dev, gen) -> list[dict]:
    """CTC alpha and beta kernels vs their plain versions. The main case,
    T=257, N=128, S=129: ragged input and label lengths, repeated labels,
    one empty label, one row whose labels cannot fit. Then the training
    step's two shapes (``rec_batch``: every label and input the same
    length): ``headline`` N=256, T=65 with 24 labels and ``wide`` N=128,
    T=257 with 48, in label arrays as wide as the labels (S=49, S=97), and
    ``headline_padded``, ``wide_padded`` in arrays 64 wide as the training
    step hands them over (S=129)."""
    n, t_len = 128, 257
    rng = np.random.default_rng(SEED)
    label_len = rng.integers(6, 49, n)
    label_len[0] = 0  # empty label
    label_len[2] = 40  # with 20 input steps below: cannot fit
    input_len = rng.integers(160, t_len, n)
    input_len[2] = 20
    main = _check_ctc_case(
        _ctc_case(dev, gen, n, t_len, 64, label_len, input_len, repeats=True), gen, "ragged",
        zero_rows=(2,))  # the infeasible row carries no cotangent
    subs = {}
    for what, n, width, chars in (("headline", 256, 256, 24), ("wide", 128, 1024, 48)):
        for label_width, key in ((chars, what), (64, f"{what}_padded")):
            case = _ctc_case(dev, gen, n, width // 4 + 1, label_width, np.full(n, chars),
                             np.full(n, width // 4))
            subs[key] = _check_ctc_case(case, gen, key)
    rows = []
    for name, line in (("ctc_alpha", "119"), ("ctc_beta", "145")):
        rows.append({
            "name": name, "route": "cuda", "source": f"ocrs_models_torch/csrc/{name}.cu",
            "replaces": f"ocrs_models_tpu/ops/pallas/ctc_kernel.py:{line}",
            **main[name],
            "max_abs_err": max(main[name]["max_abs_err"], *(v[name]["max_abs_err"] for v in subs.values())),
            **{key: {k: v for k, v in sub[name].items() if k not in ("max_abs_err", "bound_by")}
               for key, sub in subs.items()},
        })
    return rows


def rec_batch(n: int, width: int, max_chars: int, dev, seed: int = 0) -> dict:
    """The JAX package's benchmark batch (``bench.py``: uniform images,
    ``max_chars`` labels in 1..96 padded to 64), NCHW, on the card."""
    rng = np.random.default_rng(seed)
    text = np.zeros((n, 64), np.int64)
    text[:, :max_chars] = rng.integers(1, 97, (n, max_chars))
    batch = {
        "image": rng.uniform(-0.5, 0.5, (n, 1, 64, width)).astype(np.float32),
        "text": text,
        "text_len": np.full((n,), max_chars, np.int64),
        "image_width": np.full((n,), width, np.int64),
        "sample_weight": np.ones((n,), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


TRAIN_LAUNCHES = {"stage1_fwd": 1, "stage1_bwd": 1, "gru_fwd": 2, "gru_bwd": 2,
                  "ctc_alpha": 1, "ctc_beta": 1}
EVAL_LAUNCHES = {"stage1_fwd": 1, "gru_fwd": 2, "ctc_alpha": 1}


def _counts() -> dict:
    from ocrs_models_torch.ops import KERNELS

    return {k.__name__: k.launches for k in KERNELS}


def _zero_counts() -> None:
    from ocrs_models_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0


def _expect(counts: dict, per_step: dict, steps: int, what: str) -> None:
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def check_train_step_vs_plain(dev, dtype=torch.float32) -> None:
    """One headline step with the kernels vs the same step with every
    kernel's plain version swapped in, from the same weights. Tolerances
    in float32 as the CPU parity test's first step: loss rtol 1e-5, grad
    norm rtol 1e-3, parameters within 1e-5 but for at most 1% of entries
    (max-pool near-ties route a few gradients elsewhere, and Adam's first
    step is +-lr per entry), all within 2 * lr. In bf16 (where a bf16
    rounding that flips moves a value by one bf16 ulp): the loss rtol 1e-2,
    each module's gradient norm rtol 5e-2."""
    import copy

    from ocrs_models_torch import ops
    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_recognition_steps

    torch.manual_seed(SEED)
    model = RecognitionModel(n_classes=97, dtype=dtype).to(dev)
    plain_model = copy.deepcopy(model)
    batch = rec_batch(256, 256, 24, dev)
    lr = 1e-3
    results = []
    for m, plain in ((model, False), (plain_model, True)):
        state = create_train_state(m, grad_clip_norm=4.0)
        train_step, _ = make_recognition_steps(m)
        patches = [
            mock.patch("ocrs_models_torch.ops.stage1.stage1_fwd", ops.stage1_reference),
            mock.patch("ocrs_models_torch.ops.stage1.stage1_bwd", ops.stage1_bwd_reference),
            mock.patch("ocrs_models_torch.ops.gru.gru_fwd", ops.gru_recurrence_reference),
            mock.patch("ocrs_models_torch.ops.gru.gru_bwd", ops.gru_bwd_reference),
            mock.patch("ocrs_models_torch.ops.ctc.ctc_alpha", ops.ctc_alpha_reference),
            mock.patch("ocrs_models_torch.ops.ctc.ctc_beta", ops.ctc_beta_reference),
        ] if plain else []
        _zero_counts()
        for p in patches:
            p.start()
        try:
            _, metrics = train_step(state, batch, lr)
            torch.cuda.synchronize()
        finally:
            for p in patches:
                p.stop()
        counts = _counts()
        _expect(counts, {} if plain else TRAIN_LAUNCHES, 1, f"train step (plain={plain})")
        results.append(metrics)
    got, want = results
    loss_rel = abs(got["loss"].item() / want["loss"].item() - 1)
    norm_rel = abs(got["grad_norm"].item() / want["grad_norm"].item() - 1)
    module_rel = {k: abs(v.item() / want["grad_norms"][k].item() - 1)
                  for k, v in got["grad_norms"].items()}
    diffs = [(a - b).abs() for a, b in zip(model.parameters(), plain_model.parameters())]
    n_far = sum(int((d > 1e-5).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    max_diff = max(d.max().item() for d in diffs)
    bf16 = dtype == BF16
    print(json.dumps({"path": f"train_step vs plain{' bf16' if bf16 else ''}",
                      "loss": got["loss"].item(), "loss_plain": want["loss"].item(),
                      "loss_rel": loss_rel, "grad_norm": got["grad_norm"].item(),
                      "grad_norm_rel": norm_rel, "module_grad_norm_rel_max": max(module_rel.values()),
                      "params_far_frac": n_far / n_all, "params_max_diff": max_diff}), flush=True)
    if bf16:
        ok = loss_rel <= 1e-2 and all(v <= 5e-2 for v in module_rel.values())
    else:
        ok = (loss_rel <= 1e-5 and norm_rel <= 1e-3 and n_far <= 0.01 * n_all
              and max_diff <= 2 * lr + 1e-6)
    if not ok:
        raise AssertionError(f"the {'bf16 ' if bf16 else ''}training step with kernels disagrees "
                             f"with the plain step: {module_rel}")


def run_training(dev, dtype=torch.float32, wide_steps: int = 10) -> dict:
    """Phase 8's main path in ``dtype``: headline and wide steps, and in
    float32 also grad_accum=4 and eval steps. Each step's time is also read
    on the device's timeline (CUDA events between step starts), for a
    median and a spread."""
    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_recognition_steps

    torch.manual_seed(SEED + 1)
    model = RecognitionModel(n_classes=97, dtype=dtype).to(dev)
    state = create_train_state(model, grad_clip_norm=4.0)
    tag = " bf16" if dtype == BF16 else ""
    train_step, eval_step = make_recognition_steps(model)
    lr = 1e-3
    report = {}

    def timed(batch, steps, what, step_fn=train_step, per_step=TRAIN_LAUNCHES):
        nonlocal state
        state, _ = step_fn(state, batch, lr)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        _zero_counts()
        losses = []
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        t0 = time.perf_counter()
        for i in range(steps):
            marks[i].record()
            state, metrics = step_fn(state, batch, lr)
            losses.append(metrics["loss"])
        marks[-1].record()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        counts = _counts()
        _expect(counts, per_step, steps, what)
        losses = [v.item() for v in losses]
        preds = metrics["preds"]
        n, _, _, w = batch["image"].shape
        if not all(np.isfinite(losses)) or preds.shape != (n, w // 4 + 1):
            raise AssertionError(f"{what}: losses {losses}, preds {tuple(preds.shape)}")
        line = {"path": what, "batch": n, "width": w, "steps": steps,
                "seconds": elapsed, "crops_per_s": n * steps / elapsed,
                "ms_per_step": 1e3 * elapsed / steps, "step_ms_median": float(np.median(step_ms)),
                "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
                "losses": losses, "launches": counts}
        print(json.dumps(line), flush=True)
        return line

    head = rec_batch(256, 256, 24, dev)
    line = timed(head, 10, f"train_step{tag} headline 256x64x256")
    if not line["losses"][-1] < line["losses"][0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {line['losses']}")
    report["headline"] = line
    report["wide"] = timed(rec_batch(128, 1024, 48, dev, seed=1), wide_steps,
                           f"train_step{tag} wide 128x64x1024")
    if dtype == BF16:
        return report
    ga4_step, _ = make_recognition_steps(model, grad_accum=4)
    report["ga4"] = timed(head, 1, "train_step headline grad_accum=4", ga4_step,
                          {k: 4 * v for k, v in TRAIN_LAUNCHES.items()})

    _zero_counts()
    metrics = eval_step(state, head)
    loss = metrics["loss"].item()
    counts = _counts()
    _expect(counts, EVAL_LAUNCHES, 1, "eval_step")
    if not np.isfinite(loss) or not model.training:
        raise AssertionError(f"eval_step: loss {loss}, train mode not restored")
    print(json.dumps({"path": "eval_step headline", "loss": loss, "launches": counts}), flush=True)
    return report


def _cli(module, argv: list[str]) -> tuple[list[str], object, dict, float]:
    """``module.main(argv)`` (a trainer or evaluation CLI) in the working
    directory with the launch counts zeroed just before; returns its
    printed lines, its result, the counts read just after, and its
    seconds."""
    import contextlib
    import io

    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    torch.cuda.synchronize()
    return out.getvalue().splitlines(), result, _counts(), time.perf_counter() - t0


def _epoch_records() -> list[dict]:
    lines = Path("text-recognition-metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "epoch" in r]


def _rates(lines: list[str]) -> list[float]:
    """Each epoch's ``Throughput N crops/sec/chip``."""
    return [float(ln.split()[1]) for ln in lines if ln.startswith("Throughput ")]


def run_trainer(step_rates: dict) -> dict[str, dict[str, int]]:
    """Phase 9: the trainer CLI ``training/train_rec.py`` on synthetic
    lines, in a temporary directory: (a) three epochs at the JAX defaults
    (bf16, as the JAX trainer's), (b) a resume for one more epoch, (c)
    ``--validate-only``, (d) two epochs at batch 128 in bf16 with and
    without augmentation and in float32 (``--no-bf16``) without, for the
    trainer's rate against the bare step's (``step_rates``, phase 8's wide
    step at batch 128 by dtype), then the host's share of it. Returns the
    launch counts per epoch of (a) (bf16) and of (d)'s float32 run."""
    import math
    import os
    import tempfile

    from ocrs_models_torch.training import train_rec

    train_size, val_size, batch = 512, 64, 20
    steps = math.ceil(train_size / batch)
    val_batches = math.ceil(val_size / batch)

    def expect(counts, epochs, what, train=True, steps=steps, val_batches=val_batches):
        want = {k: (TRAIN_LAUNCHES.get(k, 0) * steps if train else 0)
                + EVAL_LAUNCHES.get(k, 0) * val_batches for k in counts}
        want = {k: v * epochs for k, v in want.items()}
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}, expected {want}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as run_dir:
        os.chdir(run_dir)
        try:
            # (a) Three epochs: 512 augmented lines, 64 validation lines, batch 20.
            lines, _, counts, seconds = _cli(train_rec, ["synthetic", "-", "--max-epochs", "3"])
            expect(counts, 3, "train_rec 3 epochs")
            records = _epoch_records()
            losses = [r["train_loss"] for r in records]
            if [r["epoch"] for r in records] != [0, 1, 2] or not all(
                    np.isfinite([v for r in records for v in (r["train_loss"], r["val_loss"])])):
                raise AssertionError(f"train_rec: epoch records {records}")
            if not losses[2] < losses[0]:
                raise AssertionError(f"train_rec: the train loss did not fall: {losses}")
            if "Model param count 2426913" not in lines:
                raise AssertionError("train_rec: not the full-width CRNN")
            print(json.dumps({
                "path": "train_rec synthetic 3 epochs", "dtype": "bf16", "batch": batch,
                "augment": True,
                "seconds": seconds, "launches": counts, "crops_per_s": _rates(lines),
                "train_loss": losses, "val_loss": [r["val_loss"] for r in records],
                "train_cer": [r["train_accuracy"]["char_error_rate"] for r in records],
                "val_cer": [r["val_accuracy"]["char_error_rate"] for r in records]}), flush=True)
            launches = counts

            # (b) Resume for one epoch, the Adam state as (a) left it.
            ckpt = torch.load("text-rec-checkpoint.pt", map_location="cpu", weights_only=True)
            adam_steps = {float(v["step"]) for v in ckpt["optimizer_state"]["state"].values()}
            if (ckpt["epoch"], ckpt["step"], adam_steps) != (3, 3 * steps, {3.0 * steps}):
                raise AssertionError(f"checkpoint: epoch {ckpt['epoch']}, step {ckpt['step']}, "
                                     f"Adam steps {adam_steps}; expected 3, {3 * steps}")
            lines, _, counts, seconds = _cli(train_rec, [
                "synthetic", "-", "--checkpoint", "text-rec-checkpoint.pt", "--max-epochs", "4"])
            expect(counts, 1, "train_rec resumed")
            records = _epoch_records()
            ckpt = torch.load("text-rec-checkpoint.pt", map_location="cpu", weights_only=True)
            if [r["epoch"] for r in records] != [0, 1, 2, 3] or ckpt["step"] != 4 * steps:
                raise AssertionError(f"resume: epochs {[r['epoch'] for r in records]}, "
                                     f"step {ckpt['step']}")
            print(json.dumps({"path": "train_rec resumed, epoch 3", "seconds": seconds,
                              "launches": counts, "train_loss": records[3]["train_loss"],
                              "val_cer": records[3]["val_accuracy"]["char_error_rate"]}), flush=True)

            # (c) Validation alone from the checkpoint.
            lines, _, counts, _ = _cli(train_rec, [
                "synthetic", "-", "--checkpoint", "text-rec-checkpoint.pt", "--validate-only"])
            expect(counts, 1, "train_rec --validate-only", train=False)
            (line,) = [ln for ln in lines if ln.startswith("Validation loss")]
            if not np.isfinite(float(line.split()[2])):
                raise AssertionError(f"--validate-only: {line}")
            print(json.dumps({"path": "train_rec --validate-only", "line": line}), flush=True)
        finally:
            os.chdir(cwd)

    # (d) The trainer's rate, host pipeline included: epoch 1 of two, 2048
    # lines (16 steps of 128) and 204 validation lines (2 batches) an epoch.
    per_epoch = {"bf16": {k: v // 3 for k, v in launches.items()}}
    n_images, batch_size = 2048, 128
    for dtype, augment in (("bf16", False), ("f32", False), ("bf16", True)):
        with tempfile.TemporaryDirectory() as run_dir:
            os.chdir(run_dir)
            try:
                lines, _, counts, seconds = _cli(
                    train_rec, ["synthetic", "-", "--max-images", str(n_images), "--batch-size",
                     str(batch_size), "--max-epochs", "2", "--augment" if augment else "--no-augment",
                     "--bf16" if dtype == "bf16" else "--no-bf16"])
                records = _epoch_records()
            finally:
                os.chdir(cwd)
        expect(counts, 2, f"train_rec rate run ({dtype})", steps=16, val_batches=2)
        if dtype == "f32":
            per_epoch["f32"] = {k: v // 2 for k, v in counts.items()}
        rates = _rates(lines)
        if len(rates) != 2 or len(records) != 2:
            raise AssertionError(f"train_rec rate run: rates {rates}")
        step_rate = step_rates[dtype]
        line = {"path": "train_rec rate", "dtype": dtype, "images": n_images, "batch": batch_size,
                "augment": augment, "crops_per_s": rates[1],
                "epoch_seconds": records[1]["time"] - records[0]["time"],
                "train_cer": [r["train_accuracy"]["char_error_rate"] for r in records],
                "val_cer": [r["val_accuracy"]["char_error_rate"] for r in records],
                "step_crops_per_s": step_rate, "share_of_step_rate": rates[1] / step_rate,
                "seconds": seconds, "launches": counts}
        print(json.dumps(line), flush=True)
    _host_breakdown()
    return per_epoch


def _host_breakdown(n: int = 2048, batch: int = 128) -> None:
    """The trainer's host work at batch 128, on the host alone: the
    loader's rate over ``n`` lines, collated (two threads as the trainer
    runs it, and one), and one thread's ms per line drawn, per batch
    collated and per batch scored (CER of 128 lines at T = 129)."""
    import functools

    from ocrs_models_torch.config import DEFAULT_ALPHABET
    from ocrs_models_torch.data import DataLoader, SyntheticRecognition, collate_recognition
    from ocrs_models_torch.data.augment import RecognitionAugment
    from ocrs_models_torch.utils.metrics import RecognitionAccuracyStats

    collate = functools.partial(collate_recognition, width_step=256, max_width=800)
    out = {"path": "train_rec host", "batch": batch}
    drawn = {}
    for augment, threads in ((False, 2), (True, 2), (False, 1)):
        ds = SyntheticRecognition(size=n, seed=SEED, transform=RecognitionAugment(SEED) if augment else None)
        loader = DataLoader(ds, batch, collate, shuffle=True, seed=SEED, num_threads=threads)
        t0 = time.perf_counter()
        lines = sum(len(b["text_len"]) for b in loader)
        key = f"{'augment' if augment else 'plain'}_{threads}_threads"
        out[f"loader_lines_per_s_{key}"] = lines / (time.perf_counter() - t0)
        if threads == 2:
            t0 = time.perf_counter()
            drawn[augment] = [ds[i] for i in range(256)]
            out[f"ms_per_line_{'augment' if augment else 'plain'}"] = (time.perf_counter() - t0) / 256 * 1e3
    t0 = time.perf_counter()
    for i in range(2):
        b = collate(drawn[False][i * batch : (i + 1) * batch])
    out["collate_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
    preds = np.random.default_rng(SEED).integers(0, 97, (batch, 129)).astype(np.int32)
    stats = RecognitionAccuracyStats(DEFAULT_ALPHABET)
    t0 = time.perf_counter()
    for _ in range(2):
        stats.update(b["text"], b["text_len"], preds, np.full(batch, 128))
    out["cer_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
    print(json.dumps(out), flush=True)


def _run_batch(pipe, pages, path: str) -> tuple[list, dict, int, float]:
    """``run_batch`` on the pages, warm, with launch counts zeroed just
    before and read just after: each recognition chunk (a call of the
    recognizer, counted here) launches ``stage1_fwd`` once and ``gru_fwd``
    twice (the biGRU's two layers), and nothing else launches. Prints the
    pages/s and checks the result's form; returns the result, the counts,
    the chunks and the seconds."""
    from ocrs_models_torch.config import DEFAULT_ALPHABET

    dtype = "bf16" if pipe.rec_model.dtype == BF16 else "f32"
    chunks = 0
    forward = pipe.rec_model.forward

    def counted(x):
        nonlocal chunks
        chunks += 1
        return forward(x)

    with mock.patch.object(pipe.rec_model, "forward", counted):
        pipe.run_batch(pages, det_batch=DET_BATCH, rec_batch=REC_BATCH)  # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        chunks = 0
        t0 = time.perf_counter()
        results = pipe.run_batch(pages, det_batch=DET_BATCH, rec_batch=REC_BATCH)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    counts = _counts()
    n_lines = sum(len(p) for p in results)
    print(json.dumps({"path": path, "dtype": dtype, "pages": len(pages), "lines": n_lines,
                      "chunks": chunks, "seconds": elapsed, "pages_per_s": len(pages) / elapsed,
                      "launches": counts}), flush=True)
    if len(results) != len(pages) or any(not isinstance(ln.text, str) for p in results for ln in p):
        raise AssertionError(f"{path} returned a malformed result")
    if any(ch not in DEFAULT_ALPHABET for p in results for ln in p for ch in ln.text):
        raise AssertionError(f"{path} produced characters outside the alphabet")
    if any(not np.isfinite(ln.box).all() for p in results for ln in p):
        raise AssertionError(f"{path} produced non-finite line boxes")
    if not chunks > 0:
        raise AssertionError(f"{path} recognized nothing (lines found: {n_lines})")
    _expect(counts, {"stage1_fwd": 1, "gru_fwd": 2}, chunks, f"{path} {dtype}")
    return results, counts, chunks, elapsed


def _serve(pipe, pages, crops) -> dict:
    """Phases 5 and 6 for one pipeline: ``run_batch`` on the pages and
    ``_recognize_crops`` on 128 crops of each bucket, each warm, with launch
    counts zeroed just before and read just after. Serving launches only the
    forward kernels, once (stage 1) and twice (the biGRU's two layers) for
    each recognition chunk, counted as calls of the recognizer."""
    dtype = "bf16" if pipe.rec_model.dtype == BF16 else "f32"
    out = {}
    results, counts, _, _ = _run_batch(pipe, pages, "run_batch")
    out["serve_launches"], out["pages"] = counts, results
    pipe._recognize_crops(crops, REC_BATCH)  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    texts = pipe._recognize_crops(crops, REC_BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _counts()
    print(json.dumps({"path": "recognize_crops", "dtype": dtype, "crops": len(crops),
                      "buckets": list(BUCKET_WIDTHS), "seconds": elapsed,
                      "crops_per_s": len(crops) / elapsed, "launches": counts}), flush=True)
    if len(texts) != len(crops):
        raise AssertionError(f"recognize_crops: {len(texts)} texts for {len(crops)} crops")
    _expect(counts, {"stage1_fwd": 1, "gru_fwd": 2}, len(BUCKET_WIDTHS), "recognize_crops")
    out["texts"] = texts
    return out


def _agreement(pipe, pipe_bf16, served: dict, crops) -> None:
    """How far bf16 serving agrees with float32 on the same weights (the
    check ``tools/serve_bench.py`` makes for the JAX package): the share of
    identical texts over the served crops and the run_batch lines, and of
    identical per-step argmax on the widest bucket's chunk. Printed, not
    gated: the weights are random."""
    texts, texts_bf = served["f32"]["texts"], served["bf16"]["texts"]
    lines = [(a.text, b.text) for pa, pb in zip(served["f32"]["pages"], served["bf16"]["pages"])
             for a, b in zip(pa, pb)]
    x = torch.from_numpy(np.stack([c[:, :, 0] for c in crops[-REC_BATCH:]]))[:, None]
    with pipe._numerics():
        ids = pipe.rec_model(x.to(pipe.device)).argmax(dim=-1)
        ids_bf = pipe_bf16.rec_model(x.to(pipe.device)).argmax(dim=-1)
    print(json.dumps({
        "path": "serving bf16 vs f32", "crops": len(texts),
        "identical_text_share": float(np.mean([a == b for a, b in zip(texts, texts_bf)])),
        "run_batch_lines_compared": len(lines),
        "run_batch_identical_text_share": float(np.mean([a == b for a, b in lines])) if lines else None,
        "argmax_steps": ids.numel(),
        "identical_argmax_share": (ids == ids_bf).float().mean().item()}), flush=True)


# ------------------------------------------------------------- layout (10, 11)

LAYOUT_PAGES = 16  # phase 10: pages through one [16, 500, 4] forward
LAYOUT_WORDS = 500  # the pipeline's layout_pad_words and the trainer's n_words
LAYOUT_BATCH = 64  # the layout trainer's batch
LAYOUT_STEPS = 10  # timed steps a dtype
LAYOUT_CPU_BATCH = 8  # pages of the step held against the CPU
LAYOUT_TRAIN_IMAGES = 32  # phase 11's trainer: one step (32 pages) an epoch, 32 validation pages
LAYOUT_SHARE = 0.25  # phase 10: the share of words predicted line starts, and line ends
LAYOUT_PARAMS = 4739074


def _doc_quads(n_pages: int, seed: int) -> list[np.ndarray]:
    """Word quads (``[W, 4, 2]``) of ``SyntheticDocLayout`` pages, all of
    each page's words (hundreds; some pages more than the model's 500)."""
    from ocrs_models_torch.data.layout_synth import SyntheticDocLayout

    ds = SyntheticDocLayout(size=n_pages, n_words=4000, seed=seed, normalize_coords=False)
    out = []
    for i in range(n_pages):
        b = ds[i][0]
        b = b[b[:, 2] > b[:, 0]].astype(np.float64)
        out.append(np.stack([b[:, [0, 1]], b[:, [2, 1]], b[:, [2, 3]], b[:, [0, 3]]], axis=1))
    return out


def _layout_state_dict() -> dict:
    """The full-width ``LayoutModel(return_probs=True)``'s weights, drawn
    from ``SEED`` (PyTorch's initialisation)."""
    from ocrs_models_torch.models import LayoutModel

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return LayoutModel(return_probs=True).state_dict()


def _widest_gap(values: torch.Tensor, q: float) -> torch.Tensor:
    """The middle of the widest gap between neighbouring ``values`` within
    two percentiles of their ``q`` quantile: a threshold there leaves every
    value as far from it as the data allow."""
    v = torch.sort(values).values
    lo, hi = int(len(v) * (q - 0.02)), int(len(v) * (q + 0.02))
    i = lo + int(torch.argmax(v[lo + 1 : hi + 1] - v[lo:hi]))
    return (v[i] + v[i + 1]) / 2


def check_layout_serving(dev, pages) -> dict:
    """Phase 10: the layout model in serving, float32 with TF32 off. The
    pages' word quads go through ``_group_lines_layout_batch`` (one
    ``[16, 500, 4]`` forward) on the card and on the CPU: probabilities
    within 1e-4 and the line groupings equal; where a word's probability
    lies within 1e-4 of the 0.5 threshold, a last bit may flip its
    decision, so the groupings must then agree outside that band. Random
    weights predict nearly every word a line start and a line end, so
    that every line holds one word: ``classify``'s bias is shifted so that
    about a quarter of the words are predicted starts and a quarter ends,
    with the threshold in the widest gap between the words' logits there.
    Then
    ``run_batch`` with the layout model on phase 5's pages (every
    recognition chunk launches its kernels), and the forward's time."""
    from ocrs_models_torch.pipeline import OcrPipeline

    sd = _layout_state_dict()
    pipe = OcrPipeline(layout_state_dict=sd, use_layout_model=True, device=dev, seed=SEED)
    quads = _doc_quads(LAYOUT_PAGES, SEED)
    padded, info = pipe._layout_inputs(quads)
    x_cpu = torch.from_numpy(padded)
    x = x_cpu.to(dev)
    words = torch.zeros(padded.shape[:2], dtype=torch.bool)
    for p, (_, _, k) in enumerate(info):
        words[p, :k] = True
    pipe.layout_model.return_probs = False
    with pipe._numerics():
        logits = pipe.layout_model(x).cpu()[words]
    pipe.layout_model.return_probs = True
    shift = torch.stack([_widest_gap(logits[:, c], 1.0 - LAYOUT_SHARE) for c in range(2)])
    sd["classify.bias"] -= shift
    with torch.no_grad():
        pipe.layout_model.classify.bias.copy_(sd["classify.bias"])
    cpu = OcrPipeline(layout_state_dict=sd, use_layout_model=True, device="cpu", seed=SEED)
    with pipe._numerics():
        p_gpu = pipe.layout_model(x).cpu()
    with cpu._numerics():
        p_cpu = cpu.layout_model(x_cpu)
    err = (p_gpu - p_cpu).abs().max().item()
    near = ((p_cpu - 0.5).abs() <= 1e-4) & words[..., None]
    flips = ((p_gpu >= 0.5) != (p_cpu >= 0.5)) & words[..., None]
    lines_gpu = pipe._group_lines_layout_batch(quads)
    lines_cpu = cpu._group_lines_layout_batch(quads)
    same = [[m for _, m in p] for p in lines_gpu] == [[m for _, m in p] for p in lines_cpu]
    n_words = sum(len(q) for q in quads)
    print(json.dumps({
        "path": "layout grouping card vs CPU", "shape": list(padded.shape), "words": n_words,
        "overflow_words": n_words - int(words.sum()), "lines": sum(len(p) for p in lines_gpu),
        "max_abs_err": err, "start_share": (p_cpu[..., 0][words] >= 0.5).float().mean().item(),
        "end_share": (p_cpu[..., 1][words] >= 0.5).float().mean().item(),
        "threshold_margin": (p_cpu - 0.5).abs()[words[..., None].expand_as(p_cpu)].min().item(),
        "decisions_flipped": int(flips.sum()), "groupings_equal": same}), flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"layout probabilities disagree with the CPU: {err}")
    if (flips & ~near).any() or (not same and not near.any()):
        raise AssertionError("layout line groupings on the card differ from the CPU's")

    # The forward alone, as run_batch calls it.
    def forward():
        with pipe._numerics():
            pipe.layout_model(x)

    ms = _cuda_time_ms(forward, iters=20)
    launches, times, records = _device_profile(forward)
    device_ms = (sum(times[k] * records[k] for k in times) / PROFILE_CALLS) if times else None
    print(json.dumps({"path": "layout forward f32", "shape": list(padded.shape), "ms": ms,
                      "device_ms": device_ms, "device_launches_per_call": launches}), flush=True)

    results, counts, chunks, seconds = _run_batch(pipe, pages, "run_batch layout")
    with_layout = sum(len(p) for p in results)
    return {"forward_ms": ms, "forward_device_ms": device_ms, "pages_per_s": len(pages) / seconds,
            "launches": counts, "lines": with_layout}


def _layout_batch(n: int, seed: int, dev) -> dict:
    from ocrs_models_torch.data import SyntheticLayout, collate_layout
    from ocrs_models_torch.data.loader import to_device

    ds = SyntheticLayout(size=n, n_words=LAYOUT_WORDS, seed=seed)
    batch = collate_layout([ds[i] for i in range(n)])
    del batch["n_valid"]
    return to_device(batch, dev)


def _layout_model(dtype=torch.float32, dropout=True):
    from ocrs_models_torch.models import LayoutModel
    from ocrs_models_torch.models.layout import Dropout

    torch.manual_seed(SEED + 2)
    model = LayoutModel(dtype=dtype)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def check_layout_step(dev) -> None:
    """Phase 11 (a): one ``make_layout_steps`` step on the card against the
    same step on the CPU from the same weights, f32 with TF32 off and
    dropout at 0 (8 pages of 500 words): loss within 1e-5 relative, each
    module's gradient norm within 1e-4. Then ``grad_accum=4`` at batch 64
    against one step from the same weights: loss within 1e-5 relative."""
    import copy

    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_layout_steps

    model = _layout_model(dropout=False)
    batch = _layout_batch(LAYOUT_CPU_BATCH, SEED, torch.device("cpu"))
    out = []
    for device in (torch.device("cpu"), dev):
        m = copy.deepcopy(model).to(device)
        train, _ = make_layout_steps(m)
        out.append(train(create_train_state(m), batch, 3e-4)[1])
    cpu, card = out
    loss_rel = abs(card["loss"].item() / cpu["loss"].item() - 1)
    norm_rel = {k: abs(v.item() / cpu["grad_norms"][k].item() - 1)
                for k, v in card["grad_norms"].items()}
    norm_rel["all"] = abs(card["grad_norm"].item() / cpu["grad_norm"].item() - 1)

    batch = _layout_batch(LAYOUT_BATCH, SEED + 1, dev)
    losses = []
    for grad_accum in (1, 4):
        m = copy.deepcopy(model).to(dev)
        train, _ = make_layout_steps(m, grad_accum=grad_accum)
        losses.append(train(create_train_state(m), batch, 3e-4)[1]["loss"].item())
    ga_rel = abs(losses[1] / losses[0] - 1)
    print(json.dumps({"path": "layout step card vs CPU", "batch": LAYOUT_CPU_BATCH,
                      "loss": card["loss"].item(), "loss_cpu": cpu["loss"].item(),
                      "loss_rel": loss_rel, "grad_norm_rel_max": max(norm_rel.values()),
                      "grad_accum4_loss_rel": ga_rel}), flush=True)
    if not (loss_rel <= 1e-5 and all(v <= 1e-4 for v in norm_rel.values())):
        raise AssertionError(f"the layout step on the card disagrees with the CPU: {norm_rel}")
    if not ga_rel <= 1e-5:
        raise AssertionError(f"layout grad_accum=4 loss {losses[1]} vs one step {losses[0]}")


def run_layout_training(dev, dtype) -> dict:
    """Phase 11 (b): the layout step at batch 64 x 500 words as the trainer
    runs it (dropout on, lr 3e-4): one warm-up step, then timed steps on a
    fixed batch, whose loss must fall; each step on the device's timeline
    (CUDA events between step starts) and pages/s on the host clock. The
    layout step launches none of the port's kernels."""
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_layout_steps

    model = _layout_model(dtype).to(dev)
    state = create_train_state(model)
    train, _ = make_layout_steps(model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = _layout_batch(LAYOUT_BATCH, SEED + 1, dev)
    torch.cuda.reset_peak_memory_stats()
    state, _ = train(state, batch, 3e-4, gen)
    torch.cuda.synchronize()
    _zero_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(LAYOUT_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    for i in range(LAYOUT_STEPS):
        marks[i].record()
        state, metrics = train(state, batch, 3e-4, gen)
        losses.append(metrics["loss"])
    marks[-1].record()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [v.item() for v in losses]
    tag = "bf16" if dtype == BF16 else "f32"
    line = {"path": f"layout train_step {tag} {LAYOUT_BATCH}x{LAYOUT_WORDS}",
            "steps": LAYOUT_STEPS, "seconds": elapsed,
            "pages_per_s": LAYOUT_BATCH * LAYOUT_STEPS / elapsed,
            "ms_per_step": 1e3 * elapsed / LAYOUT_STEPS,
            "step_ms_median": float(np.median(step_ms)), "step_ms_min": min(step_ms),
            "step_ms_max": max(step_ms), "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "losses": losses, "launches": counts}
    print(json.dumps(line), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"layout {tag} step: the loss did not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"the layout step launched the port's kernels: {counts}")
    return line


def _png_size(path: str) -> tuple[int, int]:
    """Decode an RGB PNG's IDAT with ``zlib`` and check its size; returns
    ``(width, height)``."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != height * (1 + 3 * width):
        raise AssertionError(f"{path}: the image data does not decode to {width}x{height} RGB")
    return width, height


def run_layout_trainer() -> dict:
    """Phase 11 (c): the layout trainer CLI in a temporary directory, at its
    defaults (bf16, batch 64, 500 words) on ``synthetic-doc`` cut to 32
    pages (one step an epoch, 32 validation pages; drawing a page takes
    over 0.1 s of Python, which bounds this phase): three epochs (every
    loss finite, epoch 2's train loss below epoch 0's, a checkpoint, three
    metrics records); a resume for one more epoch with the Adam step
    restored; ``--validate-only``; ``--export layout.pt``; then
    ``eval_layout`` on a page written by ``write_corpus``, whose PNG must
    decode."""
    import math
    import os
    import tempfile

    from ocrs_models_torch.data.layout_synth import write_corpus
    from ocrs_models_torch.training import eval_layout, train_layout

    data = ["synthetic-doc", "--max-images", str(LAYOUT_TRAIN_IMAGES)]
    steps = math.ceil(LAYOUT_TRAIN_IMAGES / LAYOUT_BATCH)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as run_dir:
        os.chdir(run_dir)
        try:
            lines, state, _, seconds = _cli(train_layout, [*data, "--max-epochs", "3"])
            records = [json.loads(r) for r in
                       Path("text-layout-metrics.jsonl").read_text().splitlines()]
            epochs = [r for r in records if "epoch" in r]
            losses = [r["train_loss"] for r in epochs]
            if [r["epoch"] for r in epochs] != [0, 1, 2] or not all(
                    np.isfinite([v for r in epochs for v in (r["train_loss"], r["val_loss"])])):
                raise AssertionError(f"train_layout: epoch records {epochs}")
            if not losses[2] < losses[0]:
                raise AssertionError(f"train_layout: the train loss did not fall: {losses}")
            if f"Model param count {LAYOUT_PARAMS}" not in lines or state.model.dtype != BF16:
                raise AssertionError("train_layout: not the full-width bf16 layout model")
            print(json.dumps({"path": "train_layout synthetic-doc 3 epochs", "dtype": "bf16",
                              "batch": LAYOUT_BATCH, "pages": LAYOUT_TRAIN_IMAGES,
                              "seconds": seconds, "train_loss": losses,
                              "val_loss": [r["val_loss"] for r in epochs],
                              "lr": [r["lr"] for r in epochs],
                              "val_accuracy": epochs[-1]["val_accuracy"]}), flush=True)

            ckpt = torch.load("text-layout-checkpoint.pt", map_location="cpu", weights_only=True)
            epoch = ckpt["epoch"]
            adam = {float(v["step"]) for v in ckpt["optimizer_state"]["state"].values()}
            if ckpt["step"] != steps * epoch or adam != {float(steps * epoch)} or epoch < 1:
                raise AssertionError(f"checkpoint: epoch {epoch}, step {ckpt['step']}, Adam {adam}")
            lines, state, _, seconds = _cli(train_layout, [
                *data, "--checkpoint", "text-layout-checkpoint.pt", "--max-epochs", str(epoch + 1)])
            records = [json.loads(r) for r in
                       Path("text-layout-metrics.jsonl").read_text().splitlines()]
            last = [r for r in records if "epoch" in r][-1]
            adam_step = float(state.optimizer.adam.state_dict()["state"][0]["step"])
            if (state.step, adam_step, last["epoch"]) != (steps * (epoch + 1),
                                                          float(steps * (epoch + 1)), epoch):
                raise AssertionError(f"resume: step {state.step}, Adam {adam_step}, "
                                     f"epoch {last['epoch']}; from epoch {epoch}")
            print(json.dumps({"path": f"train_layout resumed, epoch {epoch}", "seconds": seconds,
                              "train_loss": last["train_loss"], "val_loss": last["val_loss"]}),
                  flush=True)

            lines, _, _, _ = _cli(train_layout, [*data, "--checkpoint", "text-layout-checkpoint.pt",
                                                 "--validate-only"])
            (line,) = [ln for ln in lines if "val stats" in ln]
            _cli(train_layout, [*data, "--checkpoint", "text-layout-checkpoint.pt",
                                "--export", "layout.pt"])
            exported = torch.load("layout.pt", map_location="cpu", weights_only=True)
            n_exported = sum(v.numel() for v in exported["model_state"].values())
            if n_exported != LAYOUT_PARAMS or exported["optimizer_state"] != {}:
                raise AssertionError(f"--export layout.pt: {n_exported} parameters")

            write_corpus("pages", 1, seed=SEED)
            lines, _, _, seconds = _cli(eval_layout, ["pages/page-00000.json", "page.png",
                                                      "--checkpoint", "layout.pt",
                                                      "--colors", "labels"])
            width, height = _png_size("page.png")
            print(json.dumps({"path": "train_layout --validate-only, --export, eval_layout",
                              "val_line": line, "eval_line": lines[-1] if lines else "",
                              "png": [width, height], "eval_seconds": seconds}), flush=True)
        finally:
            os.chdir(cwd)
    return {"epochs": len(epochs)}


def run(root: Path) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from ocrs_models_torch.geometry import native
    from ocrs_models_torch.ops import _build
    from ocrs_models_torch.pipeline import OcrPipeline

    t_start = time.perf_counter()
    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {_build.sources()}", flush=True)
    for name in _build.sources():
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"host geometry core: {native.backend()}", flush=True)
    from ocrs_models_torch.ops.gru import max_active_clusters

    for dtype in (torch.float32, BF16):
        for n in (REC_BATCH, 256):  # the serving chunk and the training headline, H=256
            print(f"biGRU clusters ({dtype}) at N={n}, H=256: "
                  f"{json.dumps(max_active_clusters(n, 256, dtype=dtype))}", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)

    # Phase 3: each forward kernel against its plain version, in both dtypes.
    kernels = [check_stage1(dev, gen), check_gru(dev, gen)]
    kernels_bf16 = [check_stage1_bf16(dev, gen), check_gru_bf16(dev, gen)]

    # Phase 4: full recognition forward, f32 and bf16 (the same weights).
    pipes = {"f32": OcrPipeline(device=dev, seed=SEED),
             "bf16": OcrPipeline(device=dev, seed=SEED, compute_dtype=BF16)}
    for pipe in pipes.values():
        check_recognition(pipe, gen)

    # Phases 5 and 6: the main path, in both dtypes.
    rng = np.random.default_rng(SEED)
    pages = [
        synthetic_page(rng, int(rng.integers(1000, 1300)), int(rng.integers(760, 1000)))
        for _ in range(N_PAGES)
    ]
    crops = [synthetic_crop(rng, w) for w in BUCKET_WIDTHS for _ in range(REC_BATCH)]
    served = {dtype: _serve(pipe, pages, crops) for dtype, pipe in pipes.items()}
    _agreement(pipes["f32"], pipes["bf16"], served, crops)

    # Detection on the card against the CPU, on two pages.
    pipe = pipes["f32"]
    cpu = OcrPipeline(
        pipe.det_model.state_dict(), pipe.rec_model.state_dict(), device="cpu"
    )
    from ocrs_models_torch.data.resize import resize

    x = np.stack([resize(p, pipe.det_size)[..., 0] for p in pages[:2]])[:, None]
    with pipe._numerics():
        p_gpu = pipe.det_model(torch.from_numpy(x).to(dev)).cpu()
    with cpu._numerics():
        p_cpu = cpu.det_model(torch.from_numpy(x))
    det_err = (p_gpu - p_cpu).abs().max().item()
    print(f"detection [2,1,800,600] card vs CPU: max_abs_err {det_err:.3e}", flush=True)
    if not det_err <= 1e-4:
        raise AssertionError(f"detection probabilities disagree with the CPU: {det_err}")
    del pipe, pipes, cpu
    torch.cuda.empty_cache()

    # Phase 7: each backward kernel against its plain version.
    kernels += [check_stage1_bwd(dev, gen), check_gru_bwd(dev, gen), *check_ctc(dev, gen)]
    kernels_bf16 += [check_stage1_bwd_bf16(dev, gen), check_gru_bwd_bf16(dev, gen)]

    # Phase 8: the training step, in both dtypes.
    train = {}
    for dtype, name in ((torch.float32, "f32"), (BF16, "bf16")):
        check_train_step_vs_plain(dev, dtype)
        train[name] = run_training(dev, dtype)
    for rows, name in ((kernels, "f32"), (kernels_bf16, "bf16")):
        head = train[name]["headline"]
        for k in rows:
            k.setdefault("dtype", name)
            k["launches"] = head["launches"][k["name"]]
            k["launches_per_step"] = head["launches"][k["name"]] // head["steps"]
            if k["name"] in served[name]["serve_launches"]:
                k["serve_launches"] = served[name]["serve_launches"][k["name"]]
            if not k["launches"] > 0:
                raise AssertionError(f"the {name} training step never launched {k['name']}")

    # Phase 9: the trainer CLI.
    trainer_launches = run_trainer({k: v["wide"]["crops_per_s"] for k, v in train.items()})
    for rows, name in ((kernels, "f32"), (kernels_bf16, "bf16")):
        for k in rows:
            k["trainer_launches_per_epoch"] = trainer_launches[name][k["name"]]

    # Phase 10: the layout model in serving (phase 5's pages).
    t0 = time.perf_counter()
    layout = check_layout_serving(dev, pages)
    torch.cuda.empty_cache()
    print(f"phase 10 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 11: layout training: the step against the CPU, timed steps in
    # both dtypes, the trainer CLI and eval_layout.
    t0 = time.perf_counter()
    check_layout_step(dev)
    layout_steps = {name: run_layout_training(dev, dtype)
                    for dtype, name in ((BF16, "bf16"), (torch.float32, "f32"))}
    print(f"phase 11 steps seconds {time.perf_counter() - t0:.1f}", flush=True)
    run_layout_trainer()
    print(f"phase 11 seconds {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"path": "layout summary", "forward_ms_16x500": layout["forward_ms"],
                      "forward_device_ms_16x500": layout["forward_device_ms"],
                      "run_batch_layout_pages_per_s": layout["pages_per_s"],
                      **{f"step_{k}_median_ms": v["step_ms_median"] for k, v in layout_steps.items()},
                      **{f"step_{k}_pages_per_s": v["pages_per_s"] for k, v in layout_steps.items()}}),
          flush=True)

    print(f"smoke seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels + kernels_bf16}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    try:
        return run(Path(__file__).resolve().parent)
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
