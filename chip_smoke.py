#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``ocrs_models_torch/csrc`` (nvcc, sm_90a,
   one process per source, in parallel) and the host geometry core.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: stage 1 at [128, 1, 64, W] for W in {256, 800}
   (atol 1e-5), the biGRU recurrence at T=201, N=128, H=256 (atol 1e-4:
   error accumulates over 201 steps). Time kernel, plain version and the
   library yardstick (F.conv2d + relu + max_pool2d; cuDNN nn.GRU) with
   CUDA events.
4. Hold the full recognition forward (kernels) against the same model
   with the kernels' plain versions swapped in: log-probs at atol 1e-4.
5. The main path: ``OcrPipeline.run_batch`` on 16 synthetic pages at the
   shipped widths (detection 800x600, CRNN 32-64-128 channels, 2-layer
   biGRU H=256, 97 classes; random weights from a fixed seed),
   det_batch=8, rec_batch=128. Launch counts are zeroed just before it and
   read just after; every kernel must have launched. Detection
   probabilities are checked against the CPU on two pages.
6. ``_recognize_crops`` on 128 crops in each width bucket (256, 512, 768,
   800), so every recognition shape runs whatever detection found.

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


def _no_tf32():
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=True, deterministic=False, allow_tf32=False
    )


def _bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
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
    from ocrs_models_torch.ops import stage1, stage1_reference

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
    n, _, h, w = x.shape
    n_bytes = x.numel() * 4 + 32 * 10 * 4 + n * 32 * (h // 2) * (w // 2) * 4
    n_flops = n * 32 * h * w * 19  # 9 FMAs + bias per conv output
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    return {
        "name": "stage1_fwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/stage1_fwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/stage1_kernel.py:201",
        "shape": f"x [{n},1,{h},{w}] f32 -> [{n},32,{h // 2},{w // 2}]",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_gru(dev, gen) -> dict:
    from ocrs_models_torch.ops import gru_recurrence, gru_recurrence_reference

    t_len, n, hid = 201, REC_BATCH, 256  # T = 800 // 4 + 1 at the widest bucket
    k = 1.0 / hid**0.5
    px_f = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
    px_b = torch.randn((t_len, n, 3 * hid), generator=gen).to(dev)
    w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    with torch.inference_mode():
        want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
        got = gru_recurrence(px_f, px_b, w_hh, b_hh)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"gru [T=201,N=128,H=256]: max_abs_err {err:.3e}", flush=True)
        if not err <= 1e-4:
            raise AssertionError(f"gru_fwd disagrees with its plain version: {err}")
        ms = _cuda_time_ms(lambda: gru_recurrence(px_f, px_b, w_hh, b_hh), iters=10)
        plain_ms = _cuda_time_ms(
            lambda: gru_recurrence_reference(px_f, px_b, w_hh, b_hh), iters=3, warmup=1
        )
        # Yardstick: cuDNN's bidirectional GRU layer at the first layer's
        # shape; it also computes the input projection (F=128).
        lib_gru = torch.nn.GRU(128, hid, bidirectional=True).to(dev)
        xs = torch.randn((t_len, n, 128), generator=gen).to(dev)
        with _no_tf32():
            library_ms = _cuda_time_ms(lambda: lib_gru(xs), iters=10)
    n_bytes = 4 * (2 * t_len * n * 3 * hid + 2 * hid * 3 * hid + 2 * 3 * hid + 2 * t_len * n * hid)
    n_flops = 2 * t_len * 2 * n * hid * 3 * hid
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    return {
        "name": "gru_fwd", "route": "cuda",
        "source": "ocrs_models_torch/csrc/gru_fwd.cu",
        "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:139",
        "shape": f"px [{t_len},{n},{3 * hid}] x2, w_hh [2,{hid},{3 * hid}] f32",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_recognition(pipe, gen) -> float:
    """Full recognition forward with the kernels vs the same model with the
    kernels' plain versions swapped in, on the card."""
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
    print(f"recognition forward [128,1,64,800] vs plain ops: max_abs_err {err:.3e}", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"recognition log-probs disagree with plain ops: {err}")
    return err


def run(root: Path) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from ocrs_models_torch.config import DEFAULT_ALPHABET
    from ocrs_models_torch.geometry import native
    from ocrs_models_torch.ops import _build, gru_recurrence, stage1
    from ocrs_models_torch.pipeline import OcrPipeline

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

    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)

    # Phase 3: each kernel against its plain version.
    kernels = [check_stage1(dev, gen), check_gru(dev, gen)]

    # Phase 4: full recognition forward.
    pipe = OcrPipeline(device=dev, seed=SEED)
    check_recognition(pipe, gen)

    # Phase 5: the main path.
    rng = np.random.default_rng(SEED)
    pages = [
        synthetic_page(rng, int(rng.integers(1000, 1300)), int(rng.integers(760, 1000)))
        for _ in range(N_PAGES)
    ]
    pipe.run_batch(pages, det_batch=DET_BATCH, rec_batch=REC_BATCH)  # warm-up
    torch.cuda.synchronize()
    stage1.launches = 0
    gru_recurrence.launches = 0
    t0 = time.perf_counter()
    results = pipe.run_batch(pages, det_batch=DET_BATCH, rec_batch=REC_BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {"stage1_fwd": stage1.launches, "gru_fwd": gru_recurrence.launches}
    n_lines = sum(len(p) for p in results)
    print(json.dumps({"path": "run_batch", "pages": N_PAGES, "lines": n_lines,
                      "seconds": elapsed, "pages_per_s": N_PAGES / elapsed,
                      "launches": counts}), flush=True)
    if len(results) != N_PAGES or any(not isinstance(ln.text, str) for p in results for ln in p):
        raise AssertionError("run_batch returned a malformed result")
    if any(ch not in DEFAULT_ALPHABET for p in results for ln in p for ch in ln.text):
        raise AssertionError("run_batch produced characters outside the alphabet")
    if any(not np.isfinite(ln.box).all() for p in results for ln in p):
        raise AssertionError("run_batch produced non-finite line boxes")
    for name, count in counts.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name} (lines found: {n_lines})")
    for k in kernels:
        k["launches"] = counts[k["name"]]

    # Detection on the card against the CPU, on two pages.
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

    # Phase 6: every recognition bucket.
    crops = [synthetic_crop(rng, w) for w in BUCKET_WIDTHS for _ in range(REC_BATCH)]
    pipe._recognize_crops(crops, REC_BATCH)  # warm-up
    torch.cuda.synchronize()
    stage1.launches = 0
    gru_recurrence.launches = 0
    t0 = time.perf_counter()
    texts = pipe._recognize_crops(crops, REC_BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    bucket_counts = {"stage1_fwd": stage1.launches, "gru_fwd": gru_recurrence.launches}
    print(json.dumps({"path": "recognize_crops", "crops": len(crops),
                      "buckets": list(BUCKET_WIDTHS), "seconds": elapsed,
                      "crops_per_s": len(crops) / elapsed, "launches": bucket_counts}),
          flush=True)
    if len(texts) != len(crops) or bucket_counts != {"stage1_fwd": 4, "gru_fwd": 8}:
        raise AssertionError(f"recognize_crops: {len(texts)} texts, launches {bucket_counts}")

    print(json.dumps({"kernels": kernels}), flush=True)
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
