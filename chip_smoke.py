#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, recognition training step,
recognition trainer, layout model (served and trained), detection
training, the ONNX and ``.npz`` export, the data-parallel paths, the
real-data readers, the layout model's tensor parallelism, the
on-device components, preprocessing and beam search, and the recognizer
at a biGRU width the cluster kernels do not take (the wide route) on one
NVIDIA GPU and check them.

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
   label and an infeasible row, at the training step's two shapes
   (N=256, T=65 and N=128, T=257; S=49 and 97, and S=129 as the step pads
   its labels), and past a block of positions, S=1025 and 2049 (labels
   512 and 1024 wide, as a line of 449 or 960 characters pads them; that
   row infeasible), bit for bit (each kernel's design printed). Time kernel, plain version and the library yardstick
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
   the wide bucket 128 x 64x1024; in f32 ``grad_accum=4`` and ``eval_step``;
   and in both dtypes one wide-bucket step whose row 2 holds a line of 449
   characters (labels padded to 512, S=1025; weight 0) against the plain
   step at the same tolerances.
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

12. Detection training (``training.steps.make_detection_steps``: cuDNN
    convolutions and plain PyTorch ops, the JAX detector reaches no Pallas
    kernel) at the trainer's shape, ``[4, 1, 800, 600]`` synthetic pages
    from ``SyntheticDetection``, the full-width U-Net (622,122 parameters)
    from a fixed seed: one step on the card against the CPU from the same
    weights in each dtype (f32: loss 1e-4 relative, grad norm 1e-3, module
    norms 2e-2; bf16: 1e-2, 1e-1, 2.5e-1; parameters within ``2 * lr``);
    ``grad_accum=4`` against its four microbatches one by one (loss 1e-5,
    grad norm 1e-4); 10 timed steps in bf16 and f32 (median [min, max] by
    CUDA events, pages/s, peak memory, device launches and busy time; the
    loss must fall; no port kernel launches); the balanced BCE alone,
    forward and backward, with no host sync (ms, device ms, launches).
13. The detection trainer CLI (``training/train_detection.py``) at its
    defaults (bf16, batch 4, 800x600, augmented) on 16 synthetic pages:
    three epochs, a resume for one more with the Adam step restored,
    ``--validate-only``, and ``eval_detection`` on a 1000x750 page saved
    as PNG (its four PNGs decoded at their sizes); the host ms per page of
    drawing a page and of each augmentation branch.

14. Export: each trainer (``train_rec``, ``train_layout``,
    ``train_detection``) with ``--checkpoint`` of phase 9's, 11's and 13's
    checkpoint and ``--export`` to ``.onnx`` and ``.npz``. Each graph passes
    the spec checker and the parser, with the reference's inputs and
    outputs (``image [batch,1,800,600] -> mask``, ``line_image
    [batch,1,64,seq] -> chars [out_seq,batch,97]``, ``word_boxes
    [batch,box,4] -> preds [batch,box,2]``), and the port's numpy evaluator
    on the host agrees with the float32 forward on the card (TF32 off) from
    the same checkpoint: one synthetic 800x600 page (2e-4), line crops at
    ``[8,1,64,256]`` and ``[3,1,64,96]`` (2e-4, at least 99.9% of the
    argmaxes equal; the forward launches ``stage1_fwd`` once and
    ``gru_fwd`` twice), ``[2,500,4]`` word boxes (5e-4). Each ``.npz``
    maps back through ``weights.*_state_dict_from_jax`` into a fresh model,
    strictly, every tensor equal to the checkpoint's but
    ``num_batches_tracked``. Then ``python -m ocrs_models_torch.export
    convert recognition`` on phase 9's checkpoint must write the trainer's
    graph byte for byte. One ``{"path": "export", ...}`` line per model
    (bytes, nodes, export and evaluation seconds, largest error).

15. Data parallelism (``ocrs_models_torch.parallel``) on the one card:
    (a) in a spawned one-rank NCCL process group, the recognition step's
    collective path (``force_shard_map=True``) against the plain step at
    ``[256, 1, 64, 256]`` in f32 and bf16, 3 steps under deterministic
    algorithms with losses, parameters and running statistics bit-equal,
    then 10 timed steps of each in turns (median [min, max]), the device
    launches a step of each and the bytes all-reduced; detection at ``[4,
    1, 800, 600]`` and layout at 64 x 500 words through their mesh paths
    against their plain steps (f32, one step: loss 1e-4 and 1e-6 relative,
    grad norm 1e-3 and 1e-5); (b) two ``gloo`` ranks sharing the card, two
    steps each: the recognizer on 64 rows a rank against a one-process
    emulation of its per-shard step (two halves through forward and
    backward, summed, running statistics averaged; phase 8's f32 bounds),
    the detector on 2 pages a rank against the one-process step on all 4
    (phase 12's f32 bounds), both ranks' replicas bit-identical after two
    steps, all six kernels launched inside the ranks, host ms a step
    (gloo copies through the host: not a speed figure); (c) every kernel
    row's C entry leaves the thread's current device as it found it (one
    step in each dtype through guarded wrappers), and ``run_batch`` over
    ``create_mesh()`` (every visible card) and over the card twice (two
    replicas, each batch in halves) equal to one device's, with pages/s;
    (d) ``torchrun --standalone --nproc-per-node 1 -m
    ocrs_models_torch.training.train_rec`` for one epoch of one step (20
    lines, f32; the env-driven join, NCCL): rank 0's checkpoint written.
16. The real-data path on the committed toy roots (``tests/data``),
    copied to a temporary directory: (a) every fixture decoded by
    ``data.imageio.read_grey`` on the host (the toy roots' pages and
    ``tests/data/torch_decode_formats``: CMYK and YCCK JPEGs, 16-bit and
    Adam7 PNGs), the SHA-256 of its greyscale
    bytes equal to the committed digest of Pillow's decode, and the
    decoder's ms per megapixel on a 2 MP page and on the toy pages; (b)
    ``train_rec hiertext`` (bf16, batch 4) for an epoch and a resumed
    second: launch counts exact (all six kernels), losses finite, the
    second epoch reading the crop cache the first wrote and writing
    nothing; (c) ``train_detection hiertext`` and ``ddi``, one epoch each
    at 800x600 (finite losses, no port kernel), pages/s and host ms per
    page decoded; (d) ``eval_detection`` on a JPEG page; (e) the preview
    CLI for ``hiertext``, ``hiertext-rec`` and ``ddi``; (f) the layout
    model's tensor-parallel step on two ``gloo`` ranks sharing the card
    (1 x 2 data x model mesh, 8 pages of 500 words, dropout on) against
    the plain step from the same weights and dropout stream: loss rtol
    1e-5, parameters rtol 1e-3 / atol 5e-5 but where the plain gradient
    is flat (within 1e-6 of 0: within 2 lr), the gathered state's keys
    and shapes the plain model's.
17. Device-side geometry and preprocessing: (a)
    ``connected_components_device`` and ``component_bounds_device`` on
    two batches of 4 masks at 800 x 600 (the detection trainer's target
    masks, and the pipeline's thresholded detector output of phase 5's
    pages): each page's labels a bijection with the host core's
    components, the boxes the host components' boxes in ascending label
    order with ``max_components`` above and below the count (overflow:
    slot K-1 holds the largest label's box); propagation steps and the
    median ms of 5 calls (CUDA events) of each function, of one step and
    of one test for the fixed point; (b) ``prepare_line_crops`` on 128
    uint8 crops of 96 x 700 and ``photometric_augment`` with draws from a
    CPU generator, on the card against the CPU within 1e-5, timed; (c)
    ``ctc_beam_search_decode`` (beam 10) on the recognizer's log-probs of
    phase 5's 128 crops of width 256: host ms a crop and the share equal
    to the greedy decode (printed, not gated).
18. The biGRU's wide route (``csrc/gru_wide.cu`` and ``csrc/gru_grid.cu``;
    ``gru_bwd.cu``'s ``coef`` and ``dw`` around its chain), which takes
    every width the cluster kernels do not (``ops.gru.gru_route``): up to
    512 after padding its persistent form, one launch for all T steps in
    clusters of up to 16 blocks; above, in bf16 up to 1440 the grid form,
    one cooperative launch over the whole card; else one launch a step.
    (a) ``gru_fwd`` and ``gru_bwd`` at
    T=257, N=128 and H in {100, 264, 512}, in f32 and bf16, against the
    plain versions with the cluster rows' tolerances (bf16 ``dpx`` at
    H=512: 93% equal, not 95%; see ``_wide_min_equal``), the route, the
    wrapper counts and the device launches a call asserted (one recurrence
    kernel a forward, the chain and ``coef``, ``dw``, ``dw_sum`` a
    backward, and in bf16 W_hh's two casts), reruns bit-identical, timed
    at H=512 beside the plain versions, cuDNN's ``nn.GRU`` and the bound,
    with the rows per block and the clusters launched and held at once;
    the grid form (bf16) the same way at H=1024, T=9, then at H=1024,
    T=257, N=128 (its equal shares gated as H=512's) timed beside its plain
    versions and cuDNN, with its blocks; in bf16 the streamed plans at
    GRID_STREAMED_HIDDEN (1448, 2048, 5280 and the per-gate plan at 5288)
    the same way, timed beside the per-step form on the same inputs, and
    so the f32 streamed plans at GRID_F32_STREAMED_HIDDEN (1064, 1448,
    2048); the per-step form held at T=9 above each dtype's widest grid
    width (f32 2120, bf16 6344); (b) the shipped CRNN with ``gru_hidden=512``:
    3 steps against the plain step in each dtype (phase 8's tolerances for
    the first step, the CPU parity test's for later ones), then 10 timed
    steps at the headline and wide shapes (median [min, max], peak MiB,
    exact launch counts); (c) ``_recognize_crops`` with that recognizer on
    128 crops of width 256 (crops/s), the greedy strings equal to the
    CPU's on the same weights; (d) the CRNN with ``gru_hidden=1024`` in
    bf16 (the grid form): 3 steps against the plain steps, 10 headline and
    3 wide steps timed, every call counted in the grid form; (e) the same
    at ``gru_hidden=2048`` in bf16 and f32 (W_hh partly streamed).

Prints the nvidia-smi line, throughput lines, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
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
H100_L2_BYTES = 50e6  # H100 SXM data sheet: the L2 cache
H100_SMS = 132  # H100 SXM: SMs
H100_SMEM_BYTES = 232448  # H100: the shared memory a block of an SM may opt into
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# float32 products on the tensor cores as error-compensated TF32 (3xTF32:
# three TF32 products, 495 TFLOP/s dense on the H100 SXM, for each f32 one)
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, bf16 dense on the tensor cores
_PEAK_NAMES = {F32_FLOPS_PER_S: "f32 FMA 67 TFLOP/s", TF32X3_FLOPS_PER_S: "3xTF32 165 TFLOP/s",
               BF16_FLOPS_PER_S: "bf16 989 TFLOP/s"}
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
    return _bound_parts(n_bytes, ((n_flops, flops_per_s),))


def _bound_parts(n_bytes: float, parts) -> tuple[float, str]:
    """:func:`_bound` for work whose products run on different pipes one
    after another: ``parts`` holds (operations, peak rate) of each."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n_flops / flops_per_s for n_flops, flops_per_s in parts) * 1e3
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
        # The chain's product on the FMA pipes, coef's and dw's in 3xTF32.
        n_flops = 2 * 2 * t_len * n * hid * h3
        bound_ms, bound_by = _bound_parts(
            n_bytes, ((n_flops, F32_FLOPS_PER_S), (2 * n_flops, TF32X3_FLOPS_PER_S)))
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


def _ctc_seed(alphas, gen, zero_rows):
    """A random negative cotangent of ``alphas[:, -1]`` (none on
    ``zero_rows``) as ``ctc_beta`` takes it: ``(seed, sign)``."""
    from ocrs_models_torch.ops.ctc import NEG_INF

    n, _, s = alphas.shape
    d_last = -torch.rand((n, s), generator=gen).to(alphas.device)
    for row in zero_rows:
        d_last[row] = 0.0
    mag = d_last.abs()
    seed = torch.where(mag > 0, torch.log(mag) - alphas[:, -1], torch.full_like(mag, NEG_INF))
    return seed, torch.where(d_last < 0, -1.0, 1.0).amin(dim=1).contiguous()


def _check_ctc_dense(case: dict, gen, what: str, zero_rows) -> None:
    """Both wide CTC kernels bit for bit against their plain versions on
    ``case`` with alpha0 drawn at every position: the loss's own alpha0
    reaches position j only at step j / 2, so at T=257 the upper half of
    1025 positions would hold NEG_INF throughout and every thread's later
    slots (``ops.ctc.wide_slots``) would compare constants. Each slot of
    the rows with a cotangent must hold finite states and nonzero
    gradients at 90% of its active entries."""
    from ocrs_models_torch.ops import ctc_alpha, ctc_alpha_reference, ctc_beta, ctc_beta_reference
    from ocrs_models_torch.ops.ctc import NEG_INF, wide_slots

    emit, skip, lens = case["emit"], case["skip"], case["lens"]
    n, t_len, s = emit.shape
    alpha0 = (torch.randn((n, s), generator=gen) - 3.0).to(emit.device)
    got_a = ctc_alpha(emit, skip, alpha0, lens)
    want_a = ctc_alpha_reference(emit, skip, alpha0, lens)
    seed, sign = _ctc_seed(want_a, gen, zero_rows)
    got_b = ctc_beta(emit, skip, got_a, seed, sign, lens)
    want_b = ctc_beta_reference(emit, skip, want_a, seed, sign, lens)
    torch.cuda.synchronize()
    err = max((got_a - want_a).abs().max().item(), _err(got_b, want_b))
    rows = torch.arange(t_len, device=emit.device)[None, :]
    live = (rows >= 1) & (rows < lens[:, None].clamp(max=t_len))  # active steps past 0
    live[list(zero_rows)] = False
    shares = []
    for slot in wide_slots(s):
        cols = slice(slot.start, slot.stop)
        for x in (want_a[:, :, cols] > NEG_INF / 2, want_b[0][:, :, cols] != 0):
            shares.append(x[live].float().mean().item())
    print(f"ctc {what} dense alpha0 [N={n},T={t_len},S={s}]: max_abs_err {err:.3e}; "
          f"least live share of a slot {min(shares):.4f}", flush=True)
    if err != 0 or min(shares) < 0.9:
        raise AssertionError(f"CTC kernels ({what}, dense alpha0): err {err}, shares {shares}")


def _check_ctc_case(case: dict, gen, what: str, zero_rows=(), exact=False) -> dict:
    """Both CTC kernels against their plain versions on one case, then
    their times: alphas atol 1e-3 (log values down to ~-1e3), demit and
    dalpha0 atol 1e-5 (posteriors in [0, 1]); bit for bit where ``exact``,
    then also with alpha0 at every position (:func:`_check_ctc_dense`).
    ``zero_rows`` carry no cotangent and must get no gradient."""
    from ocrs_models_torch.ops import (ctc_alpha, ctc_alpha_chain_probe, ctc_alpha_reference,
                                       ctc_beta, ctc_beta_chain_probe, ctc_beta_reference,
                                       ctc_design)

    emit, skip, alpha0, lens = (case[k] for k in ("emit", "skip", "alpha0", "lens"))
    n, t_len, s = emit.shape
    dev = emit.device
    want_a = ctc_alpha_reference(emit, skip, alpha0, lens)
    got_a = ctc_alpha(emit, skip, alpha0, lens)
    got_final = ctc_alpha(emit, skip, alpha0, lens, final_only=True)
    seed, sign = _ctc_seed(got_a, gen, zero_rows)
    want_b = ctc_beta_reference(emit, skip, got_a, seed, sign, lens)
    got_b = ctc_beta(emit, skip, got_a, seed, sign, lens)
    torch.cuda.synchronize()
    err_a = max((got_a - want_a).abs().max().item(),
                (got_final - want_a[:, -1]).abs().max().item())
    err_b = _err(got_b, want_b)
    designs = {k: ctc_design(k, s, dev) for k in ("ctc_alpha", "ctc_beta")}
    print(f"ctc_alpha {what} [N={n},T={t_len},S={s}]: max_abs_err {err_a:.3e}; "
          f"ctc_beta: max_abs_err {err_b:.3e}; designs {designs}", flush=True)
    if not (err_a <= (0 if exact else 1e-3) and err_b <= (0 if exact else 1e-5)):
        raise AssertionError(f"CTC kernels disagree with their plain versions ({what}): {err_a}, {err_b}")
    if not all(torch.isfinite(t).all() for t in (*got_b, got_a)) or \
            any(got_b[0][row].abs().max() != 0 for row in zero_rows):
        raise AssertionError(f"ctc_beta ({what}): non-finite values, or a gradient on a zero row")
    if exact:
        _check_ctc_dense(case, gen, what, zero_rows)  # raises unless bit-equal

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
    # Bytes: the inputs of the active rows read once (emit, and for beta
    # the saved alphas; frozen rows are never read), every output row
    # written once.
    active = int(np.minimum(np.maximum(case["input_len_np"], 1), t_len).sum())
    active_bytes, state_bytes = 4 * active * s, 4 * n * t_len * s
    out = {}
    for name, ms, dev_ms, launches, plain_ms, lib_ms, n_bytes, n_flops, err in (
        ("ctc_alpha", ms_a, dev_a, launches_a, plain_a, lib_a,
         active_bytes + state_bytes + 4 * (3 * n * s + n), 14 * (active - n) * s, err_a),
        ("ctc_beta", ms_b, dev_b, launches_b, plain_b, lib_b,
         2 * active_bytes + state_bytes + 4 * (4 * n * s + 2 * n), 20 * active * s, err_b),
    ):
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        out[name] = {
            "shape": f"emit [{n},{t_len},{s}] f32", "design": designs[name], "max_abs_err": err,
            "ms": ms,
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
    step hands them over (S=129). Then past a block of positions
    (``long_s1025``, ``long_s2049``): the main case's lengths in label
    arrays 512 and 1024 wide, as a line of 449 (960) characters pads them,
    that row (2) holding that line, which its 20 steps cannot fit: bit for
    bit equal to the plain versions."""
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
    for label_width, long_len in LONG_LABELS:
        long_len_all = label_len.copy()
        long_len_all[2] = long_len
        case = _ctc_case(dev, gen, n, t_len, label_width, long_len_all, input_len, repeats=True)
        key = f"long_s{2 * label_width + 1}"
        subs[key] = _check_ctc_case(case, gen, key, zero_rows=(2,), exact=True)
        del case
        torch.cuda.empty_cache()
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


LONG_LABELS = ((512, 449), (1024, 960))
"""Phase 7's and 8's long lines: label arrays 512 and 1024 wide (S = 1025,
2049), as a line of 449 (960) characters pads them in the trainers'
collation (``round_up(len, 64)``)."""

TRAIN_LAUNCHES = {"stage1_fwd": 1, "stage1_bwd": 1, "gru_fwd": 2, "gru_bwd": 2,
                  "ctc_alpha": 1, "ctc_beta": 1}
EVAL_LAUNCHES = {"stage1_fwd": 1, "gru_fwd": 2, "ctc_alpha": 1}
WIDE_TRAIN_LAUNCHES = {"stage1_fwd": 1, "stage1_bwd": 1, "gru_wide_fwd": 2, "gru_wide_bwd": 2,
                       "ctc_alpha": 1, "ctc_beta": 1}


def train_launches(gru_hidden: int) -> dict:
    """A recognition step's launches per wrapper: the biGRU's two layers
    on the route its width takes (``ops.gru.gru_route``)."""
    from ocrs_models_torch.ops import gru_route

    return TRAIN_LAUNCHES if gru_route(gru_hidden) == "cluster" else WIDE_TRAIN_LAUNCHES


def _counts() -> dict:
    from ocrs_models_torch.ops import KERNELS

    return {k.__name__: k.launches for k in KERNELS}


def _zero_counts() -> None:
    from ocrs_models_torch.ops import KERNELS, PHASE_KERNELS

    for k in KERNELS + PHASE_KERNELS:
        k.launches = 0
        for form in getattr(k, "forms", ()):
            k.forms[form] = 0


def _phase_counts() -> dict:
    """The launches of the f32 wide backward's ``coef`` and ``dw`` wrappers
    (``ops.PHASE_KERNELS``, called inside ``gru_wide_bwd`` above 512)."""
    from ocrs_models_torch.ops import PHASE_KERNELS

    return {k.__name__: k.launches for k in PHASE_KERNELS}


def _form_counts() -> dict:
    """The wide route's wrappers' calls by form (``ops.gru.wide_form``)."""
    from ocrs_models_torch.ops import KERNELS

    return {k.__name__: dict(k.forms) for k in KERNELS if hasattr(k, "forms")}


def _expect(counts: dict, per_step: dict, steps: int, what: str) -> None:
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def long_label_batch(dev) -> dict:
    """The wide bucket, 128 x 64x1024 (T = 257), whose row 2 holds a line
    of 449 characters, which its 256 steps cannot fit: the collation pads
    every label to 512 (S = 1025) and weights that row 0."""
    batch = rec_batch(REC_BATCH, 1024, 48, dev)
    label_width, long_len = LONG_LABELS[0]
    text = torch.zeros((REC_BATCH, label_width), dtype=torch.int64, device=dev)
    text[:, :64] = batch["text"]
    text[2, :long_len] = torch.from_numpy(
        np.random.default_rng(SEED).integers(1, 97, long_len)).to(dev)
    batch["text"] = text
    batch["text_len"][2] = long_len
    batch["sample_weight"][2] = 0.0
    return batch


def check_train_step_vs_plain(dev, dtype=torch.float32, gru_hidden: int = 256,
                              steps: int = 1, batch: dict | None = None, tag: str = "") -> None:
    """``steps`` headline steps (or steps on ``batch``, named by ``tag``)
    with the kernels vs the same steps with every kernel's plain version
    swapped in, from the same weights, with a biGRU of ``gru_hidden`` units. Tolerances in float32 as the CPU parity
    test's: the first step's loss rtol 1e-5, grad norm rtol 1e-3, later
    steps' 1e-3 and 5e-2; parameters within 1e-5 but for at most 1% of
    entries after one step (max-pool near-ties route a few gradients
    elsewhere, and Adam's first step is +-lr per entry), all within 2 * lr
    a step. In bf16 (where a bf16 rounding that flips moves a value by one
    bf16 ulp): the loss rtol 1e-2, each module's gradient norm rtol 5e-2,
    1e-1 after the first step (the CPU test's later-step bound)."""
    import copy

    from ocrs_models_torch import ops
    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_recognition_steps

    torch.manual_seed(SEED)
    model = RecognitionModel(n_classes=97, gru_hidden=gru_hidden, dtype=dtype).to(dev)
    plain_model = copy.deepcopy(model)
    batch = rec_batch(256, 256, 24, dev) if batch is None else batch
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
            per_step = []
            for _ in range(steps):
                state, metrics = train_step(state, batch, lr)
                per_step.append(metrics)
            torch.cuda.synchronize()
        finally:
            for p in patches:
                p.stop()
        counts = _counts()
        _expect(counts, {} if plain else train_launches(gru_hidden), steps,
                f"train step (plain={plain})")
        results.append(per_step)
    bf16 = dtype == BF16
    diffs = [(a - b).abs() for a, b in zip(model.parameters(), plain_model.parameters())]
    n_far = sum(int((d > 1e-5).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    max_diff = max(d.max().item() for d in diffs)
    ok = steps > 1 or bf16 or (n_far <= 0.01 * n_all and max_diff <= 2 * lr + 1e-6)
    ok = ok and (bf16 or max_diff <= 2 * lr * steps + 1e-6)
    for i, (got, want) in enumerate(zip(*results)):
        first = i == 0
        loss_rel = abs(got["loss"].item() / want["loss"].item() - 1)
        norm_rel = abs(got["grad_norm"].item() / want["grad_norm"].item() - 1)
        module_rel = {k: abs(v.item() / want["grad_norms"][k].item() - 1)
                      for k, v in got["grad_norms"].items()}
        line = {"path": f"train_step vs plain{' bf16' if bf16 else ''}{tag}",
                "loss": got["loss"].item(), "loss_plain": want["loss"].item(),
                "loss_rel": loss_rel, "grad_norm": got["grad_norm"].item(),
                "grad_norm_rel": norm_rel, "module_grad_norm_rel_max": max(module_rel.values()),
                "params_far_frac": n_far / n_all, "params_max_diff": max_diff}
        if gru_hidden != 256 or steps > 1:
            line.update(gru_hidden=gru_hidden, step=i + 1, of_steps=steps)
        print(json.dumps(line), flush=True)
        if bf16:
            ok = ok and loss_rel <= 1e-2 and all(v <= (5e-2 if first else 1e-1)
                                                 for v in module_rel.values())
        else:
            ok = ok and loss_rel <= (1e-5 if first else 1e-3) and norm_rel <= (
                1e-3 if first else 5e-2)
        if not ok:
            raise AssertionError(f"the {'bf16 ' if bf16 else ''}training step with kernels "
                                 f"disagrees with the plain step at step {i + 1}: {module_rel}")


def run_training(dev, dtype=torch.float32, wide_steps: int = 10, gru_hidden: int = 256,
                 lr: float = 1e-3) -> dict:
    """Phase 8's main path in ``dtype``: headline and wide steps, and in
    float32 at the shipped width also grad_accum=4 and eval steps. Each
    step's time is also read on the device's timeline (CUDA events between
    step starts), for a median and a spread, and the peak memory of the
    timed steps. ``gru_hidden``: the biGRU's width (phase 18: 512, 1024
    and 2048); ``lr``: Adam's learning rate."""
    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_recognition_steps

    torch.manual_seed(SEED + 1)
    model = RecognitionModel(n_classes=97, gru_hidden=gru_hidden, dtype=dtype).to(dev)
    state = create_train_state(model, grad_clip_norm=4.0)
    tag = (" bf16" if dtype == BF16 else "") + (f" H={gru_hidden}" if gru_hidden != 256 else "")
    train_step, eval_step = make_recognition_steps(model)
    report = {}

    def timed(batch, steps, what, step_fn=train_step, per_step=train_launches(gru_hidden)):
        nonlocal state
        state, _ = step_fn(state, batch, lr)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
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
                "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
                "losses": losses, "launches": counts}
        if gru_hidden != 256:
            line["forms"] = _form_counts()
            line["phase_launches"] = _phase_counts()
        print(json.dumps(line), flush=True)
        return line

    head = rec_batch(256, 256, 24, dev)
    line = timed(head, 10, f"train_step{tag} headline 256x64x256")
    if not line["losses"][-1] < line["losses"][0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {line['losses']}")
    report["headline"] = line
    report["wide"] = timed(rec_batch(128, 1024, 48, dev, seed=1), wide_steps,
                           f"train_step{tag} wide 128x64x1024")
    if dtype == BF16 or gru_hidden != 256:
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


def run_trainer(step_rates: dict, keep: Path) -> dict[str, dict[str, int]]:
    """Phase 9: the trainer CLI ``training/train_rec.py`` on synthetic
    lines, in a temporary directory: (a) three epochs at the JAX defaults
    (bf16, as the JAX trainer's), (b) a resume for one more epoch, (c)
    ``--validate-only``, (d) two epochs at batch 128 in bf16 with and
    without augmentation and in float32 (``--no-bf16``) without, for the
    trainer's rate against the bare step's (``step_rates``, phase 8's wide
    step at batch 128 by dtype), then the host's share of it. Copies (a)
    and (b)'s checkpoint to ``keep / "rec.pt"`` for phase 14. Returns the
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
            shutil.copy("text-rec-checkpoint.pt", keep / "rec.pt")
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


def run_layout_trainer(keep: Path) -> dict:
    """Phase 11 (c): the layout trainer CLI in a temporary directory, at its
    defaults (bf16, batch 64, 500 words) on ``synthetic-doc`` cut to 32
    pages (one step an epoch, 32 validation pages; drawing a page takes
    over 0.1 s of Python, which bounds this phase): three epochs (every
    loss finite, epoch 2's train loss below epoch 0's, a checkpoint, three
    metrics records); a resume for one more epoch with the Adam step
    restored; ``--validate-only``; ``--export layout.pt``; then
    ``eval_layout`` on a page written by ``write_corpus``, whose PNG must
    decode. Copies the checkpoint to ``keep / "layout.pt"`` for phase 14."""
    import math
    import os
    import tempfile

    from ocrs_models_torch.data.layout_synth import write_corpus
    from ocrs_models_torch.training import eval_layout, train_layout
    from ocrs_models_torch.utils.render import read_png

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
            shutil.copy("text-layout-checkpoint.pt", keep / "layout.pt")
            n_exported = sum(v.numel() for v in exported["model_state"].values())
            if n_exported != LAYOUT_PARAMS or exported["optimizer_state"] != {}:
                raise AssertionError(f"--export layout.pt: {n_exported} parameters")

            write_corpus("pages", 1, seed=SEED)
            lines, _, _, seconds = _cli(eval_layout, ["pages/page-00000.json", "page.png",
                                                      "--checkpoint", "layout.pt",
                                                      "--colors", "labels"])
            height, width, _ = read_png("page.png").shape
            print(json.dumps({"path": "train_layout --validate-only, --export, eval_layout",
                              "val_line": line, "eval_line": lines[-1] if lines else "",
                              "png": [width, height], "eval_seconds": seconds}), flush=True)
        finally:
            os.chdir(cwd)
    return {"epochs": len(epochs)}


# ---------------------------------------------------------- detection (12, 13)

DET_TRAIN_BATCH = 4  # the detection trainer's batch
DET_TRAIN_SIZE = (800, 600)  # its mask (height, width)
DET_STEPS = 10  # timed steps a dtype
DET_TRAIN_IMAGES = 16  # phase 13's trainer: 4 steps an epoch, 10 validation pages
DET_PARAMS = 622122
DET_LR = 1e-3


def _records_ms(times: dict, records: dict, calls: int) -> float | None:
    """Device ms per call: every delivered record's time over the calls (a
    lower bound where the profiler drops records); None without records."""
    if not times:
        return None
    return sum(times[k] * records[k] for k in times) / calls


def _det_batch(n: int, seed: int) -> dict:
    """``n`` synthetic pages at the trainer's size, collated (numpy)."""
    from ocrs_models_torch.data import SyntheticDetection, collate_detection

    ds = SyntheticDetection(size=n, page_size=DET_TRAIN_SIZE, seed=seed)
    batch = collate_detection([ds[i] for i in range(n)])
    return {k: batch[k] for k in ("image", "mask", "sample_weight")}


def _det_model(dtype=torch.float32):
    from ocrs_models_torch.models import DetectionModel

    torch.manual_seed(SEED + 3)
    return DetectionModel(dtype=dtype)


def check_detection_step(dev) -> None:
    """Phase 12 (a): one ``make_detection_steps`` step on the card against
    the same step on the CPU from the same weights, at ``[4, 1, 800, 600]``
    in each dtype: loss, grad norm, each module's grad norm and the updated
    parameters (f32 without TF32: loss 1e-4 relative, grad norm 1e-3,
    module norms 2e-2 (a max-pool window whose candidates tie within the
    float noise routes its gradient to the other one), parameters within
    ``2 * lr`` (Adam's first step is about ``+-lr`` an entry); bf16: loss
    1e-2, grad norm 1e-1, module norms 2.5e-1, parameters within ``2 *
    lr``). Then ``grad_accum=4`` on the card against its four microbatches
    run one by one through the model and the balanced BCE from the same
    weights (in training, batch norm normalises each microbatch by its
    own statistics, and each microbatch has its own pools): loss 1e-5
    relative, grad norm 1e-4."""
    import copy

    from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss
    from ocrs_models_torch.training.state import create_train_state, global_norm
    from ocrs_models_torch.training.steps import make_detection_steps, numerics

    batch = _det_batch(DET_TRAIN_BATCH, SEED)
    limits = {"f32": (1e-4, 1e-3, 2e-2), "bf16": (1e-2, 1e-1, 2.5e-1)}
    for dtype, name in ((torch.float32, "f32"), (BF16, "bf16")):
        model = _det_model(dtype)
        out = []
        t0 = time.perf_counter()
        for device in (torch.device("cpu"), dev):
            m = copy.deepcopy(model).to(device)
            train, _ = make_detection_steps(m)
            _, metrics = train(create_train_state(m), batch, DET_LR)
            out.append((metrics, {k: v.float().cpu() for k, v in m.state_dict().items()}))
        (cpu, cpu_sd), (card, card_sd) = out
        loss_rel = abs(card["loss"].item() / cpu["loss"].item() - 1)
        norm_rel = abs(card["grad_norm"].item() / cpu["grad_norm"].item() - 1)
        module_rel = {k: abs(v.item() / cpu["grad_norms"][k].item() - 1)
                      for k, v in card["grad_norms"].items()}
        param_diff = max(float((card_sd[k] - v).abs().max()) for k, v in cpu_sd.items()
                         if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
        max_loss, max_norm, max_module = limits[name]
        print(json.dumps({"path": f"detection step {name} card vs CPU",
                          "shape": [DET_TRAIN_BATCH, 1, *DET_TRAIN_SIZE],
                          "loss": card["loss"].item(), "loss_cpu": cpu["loss"].item(),
                          "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                          "module_norm_rel_max": max(module_rel.values()),
                          "param_max_diff": param_diff,
                          "limits": {"loss_rel": max_loss, "grad_norm_rel": max_norm,
                                     "module_norm_rel": max_module, "param": 2 * DET_LR},
                          "seconds": time.perf_counter() - t0}), flush=True)
        if not (loss_rel <= max_loss and norm_rel <= max_norm
                and max(module_rel.values()) <= max_module and param_diff <= 2 * DET_LR + 1e-6):
            raise AssertionError(f"the {name} detection step on the card disagrees with the CPU: "
                                 f"{loss_rel}, {norm_rel}, {module_rel}, {param_diff}")

    model = _det_model().to(dev)
    parts = []
    with numerics():
        for i in range(4):
            m = copy.deepcopy(model).train()
            mb = {k: torch.from_numpy(v[i::4]).to(dev) for k, v in batch.items()}
            loss = balanced_cross_entropy_loss(m(mb["image"]), mb["mask"], mb["sample_weight"])
            loss.backward()
            parts.append((loss.detach(), [p.grad for p in m.parameters()]))
    want_loss = sum(loss for loss, _ in parts) / 4
    want_norm = global_norm([sum(g) / 4 for g in zip(*(grads for _, grads in parts))])
    train, _ = make_detection_steps(model, grad_accum=4)
    _, metrics = train(create_train_state(model), batch, DET_LR)
    loss_rel = abs(metrics["loss"].item() / want_loss.item() - 1)
    norm_rel = abs(metrics["grad_norm"].item() / want_norm.item() - 1)
    print(json.dumps({"path": "detection grad_accum=4 vs its microbatches", "loss_rel": loss_rel,
                      "grad_norm_rel": norm_rel}), flush=True)
    if not (loss_rel <= 1e-5 and norm_rel <= 1e-4):
        raise AssertionError(f"detection grad_accum=4: loss {loss_rel}, grad norm {norm_rel}")


def run_detection_training(dev, dtype) -> dict:
    """Phase 12 (b): the detection step at ``[4, 1, 800, 600]`` as the
    trainer runs it (lr 1e-3): one warm-up step, then timed steps on a fixed
    batch, whose loss must fall; each step on the device's timeline (CUDA
    events between step starts), pages/s on the host clock, peak memory,
    and the kernels, copies and sets one step puts on the device
    (``torch.profiler``). The detector launches none of the port's
    kernels."""
    from ocrs_models_torch.data.loader import to_device
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_detection_steps

    model = _det_model(dtype).to(dev)
    state = create_train_state(model)
    train, _ = make_detection_steps(model)
    batch = to_device(_det_batch(DET_TRAIN_BATCH, SEED + 1), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = train(state, batch, DET_LR)
    torch.cuda.synchronize()
    _zero_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(DET_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    for i in range(DET_STEPS):
        marks[i].record()
        state, metrics = train(state, batch, DET_LR)
        losses.append(metrics["loss"])
    marks[-1].record()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [v.item() for v in losses]
    launches, times, records = _device_profile(lambda: train(state, batch, DET_LR), calls=2)
    tag = "bf16" if dtype == BF16 else "f32"
    line = {"path": f"detection train_step {tag} {DET_TRAIN_BATCH}x{DET_TRAIN_SIZE[0]}x"
                    f"{DET_TRAIN_SIZE[1]}",
            "steps": DET_STEPS, "seconds": elapsed,
            "pages_per_s": DET_TRAIN_BATCH * DET_STEPS / elapsed,
            "ms_per_step": 1e3 * elapsed / DET_STEPS,
            "step_ms_median": float(np.median(step_ms)), "step_ms_min": min(step_ms),
            "step_ms_max": max(step_ms), "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "device_launches_per_step": launches,
            "device_busy_ms_per_step": _records_ms(times, records, 2),
            "losses": losses, "launches": counts}
    print(json.dumps(line), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"detection {tag} step: the loss did not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"the detection step launched the port's kernels: {counts}")
    return line


def time_balanced_loss(dev) -> dict:
    """Phase 12 (c): the balanced BCE alone at ``[4, 1, 800, 600]``, forward
    and backward: ms by CUDA events, its device time and the kernels,
    copies and sets it puts on the device (``torch.profiler``), and no
    host sync: it runs under ``torch.cuda.set_sync_debug_mode("error")``."""
    from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss

    batch = _det_batch(DET_TRAIN_BATCH, SEED)
    mask = torch.from_numpy(batch["mask"]).to(dev)
    weight = torch.from_numpy(batch["sample_weight"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pred = torch.rand(mask.shape, device=dev, generator=gen).requires_grad_()

    def call():
        loss = balanced_cross_entropy_loss(pred, mask, weight)
        loss.backward()
        return loss

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = _cuda_time_ms(call, iters=10)
    launches, times, records = _device_profile(call, calls=5)
    n = mask.numel()
    line = {"path": "balanced BCE forward+backward", "shape": list(mask.shape), "ms": ms,
            "device_ms": _records_ms(times, records, 5),
            "device_launches_per_call": launches,
            # The least traffic: pred and mask read, d pred written (f32).
            "bound_ms": _bound(3 * 4 * n, 0)[0]}
    print(json.dumps(line), flush=True)
    return line


def _data_host_ms(n: int = 8) -> dict:
    """Host ms per 800x600 page: drawing a synthetic page with its mask,
    and the trainer's augmentation (each of its four branches, and the
    resize alone)."""
    from ocrs_models_torch.data import SyntheticDetection
    from ocrs_models_torch.data import augment

    ds = SyntheticDetection(size=n, page_size=DET_TRAIN_SIZE, seed=SEED)
    t0 = time.perf_counter()
    pages = [ds[i] for i in range(n)]
    out = {"page_ms": 1e3 * (time.perf_counter() - t0) / n}
    for branch in ("_color_jitter", "_affine", "_perspective", "_random_crop"):
        t0 = time.perf_counter()
        for i, page in enumerate(pages):
            imgs = getattr(augment, branch)(np.random.default_rng(i), [page["image"], page["mask"]])
            augment.resize(imgs[0], DET_TRAIN_SIZE), augment.resize(imgs[1], DET_TRAIN_SIZE)
        out[f"{branch.strip('_')}_ms"] = 1e3 * (time.perf_counter() - t0) / n
    return out


def run_detection_trainer(keep: Path) -> dict:
    """Phase 13: the detection trainer CLI in a temporary directory at its
    defaults (bf16, batch 4, 800x600, augmented) on ``synthetic`` cut to
    16 pages (4 steps an epoch, 10 validation pages): three epochs (every
    loss finite, epoch 2's train loss below epoch 0's, a checkpoint, three
    metrics records); a resume for one more epoch with the Adam step
    restored; ``--validate-only``; then ``eval_detection`` on a synthetic
    page of 1000x750 saved as PNG, whose four PNGs must decode at their
    sizes (input and probabilities at 800x600, regions and words at the
    page's). Prints the host ms per page of the data. Copies the checkpoint
    to ``keep / "det.pt"`` for phase 14."""
    import os
    import tempfile

    from ocrs_models_torch.data import SyntheticDetection
    from ocrs_models_torch.training import eval_detection, train_detection
    from ocrs_models_torch.utils.render import read_png, write_png

    data = ["synthetic", "-", "--max-images", str(DET_TRAIN_IMAGES)]
    steps = DET_TRAIN_IMAGES // DET_TRAIN_BATCH
    host = _data_host_ms()
    print(json.dumps({"path": "detection data host ms per 800x600 page", **host}), flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as run_dir:
        os.chdir(run_dir)
        try:
            lines, state, counts, seconds = _cli(train_detection, [*data, "--max-epochs", "3"])
            records = [json.loads(r) for r in
                       Path("text-detection-metrics.jsonl").read_text().splitlines()]
            epochs = [r for r in records if "epoch" in r]
            losses = [r["train_loss"] for r in epochs]
            if [r["epoch"] for r in epochs] != [0, 1, 2] or not all(
                    np.isfinite([v for r in epochs for v in (r["train_loss"], r["val_loss"])])):
                raise AssertionError(f"train_detection: epoch records {epochs}")
            if not losses[2] < losses[0]:
                raise AssertionError(f"train_detection: the train loss did not fall: {losses}")
            if f"Model param count: {DET_PARAMS}" not in lines or state.model.dtype != BF16:
                raise AssertionError("train_detection: not the full-width bf16 detection model")
            if any(counts.values()):
                raise AssertionError(f"train_detection launched the port's kernels: {counts}")
            print(json.dumps({"path": "train_detection synthetic 3 epochs", "dtype": "bf16",
                              "batch": DET_TRAIN_BATCH, "pages": DET_TRAIN_IMAGES,
                              "seconds": seconds, "train_loss": losses,
                              "val_loss": [r["val_loss"] for r in epochs],
                              "val_metrics": epochs[-1]["val_metrics"]}), flush=True)

            ckpt = torch.load("text-detection-checkpoint.pt", map_location="cpu",
                              weights_only=True)
            epoch = ckpt["epoch"]
            adam = {float(v["step"]) for v in ckpt["optimizer_state"]["state"].values()}
            if ckpt["step"] != steps * epoch or adam != {float(steps * epoch)} or epoch < 1:
                raise AssertionError(f"checkpoint: epoch {epoch}, step {ckpt['step']}, Adam {adam}")
            lines, state, _, seconds = _cli(train_detection, [
                *data, "--checkpoint", "text-detection-checkpoint.pt",
                "--max-epochs", str(epoch + 1)])
            records = [json.loads(r) for r in
                       Path("text-detection-metrics.jsonl").read_text().splitlines()]
            last = [r for r in records if "epoch" in r][-1]
            adam_step = float(state.optimizer.adam.state_dict()["state"][0]["step"])
            if (state.step, adam_step, last["epoch"]) != (steps * (epoch + 1),
                                                          float(steps * (epoch + 1)), epoch):
                raise AssertionError(f"resume: step {state.step}, Adam {adam_step}, "
                                     f"epoch {last['epoch']}; from epoch {epoch}")
            print(json.dumps({"path": f"train_detection resumed, epoch {epoch}",
                              "seconds": seconds, "train_loss": last["train_loss"],
                              "val_loss": last["val_loss"]}), flush=True)

            lines, _, _, _ = _cli(train_detection, [
                *data, "--checkpoint", "text-detection-checkpoint.pt", "--validate-only"])
            val = [ln for ln in lines if ln.startswith(("Validation loss", "Validation metrics"))]
            if len(val) != 2:
                raise AssertionError(f"--validate-only printed {lines}")
            shutil.copy("text-detection-checkpoint.pt", keep / "det.pt")

            page = SyntheticDetection(size=1, page_size=(1000, 750), seed=SEED)[0]["image"]
            write_png("page.png", ((page[..., 0] + 0.5) * 255).round().astype(np.uint8))
            lines, _, _, seconds = _cli(eval_detection, ["text-detection-checkpoint.pt",
                                                         "page.png", "out"])
            sizes = {}
            for part, want in (("input", DET_TRAIN_SIZE), ("text-probs", DET_TRAIN_SIZE),
                               ("text-regions", (1000, 750)), ("text-words", (1000, 750))):
                img = read_png(f"out-{part}.png")
                sizes[part] = list(img.shape)
                if img.shape[:2] != want:
                    raise AssertionError(f"eval_detection {part}: {img.shape}, expected {want}")
            print(json.dumps({"path": "train_detection --validate-only, eval_detection",
                              "val_lines": val, "eval_line": lines[-1] if lines else "",
                              "png_shapes": sizes, "eval_seconds": seconds}), flush=True)
        finally:
            os.chdir(cwd)
    return {"epochs": len(epochs), **host}


# ------------------------------------------------------------- export (14)

EXPORT_ATOL = {"detection": 2e-4, "recognition": 2e-4, "layout": 5e-4}  # tests/test_torch_export.py
EXPORT_ARGMAX_EQUAL = 0.999  # the recognizer's share of equal argmaxes
EXPORT_REC_SHAPES = ((8, 256), (3, 96))  # (batch, width): both dynamic axes, two W//4+1
EXPORT_LAYOUT_PAGES = 2


def _export_cases() -> list[tuple]:
    """(model, trainer, its data arguments, checkpoint, input, output)."""
    from ocrs_models_torch.training import train_detection, train_layout, train_rec

    return [
        ("recognition", train_rec, ["synthetic", "-"], "rec.pt",
         ("line_image", ["batch", 1, 64, "seq"]), ("chars", ["out_seq", "batch", 97])),
        ("layout", train_layout, ["synthetic-doc", "--max-images", str(LAYOUT_TRAIN_IMAGES)],
         "layout.pt", ("word_boxes", ["batch", "box", 4]), ("preds", ["batch", "box", 2])),
        ("detection", train_detection, ["synthetic", "-", "--max-images", str(DET_TRAIN_IMAGES)],
         "det.pt", ("image", ["batch", 1, *DET_TRAIN_SIZE]), ("mask", ["batch", 1, *DET_TRAIN_SIZE])),
    ]


def _export_inputs(model: str) -> list[np.ndarray]:
    """The inputs each exported graph is evaluated on: one 800x600 page;
    line crops at two batches and widths; 500 word boxes on two pages."""
    rng = np.random.default_rng(SEED + 14)
    if model == "detection":
        return [synthetic_page(rng, *DET_TRAIN_SIZE)[None, None, :, :, 0]]
    if model == "recognition":
        return [np.stack([synthetic_crop(rng, w)[None, :, :, 0] for _ in range(n)])
                for n, w in EXPORT_REC_SHAPES]
    from ocrs_models_torch.data import SyntheticLayout

    ds = SyntheticLayout(size=EXPORT_LAYOUT_PAGES, n_words=LAYOUT_WORDS, seed=SEED + 14)
    return [np.stack([ds[i][0] for i in range(EXPORT_LAYOUT_PAGES)]).astype(np.float32)]


def run_export(dev, keep: Path) -> None:
    """Phase 14: each trainer's ``--checkpoint <phase 9/11/13's checkpoint>
    --export`` to ``.onnx`` and ``.npz``; each graph checked, parsed, its
    inputs and outputs the reference's, and run by the port's numpy
    evaluator on the host against the float32 forward on the card (TF32
    off) from the same checkpoint; each ``.npz`` mapped back through
    ``weights.*_state_dict_from_jax`` into a fresh model, strictly, every
    tensor equal to the checkpoint's but ``num_batches_tracked``; then one
    ``python -m ocrs_models_torch.export convert``, whose graph must equal
    the trainer's."""
    from ocrs_models_torch import weights
    from ocrs_models_torch.export import __main__ as convert_cli
    from ocrs_models_torch.export.onnx_check import check_bytes
    from ocrs_models_torch.export.onnx_eval import run_graph
    from ocrs_models_torch.training.export_utils import read_npz
    from ocrs_models_torch.training.steps import numerics

    cwd = os.getcwd()
    os.chdir(keep)
    try:
        for model, trainer, data, ckpt, (in_name, in_dims), (out_name, out_dims) in _export_cases():
            seconds = {}
            for ext in ("onnx", "npz"):
                lines, result, counts, seconds[ext] = _cli(
                    trainer, [*data, "--checkpoint", ckpt, "--export", f"{model}.{ext}"])
                if result is not None or any(counts.values()):
                    raise AssertionError(f"{model} --export {ext}: {result}, launches {counts}")
            parsed = check_bytes(Path(f"{model}.onnx").read_bytes())
            if (parsed.graph.inputs, parsed.graph.outputs) != ([(in_name, in_dims)],
                                                               [(out_name, out_dims)]):
                raise AssertionError(f"{model}.onnx: inputs {parsed.graph.inputs}, "
                                     f"outputs {parsed.graph.outputs}")

            sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state"]
            net = convert_cli.default_model(model)
            net.load_state_dict(sd, strict=True)
            net = net.to(dev).eval()
            err, eval_seconds, equal, shapes = 0.0, 0.0, [], []
            for x in _export_inputs(model):
                _zero_counts()
                with torch.no_grad(), numerics():
                    want = net(torch.from_numpy(x).to(dev)).cpu().numpy()
                counts = _counts()
                if model == "recognition":
                    _expect(counts, EVAL_LAUNCHES | {"ctc_alpha": 0}, 1, "recognizer forward")
                    want = want.transpose(1, 0, 2)  # [N, T, C] -> the graph's [T, N, C]
                t0 = time.perf_counter()
                got = run_graph(parsed, {in_name: x})[out_name]
                eval_seconds += time.perf_counter() - t0
                if got.shape != want.shape or not np.isfinite(got).all():
                    raise AssertionError(f"{model}: graph {got.shape}, forward {want.shape}")
                err = max(err, float(np.abs(got - want).max()))
                shapes.append(list(x.shape))
                if model == "recognition":
                    equal.append(float((got.argmax(-1) == want.argmax(-1)).mean()))
            if not err <= EXPORT_ATOL[model] or not all(e >= EXPORT_ARGMAX_EQUAL for e in equal):
                raise AssertionError(f"{model}.onnx vs the card's forward: max_abs_err {err}, "
                                     f"argmax equal {equal}")

            to_port = getattr(weights, f"{model}_state_dict_from_jax")
            fresh = convert_cli.default_model(model)
            fresh.load_state_dict(to_port(read_npz(f"{model}.npz")), strict=True)
            for key, value in sd.items():
                if not key.endswith("num_batches_tracked") and not torch.equal(
                        fresh.state_dict()[key], value):
                    raise AssertionError(f"{model}.npz round trip: {key} differs")
            print(json.dumps({
                "path": "export", "model": model, "onnx_bytes": Path(f"{model}.onnx").stat().st_size,
                "npz_bytes": Path(f"{model}.npz").stat().st_size, "nodes": len(parsed.graph.nodes),
                "export_seconds": seconds, "eval_seconds": eval_seconds, "inputs": shapes,
                "max_abs_err": err, "atol": EXPORT_ATOL[model],
                **({"argmax_equal": equal} if equal else {})}), flush=True)
            del net, fresh
            torch.cuda.empty_cache()

        _, rc, _, seconds = _cli(convert_cli, ["convert", "recognition", "rec.pt", "convert.onnx"])
        if rc != 0 or Path("convert.onnx").read_bytes() != Path("recognition.onnx").read_bytes():
            raise AssertionError("convert recognition rec.pt: not the trainer's graph")
        print(json.dumps({"path": "export convert", "model": "recognition", "seconds": seconds,
                          "onnx_bytes": Path("convert.onnx").stat().st_size}), flush=True)
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------- phase 15

DP_STEPS = 3  # phase 15 (a): steps held bit for bit against the plain step
DP_TIMED = 10  # phase 15 (a): timed steps of each path (two turns of 5)
DP_REC_ROWS = 64  # phase 15 (b): recognition rows a rank
DP_DET_PAGES = 2  # phase 15 (b): detection pages a rank
REC_PARAMS = 2426913
REC_BN_STATS = 2 * (64 + 128 + 128 + 128)  # running means and variances
KERNEL_ROWS = {("stage1_fwd", "f32"), ("stage1_bwd", "f32"), ("gru_fwd", "f32"),
               ("gru_bwd", "f32"), ("ctc_alpha", "f32"), ("ctc_beta", "f32"),
               ("stage1_fwd", "bf16"), ("stage1_bwd", "bf16"), ("gru_fwd", "bf16"),
               ("gru_bwd", "bf16")}


def _rec_model(dev, dtype=torch.float32):
    from ocrs_models_torch.models import RecognitionModel

    torch.manual_seed(SEED + 5)
    return RecognitionModel(n_classes=97, dtype=dtype).to(dev)


def _digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step_ms(step, state, batch, lr, steps: int) -> list[float]:
    """The device time of each of ``steps`` steps (CUDA events between step
    starts), after one warm-up step."""
    step(state, batch, lr)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    for i in range(steps):
        marks[i].record()
        step(state, batch, lr)
    marks[-1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def _spread(ms: list[float]) -> dict:
    return {"median": float(np.median(ms)), "min": min(ms), "max": max(ms)}


def _world1_rank(rank: int, world: int, device) -> dict:
    """Phase 15 (a), in the one rank of an NCCL process group: each
    model's step through its collective path against its plain step, from
    the same weights on the same batch. The recognizer (``force_shard_map``)
    at ``[256, 1, 64, 256]`` in both dtypes, ``DP_STEPS`` steps under
    deterministic algorithms (cuDNN's default choices are not bit-stable
    from run to run): losses, parameters and running statistics bit-equal;
    then ``DP_TIMED`` timed steps of each in turns (plain, collective,
    collective, plain) at the default settings, and the device launches of
    one step of each. Detection at ``[4, 1, 800, 600]`` and layout at 64 x
    500 words, f32, one step each: within the bounds of phases 12 and 11."""
    import copy

    import torch.distributed as dist

    from ocrs_models_torch.parallel import create_mesh
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import (
        make_detection_steps,
        make_layout_steps,
        make_recognition_steps,
    )

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's deterministic mode
    mesh = create_mesh()
    out = {"backend": dist.get_backend(), "mesh_size": mesh.size, "device": str(device)}
    lr = 1e-3
    batch = rec_batch(256, 256, 24, device)
    for dtype, name in ((torch.float32, "f32"), (BF16, "bf16")):
        models = {"plain": _rec_model(device, dtype)}
        models["collective"] = copy.deepcopy(models["plain"])
        runs = {}
        for key, kw in (("plain", {}), ("collective", {"mesh": mesh, "force_shard_map": True})):
            runs[key] = (create_train_state(models[key], grad_clip_norm=4.0),
                         make_recognition_steps(models[key], **kw)[0])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            losses = {k: [step(st, batch, lr)[1]["loss"].item() for _ in range(DP_STEPS)]
                      for k, (st, step) in runs.items()}
        finally:
            torch.use_deterministic_algorithms(False)
        sd = {k: m.state_dict() for k, m in models.items()}
        equal = (losses["plain"] == losses["collective"]
                 and all(torch.equal(sd["plain"][k], sd["collective"][k]) for k in sd["plain"]))
        if not equal:
            raise AssertionError(f"world-1 {name} collective step differs from the plain step: "
                                 f"losses {losses}")
        ms = {"plain": [], "collective": []}
        for key in ("plain", "collective", "collective", "plain"):
            st, step = runs[key]
            ms[key] += _step_ms(step, st, batch, lr, DP_TIMED // 2)
        launches = {k: _device_profile(lambda: step(st, batch, lr), calls=3)[0]
                    for k, (st, step) in runs.items()}
        out[f"rec_{name}"] = {
            "bit_equal_steps": DP_STEPS, "losses": losses["plain"],
            "plain_ms": _spread(ms["plain"]), "collective_ms": _spread(ms["collective"]),
            "launches_per_step": launches,
            "extra_launches_per_step": launches["collective"] - launches["plain"],
            "allreduce_bytes": [4 * (2 + REC_PARAMS), 4 * REC_BN_STATS]}

    def pair(make_model, make_steps, batch, bounds):
        models = {"plain": make_model().to(device)}
        models["mesh"] = copy.deepcopy(models["plain"])
        res = {}
        for key, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
            st = create_train_state(models[key])
            step = make_steps(models[key], **kw)[0]
            res[key] = step(st, batch, lr)[1]
            res[key + "_ms"] = _spread(_step_ms(step, st, batch, lr, 3))
        loss_rel = abs(res["mesh"]["loss"].item() / res["plain"]["loss"].item() - 1)
        norm_rel = abs(res["mesh"]["grad_norm"].item() / res["plain"]["grad_norm"].item() - 1)
        if not (loss_rel <= bounds[0] and norm_rel <= bounds[1]):
            raise AssertionError(f"world-1 mesh step: loss {loss_rel}, grad norm {norm_rel}")
        return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                "loss_equal": res["mesh"]["loss"].item() == res["plain"]["loss"].item(),
                "plain_ms": res["plain_ms"], "mesh_ms": res["mesh_ms"]}

    from ocrs_models_torch.data.loader import to_device

    out["detection_f32"] = pair(_det_model, make_detection_steps,
                                to_device(_det_batch(DET_TRAIN_BATCH, SEED), device), (1e-4, 1e-3))
    out["layout_f32"] = pair(lambda: _layout_model(dropout=False), make_layout_steps,
                             _layout_batch(LAYOUT_BATCH, SEED, device), (1e-6, 1e-5))
    return out


def _gloo_rank(rank: int, world: int, device) -> dict:
    """Phase 15 (b), in one of two ``gloo`` ranks sharing the card: two
    steps of the recognizer (f32, ``DP_REC_ROWS`` rows a rank of a
    ``[128, 1, 64, 256]`` batch) and of the detector (f32,
    ``DP_DET_PAGES`` pages a rank of ``[4, 1, 800, 600]``), each rank on its
    contiguous half. Returns the first step's metrics (rank 0 also the
    weights after it), each step's host ms, the digests after the second
    step and the kernel launches of the recognizer's two steps."""
    from ocrs_models_torch.parallel import create_mesh, replicate_tree
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_detection_steps, make_recognition_steps

    mesh = create_mesh(devices=[device])
    out = {}
    lr = 1e-3
    rec = rec_batch(2 * DP_REC_ROWS, 256, 24, device)
    det = {k: torch.from_numpy(v).to(device) for k, v in _det_batch(4, SEED).items()}
    cases = (
        ("rec", lambda: _rec_model(device), make_recognition_steps, 4.0, rec, DP_REC_ROWS),
        ("det", lambda: _det_model().to(device), make_detection_steps, None, det, DP_DET_PAGES),
    )
    for name, make_model, make_steps, clip, batch, per in cases:
        local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        model = make_model()
        replicate_tree(model, mesh)
        state = create_train_state(model, grad_clip_norm=clip)
        step = make_steps(model, mesh=mesh)[0]
        _zero_counts()
        ms = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(state, local, lr)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                out[name] = {"loss": metrics["loss"].item(),
                             "grad_norm": metrics["grad_norm"].item(),
                             "grad_norms": {k: v.item() for k, v in metrics["grad_norms"].items()}}
                if rank == 0:
                    out[name]["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
        out[name].update(ms=ms, digest=_digest(model), launches=_counts())
    return out


def _emulate_shards(dev, batch, halves: int, lr: float):
    """The recognizer's collective step on one process: each half of
    ``batch`` through the model and the CTC loss on its own (its own
    batch-norm statistics), the loss sums and gradients added, the running
    statistics averaged, then the division, clip and Adam of the step."""
    from ocrs_models_torch.ops import ctc_loss_forward
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import numerics

    model = _rec_model(dev)
    state = create_train_state(model, grad_clip_norm=4.0)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    start = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    stats = [[torch.zeros_like(a), torch.zeros_like(b)] for a, b in start]
    model.train()
    state.optimizer.zero_grad()
    num = den = 0.0
    per = batch["image"].shape[0] // halves
    with numerics():
        for h in range(halves):
            part = {k: v[h * per:(h + 1) * per] for k, v in batch.items()}
            for m, (a, b) in zip(bns, start):
                m.running_mean.copy_(a)
                m.running_var.copy_(b)
            nll = ctc_loss_forward(model(part["image"]), part["text"],
                                   part["image_width"] // 4, part["text_len"])
            w = part["sample_weight"]
            h_num = torch.sum(nll / part["text_len"].clamp(min=1) * w)
            h_num.backward()
            num, den = num + h_num.detach(), den + torch.sum(w)
            for acc, m in zip(stats, bns):
                acc[0] += m.running_mean / halves
                acc[1] += m.running_var / halves
        with torch.no_grad():
            for m, (a, b) in zip(bns, stats):
                m.running_mean.copy_(a)
                m.running_var.copy_(b)
        den = torch.clamp(den, min=1.0)
        for p in model.parameters():
            p.grad.div_(den)
        norm = state.optimizer.step(lr)
    return (num / den).item(), norm.item(), model.state_dict()


def run_data_parallel(dev, pages, root: Path) -> dict:
    """Phase 15: the data-parallel paths on the one card (NCCL refuses two
    ranks on one card, so real multi-GPU speed is not measured here)."""
    from ocrs_models_torch import ops
    from ocrs_models_torch.parallel import create_mesh, spawn
    from ocrs_models_torch.pipeline import OcrPipeline
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_detection_steps, make_recognition_steps

    report = {}
    # (a) NCCL at world size 1.
    t0 = time.perf_counter()
    (w1,) = spawn(_world1_rank, 1, dev, timeout=600)
    for key in ("rec_f32", "rec_bf16", "detection_f32", "layout_f32"):
        print(json.dumps({"path": f"data parallel world-1 {key}", "backend": w1["backend"],
                          **w1[key]}), flush=True)
    report["world1"] = w1
    print(f"phase 15a seconds {time.perf_counter() - t0:.1f}", flush=True)

    # (b) Two gloo ranks sharing the card.
    t0 = time.perf_counter()
    ranks = spawn(_gloo_rank, 2, dev, share_device=True, timeout=600)
    lr = 1e-3
    rec = rec_batch(2 * DP_REC_ROWS, 256, 24, dev)
    loss, norm, want_sd = _emulate_shards(dev, rec, 2, lr)
    got = ranks[0]["rec"]
    diffs = [(got["state"][k].to(dev).float() - v.float()).abs() for k, v in want_sd.items()
             if not k.endswith("num_batches_tracked")]
    n_far = sum(int((d > 1e-5).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    rec_line = {"path": "data parallel gloo 2 ranks recognition f32 2x64x[1,64,256]",
                "loss": got["loss"], "loss_emulated": loss,
                "loss_rel": abs(got["loss"] / loss - 1),
                "grad_norm_rel": abs(got["grad_norm"] / norm - 1),
                "params_far_frac": n_far / n_all,
                "params_max_diff": max(float(d.max()) for d in diffs),
                "host_ms_per_step": [r["rec"]["ms"] for r in ranks],
                "launches_rank0": ranks[0]["rec"]["launches"]}
    print(json.dumps(rec_line), flush=True)
    if not (rec_line["loss_rel"] <= 1e-5 and rec_line["grad_norm_rel"] <= 1e-3
            and n_far <= 0.01 * n_all and rec_line["params_max_diff"] <= 2 * lr + 1e-6):
        raise AssertionError("2-rank recognition step disagrees with its per-shard emulation")

    det_model = _det_model().to(dev)
    state = create_train_state(det_model)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _det_batch(4, SEED).items()}
    _, want = make_detection_steps(det_model)[0](state, batch, lr)
    got = ranks[0]["det"]
    module_rel = max(abs(got["grad_norms"][k] / v.item() - 1)
                     for k, v in want["grad_norms"].items())
    max_diff = max(float((got["state"][k].to(dev) - v).abs().max())
                   for k, v in det_model.state_dict().items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    det_line = {"path": "data parallel gloo 2 ranks detection f32 2x2x[1,800,600]",
                "loss": got["loss"], "loss_one_process": want["loss"].item(),
                "loss_rel": abs(got["loss"] / want["loss"].item() - 1),
                "grad_norm_rel": abs(got["grad_norm"] / want["grad_norm"].item() - 1),
                "module_grad_norm_rel_max": module_rel, "params_max_diff": max_diff,
                "host_ms_per_step": [r["det"]["ms"] for r in ranks]}
    print(json.dumps(det_line), flush=True)
    if not (det_line["loss_rel"] <= 1e-4 and det_line["grad_norm_rel"] <= 1e-3
            and module_rel <= 2e-2 and max_diff <= 2 * lr + 1e-6):
        raise AssertionError("2-rank detection step disagrees with the one-process step")
    for name in ("rec", "det"):
        if ranks[0][name]["digest"] != ranks[1][name]["digest"]:
            raise AssertionError(f"2-rank {name}: the replicas differ after two steps")
    for r in ranks:
        if not all(r["rec"]["launches"][k] > 0 for k in TRAIN_LAUNCHES):
            raise AssertionError(f"a kernel did not launch in a rank: {r['rec']['launches']}")
    report["gloo"] = {"rec": rec_line, "det": det_line}
    print(f"phase 15b seconds {time.perf_counter() - t0:.1f}", flush=True)

    # (c) Serving over a mesh of the visible cards, against one card; and
    # every kernel row's C entry leaves the thread's device as it was.
    t0 = time.perf_counter()
    rows = set()

    def guarded(fn):
        def call(*args, **kwargs):
            before = torch.cuda.current_device()
            result = fn(*args, **kwargs)
            if torch.cuda.current_device() != before:
                raise AssertionError(f"{fn.__name__} moved the thread's device")
            rows.add((fn.__name__, "bf16" if args[0].dtype == BF16 else "f32"))
            return result
        call.launches = 0  # the wrapper counts through its module's name, now this
        return call

    patches = [mock.patch(f"ocrs_models_torch.ops.{mod}.{k.__name__}", guarded(k))
               for mod, k in (("stage1", ops.stage1_fwd), ("stage1", ops.stage1_bwd),
                              ("gru", ops.gru_fwd), ("gru", ops.gru_bwd),
                              ("ctc", ops.ctc_alpha), ("ctc", ops.ctc_beta))]
    for p in patches:
        p.start()
    try:
        for dtype in (torch.float32, BF16):
            model = _rec_model(dev, dtype)
            step = make_recognition_steps(model)[0]
            step(create_train_state(model), rec_batch(16, 256, 8, dev), lr)
        torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    if rows != KERNEL_ROWS:
        raise AssertionError(f"kernel rows checked {sorted(rows)}")
    # create_mesh(): every visible card (one here); and the card twice, two
    # replicas each serving half of every batch, to run the sharding.
    mesh = create_mesh()
    pipes = {"plain": OcrPipeline(device=dev, seed=SEED),
             "mesh": OcrPipeline(device=dev, seed=SEED, mesh=mesh),
             "mesh_card_twice": OcrPipeline(device=dev, seed=SEED,
                                            mesh=create_mesh(devices=[dev, dev]))}
    served = {}
    for name in ("plain", "mesh", "mesh_card_twice", "mesh_card_twice", "mesh", "plain"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipes[name].run_batch(pages, det_batch=DET_BATCH, rec_batch=REC_BATCH)
        torch.cuda.synchronize()
        served.setdefault(name, []).append((out, len(pages) / (time.perf_counter() - t1)))
    texts = {k: [[ln.text for ln in page] for page in v[-1][0]] for k, v in served.items()}
    if not texts["mesh"] == texts["mesh_card_twice"] == texts["plain"]:
        raise AssertionError("mesh serving differs from one device")
    serve_line = {"path": "data parallel serving OcrPipeline(mesh=create_mesh())",
                  "mesh_devices": [str(d) for d in mesh.devices], "pages": len(pages),
                  "pages_per_s": {k: [r for _, r in v] for k, v in served.items()},
                  "lines": sum(len(p) for p in texts["mesh"]),
                  "kernel_rows_device_restored": len(rows)}
    print(json.dumps(serve_line), flush=True)
    report["serving"] = serve_line
    print(f"phase 15c seconds {time.perf_counter() - t0:.1f}", flush=True)

    # (d) The recognition trainer under torchrun, one rank (NCCL through env://).
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_torchrun_") as tmp:
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH")) if p)}
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "ocrs_models_torch.training.train_rec",
               "synthetic", "-", "--max-images", "20", "--max-epochs", "1", "--no-bf16",
               "--no-augment"]
        done = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"torchrun train_rec failed:\n{done.stdout[-3000:]}\n"
                                 f"{done.stderr[-3000:]}")
        config = json.loads(Path(tmp, "text-recognition-metrics.jsonl").read_text()
                            .splitlines()[0])
        ckpt = torch.load(Path(tmp, "text-rec-checkpoint.pt"), weights_only=True)
        if ckpt["epoch"] != 1 or ckpt["step"] != 1 or config["mesh_devices"] != 1:
            raise AssertionError(f"torchrun train_rec: epoch {ckpt['epoch']}, config {config}")
    print(json.dumps({"path": "data parallel torchrun --nproc-per-node 1 train_rec",
                      "seconds": time.perf_counter() - t0, "checkpoint_epoch": ckpt["epoch"],
                      "step": ckpt["step"]}), flush=True)
    print(f"phase 15d seconds {time.perf_counter() - t0:.1f}", flush=True)
    return report


# ---------------------------------------------------------------- phase 16

TOY_DATA = Path("tests") / "data"  # under the checkout's root
TP_BATCH = 8  # phase 16 (f): layout pages (500 words each) in the tensor-parallel step
TP_LR = 1e-3
TP_GRAD_TOL = 1e-3  # phase 16 (f): each gradient's rtol, and its atol as a share of its max


def _copy_toy(root: Path, name: str, dest: Path) -> str:
    """A fresh copy of the committed toy root ``name`` (the readers write
    their JSONL and crop cache beside it)."""
    shutil.copytree(root / TOY_DATA / name, dest / name)
    return str(dest / name)


def check_decoder(root: Path) -> dict:
    """Phase 16 (a): every committed fixture decoded by ``read_grey`` on
    this machine's host, its greyscale bytes' SHA-256 against the digests
    of Pillow's decode (made where Pillow is installed); then ms per
    megapixel, median of 10, on the 2 MP page and on the 8 toy HierText
    pages."""
    import hashlib
    import statistics

    from ocrs_models_torch.data.imageio import decode_jpeg_grey, read_grey

    digests = json.loads((root / TOY_DATA / "torch_toy_digests.json").read_text())
    for name, want in digests.items():
        got = read_grey(str(root / TOY_DATA / name))
        if (hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]
                or list(got.shape) != want["shape"]):
            raise AssertionError(f"decode of {name} differs from Pillow's")
    out = {"path": "decode", "files_equal_to_pillow": len(digests)}
    for label, paths in (("2mp_page", [root / TOY_DATA / "torch_decode_page.jpg"]),
                         ("toy_pages", sorted((root / TOY_DATA / "torch_hiertext_toy").rglob(
                             "*.jpg")))):
        datas = [p.read_bytes() for p in paths]
        mp = sum(decode_jpeg_grey(d).size for d in datas) / 1e6
        runs = []
        for _ in range(10):
            t0 = time.perf_counter()
            for d in datas:
                decode_jpeg_grey(d)
            runs.append(1e3 * (time.perf_counter() - t0))
        out[f"{label}_megapixels"] = mp
        out[f"{label}_ms_per_mp"] = statistics.median(runs) / mp
    print(json.dumps(out), flush=True)
    return out


def _snapshot(directory: Path) -> dict:
    return {str(p): p.stat().st_mtime_ns for p in directory.rglob("*") if p.is_file()}


def run_real_rec(root: Path, work: Path) -> dict:
    """Phase 16 (b): ``train_rec hiertext`` on the toy root, bf16 (the
    default), batch 4: epoch 1, then a resume for epoch 2. Every launch
    count exact, all six kernels launched, every loss finite, and epoch 2
    reads the crop cache epoch 1 wrote and writes no file in it."""
    import math

    from ocrs_models_torch.data.hiertext import HierTextRecognition
    from ocrs_models_torch.training import train_rec

    ht = _copy_toy(root, "torch_hiertext_toy", work)
    batch = 4
    args = ["hiertext", ht, "--batch-size", str(batch)]
    lines, _, counts, seconds = _cli(train_rec, [*args, "--max-epochs", "1"])
    n_train = len(HierTextRecognition(ht, train=True))
    n_val = len(HierTextRecognition(ht, train=False))
    steps, val_batches = math.ceil(n_train / batch), math.ceil(n_val / batch)
    want = {k: TRAIN_LAUNCHES.get(k, 0) * steps + EVAL_LAUNCHES.get(k, 0) * val_batches
            for k in counts}
    if counts != want or not all(counts[k] for k in TRAIN_LAUNCHES):
        raise AssertionError(f"train_rec hiertext: launches {counts}, expected {want}")
    caches = sorted(Path(ht).glob("*-lines-cache"))
    cache = {}
    for c in caches:
        cache.update(_snapshot(c))
    if len(cache) != n_train + n_val:
        raise AssertionError(f"crop cache holds {len(cache)} files, expected {n_train + n_val}")
    lines2, _, counts2, seconds2 = _cli(train_rec, [
        *args, "--checkpoint", "text-rec-checkpoint.pt", "--max-epochs", "2"])
    after = {}
    for c in caches:
        after.update(_snapshot(c))
    if after != cache:
        raise AssertionError("epoch 2 wrote into the crop cache")
    if counts2 != want:
        raise AssertionError(f"train_rec hiertext epoch 2: launches {counts2}, expected {want}")
    records = _epoch_records()
    losses = [v for r in records for v in (r["train_loss"], r["val_loss"])]
    if [r["epoch"] for r in records] != [0, 1] or not np.isfinite(losses).all():
        raise AssertionError(f"train_rec hiertext: records {records}")
    out = {"path": "train_rec hiertext toy 2 epochs", "dtype": "bf16", "batch": batch,
           "train_lines": n_train, "val_lines": n_val, "launches_per_epoch": counts,
           "epoch_seconds": [seconds, seconds2],
           "lines_per_s": [(n_train + n_val) / seconds, (n_train + n_val) / seconds2],
           "crops_per_s": _rates(lines + lines2),
           "train_loss": [r["train_loss"] for r in records],
           "val_loss": [r["val_loss"] for r in records],
           "cache_files": len(cache)}
    print(json.dumps(out), flush=True)
    return out


def run_real_detection(root: Path, work: Path, keep: Path) -> dict:
    """Phase 16 (c)-(e): ``train_detection hiertext`` and ``ddi`` for one
    epoch each at 800x600 (bf16, batch 4, augmented; finite losses, no port
    kernel launched), host ms per page decoded and per sample built;
    ``eval_detection`` on a JPEG page with phase 13's checkpoint (``keep /
    "det.pt"``; one epoch on the toy pages need not beat the trainer's
    initial best loss of 1.0, below which it writes one); the preview CLI
    for ``hiertext``, ``hiertext-rec`` and ``ddi``."""
    from ocrs_models_torch.data import __main__ as preview
    from ocrs_models_torch.data.ddi100 import DDI100
    from ocrs_models_torch.data.hiertext import HierTextDetection
    from ocrs_models_torch.data.imageio import read_grey
    from ocrs_models_torch.training import eval_detection, train_detection
    from ocrs_models_torch.utils.render import read_png

    roots = {"hiertext": _copy_toy(root, "torch_hiertext_toy", work / "det"),
             "ddi": _copy_toy(root, "torch_ddi_toy", work / "det")}
    readers = {"hiertext": HierTextDetection, "ddi": DDI100}
    report = {}
    for name, data in roots.items():
        ds = readers[name](data, train=True)
        n_train = len(ds)
        t0 = time.perf_counter()
        paths = [ds[i]["path"] for i in range(n_train)]  # decode, mask (no augmentation)
        sample_ms = 1e3 * (time.perf_counter() - t0) / n_train
        t0 = time.perf_counter()
        for path in paths:
            read_grey(path)
        decode_ms = 1e3 * (time.perf_counter() - t0) / n_train
        lines, state, counts, seconds = _cli(train_detection, [name, data, "--max-epochs", "1"])
        records = [json.loads(r) for r in
                   Path("text-detection-metrics.jsonl").read_text().splitlines()]
        (epoch,) = [r for r in records if "epoch" in r][-1:]
        if not np.isfinite([epoch["train_loss"], epoch["val_loss"]]).all():
            raise AssertionError(f"train_detection {name}: {epoch}")
        if any(counts.values()) or state.model.dtype != BF16:
            raise AssertionError(f"train_detection {name}: launches {counts}")
        report[name] = {"path": f"train_detection {name} toy 1 epoch", "dtype": "bf16",
                        "train_pages": n_train, "seconds": seconds,
                        "pages_per_s": n_train / seconds, "decode_ms_per_page": decode_ms,
                        "sample_ms_per_page": sample_ms, "train_loss": epoch["train_loss"],
                        "val_loss": epoch["val_loss"]}
        print(json.dumps(report[name]), flush=True)

    # (d) eval_detection on a JPEG page.
    page = Path(roots["hiertext"]) / "train" / "t4.jpg"
    height, width = read_grey(str(page)).shape
    lines, _, counts, seconds = _cli(eval_detection, [str(keep / "det.pt"), str(page), "jpeg"])
    for part, want in (("input", DET_TRAIN_SIZE), ("text-probs", DET_TRAIN_SIZE),
                       ("text-regions", (height, width)), ("text-words", (height, width))):
        shape = read_png(f"jpeg-{part}.png").shape[:2]
        if shape != tuple(want):
            raise AssertionError(f"eval_detection on a JPEG: {part} {shape}, expected {want}")
    print(json.dumps({"path": "eval_detection jpeg page", "page": [height, width],
                      "seconds": seconds, "line": lines[-1] if lines else ""}), flush=True)

    # (e) The preview CLI.
    written = {}
    for kind, data in (("hiertext", roots["hiertext"]), ("hiertext-rec", roots["hiertext"]),
                       ("ddi", roots["ddi"])):
        out_dir = work / f"preview-{kind}"
        _cli(preview, [kind, data, str(out_dir), "--max-images", "4"])
        names = sorted(p.name for p in out_dir.iterdir())
        prefix = "rec-" if kind == "hiertext-rec" else "det-"
        if not names or not all(n.startswith(prefix) and n.endswith(".png") for n in names):
            raise AssertionError(f"preview {kind}: {names}")
        for n in names:
            read_png(str(out_dir / n))
        written[kind] = names
    print(json.dumps({"path": "preview cli", "files": written}), flush=True)
    return report


def _tp_rank(rank: int, world: int, device, state_dict: dict) -> dict:
    """Phase 16 (f), in one of two ``gloo`` ranks sharing the card: the
    full-width layout model split over a 1 x 2 data x model mesh, one step
    on ``TP_BATCH`` pages with dropout drawn from a generator seeded alike
    on both ranks; returns the metrics, the gathered gradients and state,
    this rank's shard shapes and the step's host ms."""
    from ocrs_models_torch.parallel import (
        create_mesh_2d,
        gather_layout_state,
        shard_layout_model,
    )
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_layout_steps

    mesh = create_mesh_2d(1, 2, devices=[device])
    model = _layout_model().to(device)
    model.load_state_dict(state_dict)
    shard_layout_model(model, mesh)
    state = create_train_state(model)
    step = make_layout_steps(model, mesh=mesh)[0]
    batch = _layout_batch(TP_BATCH, SEED, device)
    gen = torch.Generator(device).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = step(state, batch, TP_LR, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "state": gather_layout_state(model, mesh), "ms": ms,
            "grads": gather_layout_state(model, mesh, {k: p.grad for k, p in
                                                       model.named_parameters()}),
            "shards": {k: list(v.shape) for k, v in model.state_dict().items()}}


def check_layout_tp(dev) -> dict:
    """Phase 16 (f): the tensor-parallel layout step on two ``gloo`` ranks
    sharing the card (dp=1, mp=2) against the plain step in this process,
    from the same weights and dropout stream: loss rtol 1e-5, grad norm
    rtol 1e-4, the gathered state's keys and shapes those of the
    one-process model, and

    - every gradient entry (gathered, before Adam) within rtol
      ``TP_GRAD_TOL`` and an atol of ``TP_GRAD_TOL`` times its tensor's
      largest gradient: the two steps sum in different orders, and the
      float noise that leaves in an entry scales with the terms summed,
      not with the entry;
    - every parameter after the step within rtol 1e-3 / atol 5e-5 beyond
      what Adam makes of that gradient difference. Adam's first step
      moves an entry by ``lr * g / (|g| + 1e-8)``: a gradient of float
      noise about 0 (the k projection's bias, 0 in exact arithmetic) or
      one near 1e-8 turns a difference within the gradient's tolerance
      into a step up to 2 lr apart. The line counts the entries where
      that term exceeds the tolerance.
    """
    from ocrs_models_torch.parallel import spawn
    from ocrs_models_torch.training.state import create_train_state
    from ocrs_models_torch.training.steps import make_layout_steps

    model = _layout_model().to(dev)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ranks = spawn(_tp_rank, 2, dev, args=(init,), share_device=True, timeout=600)
    state = create_train_state(model)
    step = make_layout_steps(model)[0]
    _, want = step(state, _layout_batch(TP_BATCH, SEED, dev), TP_LR,
                   torch.Generator(dev).manual_seed(SEED))
    plain = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    line = {"path": "layout tensor parallel gloo 1x2 f32", "pages": TP_BATCH,
            "loss": [r["loss"] for r in ranks], "loss_plain": want["loss"].item(),
            "grad_norm": [r["grad_norm"] for r in ranks], "grad_norm_plain":
            want["grad_norm"].item(), "host_ms": [r["ms"] for r in ranks],
            "qkv_shard": ranks[0]["shards"]["encode.layers.0.self_attn.in_proj_weight"]}
    for r in ranks:
        if abs(r["loss"] / line["loss_plain"] - 1) > 1e-5:
            raise AssertionError(f"layout TP loss {r['loss']} vs plain {line['loss_plain']}")
        if abs(r["grad_norm"] / line["grad_norm_plain"] - 1) > 1e-4:
            raise AssertionError(f"layout TP grad norm {r['grad_norm']} vs plain "
                                 f"{line['grad_norm_plain']}")
        got = r["state"]
        if {k: list(v.shape) for k, v in got.items()} != {k: list(v.shape)
                                                          for k, v in plain.items()}:
            raise AssertionError("layout TP: the gathered state's keys or shapes differ")
        grads_far = far = adam_noise = 0
        grad_ratio = max_diff = 0.0
        for k, v in plain.items():
            g, g_tp = grads[k], r["grads"][k]
            g_diff = (g_tp - g).abs()
            scale = g.abs().max().clamp_min(1e-30)
            grad_ratio = max(grad_ratio, (g_diff.max() / scale).item())
            grads_far += int((g_diff > TP_GRAD_TOL * (g.abs() + scale)).sum())
            diff = (got[k].float() - v.float()).abs()
            max_diff = max(max_diff, diff.max().item())
            tol = 5e-5 + 1e-3 * v.float().abs()
            adam = TP_LR * (g_tp / (g_tp.abs() + 1e-8) - g / (g.abs() + 1e-8)).abs()
            adam_noise += int((adam > tol).sum())
            far += int((diff > tol + adam).sum())
        line.update(grads_max_diff_of_max=grad_ratio, grads_beyond_tolerance=grads_far,
                    params_max_diff=max_diff, params_beyond_tolerance=far,
                    params_moved_by_gradient_noise=adam_noise)
        if grads_far:
            raise AssertionError(f"layout TP: {grads_far} gradient entries beyond rtol "
                                 f"{TP_GRAD_TOL} / atol {TP_GRAD_TOL} of their tensor's max")
        if far:
            raise AssertionError(f"layout TP: {far} parameters beyond rtol 1e-3 / atol 5e-5 "
                                 "and Adam's share of the gradients' difference")
    print(json.dumps(line), flush=True)
    return line


def run_real_data(root: Path, dev, keep: Path) -> None:
    """Phase 16: the real-data readers and layout tensor parallelism."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        work = Path(tmp)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            check_decoder(root)
            run_real_rec(root, work)
            print(f"phase 16b seconds {time.perf_counter() - t0:.1f}", flush=True)
            t0 = time.perf_counter()
            run_real_detection(root, work, keep)
            print(f"phase 16e seconds {time.perf_counter() - t0:.1f}", flush=True)
        finally:
            os.chdir(cwd)
    t0 = time.perf_counter()
    check_layout_tp(dev)
    print(f"phase 16f seconds {time.perf_counter() - t0:.1f}", flush=True)


# ---------------------------------------------------------------- phase 17

CC_PAGES = 4  # phase 17 (a): masks a batch, at the detector's 800 x 600
TIMED_CALLS = 5  # phase 17: timed calls a function (their median)
LINE_CROPS = 128  # phase 17 (b): uint8 line crops cut from phase 5's pages
LINE_CROP_SIZE = (96, 700)  # their height and width (resized to 64 x 467)
BEAM_WIDTH = 10  # phase 17 (c), ctc_beam_search_decode's default


def _median_ms(fn, calls: int = TIMED_CALLS) -> float:
    """The median of ``calls`` calls' times by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_boxes(labels: np.ndarray) -> np.ndarray:
    """``[n, 4]`` inclusive ``(x0, y0, x1, y1)`` of the host core's labels
    ``1..n``, in label order."""
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    order = np.argsort(lab, kind="stable")
    lab, ys, xs = lab[order], ys[order], xs[order]
    starts = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    return np.stack([np.minimum.reduceat(xs, starts), np.minimum.reduceat(ys, starts),
                     np.maximum.reduceat(xs, starts), np.maximum.reduceat(ys, starts)], axis=1)


def _expected_bounds(boxes: list[np.ndarray], k: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's slots for ``boxes`` in ascending-label order: the
    first K, or with more than K the K-1 first and the last."""
    out = np.zeros((len(boxes), k, 4), np.int32)
    valid = np.zeros((len(boxes), k), bool)
    for i, b in enumerate(boxes):
        kept = b if len(b) <= k else np.concatenate([b[: k - 1], b[-1:]])
        out[i, : len(kept)] = kept
        valid[i, : len(kept)] = True
    return out, valid


def check_components(name: str, masks: np.ndarray, dev) -> dict:
    """Phase 17 (a) on one batch of ``[N, 800, 600]`` masks: the device's
    labels partition each page as the host C++ core does (a bijection of
    labels, the same background), the boxes are the host components'
    boxes in ascending device-label order under ``max_components`` above
    and below the component count, and both are timed."""
    from ocrs_models_torch.geometry import connected_components
    from ocrs_models_torch.geometry import device as geo

    steps = 0
    propagate = geo._propagate

    def counted(*args):
        nonlocal steps
        steps += 1
        return propagate(*args)

    fg = torch.from_numpy(masks).to(dev)
    with mock.patch.object(geo, "_propagate", counted):
        labels = geo.connected_components_device(fg, device=dev)
    torch.cuda.synchronize()
    found = labels.cpu().numpy()
    boxes, counts = [], []
    for i, mask in enumerate(masks):
        host, n = connected_components(mask.astype(np.uint8))
        on = mask > 0
        if not np.array_equal(found[i] > 0, on):
            raise AssertionError(f"components {name} page {i}: labels off the mask")
        pairs = np.unique(np.stack([found[i][on], host[on]]), axis=1)  # by device label
        if not pairs.shape[1] == n == len(np.unique(found[i][on])):
            raise AssertionError(f"components {name} page {i}: {pairs.shape[1]} label pairs, "
                                 f"{n} host components: not a bijection")
        boxes.append(_host_boxes(host)[pairs[1] - 1] if n else np.zeros((0, 4), np.int64))
        counts.append(n)
    ks = sorted({max(counts) + 1, max(1, max(counts) // 2)})
    for k in ks:
        got, valid = geo.component_bounds_device(labels, k, device=dev)
        want, want_valid = _expected_bounds(boxes, k)
        if not (np.array_equal(valid.cpu().numpy(), want_valid)
                and np.array_equal(got.cpu().numpy(), want)):
            raise AssertionError(f"components {name}: boxes at max_components={k} differ from "
                                 "the host components' boxes")
    # One propagation step and one test for the fixed point, which
    # CHECK_EVERY weighs against each other.
    state, fg4 = labels[:, None].float(), fg[:, None] != 0
    same = state.clone()
    line = {"path": "components", "masks": name, "pages": len(masks),
            "shape": list(masks.shape[1:]), "components": counts, "max_components": ks,
            "overflowing_pages": [sum(c > k for c in counts) for k in ks],
            "propagation_steps": steps, "check_every": geo.CHECK_EVERY,
            "step_ms": _median_ms(lambda: geo._propagate(state, fg4)),
            "fixed_point_test_ms": _median_ms(lambda: torch.equal(state, same)),
            "cc_ms": _median_ms(lambda: geo.connected_components_device(fg, device=dev)),
            "bounds_ms": _median_ms(lambda: geo.component_bounds_device(labels, ks[-1],
                                                                         device=dev))}
    print(json.dumps(line), flush=True)
    return line


def check_preprocessing(pages, dev) -> dict:
    """Phase 17 (b): ``prepare_line_crops`` on uint8 line crops cut from
    the pages, then ``photometric_augment`` with draws from a CPU generator
    (the same draws on both devices), each on the card against the CPU
    within 1e-5, and timed."""
    from ocrs_models_torch.data import device_pipeline as pre

    rng = np.random.default_rng(SEED)
    h, w = LINE_CROP_SIZE
    crops = np.empty((LINE_CROPS, 1, h, w), np.uint8)
    for i in range(LINE_CROPS):
        page = pages[i % len(pages)][..., 0]
        y, x = (int(rng.integers(0, page.shape[0] - h)), int(rng.integers(0, page.shape[1] - w)))
        crops[i, 0] = np.round((page[y : y + h, x : x + w] + 0.5) * 255)
    x_cpu = torch.from_numpy(crops)
    x_dev = x_cpu.to(dev)
    lines = pre.prepare_line_crops(x_dev, 64, 800, device=dev)
    lines_cpu = pre.prepare_line_crops(x_cpu, 64, 800, device="cpu")

    def jitter(x, device):
        return pre.photometric_augment(x, torch.Generator().manual_seed(SEED), device=device)

    out = {"path": "preprocessing", "crops": list(crops.shape), "lines": list(lines.shape),
           "line_crops_max_abs_err": (lines.cpu() - lines_cpu).abs().max().item(),
           "photometric_max_abs_err": (jitter(lines, dev).cpu()
                                       - jitter(lines_cpu, "cpu")).abs().max().item(),
           "line_crops_ms": _median_ms(lambda: pre.prepare_line_crops(x_dev, 64, 800,
                                                                      device=dev)),
           "photometric_ms": _median_ms(lambda: jitter(lines, dev))}
    print(json.dumps(out), flush=True)
    for key in ("line_crops_max_abs_err", "photometric_max_abs_err"):
        if not out[key] <= 1e-5:
            raise AssertionError(f"preprocessing: {key} {out[key]} beyond 1e-5")
    return out


def run_beam_search(pipe, crops) -> dict:
    """Phase 17 (c): ``ctc_beam_search_decode`` on the recognizer's
    log-probs of phase 5's 256-wide crops, beside the greedy decode of the
    same log-probs (numbers, not a check: the weights are random)."""
    from ocrs_models_torch.utils.text import ctc_beam_search_decode, ctc_greedy_decode_text

    chunk = [c for c in crops if c.shape[1] == BUCKET_WIDTHS[0]][:REC_BATCH]
    x = torch.from_numpy(np.stack([c[:, :, 0] for c in chunk]))[:, None]
    with pipe._numerics():
        log_probs = pipe.rec_model(x.to(pipe.device)).cpu().numpy()
    steps = chunk[0].shape[1] // 4  # the pipeline's CTC length of a crop
    t0 = time.perf_counter()
    beams = [ctc_beam_search_decode(lp[:steps], pipe.alphabet, BEAM_WIDTH) for lp in log_probs]
    host_s = time.perf_counter() - t0
    greedy = [ctc_greedy_decode_text(lp[:steps].argmax(-1), pipe.alphabet) for lp in log_probs]
    out = {"path": "beam search", "crops": len(chunk), "steps": steps, "classes":
           log_probs.shape[-1], "beam_width": BEAM_WIDTH,
           "host_ms_per_crop": host_s / len(chunk) * 1e3,
           "identical_to_greedy_share": float(np.mean([a == b for a, b in zip(beams, greedy)]))}
    print(json.dumps(out), flush=True)
    return out


def run_device_ops(dev, pages, crops) -> dict:
    """Phase 17: on-device connected components and bounds (the detection
    trainer's target masks and the pipeline's thresholded detector output
    of phase 5's pages), device-side preprocessing, CTC beam search."""
    from ocrs_models_torch.config import DET_SIZE
    from ocrs_models_torch.data import SyntheticDetection
    from ocrs_models_torch.data.resize import resize
    from ocrs_models_torch.pipeline import OcrPipeline

    targets = SyntheticDetection(size=CC_PAGES, page_size=DET_SIZE, seed=SEED)
    masks = {"targets": np.stack([targets[i]["mask"][..., 0] > 0.5 for i in range(CC_PAGES)])}
    pipe = OcrPipeline(device=dev, seed=SEED)  # phase 5's float32 pipeline
    det_in = np.stack([resize(p, pipe.det_size) for p in pages[:CC_PAGES]])
    packed = pipe._det_masks(det_in)
    masks["detector"] = np.unpackbits(packed, axis=-1)[..., : pipe.det_size[1]].astype(bool)
    out = {name: check_components(name, m, dev) for name, m in masks.items()}
    out["preprocessing"] = check_preprocessing(pages, dev)
    out["beam search"] = run_beam_search(pipe, crops)
    return out


# ---------------------------------------------------------------- phase 18

WIDE_HIDDEN = 512  # phase 18: the recognizer's biGRU width on the wide route
WIDE_CHECK_HIDDEN = (100, 264, WIDE_HIDDEN)  # phase 18 (a): held against the plain versions
WIDE_T = 257  # phase 18 (a): the wide training bucket's steps (1024 // 4 + 1), at N=128
WIDE_STEPS = 3  # phase 18 (b): steps held against the plain step
STEPWISE_SHAPE = (9, REC_BATCH, 1024)  # phase 18 (a): (T, N, H) of the per-step/grid forms' check
GRID_HIDDEN = 1024  # phase 18 (a), (d): the grid form's width (all of W resident), timed and trained
STEPWISE_F32_HIDDEN = 2120  # phase 18 (a): f32 above the f32 grid form (GRID_F32_MAX_HIDDEN + 8)
GRID_STREAMED_HIDDEN = (1448, 2048, 5280, 5288)  # phase 18 (a): the grid form with W_hh partly
# streamed (from L2; at 5280 and 5288 mostly from device memory, 5288 a per-gate plan), timed
GRID_F32_STREAMED_HIDDEN = (1064, 1448, 2048)  # phase 18 (a): the f32 grid form with W_hh
# partly streamed (24, 24 and 32 units a block; at 2048 beyond the L2 and shared memory), timed
GRID_TRAIN_HIDDEN = 2048  # phase 18 (e): the recognizer trained in the streamed grid form
F32_PHASES_CHECK = (9, 259, 1064)  # phase 18 (a): (T, N, H) of the f32 wgmma coef/dw check:
# 2331 rows (ragged row tiles and dW stages), ragged unit tiles and k tiles
F32_PHASES_TIMED = (1024, 1064, 1448, GRID_TRAIN_HIDDEN)  # phase 18 (a): their widths timed


def _wide_min_equal(hid: int) -> float:
    """Least share of bf16 ``ys``/``dpx`` equal to the plain version's: 95%
    as for the cluster rows, 93% at H=512. There (T=257, N=128) two float32
    summation orders alone disagree on 4-5% of bf16 roundings: the plain
    version with float64 products reads 95.5-95.9% equal to the float32
    plain version, the per-step kernels 95.0-95.1%, and a chain that
    multiplies the unrounded dph 86.5%
    (``tests/torch_fixtures/wide_gru_equal_share.py``); the persistent
    kernels read 94.9-95.0% (this phase)."""
    return 0.95 if hid <= 264 else 0.93


def _wide_device_ms(times: dict, t_len: int, backward: bool) -> float | None:
    """Device ms of one wide-route call from the profiler's mean record by
    kernel, each times its launches a call: the recurrence kernel once in
    the persistent form (``gru_wide_fwd_kernel``, ``gru_wide_bwd_chain_kernel``
    and their bf16 twins) and in the grid form (``gru_grid_fwd_kernel``,
    ``gru_grid_chain_kernel``, in f32 ``gru_grid_f32_fwd_kernel`` and
    ``gru_grid_f32_chain_kernel``, and where W_hh is streamed the layout of
    its chunks, ``gru_grid_stream_layout_kernel`` or
    ``gru_grid_f32_stream_layout_kernel``), T times in the per-step form
    (``*_step_kernel``), and for the backward ``coef``, ``dw`` and
    ``dw_sum`` once each (``gru_bwd.cu``'s, or ``gru_bwd_wide.cu``'s above
    512, in f32 with the pre-passes ``gru_bwd_coef_split_kernel`` and
    ``gru_bwd_dw_split_kernel``, whose names put them in their phase)."""
    if not times:
        return None
    parts = (("gru_wide_bwd_chain", "gru_grid_chain", "gru_grid_f32_chain") if backward
             else ("gru_wide_fwd", "gru_grid_fwd", "gru_grid_f32_fwd"))
    # The streamed grid plans' layout of W's streamed chunks, one a call.
    parts += ("_stream_layout",)
    found = {name: ms for name, ms in times.items() if any(part in name for part in parts)}
    if not found:
        raise AssertionError(f"no kernel named *{parts}* ran on the device: {sorted(times)}")
    ms = sum(v * (t_len if "_step_kernel" in name else 1) for name, v in found.items())
    if backward:
        ms += _device_ms(times, "gru_bwd_coef") + _device_ms(times, "gru_bwd_dw")
    return ms


def _wide_launches(t_len: int, backward: bool, bf16: bool, one_launch: bool,
                   streamed: bool = False, prepasses: bool = False) -> int:
    """Device launches of one wide-route call at a width that needs no
    padding: the recurrence kernel (once in the persistent and grid forms,
    T in the per-step form; the streamed grid plans' layout of W's chunks
    before it), ``coef``, ``dw``, ``dw_sum`` and (per step) the copy of
    W_hh^T for the backward, with ``prepasses`` (f32 above 512,
    ``gru_bwd_wide.cu``) the pre-passes of ``coef`` and ``dw``, and W_hh's
    two casts in bf16."""
    chain = (1 + streamed) if one_launch else t_len
    phases = 3 + 2 * prepasses
    return (chain + phases + (0 if one_launch else 1) if backward else chain) + (2 if bf16 else 0)


def _launch_calls(fn, calls: int = 2) -> tuple[float, float]:
    """Device launches of one ``fn()``, and of them the cluster launches
    (``cudaLaunchKernelExC``), counted from the profiler's host events
    (exact, unlike its device records)."""
    from torch.profiler import ProfilerActivity, profile

    from ocrs_models_torch.profile_kernels import device_launches

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cluster = sum(1 for e in prof.events() if e.name == "cudaLaunchKernelExC")
    return device_launches(prof) / calls, cluster / calls


def _wide_call(fn, args, name: str, form: str):
    """``fn(*args)`` with the launch counts zeroed just before and read just
    after: it must have gone through the wide route's wrapper ``name``
    once, in ``form``, and nothing else."""
    _zero_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    _expect(_counts(), {name: 1}, 1, f"{name} (routed)")
    forms = _form_counts()[name]
    if forms[form] != 1:
        raise AssertionError(f"{name} ran the forms {forms}, not {form}")
    return out


def _wide_operands(gen, dev, t_len: int, n: int, hid: int, dtype) -> tuple:
    """Random wide-route operands ``(px_f, px_b, dy_f, dy_b, w_hh, b_hh)``."""
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    px_f, px_b = (torch.randn((t_len, n, 3 * hid), generator=gen).to(dev).to(dtype)
                  for _ in range(2))
    dy_f, dy_b = ((torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev).to(dtype)
                  for _ in range(2))
    return px_f, px_b, dy_f, dy_b, w_hh, b_hh


def _wide_errors(ys, want, grads, want_grads) -> dict:
    """The wide route's outputs against the plain versions': largest
    errors of ys, dpx and dW/db (and the largest dW/db), and the shares of
    ys and dpx equal."""
    return {"ys": _err(ys, want), "dpx": _err(grads[:2], want_grads[:2]),
            "dw": _err(grads[2:], want_grads[2:]),
            "dw_max": max(t.abs().max().item() for t in want_grads[2:]),
            "ys_equal": _equal_share(ys, want), "dpx_equal": _equal_share(grads[:2], want_grads[:2])}


def _wide_ok(errors: dict, bf16: bool, min_equal: float = 0.0) -> bool:
    """Phase 18 (a)'s tolerances: f32 ys 1e-4, dpx 1e-3, dW and db 1e-4 of
    their largest entry; bf16 ys and dpx 2e-2 and ``min_equal`` of them
    equal, dW and db 1e-3 of their largest entry."""
    if bf16:
        return (errors["ys"] <= 2e-2 and errors["dpx"] <= 2e-2
                and min(errors["ys_equal"], errors["dpx_equal"]) >= min_equal
                and errors["dw"] <= 1e-3 * errors["dw_max"])
    return (errors["ys"] <= 1e-4 and errors["dpx"] <= 1e-3
            and errors["dw"] <= 1e-4 * errors["dw_max"])


def _streamed(plan) -> bool:
    """Whether a grid plan streams part of W_hh (bf16 plans above
    GRID_RESIDENT_HIDDEN, f32 plans above GRID_F32_RESIDENT_HIDDEN)."""
    return plan is not None and plan.fwd.streamed > 0


def _check_wide_case(dev, gen, t_len: int, n: int, hid: int, dtype, tag: str) -> dict:
    """``gru_fwd`` and ``gru_bwd`` on the wide route at (T, N, H) against
    the plain versions (phase 18 (a)'s tolerances), reruns bit-identical,
    the form each call ran, and the device launches of a call of each;
    raises on a miss. Returns the widths' entries of the kernels rows and
    the inputs."""
    from ocrs_models_torch.ops import gru_bwd, gru_bwd_reference, gru_fwd, gru_recurrence_reference
    from ocrs_models_torch.ops.gru import bwd_phases, wide_form

    bf16 = dtype == BF16
    form, plan = wide_form(n, hid + -hid % 8, dtype, dev.index)
    one_launch = form != "stepwise"
    streamed = _streamed(plan)
    px_f, px_b, dy_f, dy_b, w_hh, b_hh = _wide_operands(gen, dev, t_len, n, hid, dtype)
    ys = _wide_call(gru_fwd, (px_f, px_b, w_hh, b_hh), "gru_wide_fwd", form)
    again = gru_fwd(px_f, px_b, w_hh, b_hh)
    want = gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    grads = _wide_call(gru_bwd, args, "gru_wide_bwd", form)
    grads_again = gru_bwd(*args)
    want_grads = gru_bwd_reference(*args)
    torch.cuda.synchronize()
    what = f"{tag} [T={t_len},N={n},H={hid}]"
    if not all(torch.equal(a, b) for a, b in zip((*ys, *grads), (*again, *grads_again))):
        raise AssertionError(f"the wide route is not deterministic at {what}")
    errors = _wide_errors(ys, want, grads, want_grads)
    launches, cluster = zip(*(_launch_calls(fn) for fn in
                              (lambda: gru_fwd(px_f, px_b, w_hh, b_hh), lambda: gru_bwd(*args))))
    # Where the wrapper pads H to a multiple of 8, its pads and slices add
    # launches of their own: the total is held only where it does not.
    prepasses = not bf16 and bwd_phases(hid + -hid % 8) == "gru_bwd_wide"
    expected = [_wide_launches(t_len, b, bf16, one_launch, streamed, prepasses)
                for b in (False, True)]
    print(f"gru wide {what} ({form}): ys max_abs_err "
          f"{errors['ys']:.3e} (equal {errors['ys_equal']:.4f}); dpx {errors['dpx']:.3e} (equal "
          f"{errors['dpx_equal']:.4f}), dW/db {errors['dw']:.3e} (max {errors['dw_max']:.3e}); "
          f"device launches a call {launches[0]:g} forward, {launches[1]:g} backward, of them "
          f"cluster or cooperative launches {cluster[0]:g}, {cluster[1]:g}", flush=True)
    if (bf16 and ys[0].dtype != BF16) or not _wide_ok(errors, bf16, _wide_min_equal(hid)):
        raise AssertionError(f"the wide route disagrees with the plain versions at {what}")
    if list(cluster) != [float(one_launch)] * 2 or (hid % 8 == 0 and list(launches) != expected):
        raise AssertionError(f"the wide route at {what}: {launches} device launches a forward "
                             f"and a backward call ({cluster} launches by cudaLaunchKernelExC), "
                             f"not {expected} ({[int(one_launch)] * 2})")
    return {"fwd": {"max_abs_err": errors["ys"], "equal_share": errors["ys_equal"]},
            "bwd": {"max_abs_err_dpx": errors["dpx"], "max_abs_err_dw": errors["dw"],
                    "dw_max": errors["dw_max"], "equal_share": errors["dpx_equal"]},
            "inputs": (px_f, px_b, w_hh, b_hh, args)}


def _phase_ms(times: dict, t_len: int, backward: bool) -> dict | None:
    """A wide-route call's device ms by phase from the profiler's records:
    the streamed chunks' layout (where there is one), the recurrence
    (``fwd`` or ``chain``, T launches in the per-step form), and for the
    backward ``coef`` and ``dw`` with ``dw_sum`` (in f32 above 512 each
    with its pre-pass); None where the profiler delivered no record."""
    if not times:
        return None
    out = {}
    stream = [ms for name, ms in times.items() if "_stream_layout" in name]
    if stream:
        out["layout"] = sum(stream)
    rec = (("gru_wide_bwd_chain", "gru_grid_chain", "gru_grid_f32_chain") if backward
           else ("gru_wide_fwd", "gru_grid_fwd", "gru_grid_f32_fwd"))
    out["chain" if backward else "fwd"] = sum(
        ms * (t_len if "_step_kernel" in name else 1) for name, ms in times.items()
        if any(part in name for part in rec))
    if backward:
        out["coef"] = _device_ms(times, "gru_bwd_coef")
        out["dw"] = _device_ms(times, "gru_bwd_dw")
    return out


_F32_PHASES_OLD = ("gru_bwd_coef_kernel", "gru_bwd_dw_kernel", "gru_bwd_dw_sum_kernel")
"""``gru_bwd.cu``'s f32 ``coef``, ``dw`` and ``dw_sum`` kernels (up to 512)."""
_F32_PHASES_NEW = ("gru_bwd_coef_split_kernel", "gru_bwd_coef_wide_f32_kernel",
                   "gru_bwd_dw_split_kernel", "gru_bwd_dw_wide_f32_kernel",
                   "gru_bwd_dw_sum_wide_kernel")
"""``gru_bwd_wide.cu``'s f32 ``coef`` and ``dw`` with their pre-passes and
``dw_sum`` (above 512)."""


def _f32_phase_kernels(times: dict, hid: int) -> list[str] | None:
    """The f32 backward's ``coef``/``dw`` kernels by the profiler's names in
    one wide call's records: above 512 (padded) ``gru_bwd_wide.cu``'s (its
    five) and none of ``gru_bwd.cu``'s, at and below 512 only
    ``gru_bwd.cu``'s three; raises on a kernel of the other source, or on
    none of the right one (the profiler may drop a kernel's records, not
    all of them). None where the profiler delivered no record."""
    if not times:
        return None
    seen = [k for k in _F32_PHASES_NEW + _F32_PHASES_OLD if any(k in name for name in times)]
    want = _F32_PHASES_NEW if hid + -hid % 8 > 512 else _F32_PHASES_OLD
    if not seen or any(k not in want for k in seen):
        raise AssertionError(f"the f32 backward at H={hid} ran the coef/dw kernels {seen}, "
                             f"not {list(want)}")
    return seen


def _per_step(fn):
    """``fn`` with the wide wrappers on the per-step form, whatever form
    ``wide_form`` picks (to time it beside the grid form)."""
    def call():
        with mock.patch("ocrs_models_torch.ops.gru.wide_form", lambda *a: ("stepwise", None)):
            return fn()
    return call


def _w_reread_bytes(t_len: int, hid: int, dtype) -> float:
    """Bytes a recurrence of ``t_len`` steps must read again from device
    memory because W_hh outgrows the chip: each step, the part of both
    directions' ``[H, 3H]`` W_hh in the compute dtype beyond the L2 and
    every SM's shared memory (0 where it fits: at H=2048 in bf16 and
    below, and in f32 up to 1024)."""
    size = 2 if dtype == BF16 else 4
    return t_len * max(0.0, size * 2 * hid * 3 * hid - H100_L2_BYTES - H100_SMS * H100_SMEM_BYTES)


def _time_wide(dev, gen, inputs, t_len: int, n: int, hid: int, dtype,
               stepwise_too: bool = False) -> tuple[dict, dict]:
    """``gru_fwd`` and ``gru_bwd`` on the wide route timed on ``inputs``
    (CUDA events, the device's records, by phase), beside the plain
    versions, cuDNN's ``nn.GRU(128, hid)`` and the bound: bytes (px and ys,
    and dy and dpx for the backward, in the dtype; the f32 weights; and
    for the forward's recurrence and the backward's chain each the
    per-step re-read of W_hh where it outgrows the chip, ``_w_reread_bytes``:
    19.5 ms of the bound at H=5288 in bf16) over 3.35 TB/s, or the
    recurrent products (three for the backward) each
    over the peak of the pipes its kernel runs it on (``bound_peaks``):
    bf16 on the tensor cores; in f32 the recurrence on the FMA pipes, or
    in 3xTF32 in the f32 grid form, and the backward's coef and dw in
    3xTF32 (``gru_bwd.cu``); with ``stepwise_too`` also the per-step form's time on
    the same inputs (``gru_fwd``/``gru_bwd`` with ``wide_form`` answering
    "stepwise" for the call, where the grid form runs). Returns the
    forward's and the backward's numbers."""
    from ocrs_models_torch.ops import (
        gru_bwd,
        gru_bwd_reference,
        gru_fwd,
        gru_recurrence_reference,
    )

    from ocrs_models_torch.ops.gru import GridF32Plan, wide_form

    px_f, px_b, w_hh, b_hh, args = inputs
    bf16 = dtype == BF16
    if bf16:
        rec_peak = other_peak = BF16_FLOPS_PER_S
    else:
        grid = isinstance(wide_form(n, hid + -hid % 8, dtype, dev.index)[1], GridF32Plan)
        rec_peak, other_peak = (TF32X3_FLOPS_PER_S if grid else F32_FLOPS_PER_S,
                                TF32X3_FLOPS_PER_S)
    h3 = 3 * hid
    size = 2 if bf16 else 4
    weights = 4 * (2 * hid * h3 + 2 * h3)
    io_bytes = size * (2 * t_len * n * h3 + 2 * t_len * n * hid)  # px and ys (dy, dpx)
    flops = 2 * t_len * 2 * n * hid * h3  # one [N,H] x [H,3H] product a step and direction
    out = []
    for name, kernel, plain, stepwise, backward in (
        ("gru_wide_fwd", lambda: gru_fwd(px_f, px_b, w_hh, b_hh),
         lambda: gru_recurrence_reference(px_f, px_b, w_hh, b_hh),
         _per_step(lambda: gru_fwd(px_f, px_b, w_hh, b_hh)), False),
        ("gru_wide_bwd", lambda: gru_bwd(*args), lambda: gru_bwd_reference(*args),
         _per_step(lambda: gru_bwd(*args)), True),
    ):
        ms = _cuda_time_ms(kernel, iters=5)
        plain_ms = _cuda_time_ms(plain, iters=2, warmup=1)
        launches, times, _ = _device_profile(kernel, calls=3)
        with _no_tf32():
            library_ms = _cuda_time_ms(
                _cudnn_gru(dev, gen, t_len, n, hid, dtype, backward), iters=5)
        parts = ((flops, rec_peak), *(((2 * flops, other_peak),) if backward else ()))
        bound_ms, bound_by = _bound_parts(io_bytes * (2 if backward else 1)
                                          + weights * (2 if backward else 1)
                                          + _w_reread_bytes(t_len, hid, dtype), parts)
        peaks = ", ".join(f"{_PEAK_NAMES[rate]} ({what})" for (_, rate), what in
                          zip(parts, ("recurrence", "coef and dw")))
        device_ms = _wide_device_ms(times, t_len, backward)
        phase_kernels = _f32_phase_kernels(times, hid) if backward and not bf16 else None
        timed = {"shape": f"T={t_len}, N={n}, H={hid}", "ms": ms, "device_ms": device_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_peaks": peaks,
                 "library_ms": library_ms, "us_per_step": 1e3 * ms / t_len,
                 "device_launches_per_call": launches,
                 "split_ms": _phase_ms(times, t_len, backward)}
        if phase_kernels is not None:
            timed["phase_kernels"] = phase_kernels
        if stepwise_too:
            timed["stepwise_ms"] = _cuda_time_ms(stepwise, iters=3, warmup=1)
        print(f"{name} {'bf16' if bf16 else 'f32'} [T={t_len},N={n},H={hid}]: {ms:.4f} ms, "
              f"device {_fmt(device_ms)} ms, {timed['us_per_step']:.3f} us per step, "
              f"{launches:g} device launches per call, by phase {timed['split_ms']}; plain "
              f"{plain_ms:.3f} ms, cuDNN {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {peaks})" + (f"; the per-step form {timed['stepwise_ms']:.4f} ms"
                                 if stepwise_too else "")
              + (f"; coef/dw kernels {phase_kernels}" if phase_kernels else ""), flush=True)
        out.append(timed)
    return out[0], out[1]


def check_gru_wide(dev, gen) -> list[dict]:
    """Phase 18 (a): the biGRU kernels on the wide route (``gru_wide.cu``
    and ``gru_bwd.cu``'s phases around its chain), through ``gru_fwd`` and
    ``gru_bwd``, against the plain versions at T=257, N=128 and H in
    WIDE_CHECK_HIDDEN (the persistent form), in both dtypes, with the
    cluster rows' tolerances: f32 ys 1e-4, dpx 1e-3, dW and db 1e-4 of
    their largest entry; bf16 ys and dpx 2e-2 and ``_wide_min_equal`` of
    them equal, dW and db 1e-3 of their largest entry. Reruns
    bit-identical, device launches a call asserted. Timed at H=512 against
    the plain versions and cuDNN's ``nn.GRU``, with the launch's rows per
    block and clusters. Above 512: the grid form (``gru_grid.cu`` in bf16,
    ``gru_grid_f32.cu`` in f32) held the same way at STEPWISE_SHAPE, then
    gated (bf16 equal shares at ``_wide_min_equal``) and timed at T=257,
    N=128, H=GRID_HIDDEN (the kernels rows' ``grid`` entries; in f32 the
    per-step form timed beside on the same inputs) and in bf16 at each
    width of GRID_STREAMED_HIDDEN, where W_hh is partly streamed (the
    ``grid_streamed`` entries, the per-step form timed beside: at 5280 and
    5288, where W_hh comes mostly from device memory, the old plan of 80
    units and the per-gate plan of 88), and in f32 at each width of
    GRID_F32_STREAMED_HIDDEN the same way; the per-step form held at T=9 above
    each dtype's widest grid width, STEPWISE_F32_HIDDEN and GRID_MAX_HIDDEN
    + 8 (the ``stepwise`` entries). Returns the kernels line's rows."""
    from ocrs_models_torch.ops import gru_route
    from ocrs_models_torch.ops.gru import (
        GRID_F32_MAX_HIDDEN,
        GRID_MAX_HIDDEN,
        wide_max_active_clusters,
    )

    if STEPWISE_F32_HIDDEN != GRID_F32_MAX_HIDDEN + 8:
        raise AssertionError(f"STEPWISE_F32_HIDDEN {STEPWISE_F32_HIDDEN} is not the width above "
                             f"the f32 grid form, {GRID_F32_MAX_HIDDEN + 8}")

    t_len, n = WIDE_T, REC_BATCH
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (BF16, "bf16")):
        bf16 = dtype == BF16
        fwd = {"name": "gru_wide_fwd", "dtype": tag, "widths": {}}
        bwd = {"name": "gru_wide_bwd", "dtype": tag, "widths": {}}
        for hid in WIDE_CHECK_HIDDEN:
            if gru_route(hid) != "wide":
                raise AssertionError(f"H={hid} does not take the wide route's persistent form")
            got = _check_wide_case(dev, gen, t_len, n, hid, dtype, tag)
            fwd["widths"][hid], bwd["widths"][hid] = got["fwd"], got["bwd"]
        # Timed at the last width checked, WIDE_HIDDEN.
        inputs = got.pop("inputs")
        clusters = wide_max_active_clusters(n, hid, dtype=dtype)
        for row, timed in zip((fwd, bwd), _time_wide(dev, gen, inputs, t_len, n, hid, dtype)):
            backward = row is bwd
            launch = clusters[row["name"]]
            row.update({
                "route": "cuda", "source": "ocrs_models_torch/csrc/gru_wide.cu",
                "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:"
                + ("171" if backward else "139"),
                "max_abs_err": max(max(v for k, v in w.items() if k.startswith("max_abs_err"))
                                   for w in row["widths"].values()),
                **timed, "cluster_size": clusters["cluster_size"],
                "rows_per_block": launch["rows_per_block"],
                "clusters_launched": launch["launched"], "max_active_clusters": launch["max_active"],
            })
            if backward:  # the phases around the wide chain
                row["also"] = "ocrs_models_torch/csrc/gru_bwd.cu (coef, dw, dw_sum)"
            if bf16:
                row["equal_share"] = min(w["equal_share"] for w in row["widths"].values())
            print(f"{row['name']} {tag} [T={t_len},N={n},H={hid}]: rows per block "
                  f"{launch['rows_per_block']}, clusters of {clusters['cluster_size']}: "
                  f"{launch['launched']} launched, {launch['max_active']} max active", flush=True)
            rows.append(row)
        del inputs, got
        torch.cuda.empty_cache()
        # Above 512: the grid form (held at STEPWISE_SHAPE, then at the
        # wide bucket's T=257, N=128, gated and timed: H=GRID_HIDDEN in
        # both dtypes, f32 beside the per-step form, and the streamed plans'
        # GRID_STREAMED_HIDDEN in bf16 and GRID_F32_STREAMED_HIDDEN in f32,
        # these beside the per-step form too, 5288 a per-gate plan); the
        # per-step form above each
        # dtype's widest grid width, held at T=9 (its errors gated at the
        # tolerances above, bf16 without an equal share: printed).
        t_s, n_s, _ = STEPWISE_SHAPE
        forms = ((("grid", GRID_HIDDEN), *(("grid", h) for h in GRID_STREAMED_HIDDEN),
                  ("stepwise", GRID_MAX_HIDDEN + 8)) if bf16 else
                 (("grid", GRID_HIDDEN), *(("grid", h) for h in GRID_F32_STREAMED_HIDDEN),
                  ("stepwise", STEPWISE_F32_HIDDEN)))
        for form, hid in forms:
            if gru_route(hid, dtype) != form:
                raise AssertionError(f"H={hid} {tag} does not take the wide route's {form} form")
            got = _check_wide_case(dev, gen, t_s, n_s, hid, dtype, tag)
            del got["inputs"]
            torch.cuda.empty_cache()
            if form == "stepwise":
                for row, name in zip((fwd, bwd), ("fwd", "bwd")):
                    row[form] = {"form": form, "route": "cuda",
                                 "source": "ocrs_models_torch/csrc/gru_wide.cu",
                                 "checked": f"T={t_s}, N={n_s}, H={hid}", **got[name]}
                # Its times at T=257 beside the grid form's on the same
                # inputs (f32 at GRID_HIDDEN and GRID_F32_STREAMED_HIDDEN,
                # bf16 at GRID_STREAMED_HIDDEN).
                continue
            subs = _wide_sub_rows(dev, gen, t_len, n, hid, dtype, tag, form)
            for row, sub in zip((fwd, bwd), subs):
                if hid in (GRID_STREAMED_HIDDEN if bf16 else GRID_F32_STREAMED_HIDDEN):
                    row.setdefault("grid_streamed", {})[hid] = sub
                else:
                    row[form] = {**row.get(form, {}), **sub}
            torch.cuda.empty_cache()
    return rows


def _wide_sub_rows(dev, gen, t_len: int, n: int, hid: int, dtype, tag: str,
                   form: str) -> tuple[dict, dict]:
    """The kernels rows' entries of the wide route's ``form`` ("grid" or
    "stepwise") at (T, N, H): ``gru_fwd`` and ``gru_bwd`` against the plain
    versions, gated at phase 18 (a)'s tolerances (the grid form's equal
    shares at ``_wide_min_equal``), then timed (``_time_wide``)."""
    from ocrs_models_torch.ops import gru_bwd, gru_bwd_reference, gru_fwd, gru_recurrence_reference
    from ocrs_models_torch.ops.gru import wide_form

    bf16 = dtype == BF16
    px_f, px_b, dy_f, dy_b, w_hh, b_hh = _wide_operands(gen, dev, t_len, n, hid, dtype)
    ys = _wide_call(gru_fwd, (px_f, px_b, w_hh, b_hh), "gru_wide_fwd", form)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    want = (gru_recurrence_reference(px_f, px_b, w_hh, b_hh), gru_bwd_reference(*args))
    errors = _wide_errors(ys, want[0], _wide_call(gru_bwd, args, "gru_wide_bwd", form), want[1])
    inputs = (px_f, px_b, w_hh, b_hh, args)
    del ys, px_f, px_b, dy_f, dy_b, w_hh, b_hh, args
    print(f"gru wide {form} {tag} [T={t_len},N={n},H={hid}]: {json.dumps(errors)}", flush=True)
    min_equal = _wide_min_equal(hid) if form == "grid" else 0.0
    if not _wide_ok(errors, bf16, min_equal):
        raise AssertionError(f"the wide route's {form} form at H={hid}, T={t_len} disagrees with "
                             f"the plain versions: {errors}")
    source = "gru_wide.cu" if form != "grid" else "gru_grid.cu" if bf16 else "gru_grid_f32.cu"
    place = {"form": form, "route": "cuda", "source": "ocrs_models_torch/csrc/" + source}
    streamed = False
    if form == "grid":
        plan = wide_form(n, hid, dtype, dev.index)[1]
        streamed = _streamed(plan)
        place.update(units_per_block=plan.units, rows_per_block=plan.rows,
                     blocks=2 * -(-hid // plan.units) * -(-n // plan.rows))
        place["w_split"] = {"fwd": plan.fwd._asdict(), "chain": plan.chain._asdict()}
        layout = f"W_hh's k16 steps resident, streamed, ring stages: {place['w_split']}"
        if bf16:
            place["also"] = "ocrs_models_torch/csrc/gru_bwd_wide.cu (coef, dw, dw_sum)"
        else:
            place["ring_stages"] = plan.stages
            place["also"] = ("ocrs_models_torch/csrc/gru_bwd_wide.cu (coef, dw, dw_sum and their "
                             "pre-passes, f32 3xTF32 on wgmma)")
            layout += f"; {plan.stages} ring stages of the A operand"
        print(f"gru wide grid {tag} [N={n},H={hid}]: {plan.units} units x {plan.rows} rows a "
              f"block, {place['blocks']} blocks in one cooperative launch; {layout}", flush=True)
    out = []
    # The per-step form beside the grid form where it is the form the grid
    # replaced at this width (f32), or where W_hh is streamed (bf16): held
    # on the same inputs at the per-step form's tolerances, then timed.
    beside = streamed or (form == "grid" and not bf16)
    if beside:
        px_f, px_b, w_hh, b_hh, args = inputs
        stepwise = _wide_errors(_per_step(lambda: gru_fwd(px_f, px_b, w_hh, b_hh))(), want[0],
                                _per_step(lambda: gru_bwd(*args))(), want[1])
        del px_f, px_b, w_hh, b_hh, args
        print(f"gru wide stepwise {tag} [T={t_len},N={n},H={hid}]: {json.dumps(stepwise)}",
              flush=True)
        if not _wide_ok(stepwise, bf16, 0.0):
            raise AssertionError(f"the wide route's stepwise form at H={hid}, T={t_len} "
                                 f"disagrees with the plain versions: {stepwise}")
    del want
    for name, timed in zip(("fwd", "bwd"), _time_wide(dev, gen, inputs, t_len, n, hid, dtype,
                                                      stepwise_too=beside)):
        errs = ({"max_abs_err": errors["ys"]} if name == "fwd" else
                {"max_abs_err": errors["dpx"], "max_abs_err_dpx": errors["dpx"],
                 "max_abs_err_dw": errors["dw"], "dw_max": errors["dw_max"]})
        if bf16:
            errs["equal_share"] = errors["ys_equal" if name == "fwd" else "dpx_equal"]
        if beside:
            errs["stepwise_max_abs_err"] = (
                {"ys": stepwise["ys"]} if name == "fwd" else
                {"dpx": stepwise["dpx"], "dw": stepwise["dw"]})
        out.append({"name": f"gru_wide_{name}", **place,
                    "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:"
                    + ("139" if name == "fwd" else "171"), **timed, **errs})
    return out[0], out[1]


def _f32_phase_inputs(gen, dev, t_len: int, n: int, hid: int) -> dict:
    """Random operands of the f32 backward's ``coef`` and ``dw`` phases."""
    w_hh, b_hh = _gru_weights(gen, dev, hid)
    rand = lambda *shape: torch.rand(shape, generator=gen).to(dev) * 2 - 1  # noqa: E731
    return {"px": [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev) for _ in range(2)],
            "ys": [rand(t_len, n, hid) for _ in range(2)],
            "dpx": [(torch.randn((t_len, n, 3 * hid), generator=gen) * 0.1).to(dev)
                    for _ in range(2)],
            "w_hh": w_hh, "b_hh": b_hh}


def _f32_phase_calls(x: dict) -> dict:
    """Per phase, the new kernel's call (``gru_bwd_wide.cu`` through its
    wrapper), the old one's (``gru_bwd.cu``'s f32 entry, its C call), the
    plain version and the library call (one ``torch.matmul`` of the
    phase's product shapes at the default "highest" f32 precision, no
    TF32), on the operands ``x`` (``coef`` the plain one's)."""
    from ocrs_models_torch.ops import gru_bwd_coef_wide_f32, gru_bwd_dw_wide_f32
    from ocrs_models_torch.ops import gru_bwd_coefficients_reference, gru_bwd_dw_reference
    from ocrs_models_torch.ops import _build
    from ocrs_models_torch.ops.gru import _bwd_lib, _dph, _dw_splits, _h_prev

    (px_f, px_b), (ys_f, ys_b), (dpx_f, dpx_b) = x["px"], x["ys"], x["dpx"]
    w_hh, b_hh, coef = x["w_hh"], x["b_hh"], x["coef"]
    t_len, n, hid = ys_f.shape
    dev, m, h3 = ys_f.device, t_len * n, 3 * hid
    lib, ptr, stream = _bwd_lib(), _build.ptr, _build.stream_ptr(ys_f.device)
    splits = _dw_splits(t_len, n)  # gru_bwd.cu's ranges
    old = {"coef": torch.empty_like(coef), "dwp": torch.empty((splits, 2, hid, h3), device=dev),
           "dbp": torch.empty((splits, 2, h3), device=dev), "dw": torch.empty_like(w_hh),
           "db": torch.empty_like(b_hh)}
    h_prev = _h_prev(ys_f, ys_b).reshape(2, m, hid)
    dph = _dph(dpx_f, dpx_b, coef).reshape(2, m, h3)
    return {
        "coef": {
            "new": lambda: gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh),
            "old": lambda: _build.check(lib, lib.ocrs_gru_bwd_coef(
                dev.index, ptr(px_f), ptr(px_b), ptr(ys_f), ptr(ys_b), ptr(w_hh), ptr(b_hh),
                ptr(old["coef"]), t_len, n, hid, stream), "gru_bwd.cu coef"),
            "plain": lambda: gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh),
            "library": lambda: torch.matmul(h_prev, w_hh)},
        "dw": {
            "new": lambda: gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef),
            "old": lambda: _build.check(lib, lib.ocrs_gru_bwd_dw(
                dev.index, ptr(ys_f), ptr(ys_b), ptr(dpx_f), ptr(dpx_b), ptr(coef), ptr(old["dwp"]),
                ptr(old["dbp"]), ptr(old["dw"]), ptr(old["db"]), splits, t_len, n, hid, stream),
                "gru_bwd.cu dw"),
            "plain": lambda: gru_bwd_dw_reference(ys_f, ys_b, _dph(dpx_f, dpx_b, coef)),
            "library": lambda: torch.matmul(h_prev.transpose(1, 2), dph)},
    }


def check_f32_phases(dev, gen) -> list[dict]:
    """Phase 18 (a): the f32 backward's ``coef`` and ``dw`` above 512,
    ``gru_bwd_wide.cu``'s 3xTF32 kernels on ``wgmma`` through their
    wrappers (``ops.PHASE_KERNELS``), against the plain versions at the
    ragged F32_PHASES_CHECK (coef within 1e-4 of its largest entry, dW and
    db 1e-4 of theirs + 1e-5, as the card tests hold them), reruns, both
    tile orders and 1 and 2 ranges of rows bit-identical, and the device
    launches of a call (coef 2, dw 3: each with its pre-pass); then at
    T=257, N=128 and each width of F32_PHASES_TIMED timed (CUDA events)
    beside ``gru_bwd.cu``'s f32 ``coef`` and ``dw`` (the kernels they
    replace, on the same operands) and, at GRID_TRAIN_HIDDEN, the plain
    versions, the library call (``torch.matmul`` on the same product
    shapes, "highest" f32 precision) and the bound: the products, 2 T N H
    3H x 2 directions each, over the 3xTF32 peak, or the bytes (inputs
    read once, outputs written once, and the pre-pass's copies written and
    read), the longer. Returns the kernels line's two rows (``launches``
    filled by ``run_wide_gru`` from phase 18 (e))."""
    from ocrs_models_torch.ops import gru_bwd_coef_wide_f32, gru_bwd_dw_wide_f32

    t_len, n, hid = F32_PHASES_CHECK
    x = _f32_phase_inputs(gen, dev, t_len, n, hid)
    (px_f, px_b), (ys_f, ys_b), (dpx_f, dpx_b) = x["px"], x["ys"], x["dpx"]
    coef = gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, x["w_hh"], x["b_hh"])
    x["coef"] = coef
    calls = _f32_phase_calls(x)
    want = {"coef": calls["coef"]["plain"]().reshape(coef.shape), "dw": calls["dw"]["plain"]()}
    same = (torch.equal(coef, calls["coef"]["new"]()) and torch.equal(
        coef, gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, x["w_hh"], x["b_hh"], order=0)))
    err = {"coef": (coef - want["coef"]).abs().max().item()}
    dw_err = []
    for splits in (1, 2):
        got = gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef, splits)
        for again in (gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef, splits),
                      gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef, splits, order=0)):
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
        dw_err.append([((a - b).abs().max().item(), b.abs().max().item())
                       for a, b in zip(got, want["dw"])])
    err["dw"] = max(e for pair in dw_err for e, _ in pair)
    ok = (err["coef"] <= 1e-4 * want["coef"].abs().max().item()
          and all(e <= 1e-4 * top + 1e-5 for pair in dw_err for e, top in pair))
    launches = {name: _launch_calls(calls[name]["new"])[0] for name in ("coef", "dw")}
    print(f"f32 wgmma phases [T={t_len},N={n},H={hid}]: coef max_abs_err {err['coef']:.3e}, dW/db "
          f"{dw_err} (max_abs_err, largest entry) at 1 and 2 ranges; reruns and tile orders "
          f"bit-identical: {same}; device launches a call {launches}", flush=True)
    if not ok or not same or launches != {"coef": 2, "dw": 3}:
        raise AssertionError(f"the f32 wgmma coef/dw at [T={t_len},N={n},H={hid}]: errors {err}, "
                             f"{dw_err}, bit-identical {same}, launches {launches}")
    del x, calls, want, coef
    torch.cuda.empty_cache()

    rows = {name: {"name": f"gru_bwd_{name}_wide_f32", "route": "cuda",
                   "source": "ocrs_models_torch/csrc/gru_bwd_wide.cu",
                   "replaces": "ocrs_models_tpu/ops/pallas/gru_kernel4.py:171",
                   "old_source": "ocrs_models_torch/csrc/gru_bwd.cu", "max_abs_err": err[name],
                   "widths": {}} for name in ("coef", "dw")}
    t_len, n = WIDE_T, REC_BATCH
    for hid in F32_PHASES_TIMED:
        x = _f32_phase_inputs(gen, dev, t_len, n, hid)
        (px_f, px_b), (ys_f, ys_b) = x["px"], x["ys"]
        x["coef"] = gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, x["w_hh"], x["b_hh"])
        calls = _f32_phase_calls(x)
        m, h3 = t_len * n, 3 * hid
        flops = 2 * 2 * m * hid * h3
        # The pre-pass's hi and lo copies (of W_hh^T, of ys^T) written once
        # and read once: 16 bytes an element.
        pre = {"coef": 16 * 2 * hid * h3, "dw": 16 * 2 * m * hid}
        io_bytes = {"coef": 4 * (2 * m * h3 + 2 * m * hid + 2 * hid * h3 + 2 * h3 + 2 * m * 5 * hid),
                    "dw": 4 * (2 * m * hid + 2 * m * h3 + 2 * m * hid + 2 * hid * h3 + 2 * h3)}
        for name, row in rows.items():
            timed = {"ms": _cuda_time_ms(calls[name]["new"], iters=5),
                     "old_ms": _cuda_time_ms(calls[name]["old"], iters=5)}
            timed["bound_ms"], timed["bound_by"] = _bound_parts(
                io_bytes[name] + pre[name], ((flops, TF32X3_FLOPS_PER_S),))
            if hid == GRID_TRAIN_HIDDEN:
                got, plain = calls[name]["new"](), calls[name]["plain"]()
                got = got if isinstance(got, tuple) else (got,)
                plain = plain if isinstance(plain, tuple) else (plain.reshape(got[0].shape),)
                row["max_abs_err"] = max(row["max_abs_err"], _err(got, plain))
                del got, plain
                timed["plain_ms"] = _cuda_time_ms(calls[name]["plain"], iters=2, warmup=1)
                timed["library_ms"] = _cuda_time_ms(calls[name]["library"], iters=3, warmup=1)
                _, times, _ = _device_profile(calls[name]["new"], calls=3)
                timed["device_ms"] = _device_ms(times, f"gru_bwd_{name}")
                row.update({"shape": f"T={t_len}, N={n}, H={hid}", **timed})
            row["widths"][hid] = timed
            print(f"f32 wgmma {name} [T={t_len},N={n},H={hid}]: {timed['ms']:.4f} ms (gru_bwd.cu's "
                  f"mma.sync {timed['old_ms']:.4f} ms), bound {timed['bound_ms']:.4f} ms "
                  f"({timed['bound_by']}; 3xTF32 165 TFLOP/s)"
                  + (f"; device {_fmt(timed['device_ms'])} ms, plain {timed['plain_ms']:.3f} ms, "
                     f"torch.matmul f32 \"highest\" {timed['library_ms']:.4f} ms"
                     if "plain_ms" in timed else ""), flush=True)
        del x, calls
        torch.cuda.empty_cache()
    return list(rows.values())


def _with_recognizer(pipe, model):
    """``pipe`` serving ``model``: ``OcrPipeline`` builds the shipped
    recognizer (H=256), as the JAX pipeline does, so phase 18 puts its
    ``gru_hidden=512`` recognizer in that one's place."""
    pipe._rec = [model]
    pipe.rec_model = model
    return pipe


def serve_wide(dev, crops) -> dict:
    """Phase 18 (c): ``_recognize_crops`` on 128 crops of width 256 with a
    ``gru_hidden=512`` recognizer (f32, random weights from a fixed seed),
    warm, counts zeroed just before and read just after (one ``stage1_fwd``
    and two ``gru_wide_fwd``), and the same crops through the same weights
    on the CPU: the greedy strings must be equal."""
    import copy

    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.pipeline import OcrPipeline

    torch.manual_seed(SEED + 2)
    model = RecognitionModel(n_classes=97, gru_hidden=WIDE_HIDDEN).eval().requires_grad_(False)
    cpu = _with_recognizer(OcrPipeline(device="cpu", seed=SEED), copy.deepcopy(model))
    pipe = _with_recognizer(OcrPipeline(device=dev, seed=SEED), model.to(dev))
    crops = crops[:REC_BATCH]
    pipe._recognize_crops(crops, REC_BATCH)  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    texts = pipe._recognize_crops(crops, REC_BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _counts()
    want = cpu._recognize_crops(crops, REC_BATCH)
    equal = float(np.mean([a == b for a, b in zip(texts, want)]))
    line = {"path": f"recognize_crops H={WIDE_HIDDEN}", "dtype": "f32", "crops": len(crops),
            "width": crops[0].shape[1], "seconds": elapsed, "crops_per_s": len(crops) / elapsed,
            "equal_to_cpu_share": equal, "nonempty_texts": sum(bool(t) for t in texts),
            "launches": counts}
    print(json.dumps(line), flush=True)
    _expect(counts, {"stage1_fwd": 1, "gru_wide_fwd": 2}, 1, line["path"])
    if equal != 1.0:
        raise AssertionError(f"{line['path']}: the card's strings differ from the CPU's")
    return line


def train_grid(dev, hidden: int = GRID_HIDDEN, dtype=BF16) -> dict:
    """Phase 18 (d) and (e): the CRNN with ``gru_hidden=hidden`` in
    ``dtype``, whose biGRU takes the grid form (GRID_HIDDEN: all of W_hh
    resident, ``gru_grid.cu`` in bf16 and ``gru_grid_f32.cu`` in f32;
    GRID_TRAIN_HIDDEN: partly streamed): WIDE_STEPS headline steps against
    the plain steps (phase 8's tolerances of the dtype for the first, the
    CPU parity test's for later ones), then 10 headline and 3 wide steps timed
    (exact launch counts; Adam at 3e-4: at 1e-3 the loss at H=1024 swung
    between 4.7 and 9.4 from step to step on the fixed batch, the first
    steps matching the plain steps'); every call of each timed run must
    have run the grid form (``.forms``). Returns ``run_training``'s
    report."""
    check_train_step_vs_plain(dev, dtype, gru_hidden=hidden, steps=WIDE_STEPS)
    report = run_training(dev, dtype, wide_steps=3, gru_hidden=hidden, lr=3e-4)
    tag = "bf16" if dtype == BF16 else "f32"
    for shape, line in report.items():
        for name in ("gru_wide_fwd", "gru_wide_bwd"):
            if line["forms"][name]["grid"] != line["launches"][name] or not line["launches"][name]:
                raise AssertionError(f"the {tag} H={hidden} {shape} steps ran {name} in the "
                                     f"forms {line['forms'][name]}, not all in the grid form")
    torch.cuda.empty_cache()
    return report


def run_wide_gru(dev, gen, crops) -> list[dict]:
    """Phase 18: the recognition model at ``gru_hidden=512``, a width the
    cluster kernels do not take: (a) the wide kernels against their plain
    versions; (b) the training step in f32 and bf16, WIDE_STEPS steps
    against the plain step, then 10 timed steps at the headline and wide
    shapes (counts zeroed just before and read just after); (c) serving;
    (d) the training step at ``gru_hidden=GRID_HIDDEN`` (the grid form) in
    bf16 and f32; (e) in bf16 and f32 at ``gru_hidden=GRID_TRAIN_HIDDEN``
    (W_hh partly streamed). Returns the kernels line's wide rows, with their
    launches from (b)'s headline steps and (c)'s serving call, the rows'
    ``grid`` entries theirs from (d)'s of their dtype and the rows'
    ``grid_streamed`` entries at GRID_TRAIN_HIDDEN from (e)'s of their
    dtype."""
    t0 = time.perf_counter()
    rows = check_gru_wide(dev, gen)
    phase_rows = check_f32_phases(dev, gen)
    print(f"phase 18a seconds {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    grid = {"bf16": train_grid(dev), "f32": train_grid(dev, GRID_HIDDEN, torch.float32)}
    print(f"phase 18d seconds {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    streamed = {"bf16": train_grid(dev, GRID_TRAIN_HIDDEN),
                "f32": train_grid(dev, GRID_TRAIN_HIDDEN, torch.float32)}
    print(f"phase 18e seconds {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    train = {}
    for dtype, name in ((torch.float32, "f32"), (BF16, "bf16")):
        check_train_step_vs_plain(dev, dtype, gru_hidden=WIDE_HIDDEN, steps=WIDE_STEPS)
        train[name] = run_training(dev, dtype, gru_hidden=WIDE_HIDDEN)
    torch.cuda.empty_cache()
    print(f"phase 18b seconds {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    served = serve_wide(dev, crops)
    print(f"phase 18c seconds {time.perf_counter() - t0:.1f}", flush=True)
    for row in rows:
        head = train[row["dtype"]]["headline"]
        row["launches"] = head["launches"][row["name"]]
        row["launches_per_step"] = row["launches"] // head["steps"]
        for sub, report in ((row.get("grid"), grid[row["dtype"]]),
                            (row.get("grid_streamed", {}).get(GRID_TRAIN_HIDDEN),
                             streamed[row["dtype"]])):
            if sub is not None:
                sub["launches"] = report["headline"]["launches"][row["name"]]
                sub["launches_per_step"] = sub["launches"] // report["headline"]["steps"]
        if row["dtype"] == "f32" and row["name"] in served["launches"]:
            row["serve_launches"] = served["launches"][row["name"]]
        if not row["launches"] > 0:
            raise AssertionError(f"the {row['dtype']} H={WIDE_HIDDEN} step never launched "
                                 f"{row['name']}")
    # The f32 coef and dw above 512: their launches in (e)'s f32 headline
    # steps, one each for every gru_wide_bwd call there.
    head = streamed["f32"]["headline"]
    for row in phase_rows:
        row["launches"] = head["phase_launches"][row["name"]]
        row["launches_per_step"] = row["launches"] // head["steps"]
        if not 0 < row["launches"] == head["launches"]["gru_wide_bwd"]:
            raise AssertionError(f"the f32 H={GRID_TRAIN_HIDDEN} steps launched {row['name']} "
                                 f"{row['launches']} times, gru_wide_bwd "
                                 f"{head['launches']['gru_wide_bwd']}")
    rows += phase_rows
    print(json.dumps({"path": f"grid biGRU summary H={GRID_HIDDEN} and {GRID_TRAIN_HIDDEN}, "
                              "bf16 and f32", **{
        f"{h}_{shape}_median_ms": v[shape]["step_ms_median"]
        for h, v in ((GRID_HIDDEN, grid["bf16"]), (f"{GRID_HIDDEN}_f32", grid["f32"]),
                     (GRID_TRAIN_HIDDEN, streamed["bf16"]),
                     (f"{GRID_TRAIN_HIDDEN}_f32", streamed["f32"]))
        for shape in ("headline", "wide")}}), flush=True)
    print(json.dumps({"path": f"wide biGRU summary H={WIDE_HIDDEN}", **{
        f"{k}_{shape}_median_ms": v[shape]["step_ms_median"]
        for k, v in train.items() for shape in ("headline", "wide")}, **{
        f"{k}_{shape}_peak_mib": v[shape]["peak_mib"]
        for k, v in train.items() for shape in ("headline", "wide")},
        "serve_crops_per_s": served["crops_per_s"]}), flush=True)
    return rows


def run(root: Path) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoints_") as keep:
        return run_phases(root, Path(keep))


def run_phases(root: Path, keep: Path) -> int:
    """Phases 1-18; the trainer phases leave their checkpoints in ``keep``
    for phase 14."""
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

    # Phase 8: the training step, in both dtypes, and at the wide bucket
    # with a line too long for its crop (S = 1025).
    train = {}
    for dtype, name in ((torch.float32, "f32"), (BF16, "bf16")):
        check_train_step_vs_plain(dev, dtype)
        check_train_step_vs_plain(dev, dtype, batch=long_label_batch(dev),
                                  tag=" wide, a 449-character line")
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
    trainer_launches = run_trainer({k: v["wide"]["crops_per_s"] for k, v in train.items()}, keep)
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
    run_layout_trainer(keep)
    print(f"phase 11 seconds {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"path": "layout summary", "forward_ms_16x500": layout["forward_ms"],
                      "forward_device_ms_16x500": layout["forward_device_ms"],
                      "run_batch_layout_pages_per_s": layout["pages_per_s"],
                      **{f"step_{k}_median_ms": v["step_ms_median"] for k, v in layout_steps.items()},
                      **{f"step_{k}_pages_per_s": v["pages_per_s"] for k, v in layout_steps.items()}}),
          flush=True)

    # Phase 12: the detection step at [4, 1, 800, 600]: against the CPU in
    # both dtypes, grad_accum=4, timed steps, the balanced BCE alone.
    t0 = time.perf_counter()
    check_detection_step(dev)
    det_steps = {name: run_detection_training(dev, dtype)
                 for dtype, name in ((BF16, "bf16"), (torch.float32, "f32"))}
    det_loss = time_balanced_loss(dev)
    torch.cuda.empty_cache()
    print(f"phase 12 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 13: the detection trainer CLI and eval_detection.
    t0 = time.perf_counter()
    det_host = run_detection_trainer(keep)
    print(f"phase 13 seconds {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"path": "detection summary",
                      **{f"step_{k}_median_ms": v["step_ms_median"] for k, v in det_steps.items()},
                      **{f"step_{k}_pages_per_s": v["pages_per_s"] for k, v in det_steps.items()},
                      **{f"step_{k}_peak_mib": v["peak_mib"] for k, v in det_steps.items()},
                      "balanced_bce_ms": det_loss["ms"],
                      "balanced_bce_launches": det_loss["device_launches_per_call"],
                      "page_ms": det_host["page_ms"]}), flush=True)

    # Phase 14: ONNX and .npz export of the three trained models.
    t0 = time.perf_counter()
    run_export(dev, keep)
    print(f"phase 14 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 15: data parallelism: NCCL at world size 1, two gloo ranks on
    # the card, serving over a mesh, the trainer under torchrun.
    t0 = time.perf_counter()
    run_data_parallel(dev, pages, root)
    print(f"phase 15 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 16: the real-data path on the toy roots (decoder, the trainers,
    # eval_detection, the preview CLI) and layout tensor parallelism.
    t0 = time.perf_counter()
    run_real_data(root, dev, keep)
    print(f"phase 16 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 17: connected components and bounds on the card, device-side
    # preprocessing, CTC beam search.
    t0 = time.perf_counter()
    run_device_ops(dev, pages, crops)
    print(f"phase 17 seconds {time.perf_counter() - t0:.1f}", flush=True)

    # Phase 18: the recognizer at gru_hidden=512, on the biGRU's wide route.
    t0 = time.perf_counter()
    kernels_wide = run_wide_gru(dev, gen, crops)
    print(f"phase 18 seconds {time.perf_counter() - t0:.1f}", flush=True)

    print(f"smoke seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels + kernels_bf16 + kernels_wide}), flush=True)
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
