"""Profile the port's recognition forward, its training step and its
kernels on one GPU.

    python -m ocrs_models_torch.profile_kernels [--width 800] [--batch 128]
        [--train-width 256] [--train-batch 256] [--only gru]

Runs, under ``torch.profiler``, the recognition forward of one
``rec_batch`` chunk (random weights, seed 1234), the biGRU recurrence
alone (``gru_fwd``, then ``gru_bwd`` whose device time the table splits by
phase: ``coef``, ``chain``, ``dw``, ``dw_sum``), and one training step of
``training.steps.make_recognition_steps`` at the JAX package's headline
shape (256 crops of 64 x 256, 24 labels, Adam with clip 4.0), and prints
for each the device time by kernel, the number of device launches per
iteration, the span on the host clock, and the device's busy share of that
span. ``--only gru`` runs the two recurrence sections alone, at
``T = width // 4 + 1`` and ``N = batch``. Needs CUDA.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numpy as np

from .models import RecognitionModel
from .ops import gru_bwd, gru_fwd
from .training.state import create_train_state
from .training.steps import make_recognition_steps


def _device_busy_us(prof) -> float:
    """Union of the device intervals of all kernels, copies and sets, in
    microseconds (overlapping work counts once)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name
    )
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemsetAsync", "cudaMemcpyAsync")


def device_launches(prof) -> int:
    """Kernels, copies and sets put on the device under ``prof``, counted
    as the runtime calls that launch them (the device-side records of the
    last launches can miss the end of a short profile)."""
    return sum(1 for e in prof.events() if e.name in _LAUNCH_CALLS)


def _report(name: str, prof, wall_s: float, iters: int) -> None:
    busy = _device_busy_us(prof) / iters
    print(f"== {name}: {wall_s / iters * 1e3:.3f} ms per iteration (host clock), "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / (wall_s / iters * 1e6):.1f}%), "
          f"{device_launches(prof) / iters:g} device launches per iteration")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def _profiled(fn, iters: int):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train-width", type=int, default=256)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--only", choices=["gru"], default=None,
                    help="run only the recurrence sections")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator().manual_seed(1234)
    torch.manual_seed(1234)
    model = RecognitionModel(n_classes=97).to(dev).eval().requires_grad_(False)
    x = (torch.rand((args.batch, 1, 64, args.width), generator=gen) - 0.5).to(dev)
    flags = dict(enabled=True, benchmark=True, deterministic=False, allow_tf32=False)
    with torch.inference_mode(), torch.backends.cudnn.flags(**flags):
        if args.only is None:
            prof, wall = _profiled(lambda: model(x), args.iters)
            _report(f"recognition forward [{args.batch},1,64,{args.width}]", prof, wall, args.iters)

        t, hid = args.width // 4 + 1, 256
        px_f = torch.randn((t, args.batch, 3 * hid), generator=gen).to(dev)
        px_b = torch.randn((t, args.batch, 3 * hid), generator=gen).to(dev)
        w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / 16).to(dev)
        b_hh = torch.zeros((2, 3 * hid), device=dev)
        prof, wall = _profiled(lambda: gru_fwd(px_f, px_b, w_hh, b_hh), args.iters)
        _report(f"gru_fwd T={t} N={args.batch} H={hid}", prof, wall, args.iters)

        # The backward alone; its kernels are its phases.
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        dy_f = (torch.randn((t, args.batch, hid), generator=gen) * 0.1).to(dev)
        dy_b = (torch.randn((t, args.batch, hid), generator=gen) * 0.1).to(dev)
        prof, wall = _profiled(
            lambda: gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh), args.iters)
        _report(f"gru_bwd T={t} N={args.batch} H={hid}", prof, wall, args.iters)
    if args.only is not None:
        return

    # One training step (its own numerics: f32, TF32 off, cuDNN benchmark).
    n, w = args.train_batch, args.train_width
    rng = np.random.default_rng(0)
    text = np.zeros((n, 64), np.int64)
    text[:, :24] = rng.integers(1, 97, (n, 24))
    batch = {
        "image": torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 1, 64, w)).astype(np.float32)),
        "text": torch.from_numpy(text),
        "text_len": torch.full((n,), 24),
        "image_width": torch.full((n,), w),
        "sample_weight": torch.ones((n,)),
    }
    batch = {k: v.to(dev) for k, v in batch.items()}
    model.requires_grad_(True).train()
    state = create_train_state(model, grad_clip_norm=4.0)
    train_step, _ = make_recognition_steps(model)
    prof, wall = _profiled(lambda: train_step(state, batch, 1e-3), args.iters)
    _report(f"train step [{n},1,64,{w}]", prof, wall, args.iters)


if __name__ == "__main__":
    main()
