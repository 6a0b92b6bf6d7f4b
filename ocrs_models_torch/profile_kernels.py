"""Profile the port's recognition chunk and its kernels on one GPU.

    python -m ocrs_models_torch.profile_kernels [--width 800] [--batch 128]

Runs the recognition forward of one ``rec_batch`` chunk (random weights,
seed 1234) and the biGRU recurrence alone under ``torch.profiler``, and
prints the device time by kernel, the span of each region on the host
clock, and the device's busy share of that span. Needs CUDA.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .models import RecognitionModel
from .ops import gru_recurrence


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


def _report(name: str, prof, wall_s: float, iters: int) -> None:
    busy = _device_busy_us(prof) / iters
    print(f"== {name}: {wall_s / iters * 1e3:.3f} ms per iteration (host clock), "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / (wall_s / iters * 1e6):.1f}%)")
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
        prof, wall = _profiled(lambda: model(x), args.iters)
        _report(f"recognition forward [{args.batch},1,64,{args.width}]", prof, wall, args.iters)

        t, hid = args.width // 4 + 1, 256
        px = torch.randn((t, args.batch, 3 * hid), generator=gen).to(dev)
        w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / 16).to(dev)
        b_hh = torch.zeros((2, 3 * hid), device=dev)
        prof, wall = _profiled(lambda: gru_recurrence(px, px, w_hh, b_hh), args.iters)
        _report(f"gru_fwd T={t} N={args.batch} H={hid}", prof, wall, args.iters)


if __name__ == "__main__":
    main()
