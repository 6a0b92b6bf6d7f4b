"""Profile the port's recognition forward, its training step and its
kernels, the layout model and the detection step, on one GPU.

    python -m ocrs_models_torch.profile_kernels [--width 800] [--batch 128]
        [--train-width 256] [--train-batch 256]
        [--only gru|stage1|ctc|layout|detection] [--bf16]

Runs, under ``torch.profiler``, the recognition forward of one
``rec_batch`` chunk (random weights, seed 1234), the biGRU recurrence
alone (``gru_fwd``, then ``gru_bwd`` whose device time the table splits by
phase: ``coef``, ``chain``, ``dw``, ``dw_sum``), and one training step of
``training.steps.make_recognition_steps`` at the JAX package's headline
shape (256 crops of 64 x 256, 24 labels, Adam with clip 4.0), and prints
for each the device time by kernel, the number of device launches per
iteration, the span on the host clock, and the device's busy share of that
span. ``--only gru`` runs the two recurrence sections alone, at
``T = width // 4 + 1`` and ``N = batch``. ``--only stage1`` runs
``stage1_fwd`` and ``stage1_bwd`` (whose table splits the two passes) and
``--only ctc`` runs ``ctc_alpha`` and ``ctc_beta``, each alone at the
training shapes given by ``--train-width`` and ``--train-batch`` (labels
of 24 characters at width 256, else 48, in arrays 64 wide as the trainer
pads them). ``--only layout`` runs the layout model's forward at
``[16, 500, 4]`` (float32, as ``OcrPipeline`` serves it) and one layout
training step at 64 pages of 500 words (dropout on, lr 3e-4); the layout
model reaches none of the port's kernels. ``--only detection`` runs one
detection training step at the trainer's shape, 4 synthetic pages of
800x600 (lr 1e-3), and the balanced BCE alone (forward and backward) on
its masks; the detector reaches none of the port's kernels. ``--bf16`` runs the model, the
step and the stage-1 and biGRU kernels in bfloat16 (the CTC kernels are
float32 in both; the layout forward and the balanced BCE stay float32).
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numpy as np

from .models import RecognitionModel
from .ops import KERNELS, ctc_alpha, ctc_beta, gru_bwd, gru_fwd, stage1_bwd, stage1_fwd
from .ops.ctc import NEG_INF, ctc_operands
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


# Name parts of the hand-written kernels (``csrc/*.cu``), by phase; a
# kernel counts under the first part its name holds (``gru_bwd_dw_sum``
# before ``gru_bwd_dw``, which is ``gru_bwd_dw_kernel`` in f32 and
# ``gru_bwd_dw_bf16_kernel`` in bf16).
OWN_KERNELS = ("stage1_fwd", "stage1_bwd_partial", "stage1_bwd_finish", "gru_fwd", "gru_bwd_coef",
               "gru_bwd_chain", "gru_bwd_dw_sum", "gru_bwd_dw", "ctc_alpha", "ctc_beta")
_WRAPPER = re.compile(r"\b(" + "|".join(k.__name__ for k in KERNELS) + r")_")


def device_records(prof) -> dict[str, list[float]]:
    """The device time, in ms, of every record of each kernel, copy or set
    under ``prof``, by name. In a short window the profiler often delivers
    fewer records than there were launches (4 for 5 launches of a kernel),
    so a record count says nothing of the launches."""
    out: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name:
            out.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
    return out


def own_wrapper(kernel: str) -> str | None:
    """The wrapper (``ops.KERNELS``) that launches the device kernel named
    ``kernel`` once a call, or None for a library kernel."""
    found = _WRAPPER.search(kernel)
    return found.group(1) if found else None


def device_ms_by_kernel(prof, calls: int, launches: dict[str, float]) -> dict[str, float]:
    """Device time of one call, in ms, of each kernel, copy or set under
    ``prof`` (``calls`` calls), by name. A kernel of the port's own is read
    as the mean of its records times its wrapper's launches per call
    (``launches``, from the wrappers' counters), so a missing record costs
    nothing; a library kernel, whose launches nothing counts, as the sum of
    its records over the calls (its record count is printed beside)."""
    out = {}
    for name, ms in device_records(prof).items():
        wrapper = own_wrapper(name)
        if wrapper is not None:
            out[name] = sum(ms) / len(ms) * launches[wrapper]
        else:
            out[name] = sum(ms) / calls
    return out


def _report(name: str, prof, wall_s: float, iters: int, launches: dict[str, float]) -> None:
    busy = _device_busy_us(prof) / iters
    print(f"== {name}: {wall_s / iters * 1e3:.3f} ms per iteration (host clock), "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / (wall_s / iters * 1e6):.1f}%), "
          f"{device_launches(prof) / iters:g} device launches per iteration")
    records = device_records(prof)
    own, library = {}, []
    for kernel, ms in device_ms_by_kernel(prof, iters, launches).items():
        part = next((p for p in OWN_KERNELS if p in kernel), None)
        if part is not None:
            own[part] = own.get(part, 0.0) + ms
        else:
            library.append((ms, kernel))
    print("   the port's own kernels, device ms per iteration (mean record x launches per "
          "iteration): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items())))
    print(f"   wrapper launches per iteration: {json.dumps(launches)}")
    print(f"   library kernels, device ms per iteration (records over {iters} iterations):")
    for ms, kernel in sorted(library, reverse=True)[:12]:
        print(f"     {ms:.4f} ms ({len(records[kernel])} records) {kernel[:100]}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def _profiled(fn, iters: int):
    """``fn`` under the profiler ``iters`` times after two warm-up calls;
    returns the profile, the host seconds and each wrapper's launches per
    iteration (its counter, zeroed just before the window)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for kernel in KERNELS:
        kernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, {k.__name__: k.launches / iters for k in KERNELS}


def _stage1_sections(n: int, w: int, iters: int, dev, gen, dtype) -> None:
    """``stage1_fwd`` and ``stage1_bwd`` alone at the training shape."""
    weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
    bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
    x = (torch.rand((n, 1, 64, w), generator=gen) - 0.5).to(dev, dtype)
    dy = torch.randn((n, 32, 32, w // 2), generator=gen).to(dev, dtype)
    for name, fn in (("stage1_fwd", lambda: stage1_fwd(x, weight, bias)),
                     ("stage1_bwd", lambda: stage1_bwd(x, weight, bias, dy))):
        prof, wall, launches = _profiled(fn, iters)
        _report(f"{name} x [{n},1,64,{w}]", prof, wall, iters, launches)


def _ctc_sections(n: int, w: int, iters: int, dev, gen) -> None:
    """``ctc_alpha`` and ``ctc_beta`` alone at the training shape, on the
    operands and the cotangent the training step's loss gives them."""
    n_chars = 24 if w == 256 else 48
    t_len = w // 4 + 1
    labels = torch.zeros((n, 64), dtype=torch.int64)
    labels[:, :n_chars] = torch.randint(1, 97, (n, n_chars), generator=gen)
    log_probs = torch.log_softmax(torch.randn((n, t_len, 97), generator=gen), -1).to(dev)
    emit, skip, alpha0, lens = ctc_operands(
        log_probs, labels.to(dev), torch.full((n,), w // 4), torch.full((n,), n_chars))
    alphas = ctc_alpha(emit, skip, alpha0, lens)
    # An NLL's cotangent lies on the last label and the last blank.
    pos = torch.arange(emit.shape[2], device=dev)[None, :]
    at_end = (pos >= 2 * n_chars - 1) & (pos <= 2 * n_chars)
    seed = torch.where(at_end, -alphas[:, -1], torch.full_like(alphas[:, -1], NEG_INF)).contiguous()
    sign = -torch.ones((n,), device=dev)
    for name, fn in (("ctc_alpha", lambda: ctc_alpha(emit, skip, alpha0, lens)),
                     ("ctc_beta", lambda: ctc_beta(emit, skip, alphas, seed, sign, lens))):
        prof, wall, launches = _profiled(fn, iters)
        _report(f"{name} emit [{n},{t_len},{emit.shape[2]}]", prof, wall, iters, launches)


def _layout_sections(iters: int, dev, dtype) -> None:
    """The layout model's served forward and its training step."""
    from .data import SyntheticLayout, collate_layout
    from .models import LayoutModel
    from .training.steps import make_layout_steps, numerics

    ds = SyntheticLayout(size=64, n_words=500, seed=1234)
    batch = collate_layout([ds[i] for i in range(64)])
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("boxes", "labels", "sample_weight")}
    model = LayoutModel(return_probs=True).to(dev).eval().requires_grad_(False)
    with torch.inference_mode(), numerics():
        prof, wall, launches = _profiled(lambda: model(batch["boxes"][:16]), iters)
    _report("layout forward f32 [16,500,4]", prof, wall, iters, launches)
    model = LayoutModel(dtype=dtype).to(dev)
    state = create_train_state(model)
    train_step, _ = make_layout_steps(model)
    gen = torch.Generator(device=dev).manual_seed(1234)
    prof, wall, launches = _profiled(lambda: train_step(state, batch, 3e-4, gen), iters)
    _report(f"layout train step {str(dtype)[6:]} [64,500,4]", prof, wall, iters, launches)


def _detection_sections(iters: int, dev, dtype) -> None:
    """One detection training step at ``[4, 1, 800, 600]``, and the
    balanced BCE alone on its masks."""
    from .data import SyntheticDetection, collate_detection
    from .models import DetectionModel
    from .ops.losses import balanced_cross_entropy_loss
    from .training.steps import make_detection_steps

    ds = SyntheticDetection(size=4, page_size=(800, 600), seed=1234)
    batch = collate_detection([ds[i] for i in range(4)])
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("image", "mask", "sample_weight")}
    model = DetectionModel(dtype=dtype).to(dev)
    state = create_train_state(model)
    train_step, _ = make_detection_steps(model)
    prof, wall, launches = _profiled(lambda: train_step(state, batch, 1e-3), iters)
    _report(f"detection train step {str(dtype)[6:]} [4,1,800,600]", prof, wall, iters, launches)
    pred = torch.rand(batch["mask"].shape, device=dev).requires_grad_()

    def loss_call():
        balanced_cross_entropy_loss(pred, batch["mask"], batch["sample_weight"]).backward()

    prof, wall, launches = _profiled(loss_call, iters)
    _report("balanced BCE forward+backward [4,1,800,600]", prof, wall, iters, launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train-width", type=int, default=256)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--only", choices=["gru", "stage1", "ctc", "layout", "detection"],
                    default=None,
                    help="run only the sections of these kernels")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 model, step and kernels")
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator().manual_seed(1234)
    torch.manual_seed(1234)
    if args.only == "stage1":
        return _stage1_sections(args.train_batch, args.train_width, args.iters, dev, gen, dtype)
    if args.only == "ctc":
        return _ctc_sections(args.train_batch, args.train_width, args.iters, dev, gen)
    if args.only == "layout":
        return _layout_sections(args.iters, dev, dtype)
    if args.only == "detection":
        return _detection_sections(args.iters, dev, dtype)
    model = RecognitionModel(n_classes=97, dtype=dtype).to(dev).eval().requires_grad_(False)
    x = (torch.rand((args.batch, 1, 64, args.width), generator=gen) - 0.5).to(dev)
    flags = dict(enabled=True, benchmark=True, deterministic=False, allow_tf32=False)
    n, w = args.train_batch, args.train_width
    with torch.inference_mode(), torch.backends.cudnn.flags(**flags):
        if args.only is None:
            prof, wall, launches = _profiled(lambda: model(x), args.iters)
            _report(f"recognition forward [{args.batch},1,64,{args.width}]", prof, wall, args.iters, launches)

        t, hid = args.width // 4 + 1, 256
        px_f = torch.randn((t, args.batch, 3 * hid), generator=gen).to(dev, dtype)
        px_b = torch.randn((t, args.batch, 3 * hid), generator=gen).to(dev, dtype)
        w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / 16).to(dev)
        b_hh = torch.zeros((2, 3 * hid), device=dev)
        prof, wall, launches = _profiled(lambda: gru_fwd(px_f, px_b, w_hh, b_hh), args.iters)
        _report(f"gru_fwd T={t} N={args.batch} H={hid}", prof, wall, args.iters, launches)

        # The backward alone; its kernels are its phases.
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        dy_f = (torch.randn((t, args.batch, hid), generator=gen) * 0.1).to(dev, dtype)
        dy_b = (torch.randn((t, args.batch, hid), generator=gen) * 0.1).to(dev, dtype)
        prof, wall, launches = _profiled(
            lambda: gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh), args.iters)
        _report(f"gru_bwd T={t} N={args.batch} H={hid}", prof, wall, args.iters, launches)
    if args.only is not None:
        return

    # One training step (its own numerics: TF32 off, cuDNN benchmark).
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
    prof, wall, launches = _profiled(lambda: train_step(state, batch, 1e-3), args.iters)
    _report(f"train step [{n},1,64,{w}]", prof, wall, args.iters, launches)


if __name__ == "__main__":
    main()
