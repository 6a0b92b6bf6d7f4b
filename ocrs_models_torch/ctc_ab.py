"""Time builds of the CTC alpha kernel against each other in one process.

    python -m ocrs_models_torch.ctc_ab [--source NAME=PATH ...] [--rounds 2] [--cold]

Each ``--source`` is a version of ``csrc/ctc_alpha.cu`` (the current one,
named ``new``, when none is given; another commit's copy for an A/B). Each
is compiled by ``nvcc`` with the flags of ``ops/_build.py`` into
``build/ab/``, loaded with ``ctypes`` and called through its C entry
``ocrs_ctc_alpha``. At every case the sources run in turns, forward then
backward (A B, B A) for ``--rounds`` rounds, and the script prints one JSON
line per case with each source's device time per call (``torch.profiler``,
the kernel alone), its events time over a loop of calls, and whether its
states equal the first source's bit for bit and the plain version's
(:func:`ops.ctc.ctc_alpha_reference`). A source that exports
``ocrs_ctc_alpha_probe`` also gets its chain alone (``chain_ms``).

Cases (N, T, S): the five of ``chip_smoke.py`` phase 7 (``ragged``,
``headline``, ``headline_padded``, ``wide``, ``wide_padded``), and more
that take them apart: ``wide_padded`` operands with ``ragged`` lengths and
the reverse, ``wide_padded`` at N=120, 112, 96, 16 and 1 (a call's 34 MB of
emissions and states shrunk step by step), and ``headline_padded`` at
N=128 (one block on an SM, where N=256 puts two on most). ``--cold`` writes a
256 MB buffer before each call so that no input is left in the 50 MB L2
cache. Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .ops import _build
from .ops.ctc import ctc_alpha_reference, ctc_operands
from .profile_kernels import device_records

AB_DIR = _build.BUILD_DIR.parent / "ab"
SEED = 1234


def _load(name: str, src: Path) -> ctypes.CDLL:
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"libctc_alpha_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ocrs_ctc_alpha.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    dll.ocrs_ctc_alpha.restype = ctypes.c_int
    dll.ocrs_error_string.argtypes = [i]
    dll.ocrs_error_string.restype = ctypes.c_char_p
    if hasattr(dll, "ocrs_ctc_alpha_probe"):
        dll.ocrs_ctc_alpha_probe.argtypes = [i, i, i, p, p]
        dll.ocrs_ctc_alpha_probe.restype = ctypes.c_int
    return dll


def _operands(dev, gen, n, t_len, label_width, label_len, input_len, repeats=False):
    """``(emit, skip, alpha0, lens)`` of random log-probs over 97 classes
    and labels of the given lengths in arrays ``label_width`` wide."""
    rng = np.random.default_rng(SEED)
    labels = np.zeros((n, label_width), np.int64)
    for i, ll in enumerate(label_len):
        labels[i, :ll] = rng.integers(1, 97, ll)
    if repeats:
        labels[1, :6] = [5, 5, 5, 7, 7, 9]
    log_probs = torch.log_softmax(torch.randn((n, t_len, 97), generator=gen), -1).to(dev)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    return ctc_operands(log_probs, as_t(labels), as_t(input_len), as_t(label_len))


def cases(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    n, t_len = 128, 257
    rng = np.random.default_rng(SEED)
    label_len = rng.integers(6, 49, n)
    label_len[0], label_len[2] = 0, 40  # an empty label, and one that cannot fit
    input_len = rng.integers(160, t_len, n)
    input_len[2] = 20
    out = {"ragged": _operands(dev, gen, n, t_len, 64, label_len, input_len, repeats=True)}
    for what, n_b, width, chars in (("headline", 256, 256, 24), ("wide", 128, 1024, 48)):
        for label_width, key in ((chars, what), (64, f"{what}_padded")):
            out[key] = _operands(dev, gen, n_b, width // 4 + 1, label_width, np.full(n_b, chars),
                                 np.full(n_b, width // 4))
    ragged, padded = out["ragged"], out["wide_padded"]
    out["wide_padded_data+ragged_lens"] = (*padded[:3], ragged[3])
    out["ragged_data+full_lens"] = (*ragged[:3], padded[3])
    for n_small in (120, 112, 96, 16, 1):
        out[f"wide_padded_n{n_small}"] = tuple(t[:n_small].contiguous() for t in padded)
    out["headline_padded_n128"] = tuple(t[:128].contiguous() for t in out["headline_padded"])
    return out


def _call(dll, args, out) -> None:
    emit, skip, alpha0, lens = args
    n, t_len, s = emit.shape
    ptrs = (_build.ptr(t) for t in (emit, skip, alpha0, lens, out))
    stream = _build.stream_ptr(emit.device)
    rc = dll.ocrs_ctc_alpha(emit.device.index, *ptrs, n, t_len, s, 0, stream)
    _build.check(dll, rc, "ctc_alpha")


def _device_ms(fn, before, calls: int = 5) -> float:
    """The profiler's device time of one call of the kernel (the mean over
    the records it delivered; a window with none is profiled again, up to
    three times), ``before()`` run ahead of each call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                before()
                fn()
            torch.cuda.synchronize()
        ms = [t for name, v in device_records(prof).items() if "ctc_alpha" in name for t in v]
        if ms:
            break
    return sum(ms) / max(len(ms), 1)


def _events_ms(fn, before, iters: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        before()
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of a ctc_alpha.cu to build (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cold", action="store_true", help="flush the L2 cache before each call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ctc_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    current = str(_build.CSRC_DIR / "ctc_alpha.cu")
    specs = [s.split("=", 1) for s in args.source] or [["new", current]]
    libs = {name: _load(name, Path(path)) for name, path in specs}
    names = list(libs)
    order = [*names, *reversed(names)] * args.rounds
    scratch = torch.empty(64 << 20, device=dev)  # 256 MB, five times the L2 cache
    before = (lambda: scratch.fill_(1.0)) if args.cold else (lambda: None)
    for case, ops in cases(dev).items():
        n, t_len, s = ops[0].shape
        outs = {k: torch.empty((n, t_len, s), device=dev) for k in names}
        for k in names:
            _call(libs[k], ops, outs[k])
        want = ctc_alpha_reference(*ops)
        line = {"case": case, "shape": [n, t_len, s], "cold": args.cold,
                "max_len": int(ops[3].clamp(1, t_len).max()),
                "equal_first": {k: torch.equal(outs[k], outs[names[0]]) for k in names},
                "max_abs_err": {k: (outs[k] - want).abs().max().item() for k in names},
                "device_ms": {k: [] for k in names}, "events_ms": {k: [] for k in names}}
        for k in order:
            fn = lambda k=k: _call(libs[k], ops, outs[k])  # noqa: E731
            line["device_ms"][k].append(_device_ms(fn, before))
            line["events_ms"][k].append(_events_ms(fn, before))
        for k in names:  # the chain alone, of the longest sample
            if hasattr(libs[k], "ocrs_ctc_alpha_probe"):
                probe = torch.zeros(3, device=dev, dtype=torch.int64)
                rc = libs[k].ocrs_ctc_alpha_probe(dev.index, line["max_len"], s,
                                                  _build.ptr(probe), _build.stream_ptr(dev))
                _build.check(libs[k], rc, "ctc_alpha_probe")
                cycles, ns, _ = probe.tolist()
                line.setdefault("chain_ms", {})[k] = ns / 1e6
                per_step = cycles / max(line["max_len"] - 1, 1)
                line.setdefault("chain_cycles_per_step", {})[k] = per_step
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
