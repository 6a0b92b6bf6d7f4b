"""Time builds of one kernel source against each other in one process.

    python -m ocrs_models_torch.kernel_ab [--kernel ctc_alpha|gru_fwd_bf16|gru_bwd_bf16|
        stage1_fwd_bf16|stage1_bwd_bf16|gru_wide_fwd|gru_wide_chain|gru_grid_f32_fwd|
        gru_grid_f32_chain] [--source NAME=PATH ...]
        [--rounds 2] [--cold] [--case TEXT]

Each ``--source`` is a version of the kernel's source (``csrc/ctc_alpha.cu``,
or ``csrc/gru_fwd.cu`` / ``csrc/gru_bwd.cu`` for the bf16 biGRU entries;
the current one, named ``new``, when none is given; another commit's copy
for an A/B, with the headers it includes beside it). Each is compiled by
``nvcc`` with the flags of ``ops/_build.py`` into ``build/ab/``, loaded with
``ctypes`` and called through its C entry. At every case the sources run in
turns, forward then backward (A B, B A) for ``--rounds`` rounds, and the
script prints one JSON line per case with each source's device time per
call (``torch.profiler``: the kernel alone, and for ``gru_bwd_bf16`` also by
phase: ``coef``, ``chain``, ``dw``, ``dw_sum``), its events time over a loop
of calls, whether its outputs equal the first source's bit for bit, and
how far they are from the plain version's.

``ctc_alpha`` (its C entry ``ocrs_ctc_alpha``; a source that exports
``ocrs_ctc_alpha_probe`` also gets its chain alone, ``chain_ms``), cases
(N, T, S): the five of ``chip_smoke.py`` phase 7 (``ragged``, ``headline``,
``headline_padded``, ``wide``, ``wide_padded``), and more that take them
apart: ``wide_padded`` operands with ``ragged`` lengths and the reverse,
``wide_padded`` at N=120, 112, 96, 16 and 1 (a call's 34 MB of emissions
and states shrunk step by step), ``headline_padded`` at N=128 (one
block on an SM, where N=256 puts two on most), and past a block of
positions, ``long_s1025`` and ``long_s2049``: ``ragged``'s lengths in label
arrays 512 and 1024 wide, row 2 holding a line of 449 (960) characters
that its 20 steps cannot fit (several positions a thread).

``gru_fwd_bf16`` and ``gru_bwd_bf16`` (C entries ``ocrs_gru_fwd_bf16`` and
``ocrs_gru_bwd_bf16``; the backward's two scratch layouts, the parent's f32
``dph`` and the current bf16 ``dhn`` with per-tile ``db`` partials, both fit
the buffers given), cases (T, N) at H=256: the smoke's two shapes each
(forward 201 x 128 and 65 x 256, backward 257 x 128 and 65 x 256), and the
trainer's batches 20 and 12 at T=129. A source that exports
``ocrs_gru_{fwd,bwd}_bf16_rows`` is also timed at each of its row choices
(``rows_ms``), with the rows it picks by itself in ``rows``.

``stage1_fwd_bf16`` and ``stage1_bwd_bf16`` (C entries ``ocrs_stage1_fwd_bf16``
and ``ocrs_stage1_bwd_bf16``; a source that exports
``ocrs_stage1_takes_weight_and_bias`` takes weight [32, 9] and bias [32]
and gives dW and db, an older one a [32, 10] array each way), cases
``N{n}_W{w}`` at H=64: the smoke's shapes (forward [128, 256] and [128,
800], backward [128, 1024] and [256, 256]), the trainer's batches 20 and 12
at W = 256, 512, 768, 1024, and the serving buckets W = 256, 512, 768, 800
at N = 128. Each line also carries ``f32_sha``, a digest of each source's
f32 entry's outputs on the same inputs (equal digests: the f32 kernel
unchanged, bit for bit), and for the backward its grid.

``gru_wide_fwd`` and ``gru_wide_chain`` (``csrc/gru_wide.cu``): the wide
route's forms against each other, its persistent entries
(``ocrs_gru_wide_fwd[_bf16]``, ``ocrs_gru_wide_chain[_bf16]``) and its per-step
ones (``ocrs_gru_wide_fwd_stepwise[_bf16]``, ``ocrs_gru_wide_chain_stepwise[_bf16]``,
which take any H % 8 == 0), at T=257, N=128, H=512 in f32 and bf16, and at
H=264 and 320; and at H=1024 the per-step form (f32 and bf16) against the
grid form (bf16: ``csrc/gru_grid.cu``'s ``ocrs_gru_grid_fwd_bf16``,
``ocrs_gru_grid_chain_bf16``, with the plan of ``ops.gru.grid_plan`` for
the card, ``rows`` giving its units and rows a block, its blocks and W_hh's
split into resident and streamed k16 steps; f32: ``csrc/gru_grid_f32.cu``'s
``ocrs_gru_grid_f32_fwd``, ``ocrs_gru_grid_f32_chain``, with
``ops.gru.grid_f32_plan``'s, ``rows`` giving its A ring stages; both
with each kernel's split of W_hh, ``w_split``; both always the
checkout's build),
and so in bf16 at H=1448 and 2048, where the grid form streams part of
W_hh, and at 5288 (``T257_N128_H5288_bf16``: a per-gate plan, 88 units a
block, W_hh streamed from device memory): one case per (shape, dtype,
form), each form's
device time the sum over its kernels of the mean record times the
kernel's launches a call (T for a per-step kernel). The chain's inputs are
the plain versions' coefficients of a plain forward; its outputs are held
against the plain chain. A source that exports
``ocrs_gru_wide_fwd_max_clusters`` also gets its rows per block and
clusters (``rows``). The chain's cases above H=512 also time the
backward's other phases on the same operands (``split_ms``, events):
``coef`` and ``dw`` (with ``dw_sum``) as ``gru_wide_bwd`` runs them there;
in bf16 ``csrc/gru_bwd_wide.cu``'s (on ``wgmma``) in both tile orders
(``coef_order_0``, ``dw_order_0``: the plain one), up to H=2048 the same
phases of ``csrc/gru_bwd.cu`` (``mma.sync``; ``coef_mma_sync``,
``dw_mma_sync``) and W_hh's cast; in f32 (3xTF32) ``csrc/gru_bwd_wide.cu``'s
``f32::`` kernels (``wgmma``, both tile orders) beside ``csrc/gru_bwd.cu``'s
(``mma.sync``), the A/B of those phases. ``--case TEXT`` runs
only the cases whose name holds TEXT (``T257_N128_H1024_f32``: both forms
of f32 at H=1024).

``gru_grid_f32_fwd`` and ``gru_grid_f32_chain`` (``csrc/gru_grid_f32.cu``):
the f32 grid form's entries alone, one source against another, at
T=257, N=128 and H = 1024, 1056 (the widest resident plan, 3 ring stages),
520 (33 unit tiles, two row tiles), 1064, 1448 (24 units a block, W_hh
partly streamed) and 2048 (32 units); the chain's cases with ``split_ms``
as above.

``--cold`` writes a 256 MB buffer before each call so that no input is
left in the 50 MB L2 cache. Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .ops import _build
from .ops.ctc import ctc_alpha_reference, ctc_operands
from .ops import gru as gru_ops
from .ops.gru import (
    DW_SPLITS,
    MIN_ROWS,
    gru_bwd_chain_bf16_reference,
    gru_bwd_chain_reference,
    gru_bwd_coefficients_reference,
    gru_bwd_phases_reference,
    gru_recurrence_reference,
)
from .ops.stage1 import stage1_bwd_reference, stage1_reference
from .profile_kernels import device_records

SEED = 1234
GRU_ROWS = (16, 32, 48, 64)
P, I = ctypes.c_void_p, ctypes.c_int


def _load(kernel: str, name: str, src: Path) -> ctypes.CDLL:
    """``src`` built into ``build/ab/`` (once for a given text of the source
    and of the headers beside the checkout's kernels: a later run with
    another ``--kernel`` reuses it) and bound for ``kernel``."""
    ab_dir = _build.build_dir().parent / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(_build.CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = ab_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(lib), str(src)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
    dll = ctypes.CDLL(str(lib))
    dll.ocrs_error_string.argtypes = [I]
    dll.ocrs_error_string.restype = ctypes.c_char_p
    SPECS[kernel]["bind"](dll)
    return dll


def _bind(fn, argtypes) -> None:
    fn.argtypes = argtypes
    fn.restype = I


# ------------------------------------------------------------------ ctc_alpha

def _bind_ctc(dll) -> None:
    _bind(dll.ocrs_ctc_alpha, [I, P, P, P, P, P, I, I, I, I, P])
    if hasattr(dll, "ocrs_ctc_alpha_probe"):
        _bind(dll.ocrs_ctc_alpha_probe, [I, I, I, P, P])


def _ctc_operands(dev, gen, n, t_len, label_width, label_len, input_len, repeats=False):
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


def _ctc_cases(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    n, t_len = 128, 257
    rng = np.random.default_rng(SEED)
    label_len = rng.integers(6, 49, n)
    label_len[0], label_len[2] = 0, 40  # an empty label, and one that cannot fit
    input_len = rng.integers(160, t_len, n)
    input_len[2] = 20
    out = {"ragged": _ctc_operands(dev, gen, n, t_len, 64, label_len, input_len, repeats=True)}
    for what, n_b, width, chars in (("headline", 256, 256, 24), ("wide", 128, 1024, 48)):
        for label_width, key in ((chars, what), (64, f"{what}_padded")):
            out[key] = _ctc_operands(dev, gen, n_b, width // 4 + 1, label_width,
                                     np.full(n_b, chars), np.full(n_b, width // 4))
    ragged, padded = out["ragged"], out["wide_padded"]
    out["wide_padded_data+ragged_lens"] = (*padded[:3], ragged[3])
    out["ragged_data+full_lens"] = (*ragged[:3], padded[3])
    for n_small in (120, 112, 96, 16, 1):
        out[f"wide_padded_n{n_small}"] = tuple(t[:n_small].contiguous() for t in padded)
    out["headline_padded_n128"] = tuple(t[:128].contiguous() for t in out["headline_padded"])
    for label_width, long_len in ((512, 449), (1024, 960)):
        lens = label_len.copy()
        lens[2] = long_len
        out[f"long_s{2 * label_width + 1}"] = _ctc_operands(dev, gen, n, t_len, label_width, lens,
                                                            input_len, repeats=True)
    return out


def _ctc_outputs(ops) -> dict:
    return {"alpha": torch.empty(ops[0].shape, device=ops[0].device)}


def _ctc_call(dll, ops, out, rows=0) -> None:
    emit, skip, alpha0, lens = ops
    n, t_len, s = emit.shape
    ptrs = (_build.ptr(t) for t in (emit, skip, alpha0, lens, out["alpha"]))
    rc = dll.ocrs_ctc_alpha(emit.device.index, *ptrs, n, t_len, s, 0, _build.stream_ptr(emit.device))
    _build.check(dll, rc, "ctc_alpha")


def _ctc_compare(ops, out, dll=None) -> dict:
    return {"max_abs_err": (out["alpha"] - ctc_alpha_reference(*ops)).abs().max().item()}


def _ctc_extra(dll, ops, line, k) -> None:
    """The chain alone, of the longest sample."""
    line["max_len"] = int(ops[3].clamp(1, ops[0].shape[1]).max())
    if hasattr(dll, "ocrs_ctc_alpha_probe"):
        dev = ops[0].device
        probe = torch.zeros(3, device=dev, dtype=torch.int64)
        rc = dll.ocrs_ctc_alpha_probe(dev.index, line["max_len"], ops[0].shape[2],
                                      _build.ptr(probe), _build.stream_ptr(dev))
        _build.check(dll, rc, "ctc_alpha_probe")
        cycles, ns, _ = probe.tolist()
        line.setdefault("chain_ms", {})[k] = ns / 1e6
        line.setdefault("chain_cycles_per_step", {})[k] = cycles / max(line["max_len"] - 1, 1)


# ------------------------------------------------------------------ biGRU, bf16

def _bind_gru_fwd(dll) -> None:
    _bind(dll.ocrs_gru_fwd_bf16, [I, P, P, P, P, P, P, I, I, I, P])
    _bind(dll.ocrs_gru_fwd_bf16_max_clusters, [I, I, I, ctypes.POINTER(I)])
    if hasattr(dll, "ocrs_gru_fwd_bf16_rows"):
        _bind(dll.ocrs_gru_fwd_bf16_rows, [I, P, P, P, P, P, P, I, I, I, I, P])


def _bind_gru_bwd(dll) -> None:
    _bind(dll.ocrs_gru_bwd_bf16, [I] + [P] * 16 + [I, I, I, I, P])
    _bind(dll.ocrs_gru_bwd_bf16_max_clusters, [I, I, I, ctypes.POINTER(I)])
    if hasattr(dll, "ocrs_gru_bwd_bf16_rows"):
        _bind(dll.ocrs_gru_bwd_bf16_rows, [I] + [P] * 16 + [I, I, I, I, I, P])


def _gru_case(dev, gen, t_len, n, hid=256) -> tuple:
    """bf16 ``px_f, px_b, ys_f, ys_b, dy_f, dy_b`` and f32 ``w_hh`` (bf16
    values) and ``b_hh``; ``ys`` from the plain forward."""
    k = 1.0 / hid**0.5
    bf = torch.bfloat16
    px = [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev, bf) for _ in range(2)]
    w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    w_hh = _build.rounded(w_hh, bf).contiguous()
    b_hh = ((torch.rand((2, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
    dy = [(torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev, bf) for _ in range(2)]
    ys = gru_recurrence_reference(*px, w_hh, b_hh)
    return (*px, *ys, *dy, w_hh, b_hh)


def _gru_cases(shapes):
    def cases(dev) -> dict:
        gen = torch.Generator().manual_seed(SEED)
        return {f"T{t}_N{n}": _gru_case(dev, gen, t, n) for t, n in shapes}
    return cases


def _gru_fwd_outputs(ops) -> dict:
    return {"ys_f": torch.empty_like(ops[2]), "ys_b": torch.empty_like(ops[3])}


def _gru_fwd_call(dll, ops, out, rows=0) -> None:
    px_f, px_b, _, _, _, _, w_hh, b_hh = ops
    t_len, n, h3 = px_f.shape
    ptrs = [_build.ptr(t) for t in (px_f, px_b, w_hh, b_hh, out["ys_f"], out["ys_b"])]
    stream = _build.stream_ptr(px_f.device)
    if rows:
        rc = dll.ocrs_gru_fwd_bf16_rows(px_f.device.index, *ptrs, t_len, n, h3 // 3, rows, stream)
    else:
        rc = dll.ocrs_gru_fwd_bf16(px_f.device.index, *ptrs, t_len, n, h3 // 3, stream)
    _build.check(dll, rc, "gru_fwd_bf16")


def _gru_fwd_compare(ops, out, dll=None) -> dict:
    want = gru_recurrence_reference(ops[0], ops[1], ops[6], ops[7])
    got = (out["ys_f"], out["ys_b"])
    return _bf16_errs(got, want)


def _bf16_errs(got, want) -> dict:
    return {"max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
            "equal_share": sum(int((a == b).sum()) for a, b in zip(got, want))
            / sum(a.numel() for a in got)}


def _splits(t_len: int, n: int) -> int:
    return max(1, min(DW_SPLITS, t_len * n // 512))  # as ops.gru.gru_bwd


def _gru_bwd_outputs(ops) -> dict:
    px_f, _, _, _, _, _, w_hh, b_hh = ops
    t_len, n, h3 = px_f.shape
    hid, dev, f32 = h3 // 3, px_f.device, torch.float32
    splits = _splits(t_len, n)
    return {
        "dpx_f": torch.empty_like(px_f), "dpx_b": torch.empty_like(px_f),
        "coef": torch.empty((2, t_len * n, 5, hid), device=dev, dtype=f32),
        # The parent's f32 dph [2, T*N, 3H], or the current bf16 dhn [2, T*N, H].
        "dph": torch.empty((2, t_len * n, h3), device=dev, dtype=f32),
        "dwp": torch.empty((splits, 2, hid, h3), device=dev, dtype=f32),
        "dbp": torch.empty((max(splits, -(-n // MIN_ROWS)), 2, h3), device=dev, dtype=f32),
        "dw": torch.empty_like(w_hh), "db": torch.empty_like(b_hh),
    }


def _gru_bwd_call(dll, ops, out, rows=0) -> None:
    px_f = ops[0]
    t_len, n, h3 = px_f.shape
    keys = ("dpx_f", "dpx_b", "coef", "dph", "dwp", "dbp", "dw", "db")
    ptrs = [_build.ptr(t) for t in ops] + [_build.ptr(out[k]) for k in keys]
    dims = (_splits(t_len, n), t_len, n, h3 // 3)
    stream = _build.stream_ptr(px_f.device)
    if rows:
        rc = dll.ocrs_gru_bwd_bf16_rows(px_f.device.index, *ptrs, *dims, rows, stream)
    else:
        rc = dll.ocrs_gru_bwd_bf16(px_f.device.index, *ptrs, *dims, stream)
    _build.check(dll, rc, "gru_bwd_bf16")


def _gru_bwd_compare(ops, out, dll=None) -> dict:
    want = gru_bwd_phases_reference(*ops)
    errs = _bf16_errs((out["dpx_f"], out["dpx_b"]), want[:2])
    scale = max(t.abs().max().item() for t in want[2:])
    errs["dw_db_err_of_max"] = max((out[k] - w).abs().max().item()
                                   for k, w in zip(("dw", "db"), want[2:])) / scale
    return errs


def _gru_extra(kernel: str):
    def extra(dll, ops, line, k) -> None:
        rows = ctypes.c_int(0)
        n, hid = ops[0].shape[1], ops[0].shape[2] // 3
        cap = getattr(dll, f"ocrs_{kernel}_max_clusters")(ops[0].device.index, n, hid,
                                                          ctypes.byref(rows))
        line.setdefault("rows", {})[k] = {"rows": rows.value, "launched": 2 * -(-n // rows.value),
                                          "max_active": cap}
    return extra


def _gru_bwd_phase(name: str) -> str:
    for part in ("dw_sum", "coef", "chain"):
        if part in name:
            return part
    return "dw"


# ------------------------------------------------------------------ biGRU, wide route

def _bind_gru_wide(dll) -> None:
    for sfx in ("", "_bf16"):
        _bind(getattr(dll, f"ocrs_gru_wide_fwd{sfx}"), [I] + [P] * 6 + [I, I, I, P])
        _bind(getattr(dll, f"ocrs_gru_wide_fwd_stepwise{sfx}"), [I] + [P] * 7 + [I, I, I, P])
        for kind in ("fwd", "chain"):
            _bind(getattr(dll, f"ocrs_gru_wide_{kind}{sfx}_max_clusters"),
                  [I, I, I, ctypes.POINTER(I)])
    _bind(dll.ocrs_gru_wide_chain, [I] + [P] * 6 + [I, I, I, P])
    _bind(dll.ocrs_gru_wide_chain_bf16, [I] + [P] * 8 + [I, I, I, I, P])
    _bind(dll.ocrs_gru_wide_chain_stepwise, [I] + [P] * 8 + [I, I, I, P])
    _bind(dll.ocrs_gru_wide_chain_stepwise_bf16, [I] + [P] * 10 + [I, I, I, P])
    _bind(dll.ocrs_gru_wide_stepwise_rows, [])


WIDE_SHAPES = ((257, 128, 512), (257, 128, 264), (257, 128, 320), (257, 128, 1024),
               (257, 128, 1448), (257, 128, 2048), (257, 128, 5288))
WIDE_F32_MAX = 1024  # widest width of WIDE_SHAPES also timed in f32


def _wide_forms(hid: int, dt: torch.dtype) -> tuple[str, ...]:
    """The forms timed against each other at padded width ``hid``."""
    if hid <= gru_ops.MAX_WIDE_HIDDEN:
        return "persistent", "stepwise"
    return ("grid", "stepwise") if gru_ops.gru_route(hid, dt) == "grid" else ("stepwise",)


def _gru_wide_cases(dev, only: str = "", shapes=WIDE_SHAPES,
                    dtypes=((torch.float32, "f32"), (torch.bfloat16, "bf16")),
                    f32_max: int = WIDE_F32_MAX) -> dict:
    """``(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, coef, form)`` per
    (shape, dtype, form) whose name holds ``only``: w_hh rounded to bf16
    values for bf16, ys from the plain forward, coef [2, T*N, 5, H] the
    plain coefficients."""
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for t_len, n, hid in shapes:
        for dt, tag in dtypes:
            forms = [f for f in _wide_forms(hid, dt) if only in f"T{t_len}_N{n}_H{hid}_{tag}_{f}"]
            if (dt == torch.float32 and hid > f32_max) or not forms:
                continue
            k = 1.0 / hid**0.5
            px = [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev, dt) for _ in range(2)]
            w_hh = _build.rounded(((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) * k)
                                  .to(dev), dt).contiguous()
            b_hh = ((torch.rand((2, 3 * hid), generator=gen) * 2 - 1) * k).to(dev)
            dy = [(torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev, dt) for _ in range(2)]
            ys = gru_recurrence_reference(*px, w_hh, b_hh)
            coef = gru_bwd_coefficients_reference(*px, *ys, w_hh, b_hh).reshape(
                2, t_len * n, 5, hid).contiguous()
            for form in forms:
                out[f"T{t_len}_N{n}_H{hid}_{tag}_{form}"] = (*px, *ys, *dy, w_hh, b_hh, coef, form)
    return out


GRID_F32_SHAPES = ((257, 128, 1024), (257, 128, 1056), (257, 128, 520), (257, 128, 1064),
                   (257, 128, 1448), (257, 128, 2048))


def _grid_f32_cases(dev, only: str = "") -> dict:
    """The f32 grid form's cases of :func:`_gru_wide_cases` at
    GRID_F32_SHAPES."""
    cases = _gru_wide_cases(dev, only, GRID_F32_SHAPES, ((torch.float32, "f32"),),
                            gru_ops.GRID_F32_MAX_HIDDEN)
    return {k: v for k, v in cases.items() if v[-1] == "grid"}


def _bind_grid_f32(dll) -> None:
    ll = ctypes.c_longlong
    _bind(dll.ocrs_gru_grid_f32_fwd, [I] + [P] * 9 + [ll] + [I] * 8 + [P])
    _bind(dll.ocrs_gru_grid_f32_chain, [I] + [P] * 10 + [ll] + [I] * 8 + [P])


def _grid_plan(ops) -> gru_ops.GridPlan | gru_ops.GridF32Plan:
    t_len, n, h3 = ops[0].shape
    return gru_ops.wide_form(n, h3 // 3, ops[0].dtype, ops[0].device.index)[1]


def _grid_stream(kind: str, hid: int, ops) -> torch.Tensor:
    """The grid form's scratch of streamed chunks of ``kind`` (empty where
    the plan streams none)."""
    wst, _ = gru_ops._grid_stream(kind, hid, _grid_plan(ops), ops[0].device)
    return torch.empty((0,), device=ops[0].device) if wst is None else wst


def _wst(out) -> tuple:
    """The streamed chunks' pointer (None where empty) and length."""
    wst = out["wst"]
    return (_build.ptr(wst) if wst.numel() else None), wst.numel()


def _sfx(ops) -> str:
    return "_bf16" if ops[0].dtype == torch.bfloat16 else ""


def _gru_wide_fwd_outputs(ops) -> dict:
    t_len, n, h3 = ops[0].shape
    out = {"ys_f": torch.empty_like(ops[2]), "ys_b": torch.empty_like(ops[3]),
           "hs": torch.empty((2, 2, n, h3 // 3), device=ops[0].device)}
    if ops[-1] == "grid":
        out["ctr"] = torch.empty((2 * n,), device=ops[0].device, dtype=torch.int32)
        out["wst"] = _grid_stream("fwd", h3 // 3, ops)
        if ops[0].dtype == torch.bfloat16:
            out["frag"] = gru_ops._grid_frag(n, h3 // 3, ops[0].device)
    return out


def _gru_wide_fwd_call(dll, ops, out, rows=0) -> None:
    px_f, px_b, w_hh, b_hh, form = ops[0], ops[1], ops[6], ops[7], ops[-1]
    t_len, n, h3 = px_f.shape
    ptr = _build.ptr
    dev, stream = px_f.device, _build.stream_ptr(px_f.device)
    if form == "grid" and px_f.dtype == torch.float32:
        # The source under test where it is gru_grid_f32.cu, else the checkout's.
        dll = dll if hasattr(dll, "ocrs_gru_grid_f32_fwd") else gru_ops._grid_f32_lib()
        plan = _grid_plan(ops)
        rc = dll.ocrs_gru_grid_f32_fwd(
            dev.index, ptr(px_f), ptr(px_b), ptr(w_hh), ptr(b_hh), ptr(out["hs"]), ptr(out["ys_f"]),
            ptr(out["ys_b"]), ptr(out["ctr"]), *_wst(out), t_len, n, h3 // 3, plan.units,
            plan.rows, plan.stages, plan.fwd.resident, plan.fwd.stages, stream)
    elif form == "grid":
        dll = gru_ops._grid_lib()
        plan = _grid_plan(ops)
        rc = dll.ocrs_gru_grid_fwd_bf16(
            dev.index, ptr(px_f), ptr(px_b), ptr(w_hh), ptr(b_hh), ptr(out["hs"]), ptr(out["frag"]),
            ptr(out["ys_f"]), ptr(out["ys_b"]), ptr(out["ctr"]), *_wst(out), t_len, n, h3 // 3,
            plan.units, plan.rows, plan.fwd.resident, plan.fwd.stages, plan.fwd.pass_rows, stream)
    elif form == "persistent":
        rc = getattr(dll, f"ocrs_gru_wide_fwd{_sfx(ops)}")(
            dev.index, ptr(px_f), ptr(px_b), ptr(w_hh), ptr(b_hh), ptr(out["ys_f"]),
            ptr(out["ys_b"]), t_len, n, h3 // 3, stream)
    else:
        rc = getattr(dll, f"ocrs_gru_wide_fwd_stepwise{_sfx(ops)}")(
            dev.index, ptr(px_f), ptr(px_b), ptr(w_hh), ptr(b_hh), ptr(out["hs"]),
            ptr(out["ys_f"]), ptr(out["ys_b"]), t_len, n, h3 // 3, stream)
    _build.check(dll, rc, f"gru_wide_fwd ({form})")


def _gru_wide_fwd_compare(ops, out, dll=None) -> dict:
    want = gru_recurrence_reference(ops[0], ops[1], ops[6], ops[7])
    return _bf16_errs((out["ys_f"], out["ys_b"]), want)


def _gru_wide_chain_outputs(ops) -> dict:
    px_f, w_hh = ops[0], ops[6]
    t_len, n, h3 = px_f.shape
    hid, dev, f32 = h3 // 3, px_f.device, torch.float32
    out = {"dpx_f": torch.empty_like(px_f), "dpx_b": torch.empty_like(px_f),
           "w_t": w_hh.transpose(1, 2).contiguous(),
           "dph": torch.empty((2, 2, n, h3), device=dev, dtype=f32),
           "carry": torch.empty((2, n, hid), device=dev, dtype=f32)}
    if px_f.dtype == torch.bfloat16:  # bf16(dhn) and db's partials, one per tile of >= 16 rows
        out["dhn"] = torch.empty((2, t_len * n, hid), device=dev, dtype=torch.bfloat16)
        out["dbp"] = torch.empty((-(-n // 16), 2, h3), device=dev, dtype=f32)
    if ops[-1] == "grid":
        out["ctr"] = torch.empty((2 * n,), device=dev, dtype=torch.int32)
        out["wst"] = _grid_stream("chain", hid, ops)
        if px_f.dtype == torch.bfloat16:
            out["frag"] = gru_ops._grid_frag(n, h3, dev)
    return out


def _gru_wide_chain_call(dll, ops, out, rows=0) -> None:
    dy_f, dy_b, w_hh, coef, form = ops[4], ops[5], ops[6], ops[8], ops[-1]
    t_len, n, hid = dy_f.shape
    ptr = _build.ptr
    dev, stream = dy_f.device, _build.stream_ptr(dy_f.device)
    bf16 = dy_f.dtype == torch.bfloat16
    extra = [ptr(out["dhn"]), ptr(out["dbp"])] if bf16 else []
    if form == "grid" and not bf16:
        dll = dll if hasattr(dll, "ocrs_gru_grid_f32_chain") else gru_ops._grid_f32_lib()
        plan = _grid_plan(ops)
        rc = dll.ocrs_gru_grid_f32_chain(
            dev.index, ptr(dy_f), ptr(dy_b), ptr(w_hh), ptr(coef), ptr(out["dph"]),
            ptr(out["carry"]), ptr(out["dpx_f"]), ptr(out["dpx_b"]), ptr(out["ctr"]), *_wst(out),
            t_len, n, hid, plan.units, plan.rows, plan.stages, plan.chain.resident,
            plan.chain.stages, stream)
    elif form == "grid":
        dll = gru_ops._grid_lib()
        plan = _grid_plan(ops)
        rc = dll.ocrs_gru_grid_chain_bf16(
            dev.index, ptr(dy_f), ptr(dy_b), ptr(w_hh), ptr(coef), ptr(out["carry"]),
            ptr(out["frag"]), ptr(out["dpx_f"]), ptr(out["dpx_b"]), *extra, out["dbp"].shape[0],
            ptr(out["ctr"]), *_wst(out), t_len, n, hid, plan.units, plan.rows,
            plan.chain.resident, plan.chain.stages, plan.chain.pass_rows, stream)
    elif form == "persistent":
        parts = [out["dbp"].shape[0]] if bf16 else []
        rc = getattr(dll, f"ocrs_gru_wide_chain{_sfx(ops)}")(
            dev.index, ptr(dy_f), ptr(dy_b), ptr(w_hh), ptr(coef), ptr(out["dpx_f"]),
            ptr(out["dpx_b"]), *extra, *parts, t_len, n, hid, stream)
    else:
        rc = getattr(dll, f"ocrs_gru_wide_chain_stepwise{_sfx(ops)}")(
            dev.index, ptr(dy_f), ptr(dy_b), ptr(out["w_t"]), ptr(coef), ptr(out["dph"]),
            ptr(out["carry"]), ptr(out["dpx_f"]), ptr(out["dpx_b"]), *extra, t_len, n, hid,
            stream)
    _build.check(dll, rc, f"gru_wide_chain ({form})")


def _gru_wide_chain_compare(ops, out, dll=None) -> dict:
    dy_f, dy_b, w_hh, coef = ops[4], ops[5], ops[6], ops[8]
    t_len, n, hid = dy_f.shape
    coef = coef.reshape(2, t_len, n, 5, hid)
    if dy_f.dtype == torch.bfloat16:
        dpx_f, dpx_b, dhn, _ = gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh)
        errs = _bf16_errs((out["dpx_f"], out["dpx_b"]), (dpx_f, dpx_b))
        errs["dhn_equal_share"] = _bf16_errs((out["dhn"].reshape(dhn.shape),), (dhn,))["equal_share"]
        return errs
    dpx_f, dpx_b, _ = gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh)
    return _bf16_errs((out["dpx_f"], out["dpx_b"]), (dpx_f, dpx_b))


def _gru_wide_extra(kind: str):
    def extra(dll, ops, line, k) -> None:
        wide_only = ops[0].shape[-1] // 3 > gru_ops.MAX_WIDE_HIDDEN
        if kind == "chain" and wide_only and "split_ms" not in line:
            line["split_ms"] = _bwd_split_ms(ops)
        if ops[-1] == "grid":
            plan = _grid_plan(ops)
            t_len, n, h3 = ops[0].shape
            line.setdefault("rows", {})[k] = {
                "units": plan.units, "rows": plan.rows,
                "blocks": 2 * -(-n // plan.rows) * -(-h3 // 3 // plan.units),
                **({"stages": plan.stages} if isinstance(plan, gru_ops.GridF32Plan) else {}),
                "w_split": {"fwd": plan.fwd._asdict(), "chain": plan.chain._asdict()}}
            return
        if ops[-1] != "persistent":
            line.setdefault("rows", {})[k] = {"rows": dll.ocrs_gru_wide_stepwise_rows()}
            return
        rows = ctypes.c_int(0)
        t_len, n, h3 = ops[0].shape
        cap = getattr(dll, f"ocrs_gru_wide_{kind}{_sfx(ops)}_max_clusters")(
            ops[0].device.index, n, h3 // 3, ctypes.byref(rows))
        line.setdefault("rows", {})[k] = {"rows": rows.value, "launched": 2 * -(-n // rows.value),
                                          "max_active": cap}
    return extra


MMA_SYNC_MAX = 2048  # widest H whose split also times gru_bwd.cu's bf16 coef and dw


def _bwd_split_ms(ops) -> dict:
    """The backward's phases around its chain on the case's operands, by
    CUDA events, as ``ops.gru.gru_wide_bwd`` runs them above H=512. bf16:
    ``coef`` and ``dw`` (with ``dw_sum``, one C call) of
    ``gru_bwd_wide.cu`` (``wgmma``, with its row ranges) in the wrapper's
    tile order (``ops.gru.BWD_WIDE_ORDER``) and in the other
    (``coef_order_0``, ``dw_order_0``: the plain order, the unit or column
    tiles fastest), up to ``MMA_SYNC_MAX`` the same phases of
    ``gru_bwd.cu`` (``mma.sync``, with ``_dw_splits``'s ranges for it), and
    W_hh's cast to bf16 values. f32 (3xTF32 on the tensor cores): the same
    of ``gru_bwd_wide.cu``'s ``f32::`` kernels on ``wgmma`` (each C call
    with its pre-pass), in both tile orders, beside ``gru_bwd.cu``'s
    (``mma.sync``; ``coef_mma_sync``, ``dw_mma_sync``, with its ranges)
    at every width: the A/B of the phases this port replaced."""
    px_f, px_b, ys_f, ys_b = ops[:4]
    w_hh, b_hh = ops[6], ops[7]
    t_len, n, h3 = px_f.shape
    hid, dev = h3 // 3, px_f.device
    lib, ptr, stream = gru_ops._bwd_lib(), _build.ptr, _build.stream_ptr(dev)
    coef = torch.empty((2, t_len * n, 5, hid), device=dev)
    splits = gru_ops._dw_splits(t_len, n)
    dpx = [torch.zeros_like(px_f) for _ in range(2)]
    dw, db = torch.empty_like(w_hh), torch.empty_like(b_hh)
    if px_f.dtype == torch.float32:
        wide = gru_ops._bwd_wide_lib()
        splits_tc = gru_ops._dw_splits(t_len, n, hid)
        dwp = torch.empty((max(splits, splits_tc), 2, hid, h3), device=dev)
        dbp = torch.empty((max(splits, splits_tc), 2, h3), device=dev)
        wt = torch.empty((2, 2, h3, hid), device=dev)
        yt = torch.empty((2, 2, hid, wide.ocrs_gru_bwd_dw_wide_f32_pitch(t_len, n)), device=dev)
        order = gru_ops.BWD_WIDE_ORDER
        calls = {
            f"{name}{'' if o == order else '_order_' + str(o)}": fn
            for o in (order, 1 - order) for name, fn in (
                ("coef", lambda o=o: wide.ocrs_gru_bwd_coef_wide_f32(
                    dev.index, ptr(px_f), ptr(px_b), ptr(ys_f), ptr(ys_b), ptr(w_hh), ptr(b_hh),
                    ptr(wt), ptr(coef), t_len, n, hid, o, stream)),
                ("dw", lambda o=o: wide.ocrs_gru_bwd_dw_wide_f32(
                    dev.index, ptr(ys_f), ptr(ys_b), ptr(dpx[0]), ptr(dpx[1]), ptr(coef), ptr(yt),
                    ptr(dwp), ptr(dbp), ptr(dw), ptr(db), splits_tc, t_len, n, hid, o, stream)))}
        calls.update({
            "coef_mma_sync": lambda: lib.ocrs_gru_bwd_coef(
                dev.index, ptr(px_f), ptr(px_b), ptr(ys_f), ptr(ys_b), ptr(w_hh), ptr(b_hh),
                ptr(coef), t_len, n, hid, stream),
            "dw_mma_sync": lambda: lib.ocrs_gru_bwd_dw(
                dev.index, ptr(ys_f), ptr(ys_b), ptr(dpx[0]), ptr(dpx[1]), ptr(coef), ptr(dwp),
                ptr(dbp), ptr(dw), ptr(db), splits, t_len, n, hid, stream),
        })
    else:
        wide = gru_ops._bwd_wide_lib()
        w16 = w_hh.to(torch.bfloat16)
        splits_tc = gru_ops._dw_splits(t_len, n, hid, True)
        dhn = torch.zeros((2, t_len * n, hid), device=dev, dtype=torch.bfloat16)
        dbp = torch.zeros((1, 2, h3), device=dev)
        mma_sync = hid <= MMA_SYNC_MAX
        dwp = torch.empty((max(splits if mma_sync else 1, splits_tc), 2, hid, h3), device=dev)
        order = gru_ops.BWD_WIDE_ORDER
        calls = {
            f"{name}{'' if o == order else '_order_' + str(o)}": fn
            for o in (order, 1 - order) for name, fn in (
                ("coef", lambda o=o: wide.ocrs_gru_bwd_coef_wide_bf16(
                    dev.index, ptr(px_f), ptr(px_b), ptr(ys_f), ptr(ys_b), ptr(w16), ptr(b_hh),
                    ptr(coef), t_len, n, hid, o, stream)),
                ("dw", lambda o=o: wide.ocrs_gru_bwd_dw_wide_bf16(
                    dev.index, ptr(ys_f), ptr(ys_b), ptr(dpx[0]), ptr(dpx[1]), ptr(dhn), ptr(dwp),
                    ptr(dbp), 1, ptr(dw), ptr(db), splits_tc, t_len, n, hid, o, stream)))}
        calls.update({} if not mma_sync else {
            "coef_mma_sync": lambda: lib.ocrs_gru_bwd_coef_bf16(
                dev.index, ptr(px_f), ptr(px_b), ptr(ys_f), ptr(ys_b), ptr(w_hh), ptr(b_hh),
                ptr(coef), t_len, n, hid, stream),
            "dw_mma_sync": lambda: lib.ocrs_gru_bwd_dw_bf16(
                dev.index, ptr(ys_f), ptr(ys_b), ptr(dpx[0]), ptr(dpx[1]), ptr(dhn), ptr(dwp),
                ptr(dbp), 1, ptr(dw), ptr(db), splits, t_len, n, hid, stream)})
        calls["cast"] = lambda: _build.rounded(w_hh, torch.bfloat16).contiguous()
    out = {}
    for name, fn in calls.items():
        rc = fn()
        if isinstance(rc, int):
            _build.check(lib, rc, f"kernel_ab split ({name})")
        out[name] = _events_ms(fn, lambda: None)
    return out


def _wide_launches(name: str, ops) -> int:
    """Launches a call of the wide kernel ``name``: T for a per-step one."""
    return ops[0].shape[0] if "_step_kernel" in name else 1


# ------------------------------------------------------------------ stage 1, bf16

def _bind_stage1_fwd(dll) -> None:
    split = hasattr(dll, "ocrs_stage1_takes_weight_and_bias")
    for fn in (dll.ocrs_stage1_fwd, dll.ocrs_stage1_fwd_bf16):
        _bind(fn, [I, P, P, P, P, I, I, I, P] if split else [I, P, P, P, I, I, I, P])


def _bind_stage1_bwd(dll) -> None:
    split = hasattr(dll, "ocrs_stage1_takes_weight_and_bias")
    for sfx in ("", "_bf16"):
        _bind(getattr(dll, f"ocrs_stage1_bwd{sfx}"),
              [I] + [P] * (7 if split else 5) + [I, I, I, I, P])
        _bind(getattr(dll, f"ocrs_stage1_bwd{sfx}_blocks"), [I, I, I, I])


def _stage1_cases(shapes):
    def cases(dev) -> dict:
        gen = torch.Generator().manual_seed(SEED)
        weight = (torch.randn((32, 1, 3, 3), generator=gen) * 0.3).to(dev)
        bias = (torch.randn((32,), generator=gen) * 0.1).to(dev)
        # The [32, 10] taps and bias of a source that takes them so: rounded
        # to bf16 values for its bf16 entry, as they are for its f32 one.
        w10 = torch.cat([weight.reshape(32, 9), bias[:, None]], 1).contiguous()
        w10_bf16 = _build.rounded(w10, torch.bfloat16).contiguous()
        out = {}
        for n, w in shapes:
            x = (torch.rand((n, 1, 64, w), generator=gen) - 0.5).to(dev, torch.bfloat16)
            dy = torch.randn((n, 32, 32, w // 2), generator=gen).to(dev, torch.bfloat16)
            out[f"N{n}_W{w}"] = (x, weight, bias, dy, w10_bf16, w10)
        return out
    return cases


def _weights(dll, ops) -> list:
    x, weight, bias, _, w10_bf16, w10 = ops
    if hasattr(dll, "ocrs_stage1_takes_weight_and_bias"):
        return [_build.ptr(weight), _build.ptr(bias)]
    return [_build.ptr(w10 if x.dtype == torch.float32 else w10_bf16)]


def _stage1_fwd_outputs(ops) -> dict:
    n, _, h, w = ops[0].shape
    return {"y": torch.empty((n, 32, h // 2, w // 2), device=ops[0].device, dtype=ops[0].dtype)}


def _stage1_fwd_call(dll, ops, out, rows=0) -> None:
    x = ops[0]
    n, _, h, w = x.shape
    entry = dll.ocrs_stage1_fwd if x.dtype == torch.float32 else dll.ocrs_stage1_fwd_bf16
    rc = entry(x.device.index, _build.ptr(x), *_weights(dll, ops), _build.ptr(out["y"]), n, h, w,
               _build.stream_ptr(x.device))
    _build.check(dll, rc, "stage1_fwd_bf16")


def _stage1_fwd_compare(ops, out, dll=None) -> dict:
    """Besides the largest difference and the share equal, the largest
    difference in bf16 ulps of the larger magnitude."""
    got, want = out["y"].float(), stage1_reference(*ops[:3]).float()
    errs = _bf16_errs((got,), (want,))
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    errs["max_ulps"] = ((got - want).abs() / ulp).max().item()
    return errs


def _stage1_bwd_outputs(ops) -> dict:
    dev, f32 = ops[0].device, torch.float32
    # dw10 for a source that gives the gradients as one [32, 10] array.
    return {"partial": torch.empty((4096, 320), device=dev, dtype=f32),
            "dw": torch.empty((32, 1, 3, 3), device=dev, dtype=f32),
            "db": torch.empty((32,), device=dev, dtype=f32),
            "dw10": torch.empty((32, 10), device=dev, dtype=f32)}


def _stage1_bwd_call(dll, ops, out, rows=0) -> None:
    x, dy = ops[0], ops[3]
    n, _, h, w = x.shape
    sfx = "" if x.dtype == torch.float32 else "_bf16"
    n_part = getattr(dll, f"ocrs_stage1_bwd{sfx}_blocks")(x.device.index, n, h, w)
    if not 0 <= n_part <= out["partial"].shape[0]:
        raise RuntimeError(f"stage1_bwd_bf16: grid {n_part}")
    grads = ([out["dw"], out["db"]] if hasattr(dll, "ocrs_stage1_takes_weight_and_bias")
             else [out["dw10"]])
    entry = getattr(dll, f"ocrs_stage1_bwd{sfx}")
    rc = entry(x.device.index, _build.ptr(x), *_weights(dll, ops), _build.ptr(dy),
               _build.ptr(out["partial"]), *(_build.ptr(g) for g in grads), n, h, w, n_part,
               _build.stream_ptr(x.device))
    _build.check(dll, rc, "stage1_bwd_bf16")


def _stage1_grads(dll, out) -> tuple:
    if hasattr(dll, "ocrs_stage1_takes_weight_and_bias"):
        return out["dw"].reshape(32, 9), out["db"]
    return out["dw10"][:, :9], out["dw10"][:, 9]


def _stage1_bwd_compare(ops, out, dll) -> dict:
    want = stage1_bwd_reference(*ops[:4])
    got = _stage1_grads(dll, out)
    scale = max(t.abs().max().item() for t in want)
    return {"dw_db_err_of_max": max((g.reshape(-1) - w_.reshape(-1)).abs().max().item()
                                    for g, w_ in zip(got, want)) / scale}


def _stage1_extra(kernel: str):
    """The bwd grid, and a digest of the f32 entry's outputs on the same
    inputs widened to f32 (``f32_sha``: equal digests, equal bits)."""
    def extra(dll, ops, line, k) -> None:
        f32 = (ops[0].float(), *ops[1:3], ops[3].float(), *ops[4:])
        outs = SPECS[kernel]["outputs"](f32)
        SPECS[kernel]["call"](dll, f32, outs)
        torch.cuda.synchronize()
        got = (outs["y"],) if kernel == "stage1_fwd_bf16" else _stage1_grads(dll, outs)
        digest = hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes() for t in got))
        line.setdefault("f32_sha", {})[k] = digest.hexdigest()[:16]
        if kernel == "stage1_bwd_bf16":
            n, _, h, w = ops[0].shape
            line.setdefault("grid", {})[k] = dll.ocrs_stage1_bwd_bf16_blocks(
                ops[0].device.index, n, h, w)
    return extra


def _stage1_shapes(serving: bool) -> tuple:
    """The smoke's shapes, the trainer's batches 20 and 12 at W = 256 to
    1024, and the serving buckets at N = 128."""
    smoke = ((128, 256), (128, 800)) if serving else ((128, 1024), (256, 256))
    trainer = tuple((n, w) for n in (20, 12) for w in (256, 512, 768, 1024))
    buckets = tuple((128, w) for w in (256, 512, 768, 800))
    return tuple(dict.fromkeys(smoke + trainer + buckets))


SPECS = {
    "ctc_alpha": {"source": "ctc_alpha.cu", "bind": _bind_ctc, "cases": _ctc_cases,
                  "outputs": _ctc_outputs, "call": _ctc_call, "compare": _ctc_compare,
                  "extra": _ctc_extra, "match": "ctc_alpha", "phase": None, "rows_entry": None},
    "gru_fwd_bf16": {"source": "gru_fwd.cu", "bind": _bind_gru_fwd,
                     "cases": _gru_cases(((201, 128), (65, 256), (129, 20), (129, 12))),
                     "outputs": _gru_fwd_outputs, "call": _gru_fwd_call,
                     "compare": _gru_fwd_compare, "extra": _gru_extra("gru_fwd_bf16"),
                     "match": "gru_fwd", "phase": None, "rows_entry": "ocrs_gru_fwd_bf16_rows"},
    "gru_bwd_bf16": {"source": "gru_bwd.cu", "bind": _bind_gru_bwd,
                     "cases": _gru_cases(((257, 128), (65, 256), (129, 20), (129, 12))),
                     "outputs": _gru_bwd_outputs, "call": _gru_bwd_call,
                     "compare": _gru_bwd_compare, "extra": _gru_extra("gru_bwd_bf16"),
                     "match": "gru_bwd", "phase": _gru_bwd_phase,
                     "rows_entry": "ocrs_gru_bwd_bf16_rows"},
    "stage1_fwd_bf16": {"source": "stage1_fwd.cu", "bind": _bind_stage1_fwd,
                        "cases": _stage1_cases(_stage1_shapes(serving=True)),
                        "outputs": _stage1_fwd_outputs, "call": _stage1_fwd_call,
                        "compare": _stage1_fwd_compare, "extra": _stage1_extra("stage1_fwd_bf16"),
                        "match": "stage1_fwd", "phase": None, "rows_entry": None},
    "stage1_bwd_bf16": {"source": "stage1_bwd.cu", "bind": _bind_stage1_bwd,
                        "cases": _stage1_cases(_stage1_shapes(serving=False)),
                        "outputs": _stage1_bwd_outputs, "call": _stage1_bwd_call,
                        "compare": _stage1_bwd_compare, "extra": _stage1_extra("stage1_bwd_bf16"),
                        "match": "stage1_bwd", "phase": lambda name: "finish" if "finish" in name
                        else "partial", "rows_entry": None, "grads": _stage1_grads},
    "gru_wide_fwd": {"source": "gru_wide.cu", "bind": _bind_gru_wide, "cases": _gru_wide_cases,
                     "outputs": _gru_wide_fwd_outputs, "call": _gru_wide_fwd_call,
                     "compare": _gru_wide_fwd_compare, "extra": _gru_wide_extra("fwd"),
                     "match": ("gru_wide", "gru_grid"), "phase": None, "rows_entry": None,
                     "launches": _wide_launches},
    "gru_grid_f32_fwd": {"source": "gru_grid_f32.cu", "bind": _bind_grid_f32,
                         "cases": _grid_f32_cases, "outputs": _gru_wide_fwd_outputs,
                         "call": _gru_wide_fwd_call, "compare": _gru_wide_fwd_compare,
                         "extra": _gru_wide_extra("fwd"), "match": "gru_grid_f32",
                         "phase": None, "rows_entry": None, "launches": _wide_launches},
    "gru_grid_f32_chain": {"source": "gru_grid_f32.cu", "bind": _bind_grid_f32,
                           "cases": _grid_f32_cases, "outputs": _gru_wide_chain_outputs,
                           "call": _gru_wide_chain_call, "compare": _gru_wide_chain_compare,
                           "extra": _gru_wide_extra("chain"), "match": "gru_grid_f32",
                           "phase": None, "rows_entry": None, "launches": _wide_launches},
    "gru_wide_chain": {"source": "gru_wide.cu", "bind": _bind_gru_wide, "cases": _gru_wide_cases,
                       "outputs": _gru_wide_chain_outputs, "call": _gru_wide_chain_call,
                       "compare": _gru_wide_chain_compare, "extra": _gru_wide_extra("chain"),
                       "match": ("gru_wide", "gru_grid"), "phase": None, "rows_entry": None,
                       "launches": _wide_launches},
}


def _device_ms(fn, before, match: str | tuple, phase=None, calls: int = 5,
               launches=lambda name: 1) -> tuple[float, dict]:
    """The profiler's device time of one call of the kernel, all its
    launches (the mean over the records each launch name delivered, times
    ``launches(name)`` a call; a window with none is profiled again, up to
    three times), and by phase name; ``before()`` runs ahead of each call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                before()
                fn()
            torch.cuda.synchronize()
        parts = (match,) if isinstance(match, str) else match
        found = {name: launches(name) * sum(v) / len(v)
                 for name, v in device_records(prof).items() if any(m in name for m in parts)}
        if found:
            break
    phases: dict[str, float] = {}
    if phase is not None:
        for name, ms in found.items():
            phases[phase(name)] = phases.get(phase(name), 0.0) + ms
    return sum(found.values()), phases


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


def _equal(spec: dict, a: tuple, b: tuple) -> bool:
    """Whether two sources' outputs, each ``(dll, outputs)``, agree bit for
    bit (for the stage-1 backward: its gradients, in either layout)."""
    if "grads" in spec:
        return all(torch.equal(x, y) for x, y in zip(spec["grads"](*a), spec["grads"](*b)))
    # The backward's scratch differs between its layouts; its outputs must not.
    keys = [k for k in a[1] if k not in ("coef", "dph", "dwp", "dbp", "hs", "carry", "w_t", "frag",
                                         "ctr")]
    return all(torch.equal(a[1][k], b[1][k]) for k in keys)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", choices=sorted(SPECS), default="ctc_alpha")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of a version of the kernel's source to build (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cold", action="store_true", help="flush the L2 cache before each call")
    ap.add_argument("--case", default="",
                    help="run only the cases whose name holds this text (e.g. H1024_f32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    spec = SPECS[args.kernel]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    current = str(_build.CSRC_DIR / spec["source"])
    specs = [s.split("=", 1) for s in args.source] or [["new", current]]
    libs = {name: _load(args.kernel, name, Path(path)) for name, path in specs}
    names = list(libs)
    order = [*names, *reversed(names)] * args.rounds
    scratch = torch.empty(64 << 20, device=dev)  # 256 MB, five times the L2 cache
    before = (lambda: scratch.fill_(1.0)) if args.cold else (lambda: None)
    cases = (spec["cases"](dev, args.case) if spec["cases"] in (_gru_wide_cases, _grid_f32_cases)
             else spec["cases"](dev))
    for case, ops in cases.items():
        if args.case not in case:
            continue
        count = spec.get("launches")
        launches = (lambda name, ops=ops: count(name, ops)) if count else (lambda name: 1)
        timed = lambda fn, launches=launches: (  # noqa: E731
            *_device_ms(fn, before, spec["match"], spec["phase"], launches=launches),
            _events_ms(fn, before))
        outs = {k: spec["outputs"](ops) for k in names}
        for k in names:
            spec["call"](libs[k], ops, outs[k])
        torch.cuda.synchronize()
        line = {"kernel": args.kernel, "case": case, "shape": list(ops[0].shape),
                "cold": args.cold,
                "equal_first": {k: _equal(spec, (libs[k], outs[k]), (libs[names[0]], outs[names[0]]))
                                for k in names},
                "check": {k: spec["compare"](ops, outs[k], libs[k]) for k in names},
                "device_ms": {k: [] for k in names}, "events_ms": {k: [] for k in names}}
        for k in order:
            device_ms, phases, events_ms = timed(lambda k=k: spec["call"](libs[k], ops, outs[k]))
            line["device_ms"][k].append(device_ms)
            line["events_ms"][k].append(events_ms)
            if phases:
                line.setdefault("phase_ms", {k: [] for k in names})[k].append(phases)
        for k in names:
            spec["extra"](libs[k], ops, line, k)
            if spec["rows_entry"] and hasattr(libs[k], spec["rows_entry"]):
                line.setdefault("rows_ms", {})[k] = {
                    r: timed(lambda r=r: spec["call"](libs[k], ops, outs[k], rows=r))[0]
                    for r in GRU_ROWS if _offers(spec, libs[k], ops, outs[k], r)}
        print(json.dumps(line), flush=True)


def _offers(spec, dll, ops, out, rows: int) -> bool:
    """Whether the source takes ``rows`` rows per block (it refuses a
    choice it does not offer with an invalid-argument error)."""
    try:
        spec["call"](dll, ops, out, rows=rows)
    except RuntimeError:
        return False
    return True


if __name__ == "__main__":
    main()
