"""Bidirectional multi-layer GRU with a hand-written CUDA recurrence.

Counterpart of ``ocrs_models_tpu/ops/gru.py`` and of its Pallas kernel
``gru_recurrence4`` with its custom VJP. The input projections ``x @ W_ih
+ b_ih`` for all steps are one large matmul per direction, outside the
recurrence; only ``h @ W_hh`` and the gate math run step by step, in
:func:`gru_recurrence`, differentiable through
:class:`GRURecurrenceFunction`: the forward runs :func:`gru_fwd`
(``csrc/gru_fwd.cu``), the backward :func:`gru_bwd` (``csrc/gru_bwd.cu``).
Both kernels keep their slice of ``W_hh`` in registers for all steps and
loop over time inside one launch; the blocks that share a batch tile form
a thread block cluster and exchange the state through each other's shared
memory. In bf16 their products run on the tensor cores. A cluster holds
at most 8 blocks of 32 units, so these kernels take ``H % 8 == 0`` and
``H <= 256`` (:func:`gru_route`: "cluster"); every other width, as the
Pallas kernel takes any, goes to :func:`gru_wide_fwd` and
:func:`gru_wide_bwd` (``csrc/gru_wide.cu``; the backward's phases around
its chain are ``gru_bwd.cu``'s), zero-padded to a multiple of 8 first. Up
to 512 after padding ("wide") they run in the same persistent form, one
launch for all T steps, in clusters of up to 16 blocks with part of
``W_hh`` in shared memory; above 512 ("grid") in one cooperative launch
over the whole card, the state exchanged through device memory between
steps: in bf16 up to ``GRID_MAX_HIDDEN`` (``csrc/gru_grid.cu``, above
``GRID_RESIDENT_HIDDEN`` part of ``W_hh`` streamed each step, from L2 and,
past ``GRID_GATE_UNITS`` units a block, from device memory), in
float32 up to ``GRID_F32_MAX_HIDDEN`` (``csrc/gru_grid_f32.cu``, all of
the f32 ``W_hh`` slice resident up to ``GRID_F32_RESIDENT_HIDDEN``, part of
it streamed each step above); every other width above 512
("stepwise") in one launch per step, the state in device memory between
launches. Above 512 the backward's coefficients and dW run on
``wgmma`` (``csrc/gru_bwd_wide.cu``), in float32 as error-compensated
TF32 (:func:`bwd_phases`, :func:`gru_bwd_coef_wide_f32`,
:func:`gru_bwd_dw_wide_f32`). On CPU tensors
both wrappers run their plain versions (:func:`gru_recurrence_reference`,
a Python loop of torch ops, and autograd of it). The backward kernel's
three phases have plain versions of their own
(:func:`gru_bwd_coefficients_reference`, :func:`gru_bwd_chain_reference`,
:func:`gru_bwd_dw_reference`; in bf16 the chain hands ``dw`` only
``bf16(dhn)`` and sums ``db`` itself, :func:`gru_bwd_chain_bf16_reference`
and :func:`gru_bwd_dw_bf16_reference`), composed by
:func:`gru_bwd_phases_reference`. Gate order and parameter names follow torch's
``nn.GRU`` (r, z, n; ``n = tanh(xn + r * (W_hn h + b_hn))``), so its
state dict loads into :class:`BiGRU` and back.

The dtype of ``px`` is the compute dtype, as in ``gru_recurrence4``, whose
io dtype follows it: float32, or bfloat16 with the Pallas kernel's rounding
points. Forward: the carried state ``h`` is f32, each step's product is
``bf16(h) @ bf16(W_hh)`` summed in f32 plus the f32 ``b_hh``, the gate math
is f32 (``z * h`` with the f32 ``h``), and ``ys`` is rounded to bf16.
Backward: ``h_prev`` is read back from the bf16 ``ys``, ``dy`` is bf16,
``dh`` takes ``bf16(dph) @ bf16(W_hh)^T``, ``dW_hh`` sums ``h_prev^T
bf16(dph)`` in f32, ``db_hh`` the unrounded ``dph``, and ``dpx`` is
rounded to bf16. ``W_hh``, ``b_hh`` and their gradients stay float32.
Since ``dpx = bf16([da_r, da_z, da_c])`` and ``dph = [da_r, da_z, dhn]``,
``bf16(dph)`` is ``dpx``'s first ``2H`` columns beside ``bf16(dhn)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _build


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 ``t`` as float32 (exact); any other ``t`` as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def gru_recurrence_reference(px_f, px_b, w_hh, b_hh):
    """Plain version of the recurrence of one bidirectional layer.

    :param px_f, px_b: ``[T, N, 3H]`` input projections per direction, both
        in natural time order (the backward direction reads step ``T-1-i``);
        float32, or bfloat16 for bf16 compute.
    :param w_hh: ``[2, H, 3H]`` float32 recurrent weights laid out for ``h @ W``.
    :param b_hh: ``[2, 3H]`` float32.
    :return: ``(ys_f, ys_b)``, each ``[T, N, H]`` in natural time order, in
        ``px``'s dtype.
    """
    t_len, n, h3 = px_f.shape
    hid = h3 // 3
    dt = px_f.dtype
    ys_f = px_f.new_empty((t_len, n, hid))
    ys_b = px_f.new_empty((t_len, n, hid))
    h = _widen(px_f).new_zeros((2, n, hid))
    w = _build.rounded(w_hh, dt)
    for i in range(t_len):
        tb = t_len - 1 - i
        ph = torch.baddbmm(b_hh[:, None, :], _build.rounded(h, dt), w)  # [2, N, 3H]
        px_t = _widen(torch.stack([px_f[i], px_b[tb]]))
        xr, xz, xn = px_t.split(hid, dim=-1)
        hr, hz, hn = ph.split(hid, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xn + r * hn)
        h = (1.0 - z) * c + z * h
        ys_f[i] = h[0]
        ys_b[tb] = h[1]
    return ys_f, ys_b


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    if lib.ocrs_gru_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        for sfx in _build.SUFFIX.values():
            fn = getattr(lib, f"ocrs_gru_fwd{sfx}")
            fn.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"ocrs_gru_fwd{sfx}_max_clusters")
            fn.argtypes = [i, i, i, ctypes.POINTER(i)]
            fn.restype = ctypes.c_int
    return lib


MAX_HIDDEN = 256
"""Widest hidden size of the cluster route (``gru_fwd.cu``, ``gru_bwd.cu``:
a cluster of ``H / 32`` blocks, at most 8); wider layers take the wide
route (:func:`gru_route`)."""
MAX_WIDE_HIDDEN = 512
"""Widest hidden size, after padding to a multiple of 8, of the wide
route's persistent form (``gru_wide.cu``: a cluster of ``ceil(H / 32)``
blocks, at most 16); wider layers run the grid form (bf16 up to
``GRID_MAX_HIDDEN``, float32 up to ``GRID_F32_MAX_HIDDEN``) or one launch a
step."""

H100_SMS = 132
"""SMs of an H100 SXM, the card :func:`gru_route` answers for."""
H100_SMEM = 232448
"""Dynamic shared memory an H100 block may opt into (227 KB)."""
GRID_UNITS = (32, 24)
"""Hidden units a block of the grid form may own up to
``GRID_RESIDENT_HIDDEN``, the first that fits."""
GRID_RESIDENT_HIDDEN = 1440
"""Widest hidden size, after padding, whose plans keep a block's whole
slice of ``W_hh`` in shared memory (on an H100: 24 units a block, whose
``[24][4328]`` bf16 slice of the chain's ``W_hh^T`` and its partial sums
take 232,320 of the 232,448 bytes; 32 units fit up to 1072). Wider plans
stream part of the slice (:func:`grid_split`)."""
GRID_GATE_UNITS = 80
"""Most hidden units a block whose forward multiplies its ``3U`` columns in
one ``wgmma`` (n = 3U, at most 256). Above, up to ``GRID_MAX_UNITS`` ("the
per-gate plans", past H = 5280 on an H100), the forward takes one ``wgmma``
a gate (n = U) and the chain runs on ``wgmma`` too (n = U), both in passes
of 128 rows split between the two warpgroups; their ``W_hh`` comes from
device memory each step (it outgrows the L2), through rings sized by
``GRID_HBM_RING_BYTES`` (the forward's copies marked evict-first in L2)."""
GRID_MAX_UNITS = 96
"""Most hidden units a block of the grid form owns: 66 unit tiles of 96 at
H = 6336 fill an H100's 132 SMs with both directions."""
GRID_PASS_ROWS = 64
"""Batch rows a block of the grid form multiplies at once (``gru_grid.cu``
runs more in passes)."""
GRID_GATE_CHAIN_CHUNK = 12
"""k16 steps of ``W_hh`` in a ring stage of the per-gate plans' chain
(``gru_grid.cu``'s ``kGateChunk``), one batch of its products: one
``cp.async.bulk`` a stage, as few a step as its shared memory allows."""
GRID_CHUNK = {"fwd": 4, "chain": 8}
"""k16 steps of ``W_hh`` in a ring stage of each kernel of the grid form
(``gru_grid.cu``'s ``kFwdChunk``, ``kChainChunk``; the per-gate plans'
chain takes the forward's, :func:`grid_chunk`)."""
GRID_RING_BYTES = 40960
"""Shared memory the ring of a streamed plan aims at where the slice is
streamed mostly: enough chunks in flight to cover a read from L2."""
GRID_HBM_RING_BYTES = {"fwd": 147456, "chain": 73728}
"""Shared memory the rings of a per-gate plan aim at. Its slice comes from
device memory, about 2.8 MB an SM each step at H = 5288. The forward's 4
stages of 4 k16 steps (135 KB at 88 units, 147 KB at 96) also hold its
accumulators, 128 rows x 3U f32, between its products; the chain's 2
stages of ``GRID_GATE_CHAIN_CHUNK`` steps (34-37 KB) leave room for its A
staging: each stage's copy cost about a latency that nothing hid, so the
chain takes few, large ones (``gru_grid.cu``)."""
GRID_MAX_STAGES = 8
"""Most stages of a streamed plan's ring."""


class GridSplit(NamedTuple):
    """How a kernel of the grid form holds its slice of ``W_hh``: the first
    ``resident`` k16 steps of the contraction in shared memory, the next
    ``streamed`` (whole chunks of ``GRID_CHUNK``, zero past the contraction)
    through a ring of ``stages`` stages each step; ``(k16 steps, 0, 0)``
    where the whole slice stays. ``pass_rows``, the batch rows it
    multiplies at once, picks the kernel's variant (:func:`grid_split`)."""

    resident: int
    streamed: int
    stages: int
    pass_rows: int = GRID_PASS_ROWS


class GridPlan(NamedTuple):
    """The grid form's blocks (:func:`grid_plan`): ``units`` hidden units x
    ``rows`` batch rows a block, and each kernel's :class:`GridSplit`."""

    units: int
    rows: int
    fwd: GridSplit
    chain: GridSplit


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def _grid_k16(kind: str, hid: int) -> int:
    """k16 steps of the contraction of ``kind`` ("fwd": H, "chain": 3H)."""
    return _round16(hid if kind == "fwd" else 3 * hid) // 16


def grid_chunk(kind: str, units: int) -> int:
    """k16 steps of ``W_hh`` in a ring stage of the grid form's ``kind``
    kernel with ``units`` a block: ``GRID_CHUNK``'s, and 4 in the chain of
    the per-gate plans (above ``GRID_GATE_UNITS``), which reads its slice
    through ``wgmma``'s layout as the forward does."""
    if units > GRID_GATE_UNITS:
        return GRID_CHUNK["fwd"] if kind == "fwd" else GRID_GATE_CHAIN_CHUNK
    return GRID_CHUNK[kind]


def _grid_chunk_bytes(kind: str, units: int) -> int:
    """Bytes of a ring stage: the forward's 4 k16 steps of ``3U`` rows, the
    chain's ``U`` rows of 8 k16 steps and 8 more bf16 a row (of the
    per-gate plans: 4 k16 steps of ``U`` rows)."""
    if kind == "fwd":
        return 4 * 96 * units
    if units > GRID_GATE_UNITS:
        return GRID_GATE_CHAIN_CHUNK * 32 * units
    return 2 * units * (16 * 8 + 8)


def grid_kernel_smem(kind: str, units: int, resident: int, stages: int,
                     pass_rows: int = GRID_PASS_ROWS) -> int:
    """Dynamic shared memory of the grid form's ``kind`` kernel with
    ``units`` a block, ``resident`` k16 steps of ``W_hh`` resident, a ring
    of ``stages`` and passes of ``pass_rows`` (``gru_grid.cu``'s
    ``fwd_smem``, ``chain_smem``): the resident slice (the forward's
    ``[3U][16 resident]`` bf16, the chain's ``[U][16 resident + 8]``, or
    ``[U][16 resident]`` in the per-gate plans), the exchange where its k
    groups' partial sums meet (24 KB up to 32 units a block; twice that in
    the chain at 128 rows a pass, its warps on 4 m16 tiles, and none where
    the warpgroups split the rows: the forward at 128 rows a pass and the
    per-gate plans' chain), the staging of the A fragments (streamed
    forward, per-gate chain), the ring and two mbarriers a stage."""
    ug = units // 8
    ring = stages * (_grid_chunk_bytes(kind, units) + 16)
    # The streamed kernels on wgmma stage each warp's A fragments: 3
    # batches of 2 k16 steps, 512 bytes a step; of 4 at 128 rows a pass;
    # the per-gate chain 2 batches of 16.
    msplit = pass_rows > GRID_PASS_ROWS
    staged = 8 * 3 * (4 if msplit else 2) * 512 if stages else 0
    if kind == "fwd":
        xchg = 0 if msplit else 2 * 4 * 3 * -(-ug // 2) * 512
        return 96 * units * resident + xchg + staged + ring
    if units > GRID_GATE_UNITS:  # its batches of GRID_GATE_CHAIN_CHUNK steps; db's sums
        return (32 * units * resident + 8 * 2 * GRID_GATE_CHAIN_CHUNK * 512 + ring
                + 8 * 3 * units * 4)
    tiles = pass_rows // 32
    return 2 * units * (16 * resident + 8) + 4 * 2 * tiles * (ug - ug // 4) * 512 + ring


def grid_smem(hid: int, units: int) -> int:
    """Dynamic shared memory of the grid form's larger kernel for padded
    width ``hid`` and ``units`` a block with the whole slice of ``W_hh``
    resident: the forward's ``[3U][H]`` or the chain's ``[U][3H]`` bf16, the
    contraction padded to the k16 steps (and the chain's rows by 8 more),
    beside its exchange."""
    return max(grid_kernel_smem(kind, units, _grid_k16(kind, hid), 0) for kind in ("fwd", "chain"))


def grid_split(kind: str, hid: int, units: int, smem: int, rows: int = 64) -> GridSplit | None:
    """How the grid form's ``kind`` kernel ("fwd" or "chain") holds its
    slice of ``W_hh`` at padded width ``hid`` with ``units`` x ``rows`` a
    block within ``smem`` bytes: all of it where it fits (passes of 64
    rows); else as many k16 steps as fit beside the exchange and the ring
    (a multiple of the chunk, :func:`grid_chunk`), the rest streamed. The
    ring has 2 stages where that leaves at most three chunks a step (the
    slice only just misses: a stage more would stream a chunk more), else
    about ``GRID_RING_BYTES`` (``GRID_HBM_RING_BYTES`` in the per-gate plans;
    2 to ``GRID_MAX_STAGES`` stages). A streamed kernel of a block of more
    than 64 rows takes passes of 128, where its kernels have that variant:
    the forward's warpgroups split the rows (not the contraction) and a
    pass reads the ring once for all of them; the chain's warps take 4 m16
    tiles up to 32 units. The per-gate plans (above ``GRID_GATE_UNITS``)
    have only that variant, in both kernels: their chain's warpgroups split
    the rows too. None where not even the exchange and two stages fit."""
    k16 = _grid_k16(kind, hid)
    if grid_kernel_smem(kind, units, k16, 0) <= smem:
        return GridSplit(k16, 0, 0)
    chunk, step = grid_chunk(kind, units), grid_kernel_smem(kind, units, 1, 0) - grid_kernel_smem(
        kind, units, 0, 0)
    gate = units > GRID_GATE_UNITS
    wide = gate or (rows > GRID_PASS_ROWS and (kind == "fwd" or units <= 32))
    pass_rows = 2 * GRID_PASS_ROWS if wide else GRID_PASS_ROWS
    # The per-gate forward parks its sums in 4 stages.
    least = 4 if gate and kind == "fwd" else 2

    def resident(stages: int) -> int:
        room = smem - grid_kernel_smem(kind, units, 0, stages, pass_rows)
        return -1 if room < 0 else min(k16 - 1, room // step) // chunk * chunk

    if resident(least) < 0:
        return None
    chunks = -(-(k16 - resident(least)) // chunk)
    ring = GRID_HBM_RING_BYTES[kind] if gate else GRID_RING_BYTES
    stages = least if chunks <= 3 else max(least, min(GRID_MAX_STAGES, ring // _grid_chunk_bytes(
        kind, units)))
    if resident(stages) < 0:
        stages = least
    kept = resident(stages)
    return GridSplit(kept, -(-(k16 - kept) // chunk) * chunk, stages, pass_rows)


def grid_stream_elems(kind: str, hid: int, plan: GridPlan) -> int:
    """bf16 elements of the device copy of every block's streamed chunks of
    ``kind`` for ``plan`` at padded width ``hid`` (0 where none is
    streamed): 2 directions x unit tiles x chunks x a stage's bytes / 2."""
    split = plan.fwd if kind == "fwd" else plan.chain
    chunks = split.streamed // grid_chunk(kind, plan.units)
    return 2 * -(-hid // plan.units) * chunks * _grid_chunk_bytes(kind, plan.units) // 2


def _grid_rows(n: int, row_tiles: int) -> int:
    """Batch rows a block: as many row tiles as the SMs hold, each at most
    64 rows a pass, R a multiple of 16."""
    rows = -(-n // min(row_tiles, -(-n // GRID_PASS_ROWS)))
    return 16 * -(-rows // 16)


def grid_plan(n: int, hid: int, sms: int = H100_SMS,
              smem: int = H100_SMEM) -> GridPlan | None:
    """The grid form's blocks for batch ``n`` and hidden size ``hid``
    (zero-padded to a multiple of 8) on a card of ``sms`` SMs whose blocks
    may use ``smem`` bytes of shared memory, or None where it has none.
    Up to ``GRID_RESIDENT_HIDDEN``: the first U of ``GRID_UNITS`` whose whole
    slice fits and whose ``ceil(H/U)`` unit tiles leave room for both
    directions on the SMs. Above: the least U, a multiple of 8 from 24 to
    ``GRID_MAX_UNITS``, whose unit tiles leave that room and whose kernels
    both split (:func:`grid_split`; above ``GRID_GATE_UNITS`` the per-gate
    plans). Then as many row tiles as the SMs hold (each block at most 64
    rows a pass, 128 where the kernels split the rows between their
    warpgroups). It depends on the width and the card only, and R on the
    batch too. Shared by :func:`gru_route` and the wrappers, which hand it
    to the C entries."""
    hid += -hid % 8
    wide = hid > GRID_RESIDENT_HIDDEN
    for units in range(24, GRID_MAX_UNITS + 1, 8) if wide else GRID_UNITS:
        tiles = -(-hid // units)
        row_tiles = sms // (2 * tiles)
        if row_tiles < 1:
            continue
        rows = _grid_rows(n, row_tiles)
        if wide:
            fwd, chain = (grid_split(kind, hid, units, smem, rows) for kind in ("fwd", "chain"))
            if fwd is None or chain is None:
                continue
        elif grid_smem(hid, units) > smem:
            continue
        else:
            fwd, chain = (GridSplit(_grid_k16(kind, hid), 0, 0) for kind in ("fwd", "chain"))
        return GridPlan(units, rows, fwd, chain)
    return None


GRID_MAX_HIDDEN = max(h for h in range(8, 8192, 8) if grid_plan(1, h) is not None)
"""Widest hidden size, after padding to a multiple of 8, of the grid form
on an H100 SXM, 6336: 96 units a block (the per-gate plans' ``wgmma`` n =
96), 66 unit tiles, 132 blocks; from 6344 ``grid_plan`` gives None (67 unit
tiles of 96 a direction outnumber the SMs, and 104 units are not built).
Up to 5280 the plans take at most ``GRID_GATE_UNITS`` (80 at 5280, the
forward's ``wgmma`` n = 240); 88 from 5288, 96 from 5816."""

GRID_F32_UNITS = 16
"""Hidden units a block of the f32 grid form owns up to
``GRID_F32_RESIDENT_HIDDEN`` (``gru_grid_f32.cu``'s resident plans): the
widest slice of ``W_hh`` in f32 that leaves a ring beside it in shared
memory at H = 1024."""
GRID_F32_RESIDENT_HIDDEN = 1056
"""Widest hidden size, after padding, of the f32 grid form's resident
plans on an H100: 66 unit tiles of 16 for both directions fill its 132
SMs. Wider plans take ``GRID_F32_STREAM_UNITS`` and stream part of the
slice (:func:`grid_f32_split`)."""
GRID_F32_STREAM_UNITS = (24, 32)
"""Hidden units a block of the f32 grid form may own above
``GRID_F32_RESIDENT_HIDDEN``, the least whose unit tiles fit the SMs (24
up to 1584, 32 up to 2112 on an H100); ``gru_grid_f32.cu`` is built for
these (wider blocks would hold more accumulators than registers)."""
GRID_F32_STAGES = (4, 3)
"""Ring stages of the f32 grid form's staged A operand, the first that
fits beside the ``W_hh`` slice (``gru_grid_f32.cu`` is built for these):
4 up to H = 1040 on an H100, 3 at 1048 and 1056; the streamed plans take
4."""
GRID_F32_STAGE_BYTES = 8 * 16 * 16 * 4
"""Shared memory of one ring stage of the f32 grid form: 8 warps x 16 rows
x 16 k of f32."""
GRID_F32_CHUNK = {"fwd": 2, "chain": 6}
"""k16 steps of ``W_hh`` in a ring stage of each kernel of the f32 grid
form's streamed plans (``gru_grid_f32.cu``'s ``kFwdChunk``,
``kChainChunk``): 9 KB at 24 units a block, 12 KB at 32, in both."""
GRID_F32_RING_BYTES = 49152
"""Shared memory the W ring of an f32 streamed plan aims at: 4 stages of
12 KB at 32 units, 5 of 9 KB at 24, enough chunks in flight to cover a
read from device memory while a chunk multiplies."""


class GridF32Split(NamedTuple):
    """How a kernel of the f32 grid form holds its slice of ``W_hh``: the
    first ``resident`` k16 steps of the contraction in shared memory, the
    next ``streamed`` (whole chunks of ``GRID_F32_CHUNK``, zero past the
    contraction) through a ring of ``stages`` stages each step, copied
    evict-first in L2; ``(k16 steps, 0, 0)`` where the whole slice stays."""

    resident: int
    streamed: int
    stages: int


class GridF32Plan(NamedTuple):
    """The f32 grid form's blocks (:func:`grid_f32_plan`): ``units`` hidden
    units x ``rows`` batch rows a block, the ``stages`` of each warp's ring
    of the A operand, and each kernel's :class:`GridF32Split`."""

    units: int
    rows: int
    stages: int
    fwd: GridF32Split
    chain: GridF32Split


def _grid_f32_cols(kind: str, units: int) -> int:
    """Columns of the f32 slice: the forward's ``3U``, the chain's ``U``."""
    return 3 * units if kind == "fwd" else units


def _grid_f32_chunk_bytes(kind: str, units: int) -> int:
    """Bytes of a W ring stage of the f32 grid form's ``kind`` kernel."""
    return 4 * 16 * _grid_f32_cols(kind, units) * GRID_F32_CHUNK[kind]


def grid_f32_kernel_smem(kind: str, units: int, resident: int, ring: int, stages: int) -> int:
    """Dynamic shared memory of the f32 grid form's ``kind`` kernel ("fwd"
    or "chain") with ``units`` a block (``gru_grid_f32.cu``'s
    ``grid_f32_smem``): ``resident`` k16 steps of the f32 ``W_hh`` slice
    (the forward's ``3U`` columns, the chain's ``U``), a W ring of ``ring``
    stages with two mbarriers and a counter each, and the warps' A rings of
    ``stages``."""
    return (4 * 16 * _grid_f32_cols(kind, units) * resident
            + ring * (_grid_f32_chunk_bytes(kind, units) + 20) + stages * GRID_F32_STAGE_BYTES)


def grid_f32_smem(kind: str, hid: int, stages: int) -> int:
    """Dynamic shared memory of the f32 grid form's ``kind`` kernel with
    the whole slice resident at padded width ``hid`` and ``stages`` A ring
    stages (the resident plans, ``GRID_F32_UNITS`` units): the forward's
    ``3U`` columns over ``round16(H)`` or the chain's ``U`` over
    ``round16(3H)``, beside the warps' rings."""
    return grid_f32_kernel_smem(kind, GRID_F32_UNITS, _grid_k16(kind, hid), 0, stages)


def grid_f32_split(kind: str, hid: int, units: int, smem: int,
                   stages: int) -> GridF32Split | None:
    """How the f32 grid form's ``kind`` kernel holds its slice of ``W_hh``
    at padded width ``hid`` with ``units`` a block and A rings of
    ``stages``, within ``smem`` bytes: all of it where it fits; else a W
    ring of ``GRID_F32_RING_BYTES`` in whole chunks, as many k16 steps
    resident as fit beside it, the rest streamed in whole chunks. None
    where not even the ring fits."""
    k16 = _grid_k16(kind, hid)
    if grid_f32_kernel_smem(kind, units, k16, 0, stages) <= smem:
        return GridF32Split(k16, 0, 0)
    chunk = GRID_F32_CHUNK[kind]
    ring = GRID_F32_RING_BYTES // _grid_f32_chunk_bytes(kind, units)
    room = smem - grid_f32_kernel_smem(kind, units, 0, ring, stages)
    if room < 0:
        return None
    kept = min(k16 - 1, room // (4 * 16 * _grid_f32_cols(kind, units)))
    return GridF32Split(kept, -(-(k16 - kept) // chunk) * chunk, ring)


def grid_f32_stream_elems(kind: str, hid: int, plan: GridF32Plan) -> int:
    """float32 elements of the device copy of every block's streamed chunks
    of ``kind`` for ``plan`` at padded width ``hid`` (0 where none is
    streamed): 2 directions x unit tiles x chunks x a stage's floats."""
    split = plan.fwd if kind == "fwd" else plan.chain
    chunks = split.streamed // GRID_F32_CHUNK[kind]
    return 2 * -(-hid // plan.units) * chunks * _grid_f32_chunk_bytes(kind, plan.units) // 4


def grid_f32_plan(n: int, hid: int, sms: int = H100_SMS,
                  smem: int = H100_SMEM) -> GridF32Plan | None:
    """The f32 grid form's blocks for batch ``n`` and hidden size ``hid``
    (zero-padded to a multiple of 8) on a card of ``sms`` SMs whose blocks
    may use ``smem`` bytes of shared memory, or None where it has none. Up
    to ``GRID_F32_RESIDENT_HIDDEN``: ``GRID_F32_UNITS`` units a block, as
    many row tiles as the SMs hold for both directions' ``ceil(H/16)`` unit
    tiles (R as :func:`grid_plan` picks it), and the most of
    ``GRID_F32_STAGES`` whose rings fit beside the whole ``W_hh`` slice.
    Above: the least U of ``GRID_F32_STREAM_UNITS`` whose unit tiles leave
    room for both directions on the SMs and whose kernels both split
    (:func:`grid_f32_split`, A rings of ``GRID_F32_STAGES[0]``). Shared by
    :func:`gru_route` and the wrappers, which hand it to the C entries."""
    hid += -hid % 8
    if hid <= GRID_F32_RESIDENT_HIDDEN:
        row_tiles = sms // (2 * -(-hid // GRID_F32_UNITS))
        if row_tiles < 1:
            return None
        for stages in GRID_F32_STAGES:
            if max(grid_f32_smem(kind, hid, stages) for kind in ("fwd", "chain")) <= smem:
                fwd, chain = (GridF32Split(_grid_k16(kind, hid), 0, 0) for kind in ("fwd", "chain"))
                return GridF32Plan(GRID_F32_UNITS, _grid_rows(n, row_tiles), stages, fwd, chain)
        return None
    stages = GRID_F32_STAGES[0]
    for units in GRID_F32_STREAM_UNITS:
        tiles = -(-hid // units)
        row_tiles = sms // (2 * tiles)
        if row_tiles < 1:
            continue
        fwd, chain = (grid_f32_split(kind, hid, units, smem, stages) for kind in ("fwd", "chain"))
        if fwd is not None and chain is not None:
            return GridF32Plan(units, _grid_rows(n, row_tiles), stages, fwd, chain)
    return None


GRID_F32_MAX_HIDDEN = max(h for h in range(8, 8192, 8) if grid_f32_plan(1, h) is not None)
"""Widest hidden size, after padding to a multiple of 8, of the f32 grid
form on an H100 SXM, 2112: 66 unit tiles of 32, 132 blocks, each kernel's
slice (811 KB) mostly streamed; from 2120 the unit tiles of both
directions outnumber the SMs (and 40 units are not built). Up to
``GRID_F32_RESIDENT_HIDDEN`` (1056) the plans keep the whole slice, 16
units a block; 24 units from 1064, 32 from 1592."""


def gru_route(hid: int, dtype: torch.dtype = torch.float32) -> str:
    """Which kernels run a layer of hidden size ``hid`` and compute dtype
    ``dtype`` on an H100, by the width and the dtype alone: ``"cluster"``
    (``gru_fwd.cu``, ``gru_bwd.cu``) for ``H % 8 == 0`` and ``8 <= H <=
    MAX_HIDDEN``; else, with ``H`` zero-padded to the next multiple of 8,
    ``"wide"`` (``gru_wide.cu``'s persistent kernels) up to
    ``MAX_WIDE_HIDDEN``; then ``"grid"``, in bf16 ``gru_grid.cu`` up to
    ``GRID_MAX_HIDDEN`` (6336 on an H100: 96 units a block, 66 unit tiles
    of both directions on its 132 SMs; above ``GRID_RESIDENT_HIDDEN``,
    1440, with part of ``W_hh`` streamed; above 5280, 80 units a block,
    the per-gate plans, one ``wgmma`` of n = U a gate),
    in float32 ``gru_grid_f32.cu`` up to ``GRID_F32_MAX_HIDDEN`` (2112: 66
    unit tiles of 32; up to 1056 16 units a block with the whole f32
    ``W_hh`` slice resident, above 24 or 32 with part of it streamed); and
    ``"stepwise"`` (``gru_wide.cu``'s kernels of one launch a step) above.
    A card that cannot hold the grid plan's blocks runs "stepwise" where
    this says "grid" (:func:`wide_form`)."""
    if hid < 1:
        raise ValueError(f"gru_route: the hidden size must be at least 1, got {hid}")
    if hid % 8 == 0 and hid <= MAX_HIDDEN:
        return "cluster"
    padded = hid + -hid % 8
    if padded <= MAX_WIDE_HIDDEN:
        return "wide"
    widest = GRID_MAX_HIDDEN if dtype == torch.bfloat16 else GRID_F32_MAX_HIDDEN
    return "grid" if padded <= widest else "stepwise"


# The wide kernels take H % 8 == 0; another width is zero-padded to the
# next multiple of 8 first, and the padding sliced off the results. This
# is exact: a padded unit has px = 0, its W_hh row and columns 0 and b_hh
# 0, so r = z = 1/2 and c = tanh(0) = 0, and from h = 0 its state stays 0;
# its W_hh row is 0, so it feeds no real unit in either direction. In the
# backward its dy is 0 and dh gets nothing through its W_hh row, so dht
# stays 0; then its dpx, dph, dW and db entries are 0, and real units see
# only zero terms from it.


def _pad_gates(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t [..., 3H]`` with ``pad`` zero columns after each gate's ``H``."""
    return F.pad(t.unflatten(-1, (3, -1)), (0, pad)).flatten(-2)


def _unpad_gates(t: torch.Tensor, hid: int) -> torch.Tensor:
    return t.unflatten(-1, (3, -1))[..., :hid].flatten(-2).contiguous()


def _pad_w(w_hh: torch.Tensor, pad: int) -> torch.Tensor:
    """``w_hh [2, H, 3H]`` as ``[2, H + pad, 3(H + pad)]``, zero-padded."""
    return F.pad(_pad_gates(w_hh, pad), (0, 0, 0, pad))


def _check(name: str, tensors: dict, t_len: int, n: int, hid: int) -> None:
    h3 = 3 * hid
    shapes = {
        "px_f": (t_len, n, h3), "px_b": (t_len, n, h3), "ys_f": (t_len, n, hid),
        "ys_b": (t_len, n, hid), "dy_f": (t_len, n, hid), "dy_b": (t_len, n, hid),
        "w_hh": (2, hid, h3), "b_hh": (2, h3),
    }
    dev = tensors["px_f"].device
    io = tensors["px_f"].dtype
    if io not in _build.DTYPES:
        raise ValueError(f"{name}: px_f must be float32 or bfloat16, got {io}")
    for key, t in tensors.items():
        want = torch.float32 if key in ("w_hh", "b_hh") else io
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {want} on {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shapes[key]}")


def _cuda_sizes(name: str, tensors: dict) -> tuple[int, int, int]:
    """``(T, N, H)`` of a call on CUDA tensors, checked (:func:`_check`);
    raises for a device that is neither the CPU nor CUDA."""
    px_f = tensors["px_f"]
    if not px_f.is_cuda:
        raise RuntimeError(f"{name}: unsupported device {px_f.device}")
    if px_f.dim() != 3 or px_f.shape[-1] % 3:
        raise ValueError(f"{name}: px_f must be [T, N, 3H], got {tuple(px_f.shape)}")
    t_len, n, h3 = px_f.shape
    _check(name, tensors, t_len, n, h3 // 3)
    return t_len, n, h3 // 3


def gru_fwd(px_f, px_b, w_hh, b_hh):
    """Forward kernel of one bidirectional layer's recurrence; same
    contract as :func:`gru_recurrence_reference`. A CUDA tensor goes
    through ``gru_fwd.cu``'s kernel of its dtype where :func:`gru_route`
    says "cluster" (one ctypes call, one launch for all T steps; for bf16
    also the rounding of ``W_hh`` to bf16 values), else through
    :func:`gru_wide_fwd` (routes "wide" and "stepwise"); a CPU tensor
    through the plain version."""
    if px_f.device.type == "cpu":
        return gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    t_len, n, hid = _cuda_sizes("gru_fwd", {"px_f": px_f, "px_b": px_b, "w_hh": w_hh,
                                            "b_hh": b_hh})
    if gru_route(hid) != "cluster":
        return gru_wide_fwd(px_f, px_b, w_hh, b_hh)
    ys_f = torch.empty((t_len, n, hid), device=px_f.device, dtype=px_f.dtype)
    ys_b = torch.empty_like(ys_f)
    w = _build.rounded(w_hh, px_f.dtype).contiguous()
    lib = _fwd_lib()
    p = _build.ptr
    rc = getattr(lib, f"ocrs_gru_fwd{_build.SUFFIX[px_f.dtype]}")(
        px_f.device.index, p(px_f), p(px_b), p(w), p(b_hh), p(ys_f), p(ys_b),
        t_len, n, hid, _build.stream_ptr(px_f.device),
    )
    _build.check(lib, rc, "gru_fwd")
    gru_fwd.launches += 1
    return ys_f, ys_b


gru_fwd.launches = 0


def _wide_lib() -> ctypes.CDLL:
    lib = _build.load("gru_wide")
    if lib.ocrs_gru_wide_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int

        def bind(name, argtypes):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i

        for sfx in _build.SUFFIX.values():
            bind(f"ocrs_gru_wide_fwd{sfx}", [i] + [p] * 6 + [i, i, i, p])
            bind(f"ocrs_gru_wide_fwd_stepwise{sfx}", [i] + [p] * 7 + [i, i, i, p])
            for kind in ("fwd", "chain"):
                bind(f"ocrs_gru_wide_{kind}{sfx}_max_clusters", [i, i, i, ctypes.POINTER(i)])
        bind("ocrs_gru_wide_chain", [i] + [p] * 6 + [i, i, i, p])
        bind("ocrs_gru_wide_chain_bf16", [i] + [p] * 8 + [i, i, i, i, p])
        bind("ocrs_gru_wide_chain_stepwise", [i] + [p] * 8 + [i, i, i, p])
        bind("ocrs_gru_wide_chain_stepwise_bf16", [i] + [p] * 10 + [i, i, i, p])
        bind("ocrs_gru_wide_stepwise_rows", [])
    return lib


def _wide_report(kind: str, n: int, hid: int, device: int, dtype: torch.dtype) -> dict:
    """The persistent ``kind`` ("fwd" or "chain") launch's choice for batch
    ``n`` and padded width ``hid``: its batch rows per block, the clusters
    it launches and how many the card holds at once (raises where the
    runtime reports none)."""
    lib = _wide_lib()
    name = f"ocrs_gru_wide_{kind}{_build.SUFFIX[dtype]}_max_clusters"
    rows = ctypes.c_int(0)
    got = getattr(lib, name)(device, n, hid, ctypes.byref(rows))
    if got < 0:
        _build.check(lib, -got, name)
    return {"rows_per_block": rows.value, "launched": 2 * -(-n // rows.value), "max_active": got}


def _grid_lib() -> ctypes.CDLL:
    lib = _build.load("gru_grid")
    if lib.ocrs_gru_grid_fwd_bf16.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.ocrs_gru_grid_fwd_bf16.argtypes = [i] + [p] * 10 + [ll] + [i] * 8 + [p]
        lib.ocrs_gru_grid_chain_bf16.argtypes = [i] + [p] * 10 + [i, p, p, ll] + [i] * 8 + [p]
        lib.ocrs_gru_grid_limits.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
        for fn in (lib.ocrs_gru_grid_fwd_bf16, lib.ocrs_gru_grid_chain_bf16,
                   lib.ocrs_gru_grid_limits):
            fn.restype = i
        lib.ocrs_gru_grid_smem.argtypes = [i] * 5
        lib.ocrs_gru_grid_smem.restype = ll
    return lib


def _grid_f32_lib() -> ctypes.CDLL:
    lib = _build.load("gru_grid_f32")
    if lib.ocrs_gru_grid_f32_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.ocrs_gru_grid_f32_fwd.argtypes = [i] + [p] * 9 + [ll] + [i] * 8 + [p]
        lib.ocrs_gru_grid_f32_chain.argtypes = [i] + [p] * 10 + [ll] + [i] * 8 + [p]
        for fn in (lib.ocrs_gru_grid_f32_fwd, lib.ocrs_gru_grid_f32_chain):
            fn.restype = i
        lib.ocrs_gru_grid_f32_smem.argtypes = [i] * 5
        lib.ocrs_gru_grid_f32_smem.restype = ctypes.c_longlong
    return lib


_limits: dict[int, tuple[int, int]] = {}


def grid_limits(device: int = 0) -> tuple[int, int]:
    """The card's SM count and the shared memory a block may opt into, as
    :func:`grid_plan` takes them (asked of the runtime once a device)."""
    if device not in _limits:
        lib = _grid_lib()
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib, lib.ocrs_gru_grid_limits(device, ctypes.byref(sms), ctypes.byref(smem)),
                     "grid_limits")
        _limits[device] = (sms.value, smem.value)
    return _limits[device]


def wide_form(n: int, hid: int, dtype: torch.dtype,
              device: int = 0) -> tuple[str, GridPlan | GridF32Plan | None]:
    """The wide route's form for batch ``n``, padded width ``hid`` and
    ``dtype`` on CUDA device ``device``, chosen before any launch:
    ``("persistent", None)`` up to ``MAX_WIDE_HIDDEN``; ``("grid", plan)``
    where :func:`gru_route` says "grid" and the dtype's plan
    (:func:`grid_plan` in bf16, :func:`grid_f32_plan` in float32) finds
    blocks for this card; else ``("stepwise", None)``."""
    if hid <= MAX_WIDE_HIDDEN:
        return "persistent", None
    if gru_route(hid, dtype) == "grid":
        planner = grid_plan if dtype == torch.bfloat16 else grid_f32_plan
        plan = planner(n, hid, *grid_limits(device))
        if plan is not None:
            return "grid", plan
    return "stepwise", None


def _grid_frag(n: int, k: int, dev) -> torch.Tensor:
    """Scratch of the grid form's A operand with contraction ``k`` (H for
    the forward, 3H for the chain) in ``mma``'s fragment order, two step
    parities of both directions: ``[2, 2, 16 ceil(N/16), round16(k)]`` bf16
    (any contents: ``gru_grid.cu`` writes each step's before it reads it)."""
    return torch.empty((2, 2, 16 * -(-n // 16), _round16(k)), device=dev, dtype=torch.bfloat16)


def _grid_stream(kind: str, hid: int, plan: GridPlan | GridF32Plan,
                 dev) -> tuple[torch.Tensor | None, int]:
    """Scratch of the device copy of the streamed chunks of the grid form's
    ``kind`` kernel (written by its C entry each call; None where the plan
    streams none; bf16 for a :class:`GridPlan`, float32 for a
    :class:`GridF32Plan`) and its length in elements."""
    if isinstance(plan, GridF32Plan):
        elems, dt = grid_f32_stream_elems(kind, hid, plan), torch.float32
    else:
        elems, dt = grid_stream_elems(kind, hid, plan), torch.bfloat16
    return (torch.empty((elems,), device=dev, dtype=dt) if elems else None), elems



def _count_form(wrapper, form: str) -> None:
    wrapper.launches += 1
    wrapper.forms[form] += 1


def gru_wide_fwd(px_f, px_b, w_hh, b_hh):
    """The forward on the wide route, for any hidden size; same contract
    as :func:`gru_recurrence_reference`. A CUDA tensor goes, in one ctypes
    call, through the form :func:`wide_form` picks: up to
    ``MAX_WIDE_HIDDEN`` after padding (:func:`gru_route`'s "wide", or a
    width of the cluster route called here directly) ``gru_wide.cu``'s
    persistent kernel, one launch for all T steps; "grid" one cooperative
    launch of ``gru_grid.cu``'s kernel (bf16; above ``GRID_RESIDENT_HIDDEN``
    also one launch before it that lays out the streamed part of
    ``W_hh``) or ``gru_grid_f32.cu``'s (f32; the same layout launch above
    ``GRID_F32_RESIDENT_HIDDEN``), with the f32 state and the
    step counters in scratch of the call's own; "stepwise" T
    launches of ``gru_wide.cu``, one a step, with the f32 state in scratch
    of the call's own, ``[2, 2, N, H]``. For bf16 also the rounding of
    ``W_hh`` to bf16 values; a width that is not a multiple of 8 is
    zero-padded first (exact, see :func:`_pad_gates`). A failed launch
    raises. A CPU tensor goes through the plain version. ``.launches``
    counts the calls, ``.forms`` the calls of each form."""
    if px_f.device.type == "cpu":
        return gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    t_len, n, hid = _cuda_sizes("gru_wide_fwd", {"px_f": px_f, "px_b": px_b, "w_hh": w_hh,
                                                 "b_hh": b_hh})
    pad = -hid % 8
    if pad:
        ys_f, ys_b = gru_wide_fwd(_pad_gates(px_f, pad), _pad_gates(px_b, pad),
                                  _pad_w(w_hh, pad), _pad_gates(b_hh, pad))
        return ys_f[..., :hid].contiguous(), ys_b[..., :hid].contiguous()
    dev = px_f.device
    ys_f = torch.empty((t_len, n, hid), device=dev, dtype=px_f.dtype)
    ys_b = torch.empty_like(ys_f)
    w = _build.rounded(w_hh, px_f.dtype).contiguous()
    form, plan = wide_form(n, hid, px_f.dtype, dev.index)
    p = _build.ptr
    sfx = _build.SUFFIX[px_f.dtype]
    if isinstance(plan, GridF32Plan):
        lib = _grid_f32_lib()
        hs = torch.empty((2, 2, n, hid), device=dev, dtype=torch.float32)
        ctr = torch.empty((2 * -(-n // plan.rows),), device=dev, dtype=torch.int32)
        wst, elems = _grid_stream("fwd", hid, plan, dev)
        rc = lib.ocrs_gru_grid_f32_fwd(
            dev.index, p(px_f), p(px_b), p(w), p(b_hh), p(hs), p(ys_f), p(ys_b), p(ctr),
            p(wst) if wst is not None else None, elems, t_len, n, hid, plan.units, plan.rows,
            plan.stages, plan.fwd.resident, plan.fwd.stages, _build.stream_ptr(dev))
    elif isinstance(plan, GridPlan):
        lib = _grid_lib()
        hs = torch.empty((2, n, hid), device=dev, dtype=torch.float32)
        frag = _grid_frag(n, hid, dev)
        ctr = torch.empty((2 * -(-n // plan.rows),), device=dev, dtype=torch.int32)
        wst, elems = _grid_stream("fwd", hid, plan, dev)
        rc = lib.ocrs_gru_grid_fwd_bf16(
            dev.index, p(px_f), p(px_b), p(w), p(b_hh), p(hs), p(frag), p(ys_f), p(ys_b), p(ctr),
            p(wst) if wst is not None else None, elems, t_len, n, hid, plan.units, plan.rows,
            plan.fwd.resident, plan.fwd.stages, plan.fwd.pass_rows, _build.stream_ptr(dev))
    elif form == "persistent":
        lib = _wide_lib()
        rc = getattr(lib, f"ocrs_gru_wide_fwd{sfx}")(
            dev.index, p(px_f), p(px_b), p(w), p(b_hh), p(ys_f), p(ys_b), t_len, n, hid,
            _build.stream_ptr(dev))
    else:
        lib = _wide_lib()
        hs = torch.empty((2, 2, n, hid), device=dev, dtype=torch.float32)
        rc = getattr(lib, f"ocrs_gru_wide_fwd_stepwise{sfx}")(
            dev.index, p(px_f), p(px_b), p(w), p(b_hh), p(hs), p(ys_f), p(ys_b), t_len, n, hid,
            _build.stream_ptr(dev))
    _build.check(lib, rc, f"gru_wide_fwd ({form})")
    _count_form(gru_wide_fwd, form)
    return ys_f, ys_b


WIDE_FORMS = ("persistent", "grid", "stepwise")
"""The wide route's forms (:func:`wide_form`)."""
gru_wide_fwd.launches = 0
gru_wide_fwd.forms = dict.fromkeys(WIDE_FORMS, 0)


def gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh):
    """Plain version of the backward: autograd of
    :func:`gru_recurrence_reference` (which recomputes the forward, so
    ``ys_f`` and ``ys_b`` are not read). In bf16, whose rounding points
    autograd does not take (``h_prev`` from the bf16 ``ys``, ``dph``
    rounded for its products), :func:`gru_bwd_phases_reference`.

    :return: ``(dpx_f, dpx_b [T, N, 3H]`` in ``px``'s dtype, ``dw_hh [2, H,
        3H], db_hh [2, 3H])`` float32.
    """
    if px_f.dtype == torch.bfloat16:
        return gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    del ys_f, ys_b
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (px_f, px_b, w_hh, b_hh)]
        outs = gru_recurrence_reference(*ins)
        return torch.autograd.grad(outs, ins, (dy_f, dy_b))


def _h_prev(ys_f, ys_b):
    """``h_{t-1}`` in scan order for both directions, ``[2, T, N, H]``:
    ``ys_f[t-1]`` and ``ys_b[t+1]``, zero at each direction's first step."""
    zero = ys_f.new_zeros((1, *ys_f.shape[1:]))
    return _widen(torch.stack([torch.cat([zero, ys_f[:-1]]), torch.cat([ys_b[1:], zero])]))


def gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh):
    """Plain version of the backward kernel's first phase: recompute the
    gates of every step at once (``ph = h_prev @ W_hh + b_hh`` over all
    ``T * N`` rows) and return what the chain needs per element,
    ``coef [2, T, N, 5, H]``: ``z``, ``(1-z)(1-c^2)``, ``(h_prev-c) z (1-z)``,
    ``r``, ``hn r (1-r)``, float32 in both dtypes (``h_prev`` is the
    saved ``ys``, so bf16 ``ys`` give the bf16 product's operands)."""
    hid = ys_f.shape[-1]
    h_prev = _h_prev(ys_f, ys_b)
    w = _build.rounded(w_hh, ys_f.dtype)
    ph = torch.einsum("dtnk,dkj->dtnj", h_prev, w) + b_hh[:, None, None, :]
    xr, xz, xn = _widen(torch.stack([px_f, px_b])).split(hid, dim=-1)
    hr, hz, hn = ph.split(hid, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xn + r * hn)
    return torch.stack(
        [z, (1.0 - z) * (1.0 - c * c), (h_prev - c) * z * (1.0 - z), r, hn * r * (1.0 - r)],
        dim=3,
    )


def gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh):
    """Plain version of the backward kernel's second phase, the chain of
    ``T`` dependent steps: ``dht = dh + dy[t]``, the gate gradients from
    the coefficients, ``dh <- dht z + dph @ W_hh^T`` (for bf16 ``dy``,
    ``bf16(dph) @ bf16(W_hh)^T``). Returns ``(dpx_f, dpx_b)``, each ``[T,
    N, 3H]`` in ``dy``'s dtype, and ``dph = [da_r, da_z, dhn]``, ``[2, T, N,
    3H]`` float32 and unrounded."""
    t_len, n, hid = dy_f.shape
    dt = dy_f.dtype
    dpx_f = dy_f.new_empty((t_len, n, 3 * hid))
    dpx_b = dy_f.new_empty((t_len, n, 3 * hid))
    dph = coef.new_empty((2, t_len, n, 3 * hid))
    dh = coef.new_zeros((2, n, hid))
    w_t = _build.rounded(w_hh, dt).transpose(1, 2)
    for step in range(t_len):
        tf, tb = t_len - 1 - step, step
        cz, ca, cb, cr, cc = torch.stack([coef[0, tf], coef[1, tb]]).unbind(dim=2)
        dht = dh + _widen(torch.stack([dy_f[tf], dy_b[tb]]))
        da_c = dht * ca
        da_z = dht * cb
        dhn = da_c * cr
        da_r = da_c * cc
        dpx = torch.cat([da_r, da_z, da_c], dim=-1)
        dpx_f[tf] = dpx[0]
        dpx_b[tb] = dpx[1]
        d = torch.cat([da_r, da_z, dhn], dim=-1)
        dph[0, tf], dph[1, tb] = d[0], d[1]
        dh = dht * cz + torch.bmm(_build.rounded(d, dt), w_t)
    return dpx_f, dpx_b, dph


def gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh):
    """The chain as the bf16 kernel splits it: :func:`gru_bwd_chain_reference`
    (bf16 ``dy``), but what it hands on is ``bf16(dhn)``, ``[2, T, N, H]``,
    and ``db_hh = sum dph`` over all steps and rows, summed before any
    rounding. Returns ``(dpx_f, dpx_b, dhn, db_hh [2, 3H] float32)``."""
    dpx_f, dpx_b, dph = gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh)
    hid = dy_f.shape[-1]
    return dpx_f, dpx_b, dph[..., 2 * hid:].to(torch.bfloat16), dph.sum(dim=(1, 2))


def gru_bwd_dw_bf16_reference(ys_f, ys_b, dpx_f, dpx_b, dhn):
    """``dW_hh = h_prev^T bf16(dph)`` from what the bf16 chain hands on:
    ``bf16(dph)`` is ``[dpx[..., :2H], dhn]``. Returns ``dw_hh [2, H, 3H]``
    float32."""
    hid = ys_f.shape[-1]
    d = torch.cat([torch.stack([dpx_f, dpx_b])[..., : 2 * hid], dhn], dim=-1).float()
    return torch.einsum("dtnk,dtnj->dkj", _h_prev(ys_f, ys_b), d)


def gru_bwd_dw_reference(ys_f, ys_b, dph):
    """Plain version of the backward kernel's third phase: ``dW_hh =
    h_prev^T dph`` (for bf16 ``ys``, ``h_prev^T bf16(dph)``) and ``db_hh =
    sum dph`` (unrounded) over all ``T * N`` rows. Returns ``(dw_hh [2, H,
    3H], db_hh [2, 3H])`` float32."""
    dw = torch.einsum("dtnk,dtnj->dkj", _h_prev(ys_f, ys_b), _build.rounded(dph, ys_f.dtype))
    return dw, dph.sum(dim=(1, 2))


def gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh):
    """The backward as the kernel computes it, phase by phase, in plain
    torch ops; same contract as :func:`gru_bwd_reference` (and it reads
    the saved ``ys_f``, ``ys_b``, as the kernel does)."""
    coef = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
    if px_f.dtype == torch.bfloat16:
        dpx_f, dpx_b, dhn, db = gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh)
        return dpx_f, dpx_b, gru_bwd_dw_bf16_reference(ys_f, ys_b, dpx_f, dpx_b, dhn), db
    dpx_f, dpx_b, dph = gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh)
    dw, db = gru_bwd_dw_reference(ys_f, ys_b, dph)
    return dpx_f, dpx_b, dw, db


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    if lib.ocrs_gru_bwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.ocrs_gru_bwd.argtypes = [i] + [p] * 15 + [i, i, i, i, p]
        lib.ocrs_gru_bwd.restype = ctypes.c_int
        lib.ocrs_gru_bwd_bf16.argtypes = [i] + [p] * 16 + [i, i, i, i, p]
        lib.ocrs_gru_bwd_bf16.restype = ctypes.c_int
        for sfx in _build.SUFFIX.values():
            fn = getattr(lib, f"ocrs_gru_bwd_coef{sfx}")
            fn.argtypes = [i] + [p] * 7 + [i, i, i, p]
            fn.restype = ctypes.c_int
        lib.ocrs_gru_bwd_dw.argtypes = [i] + [p] * 9 + [i, i, i, i, p]
        lib.ocrs_gru_bwd_dw.restype = ctypes.c_int
        lib.ocrs_gru_bwd_dw_bf16.argtypes = [i] + [p] * 7 + [i, p, p, i, i, i, i, p]
        lib.ocrs_gru_bwd_dw_bf16.restype = ctypes.c_int
        for sfx in _build.SUFFIX.values():
            fn = getattr(lib, f"ocrs_gru_bwd{sfx}_max_clusters")
            fn.argtypes = [i, i, i, ctypes.POINTER(i)]
            fn.restype = ctypes.c_int
    return lib


BWD_WIDE_ORDER = 1
"""The tile order ``gru_bwd_wide.cu``'s ``coef`` and ``dw`` run in: 1, grouped
(the blocks in flight share a few of W_hh's and dph's column tiles, which
their group's rows then reuse from L2), rather than 0, the plain order
(column tiles fastest); the results are the same bits."""


def _bwd_wide_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd_wide")
    if lib.ocrs_gru_bwd_coef_wide_bf16.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.ocrs_gru_bwd_coef_wide_bf16.argtypes = [i] + [p] * 7 + [i, i, i, i, p]
        lib.ocrs_gru_bwd_dw_wide_bf16.argtypes = [i] + [p] * 7 + [i, p, p, i, i, i, i, i, p]
        lib.ocrs_gru_bwd_coef_wide_f32.argtypes = [i] + [p] * 8 + [i, i, i, i, p]
        lib.ocrs_gru_bwd_dw_wide_f32.argtypes = [i] + [p] * 10 + [i, i, i, i, i, p]
        lib.ocrs_gru_bwd_dw_wide_f32_pitch.argtypes = [i, i]
        lib.ocrs_gru_bwd_wide_f32_smem.argtypes = [i]
        for fn in (lib.ocrs_gru_bwd_coef_wide_bf16, lib.ocrs_gru_bwd_dw_wide_bf16,
                   lib.ocrs_gru_bwd_coef_wide_f32, lib.ocrs_gru_bwd_dw_wide_f32,
                   lib.ocrs_gru_bwd_dw_wide_f32_pitch, lib.ocrs_gru_bwd_wide_f32_smem):
            fn.restype = i
    return lib


def bwd_phases(hid: int) -> str:
    """Whose coefficients and dW the wide backward runs at padded width
    ``hid``: ``"gru_bwd_wide"`` (``wgmma``; bf16, and f32 in 3xTF32, faster
    than ``gru_bwd.cu``'s at every f32 width measured, 520 to 2048: PERF.md)
    above ``MAX_WIDE_HIDDEN``, else ``"gru_bwd"`` (``mma.sync`` tiles)."""
    return "gru_bwd_wide" if hid > MAX_WIDE_HIDDEN else "gru_bwd"


BWD_WIDE_TILE = (128, 192)
"""Output tile of ``gru_bwd_wide.cu``'s products, rows x columns: its two
multiplying warpgroups' 64 rows each, one ``wgmma`` n = 192."""
BWD_WIDE_F32_K = 16
"""Contraction a ring stage of ``gru_bwd_wide.cu``'s f32 kernels (two k8
steps)."""
BWD_WIDE_F32_STAGES = {"coef": 6, "dw": 5}
"""Ring stages of ``gru_bwd_wide.cu``'s f32 kernels."""


def bwd_wide_f32_smem(kind: str) -> int:
    """Dynamic shared memory a block of ``gru_bwd_wide.cu``'s f32 ``kind``
    ("coef" or "dw") asks for, whatever H is: its ring, a stage
    ``BWD_WIDE_F32_K`` of the contraction of A's source (the tile's 128
    rows: h_prev, or dpx and coef's r) and of B's hi and lo (192 rows
    each), 4 bytes an element; an mbarrier pair a stage; 1 KB to align
    the ring (``ocrs_gru_bwd_wide_f32_smem``)."""
    rows, cols = BWD_WIDE_TILE
    stage = 4 * BWD_WIDE_F32_K * (rows * (2 if kind == "dw" else 1) + 2 * cols)
    stages = BWD_WIDE_F32_STAGES[kind]
    return stages * stage + 16 * stages + 1024


TF32_MASK = -8192
"""``0xffffe000`` as an int32: the bits of an f32 that a tf32 operand keeps."""


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 ``x`` as the 3xTF32 products split it (``gru_bwd.cu``'s
    ``split_tf32``, ``gru_bwd_wide.cu``'s ``f32::split``): hi, the upper 19
    bits of x, and lo, those of ``x - hi`` (the bits the tensor core reads)."""
    hi = (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def tf32x3_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (float32) as the 3xTF32 products take it, ``a_lo b_hi +
    a_hi b_lo + a_hi b_hi`` of :func:`tf32_split`'s parts, in float64 (so
    the products are exact and only the split's dropped terms differ from
    ``a @ b`` in float64: below ``3 * 2**-20`` of ``|a| @ |b|``)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return al @ bh + ah @ bl + ah @ bh


def _dph(dpx_f, dpx_b, coef):
    """The f32 backward's ``dph [2, T, N, 3H]`` from what its dW phase
    reads: dpx's r and z columns, and its n columns (``da_c``) times
    ``coef``'s r (``dhn = da_c r``)."""
    t_len, n, h3 = dpx_f.shape
    hid = h3 // 3
    dpx = torch.stack([dpx_f, dpx_b])
    r = coef.reshape(2, t_len, n, 5, hid)[..., 3, :]
    return torch.cat([dpx[..., : 2 * hid], dpx[..., 2 * hid:] * r], dim=-1)


def gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh, order: int | None = None):
    """The float32 backward's coefficients above ``MAX_WIDE_HIDDEN``, ``coef
    [2, T*N, 5, H]`` as :func:`gru_bwd_coefficients_reference` gives them
    (``[2, T, N, 5, H]`` flattened). A CUDA tensor (H a multiple of 8) goes
    through ``gru_bwd_wide.cu``'s ``ocrs_gru_bwd_coef_wide_f32``: the
    pre-pass that writes ``W_hh^T``'s tf32 hi and lo parts into scratch
    ``[2, 2, 3H, H]``, then the 3xTF32 product on ``wgmma`` with the gate
    epilogue (two launches), in tile ``order`` (default
    ``BWD_WIDE_ORDER``; the same bits either way); a CPU tensor through the
    plain version. ``.launches`` counts the calls that launch the kernel."""
    t_len, n, hid = ys_f.shape
    if px_f.device.type == "cpu":
        return gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh).reshape(
            2, t_len * n, 5, hid)
    _cuda_sizes("gru_bwd_coef_wide_f32", {"px_f": px_f, "px_b": px_b, "ys_f": ys_f, "ys_b": ys_b,
                                          "w_hh": w_hh, "b_hh": b_hh})
    if px_f.dtype != torch.float32 or hid % 8:
        raise ValueError(f"gru_bwd_coef_wide_f32: float32 and H % 8 == 0, got {px_f.dtype}, "
                         f"H={hid}")
    dev = px_f.device
    wt = torch.empty((2, 2, 3 * hid, hid), device=dev, dtype=torch.float32)
    coef = torch.empty((2, t_len * n, 5, hid), device=dev, dtype=torch.float32)
    lib = _bwd_wide_lib()
    p = _build.ptr
    rc = lib.ocrs_gru_bwd_coef_wide_f32(
        dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(w_hh), p(b_hh), p(wt), p(coef), t_len, n,
        hid, BWD_WIDE_ORDER if order is None else order, _build.stream_ptr(dev))
    _build.check(lib, rc, "gru_bwd_coef_wide_f32")
    gru_bwd_coef_wide_f32.launches += 1
    return coef


gru_bwd_coef_wide_f32.launches = 0


def gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef, splits: int | None = None,
                        order: int | None = None):
    """The float32 backward's ``(dw_hh [2, H, 3H], db_hh [2, 3H])`` above
    ``MAX_WIDE_HIDDEN`` from the chain's ``dpx_f``, ``dpx_b`` and ``coef``
    (:func:`gru_bwd_coef_wide_f32`'s, for its r): :func:`gru_bwd_dw_reference`
    on :func:`_dph`. A CUDA tensor (H a multiple of 8) goes through
    ``gru_bwd_wide.cu``'s ``ocrs_gru_bwd_dw_wide_f32``: the pre-pass that
    writes ``h_prev^T``'s tf32 hi and lo parts (``ys`` shifted by a step and
    transposed) into scratch ``[2, 2, H, pitch]``, the 3xTF32 product ``dph^T h_prev`` on
    ``wgmma`` over ``splits`` ranges of rows (default :func:`_dw_splits`'s)
    into partials ``[splits, 2, H, 3H]``, with db's, and their sum in range
    order (three launches), in tile ``order``; a CPU tensor through the
    plain version. ``.launches`` counts the calls that launch the kernel."""
    t_len, n, hid = ys_f.shape
    if ys_f.device.type == "cpu":
        return gru_bwd_dw_reference(ys_f, ys_b, _dph(dpx_f, dpx_b, coef))
    _cuda_sizes("gru_bwd_dw_wide_f32", {"px_f": dpx_f, "px_b": dpx_b, "ys_f": ys_f, "ys_b": ys_b})
    if ys_f.dtype != torch.float32 or hid % 8:
        raise ValueError(f"gru_bwd_dw_wide_f32: float32 and H % 8 == 0, got {ys_f.dtype}, H={hid}")
    dev = ys_f.device
    if (coef.device != dev or coef.dtype != torch.float32 or not coef.is_contiguous()
            or tuple(coef.shape) != (2, t_len * n, 5, hid)):
        raise ValueError(f"gru_bwd_dw_wide_f32: coef must be contiguous float32 "
                         f"{(2, t_len * n, 5, hid)} on {dev}")
    splits = _dw_splits(t_len, n, hid) if splits is None else splits
    lib = _bwd_wide_lib()
    h3 = 3 * hid
    yt = torch.empty((2, 2, hid, lib.ocrs_gru_bwd_dw_wide_f32_pitch(t_len, n)), device=dev,
                     dtype=torch.float32)
    dwp = torch.empty((splits, 2, hid, h3), device=dev, dtype=torch.float32)
    dbp = torch.empty((splits, 2, h3), device=dev, dtype=torch.float32)
    dw = torch.empty((2, hid, h3), device=dev, dtype=torch.float32)
    db = torch.empty((2, h3), device=dev, dtype=torch.float32)
    p = _build.ptr
    rc = lib.ocrs_gru_bwd_dw_wide_f32(
        dev.index, p(ys_f), p(ys_b), p(dpx_f), p(dpx_b), p(coef), p(yt), p(dwp), p(dbp), p(dw),
        p(db), splits, t_len, n, hid, BWD_WIDE_ORDER if order is None else order,
        _build.stream_ptr(dev))
    _build.check(lib, rc, "gru_bwd_dw_wide_f32")
    gru_bwd_dw_wide_f32.launches += 1
    return dw, db


gru_bwd_dw_wide_f32.launches = 0

PHASE_KERNELS = (gru_bwd_coef_wide_f32, gru_bwd_dw_wide_f32)
"""The wrappers of the f32 backward's ``coef`` and ``dw`` above
``MAX_WIDE_HIDDEN``, which :func:`gru_wide_bwd` calls; each counts its
launches in ``.launches``, as ``ops.KERNELS``' wrappers do."""


def wide_max_active_clusters(n: int, hid: int, device: int = 0,
                             dtype: torch.dtype = torch.float32) -> dict:
    """:func:`max_active_clusters` for the wide route's persistent kernels
    (``hid`` zero-padded to a multiple of 8, at most ``MAX_WIDE_HIDDEN``):
    ``gru_wide_fwd``'s and the chain of ``gru_wide_bwd``'s."""
    hid += -hid % 8
    if hid > MAX_WIDE_HIDDEN:
        raise ValueError(f"wide_max_active_clusters: H={hid} runs one launch a step")
    return {"cluster_size": -(-hid // 32),
            "gru_wide_fwd": _wide_report("fwd", n, hid, device, dtype),
            "gru_wide_bwd": _wide_report("chain", n, hid, device, dtype)}


def max_active_clusters(n: int, hid: int, device: int = 0,
                        dtype: torch.dtype = torch.float32) -> dict:
    """For batch ``n``, hidden size ``hid`` and ``dtype``: the batch rows
    per block that :func:`gru_fwd` and :func:`gru_bwd` pick, the clusters
    each then launches, and how many of them the card can hold at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = {"cluster_size": -(-hid // 32)}
    sfx = _build.SUFFIX[dtype]
    for name, lib, fn in (("gru_fwd", _fwd_lib(), f"ocrs_gru_fwd{sfx}_max_clusters"),
                          ("gru_bwd", _bwd_lib(), f"ocrs_gru_bwd{sfx}_max_clusters")):
        rows = ctypes.c_int(0)
        got = getattr(lib, fn)(device, n, hid, ctypes.byref(rows))
        if got < 0:
            _build.check(lib, -got, fn)
        out[name] = {"rows_per_block": rows.value, "launched": 2 * -(-n // rows.value),
                     "max_active": got}
    return out


DW_SPLITS = 8
"""Most ranges of rows in the dW reduction; each range needs a partial
``[2, H, 3H]``."""
MIN_ROWS = 16
"""Fewest batch rows per block the bf16 chain picks: it writes one ``db``
partial per batch tile."""


def gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, scratch_out: dict | None = None):
    """Backward kernel of one bidirectional layer's recurrence; same
    contract as :func:`gru_bwd_reference`. A CUDA tensor goes through
    ``gru_bwd.cu``'s kernels of its dtype (one ctypes call, four launches
    whatever ``T`` is: the coefficients, the chain, the weight-gradient
    partials, their sum; for bf16 also the rounding of ``W_hh`` to bf16
    values, and the chain hands the weight gradient ``bf16(dhn)`` through
    scratch of its own and sums ``db`` itself); a CPU tensor through the
    plain version. A dict ``scratch_out`` gets the bf16 chain's ``dhn``
    (``[2, T, N, H]``), for tests of that phase. Where :func:`gru_route`
    says "wide" or "stepwise", the call is :func:`gru_wide_bwd`'s."""
    if px_f.device.type == "cpu":
        return gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    t_len, n, hid = _cuda_sizes("gru_bwd", {
        "px_f": px_f, "px_b": px_b, "ys_f": ys_f, "ys_b": ys_b, "dy_f": dy_f, "dy_b": dy_b,
        "w_hh": w_hh, "b_hh": b_hh,
    })
    if gru_route(hid) != "cluster":
        return gru_wide_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, scratch_out)
    h3 = 3 * hid
    dev = px_f.device
    bf16 = px_f.dtype == torch.bfloat16
    splits = _dw_splits(t_len, n)
    dpx_f = torch.empty_like(px_f)
    dpx_b = torch.empty_like(px_b)
    coef = torch.empty((2, t_len * n, 5, hid), device=dev, dtype=torch.float32)
    dwp = torch.empty((splits, 2, hid, h3), device=dev, dtype=torch.float32)
    # db partials: per dW split (f32), per batch tile of the chain (bf16).
    parts = max(splits, -(-n // MIN_ROWS)) if bf16 else splits
    dbp = torch.empty((parts, 2, h3), device=dev, dtype=torch.float32)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    lib = _bwd_lib()
    p = _build.ptr
    if bf16:
        dhn = torch.empty((2, t_len, n, hid), device=dev, dtype=torch.bfloat16)
        rc = lib.ocrs_gru_bwd_bf16(
            dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(dy_f), p(dy_b),
            p(_build.rounded(w_hh, px_f.dtype).contiguous()), p(b_hh), p(dpx_f), p(dpx_b),
            p(coef), p(dhn), p(dwp), p(dbp), p(dw), p(db), splits, t_len, n, hid,
            _build.stream_ptr(dev),
        )
        if scratch_out is not None:
            scratch_out["dhn"] = dhn
    else:
        rc = lib.ocrs_gru_bwd(
            dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(dy_f), p(dy_b), p(w_hh), p(b_hh),
            p(dpx_f), p(dpx_b), p(coef), p(dwp), p(dbp), p(dw), p(db),
            splits, t_len, n, hid, _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "gru_bwd")
    gru_bwd.launches += 1
    return dpx_f, dpx_b, dw, db


gru_bwd.launches = 0


def _dw_wide_tiles(hid: int, bf16: bool) -> int:
    """Output tiles a range of rows of ``gru_bwd_wide.cu``'s dW: bf16 2
    directions x ceil(H/128) rows k x (ceil(2H/192) + ceil(H/192)) columns
    j; f32 (the transposed product) 2 x ceil(H/192) columns k x
    (ceil(2H/128) + ceil(H/128)) rows j."""
    if bf16:
        return 2 * -(-hid // 128) * (-(-2 * hid // 192) + -(-hid // 192))
    return 2 * -(-hid // 192) * (-(-2 * hid // 128) + -(-hid // 128))


def _dw_splits(t_len: int, n: int, hid: int = 0, bf16: bool = False) -> int:
    """Ranges of rows in the dW reduction: one a 512 rows, up to
    ``DW_SPLITS``, so that every SM works. f32 keeps that count at every
    width, for accuracy: the tensor cores' f32 sums truncate, so a range's
    error grows with its rows (3xTF32 on ``wgmma`` at T=257, N=128, H=2048
    against float64: 2.4e-4 of the largest dW entry in one range, 3.1e-5
    in 8 ranges of 4112 rows, as ``gru_bwd.cu``'s; ``grid_probe
    --f32-phase-readings``, PERF.md). The
    bf16 phase above ``MAX_WIDE_HIDDEN`` on ``wgmma`` (its products are
    exact in f32; :func:`_dw_wide_tiles` output tiles a range, one after
    another on the card's SMs) takes the count, up to that one, whose
    rounds of tiles waste least: the rounds' share of a range plus 0.05 of
    a range's time for each partial that ``dw_sum`` then reads (at T=257,
    N=128: 4 at H=1024, whose 272 tiles leave the last of 3 rounds 6% full
    in one range; 2 at 1448; 1 at 2048, whose 1056 tiles are 8 whole
    rounds)."""
    most = max(1, min(DW_SPLITS, t_len * n // 512))
    if not bf16 or bwd_phases(hid) != "gru_bwd_wide":
        return most
    tiles = _dw_wide_tiles(hid, bf16)
    return min(range(1, most + 1), key=lambda s: -(-tiles * s // H100_SMS) / s + 0.05 * s)


def gru_wide_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh,
                 scratch_out: dict | None = None):
    """The backward on the wide route, for any hidden size; same contract
    as :func:`gru_bwd_reference`. A CUDA tensor goes through ``gru_bwd.cu``'s
    coefficients (one launch), the chain of the form :func:`wide_form`
    picks (bf16 also writes ``bf16(dhn)`` and ``db``'s partials, one per
    batch tile of the chain's rows per block), then ``gru_bwd.cu``'s dW
    reduction and sum (two launches), in three ctypes calls, plus for bf16
    the rounding of ``W_hh``. Above ``MAX_WIDE_HIDDEN`` (:func:`bwd_phases`)
    the coefficients and the dW reduction are ``gru_bwd_wide.cu``'s, on
    ``wgmma``: in bf16 reading the first cast's bf16 ``W_hh``; in f32 in
    3xTF32 through :func:`gru_bwd_coef_wide_f32` and
    :func:`gru_bwd_dw_wide_f32`, each with a pre-pass that writes the tf32
    hi and lo parts of its shared-memory operand (``W_hh^T``, ``h_prev^T``):
    2 launches more a call. The chain: up to
    ``MAX_WIDE_HIDDEN`` after padding ``gru_wide.cu``'s persistent kernel,
    one launch: 4 launches a call; "grid" ``gru_grid.cu``'s chain (bf16) or
    ``gru_grid_f32.cu``'s (f32, with the previous step's ``dph`` in scratch
    too), one cooperative launch, its ``dht * z`` and step counters in
    scratch of the call's own: 4 launches (5 above ``GRID_RESIDENT_HIDDEN``
    in bf16 and ``GRID_F32_RESIDENT_HIDDEN`` in f32, whose streamed part of
    ``W_hh`` is laid out first); "stepwise" T launches of
    ``gru_wide.cu``, one a step, its state in
    scratch of the call's own, and the copy of ``W_hh^T``: T + 4. A width
    that is not a multiple of 8 is zero-padded first (exact, see
    :func:`_pad_gates`). A failed launch raises. A CPU tensor goes through
    the plain version; ``scratch_out`` as for :func:`gru_bwd`; ``.forms``
    as for :func:`gru_wide_fwd`."""
    if px_f.device.type == "cpu":
        return gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    t_len, n, hid = _cuda_sizes("gru_wide_bwd", {
        "px_f": px_f, "px_b": px_b, "ys_f": ys_f, "ys_b": ys_b, "dy_f": dy_f, "dy_b": dy_b,
        "w_hh": w_hh, "b_hh": b_hh,
    })
    pad = -hid % 8
    if pad:
        grads = gru_wide_bwd(
            _pad_gates(px_f, pad), _pad_gates(px_b, pad), *(F.pad(t, (0, pad)) for t in
                                                           (ys_f, ys_b, dy_f, dy_b)),
            _pad_w(w_hh, pad), _pad_gates(b_hh, pad), scratch_out)
        if scratch_out is not None and "dhn" in scratch_out:
            scratch_out["dhn"] = scratch_out["dhn"][..., :hid].contiguous()
        dpx_f, dpx_b, dw, db = grads
        return (_unpad_gates(dpx_f, hid), _unpad_gates(dpx_b, hid),
                _unpad_gates(dw[:, :hid], hid), _unpad_gates(db, hid))
    h3 = 3 * hid
    dev = px_f.device
    dt = px_f.dtype
    bf16 = dt == torch.bfloat16
    sfx = _build.SUFFIX[dt]
    stream = _build.stream_ptr(dev)
    p = _build.ptr
    # The phases above MAX_WIDE_HIDDEN run on wgmma (gru_bwd_wide.cu); in
    # bf16 they read W_hh in bf16 itself: the first of the rounding's two
    # casts; in f32 through their own wrappers (PHASE_KERNELS).
    wgmma = bwd_phases(hid) == "gru_bwd_wide"
    tensor_cores = bf16 and wgmma
    w16 = w_hh.to(torch.bfloat16) if bf16 else None
    w = (w16.float() if bf16 else w_hh).contiguous()
    bwd, wide = _bwd_lib(), _wide_lib()
    phases = _bwd_wide_lib() if tensor_cores else bwd

    if wgmma and not bf16:
        coef = gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w, b_hh)
    else:
        coef = torch.empty((2, t_len * n, 5, hid), device=dev, dtype=torch.float32)
        if tensor_cores:
            rc = phases.ocrs_gru_bwd_coef_wide_bf16(
                dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(w16), p(b_hh), p(coef), t_len, n,
                hid, BWD_WIDE_ORDER, stream)
        else:
            rc = getattr(bwd, f"ocrs_gru_bwd_coef{sfx}")(
                dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(w), p(b_hh), p(coef), t_len, n,
                hid, stream)
        _build.check(phases, rc, "gru_wide_bwd (coef)")

    dpx_f = torch.empty_like(px_f)
    dpx_b = torch.empty_like(px_b)
    form, plan = wide_form(n, hid, dt, dev.index)
    persistent = form == "persistent"
    if form != "persistent":  # the chain's dht * z
        carry = torch.empty((2, n, hid), device=dev, dtype=torch.float32)
    if form == "stepwise":  # the per-step chain's operand
        w_t = w.transpose(1, 2).contiguous()
    if form == "stepwise" or isinstance(plan, GridF32Plan):  # the previous step's dph
        dph = torch.empty((2, 2, n, h3), device=dev, dtype=torch.float32)
    splits = _dw_splits(t_len, n, hid, bf16)
    if not wgmma or bf16:
        dwp = torch.empty((splits, 2, hid, h3), device=dev, dtype=torch.float32)
        dw = torch.empty_like(w_hh)
        db = torch.empty_like(b_hh)
    if bf16:
        rows = (_wide_report("chain", n, hid, dev.index, dt)["rows_per_block"] if persistent
                else plan.rows if isinstance(plan, GridPlan)
                else wide.ocrs_gru_wide_stepwise_rows())
        tiles = -(-n // rows)
        dhn = torch.empty((2, t_len, n, hid), device=dev, dtype=torch.bfloat16)
        dbp = torch.empty((tiles, 2, h3), device=dev, dtype=torch.float32)
        chain = wide
        if isinstance(plan, GridPlan):
            chain = _grid_lib()
            frag = _grid_frag(n, h3, dev)
            ctr = torch.empty((2 * tiles,), device=dev, dtype=torch.int32)
            wst, elems = _grid_stream("chain", hid, plan, dev)
            rc = chain.ocrs_gru_grid_chain_bf16(
                dev.index, p(dy_f), p(dy_b), p(w), p(coef), p(carry), p(frag), p(dpx_f), p(dpx_b),
                p(dhn), p(dbp), tiles, p(ctr), p(wst) if wst is not None else None, elems,
                t_len, n, hid, plan.units, rows, plan.chain.resident, plan.chain.stages,
                plan.chain.pass_rows, stream)
        elif persistent:
            rc = wide.ocrs_gru_wide_chain_bf16(
                dev.index, p(dy_f), p(dy_b), p(w), p(coef), p(dpx_f), p(dpx_b), p(dhn), p(dbp),
                tiles, t_len, n, hid, stream)
        else:
            rc = wide.ocrs_gru_wide_chain_stepwise_bf16(
                dev.index, p(dy_f), p(dy_b), p(w_t), p(coef), p(dph), p(carry), p(dpx_f),
                p(dpx_b), p(dhn), p(dbp), t_len, n, hid, stream)
        _build.check(chain, rc, f"gru_wide_bwd (chain, {form})")
        dw_args = (dev.index, p(ys_f), p(ys_b), p(dpx_f), p(dpx_b), p(dhn), p(dwp), p(dbp), tiles,
                   p(dw), p(db), splits, t_len, n, hid)
        rc = (phases.ocrs_gru_bwd_dw_wide_bf16(*dw_args, BWD_WIDE_ORDER, stream) if tensor_cores
              else bwd.ocrs_gru_bwd_dw_bf16(*dw_args, stream))
        if scratch_out is not None:
            scratch_out["dhn"] = dhn
    else:
        chain = wide
        if persistent:
            rc = wide.ocrs_gru_wide_chain(
                dev.index, p(dy_f), p(dy_b), p(w), p(coef), p(dpx_f), p(dpx_b), t_len, n, hid,
                stream)
        elif isinstance(plan, GridF32Plan):
            chain = _grid_f32_lib()
            ctr = torch.empty((2 * -(-n // plan.rows),), device=dev, dtype=torch.int32)
            wst, elems = _grid_stream("chain", hid, plan, dev)
            rc = chain.ocrs_gru_grid_f32_chain(
                dev.index, p(dy_f), p(dy_b), p(w), p(coef), p(dph), p(carry), p(dpx_f), p(dpx_b),
                p(ctr), p(wst) if wst is not None else None, elems, t_len, n, hid, plan.units,
                plan.rows, plan.stages, plan.chain.resident, plan.chain.stages, stream)
        else:
            rc = wide.ocrs_gru_wide_chain_stepwise(
                dev.index, p(dy_f), p(dy_b), p(w_t), p(coef), p(dph), p(carry), p(dpx_f),
                p(dpx_b), t_len, n, hid, stream)
        _build.check(chain, rc, f"gru_wide_bwd (chain, {form})")
        if wgmma:
            dw, db = gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef, splits)
            rc = 0
        else:
            dbp = torch.empty((splits, 2, h3), device=dev, dtype=torch.float32)
            rc = bwd.ocrs_gru_bwd_dw(
                dev.index, p(ys_f), p(ys_b), p(dpx_f), p(dpx_b), p(coef), p(dwp), p(dbp), p(dw),
                p(db), splits, t_len, n, hid, stream)
    _build.check(phases, rc, "gru_wide_bwd (dw)")
    _count_form(gru_wide_bwd, form)
    return dpx_f, dpx_b, dw, db


gru_wide_bwd.launches = 0
gru_wide_bwd.forms = dict.fromkeys(WIDE_FORMS, 0)


class GRURecurrenceFunction(torch.autograd.Function):
    """Differentiable recurrence: forward :func:`gru_fwd`, backward
    :func:`gru_bwd`, saving ``px_f, px_b, ys_f, ys_b, w_hh, b_hh`` (the
    JAX VJP's residuals)."""

    @staticmethod
    def forward(ctx, px_f, px_b, w_hh, b_hh):
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        ctx.save_for_backward(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        px_f, px_b, ys_f, ys_b, w_hh, b_hh = ctx.saved_tensors
        dy_f = torch.zeros_like(ys_f) if dy_f is None else dy_f.contiguous()
        dy_b = torch.zeros_like(ys_b) if dy_b is None else dy_b.contiguous()
        return gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)


def gru_recurrence(px_f, px_b, w_hh, b_hh):
    """Recurrence of one bidirectional layer, differentiable in all four
    inputs; same contract as :func:`gru_recurrence_reference`. Without a
    gradient to track it is one :func:`gru_fwd` call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (px_f, px_b, w_hh, b_hh)):
        return GRURecurrenceFunction.apply(px_f, px_b, w_hh, b_hh)
    return gru_fwd(px_f, px_b, w_hh, b_hh)


class BiGRU(nn.Module):
    """Stack of bidirectional GRU layers with ``nn.GRU(input_size, hidden,
    num_layers=layers, bidirectional=True, batch_first=True)`` semantics and
    parameter names. Input ``[N, T, F]``, output ``[N, T, 2 * hidden]`` in
    ``compute_dtype``.

    ``compute_dtype`` bfloat16 is the JAX package's bf16 path
    (``ops/gru.py``, backend ``pallas4``): the input projections take bf16
    operands with f32 accumulation and are stored in bf16 (here one bf16
    ``linear``, which also rounds ``b_ih`` to bf16 before the sum), the
    recurrence runs in bf16 (see the module's docstring), and ``ys`` feeds
    the next layer in bf16. Parameters stay float32."""

    def __init__(self, input_size: int, hidden: int, layers: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in _build.DTYPES:
            raise ValueError(f"BiGRU: compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.hidden = hidden
        self.layers = layers
        self.compute_dtype = compute_dtype
        k = 1.0 / math.sqrt(hidden)
        for layer in range(layers):
            fin = input_size if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                for name, shape in (
                    (f"weight_ih_l{layer}{sfx}", (3 * hidden, fin)),
                    (f"weight_hh_l{layer}{sfx}", (3 * hidden, hidden)),
                    (f"bias_ih_l{layer}{sfx}", (3 * hidden,)),
                    (f"bias_hh_l{layer}{sfx}", (3 * hidden,)),
                ):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape).uniform_(-k, k))
                    )

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        # bf16 compute casts to bf16; float32 compute widens a bf16 input
        # (a bf16 model's features) and takes float32 (and the tests'
        # float64) as they come.
        lowp = self.compute_dtype == torch.bfloat16

        def cast(t):
            return t.to(torch.bfloat16) if lowp else t

        x = (cast(xs) if lowp else _widen(xs)).transpose(0, 1)  # time-major [T, N, F]
        for layer in range(self.layers):
            f, b = f"l{layer}", f"l{layer}_reverse"
            # Hoisted input projections: one [T*N, F] x [F, 3H] matmul each.
            px_f, px_b = (
                torch.nn.functional.linear(x, cast(self._p(f"weight_ih_{d}")),
                                           cast(self._p(f"bias_ih_{d}")))
                for d in (f, b)
            )
            w_hh = torch.stack([self._p(f"weight_hh_{f}").t(), self._p(f"weight_hh_{b}").t()])
            b_hh = torch.stack([self._p(f"bias_hh_{f}"), self._p(f"bias_hh_{b}")])
            ys_f, ys_b = gru_recurrence(
                px_f.contiguous(), px_b.contiguous(), w_hh.contiguous(), b_hh
            )
            x = torch.cat([ys_f, ys_b], dim=-1)
        return x.transpose(0, 1)
