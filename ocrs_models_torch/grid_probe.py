"""Where a step of the biGRU's bf16 grid form (``csrc/gru_grid.cu``) spends
its time, on the card:

    python -m ocrs_models_torch.grid_probe [--t 257 --n 128 --hid 1024]

Builds copies of ``csrc/gru_grid.cu`` with one part switched off each
(their numbers are wrong; only their times count) and times the forward and
the backward's chain of each at (T, N, H), by CUDA events:

- ``full``: the source as it is;
- ``no_wait``: no wait on the step counters (the blocks run unsynchronised);
- ``no_product``: no product (the barrier, the gate math and its loads and
  stores alone);
- ``no_aload``: the product on constants (zeros where the streamed plans
  stage them in shared memory) instead of the A fragments it loads from
  device memory;
- ``fwd_batch_<k>``, ``chain_ahead_<k>``: the forward's A fragments of
  ``k`` k16 steps loaded at once (where the plan keeps all of W resident),
  the chain's ``k`` ahead, instead of the source's numbers.

Then ``phases``: a copy with ``clock64`` marks read by thread 0 of every
block at each step's start, after its wait on the counter, after the
product (every warp of the block) and after the gate math, and each part's
mean cycles a step over the blocks and the steps after the first (the wait
also at its 50th and 90th percentile); where the plan streams part of
W_hh (H above 1440), also the cycles thread 0 spends a step waiting for
the ring's chunks to land (and issuing those not yet issued),
``ring_wait_cycles``. At H = 5288 (``--hid 5288``: a per-gate plan, W_hh
from device memory) that reads whether HBM sets the pace: the ring's
waits against the product. Then the bf16 backward's other phases on the
same shape (``coef`` and ``dw`` with ``dw_sum`` as the wrapper runs them
above H=512, ``gru_bwd_wide.cu``'s on ``wgmma`` in both tile orders, the
``_order_0`` ones in the plain order, up to H=2048 ``gru_bwd.cu``'s
``mma.sync`` ones beside, and W_hh's cast to bf16 values), and the
forward at T = 2 and 33 (those up to T). Each copy is written to
``build/probe/`` and compiled by ``nvcc`` with the flags of
``ops/_build.py``, all at once.
Prints the card's name and power limit first and one JSON line a variant.
Needs CUDA and ``nvcc``.

    python -m ocrs_models_torch.grid_probe --f32 [--t 257 --n 128 --hid 1024]

does the same for the f32 grid form (``csrc/gru_grid_f32.cu``): builds
``full``, ``no_wait``, ``no_product`` and ``no_aload`` (the staged A
operand zero-filled, nothing of the state read from L2) and times the
forward and the chain of each at (T, N, H), the full build also at every
ring stage count the kernels are built for that fits (``stages_<S>``,
the resident plans up to H = 1056); then, at N a multiple of 128,
``phases``: a step's cycles by phase (the wait, the product, the gate
math, to the next step) and, where the plan streams part of W_hh
(``--hid 1064``, ``1448``, ``2048``), thread 0's cycles waiting for ring
chunks, as for the bf16 form.

    python -m ocrs_models_torch.grid_probe --backward [--t 257 --n 128 --hid 1024]

times only the backward's ``coef`` and ``dw`` (both tile orders) at (T, N,
H): at H = 5288 a small T (one group of row tiles: W_hh read once a call
from device memory) against T = 257 tells a tile's own pace from the
re-reads that its order causes.

    python -m ocrs_models_torch.grid_probe --dw-readings SEED --t 2 --n 259 --hid 5280

instead reads the bf16 wide route's dW end to end (``gru_fwd``, then
``gru_bwd``, in the form the route picks; the per-step form above
``GRID_MAX_HIDDEN``) against the plain phases (``gru_bwd_reference``) on
the card tests' operands (``_gru_case`` of ``tests/test_torch_cuda.py``,
from ``SEED``): the largest error over 1e-3 of the largest entry, the
entries past that bound, dW against the plain dW phase on the bf16(dph)
the chain handed on, and how many of the bf16 operands round otherwise
than in the plain version (ys; dpx and dhn, the bf16(dph) of dW).

    python -m ocrs_models_torch.grid_probe --f32-phase-readings SEED --t 257 --n 128 --hid 2048

instead reads the f32 backward's ``coef`` and ``dw`` above 512 (3xTF32:
``gru_bwd_wide.cu``'s on ``wgmma`` and ``gru_bwd.cu``'s on ``mma.sync``)
and the f32 plain versions against float64 plain versions, on random
operands from ``SEED``: coef's largest error (by coefficient for the
``wgmma`` one) and whether the two kernels' coef agree bit for bit; dW's
and db's largest errors with ``dw`` in 1 and 2 ranges of rows and in the
wrapper's (``_dw_splits``), and ``gru_bwd.cu``'s in its ranges.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .ops import _build
from .ops import gru as gru_ops

# (anchor in gru_grid.cu, its replacement, times it occurs): each part a
# macro switches off.
_PATCHES = (
    ("if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));",
     "\n#if !NO_WAIT\n if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));\n#endif\n", 3),
    ("if (step > 0) {\n                __syncthreads();  // the warpgroup reconverged",
     "if (step > 0 && !NO_PRODUCT) {\n                __syncthreads();  // the warpgroup reconverged", 2),
    ("if (step > 0 && (Stream || mw > 0))\n", "if (step > 0 && (Stream || mw > 0) && !NO_PRODUCT)\n", 1),
    ("? __ldcg(frag + (size_t)ks", "? PROBE_LOAD(frag + (size_t)ks", 1),
    ("__ldcg(frag + i * tile", "PROBE_LOAD(frag + i * tile", 2),
    ("const int nbytes = ok ? 16 : 0;", "const int nbytes = ok && !NO_ALOAD ? 16 : 0;", 1),
    ("namespace {\n", "namespace {\n#define PROBE_LOAD(p) "
     "(NO_ALOAD ? make_uint4(threadIdx.x, 1u, 2u, 3u) : __ldcg(p))\n", 1),
    ("constexpr int kFwdBatch = ", "constexpr int kFwdBatch = FWD_BATCH; // ", 1),
    ("constexpr int kChainAhead = ", "constexpr int kChainAhead = CHAIN_AHEAD; // ", 1),
)
# The phases build: marks 0-3 a step (``PROBE_MARK``) into the buffer that
# ``ocrs_probe_set`` hands the kernels, [blocks][T][5] cycles, slot 4 the
# cycles thread 0 has spent in ring_wait so far (a running sum a block,
# kept past the marks, [blocks]).
_MARKS = (
    ("namespace {\n", "namespace {\n__device__ long long* g_probe;\n__device__ long long* g_ring;\n"
     "#define PROBE_MARK(k) do { if (PROBE_PHASES && threadIdx.x == 0) { "
     "g_probe[((size_t)blockIdx.x * T + step) * 5 + (k)] = clock64(); if ((k) == 3) "
     "g_probe[((size_t)blockIdx.x * T + step) * 5 + 4] = g_ring[blockIdx.x]; } } while (0)\n", 1),
    ("    const unsigned s = g % (unsigned)r.S;\n    if (threadIdx.x == 0)\n",
     "    const unsigned s = g % (unsigned)r.S;\n    const long long probe_t0 = clock64();\n"
     "    if (threadIdx.x == 0)\n", 1),
    ("    mbar_wait(r.full + s, (g / (unsigned)r.S) & 1u);\n    return smem_u32(r.stage0) + s * r.bytes;\n",
     "    mbar_wait(r.full + s, (g / (unsigned)r.S) & 1u);\n"
     "    if (PROBE_PHASES && threadIdx.x == 0) g_ring[blockIdx.x] += clock64() - probe_t0;\n"
     "    return smem_u32(r.stage0) + s * r.bytes;\n", 1),
    ("    for (int step = 0; step < T; ++step) {\n",
     "    for (int step = 0; step < T; ++step) {\n        PROBE_MARK(0);\n", 3),
    ("        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));\n",
     "        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));\n        PROBE_MARK(1);\n", 3),
    ("                __syncthreads();  // the previous pass's sums have been read\n",
     "                __syncthreads();  // the previous pass's sums have been read\n"
     "                PROBE_MARK(2);\n", 2),
    # The per-gate plans' chain has no barrier between its product and its
    # gate math: the phases build puts one there for the mark.
    ("            if (!active) continue;\n            // The gate math's inputs of group g",
     "            __syncthreads();\n            PROBE_MARK(2);\n"
     "            if (!active) continue;\n            // The gate math's inputs of group g", 1),
    ("        if (step + 1 < T) signal_step(ctr);\n",
     "        __syncthreads();\n        PROBE_MARK(3);\n        if (step + 1 < T) signal_step(ctr);\n", 3),
    ('extern "C" {\n', 'extern "C" {\nint ocrs_probe_set(void* p, void* ring) {\n'
     "    cudaError_t err = cudaMemcpyToSymbol(g_probe, &p, sizeof(p));\n"
     "    return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(g_ring, &ring, sizeof(ring)));\n}\n", 1),
)
_DEFAULTS = {"NO_WAIT": 0, "NO_PRODUCT": 0, "NO_ALOAD": 0, "PROBE_PHASES": 0}
# The same parts of gru_grid_f32.cu, and its phases build's marks: 0 at a
# step's start, 1 after the wait, 2 after the product and 3 after the gate
# math (each behind a block barrier in that build only, so every warp of
# the block must hold rows: N a multiple of 128), slot 4 the cycles thread
# 0 has spent in ring_wait so far.
_F32_PATCHES = (
    ("namespace {\n", "namespace {\n__device__ long long* g_probe;\n__device__ long long* g_ring;\n"
     "#define PROBE_MARK(k) do { if (PROBE_PHASES) { __syncthreads(); if (threadIdx.x == 0) { "
     "g_probe[((size_t)blockIdx.x * T + step) * 5 + (k)] = clock64(); if ((k) == 3) "
     "g_probe[((size_t)blockIdx.x * T + step) * 5 + 4] = g_ring[blockIdx.x]; } } } while (0)\n", 1),
    ("    for (int step = 0; step < T; ++step) {\n",
     "    for (int step = 0; step < T; ++step) {\n        PROBE_MARK(0);\n", 2),
    ("if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));",
     "\n#if !NO_WAIT\n if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));\n#endif\n"
     " PROBE_MARK(1);\n", 2),
    ("if (step > 0)\n                warp_product<", "if (step > 0 && !NO_PRODUCT)\n                warp_product<", 2),
    ("row0, valid, H, lane);\n", "row0, valid, H, lane);\n            PROBE_MARK(2);\n", 1),
    ("row0, valid, H3, lane);\n", "row0, valid, H3, lane);\n            PROBE_MARK(2);\n", 1),
    ("        signal_step(ctr);\n", "        PROBE_MARK(3);\n        signal_step(ctr);\n", 2),
    ("const bool ok = r < valid && k < K;", "const bool ok = r < valid && k < K && !NO_ALOAD;", 1),
    ("const float* ring_wait(const WRing& r, unsigned g) {\n",
     "const float* ring_wait(const WRing& r, unsigned g) {\n    const long long probe_t0 = clock64();\n", 1),
    ("    mbar_wait(r.full + g % (unsigned)r.SW, (g / (unsigned)r.SW) & 1u);\n",
     "    mbar_wait(r.full + g % (unsigned)r.SW, (g / (unsigned)r.SW) & 1u);\n"
     "    if (PROBE_PHASES && threadIdx.x == 0) g_ring[blockIdx.x] += clock64() - probe_t0;\n", 1),
    ('extern "C" {\n', 'extern "C" {\nint ocrs_probe_set(void* p, void* ring) {\n'
     "    cudaError_t err = cudaMemcpyToSymbol(g_probe, &p, sizeof(p));\n"
     "    return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(g_ring, &ring, sizeof(ring)));\n}\n", 1),
)


def _source() -> str:
    src = (_build.CSRC_DIR / "gru_grid.cu").read_text()
    for old, new, count in _MARKS + _PATCHES:
        if src.count(old) != count:
            raise RuntimeError(f"grid_probe: gru_grid.cu holds {old!r} {src.count(old)} times, "
                               f"not {count}")
        src = src.replace(old, new)
    return src


def _source_depth(name: str) -> int:
    text = (_build.CSRC_DIR / "gru_grid.cu").read_text()
    return int(text.split(f"constexpr int {name} = ", 1)[1].split(";", 1)[0])


def _variants(plan: gru_ops.GridPlan) -> dict[str, dict[str, int]]:
    """The builds to time. The forward's batch (``kFwdBatch``) is that of
    the kernels that keep all of W resident, and a streamed chain's round
    (4 k groups x ``kChainAhead``) must be one ring chunk: their variants
    only where the plan streams none."""
    fwd, chain = _source_depth("kFwdBatch"), _source_depth("kChainAhead")
    out = {"full": {}, "no_wait": {"NO_WAIT": 1}, "no_product": {"NO_PRODUCT": 1},
           "no_aload": {"NO_ALOAD": 1}}
    for k in (2, 8):
        if plan.fwd.stages == 0:
            out[f"fwd_batch_{k}"] = {"FWD_BATCH": k}
    for k in (4, 6):  # a streamed chain's round of 4 k groups is one 8-step chunk
        if plan.chain.stages == 0:
            out[f"chain_ahead_{k}"] = {"CHAIN_AHEAD": k}
    out["phases"] = {"PROBE_PHASES": 1}
    return {name: {**_DEFAULTS, "FWD_BATCH": fwd, "CHAIN_AHEAD": chain, **v}
            for name, v in out.items()}


def _build_all(variants: dict) -> dict[str, ctypes.CDLL]:
    probe_dir = _build.build_dir().parent / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    src = probe_dir / "gru_grid_probe.cu"
    src.write_text(_source())
    procs = {}
    for name, macros in variants.items():
        lib = probe_dir / f"libgru_grid_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{k}={v}" for k, v in macros.items()), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"grid_probe: nvcc failed for {name}:\n{out}")
        dll = ctypes.CDLL(str(lib))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dll.ocrs_gru_grid_fwd_bf16.argtypes = [i] + [p] * 10 + [ll] + [i] * 8 + [p]
        dll.ocrs_gru_grid_chain_bf16.argtypes = [i] + [p] * 10 + [i, p, p, ll] + [i] * 8 + [p]
        dll.ocrs_probe_set.argtypes = [p, p]
        dll.ocrs_error_string.argtypes = [i]
        dll.ocrs_error_string.restype = ctypes.c_char_p
        libs[name] = dll
    return libs


def f32_probe(t_len: int, n: int, hid: int) -> None:
    """The f32 grid form's builds with one part switched off each and the
    full build at each A ring stage count that fits (the resident plans),
    timed, and a step's cycles by phase (one JSON line a variant)."""
    dev = torch.device("cuda", 0)
    plan = gru_ops.grid_f32_plan(n, hid, *gru_ops.grid_limits(dev.index))
    if plan is None or gru_ops.gru_route(hid) != "grid":
        raise SystemExit(f"grid_probe: H={hid} takes no f32 grid form")
    src = (_build.CSRC_DIR / "gru_grid_f32.cu").read_text()
    for old, new, count in _F32_PATCHES:
        if src.count(old) != count:
            raise RuntimeError(f"grid_probe: gru_grid_f32.cu holds {old!r} {src.count(old)} "
                               f"times, not {count}")
        src = src.replace(old, new)
    probe_dir = _build.build_dir().parent / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    (probe_dir / "gru_grid_f32_probe.cu").write_text(src)
    variants = {"full": {}, "no_wait": {"NO_WAIT": 1}, "no_product": {"NO_PRODUCT": 1},
                "no_aload": {"NO_ALOAD": 1}}
    if n % 128 == 0:
        variants["phases"] = {"PROBE_PHASES": 1}
    procs = {}
    for name, macros in variants.items():
        lib = probe_dir / f"libgru_grid_f32_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{k}={v}" for k, v in {**_DEFAULTS, **macros}.items()), "-o", str(lib),
               str(probe_dir / "gru_grid_f32_probe.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"grid_probe: nvcc failed for {name}:\n{out}")
        dll = ctypes.CDLL(str(lib))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dll.ocrs_gru_grid_f32_fwd.argtypes = [i] + [p] * 9 + [ll] + [i] * 8 + [p]
        dll.ocrs_gru_grid_f32_chain.argtypes = [i] + [p] * 10 + [ll] + [i] * 8 + [p]
        dll.ocrs_probe_set.argtypes = [p, p]
        dll.ocrs_error_string.argtypes = [i]
        dll.ocrs_error_string.restype = ctypes.c_char_p
        libs[name] = dll
    gen = torch.Generator().manual_seed(3)
    px = [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev) for _ in range(2)]
    w = (((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / hid**0.5).to(dev))
    b = torch.zeros((2, 3 * hid), device=dev)
    dy = [(torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev) for _ in range(2)]
    coef = torch.rand((2, t_len * n, 5, hid), device=dev)
    ys = [torch.empty((t_len, n, hid), device=dev) for _ in range(2)]
    dpx = [torch.empty((t_len, n, 3 * hid), device=dev) for _ in range(2)]
    hs, dph = torch.empty((2, 2, n, hid), device=dev), torch.empty((2, 2, n, 3 * hid), device=dev)
    carry = torch.empty((2, n, hid), device=dev)
    ctr = torch.empty((2 * -(-n // plan.rows),), device=dev, dtype=torch.int32)
    (fwst, felems), (cwst, celems) = (gru_ops._grid_stream(kind, hid, plan, dev)
                                      for kind in ("fwd", "chain"))
    ptr, stream = _build.ptr, _build.stream_ptr(dev)

    def opt(t):
        return None if t is None else ptr(t)

    def fwd(dll, stages, split):
        return lambda: _build.check(dll, dll.ocrs_gru_grid_f32_fwd(
            dev.index, ptr(px[0]), ptr(px[1]), ptr(w), ptr(b), ptr(hs), ptr(ys[0]), ptr(ys[1]),
            ptr(ctr), opt(fwst), felems, t_len, n, hid, plan.units, plan.rows, stages,
            split.resident, split.stages, stream), "grid_probe forward")

    def chain(dll, stages, split):
        return lambda: _build.check(dll, dll.ocrs_gru_grid_f32_chain(
            dev.index, ptr(dy[0]), ptr(dy[1]), ptr(w), ptr(coef), ptr(dph), ptr(carry),
            ptr(dpx[0]), ptr(dpx[1]), ptr(ctr), opt(cwst), celems, t_len, n, hid, plan.units,
            plan.rows, stages, split.resident, split.stages, stream), "grid_probe chain")

    shape = {"T": t_len, "N": n, "H": hid, "units": plan.units, "rows": plan.rows,
             "stages": plan.stages,
             "w_split": {"fwd": plan.fwd._asdict(), "chain": plan.chain._asdict()}}
    runs = [(name, dll, plan.stages) for name, dll in libs.items() if name != "phases"]
    if not plan.fwd.stages:  # the resident plans' A ring stages
        runs += [(f"stages_{s}", libs["full"], s) for s in gru_ops.GRID_F32_STAGES
                 if s != plan.stages and max(gru_ops.grid_f32_smem(k, hid, s)
                                             for k in ("fwd", "chain"))
                 <= gru_ops.grid_limits(dev.index)[1]]
    for name, dll, stages in runs:
        print(json.dumps({"variant": name, **shape, "stages": stages,
                          "fwd_ms": _events_ms(fwd(dll, stages, plan.fwd)),
                          "chain_ms": _events_ms(chain(dll, stages, plan.chain))}), flush=True)
    if "phases" not in libs:
        return
    blocks = 2 * -(-n // plan.rows) * -(-hid // plan.units)
    marks = torch.zeros((blocks, t_len, 5), device=dev, dtype=torch.int64)
    ring = torch.zeros((blocks,), device=dev, dtype=torch.int64)
    phases = libs["phases"]
    _build.check(phases, phases.ocrs_probe_set(ptr(marks), ptr(ring)), "grid_probe phases")
    names = ("wait", "product", "gate_math", "signal_to_next", "ring_wait")
    for kernel, call in (("fwd", fwd(phases, plan.stages, plan.fwd)),
                         ("chain", chain(phases, plan.stages, plan.chain))):
        ring.zero_()
        call()
        torch.cuda.synchronize()
        m = marks[:, 1:].double()  # steps after the first (no wait, no product before it)
        parts = [m[..., 1] - m[..., 0], m[..., 2] - m[..., 1], m[..., 3] - m[..., 2],
                 marks[:, 2:, 0].double() - marks[:, 1:-1, 3].double(),
                 marks[:, 1:, 4].double() - marks[:, :-1, 4].double()]
        wait = parts[0].flatten()
        print(json.dumps({"phases": kernel, **shape, "blocks": blocks,
                          **{f"{k}_cycles": p.mean().item() for k, p in zip(names, parts)},
                          "wait_p50_cycles": wait.quantile(0.5).item(),
                          "wait_p90_cycles": wait.quantile(0.9).item(),
                          "step_cycles": (marks[:, 2:, 0] - marks[:, 1:-1, 0]).double().mean().item()}),
              flush=True)


def _events_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dw_readings(t_len: int, n: int, hid: int, seed: int) -> dict:
    """The bf16 wide route's dW end to end at (T, N, H) against the plain
    phases, on the operands the card tests make from ``seed``."""
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    k = 1.0 / hid**0.5
    px_f, px_b = (torch.randn((t_len, n, 3 * hid), generator=g).to(dev, bf16) for _ in range(2))
    w_hh = ((torch.rand((2, hid, 3 * hid), generator=g) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * hid), generator=g) * 2 - 1) * k).to(dev)
    dy_f, dy_b = (torch.randn((t_len, n, hid), generator=g).to(dev, bf16) for _ in range(2))
    ys = gru_ops.gru_fwd(px_f, px_b, w_hh, b_hh)
    args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
    scratch = {}
    dpx_f, dpx_b, dw, _ = gru_ops.gru_bwd(*args, scratch_out=scratch)
    want = gru_ops.gru_bwd_reference(*args)
    coef = gru_ops.gru_bwd_coefficients_reference(px_f, px_b, *ys, w_hh, b_hh)
    dhn_want = gru_ops.gru_bwd_chain_bf16_reference(coef, dy_f, dy_b, w_hh)[2]
    on_dph = gru_ops.gru_bwd_dw_bf16_reference(*ys, dpx_f, dpx_b, scratch["dhn"])
    err, bound = (dw - want[2]).abs(), 1e-3 * want[2].abs().max().item()
    flips = {
        "ys": sum(int((a != b).sum()) for a, b in zip(ys, gru_ops.gru_recurrence_reference(
            px_f, px_b, w_hh, b_hh))),
        "dpx": sum(int((a != b).sum()) for a, b in zip((dpx_f, dpx_b), want[:2])),
        "dhn": int((scratch["dhn"] != dhn_want).sum()),
    }
    return {"T": t_len, "N": n, "H": hid, "seed": seed,
            "form": gru_ops.wide_form(n, hid + -hid % 8, bf16, dev.index)[0],
            "dw_max": want[2].abs().max().item(), "dw_max_abs_err": err.max().item(),
            "err_over_1e-3_of_max": err.max().item() / bound,
            "entries_past_1e-3_of_max": int((err > bound + 1e-6).sum()), "entries": err.numel(),
            "dw_on_chains_dph_err_over_max": (dw - on_dph).abs().max().item()
            / on_dph.abs().max().item(),
            "bf16_entries_rounded_otherwise": flips,
            "bf16_entries": {"ys": 2 * ys[0].numel(), "dpx": 2 * dpx_f.numel(),
                             "dhn": scratch["dhn"].numel()}}


def f32_phase_readings(t_len: int, n: int, hid: int, seed: int) -> dict:
    """The f32 backward's coef and dW/db at (T, N, H), the 3xTF32 kernels'
    and the f32 plain versions', against float64 plain versions."""
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(seed)
    k = 1.0 / hid**0.5
    px = [torch.randn((t_len, n, 3 * hid), generator=g).to(dev) for _ in range(2)]
    w = ((torch.rand((2, hid, 3 * hid), generator=g) * 2 - 1) * k).to(dev)
    b = ((torch.rand((2, 3 * hid), generator=g) * 2 - 1) * k).to(dev)
    ys = [(torch.rand((t_len, n, hid), generator=g) * 2 - 1).to(dev) for _ in range(2)]
    dpx = [(torch.randn((t_len, n, 3 * hid), generator=g) * 0.1).to(dev) for _ in range(2)]
    lib, ptr, stream = gru_ops._bwd_lib(), _build.ptr, _build.stream_ptr(dev)
    coef = gru_ops.gru_bwd_coef_wide_f32(*px, *ys, w, b)
    old = torch.empty_like(coef)
    _build.check(lib, lib.ocrs_gru_bwd_coef(dev.index, ptr(px[0]), ptr(px[1]), ptr(ys[0]),
                                            ptr(ys[1]), ptr(w), ptr(b), ptr(old), t_len, n, hid,
                                            stream), "gru_bwd.cu coef")
    exact = gru_ops.gru_bwd_coefficients_reference(
        *(x.double() for x in (*px, *ys, w, b))).reshape(coef.shape)
    plain = gru_ops.gru_bwd_coefficients_reference(*px, *ys, w, b).reshape(coef.shape)
    out = {"T": t_len, "N": n, "H": hid, "seed": seed, "coef_max": exact.abs().max().item(),
           "coef_err": {name: (v.double() - exact).abs().max().item()
                        for name, v in (("wgmma", coef), ("mma_sync", old), ("plain", plain))},
           "coef_wgmma_err_by_coefficient": [(coef.double() - exact)[:, :, q].abs().max().item()
                                             for q in range(5)],
           "coef_wgmma_equals_mma_sync": torch.equal(coef, old)}
    del px, old, plain, exact
    ops64 = (ys[0].double(), ys[1].double(), gru_ops._dph(dpx[0].double(), dpx[1].double(),
                                                         coef.double()))
    dw64, db64 = gru_ops.gru_bwd_dw_reference(*ops64)
    del ops64
    errs = lambda dw, db: ((dw.double() - dw64).abs().max().item(),  # noqa: E731
                           (db.double() - db64).abs().max().item())
    splits = gru_ops._dw_splits(t_len, n, hid)
    out.update(dw_max=dw64.abs().max().item(), db_max=db64.abs().max().item(), dw_ranges=splits)
    out["dw_db_err"] = {f"wgmma_{s}": errs(*gru_ops.gru_bwd_dw_wide_f32(*ys, *dpx, coef, s))
                        for s in sorted({1, 2, splits})}
    old_splits = gru_ops._dw_splits(t_len, n)
    h3 = 3 * hid
    dwp = torch.empty((old_splits, 2, hid, h3), device=dev)
    dbp = torch.empty((old_splits, 2, h3), device=dev)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    _build.check(lib, lib.ocrs_gru_bwd_dw(dev.index, ptr(ys[0]), ptr(ys[1]), ptr(dpx[0]),
                                          ptr(dpx[1]), ptr(coef), ptr(dwp), ptr(dbp), ptr(dw),
                                          ptr(db), old_splits, t_len, n, hid, stream),
                 "gru_bwd.cu dw")
    out["dw_db_err"][f"mma_sync_{old_splits}"] = errs(dw, db)
    out["dw_db_err"]["plain"] = errs(*gru_ops.gru_bwd_dw_reference(
        *ys, gru_ops._dph(*dpx, coef)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--t", type=int, default=257)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--hid", type=int, default=1024)
    ap.add_argument("--dw-readings", type=int, metavar="SEED", default=None)
    ap.add_argument("--f32-phase-readings", type=int, metavar="SEED", default=None)
    ap.add_argument("--f32", action="store_true", help="probe the f32 grid form instead")
    ap.add_argument("--backward", action="store_true",
                    help="only the backward's coef and dw (both tile orders) at (T, N, H)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grid_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t_len, n, hid = args.t, args.n, args.hid
    if args.dw_readings is not None:
        print(json.dumps(dw_readings(t_len, n, hid, args.dw_readings)), flush=True)
        return
    if args.f32_phase_readings is not None:
        print(json.dumps(f32_phase_readings(t_len, n, hid, args.f32_phase_readings)), flush=True)
        return
    if args.f32:
        f32_probe(t_len, n, hid)
        return
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    form, plan = gru_ops.wide_form(n, hid, bf16, dev.index)
    if form != "grid":
        raise SystemExit(f"grid_probe: H={hid} takes the {form} form, not the grid form")
    units, rows = plan.units, plan.rows
    libs = {} if args.backward else _build_all(_variants(plan))
    gen = torch.Generator().manual_seed(3)
    px = [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev, bf16) for _ in range(2)]
    w = _build.rounded(((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / hid**0.5)
                       .to(dev), bf16).contiguous()
    b = torch.zeros((2, 3 * hid), device=dev)
    dy = [(torch.randn((t_len, n, hid), generator=gen) * 0.1).to(dev, bf16) for _ in range(2)]
    coef = torch.rand((2, t_len * n, 5, hid), device=dev)
    ys = [torch.empty((t_len, n, hid), device=dev, dtype=bf16) for _ in range(2)]
    dpx = [torch.empty((t_len, n, 3 * hid), device=dev, dtype=bf16) for _ in range(2)]
    dhn = torch.empty((2, t_len * n, hid), device=dev, dtype=bf16)
    tiles = -(-n // rows)
    dbp = torch.empty((tiles, 2, 3 * hid), device=dev)
    hs, carry = torch.empty((2, n, hid), device=dev), torch.empty((2, n, hid), device=dev)
    ctr = torch.empty((2 * tiles,), device=dev, dtype=torch.int32)
    ffrag, cfrag = gru_ops._grid_frag(n, hid, dev), gru_ops._grid_frag(n, 3 * hid, dev)
    (fwst, felems), (cwst, celems) = (gru_ops._grid_stream(kind, hid, plan, dev)
                                      for kind in ("fwd", "chain"))
    ptr, stream = _build.ptr, _build.stream_ptr(dev)

    def opt(t):
        return None if t is None else ptr(t)

    def fwd(dll, steps=t_len):
        return lambda: _build.check(dll, dll.ocrs_gru_grid_fwd_bf16(
            dev.index, ptr(px[0]), ptr(px[1]), ptr(w), ptr(b), ptr(hs), ptr(ffrag), ptr(ys[0]),
            ptr(ys[1]), ptr(ctr), opt(fwst), felems, steps, n, hid, units, rows,
            plan.fwd.resident, plan.fwd.stages, plan.fwd.pass_rows, stream), "grid_probe forward")

    def chain(dll):
        return lambda: _build.check(dll, dll.ocrs_gru_grid_chain_bf16(
            dev.index, ptr(dy[0]), ptr(dy[1]), ptr(w), ptr(coef), ptr(carry), ptr(cfrag),
            ptr(dpx[0]), ptr(dpx[1]), ptr(dhn), ptr(dbp), tiles, ptr(ctr), opt(cwst), celems,
            t_len, n, hid, units, rows, plan.chain.resident, plan.chain.stages,
            plan.chain.pass_rows, stream),
            "grid_probe chain")

    shape = {"T": t_len, "N": n, "H": hid, "units": units, "rows": rows,
             "w_split": {"fwd": plan.fwd._asdict(), "chain": plan.chain._asdict()}}
    for name, dll in libs.items():
        if name == "phases":
            continue
        if args.backward:
            break
        print(json.dumps({"variant": name, **shape, "fwd_ms": _events_ms(fwd(dll)),
                          "chain_ms": _events_ms(chain(dll))}), flush=True)
    blocks = 2 * tiles * -(-hid // units)
    if args.backward:
        _backward_phases(shape, dev, t_len, n, hid, px, ys, dpx, dhn, dbp, tiles, w, b, coef)
        return
    marks = torch.zeros((blocks, t_len, 5), device=dev, dtype=torch.int64)
    ring = torch.zeros((blocks,), device=dev, dtype=torch.int64)
    phases = libs["phases"]
    _build.check(phases, phases.ocrs_probe_set(ptr(marks), ptr(ring)), "grid_probe phases")
    names = ("wait", "product", "gate_math", "signal_to_next", "ring_wait")
    for kernel, call in (("fwd", fwd(phases)), ("chain", chain(phases))):
        ring.zero_()
        call()
        torch.cuda.synchronize()
        m = marks[:, 1:].double()  # steps after the first (no wait before it)
        parts = [m[..., 1] - m[..., 0], m[..., 2] - m[..., 1], m[..., 3] - m[..., 2],
                 marks[:, 2:, 0].double() - marks[:, 1:-1, 3].double(),
                 marks[:, 1:, 4].double() - marks[:, :-1, 4].double()]
        wait = parts[0].flatten()
        print(json.dumps({"phases": kernel, **shape, "blocks": blocks,
                          **{f"{k}_cycles": p.mean().item() for k, p in zip(names, parts)},
                          "wait_p50_cycles": wait.quantile(0.5).item(),
                          "wait_p90_cycles": wait.quantile(0.9).item(),
                          "step_cycles": (marks[:, 2:, 0] - marks[:, 1:-1, 0]).double().mean().item()}),
              flush=True)
    _backward_phases(shape, dev, t_len, n, hid, px, ys, dpx, dhn, dbp, tiles, w, b, coef)
    for steps in (s for s in (2, 33) if s <= t_len):  # within the T steps of px and ys
        print(json.dumps({"variant": "full", **shape, "T": steps,
                          "fwd_ms": _events_ms(fwd(libs["full"], steps))}), flush=True)


def _backward_phases(shape, dev, t_len, n, hid, px, ys, dpx, dhn, dbp, tiles, w, b, coef) -> None:
    """The bf16 backward's phases around the chain at (T, N, H), by CUDA
    events (one JSON line): ``coef`` and ``dw`` of ``gru_bwd_wide.cu`` in
    both tile orders, up to H=2048 ``gru_bwd.cu``'s beside, W_hh's cast."""
    bf16, ptr, stream = torch.bfloat16, _build.ptr, _build.stream_ptr(dev)
    bwd, wide = gru_ops._bwd_lib(), gru_ops._bwd_wide_lib()
    coef_out = torch.empty_like(coef)
    splits, splits_tc = gru_ops._dw_splits(t_len, n), gru_ops._dw_splits(t_len, n, hid, True)
    dwp = torch.empty((max(splits, splits_tc), 2, hid, 3 * hid), device=dev)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    w16 = w.to(bf16)
    order = gru_ops.BWD_WIDE_ORDER
    split = {
        f"{name}{'' if o == order else '_order_' + str(o)}_ms": fn
        for o in (order, 1 - order) for name, fn in (
            ("coef", lambda o=o: _build.check(wide, wide.ocrs_gru_bwd_coef_wide_bf16(
                dev.index, ptr(px[0]), ptr(px[1]), ptr(ys[0]), ptr(ys[1]), ptr(w16), ptr(b),
                ptr(coef_out), t_len, n, hid, o, stream), "grid_probe coef")),
            ("dw", lambda o=o: _build.check(wide, wide.ocrs_gru_bwd_dw_wide_bf16(
                dev.index, ptr(ys[0]), ptr(ys[1]), ptr(dpx[0]), ptr(dpx[1]), ptr(dhn), ptr(dwp),
                ptr(dbp), tiles, ptr(dw), ptr(db), splits_tc, t_len, n, hid, o, stream),
                "grid_probe dw")))}
    split.update({} if hid > 2048 else {
        "coef_mma_sync_ms": lambda: _build.check(bwd, bwd.ocrs_gru_bwd_coef_bf16(
            dev.index, ptr(px[0]), ptr(px[1]), ptr(ys[0]), ptr(ys[1]), ptr(w), ptr(b),
            ptr(coef_out), t_len, n, hid, stream), "grid_probe coef"),
        "dw_mma_sync_ms": lambda: _build.check(bwd, bwd.ocrs_gru_bwd_dw_bf16(
            dev.index, ptr(ys[0]), ptr(ys[1]), ptr(dpx[0]), ptr(dpx[1]), ptr(dhn), ptr(dwp),
            ptr(dbp), tiles, ptr(dw), ptr(db), splits, t_len, n, hid, stream), "grid_probe dw")})
    split["cast_ms"] = lambda: _build.rounded(w, bf16).contiguous()
    print(json.dumps({"backward_phases": True, **shape,
                      **{k: _events_ms(fn) for k, fn in split.items()}}), flush=True)


if __name__ == "__main__":
    main()
