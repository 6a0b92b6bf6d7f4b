"""Measurements behind the design of the wide biGRU's persistent kernels
(``csrc/gru_wide.cu``), on the card:

    python -m ocrs_models_torch.cluster_probe [--only lds|exchange|phases]

- ``lds``: cycles per warp-wide 16-byte shared-memory load (``LDS.128``) by
  address pattern, 512 threads on one SM: 1, 2, 4, 8 or 32 distinct
  16-byte words in a warp. The f32 forward's lanes pair up over the
  contraction so that a warp's loads of h touch two words.
- ``exchange``: cycles for every block of a 16-block cluster to send 6 KB
  (a tile of 48 rows x 32 f32 units) to each of its 15 peers, by
  mechanism: per-thread ``st.shared::cluster`` of 16 or 8 bytes and a
  cluster barrier, ``cp.async.bulk`` onto the peers' mbarriers (and a
  cluster barrier), and the cluster barrier alone; one cluster, and six
  at once (the f32 forward's launch at N=128).
- ``phases``: cycles a step by phase of the f32 persistent forward
  (``gru_wide_fwd_kernel``), read by thread 0 of block (0, 0, 0) from a copy
  of ``csrc/gru_wide.cu`` with ``clock64`` marks, at T=257 and (N, H) =
  (128, 512), (1, 512), (128, 264).

Each source is written to ``build/probe/`` and compiled by ``nvcc`` with the
flags of ``ops/_build.py``. Prints the card's name and power limit first.
Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from .ops import _build

LDS_SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512, 1) lds(int pattern, int iters, float* out, long long* cyc) {
    __shared__ __align__(16) float s[8192];
    for (int i = threadIdx.x; i < 8192; i += 512) s[i] = i * 1e-3f;
    __syncthreads();
    const int lane = threadIdx.x % 32;
    const int words[] = {1, 2, 4, 8, 32};
    const int off = (lane % words[pattern]) * 4;
    float4 acc = make_float4(0, 0, 0, 0);
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        const int base = (i * 128) & 4095;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            float4 v = *reinterpret_cast<const float4*>(s + ((base + u * 512 + off) & 8191));
            acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
    }
    __syncthreads();
    long long t1 = clock64();
    if (threadIdx.x == 0) *cyc = t1 - t0;
    out[threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}
int main() {
    float* out; long long* cyc;
    cudaMalloc(&out, 512 * 4); cudaMalloc(&cyc, 8);
    const int iters = 4096, words[] = {1, 2, 4, 8, 32};
    for (int p = 0; p < 5; ++p) {
        lds<<<1, 512>>>(p, iters, out, cyc);
        long long c;
        cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
        printf("LDS.128, %2d distinct 16-byte words a warp: %.3f cycles per warp-wide load\n",
               words[p], (double)c / (16.0 * iters * 8));
    }
    return 0;
}
"""

EXCHANGE_SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint32_t rank_() { uint32_t r; asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r)); return r; }
__device__ __forceinline__ uint32_t mapa(const void* p, uint32_t r) {
    uint32_t l = (uint32_t)__cvta_generic_to_shared(p), o;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(l), "r"(r));
    return o;
}
__device__ __forceinline__ void carrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cwait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }
__device__ __forceinline__ uint32_t s32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
constexpr int B = 6144, NP = 16;
__global__ void __cluster_dims__(16, 1, 1) __launch_bounds__(512, 1) xchg(int mode, int iters, long long* out) {
    extern __shared__ __align__(16) float sm[];
    float* recv = sm;              // [16][B / 4]
    float* src = sm + NP * B / 4;  // [B / 4]
    uint64_t* bar = reinterpret_cast<uint64_t*>(src + B / 4);
    const uint32_t rank = rank_();
    const int tid = threadIdx.x;
    for (int i = tid; i < B / 4; i += 512) src[i] = i + rank;
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(s32(bar)));
        asm volatile("fence.mbarrier_init.release.cluster;");
    }
    __syncthreads(); carrive(); cwait();
    long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
        if (mode == 0) {
            for (int i = tid; i < (NP - 1) * (B / 16); i += 512) {
                int p = i / (B / 16), o = i % (B / 16); p += p >= (int)rank;
                float4 v = reinterpret_cast<const float4*>(src)[o];
                asm volatile("st.shared::cluster.v4.f32 [%0], {%1,%2,%3,%4};"
                             :: "r"(mapa(recv + rank * B / 4 + 4 * o, p)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
            }
            carrive(); cwait();
        } else if (mode == 1) {
            for (int i = tid; i < (NP - 1) * (B / 8); i += 512) {
                int p = i / (B / 8), o = i % (B / 8); p += p >= (int)rank;
                float2 v = reinterpret_cast<const float2*>(src)[o];
                asm volatile("st.shared::cluster.v2.f32 [%0], {%1,%2};"
                             :: "r"(mapa(recv + rank * B / 4 + 2 * o, p)), "f"(v.x), "f"(v.y) : "memory");
            }
            carrive(); cwait();
        } else if (mode == 2) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            __syncthreads();
            if (tid == 0)
                asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                             :: "r"(s32(bar)), "r"((NP - 1) * B) : "memory");
            if (tid < NP && tid != (int)rank)
                asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                             :: "r"(mapa(recv + rank * B / 4, tid)), "r"(s32(src)), "r"(B), "r"(mapa(bar, tid)) : "memory");
            uint32_t done = 0;
            do {
                asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
                             : "=r"(done) : "r"(s32(bar)), "r"(it & 1) : "memory");
            } while (!done);
            carrive(); cwait();  // no block runs ahead into the next round's sources
        } else {
            carrive(); cwait();
        }
    }
    long long t1 = clock64();
    if (tid == 0 && rank == 0) *out = (t1 - t0) / iters;
}
int main() {
    long long* out;
    cudaMalloc(&out, 8);
    size_t smem = NP * B + B + 16;
    cudaFuncSetAttribute(xchg, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncSetAttribute(xchg, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    const char* names[] = {"st.shared::cluster.v4 + cluster barrier", "st.shared::cluster.v2 + cluster barrier",
                           "cp.async.bulk onto mbarriers + cluster barrier", "cluster barrier alone"};
    for (int m = 0; m < 4; ++m)
        for (int grid : {16, 96}) {
            xchg<<<grid, 512, smem>>>(m, 200, out);
            cudaError_t e = cudaDeviceSynchronize();
            long long c;
            cudaMemcpy(&c, out, 8, cudaMemcpyDeviceToHost);
            printf("%-48s %d cluster(s): %lld cycles a round (%s)\n", names[m], grid / 16, c,
                   cudaGetErrorString(e));
        }
    return 0;
}
"""

PHASES = ["prefetch px", "wait full", "product", "reduce + px wait", "block barrier 1",
          "free arrive + gate math + barrier 2", "wait free", "send"]

# (anchor in gru_wide_fwd_kernel, mark inserted before it); each anchor
# must occur once in the kernel's text.
_MARKS = [
    ("            if (n_peers > 1) {\n                if (step > 0) mbar_wait_cluster", 0),
    ("            float acc[kRC][3];\n", 1),
    ("            // The two lanes of a unit add their sums", 2),
    ("            __syncthreads();\n            // This block has read chunk c", 3),
    ("            // This block has read chunk c", 4),
    ("            if (!last && n_peers > 1) {\n                // This block's rows", 5),
    ("                constexpr int kF4 = kRC * (kBU / 4);", 6),
]


def _phases_source() -> str:
    """``csrc/gru_wide.cu`` with ``clock64`` marks in the f32 persistent
    forward, which thread 0 of block (0, 0, 0) sums by phase into
    ``g_probe`` (read by ``ocrs_probe_read``)."""
    src = (_build.CSRC_DIR / "gru_wide.cu").read_text()
    start = src.index("gru_wide_fwd_kernel(const float* __restrict__ px_f")
    end = src.index("// bf16 forward:")
    body = src[start:end]

    def insert(anchor: str, text: str) -> None:
        nonlocal body
        if body.count(anchor) != 1:
            raise RuntimeError(f"cluster_probe: the forward kernel no longer has {anchor!r}")
        body = body.replace(anchor, text + anchor)

    insert("    int chunk = 0;", "    long long pc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
           "    long long c0 = clock64(), c1;\n"
           "#define MARK(i) { c1 = clock64(); pc[i] += c1 - c0; c0 = c1; }\n")
    for anchor, i in _MARKS:
        insert(anchor, f"            MARK({i})\n")
    tail = "    cp_async_wait<0>();\n}"
    if body.count(tail) != 1:
        raise RuntimeError("cluster_probe: the forward kernel's end moved")
    body = body.replace(tail, tail.replace(
        "}", "    if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)\n"
        "        for (int i = 0; i < 8; ++i) g_probe[i] = pc[i];\n}"))
    send_end = ("                                reinterpret_cast<const float4*>(mine)[o]);\n"
                "                }\n            }\n")
    if body.count(send_end) != 1:
        raise RuntimeError("cluster_probe: the forward kernel's send moved")
    body = body.replace(send_end, send_end + "            MARK(7)\n")
    src = src[:start] + body + src[end:]
    src = src.replace("namespace {\n", "__device__ long long g_probe[8];\n\nnamespace {\n", 1)
    return src.replace('extern "C" {\n', 'extern "C" {\n\nint ocrs_probe_read(long long* out) {\n'
                       '    return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n', 1)


def _compile(name: str, text: str, shared: bool) -> str:
    out_dir = _build.build_dir().parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = out_dir / (f"lib{name}.so" if shared else name)
    cmd = [_build._nvcc(), *(_build.NVCC_FLAGS if shared else flags), "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
    return str(out)


def _run(name: str, text: str) -> None:
    print(subprocess.run([_compile(name, text, shared=False)], check=True, capture_output=True,
                         text=True, timeout=120).stdout, end="", flush=True)


def _phases() -> None:
    dll = ctypes.CDLL(_compile("gru_wide_phases", _phases_source(), shared=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.ocrs_gru_wide_fwd.argtypes = [I] + [P] * 6 + [I, I, I, P]
    dll.ocrs_probe_read.argtypes = [P]
    dev = torch.device("cuda", 0)
    for n, hid in ((128, 512), (1, 512), (128, 264)):
        t_len = 257
        gen = torch.Generator().manual_seed(0)
        px = [torch.randn((t_len, n, 3 * hid), generator=gen).to(dev) for _ in range(2)]
        w_hh = ((torch.rand((2, hid, 3 * hid), generator=gen) * 2 - 1) / hid**0.5).to(dev)
        b_hh = torch.zeros((2, 3 * hid), device=dev)
        ys = [torch.empty((t_len, n, hid), device=dev) for _ in range(2)]
        ptrs = [_build.ptr(x) for x in (*px, w_hh, b_hh, *ys)]
        rc = dll.ocrs_gru_wide_fwd(0, *ptrs, t_len, n, hid, _build.stream_ptr(dev))
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"cluster_probe: the instrumented forward failed ({rc})")
        cycles = (ctypes.c_longlong * 8)()
        dll.ocrs_probe_read(ctypes.cast(cycles, P))
        per_step = {k: round(v / t_len, 1) for k, v in zip(PHASES, cycles)}
        print(f"gru_wide_fwd f32 T={t_len} N={n} H={hid}: cycles a step by phase {per_step}, "
              f"total {sum(cycles) / t_len:.1f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=("lds", "exchange", "phases"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cluster_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.only in (None, "lds"):
        _run("lds_bench", LDS_SOURCE)
    if args.only in (None, "exchange"):
        _run("exchange_bench", EXCHANGE_SOURCE)
    if args.only in (None, "phases"):
        _phases()


if __name__ == "__main__":
    main()
