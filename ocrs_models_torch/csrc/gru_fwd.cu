// Bidirectional GRU recurrence of one layer, forward, in float32 or bfloat16.
//
// Replaces: the forward of the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py (`_fwd_call`, body
// `_fwd_kernel`). Same contract: px_f, px_b [T, N, 3H] are x @ W_ih + b_ih
// per direction in natural time order; the backward direction reads step
// T-1-i and writes its output back in natural order. w_hh [2, H, 3H] is
// laid out for h @ W (direction 0 = forward), b_hh [2, 3H]. Gate order is
// r, z, n with n = tanh(xn + r * (W_hn h + b_hn)); all gate math is f32.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At T=201, N=128, H=256: each step is one [N,H] x [H,3H]
// product per direction, 2 * 2*128*256*768 = 100.7 MFLOP for both, and
// the T steps form a chain of dependent products, so the whole call is
// 20.2 GFLOP, 0.30 ms at the f32 rate. The device-memory traffic is px
// read once (158 MB), ys written once (52.7 MB) and W_hh (1.6 MB): 212 MB,
// 63 us. Operations bound it, and the chain bounds it harder: a block's
// share of one step, 16 x 256 x 96 FMAs, takes 3072 cycles of one SM's
// FMA pipes (1.75 us at 1.755 GHz) whatever the rest of the card does.
//
// Design: ONE launch for all T steps. The grid is (tiles of 32 hidden
// units, tiles of R batch rows, direction); the blocks of one (batch
// tile, direction) form a thread block cluster of ceil(H/32) blocks (8 at
// H=256, the portable maximum), and clusters are independent of each
// other. A block owns the r, z and n columns of its 32 units and loops
// over the steps inside the kernel.
// - W_hh stays in REGISTERS: warp q of the block's 16 owns the k range
//   [16q, 16q+16) and lane l the unit l, so a thread keeps W_hh[16 k][3
//   gates] of its unit, 48 registers, loaded once. Per step it reads the
//   rows of h as float4 broadcasts (every lane of a warp reads the same
//   address, one wavefront) and does 12 FMAs per load; four warps per
//   scheduler hide the latency of those loads. An earlier layout that
//   kept the 96 KB slice in shared memory was bound by its shared loads
//   of W_hh, not by its FMAs. The product is straight-line code: the h
//   buffers have a fixed row stride and zero columns from H on, so no
//   guard on k breaks the unrolled loop into branches.
// - The 16 partial sums per output (one per warp) go through shared
//   memory; the thread that finishes the gate math of an element adds
//   them in a fixed order (gate math and px loads are spread over R * 16
//   threads, two units each).
// - The rows h_{t-1}[R, H] of the batch tile live in two ping-pong buffers
//   in every block's shared memory: after the gate math a block writes its
//   [R, 32] slice of h_t into the other-parity buffer of every block of
//   its cluster (distributed shared memory, `mapa` + `st.shared::cluster`),
//   then one cluster barrier per step, split into arrive and wait so that
//   the prefetch of px[t+1] overlaps the wait. Nothing of the state goes
//   through device memory.
// - R is 16 or 20, chosen per call from the batch size and the clusters
//   the card holds at once (gru_cluster.cuh).
// The products stay on the f32 FMA pipes: plain TF32 tensor-core products
// over a 200-step recurrence do not meet the 1e-4 tolerance against the
// plain version, and an error-compensated 3xTF32 product was not tried.
// H > 256 would need a cluster of more than 8 blocks; the wrapper raises
// for it (every width the repo's models use is <= 256).
//
// bf16 (`compute_dtype=jnp.bfloat16`, the Pallas kernel's default): px is
// read and ys written in bf16, and each step's product takes bf16(h) and
// bf16(W_hh) with f32 sums, while the gate update takes the f32 h, as in
// the Pallas kernel. So the blocks exchange bf16-ROUNDED h (as f32 values in
// the same buffers, which the product reads), and each thread keeps the f32
// state of its own elements in registers: the thread that finishes an
// element is the same at every step (e = tid + j * kThreads). The wrapper
// rounds W_hh to bf16 values; a product of two bf16 values is exact in
// f32, so the FMA loop is the bf16 dot with f32 accumulation. At T=201,
// N=128, H=256 the bytes halve (79 + 26 MB, 32 us) and bound it: the
// products take 20 us at the bf16 tensor-core rate (989 TFLOP/s). This
// kernel runs them as f32 FMAs (302 us at 67 TFLOP/s), one step after
// another.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "gru_cluster.cuh"

namespace {

using namespace gru_cluster;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // k range split across the warps
constexpr int kKPT = 16;               // k per warp: kWarps * kKPT >= H

// Gate functions on the fast exponential and division (ex2.approx,
// rcp.approx): they sit on every step's critical path, and the result
// stays within 5e-7 of the plain version after 201 steps (measured).
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

__device__ __forceinline__ float tanh_fast(float v) { return 2.f * sigmoid(2.f * v) - 1.f; }

// Row stride of the h buffers: the widest H, whatever H is, plus 4 floats
// so that rows start in different banks. Columns from H on stay zero, so
// the product runs over all kWarps * kKPT columns without a guard.
constexpr int kHS = kWarps * kKPT + 4;

size_t smem_bytes(int rows, int) {
    return sizeof(float) * ((size_t)2 * rows * kHS + (size_t)kWarps * rows * 3 * kBU);
}

// R batch rows per block (a multiple of 4, at most 32). Requires H % 8 == 0, H <= 256
// and a cluster of ceil(H / kBU) blocks along x, equal to gridDim.x. E is
// the element type of px and ys, float or bf16.
template <int R, typename E>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const E* __restrict__ px_f, const E* __restrict__ px_b,
               const float* __restrict__ w_hh, const float* __restrict__ b_hh,
               E* __restrict__ ys_f, E* __restrict__ ys_b, int T, int N, int H) {
    constexpr bool kBf16 = io::is_bf16<E>::value;
    constexpr int kPairs = R * (kBU / 2);  // gate-math elements come in pairs of units
    constexpr int kNE = (kPairs + kThreads - 1) / kThreads;
    static_assert(R % 4 == 0 && kWarps * kKPT == kMaxCluster * kBU, "tile sizes");
    extern __shared__ __align__(16) float smem[];
    constexpr int HS = kHS;
    float* hs = smem;                        // [2][R][HS]: rows of h, by step parity
    float* red = hs + 2 * R * HS;            // [kWarps][R][3][kBU]: partial products

    const int dir = blockIdx.z;
    const uint32_t n_peers = cluster_size();
    const int u0 = (int)cluster_rank() * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int tid = threadIdx.x;
    const int kq = tid / 32, lane = tid % 32;
    const int kb = kq * kKPT;

    // This thread's W_hh entries, for all steps: k in [kb, kb + kKPT), the
    // three gates of unit u0 + lane.
    float w[kKPT][3];
    {
        const float* W = w_hh + (size_t)dir * H * H3 + u0 + lane;
#pragma unroll
        for (int kk = 0; kk < kKPT; ++kk)
#pragma unroll
            for (int g = 0; g < 3; ++g)
                w[kk][g] = (kb + kk < H && u0 + lane < H)
                               ? __ldg(W + (size_t)(kb + kk) * H3 + g * H) : 0.f;
    }
    for (int i = tid; i < 2 * R * HS; i += kThreads) hs[i] = 0.f;  // h_0 = 0

    const float* b = b_hh + dir * H3;
    const E* px = dir == 0 ? px_f : px_b;
    E* ys = dir == 0 ? ys_f : ys_b;
    const size_t px_step = (size_t)N * H3, ys_step = (size_t)N * H;

    // Gate-math elements of this thread: pairs e = tid + j * kThreads, row
    // e / 16, units 2 * (e % 16) and the next. In bf16, hf holds their f32
    // state (the buffers hold it rounded).
    float2 xg[kNE][3], hf[kNE];
    {
        const int t = dir == 0 ? 0 : T - 1;
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
            const bool ok = e < kPairs && row < N && u < H;
#pragma unroll
            for (int g = 0; g < 3; ++g)
                xg[j][g] = ok ? io::ldg2(px + t * px_step + (size_t)row * H3 + g * H + u)
                              : make_float2(0.f, 0.f);
            hf[j] = make_float2(0.f, 0.f);
        }
    }

    // Every block of the cluster has zeroed its buffers before any peer
    // writes into them.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? step : T - 1 - step;
        const float* cur = hs + (step & 1) * R * HS;
        float* nxt = hs + ((step + 1) & 1) * R * HS;

        // Two chunks of R / 2 rows, so that the accumulators and the 48
        // registers of W_hh fit 128 registers a thread.
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
            constexpr int kRC = R / 2;
            const float* hrow = cur + ch * kRC * HS + kb;
            float acc[kRC][3];
#pragma unroll
            for (int r = 0; r < kRC; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
#pragma unroll
            for (int r = 0; r < kRC; r += 2) {
#pragma unroll
                for (int c = 0; c < kKPT; c += 4) {
                    float4 hv[2];
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        hv[i] = *reinterpret_cast<const float4*>(hrow + (r + i) * HS + c);
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int g = 0; g < 3; ++g) {
                            float a = acc[r + i][g];
                            a = fmaf(hv[i].x, w[c][g], a);
                            a = fmaf(hv[i].y, w[c + 1][g], a);
                            a = fmaf(hv[i].z, w[c + 2][g], a);
                            a = fmaf(hv[i].w, w[c + 3][g], a);
                            acc[r + i][g] = a;
                        }
                }
            }
#pragma unroll
            for (int r = 0; r < kRC; ++r)
#pragma unroll
                for (int g = 0; g < 3; ++g)
                    red[((kq * R + ch * kRC + r) * 3 + g) * kBU + lane] = acc[r][g];
        }
        __syncthreads();

        // Sum the warps' partials in a fixed order and finish the gate
        // math of this thread's elements.
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int er = e / (kBU / 2), eu = 2 * (e % (kBU / 2));
            const int row = n0 + er, u = u0 + eu;
            if (e < kPairs && u < H) {
                float2 ph[3], bg[3];
#pragma unroll
                for (int g = 0; g < 3; ++g) {
                    float2 s = *reinterpret_cast<const float2*>(red + (er * 3 + g) * kBU + eu);
#pragma unroll
                    for (int q = 1; q < kWarps; ++q) {
                        const float2 v = *reinterpret_cast<const float2*>(
                            red + ((q * R + er) * 3 + g) * kBU + eu);
                        s.x += v.x;
                        s.y += v.y;
                    }
                    ph[g] = s;
                    bg[g] = __ldg(reinterpret_cast<const float2*>(b + g * H + u));
                }
                const float2 hp =
                    kBf16 ? hf[j] : *reinterpret_cast<const float2*>(cur + er * HS + u);
                const float r0 = sigmoid(xg[j][0].x + (ph[0].x + bg[0].x));
                const float r1 = sigmoid(xg[j][0].y + (ph[0].y + bg[0].y));
                const float z0 = sigmoid(xg[j][1].x + (ph[1].x + bg[1].x));
                const float z1 = sigmoid(xg[j][1].y + (ph[1].y + bg[1].y));
                const float c0 = tanh_fast(xg[j][2].x + r0 * (ph[2].x + bg[2].x));
                const float c1 = tanh_fast(xg[j][2].y + r1 * (ph[2].y + bg[2].y));
                const float hn0 = (1.f - z0) * c0 + z0 * hp.x;
                const float hn1 = (1.f - z1) * c1 + z1 * hp.y;
                const float* dst = nxt + er * HS + u;
                if (kBf16) {
                    hf[j] = make_float2(hn0, hn1);
                    const float q0 = io::round_bf16(hn0), q1 = io::round_bf16(hn1);
                    for (uint32_t p = 0; p < n_peers; ++p) st_peer_f2(dst, p, q0, q1);
                } else {
                    for (uint32_t p = 0; p < n_peers; ++p) st_peer_f2(dst, p, hn0, hn1);
                }
                if (row < N) io::st2(ys + t * ys_step + (size_t)row * H + u, hn0, hn1);
            }
        }
        cluster_arrive();
        if (step + 1 < T) {
            const int tn = dir == 0 ? step + 1 : T - 2 - step;
#pragma unroll
            for (int j = 0; j < kNE; ++j) {
                const int e = tid + j * kThreads;
                const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
                if (e < kPairs && row < N && u < H) {
#pragma unroll
                    for (int g = 0; g < 3; ++g)
                        xg[j][g] = io::ldg2(px + tn * px_step + (size_t)row * H3 + g * H + u);
                }
            }
        }
        cluster_wait();
    }
}

template <typename E>
const void* kernel_for(int rows) {
    return rows == 16 ? (const void*)gru_fwd_kernel<16, E> : (const void*)gru_fwd_kernel<20, E>;
}

int reported_f32[kNumChoices][kMaxCluster + 1], reported_bf16[kNumChoices][kMaxCluster + 1];
const Family kFamily = {kernel_for<float>, smem_bytes, kThreads, reported_f32};
const Family kFamilyBf16 = {kernel_for<io::bf16>, smem_bytes, kThreads, reported_bf16};

template <typename E>
int launch(const Family& family, int device, const E* px_f, const E* px_b, const float* w_hh,
           const float* b_hh, E* ys_f, E* ys_b, int T, int N, int H, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1) return (int)cudaErrorInvalidValue;
    int rows = 0, max_active = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = pick_rows(family, N, H, &rows, &max_active);
    if (err == cudaSuccess) err = configure(family, rows, N, H, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    cfg.stream = (cudaStream_t)stream;
    void* args[] = {&px_f, &px_b, &w_hh, &b_hh, &ys_f, &ys_b, &T, &N, &H};
    err = cudaLaunchKernelExC(&cfg, family.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

int max_clusters(const Family& family, int device, int N, int H, int* rows_out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int max_active = 0;
    err = pick_rows(family, N, H, rows_out, &max_active);
    return err == cudaSuccess ? max_active : -(int)err;
}

}  // namespace

extern "C" {

// px_f, px_b [T, N, 3H]; w_hh [2, H, 3H]; b_hh [2, 3H]; ys_f, ys_b [T, N, H].
// All float32, contiguous, on CUDA device `device`, whose stream is
// `stream`. H % 8 == 0 and H <= 256. Returns the launch's CUDA error, or 0.
int ocrs_gru_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                 const float* b_hh, float* ys_f, float* ys_b, int T, int N, int H,
                 void* stream) {
    return launch(kFamily, device, px_f, px_b, w_hh, b_hh, ys_f, ys_b, T, N, H, stream);
}

// The same with px and ys bf16 (w_hh float32 holding bf16 values, b_hh
// float32).
int ocrs_gru_fwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                      const float* w_hh, const float* b_hh, io::bf16* ys_f, io::bf16* ys_b,
                      int T, int N, int H, void* stream) {
    return launch(kFamilyBf16, device, px_f, px_b, w_hh, b_hh, ys_f, ys_b, T, N, H, stream);
}

// How many clusters of the launch for (N, H) the device can hold at once
// (cudaOccupancyMaxActiveClusters); *rows_out gets the batch rows per block
// that ocrs_gru_fwd picks for that shape. Returns the count, or minus the
// CUDA error code.
int ocrs_gru_fwd_max_clusters(int device, int N, int H, int* rows_out) {
    return max_clusters(kFamily, device, N, H, rows_out);
}

// The same for ocrs_gru_fwd_bf16's launch.
int ocrs_gru_fwd_bf16_max_clusters(int device, int N, int H, int* rows_out) {
    return max_clusters(kFamilyBf16, device, N, H, rows_out);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
