// Bidirectional GRU recurrence of one layer at any hidden width: the
// forward, and the backward's chain of dependent steps, in float32 or
// bfloat16 ("the wide route").
//
// Replaces: the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py, forward (`_fwd_call`, body
// `_fwd_kernel`) and the chain of its backward (`_bwd_call`, body
// `_bwd_kernel`), at the hidden widths that gru_fwd.cu and gru_bwd.cu's
// chain do not take: their blocks of one batch tile form a thread block
// cluster of ceil(H/32) blocks, at most 8, so they need H % 8 == 0 and
// H <= 256. The Pallas kernel takes any H (whole-array blocks of (1, N,
// 3H) and (2, H, 3H)). The wrapper (ops/gru.py) routes every other H here;
// a width that is not a multiple of 8 it zero-pads to the next one first
// (exact: see gru.py, `_pad_gates`). The backward's other phases, the
// coefficients before the chain and the dW/db reduction after it, are
// gru_bwd.cu's, which take any H % 8 == 0.
//
// Same contract as gru_fwd.cu and gru_bwd.cu: px_f, px_b [T, N, 3H] are x
// @ W_ih + b_ih per direction in natural time order (the backward
// direction reads step T-1-i); w_hh [2, H, 3H] for h @ W, b_hh [2, 3H];
// gate order r, z, n with n = tanh(xn + r * (W_hn h + b_hn)); all gate
// math in f32. In bf16 the rounding points are the Pallas kernel's: the
// forward carries the state h in f32 (scratch `hs`, never reread from the
// bf16 ys), multiplies bf16(h) by the wrapper's bf16-rounded W_hh with f32
// sums, and writes ys rounded to bf16; the chain multiplies bf16(dph) by
// the rounded W_hh^T, carries dh in f32, and writes dpx rounded to bf16.
// A product of two bf16 values is exact in f32, so an f32 FMA on them is
// the bf16 product with an f32 sum.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores, 989 TFLOP/s bf16 on them). At T=257, N=128, H=512 the
// forward multiplies [N,H] x [H,3H] per step and direction: 2 * 257 *
// 2*128*512*1536 = 103.5 GFLOP, 1.54 ms at the f32 rate (0.105 ms at the
// bf16 rate); its bytes, px read and ys written once, are 0.54 GB in f32,
// 0.16 ms. The chain's product [N,3H] x [3H,H] is as large, and the whole
// backward (the coefficients' [N,H] x [H,3H] and dW's [H,T*N] x [T*N,3H]
// beside it) is 310.6 GFLOP, 4.64 ms in f32 (0.314 ms in bf16), against
// 1.08 GB, 0.32 ms. Operations bound both, and the T dependent steps bound
// them harder: each step is one product too small to fill the card.
//
// Design: ONE LAUNCH PER STEP, the launch boundary being the grid-wide
// barrier between steps. Each launch is a tiled product of the previous
// step's state with W_hh (forward) or W_hh^T (chain), with the step's
// elementwise work in its epilogue.
// - Grid (tiles of 32 hidden units, tiles of 32 batch rows, direction),
//   128 threads. A thread owns 4 rows x 2 units: in the forward the r, z
//   and n columns of each (24 sums), so the gate math of an element runs
//   in the thread that summed it; in the chain the dh of each (8 sums).
// - The contraction runs in stages of 32: the state's [32 rows, 32 k]
//   and W's [32 k, 96 or 32 columns] are loaded as float4 into registers
//   while the previous stage is multiplied from shared memory (double
//   buffered). Per 4 k a thread reads its 4 rows as float4 broadcasts and
//   W as float2: 16 loads for 96 FMAs (forward), 8 for 32 (chain). Each
//   sum runs over k in order: no atomics, and reruns agree bit for bit.
// - The state lives in device memory between launches, in scratch of the
//   call's own (two calls on two streams share nothing): the forward's
//   f32 h in two buffers by step parity, [2][2, N, H]; the chain's dph
//   (rounded to bf16 values in bf16) in two buffers [2][2, N, 3H], and
//   dht * z, which the same thread reads at the next step, [2, N, H].
// - The chain also writes dpx[t] and, in bf16, bf16(dhn) [2, T*N, H] for
//   gru_bwd.cu's bf16 dW phase and db: the block's column sums of the
//   unrounded dph over its rows, in row order through shared memory, added
//   step by step into one partial per batch tile (no atomics: one thread
//   owns each entry). In f32, gru_bwd.cu's dW phase sums db as it does
//   for the cluster chain.
// At T=257 a call is 257 launches; a launch's product at N=128, H=512 is
// 128 blocks of 1.57 M FMA, about one block an SM, four warps each: too
// few to hide the shared loads' latency (measured: 25.0 us a forward step,
// 3.5x the FMA pipes' time; PERF.md). The products stay on the FMA pipes
// in bf16 too; the tensor cores, more warps an SM and one persistent
// launch are for a later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 32;                // batch rows per block
constexpr int kBU = 32;                // hidden units per block
constexpr int kBK = 32;                // contraction per stage
constexpr int kAS = kBK + 4;           // row stride of the state stage (16-byte rows)
constexpr int kNC = 5;                 // coefficients per element (gru_bwd.cu's coef)

using io::ldg2;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// x rounded to the nearest bf16 value, as float.
__device__ __forceinline__ float bf16_value(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lane(const float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lane(const float2& v, int q) { return q == 0 ? v.x : v.y; }

// Shared memory of the product with G column groups of kBU units.
template <int G>
struct Smem {
    float a[2][kBM][kAS];              // state rows, k along the row
    float b[2][kBK][G * kBU + 4];      // W rows (k), the block's columns along the row
};

template <int G>
struct Stage {
    float4 a[2];
    float4 b[2 * G];
};

// Global loads of one stage: rows m0.. of A [M, K] (zero past M or K; in
// bf16 products, rounded to bf16 values) and rows k0.. of B [K, ldb] at
// columns g * gstride + u0 .. + kBU for g < G (zero past K or H). K and H
// are multiples of 8, so a float4 lies wholly inside or outside.
template <int G, bool kRound>
__device__ __forceinline__ void stage_load(Stage<G>& st, const float* __restrict__ A, int M, int K,
                                           int m0, const float* __restrict__ B, int ldb,
                                           int gstride, int u0, int H, int k0, int tid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBK / 4), k = k0 + 4 * (idx % (kBK / 4));
        float4 v = (m0 + r < M && k < K)
                       ? __ldg(reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k))
                       : zero;
        if (kRound)
            v = make_float4(bf16_value(v.x), bf16_value(v.y), bf16_value(v.z), bf16_value(v.w));
        st.a[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) {
        const int idx = tid + i * kThreads;
        const int kr = idx / (G * kBU / 4), c = 4 * (idx % (G * kBU / 4));
        const int u = u0 + c % kBU;
        st.b[i] = (k0 + kr < K && u < H)
                      ? __ldg(reinterpret_cast<const float4*>(B + (size_t)(k0 + kr) * ldb +
                                                              (c / kBU) * gstride + u))
                      : zero;
    }
}

template <int G>
__device__ __forceinline__ void stage_store(const Stage<G>& st, Smem<G>& sm, int buf, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<float4*>(&sm.a[buf][idx / (kBK / 4)][4 * (idx % (kBK / 4))]) = st.a[i];
    }
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<float4*>(&sm.b[buf][idx / (G * kBU / 4)][4 * (idx % (G * kBU / 4))]) =
            st.b[i];
    }
}

// acc[i][g][j] += sum over the stage's k of A[row 4 tm + i][k] * B[k][g kBU + 2 tn + j].
template <int G>
__device__ __forceinline__ void stage_fma(float (&acc)[4][G][2], const Smem<G>& sm, int buf,
                                          int tm, int tn) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(&sm.a[buf][4 * tm + i][kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float2 b[G];
#pragma unroll
            for (int g = 0; g < G; ++g)
                b[g] = *reinterpret_cast<const float2*>(&sm.b[buf][kk + q][g * kBU + 2 * tn]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        acc[i][g][j] = fmaf(lane(a[i], q), lane(b[g], j), acc[i][g][j]);
        }
    }
}

// The block's tile of A [M, K] @ B: rows m0 .. m0 + kBM, columns g *
// gstride + u0 .. + kBU for each group g, over all K.
template <int G, bool kRound>
__device__ __forceinline__ void tile_product(float (&acc)[4][G][2], Smem<G>& sm,
                                             const float* __restrict__ A, int M, int K, int m0,
                                             const float* __restrict__ B, int ldb, int gstride,
                                             int u0, int H) {
    const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
    const int n_stages = (K + kBK - 1) / kBK;
    Stage<G> st;
    stage_load<G, kRound>(st, A, M, K, m0, B, ldb, gstride, u0, H, 0, tid);
    stage_store(st, sm, 0, tid);
    __syncthreads();
    for (int s = 0; s < n_stages; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_stages)
            stage_load<G, kRound>(st, A, M, K, m0, B, ldb, gstride, u0, H, (s + 1) * kBK, tid);
        stage_fma(acc, sm, buf, tm, tn);
        if (s + 1 < n_stages) stage_store(st, sm, buf ^ 1, tid);
        __syncthreads();
    }
}

// ---------------------------------------------------------------------
// forward: step `step` of both directions. h_in [2, N, H] is the state
// after the previous step (nullptr at step 0: h = 0), h_out the state
// after this one.

template <typename E>
__global__ void __launch_bounds__(kThreads)
gru_wide_fwd_step_kernel(const E* __restrict__ px_f, const E* __restrict__ px_b,
                         const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                         const float* __restrict__ h_in, float* __restrict__ h_out,
                         E* __restrict__ ys_f, E* __restrict__ ys_b, int step, int T, int N,
                         int H) {
    __shared__ __align__(16) Smem<3> sm;
    constexpr bool kBf16 = sizeof(E) == 2;
    const int dir = blockIdx.z, u0 = blockIdx.x * kBU, m0 = blockIdx.y * kBM;
    const int H3 = 3 * H;
    const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
    const float* h_prev = h_in == nullptr ? nullptr : h_in + (size_t)dir * N * H;

    float acc[4][3][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[i][g][0] = acc[i][g][1] = 0.f;
    if (h_prev != nullptr)
        tile_product<3, kBf16>(acc, sm, h_prev, N, H, m0, w_hh + (size_t)dir * H * H3, H3, H, u0,
                               H);

    const int u = u0 + 2 * tn;
    if (u >= H) return;
    const int t = dir == 0 ? step : T - 1 - step;
    const E* px = (dir == 0 ? px_f : px_b) + (size_t)t * N * H3 + u;
    E* ys = (dir == 0 ? ys_f : ys_b) + (size_t)t * N * H + u;
    float* hs = h_out + (size_t)dir * N * H + u;
    const float* b = b_hh + dir * H3 + u;
    const float2 br = ldg2(b), bz = ldg2(b + H), bn = ldg2(b + 2 * H);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * tm + i;
        if (m >= N) break;
        const E* p = px + (size_t)m * H3;
        const float2 xr = ldg2(p), xz = ldg2(p + H), xn = ldg2(p + 2 * H);
        const float2 hp = h_prev != nullptr
                              ? *reinterpret_cast<const float2*>(h_prev + (size_t)m * H + u)
                              : make_float2(0.f, 0.f);
        float h[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float r = sigmoid(lane(xr, j) + (acc[i][0][j] + lane(br, j)));
            const float z = sigmoid(lane(xz, j) + (acc[i][1][j] + lane(bz, j)));
            const float c = tanhf(lane(xn, j) + r * (acc[i][2][j] + lane(bn, j)));
            h[j] = (1.f - z) * c + z * lane(hp, j);
        }
        *reinterpret_cast<float2*>(hs + (size_t)m * H) = make_float2(h[0], h[1]);
        io::st2(ys + (size_t)m * H, h[0], h[1]);
    }
}

// ---------------------------------------------------------------------
// the backward's chain: step `step` of both directions' reverse scans
// (the forward direction at t = T-1-step, the backward one at t = step).
// dph_in [2, N, 3H] is the previous step's dph (bf16 values in bf16;
// nullptr at step 0: dh = 0), dph_out this step's; carry [2, N, H] holds
// dht * z from the previous step and gets this step's.
//   dh = carry + dph_in @ W_hh^T;  dht = dh + dy[t];  with the
//   coefficients q of (t, n): da_c = dht q1, da_z = dht q2, dhn = da_c q3,
//   da_r = da_c q4;  dpx[t] = [da_r, da_z, da_c];  dph = [da_r, da_z, dhn];
//   carry = dht q0 (q0 = z).
// dhn_out (bf16 only) [2, T*N, H] gets bf16(dhn); dbp (bf16 only)
// [batch tiles, 2, 3H] the sum of dph over the tile's rows and the steps
// so far.

template <typename E>
__global__ void __launch_bounds__(kThreads)
gru_wide_bwd_chain_step_kernel(const E* __restrict__ dy_f, const E* __restrict__ dy_b,
                           const float* __restrict__ w_t, const float* __restrict__ coef,
                           const float* __restrict__ dph_in, float* __restrict__ dph_out,
                           float* __restrict__ carry, E* __restrict__ dpx_f,
                           E* __restrict__ dpx_b, io::bf16* __restrict__ dhn_out,
                           float* __restrict__ dbp, int step, int T, int N, int H) {
    __shared__ __align__(16) Smem<1> sm;
    __shared__ float red[kBM][3 * kBU + 1];
    constexpr bool kBf16 = sizeof(E) == 2;
    const int dir = blockIdx.z, u0 = blockIdx.x * kBU, m0 = blockIdx.y * kBM;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

    float acc[4][1][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0][0] = acc[i][0][1] = 0.f;
    if (dph_in != nullptr)
        tile_product<1, false>(acc, sm, dph_in + (size_t)dir * N * H3, N, H3, m0,
                               w_t + (size_t)dir * H3 * H, H, 0, u0, H);

    const int t = dir == 0 ? T - 1 - step : step;
    const size_t row0 = (size_t)t * N;     // row (t, 0) of the [T * N] layouts
    const int u = u0 + 2 * tn;
    float part[4][3][2];                   // this thread's dph, for db
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) part[i][g][0] = part[i][g][1] = 0.f;
    if (u < H) {
        const E* dy = (dir == 0 ? dy_f : dy_b) + row0 * H + u;
        E* dpx = (dir == 0 ? dpx_f : dpx_b) + row0 * H3 + u;
        const float* cf = coef + ((size_t)dir * T * N + row0) * kNC * H + u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + 4 * tm + i;
            if (m >= N) break;
            float* cy = carry + ((size_t)dir * N + m) * H + u;
            float2 dh = make_float2(0.f, 0.f);
            if (dph_in != nullptr) {
                const float2 c = *reinterpret_cast<const float2*>(cy);
                dh = make_float2(c.x + acc[i][0][0], c.y + acc[i][0][1]);
            }
            const float2 g = ldg2(dy + (size_t)m * H);
            const float* q = cf + (size_t)m * kNC * H;
            const float2 cz = ldg2(q), ca = ldg2(q + H), cb = ldg2(q + 2 * H),
                         cr = ldg2(q + 3 * H), cc = ldg2(q + 4 * H);
            float da_r[2], da_z[2], da_c[2], dhn[2], keep[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float dht = lane(dh, j) + lane(g, j);
                da_c[j] = dht * lane(ca, j);
                da_z[j] = dht * lane(cb, j);
                dhn[j] = da_c[j] * lane(cr, j);
                da_r[j] = da_c[j] * lane(cc, j);
                keep[j] = dht * lane(cz, j);
                part[i][0][j] = da_r[j];
                part[i][1][j] = da_z[j];
                part[i][2][j] = dhn[j];
            }
            E* o = dpx + (size_t)m * H3;
            io::st2(o, da_r[0], da_r[1]);
            io::st2(o + H, da_z[0], da_z[1]);
            io::st2(o + 2 * H, da_c[0], da_c[1]);
            float* d = dph_out + ((size_t)dir * N + m) * H3 + u;
            if (kBf16) {
                *reinterpret_cast<float2*>(d) = make_float2(bf16_value(da_r[0]), bf16_value(da_r[1]));
                *reinterpret_cast<float2*>(d + H) =
                    make_float2(bf16_value(da_z[0]), bf16_value(da_z[1]));
                *reinterpret_cast<float2*>(d + 2 * H) =
                    make_float2(bf16_value(dhn[0]), bf16_value(dhn[1]));
                io::st2(dhn_out + ((size_t)dir * T * N + row0 + m) * H + u, dhn[0], dhn[1]);
            } else {
                *reinterpret_cast<float2*>(d) = make_float2(da_r[0], da_r[1]);
                *reinterpret_cast<float2*>(d + H) = make_float2(da_z[0], da_z[1]);
                *reinterpret_cast<float2*>(d + 2 * H) = make_float2(dhn[0], dhn[1]);
            }
            *reinterpret_cast<float2*>(cy) = make_float2(keep[0], keep[1]);
        }
    }
    if (!kBf16) return;
    // db: this block's rows summed in row order, then added to the tile's partial.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int j = 0; j < 2; ++j) red[4 * tm + i][g * kBU + 2 * tn + j] = part[i][g][j];
    __syncthreads();
    if (tid < 3 * kBU && u0 + tid % kBU < H) {
        float s = 0.f;
        for (int r = 0; r < kBM; ++r) s += red[r][tid];
        float* p = dbp + ((size_t)blockIdx.y * 2 + dir) * H3 + (tid / kBU) * H + u0 + tid % kBU;
        *p = step == 0 ? s : *p + s;
    }
}

bool shape_ok(int T, int N, int H) { return T >= 1 && N >= 1 && H >= 8 && H % 8 == 0; }

dim3 grid(int N, int H) { return dim3((H + kBU - 1) / kBU, (N + kBM - 1) / kBM, 2); }

template <typename E>
int launch_fwd(int device, const E* px_f, const E* px_b, const float* w_hh, const float* b_hh,
               float* hs, E* ys_f, E* ys_b, int T, int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!shape_ok(T, N, H)) return (int)cudaErrorInvalidValue;
    const size_t state = (size_t)2 * N * H;
    for (int i = 0; i < T; ++i) {
        const float* h_in = i == 0 ? nullptr : hs + ((i - 1) & 1) * state;
        gru_wide_fwd_step_kernel<E><<<grid(N, H), kThreads, 0, (cudaStream_t)stream>>>(
            px_f, px_b, w_hh, b_hh, h_in, hs + (i & 1) * state, ys_f, ys_b, i, T, N, H);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

template <typename E>
int launch_chain(int device, const E* dy_f, const E* dy_b, const float* w_t, const float* coef,
                 float* dph, float* carry, E* dpx_f, E* dpx_b, io::bf16* dhn, float* dbp, int T,
                 int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!shape_ok(T, N, H)) return (int)cudaErrorInvalidValue;
    const size_t state = (size_t)2 * N * 3 * H;
    for (int s = 0; s < T; ++s) {
        const float* dph_in = s == 0 ? nullptr : dph + ((s - 1) & 1) * state;
        gru_wide_bwd_chain_step_kernel<E><<<grid(N, H), kThreads, 0, (cudaStream_t)stream>>>(
            dy_f, dy_b, w_t, coef, dph_in, dph + (s & 1) * state, carry, dpx_f, dpx_b, dhn, dbp,
            s, T, N, H);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

// The forward: px_f, px_b [T, N, 3H]; w_hh [2, H, 3H] (bf16 values for
// the bf16 entry); b_hh [2, 3H]; scratch hs [2, 2, N, H] float32; out
// ys_f, ys_b [T, N, H]. H % 8 == 0 (any size). Contiguous, on CUDA device
// `device`, whose stream is `stream`. T launches. Returns the first CUDA
// error, or 0.
int ocrs_gru_wide_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                      const float* b_hh, float* hs, float* ys_f, float* ys_b, int T, int N,
                      int H, void* stream) {
    return launch_fwd(device, px_f, px_b, w_hh, b_hh, hs, ys_f, ys_b, T, N, H, stream);
}

// The same with px and ys bf16.
int ocrs_gru_wide_fwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                           const float* w_hh, const float* b_hh, float* hs, io::bf16* ys_f,
                           io::bf16* ys_b, int T, int N, int H, void* stream) {
    return launch_fwd(device, px_f, px_b, w_hh, b_hh, hs, ys_f, ys_b, T, N, H, stream);
}

// The backward's chain: dy_f, dy_b [T, N, H]; w_t [2, 3H, H] (W_hh^T);
// coef [2, T*N, 5, H] from gru_bwd.cu's ocrs_gru_bwd_coef; scratch dph
// [2, 2, N, 3H] and carry [2, N, H] float32; out dpx_f, dpx_b [T, N, 3H].
// H % 8 == 0. T launches. Returns the first CUDA error, or 0.
int ocrs_gru_wide_chain(int device, const float* dy_f, const float* dy_b, const float* w_t,
                        const float* coef, float* dph, float* carry, float* dpx_f, float* dpx_b,
                        int T, int N, int H, void* stream) {
    return launch_chain(device, dy_f, dy_b, w_t, coef, dph, carry, dpx_f, dpx_b,
                        (io::bf16*)nullptr, (float*)nullptr, T, N, H, stream);
}

// The same with dy and dpx bf16 (w_t holding bf16 values), and two more
// outputs for gru_bwd.cu's ocrs_gru_bwd_dw_bf16: dhn [2, T*N, H] bf16 and
// dbp [ceil(N / 32), 2, 3H] float32, db's partial per batch tile.
int ocrs_gru_wide_chain_bf16(int device, const io::bf16* dy_f, const io::bf16* dy_b,
                             const float* w_t, const float* coef, float* dph, float* carry,
                             io::bf16* dpx_f, io::bf16* dpx_b, io::bf16* dhn, float* dbp, int T,
                             int N, int H, void* stream) {
    return launch_chain(device, dy_f, dy_b, w_t, coef, dph, carry, dpx_f, dpx_b, dhn, dbp, T, N,
                        H, stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
