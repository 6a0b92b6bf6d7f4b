// Bidirectional GRU recurrence of one layer at the hidden widths the
// cluster kernels do not take: the forward, and the backward's chain of
// dependent steps, in float32 or bfloat16 ("the wide route").
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
// forward carries the state h in f32 (never reread from the bf16 ys),
// multiplies bf16(h) by the wrapper's bf16-rounded W_hh with f32 sums, and
// writes ys rounded to bf16; the chain multiplies bf16(dph) by the rounded
// W_hh^T, carries dh in f32, and writes dpx rounded to bf16. A product of
// two bf16 values is exact in f32, so an f32 FMA or a bf16 `mma` on them
// is the bf16 product with an f32 sum.
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
// Design: two forms, chosen by the width alone (ops/gru.py, `gru_route`):
//
// PERSISTENT, H <= 512 (namespace `persistent`): ONE launch for all T
// steps, the design of gru_fwd.cu and gru_bwd.cu's chain on clusters of up
// to 16 blocks (non-portable; gru_cluster.cuh allows them per kernel). The
// grid is (ceil(H/32) unit tiles, ceil(N/R) batch tiles, 2 directions);
// the blocks of one (batch tile, direction) form a cluster, one block an
// SM, and each block loops over the steps. Its slice of W_hh is loaded
// once and stays on chip; the state stays on chip; every sum runs in a
// fixed order and there are no atomics, so reruns agree bit for bit. R,
// the batch rows per block, is 16, 32 or 48, chosen per call by
// gru_cluster.cuh's cost model from the batch size and the clusters of 16
// the card holds at once (N=128 takes 32 if it holds 8, else 48).
// - f32 forward, 512 threads. The block's W_hh slice [H, 96] (its 32
//   units' r, z, n columns) is 192 KB at H=512: half the contraction (k <
//   256) stays in REGISTERS, 48 a thread as in gru_fwd.cu, the other half
//   in shared memory, 48 floats a thread read back by that thread alone.
//   Warp w takes 16 units and one unit tile of k from each half (w / 2);
//   the two lanes of a unit take alternate runs of 4 k, so a warp's loads
//   of h touch two 16-byte words (as cheap as a broadcast; four cost as
//   much as 32, measured on an H100) and their sums meet by one shuffle.
//   The 8 k groups' partials go through shared memory in chunks of 8 rows
//   and are added in a fixed order by the thread that does the element's
//   gate math; px of the next chunk's rows loads meanwhile (cp.async).
//   h_{t-1} [R, H] is f32 in ONE buffer a block (ping-pong buffers do not
//   fit beside W at R=48). The exchange runs chunk by chunk beside the
//   products, with no cluster barrier in the step: once every peer has
//   read its rows of chunk c of h_{t-1} (each says so by a remote mbarrier
//   arrive), a block sends its rows of chunk c of h_t, written in place by
//   the gate math, to each peer with `st.async`, whose bytes complete that
//   peer's mbarrier of chunk c; a block multiplies chunk c of h_t once
//   that mbarrier says every peer's rows have landed. A cluster of 16
//   moves about 11 bytes a cycle per SM whatever the instruction
//   (`st.shared::cluster` or `cp.async.bulk` alike; a cluster barrier
//   alone takes 1.6 k cycles; measured on an H100), so the 92 KB a block
//   sends a step at R=48 would take 4-5 us on its own. The z * h_{t-1} term
//   reads the f32 state from the block's own tile.
// - bf16 forward, 128 threads per 16 rows: gru_fwd.cu's bf16 kernel with
//   W_hh's slice in SHARED MEMORY (96 KB of bf16 at H=512, rows of 32 * n
//   + 8 values so that `ldmatrix` reads eight rows in eight bank groups)
//   instead of registers: the products on `mma.sync.m16n8k16` bf16 -> f32,
//   the gate math on the accumulator fragments, the f32 state in the
//   registers of the thread that owns the element, bf16(h) in ping-pong
//   tiles exchanged with `cp.async.bulk` onto the peers' mbarriers.
// - chains, 512 threads: gru_bwd.cu's chain. Each block multiplies its
//   own dph columns [R, 96] by its W_hh rows, which gives a partial dh
//   [R, H] for every block's units; warp w makes block w's [R, 32] and
//   stores it into block w's receive buffer, and a block adds the partials
//   of its units in block order. The receive buffer is single (4 * 16 * R *
//   32 bytes at 16 blocks; two of them do not fit beside W at R=48): a
//   cluster barrier (relaxed) after the block has read its partials,
//   waited on before the first store, and a second one that publishes the
//   stores, split around the prefetch of the next step's coefficients and
//   dy. (The f32 forward's mbarrier exchange made the chains slower: its
//   byte count on the receiver's mbarrier for every 8- or 16-byte store
//   cost more than the barrier, measured on an H100.) dht * z and dph
//   stay in registers and shared memory. f32: W_hh^T's slice [96, H] half
//   in registers and half in shared memory, as in the forward; lanes pair
//   up over the contraction
//   and meet by one shuffle; the sums run on the FMA pipes (R is 16-48 at
//   16 blocks, so m16 tiles would fill, but plain TF32 fails the
//   tolerances and 3xTF32 was not tried). bf16: `mma` on bf16(dph) with
//   W_hh^T as 48 registers of B fragments a thread; the chain also hands
//   gru_bwd.cu's bf16 dW phase bf16(dhn) and sums db from the unrounded
//   dph into one partial per batch tile of R rows.
//
// PER STEP, H > 512 (namespace `stepwise`): ONE LAUNCH PER STEP, the launch
// boundary being the grid-wide barrier between steps. Each launch is a
// tiled product of the previous step's state with W_hh (forward) or W_hh^T
// (chain), with the step's elementwise work in its epilogue.
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
// At T=257 a call is 257 launches; at N=128, H=512 a launch was 128 blocks
// of four warps, about one block an SM, too few to hide the shared loads'
// latency (25.0 us a forward step, 3.5x the FMA pipes' time; PERF.md). No
// cluster of 16 blocks holds a width above 512, so this form serves those.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "device_guard.cuh"
#include "gru_cluster.cuh"

namespace {

namespace stepwise {

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


}  // namespace stepwise

// ---------------------------------------------------------------------
// The persistent form (H <= 512)

namespace persistent {

using namespace gru_cluster;

constexpr int kThreads = 512;          // f32 kernels and chains
constexpr int kNC = 5;                 // coefficients per element (gru_bwd.cu's coef)
constexpr int kRC = 8;                 // rows per product chunk (f32)
constexpr int kRegTiles = 8;           // unit tiles of the contraction held in registers (k < 256)
constexpr int kWS4 = 12;               // float4s of W a thread keeps in shared memory (f32)
constexpr int kDS = 3 * kBU + 4;       // row stride of the f32 chain's dph slice
constexpr int kDSB = 3 * kBU + 8;      // bf16 row stride of the bf16 chain's dph slice
constexpr int kTS = kBU + 8;           // bf16 row stride of a unit tile of h (bf16 forward)
constexpr int kRows[] = {16, 32, 48};
// Fixed cost of a step in rows of products, for pick_rows: the barriers,
// the exchange and the gate math against the product's time per row.
// Estimates; they only weigh a choice that runs in fewer rounds against
// one with fewer rows, and at N=128 either way of weighing picks the
// choice that runs in one round.
constexpr int kF32StepCost = 8;
constexpr int kBf16StepCost = 16;

// Gate functions on the fast exponential and division (ex2.approx,
// rcp.approx), as in gru_fwd.cu.
__device__ __forceinline__ float sigmoid_fast(float v) {
    return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) { return 2.f * sigmoid_fast(2.f * v) - 1.f; }

__device__ __forceinline__ void st_peer_f4(const float* p, uint32_t rank, float4 v) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "r"(peer_address(p, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

// This block's arrival on the cluster barrier with no memory ordering: for
// a barrier that only says the block's earlier shared-memory reads (whose
// values it has used) are done.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

size_t sole(size_t need) { return need > kSoleBlockSmem ? need : kSoleBlockSmem; }

// ---------------------------------------------------------------------
// f32 forward

constexpr int kKG = 8;                 // k groups of the f32 forward's warps
constexpr int kMaxChunks = 48 / kRC;   // chunks of the largest row choice

// One arrival on the mbarrier at the address of `bar` in block `rank`,
// ordered after this thread's earlier memory accesses (cluster scope).
__device__ __forceinline__ void mbar_arrive_peer(const uint64_t* bar, uint32_t rank) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                 :: "r"(peer_address(bar, rank)) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed, with
// the arrivals' (and their blocks') earlier accesses visible to this
// thread. A peer that never signals (a fault in the kernel) traps after
// about ten seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (!done && clock64() - start > (1ll << 34)) __trap();
    } while (!done);
}

// v into block `rank`'s shared memory at the address of p, its 16 bytes
// counted on that block's mbarrier at the address of `bar`.
__device__ __forceinline__ void st_async_f4(const float* p, const uint64_t* bar, uint32_t rank,
                                            float4 v) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(peer_address(p, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
           "r"(peer_address(bar, rank))
        : "memory");
}

// [kWS4][kThreads] float4 of W (H > 256 only), h [n_tiles][R][32], the
// chunk's partials [kKG][kRC][3][32], px of a chunk's rows [2][kRC][96],
// mbarriers full and free [kMaxChunks] each.
size_t fwd_smem(int rows, int n_tiles) {
    const size_t ws = n_tiles > kRegTiles ? (size_t)kWS4 * kThreads * 4 : 0;
    return sole(sizeof(float) * (ws + (size_t)n_tiles * rows * kBU + kKG * kRC * 3 * kBU +
                                 2 * kRC * 3 * kBU) +
                2 * kMaxChunks * sizeof(uint64_t));
}

// px[t] of rows r0 .. r0 + kRC of the block's tile, its units, into pxs
// [kRC][96] (zero past N and H); one cp.async group.
__device__ __forceinline__ void prefetch_px(float* pxs, const float* px, int t, int r0, int N,
                                            int H, int n0, int u0, int tid) {
    const int H3 = 3 * H;
    if (tid < kRC * 3 * (kBU / 4)) {
        const int row = tid / (3 * (kBU / 4)), seg = tid % (3 * (kBU / 4));
        const int g = seg / (kBU / 4), u = u0 + 4 * (seg % (kBU / 4));
        const int n = n0 + r0 + row;
        const bool ok = n < N && u < H;
        const float* src = px + ((size_t)t * N + (ok ? n : 0)) * H3 + (ok ? g * H + u : 0);
        cp_async16(pxs + row * 3 * kBU + g * kBU + 4 * (seg % (kBU / 4)), src, ok ? 16 : 0);
    }
    cp_async_commit();
}

// R batch rows per block (a multiple of kRC, at most 48). Requires H % 8 ==
// 0, H <= 512 and a cluster of ceil(H / kBU) blocks along x, equal to
// gridDim.x.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru_wide_fwd_kernel(const float* __restrict__ px_f, const float* __restrict__ px_b,
                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                    float* __restrict__ ys_f, float* __restrict__ ys_b, int T, int N, int H) {
    constexpr int kChunks = R / kRC;
    static_assert(R % kRC == 0 && kChunks <= kMaxChunks && kThreads == 2 * kKG * 32,
                  "tile sizes");
    extern __shared__ __align__(16) float smem[];
    const int n_peers = (int)cluster_size();
    const uint32_t rank = cluster_rank();
    const bool wide = n_peers > kRegTiles;
    float4* ws = reinterpret_cast<float4*>(smem);
    float* hb = smem + (wide ? kWS4 * kThreads * 4 : 0);  // [n_peers][R][32]
    float* red = hb + n_peers * R * kBU;                   // [kKG][kRC][3][32]
    float* pxs = red + kKG * kRC * 3 * kBU;                // [2][kRC][96]
    // full[c]: the peers' rows of chunk c of the next h have landed here;
    // free[c]: every peer has read its rows of chunk c of this step's h.
    uint64_t* full = reinterpret_cast<uint64_t*>(pxs + 2 * kRC * 3 * kBU);
    uint64_t* free_ = full + kMaxChunks;

    const int dir = blockIdx.z, u0 = (int)rank * kBU, n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    // Warp w: the units [16 (w % 2), +16) and the k group w / 2 (unit tile
    // w / 2 from registers, tile 8 + w / 2 from shared memory); lane l: the
    // unit l / 2 of those and, within the tile, k = 8 j + 4 (l % 2) + q for
    // j, q < 4. The two lanes of a unit read 32 contiguous bytes of h.
    const int kg = warp / 2, ks = lane % 2;
    const int unit = 16 * (warp % 2) + lane / 2;  // of the block's 32
    const bool uok = u0 + unit < H;
    const bool reg_tile = kg < n_peers, smem_tile = wide && kRegTiles + kg < n_peers;

    // W_hh entries of this thread, for all steps: unit `unit`, gates r, z,
    // n, and k = 32 kg + 8 j + 4 ks + q (registers) or 256 + the same
    // (shared memory, [j * 3 + g][tid] as float4 over q); zero past H.
    float w[4][4][3];
    {
        const float* W = w_hh + (size_t)dir * H * H3 + u0 + unit;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int g = 0; g < 3; ++g) {
                    const int k = kBU * kg + 8 * j + 4 * ks + q;
                    w[j][q][g] = uok && k < H ? __ldg(W + (size_t)k * H3 + g * H) : 0.f;
                }
        if (wide) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int g = 0; g < 3; ++g) {
                    float v[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int k = kBU * (kRegTiles + kg) + 8 * j + 4 * ks + q;
                        v[q] = uok && k < H ? __ldg(W + (size_t)k * H3 + g * H) : 0.f;
                    }
                    ws[(j * 3 + g) * kThreads + tid] = make_float4(v[0], v[1], v[2], v[3]);
                }
        }
    }
    for (int i = tid; i < n_peers * R * kBU; i += kThreads) hb[i] = 0.f;  // h_0 = 0
    if (tid == 0 && n_peers > 1) {
        for (int c = 0; c < kChunks; ++c) {
            mbar_init(&full[c], 1);
            mbar_init(&free_[c], n_peers - 1);
        }
        fence_mbar_init();
    }

    // Gate math: thread tid < kRC * 32 owns, in chunk c, the element (row
    // c * kRC + tid / 32, unit tid % 32).
    const bool gm = tid < kRC * kBU;
    const int gr = tid / kBU, gu = tid % kBU;
    const bool guok = u0 + gu < H;
    float bg[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) bg[g] = gm && guok ? __ldg(b_hh + dir * H3 + g * H + u0 + gu) : 0.f;

    const float* px = dir == 0 ? px_f : px_b;
    float* ys = dir == 0 ? ys_f : ys_b;
    prefetch_px(pxs, px, dir == 0 ? 0 : T - 1, 0, N, H, n0, u0, tid);
    // Every block has zeroed its buffer and set up its mbarriers before any
    // peer signals or writes into them.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    // The exchange runs chunk by chunk, overlapping the products: a block
    // sends its rows of chunk c of h_{t} to a peer once every peer has read
    // chunk c of h_{t-1} (free[c]), and reads chunk c of h_t once every
    // peer's rows of it have landed (full[c], counted in bytes).
    const uint32_t chunk_bytes = (uint32_t)(n_peers - 1) * kRC * kBU * sizeof(float);
    int chunk = 0;  // chunks so far: its parity picks the px buffer
    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? step : T - 1 - step;
        const bool last = step + 1 == T;
#pragma unroll 1
        for (int c = 0; c < kChunks; ++c, ++chunk) {
            // The next chunk's px, into the other buffer (read last by the
            // chunk before this one, whose gate math is done).
            float* pnext = pxs + ((chunk + 1) & 1) * kRC * 3 * kBU;
            if (c + 1 < kChunks)
                prefetch_px(pnext, px, t, (c + 1) * kRC, N, H, n0, u0, tid);
            else if (!last)
                prefetch_px(pnext, px, dir == 0 ? step + 1 : T - 2 - step, 0, N, H, n0, u0, tid);
            else
                cp_async_commit();
            if (n_peers > 1) {
                if (step > 0) mbar_wait_cluster(&full[c], (step - 1) & 1);
                if (tid == 0 && !last) mbar_arrive_expect_tx(&full[c], chunk_bytes);  // next step's
            }

            float acc[kRC][3];
#pragma unroll
            for (int r = 0; r < kRC; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
            if (reg_tile) {  // uniform in the warp
                const float* hp = hb + (kg * R + c * kRC) * kBU + 4 * ks;
#pragma unroll
                for (int r = 0; r < kRC; ++r) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float4 a = *reinterpret_cast<const float4*>(hp + r * kBU + 8 * j);
#pragma unroll
                        for (int g = 0; g < 3; ++g) {
                            float s = acc[r][g];
                            s = fmaf(a.x, w[j][0][g], s);
                            s = fmaf(a.y, w[j][1][g], s);
                            s = fmaf(a.z, w[j][2][g], s);
                            s = fmaf(a.w, w[j][3][g], s);
                            acc[r][g] = s;
                        }
                    }
                }
            }
            if (smem_tile) {
                const float* hp = hb + ((kRegTiles + kg) * R + c * kRC) * kBU + 4 * ks;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float4 wv[3];
#pragma unroll
                    for (int g = 0; g < 3; ++g) wv[g] = ws[(j * 3 + g) * kThreads + tid];
#pragma unroll
                    for (int r = 0; r < kRC; ++r) {
                        const float4 a = *reinterpret_cast<const float4*>(hp + r * kBU + 8 * j);
#pragma unroll
                        for (int g = 0; g < 3; ++g) {
                            float s = acc[r][g];
                            s = fmaf(a.x, wv[g].x, s);
                            s = fmaf(a.y, wv[g].y, s);
                            s = fmaf(a.z, wv[g].z, s);
                            s = fmaf(a.w, wv[g].w, s);
                            acc[r][g] = s;
                        }
                    }
                }
            }
            // The two lanes of a unit add their sums (both get the same
            // value: fp addition commutes); lane 0 hands on gates r and z,
            // lane 1 gate n.
#pragma unroll
            for (int r = 0; r < kRC; ++r) {
                float s[3];
#pragma unroll
                for (int g = 0; g < 3; ++g) s[g] = acc[r][g] + __shfl_xor_sync(0xffffffffu, acc[r][g], 1);
                float* dst = red + ((kg * kRC + r) * 3) * kBU + unit;
                if (ks == 0) {
                    dst[0] = s[0];
                    dst[kBU] = s[1];
                } else {
                    dst[2 * kBU] = s[2];
                }
            }
            cp_async_wait<1>();  // this chunk's px has landed
            __syncthreads();
            // This block has read chunk c of h_{t-1}: the peers may send
            // theirs of h_t (from the last warp, which does no gate math).
            if (!last && warp == kThreads / 32 - 1 && lane < n_peers && lane != (int)rank)
                mbar_arrive_peer(&free_[c], lane);
            if (gm) {
                const int row = c * kRC + gr;
                float p[3];
#pragma unroll
                for (int g = 0; g < 3; ++g) {
                    float s = red[(gr * 3 + g) * kBU + gu];
#pragma unroll
                    for (int q = 1; q < kKG; ++q) s += red[((q * kRC + gr) * 3 + g) * kBU + gu];
                    p[g] = s;
                }
                const float* x = pxs + (chunk & 1) * kRC * 3 * kBU + gr * 3 * kBU + gu;
                float* hs = hb + (rank * R + row) * kBU + gu;
                const float r_ = sigmoid_fast(x[0] + (p[0] + bg[0]));
                const float z = sigmoid_fast(x[kBU] + (p[1] + bg[1]));
                const float cn = tanh_fast(x[2 * kBU] + r_ * (p[2] + bg[2]));
                const float h = guok ? (1.f - z) * cn + z * *hs : 0.f;
                *hs = h;  // the rows of this chunk are read no more this step
                if (guok && n0 + row < N) ys[((size_t)t * N + n0 + row) * H + u0 + gu] = h;
            }
            __syncthreads();
            if (!last && n_peers > 1) {
                // This block's rows of chunk c of h_t to every peer.
                mbar_wait_cluster(&free_[c], step & 1);
                constexpr int kF4 = kRC * (kBU / 4);  // float4s of a chunk's rows of a tile
                const float* mine = hb + (rank * R + c * kRC) * kBU;
                for (int i = tid; i < (n_peers - 1) * kF4; i += kThreads) {
                    int p = i / kF4;
                    const int o = i % kF4;
                    p += p >= (int)rank;
                    st_async_f4(mine + 4 * o, &full[c], (uint32_t)p,
                                reinterpret_cast<const float4*>(mine)[o]);
                }
            }
        }
    }
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// bf16 forward: 16 * MG batch rows per block, 4 * MG warps; warp w owns
// units [8 (w % 4), +8) of the block's 32 and the m16 tile of row group
// w / 4.

// h [2][n_tiles][R][kTS] bf16, W^T [96][32 n_tiles + 8] bf16, two mbarriers.
size_t fwd_bf16_smem(int rows, int n_tiles) {
    return sole(sizeof(io::bf16) * (2 * (size_t)n_tiles * rows * kTS + 96 * (32 * (size_t)n_tiles + 8)) +
                2 * sizeof(uint64_t));
}

template <int MG>
__global__ void __launch_bounds__(128 * MG, 1)
gru_wide_fwd_bf16_kernel(const io::bf16* __restrict__ px_f, const io::bf16* __restrict__ px_b,
                         const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                         io::bf16* __restrict__ ys_f, io::bf16* __restrict__ ys_b, int T, int N,
                         int H) {
    constexpr int R = 16 * MG;
    constexpr int kTile = R * kTS;  // one block's 32 units of the tile's rows
    constexpr int kThr = 128 * MG;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    const int K = (int)n_peers * kBU;  // the contraction, zero-padded past H
    const int kWS = K + 8;             // bf16 row stride of W^T
    io::bf16* hs = reinterpret_cast<io::bf16*>(smem_raw);  // [2][n_peers][R][kTS]
    io::bf16* wt = hs + 2 * n_peers * kTile;               // [96][kWS]
    uint64_t* bars = reinterpret_cast<uint64_t*>(wt + 96 * kWS);  // [2]

    const int dir = blockIdx.z;
    const int u0 = (int)rank * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int ubl = (warp % 4) * 8;       // the warp's 8 units, of the block's 32
    const int ub = u0 + ubl;
    const int m0 = (warp / 4) * 16;       // the warp's first row of the tile
    const bool uok = ub < H;              // all 8 units exist, or none (H % 8 == 0)
    const int unit = ub + 2 * tig;        // this thread's C columns: unit, unit + 1

    // The block's slice of W_hh as bf16, transposed: wt[g * 32 + ul][k] =
    // W[k][g * H + u0 + ul], zero past H.
    {
        const float* W = w_hh + (size_t)dir * H * H3;
        for (int i = tid; i < 96 * K; i += kThr) {
            const int k = i / 96, c = i % 96, g = c / kBU, ul = c % kBU;
            const float v = k < H && u0 + ul < H ? __ldg(W + (size_t)k * H3 + g * H + u0 + ul) : 0.f;
            wt[c * kWS + k] = __float2bfloat16_rn(v);
        }
    }
    float bg[3][2];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
        const float2 v = uok ? __ldg(reinterpret_cast<const float2*>(b_hh + dir * H3 + g * H + unit))
                             : make_float2(0.f, 0.f);
        bg[g][0] = v.x;
        bg[g][1] = v.y;
    }
    {
        uint4* p = reinterpret_cast<uint4*>(hs);  // h_0 = 0, and units past H stay 0
        for (int i = tid; i < 2 * (int)n_peers * kTile * 2 / 16; i += kThr) p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        fence_mbar_init();
    }

    const io::bf16* px = dir == 0 ? px_f : px_b;
    io::bf16* ys = dir == 0 ? ys_f : ys_b;
    const size_t px_step = (size_t)N * H3, ys_step = (size_t)N * H;

    // This thread's elements: rows m0 + gid + 8 half of the tile, units
    // unit and unit + 1; their gate inputs and f32 state.
    uint32_t xg[2][3];
    float hf[2][2];
    {
        const int t = dir == 0 ? 0 : T - 1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = n0 + m0 + gid + 8 * half;
            const bool ok = uok && row < N;
#pragma unroll
            for (int g = 0; g < 3; ++g)
                xg[half][g] = ok ? __ldg(reinterpret_cast<const unsigned int*>(
                                       px + t * px_step + (size_t)row * H3 + g * H + unit))
                                 : 0u;
            hf[half][0] = hf[half][1] = 0.f;
        }
    }

    // Every block of the cluster has zeroed its buffers and set up its
    // mbarriers before any peer copies into them.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    // This lane's ldmatrix rows: of an A tile (row lane % 16, k (lane / 16)
    // * 8), and of W^T for gates 0-1 (x4) and gate 2 (x2): row (lane / 16)
    // * 32 + ubl + lane % 8, k ((lane / 8) % 2) * 8.
    const uint32_t a_lane = smem_u32(hs) + 2u * ((m0 + lane % 16) * kTS + (lane / 16) * 8);
    const uint32_t b_lane01 =
        smem_u32(wt) + 2u * ((uint32_t)((lane / 16) * kBU + ubl + lane % 8) * kWS + ((lane / 8) % 2) * 8);
    const uint32_t b_lane2 =
        smem_u32(wt) + 2u * ((uint32_t)(2 * kBU + ubl + lane % 8) * kWS + ((lane / 8) % 2) * 8);
    const int k_steps = 2 * (int)n_peers;
    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? step : T - 1 - step;
        const uint32_t cur = a_lane + 2u * (step & 1) * n_peers * kTile;
        io::bf16* mine = hs + (((step + 1) & 1) * n_peers + rank) * kTile;  // next h, this block's units

        float acc[3][4];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[g][f] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < k_steps; ++ks) {
            uint32_t a[4], b01[4], b2[2];
            ldmatrix_x4(a, cur + 2u * ((ks / 2) * kTile + (ks % 2) * 16));
            ldmatrix_x4(b01, b_lane01 + 2u * 16 * ks);
            ldmatrix_x2(b2, b_lane2 + 2u * 16 * ks);
            mma_bf16(acc[0], a, b01[0], b01[1]);
            mma_bf16(acc[1], a, b01[2], b01[3]);
            mma_bf16(acc[2], a, b2[0], b2[1]);
        }

        // Gate math on the fragments; then ys, and bf16(h) into this block's tile.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const uint32_t* x = xg[half];
            float hn[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int f = 2 * half + j;
                const float xr = j ? hi_bf16(x[0]) : lo_bf16(x[0]);
                const float xz = j ? hi_bf16(x[1]) : lo_bf16(x[1]);
                const float xn = j ? hi_bf16(x[2]) : lo_bf16(x[2]);
                const float r = sigmoid_fast(xr + (acc[0][f] + bg[0][j]));
                const float z = sigmoid_fast(xz + (acc[1][f] + bg[1][j]));
                const float c = tanh_fast(xn + r * (acc[2][f] + bg[2][j]));
                const float h = (1.f - z) * c + z * hf[half][j];
                hn[j] = uok ? h : 0.f;
                hf[half][j] = hn[j];
            }
            const uint32_t hw = pack_bf16(hn[0], hn[1]);
            const int rl = m0 + gid + 8 * half;
            if (uok && n0 + rl < N)
                *reinterpret_cast<uint32_t*>(ys + t * ys_step + (size_t)(n0 + rl) * H + unit) = hw;
            *reinterpret_cast<uint32_t*>(mine + rl * kTS + ubl + 2 * tig) = hw;
        }
        if (step + 1 < T) {
            const int tn = dir == 0 ? step + 1 : T - 2 - step;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = n0 + m0 + gid + 8 * half;
                if (uok && row < N)
#pragma unroll
                    for (int g = 0; g < 3; ++g)
                        xg[half][g] = __ldg(reinterpret_cast<const unsigned int*>(
                            px + tn * px_step + (size_t)row * H3 + g * H + unit));
            }
            // This block's tile to every peer, and the peers' tiles here.
            // The next step's buffer was last read in the previous step,
            // before every block's copies of this one.
            fence_proxy_async();
            __syncthreads();
            uint64_t* bar = &bars[(step + 1) & 1];
            if ((uint32_t)tid < n_peers && (uint32_t)tid != rank)
                bulk_to_peer(mine, mine, 2u * kTile, bar, tid);
            if (tid == 0) mbar_arrive_expect_tx(bar, (n_peers - 1) * 2u * kTile);
            mbar_wait(bar, (step >> 1) & 1);
        }
    }
    // No block leaves while a copy from its shared memory may be running.
    cluster_arrive();
    cluster_wait();
}

// ---------------------------------------------------------------------
// the chains: what both dtypes share

// The elements of a chain thread: pairs e = tid + j * kThreads, row e /
// 16, units 2 * (e % 16) and the next; the coefficients and dy of step t
// (zero where the tile hangs over N or H, so that those elements give zero
// gradients and zero partial sums).
template <int kNE, int kPairs, typename E>
__device__ __forceinline__ void chain_load(float2 (&c)[kNE][kNC], float2 (&dyv)[kNE],
                                           const float* cf, const E* dy, int t, int N, int H,
                                           int n0, int u0, int tid, bool all) {
    const float2 zero2 = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kNE; ++j) {
        const int e = tid + j * kThreads;
        const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
        const bool ok = e < kPairs && row < N && u < H;
        if (!ok && !all) continue;
        const size_t m = (size_t)t * N + row;
#pragma unroll
        for (int q = 0; q < kNC; ++q) c[j][q] = ok ? io::ldg2(cf + (m * kNC + q) * H + u) : zero2;
        dyv[j] = ok ? io::ldg2(dy + m * H + u) : zero2;
    }
}

// ---------------------------------------------------------------------
// f32 chain

// [kWS4][kThreads] float4 of W, the partials received [n_tiles][R][32],
// the dph slice [R][kDS].
size_t chain_smem(int rows, int n_tiles) {
    return sole(sizeof(float) * ((size_t)kWS4 * kThreads * 4 + (size_t)n_tiles * rows * kBU +
                                 (size_t)rows * kDS));
}

// R batch rows per block (a multiple of kRC). Requires H % 8 == 0, H <= 512
// and a cluster of ceil(H / kBU) blocks along x, equal to gridDim.x.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru_wide_bwd_chain_kernel(const float* __restrict__ dy_f, const float* __restrict__ dy_b,
                      const float* __restrict__ w_hh, const float* __restrict__ coef,
                      float* __restrict__ dpx_f, float* __restrict__ dpx_b, int T, int N, int H) {
    constexpr int kPairs = R * (kBU / 2);
    constexpr int kNE = (kPairs + kThreads - 1) / kThreads;
    static_assert(R % kRC == 0 && kThreads == kMaxWideCluster * 32, "tile sizes");
    extern __shared__ __align__(16) float smem[];
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    float4* ws = reinterpret_cast<float4*>(smem);  // [kWS4][kThreads]
    float* recv = smem + kWS4 * kThreads * 4;      // [n_peers][R][32]: partial dh from each block
    float* ds = recv + n_peers * R * kBU;          // [R][kDS]: this block's dph slice

    const int dir = blockIdx.z;
    const int u0 = (int)rank * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int M = T * N;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    // Warp w makes the partial of block w's units; lane l the units 32 w +
    // 2 (l / 2) and the next, over this block's dph columns j = 8 i + 4 (l
    // % 2) + q (i < 6 in registers, the rest in shared memory).
    const bool wok = (uint32_t)warp < n_peers;
    const int ks = lane % 2;
    const int ua = 32 * warp + 2 * (lane / 2);

    float wr[6][4][2];
    {
        const float* W = w_hh + (size_t)dir * H * H3 + u0;
#pragma unroll
        for (int i = 0; i < 12; ++i)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                float x[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int j = 8 * i + 4 * ks + q, g = j / kBU, jl = j % kBU;
                    const int u = ua + v;
                    x[q] = wok && u < H && u0 + jl < H ? __ldg(W + (size_t)u * H3 + g * H + jl) : 0.f;
                }
                if (i < 6) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) wr[i][q][v] = x[q];
                } else {
                    ws[((i - 6) * 2 + v) * kThreads + tid] = make_float4(x[0], x[1], x[2], x[3]);
                }
            }
    }

    const float* dy = dir == 0 ? dy_f : dy_b;
    float* dpx = dir == 0 ? dpx_f : dpx_b;
    const float* cf = coef + (size_t)dir * M * kNC * H;
    const float2 zero2 = make_float2(0.f, 0.f);
    float2 c[kNE][kNC], dyv[kNE], dhz[kNE];  // dhz: dht * z of the previous step
    chain_load<kNE, kPairs>(c, dyv, cf, dy, dir == 0 ? T - 1 : 0, N, H, n0, u0, tid, true);
#pragma unroll
    for (int j = 0; j < kNE; ++j) dhz[j] = zero2;

    __syncthreads();
    cluster_arrive();
    cluster_wait();

    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? T - 1 - step : step;
        const bool last = step + 1 == T;
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int er = e / (kBU / 2), eu = 2 * (e % (kBU / 2));
            const int row = n0 + er, u = u0 + eu;
            if (e >= kPairs) continue;
            // dh = dht z + the partial products of all blocks, in block order.
            float2 back = zero2;
            if (step > 0) {
                const float* src = recv + er * kBU + eu;
                for (uint32_t p = 0; p < n_peers; ++p) {
                    const float2 v = *reinterpret_cast<const float2*>(src + p * R * kBU);
                    back.x += v.x;
                    back.y += v.y;
                }
            }
            const float dht0 = dhz[j].x + back.x + dyv[j].x;
            const float dht1 = dhz[j].y + back.y + dyv[j].y;
            const float da_c0 = dht0 * c[j][1].x, da_c1 = dht1 * c[j][1].y;
            const float da_z0 = dht0 * c[j][2].x, da_z1 = dht1 * c[j][2].y;
            const float dhn0 = da_c0 * c[j][3].x, dhn1 = da_c1 * c[j][3].y;
            const float da_r0 = da_c0 * c[j][4].x, da_r1 = da_c1 * c[j][4].y;
            dhz[j] = make_float2(dht0 * c[j][0].x, dht1 * c[j][0].y);
            if (row < N && u < H) {
                float* o = dpx + ((size_t)t * N + row) * H3 + u;
                io::st2(o, da_r0, da_r1);
                io::st2(o + H, da_z0, da_z1);
                io::st2(o + 2 * H, da_c0, da_c1);
            }
            float* d = ds + er * kDS + eu;
            io::st2(d, da_r0, da_r1);
            io::st2(d + kBU, da_z0, da_z1);
            io::st2(d + 2 * kBU, dhn0, dhn1);
        }
        if (last) break;  // the last step's dh is not needed
        cluster_arrive_relaxed();  // this block has read its partials
        __syncthreads();
#pragma unroll 1
        for (int ch = 0; ch < R / kRC; ++ch) {
            float acc[kRC][2];
#pragma unroll
            for (int r = 0; r < kRC; ++r) acc[r][0] = acc[r][1] = 0.f;
            if (wok) {
                const float* dr = ds + ch * kRC * kDS + 4 * ks;
#pragma unroll
                for (int i = 0; i < 6; ++i)
#pragma unroll
                    for (int r = 0; r < kRC; ++r) {
                        const float4 a = *reinterpret_cast<const float4*>(dr + r * kDS + 8 * i);
#pragma unroll
                        for (int v = 0; v < 2; ++v) {
                            float s = acc[r][v];
                            s = fmaf(a.x, wr[i][0][v], s);
                            s = fmaf(a.y, wr[i][1][v], s);
                            s = fmaf(a.z, wr[i][2][v], s);
                            s = fmaf(a.w, wr[i][3][v], s);
                            acc[r][v] = s;
                        }
                    }
#pragma unroll
                for (int i = 6; i < 12; ++i) {
                    const float4 w0 = ws[((i - 6) * 2) * kThreads + tid];
                    const float4 w1 = ws[((i - 6) * 2 + 1) * kThreads + tid];
#pragma unroll
                    for (int r = 0; r < kRC; ++r) {
                        const float4 a = *reinterpret_cast<const float4*>(dr + r * kDS + 8 * i);
                        acc[r][0] = fmaf(a.w, w0.w, fmaf(a.z, w0.z, fmaf(a.y, w0.y, fmaf(a.x, w0.x, acc[r][0]))));
                        acc[r][1] = fmaf(a.w, w1.w, fmaf(a.z, w1.z, fmaf(a.y, w1.y, fmaf(a.x, w1.x, acc[r][1]))));
                    }
                }
#pragma unroll
                for (int r = 0; r < kRC; ++r)
#pragma unroll
                    for (int v = 0; v < 2; ++v) acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], 1);
            }
            if (ch == 0) cluster_wait();  // every block has read its partials
            if (wok) {
                // The lane pair holds the same sums; each stores every other row.
                float* dst = recv + (rank * R + ch * kRC) * kBU + 2 * (lane / 2);
#pragma unroll
                for (int r = 0; r < kRC; ++r)
                    if (r % 2 == ks) st_peer_f2(dst + r * kBU, (uint32_t)warp, acc[r][0], acc[r][1]);
            }
        }
        cluster_arrive();
        chain_load<kNE, kPairs>(c, dyv, cf, dy, dir == 0 ? T - 2 - step : step + 1, N, H, n0, u0,
                                tid, false);
        cluster_wait();
    }
}

// ---------------------------------------------------------------------
// bf16 chain

// The partials received [n_tiles][R][32] f32, the dph slice [R][kDSB] bf16.
size_t chain_bf16_smem(int rows, int n_tiles) {
    return sole(sizeof(float) * (size_t)n_tiles * rows * kBU + sizeof(io::bf16) * rows * kDSB);
}

// R batch rows per block (16, 32 or 48). Requires H % 8 == 0, H <= 512 and a
// cluster of ceil(H / kBU) blocks along x, equal to gridDim.x. Writes dpx
// and bf16(dhn) [2][T*N][H] for gru_bwd.cu's dW phase, and this block's db
// over its rows to dbp[blockIdx.y][dir][3H].
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru_wide_bwd_chain_bf16_kernel(const io::bf16* __restrict__ dy_f, const io::bf16* __restrict__ dy_b,
                           const float* __restrict__ w_hh, const float* __restrict__ coef,
                           io::bf16* __restrict__ dpx_f, io::bf16* __restrict__ dpx_b,
                           io::bf16* __restrict__ dhn, float* __restrict__ dbp, int T, int N,
                           int H) {
    constexpr int MT = R / 16;
    constexpr int kPairs = R * (kBU / 2);
    constexpr int kNE = (kPairs + kThreads - 1) / kThreads;
    constexpr int kJSteps = 3 * kBU / 16;  // k16 steps over the block's 96 dph columns
    static_assert(R % 16 == 0 && kThreads / 32 == kMaxWideCluster, "tile sizes");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    float* recv = reinterpret_cast<float*>(smem_raw);  // [n_peers][R][32]: from each block
    io::bf16* ds = reinterpret_cast<io::bf16*>(recv + n_peers * R * kBU);  // [R][kDSB]

    const int dir = blockIdx.z;
    const int u0 = (int)rank * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int M = T * N;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const bool wok = (uint32_t)warp < n_peers;  // block `warp` exists

    // W_hh^T's B fragments: k = this block's dph column jl (gate jl / 32,
    // unit u0 + jl % 32), n = unit 32 warp + 8 nt + gid, for all steps.
    uint32_t wf[kJSteps][4][2];
    {
        const float* W = w_hh + (size_t)dir * H * H3;
#pragma unroll
        for (int ks = 0; ks < kJSteps; ++ks)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int n = 32 * warp + 8 * nt + gid;
                    const int jl = ks * 16 + 2 * tig + 8 * half;
                    const int g = jl / kBU, ul = jl % kBU;
                    const float* w = W + (size_t)n * H3 + g * H + u0 + ul;
                    wf[ks][nt][half] =
                        wok && n < H && u0 + ul < H ? pack_bf16(__ldg(w), __ldg(w + 1)) : 0u;
                }
    }

    const io::bf16* dy = dir == 0 ? dy_f : dy_b;
    io::bf16* dpx = dir == 0 ? dpx_f : dpx_b;
    io::bf16* dn = dhn + (size_t)dir * M * H;
    const float* cf = coef + (size_t)dir * M * kNC * H;
    const float2 zero2 = make_float2(0.f, 0.f);
    float2 c[kNE][kNC], dyv[kNE], dhz[kNE];  // dhz: dht * z of the previous step
    float2 dbacc[kNE][3];                    // sums of the unrounded da_r, da_z, dhn
    chain_load<kNE, kPairs>(c, dyv, cf, dy, dir == 0 ? T - 1 : 0, N, H, n0, u0, tid, true);
#pragma unroll
    for (int j = 0; j < kNE; ++j) dhz[j] = dbacc[j][0] = dbacc[j][1] = dbacc[j][2] = zero2;

    __syncthreads();
    cluster_arrive();
    cluster_wait();

    // This lane's ldmatrix row of an A tile of the dph slice.
    const uint32_t a_lane = smem_u32(ds) + 2u * ((lane % 16) * kDSB + (lane / 16) * 8);
    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? T - 1 - step : step;
        const bool last = step + 1 == T;
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int er = e / (kBU / 2), eu = 2 * (e % (kBU / 2));
            const int row = n0 + er, u = u0 + eu;
            if (e >= kPairs) continue;
            float2 back = zero2;
            if (step > 0) {
                const float* src = recv + er * kBU + eu;
                for (uint32_t p = 0; p < n_peers; ++p) {
                    const float2 v = *reinterpret_cast<const float2*>(src + p * R * kBU);
                    back.x += v.x;
                    back.y += v.y;
                }
            }
            const float dht0 = dhz[j].x + back.x + dyv[j].x;
            const float dht1 = dhz[j].y + back.y + dyv[j].y;
            const float da_c0 = dht0 * c[j][1].x, da_c1 = dht1 * c[j][1].y;
            const float da_z0 = dht0 * c[j][2].x, da_z1 = dht1 * c[j][2].y;
            const float dhn0 = da_c0 * c[j][3].x, dhn1 = da_c1 * c[j][3].y;
            const float da_r0 = da_c0 * c[j][4].x, da_r1 = da_c1 * c[j][4].y;
            dhz[j] = make_float2(dht0 * c[j][0].x, dht1 * c[j][0].y);
            dbacc[j][0].x += da_r0;
            dbacc[j][0].y += da_r1;
            dbacc[j][1].x += da_z0;
            dbacc[j][1].y += da_z1;
            dbacc[j][2].x += dhn0;
            dbacc[j][2].y += dhn1;
            if (row < N && u < H) {
                const size_t m = (size_t)t * N + row;
                io::bf16* o = dpx + m * H3 + u;
                io::st2(o, da_r0, da_r1);
                io::st2(o + H, da_z0, da_z1);
                io::st2(o + 2 * H, da_c0, da_c1);
                io::st2(dn + m * H + u, dhn0, dhn1);
            }
            uint32_t* d = reinterpret_cast<uint32_t*>(ds + er * kDSB + eu);
            d[0] = pack_bf16(da_r0, da_r1);
            d[kBU / 2] = pack_bf16(da_z0, da_z1);
            d[kBU] = pack_bf16(dhn0, dhn1);
        }
        if (last) break;  // the last step's dh is not needed
        cluster_arrive_relaxed();  // this block has read its partials
        __syncthreads();
        // Warp w: the partial dh of block w's 32 units over this block's 96
        // columns, an m16 tile at a time, stored into block w's buffer.
#pragma unroll 1
        for (int mt = 0; mt < MT; ++mt) {
            float acc[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int f = 0; f < 4; ++f) acc[nt][f] = 0.f;
            if (wok) {
#pragma unroll
                for (int ks = 0; ks < kJSteps; ++ks) {
                    uint32_t a[4];
                    ldmatrix_x4(a, a_lane + 2u * (mt * 16 * kDSB + ks * 16));
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], a, wf[ks][nt][0], wf[ks][nt][1]);
                }
            }
            if (mt == 0) cluster_wait();  // every block has read its partials
            if (wok) {
                // Pairs of lanes trade halves so that each holds 4 units of
                // one row: the even lane row gid, the odd lane row gid + 8.
                const bool odd = tig & 1;
                float* dst = recv + rank * R * kBU;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const float* a = acc[nt];
                    const float rx = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
                    const float ry = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
                    const float4 v = odd ? make_float4(rx, ry, a[2], a[3]) : make_float4(a[0], a[1], rx, ry);
                    const int row = mt * 16 + gid + (odd ? 8 : 0);
                    const int col = nt * 8 + 4 * (tig / 2);
                    st_peer_f4(dst + row * kBU + col, (uint32_t)warp, v);
                }
            }
        }
        cluster_arrive();
        chain_load<kNE, kPairs>(c, dyv, cf, dy, dir == 0 ? T - 2 - step : step + 1, N, H, n0, u0,
                                tid, false);
        cluster_wait();
    }
    // db of this block's 96 columns over its rows, in row order. The
    // partials were last read above (no block stores after its last step).
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);  // [R][3 kBU]
#pragma unroll
    for (int j = 0; j < kNE; ++j) {
        const int e = tid + j * kThreads;
        if (e < kPairs) {
            const int er = e / (kBU / 2), eu = 2 * (e % (kBU / 2));
#pragma unroll
            for (int g = 0; g < 3; ++g)
                *reinterpret_cast<float2*>(red + er * 3 * kBU + g * kBU + eu) = dbacc[j][g];
        }
    }
    __syncthreads();
    if (tid < 3 * kBU && u0 + tid % kBU < H) {
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += red[r * 3 * kBU + tid];
        dbp[((size_t)blockIdx.y * 2 + dir) * H3 + (tid / kBU) * H + u0 + tid % kBU] = s;
    }
}

// ---------------------------------------------------------------------
// the families and their launches

const void* fwd_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_wide_fwd_kernel<16>;
        case 32: return (const void*)gru_wide_fwd_kernel<32>;
        default: return (const void*)gru_wide_fwd_kernel<48>;
    }
}

const void* fwd_bf16_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_wide_fwd_bf16_kernel<1>;
        case 32: return (const void*)gru_wide_fwd_bf16_kernel<2>;
        default: return (const void*)gru_wide_fwd_bf16_kernel<3>;
    }
}

const void* chain_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_wide_bwd_chain_kernel<16>;
        case 32: return (const void*)gru_wide_bwd_chain_kernel<32>;
        default: return (const void*)gru_wide_bwd_chain_kernel<48>;
    }
}

const void* chain_bf16_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_wide_bwd_chain_bf16_kernel<16>;
        case 32: return (const void*)gru_wide_bwd_chain_bf16_kernel<32>;
        default: return (const void*)gru_wide_bwd_chain_bf16_kernel<48>;
    }
}

int threads_512(int) { return kThreads; }
int threads_bf16_fwd(int rows) { return 128 * (rows / 16); }

constexpr int kReports = kMaxChoices * (kMaxWideCluster + 1);
int reported_fwd[kReports], reported_fwd_bf16[kReports], reported_chain[kReports],
    reported_chain_bf16[kReports];
const Family kFwd = {fwd_for, fwd_smem, threads_512, kRows, 3, kF32StepCost, kMaxWideCluster,
                     reported_fwd};
const Family kFwdBf16 = {fwd_bf16_for, fwd_bf16_smem, threads_bf16_fwd, kRows, 3, kBf16StepCost,
                         kMaxWideCluster, reported_fwd_bf16};
const Family kChain = {chain_for, chain_smem, threads_512, kRows, 3, kF32StepCost,
                       kMaxWideCluster, reported_chain};
const Family kChainBf16 = {chain_bf16_for, chain_bf16_smem, threads_512, kRows, 3, kBf16StepCost,
                           kMaxWideCluster, reported_chain_bf16};

// One launch of `f`'s kernel with the rows pick_rows chooses for (N, H);
// `args` are the kernel's arguments. With `db_parts` > 0 the launch's batch
// tiles must not exceed it (the bf16 chain writes one db partial each).
int launch(const Family& f, int device, int T, int N, int H, void** args, int db_parts,
           void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1) return (int)cudaErrorInvalidValue;
    int rows = 0, max_active = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = pick_rows(f, N, H, &rows, &max_active);
    if (err == cudaSuccess) err = configure(f, rows, N, H, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    if (db_parts > 0 && (N + rows - 1) / rows > db_parts) return (int)cudaErrorInvalidValue;
    cfg.stream = (cudaStream_t)stream;
    err = cudaLaunchKernelExC(&cfg, f.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

int max_clusters(const Family& f, int device, int N, int H, int* rows_out) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int max_active = 0;
    err = pick_rows(f, N, H, rows_out, &max_active);
    return err == cudaSuccess ? max_active : -(int)err;
}

}  // namespace persistent

}  // namespace

extern "C" {

// The persistent forward (H <= 512): px_f, px_b [T, N, 3H]; w_hh [2, H, 3H];
// b_hh [2, 3H]; out ys_f, ys_b [T, N, H]. All float32, contiguous, on CUDA
// device `device`, whose stream is `stream`. H % 8 == 0 and H <= 512. One
// launch. Returns the launch's CUDA error, or 0.
int ocrs_gru_wide_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                      const float* b_hh, float* ys_f, float* ys_b, int T, int N, int H,
                      void* stream) {
    void* args[] = {&px_f, &px_b, &w_hh, &b_hh, &ys_f, &ys_b, &T, &N, &H};
    return persistent::launch(persistent::kFwd, device, T, N, H, args, 0, stream);
}

// The same with px and ys bf16 (w_hh float32 holding bf16 values).
int ocrs_gru_wide_fwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                           const float* w_hh, const float* b_hh, io::bf16* ys_f, io::bf16* ys_b,
                           int T, int N, int H, void* stream) {
    void* args[] = {&px_f, &px_b, &w_hh, &b_hh, &ys_f, &ys_b, &T, &N, &H};
    return persistent::launch(persistent::kFwdBf16, device, T, N, H, args, 0, stream);
}

// The persistent backward chain (H <= 512): dy_f, dy_b [T, N, H]; w_hh [2,
// H, 3H]; coef [2, T*N, 5, H] from gru_bwd.cu's ocrs_gru_bwd_coef; out
// dpx_f, dpx_b [T, N, 3H]. H % 8 == 0 and H <= 512. One launch.
int ocrs_gru_wide_chain(int device, const float* dy_f, const float* dy_b, const float* w_hh,
                        const float* coef, float* dpx_f, float* dpx_b, int T, int N, int H,
                        void* stream) {
    void* args[] = {&dy_f, &dy_b, &w_hh, &coef, &dpx_f, &dpx_b, &T, &N, &H};
    return persistent::launch(persistent::kChain, device, T, N, H, args, 0, stream);
}

// The same with dy and dpx bf16 (w_hh holding bf16 values), and two more
// outputs for gru_bwd.cu's ocrs_gru_bwd_dw_bf16: dhn [2, T*N, H] bf16 and
// dbp [db_parts, 2, 3H] float32, db's partial per batch tile of the rows
// per block that ocrs_gru_wide_chain_bf16_max_clusters reports (the call
// refuses a db_parts smaller than its tiles).
int ocrs_gru_wide_chain_bf16(int device, const io::bf16* dy_f, const io::bf16* dy_b,
                             const float* w_hh, const float* coef, io::bf16* dpx_f,
                             io::bf16* dpx_b, io::bf16* dhn, float* dbp, int db_parts, int T,
                             int N, int H, void* stream) {
    if (db_parts < 1) return (int)cudaErrorInvalidValue;
    void* args[] = {&dy_f, &dy_b, &w_hh, &coef, &dpx_f, &dpx_b, &dhn, &dbp, &T, &N, &H};
    return persistent::launch(persistent::kChainBf16, device, T, N, H, args, db_parts, stream);
}

// How many clusters of each persistent launch for (N, H) the device can
// hold at once (cudaOccupancyMaxActiveClusters); *rows_out gets the batch
// rows per block the entry picks for that shape. Returns the count, or
// minus the CUDA error code.
int ocrs_gru_wide_fwd_max_clusters(int device, int N, int H, int* rows_out) {
    return persistent::max_clusters(persistent::kFwd, device, N, H, rows_out);
}

int ocrs_gru_wide_fwd_bf16_max_clusters(int device, int N, int H, int* rows_out) {
    return persistent::max_clusters(persistent::kFwdBf16, device, N, H, rows_out);
}

int ocrs_gru_wide_chain_max_clusters(int device, int N, int H, int* rows_out) {
    return persistent::max_clusters(persistent::kChain, device, N, H, rows_out);
}

int ocrs_gru_wide_chain_bf16_max_clusters(int device, int N, int H, int* rows_out) {
    return persistent::max_clusters(persistent::kChainBf16, device, N, H, rows_out);
}

// The per-step forward (any H % 8 == 0; the wrapper sends H > 512 here):
// as ocrs_gru_wide_fwd, with scratch hs [2, 2, N, H] float32. T launches.
int ocrs_gru_wide_fwd_stepwise(int device, const float* px_f, const float* px_b,
                               const float* w_hh, const float* b_hh, float* hs, float* ys_f,
                               float* ys_b, int T, int N, int H, void* stream) {
    return stepwise::launch_fwd(device, px_f, px_b, w_hh, b_hh, hs, ys_f, ys_b, T, N, H, stream);
}

int ocrs_gru_wide_fwd_stepwise_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                                    const float* w_hh, const float* b_hh, float* hs,
                                    io::bf16* ys_f, io::bf16* ys_b, int T, int N, int H,
                                    void* stream) {
    return stepwise::launch_fwd(device, px_f, px_b, w_hh, b_hh, hs, ys_f, ys_b, T, N, H, stream);
}

// The per-step chain: dy_f, dy_b [T, N, H]; w_t [2, 3H, H] (W_hh^T); coef
// [2, T*N, 5, H]; scratch dph [2, 2, N, 3H] and carry [2, N, H] float32;
// out dpx_f, dpx_b [T, N, 3H]. H % 8 == 0. T launches.
int ocrs_gru_wide_chain_stepwise(int device, const float* dy_f, const float* dy_b,
                                 const float* w_t, const float* coef, float* dph, float* carry,
                                 float* dpx_f, float* dpx_b, int T, int N, int H, void* stream) {
    return stepwise::launch_chain(device, dy_f, dy_b, w_t, coef, dph, carry, dpx_f, dpx_b,
                                  (io::bf16*)nullptr, (float*)nullptr, T, N, H, stream);
}

// The same in bf16, with dhn [2, T*N, H] bf16 and dbp [ceil(N / rows), 2,
// 3H] float32 (rows: ocrs_gru_wide_stepwise_rows()).
int ocrs_gru_wide_chain_stepwise_bf16(int device, const io::bf16* dy_f, const io::bf16* dy_b,
                                      const float* w_t, const float* coef, float* dph,
                                      float* carry, io::bf16* dpx_f, io::bf16* dpx_b,
                                      io::bf16* dhn, float* dbp, int T, int N, int H,
                                      void* stream) {
    return stepwise::launch_chain(device, dy_f, dy_b, w_t, coef, dph, carry, dpx_f, dpx_b, dhn,
                                  dbp, T, N, H, stream);
}

// Batch rows per block of the per-step kernels.
int ocrs_gru_wide_stepwise_rows() { return stepwise::kBM; }

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
