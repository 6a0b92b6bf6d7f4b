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
// H > 256 would need a cluster of more than 8 blocks: the wrapper sends
// every width this kernel does not take (H > 256 or H % 8 != 0) to
// gru_wide.cu, whose persistent kernels run this design in clusters of up
// to 16 blocks (H <= 512 after padding), and whose per-step kernels take
// the widths above.
//
// bf16 (`compute_dtype=jnp.bfloat16`, the Pallas kernel's default) has a
// kernel of its own, `gru_fwd_bf16_kernel`, with the Pallas kernel's
// rounding points: px is read and ys written in bf16; each step's product
// is bf16(h) @ bf16(W_hh) with f32 sums (the wrapper rounds W_hh to bf16
// values, which this kernel packs into bf16 registers exactly); the gate
// math is f32 on the f32 state h. At T=201, N=128, H=256 the bytes (px 79
// MB, ys 26 MB: 32 us) bound it; the products take 20 us at the bf16
// tensor-core rate (989 TFLOP/s). What bounds it in fact is the chain of
// T steps, each a product, the gate math and an exchange between the
// blocks of a cluster. Same grid, clusters and step loop as above, but:
// - The products run on `mma.sync.m16n8k16` bf16 -> f32. Warp w of a
//   block owns the r, z and n n8 tiles of the units [8 (w % 4), +8) of
//   the block's 32 and the m16 tiles of its row group w / 4, over the whole
//   contraction (K = 256, zero-padded past H). So one warp's accumulators
//   hold each output's whole sum, and the r, z, n of a (row, unit) land in
//   one thread: the gate math runs on the accumulator fragments, with no
//   cross-warp reduction.
// - W_hh's slice stays in REGISTERS as bf16 B fragments: 16 k-steps x 3
//   gates x 2 = 96 registers a thread, loaded once.
// - The h buffers hold bf16, in tiles of 32 units (one per block) with a
//   row stride of 80 bytes, so that `ldmatrix` reads eight rows in eight
//   different bank groups; each thread keeps its elements' f32 state in
//   registers (the same thread owns an element at every step).
// - The exchange: each block writes its tile of the next h into its own
//   shared memory, and its first threads copy it whole into every peer
//   with `cp.async.bulk` (shared::cta -> shared::cluster), completing on
//   the peer's mbarrier; a block waits on its own mbarrier for the other
//   tiles. No cluster barrier in the step. Per-thread `st.shared::cluster`
//   stores of 16 bytes and a cluster barrier took 1.3 times as long at
//   T=201, N=128 (PERF.md).
// - R, the batch rows per block, is 16, 32, 48 or 64 (warps: 4 per 16
//   rows, and 8 warps of two m16 tiles each at 64), chosen per call by
//   gru_cluster.cuh's cost model with this kernel's measured step cost: 32
//   at N=128 and 48 at N=256, one round each (R=16 or 20 would need two).
//   Each block asks for more than half an SM's shared memory, so that two
//   never share an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
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

// The bf16 kernel's fixed cost of a step, in rows, for pick_rows: on an
// H100 a step took about 0.56 us + 0.045 us a row per block at T=201,
// N=128 (R = 16 in two rounds, 32, 48, 64; PERF.md).
constexpr int kBf16StepCost = 14;

size_t smem_bytes(int rows, int) {
    return sizeof(float) * ((size_t)2 * rows * kHS + (size_t)kWarps * rows * 3 * kBU);
}

// R batch rows per block (a multiple of 4, at most 32). Requires H % 8 == 0, H <= 256
// and a cluster of ceil(H / kBU) blocks along x, equal to gridDim.x.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const float* __restrict__ px_f, const float* __restrict__ px_b,
               const float* __restrict__ w_hh, const float* __restrict__ b_hh,
               float* __restrict__ ys_f, float* __restrict__ ys_b, int T, int N, int H) {
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
    const float* px = dir == 0 ? px_f : px_b;
    float* ys = dir == 0 ? ys_f : ys_b;
    const size_t px_step = (size_t)N * H3, ys_step = (size_t)N * H;

    // Gate-math elements of this thread: pairs e = tid + j * kThreads, row
    // e / 16, units 2 * (e % 16) and the next.
    float2 xg[kNE][3];
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
                const float2 hp = *reinterpret_cast<const float2*>(cur + er * HS + u);
                const float r0 = sigmoid(xg[j][0].x + (ph[0].x + bg[0].x));
                const float r1 = sigmoid(xg[j][0].y + (ph[0].y + bg[0].y));
                const float z0 = sigmoid(xg[j][1].x + (ph[1].x + bg[1].x));
                const float z1 = sigmoid(xg[j][1].y + (ph[1].y + bg[1].y));
                const float c0 = tanh_fast(xg[j][2].x + r0 * (ph[2].x + bg[2].x));
                const float c1 = tanh_fast(xg[j][2].y + r1 * (ph[2].y + bg[2].y));
                const float hn0 = (1.f - z0) * c0 + z0 * hp.x;
                const float hn1 = (1.f - z1) * c1 + z1 * hp.y;
                const float* dst = nxt + er * HS + u;
                for (uint32_t p = 0; p < n_peers; ++p) st_peer_f2(dst, p, hn0, hn1);
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

// ---------------------------------------------------------------------
// bf16: the products on the tensor cores (see the head of the file)

namespace bf {

constexpr int kTS = kBU + 8;                     // bf16 row stride of a unit tile
constexpr int kKSteps = kMaxCluster * kBU / 16;  // k16 steps over the widest H

// The gate inputs px[t] of one (row, unit pair) as three bf16 pairs.
__device__ __forceinline__ void load_px(uint32_t (&x)[3], const io::bf16* p, int H, bool ok) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
        x[g] = ok ? __ldg(reinterpret_cast<const unsigned int*>(p + g * H)) : 0u;
}

// 16 * MG * MT batch rows per block, 4 * MG warps: warp w owns units
// [8 (w % 4), +8) of the block's 32 and the MT m16 tiles of row group w / 4.
// Requires H % 8 == 0, H <= 256 and a cluster of ceil(H / kBU) blocks
// along x, equal to gridDim.x.
template <int MG, int MT>
__global__ void __launch_bounds__(128 * MG, 1)
gru_fwd_bf16_kernel(const io::bf16* __restrict__ px_f, const io::bf16* __restrict__ px_b,
                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                    io::bf16* __restrict__ ys_f, io::bf16* __restrict__ ys_b, int T, int N,
                    int H) {
    constexpr int R = 16 * MG * MT;
    constexpr int kTile = R * kTS;  // one block's 32 units of the tile's rows
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // [2][kMaxCluster][R][kTS]: bf16(h) by step parity, in tiles of 32 units
    io::bf16* hs = reinterpret_cast<io::bf16*>(smem_raw);
    uint64_t* bars = reinterpret_cast<uint64_t*>(hs + 2 * kMaxCluster * kTile);  // [2]

    const int dir = blockIdx.z;
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    const int u0 = (int)rank * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int ub = u0 + (warp % 4) * 8;   // the warp's 8 units
    const int m0 = (warp / 4) * MT * 16;  // the warp's first row of the tile
    const bool uok = ub < H;              // all 8 units exist, or none (H % 8 == 0)
    const int unit = ub + 2 * tig;        // this thread's C columns: unit, unit + 1

    // W_hh's B fragments of the warp's 3 n8 tiles (gate g, units ub..ub+7)
    // for all 16 k-steps; zero past H.
    uint32_t wf[kKSteps][3][2];
    {
        const float* W = w_hh + (size_t)dir * H * H3 + ub + gid;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int k = ks * 16 + 2 * tig + 8 * half;
                    wf[ks][g][half] =
                        uok && k < H ? pack_bf16(__ldg(W + (size_t)k * H3 + g * H),
                                                 __ldg(W + (size_t)(k + 1) * H3 + g * H))
                                     : 0u;
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
        for (int i = tid; i < 2 * kTile; i += 128 * MG) p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        fence_mbar_init();
    }

    const io::bf16* px = dir == 0 ? px_f : px_b;
    io::bf16* ys = dir == 0 ? ys_f : ys_b;
    const size_t px_step = (size_t)N * H3, ys_step = (size_t)N * H;

    // This thread's elements: rows m0 + 16 mt + gid + 8 half of the tile,
    // units unit and unit + 1; their gate inputs and f32 state.
    uint32_t xg[MT][2][3];
    float hf[MT][2][2];
    {
        const int t = dir == 0 ? 0 : T - 1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = n0 + m0 + mt * 16 + gid + 8 * half;
                load_px(xg[mt][half], px + t * px_step + (size_t)row * H3 + unit, H,
                        uok && row < N);
                hf[mt][half][0] = hf[mt][half][1] = 0.f;
            }
    }

    // Every block of the cluster has zeroed its buffers and set up its
    // mbarriers before any peer copies into them.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    // This lane's ldmatrix row in an A tile: row lane % 16, k (lane / 16) * 8.
    const uint32_t a_lane = smem_u32(hs) + 2u * ((m0 + lane % 16) * kTS + (lane / 16) * 8);
    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? step : T - 1 - step;
        const uint32_t cur = a_lane + 2u * (step & 1) * kMaxCluster * kTile;
        io::bf16* mine = hs + (((step + 1) & 1) * kMaxCluster + rank) * kTile;  // next h, this block's units

        float acc[MT][3][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
                for (int f = 0; f < 4; ++f) acc[mt][g][f] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
                ldmatrix_x4(a[mt], cur + 2u * ((ks / 2) * kTile + mt * 16 * kTS + (ks % 2) * 16));
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][g], a[mt], wf[ks][g][0], wf[ks][g][1]);
        }

        // Gate math on the fragments; then ys, and bf16(h) into this block's tile.
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const uint32_t* x = xg[mt][half];
                float hn[2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int f = 2 * half + j;
                    const float xr = j ? hi_bf16(x[0]) : lo_bf16(x[0]);
                    const float xz = j ? hi_bf16(x[1]) : lo_bf16(x[1]);
                    const float xn = j ? hi_bf16(x[2]) : lo_bf16(x[2]);
                    const float r = sigmoid(xr + (acc[mt][0][f] + bg[0][j]));
                    const float z = sigmoid(xz + (acc[mt][1][f] + bg[1][j]));
                    const float c = tanh_fast(xn + r * (acc[mt][2][f] + bg[2][j]));
                    const float h = (1.f - z) * c + z * hf[mt][half][j];
                    hn[j] = uok ? h : 0.f;
                    hf[mt][half][j] = hn[j];
                }
                const uint32_t hw = pack_bf16(hn[0], hn[1]);
                const int rl = m0 + mt * 16 + gid + 8 * half;
                if (uok && n0 + rl < N)
                    *reinterpret_cast<uint32_t*>(ys + t * ys_step + (size_t)(n0 + rl) * H + unit) = hw;
                *reinterpret_cast<uint32_t*>(mine + rl * kTS + (ub - u0) + 2 * tig) = hw;
            }
        if (step + 1 < T) {
            const int tn = dir == 0 ? step + 1 : T - 2 - step;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = n0 + m0 + mt * 16 + gid + 8 * half;
                    if (uok && row < N)
                        load_px(xg[mt][half], px + tn * px_step + (size_t)row * H3 + unit, H, true);
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

constexpr int kRows[] = {16, 32, 48, 64};

const void* kernel_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_fwd_bf16_kernel<1, 1>;
        case 32: return (const void*)gru_fwd_bf16_kernel<2, 1>;
        case 48: return (const void*)gru_fwd_bf16_kernel<3, 1>;
        default: return (const void*)gru_fwd_bf16_kernel<2, 2>;
    }
}

int threads(int rows) { return rows == 64 ? 256 : 128 * (rows / 16); }

size_t smem_bytes(int rows, int) {
    const size_t need = sizeof(io::bf16) * 2 * kMaxCluster * rows * kTS + 2 * sizeof(uint64_t);
    return need > kSoleBlockSmem ? need : kSoleBlockSmem;
}

}  // namespace bf

const void* kernel_for(int rows) {
    return rows == 16 ? (const void*)gru_fwd_kernel<16> : (const void*)gru_fwd_kernel<20>;
}

int threads_f32(int) { return kThreads; }

constexpr int kRowsF32[] = {16, 20};
int reported_f32[kMaxChoices * (kMaxCluster + 1)], reported_bf16[kMaxChoices * (kMaxCluster + 1)];
const Family kFamily = {kernel_for, smem_bytes, threads_f32, kRowsF32, 2, 14, kMaxCluster,
                        reported_f32};
const Family kFamilyBf16 = {bf::kernel_for, bf::smem_bytes, bf::threads, bf::kRows, 4,
                            kBf16StepCost, kMaxCluster, reported_bf16};

// `rows` > 0 forces that many batch rows per block (one of the family's
// choices); 0 lets pick_rows choose.
template <typename E>
int launch(const Family& family, int device, const E* px_f, const E* px_b, const float* w_hh,
           const float* b_hh, E* ys_f, E* ys_b, int T, int N, int H, int rows, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1) return (int)cudaErrorInvalidValue;
    int max_active = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = rows > 0 ? (offers(family, rows) ? cudaSuccess : cudaErrorInvalidValue)
                   : pick_rows(family, N, H, &rows, &max_active);
    if (err == cudaSuccess) err = configure(family, rows, N, H, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    cfg.stream = (cudaStream_t)stream;
    void* args[] = {&px_f, &px_b, &w_hh, &b_hh, &ys_f, &ys_b, &T, &N, &H};
    err = cudaLaunchKernelExC(&cfg, family.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

int max_clusters(const Family& family, int device, int N, int H, int* rows_out) {
    const RestoreDevice restore_device;
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
    return launch(kFamily, device, px_f, px_b, w_hh, b_hh, ys_f, ys_b, T, N, H, 0, stream);
}

// The same with px and ys bf16 (w_hh float32 holding bf16 values, b_hh
// float32).
int ocrs_gru_fwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                      const float* w_hh, const float* b_hh, io::bf16* ys_f, io::bf16* ys_b,
                      int T, int N, int H, void* stream) {
    return launch(kFamilyBf16, device, px_f, px_b, w_hh, b_hh, ys_f, ys_b, T, N, H, 0, stream);
}

// ocrs_gru_fwd_bf16 with `rows` batch rows per block (16, 32, 48 or 64)
// instead of the one it picks: for measuring the row choices.
int ocrs_gru_fwd_bf16_rows(int device, const io::bf16* px_f, const io::bf16* px_b,
                           const float* w_hh, const float* b_hh, io::bf16* ys_f,
                           io::bf16* ys_b, int T, int N, int H, int rows, void* stream) {
    if (rows < 1) return (int)cudaErrorInvalidValue;
    return launch(kFamilyBf16, device, px_f, px_b, w_hh, b_hh, ys_f, ys_b, T, N, H, rows,
                  stream);
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
