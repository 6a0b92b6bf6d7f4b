// Bidirectional GRU recurrence of one layer, backward, in float32 or
// bfloat16.
//
// Replaces: the backward of the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py (`_bwd_call`, body
// `_bwd_kernel`). Same math: both directions' reverse scans (the forward
// direction walks time backwards, the backward direction forwards); at
// each step h_prev in scan order (ys_f[t-1] or ys_b[t+1], zero at each
// direction's first step), ph = h_prev @ W_hh + b_hh and the gates are
// recomputed, and
//   dht = dh + dy[t];  dc = dht (1 - z);  da_c = dc (1 - c^2);
//   da_z = dht (h_prev - c) z (1 - z);  dhn = da_c r;
//   da_r = da_c hn r (1 - r);
//   dpx[t] = [da_r, da_z, da_c];  dph = [da_r, da_z, dhn];
//   dh <- dht z + dph @ W_hh^T;  dW_hh += h_prev^T dph;  db_hh += sum dph.
// Contract: px_f, px_b [T, N, 3H] (x @ W_ih + b_ih, natural time order),
// ys_f, ys_b [T, N, H] the forward's outputs, dy_f, dy_b [T, N, H] their
// cotangents; w_hh [2, H, 3H] (for h @ W), b_hh [2, 3H]; out dpx_f, dpx_b
// [T, N, 3H], dw [2, H, 3H], db [2, 3H]. Gate order r, z, n.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At T=257, N=128, H=256, per step and direction the
// function multiplies [N,H] x [H,3H] (the recomputed ph) and [N,3H] x
// [3H,H] (dh), and dW_hh is [H, T*N] x [T*N, 3H]: 3 * 2*128*256*768 FLOP
// * 257 steps * 2 directions = 77.6 GFLOP, 1.16 ms at the f32 rate. The
// bytes are px, ys, dy read once and dpx written once: 2 * (101 + 33.7 +
// 33.7 + 101) MB = 539 MB, 0.16 ms. Operations bound it. Only one of the
// three products is a chain of T dependent steps: ph reads the saved ys
// and dW reads finished gradients, so both run over all T*N rows at once.
//
// Design: four launches, whatever T is.
// (a) `coef`, parallel over all T*N rows: ph = h_prev @ W_hh + b_hh as a
//     tiled product (128 rows x 32 units x 3 gates per block, 16-deep k
//     stages double-buffered through registers, `mma.sync` m16n8k8 tiles
//     with the error-compensated TF32 product described below), the
//     gates in its epilogue, and per element the five numbers the chain
//     needs: z, (1-z)(1-c^2), (h_prev-c) z (1-z), r, hn r (1-r), into
//     coef [2, T*N, 5, H].
// (b) `chain`, ONE launch for all T steps, the forward kernel's layout: a
//     block owns 32 hidden units x R batch rows of one direction, the
//     blocks of one (batch tile, direction) form a thread block cluster of
//     ceil(H/32) blocks, and the loop over steps is inside the kernel. Per
//     step a thread turns dht into da_r, da_z, da_c, dhn for its elements
//     (dht z stays in its registers), writes dpx[t] and the block's dph
//     slice [R, 96] to shared memory. dph @ W_hh^T is split over the
//     contraction: a block multiplies its OWN 96 columns of dph with its
//     96 x H slice of W_hh^T, which gives a partial sum for all H units.
//     That slice stays in REGISTERS: each of the block's 512 threads
//     owns two units and 24 of the block's 96 columns, W_hh[2][24], 48
//     registers, loaded once; per step it reads the dph slice as float4
//     broadcasts (every lane of a warp the same address) with 8 FMAs per
//     load, and the four column groups are added through shared memory in
//     a fixed order. The thread that adds them holds the partial for a
//     unit of block w and writes it into block w's shared memory
//     (distributed shared memory, buffers by step parity), then one
//     cluster barrier per step, split into arrive and wait around the
//     prefetch of the next step's coefficients and dy. After the barrier a
//     block sums the partials of its units in block order. Exchanging
//     partial sums moves [R, 32] per pair of blocks and step, a third of
//     what exchanging dph itself would. R is 16 or 20, chosen per call
//     from the batch size and the clusters the card holds at once
//     (gru_cluster.cuh).
// (c) `dw`: h_prev^T dph over all T*N rows, 128 x 96 output tiles (the
//     same `mma.sync` tiles as `coef`), the rows split into up to 8 ranges
//     so that every SM works; a block writes
//     its partial tile, and the blocks of the first row tile also the
//     column sums for db. dph is read as dpx, with its n columns times r
//     from coef, so the chain does not store dph.
// (d) `dw_sum` adds the partials in range order.
// Every sum runs in a fixed order and there are no atomics, so repeated
// runs agree bit for bit. The two products outside the chain run on the
// tensor cores as error-compensated TF32 ("3xTF32": hi/lo split of both
// operands, three `mma` per tile, f32 accumulation), which keeps f32
// accuracy (plain TF32 does not meet the tolerances against the plain
// version) at about 1.5 times the speed of an f32 FMA loop with the same
// tiles (measured on an H100 80GB HBM3). The chain's
// product stays on the f32 FMA pipes: its 16 or 20 rows do not fill the
// 16-row tiles of `mma` at the cluster sizes that fit the card. The chain
// takes H % 8 == 0 up to 256 (a cluster of at most 8 blocks); for every
// other width the wrapper runs gru_wide.cu's chain between this file's
// (a), (c) and (d), which take any H % 8 == 0 (`ocrs_gru_bwd_coef`,
// `ocrs_gru_bwd_dw` and their bf16 entries): its persistent chain, this
// design in clusters of up to 16 blocks, up to H = 512 after padding, and
// its chain of one launch a step above.
//
// bf16 (`compute_dtype=jnp.bfloat16`) has kernels of its own, in namespace
// `bf`, with every product on the tensor cores (`mma.sync.m16n8k16` bf16,
// f32 accumulation). px, ys, dy are read and dpx written in bf16; coef, dW
// and db stay f32. The rounding points are the Pallas kernel's: h_prev is
// the bf16 ys (so `coef` recomputes the gates from the rounded state, as
// the Pallas kernel does); the chain's product takes bf16(dph) and the
// wrapper's bf16-rounded W_hh; dW sums h_prev^T bf16(dph) and db the
// UNROUNDED dph, both in f32. A product of two bf16 values is exact in f32,
// so the bf16 `mma` changes only the order of the f32 sums. At T=257,
// N=128, H=256 the bytes the function must move are px, ys, dy and dpx in
// bf16: 269.6 MB, 80 us, which bound it; the products take 78 us at the
// bf16 tensor-core rate (989 TFLOP/s).
// (a) `coef`: the f32 phase's tiles and epilogue, with h_prev and W_hh
//     staged in shared memory as bf16 (k stages of 32) and read with
//     `ldmatrix` (W_hh transposed), two blocks an SM.
// (b) `chain`: the f32 phase's cluster and step loop. Its product, the
//     block's bf16(dph) slice [R, 96] times W_hh^T [96, H], runs on the
//     tensor cores: warp w makes the partial dh of block w's 32 units (4
//     n8 tiles, 6 k-steps, W_hh^T as 48 registers of B fragments), stages
//     it in shared memory and one thread copies it whole into block w's
//     receive buffer with `cp.async.bulk`, completing on block w's
//     mbarrier (no cluster barrier in the step); a block adds the partials
//     of its units in block order. The chain also sums db from the
//     unrounded dph in f32 in its own registers (a thread owns the same
//     elements at every step), then over its rows in order into one
//     partial per batch tile, and hands `dw` only bf16(dhn) [2, T*N, H]:
//     bf16(dph) = [bf16(da_r), bf16(da_z), bf16(dhn)], and the first two
//     are dpx's first 2H columns. The next step's coefficients and dy are
//     loaded while the copies run. R is 16, 32 or 48.
// (c) `dw`: h_prev^T bf16(dph) from ys, dpx and dhn in bf16, 128 x 96
//     output tiles, both operands read with `ldmatrix.trans` (the
//     contraction runs along the stages' rows).
// (d) `dw_sum` adds dW's partials in range order and db's in tile order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "bf16_io.cuh"
#include "gru_cluster.cuh"

namespace {

using namespace gru_cluster;

constexpr int kThreads = 256;
constexpr int kNC = 5;                 // coefficients per element
// The bf16 chain's fixed cost of a step, in rows, for pick_rows: on an
// H100 a chain step took about 0.7 us + 0.087 us a row per block at T=257,
// N=128 (R = 16 in two rounds, 32, 48; PERF.md).
constexpr int kBf16StepCost = 8;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

using io::ldg2;
using io::ldg4;

// Error-compensated TF32 products on the tensor cores ("3xTF32"): x is
// split into hi, its upper 19 bits, and lo = x - hi (exact), of which the
// tensor core in turn reads the upper 19 bits; a * b is taken as a_lo b_hi
// + a_hi b_lo + a_hi b_hi with f32 accumulation. What is dropped is below
// 2^-20 of the product. The split is a mask and a subtraction: `cvt` to
// tf32 rounds better but runs at a quarter of the rate and then bounds
// the kernel.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], one warp. With gid = lane / 4 and tig =
// lane % 4 a thread holds a: (gid, tig), (gid+8, tig), (gid, tig+4),
// (gid+8, tig+4); b: (tig, gid), (tig+4, gid); c: (gid, 2 tig), (gid, 2 tig
// + 1), (gid+8, 2 tig), (gid+8, 2 tig + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
    mma_tf32(c, a_lo, b_hi);
    mma_tf32(c, a_hi, b_lo);
    mma_tf32(c, a_hi, b_hi);
}

// ---------------------------------------------------------------------
// (a) coefficients

constexpr int kGM = 128;               // rows (t, n) per block
constexpr int kGK = 16;                // k per stage
constexpr int kGAS = kGK + 4;          // row stride of the A stage
constexpr int kGBS = 3 * kBU + 8;      // row stride of the B stage

struct CoefStage {
    float4 a[2];
    float4 b[2];
};

// Global loads of one k stage: 128 x 16 of h_prev and 16 x 96 of W_hh.
__device__ __forceinline__ void coef_load(CoefStage& s, const float* __restrict__ ys,
                                          const float* __restrict__ W, int k0, int m0, int u0,
                                          long long shift, int M, int H, int tid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int H3 = 3 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kGK / 4), k = k0 + 4 * (idx % (kGK / 4));
        const long long src = (long long)(m0 + r) + shift;  // row of h_prev in ys
        s.a[i] = (m0 + r < M && src >= 0 && src < M && k < H) ? ldg4(ys + src * H + k) : zero;
        if (idx < kGK * 3 * (kBU / 4)) {
            const int kb = k0 + idx / (3 * (kBU / 4));
            const int g = (idx / (kBU / 4)) % 3;
            const int u = u0 + 4 * (idx % (kBU / 4));
            s.b[i] = (kb < H && u < H) ? ldg4(W + (size_t)kb * H3 + g * H + u) : zero;
        }
    }
}

__device__ __forceinline__ void coef_store(const CoefStage& s, float (*As)[kGAS],
                                           float (*Bs)[kGBS], int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<float4*>(&As[idx / (kGK / 4)][4 * (idx % (kGK / 4))]) = s.a[i];
        if (idx < kGK * 3 * (kBU / 4))
            *reinterpret_cast<float4*>(&Bs[idx / (3 * (kBU / 4))][4 * (idx % (3 * (kBU / 4)))]) =
                s.b[i];
    }
}

// coef[dir][m][q][u], m = t * N + n, q: 0 z, 1 (1-z)(1-c^2), 2 (h_prev-c) z (1-z),
// 3 r, 4 hn r (1-r). Requires H % 8 == 0.
__global__ void __launch_bounds__(kThreads)
gru_bwd_coef_kernel(const float* __restrict__ px_f, const float* __restrict__ px_b,
                    const float* __restrict__ ys_f, const float* __restrict__ ys_b,
                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                    float* __restrict__ coef, int T, int N, int H) {
    // Strides 20 and 104: the fragment loads below hit 32 different banks.
    __shared__ __align__(16) float As[2][kGM][kGAS];
    __shared__ __align__(16) float Bs[2][kGK][kGBS];

    const int dir = blockIdx.z;
    const int u0 = blockIdx.x * kBU;
    const int m0 = blockIdx.y * kGM;
    const int M = T * N;
    const int H3 = 3 * H;
    const int tid = threadIdx.x;
    // Warp tile: 32 rows x (16 units x 3 gates), as 2 x 6 mma tiles, so a
    // thread ends up with all three gates of its elements.
    const int warp = tid / 32, gid = (tid % 32) / 4, tig = tid % 4;
    const int wm = warp % 4, wn = warp / 4;
    const float* ys = dir == 0 ? ys_f : ys_b;
    const long long shift = dir == 0 ? -(long long)N : (long long)N;
    const float* W = w_hh + (size_t)dir * H * H3;

    float acc[2][6][4];                // [row tile][gate * 2 + unit tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;

    CoefStage st;
    coef_load(st, ys, W, 0, m0, u0, shift, M, H, tid);
    coef_store(st, As[0], Bs[0], tid);
    __syncthreads();
    const int n_stages = (H + kGK - 1) / kGK;
    for (int s = 0; s < n_stages; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_stages) coef_load(st, ys, W, (s + 1) * kGK, m0, u0, shift, M, H, tid);
#pragma unroll
        for (int k8 = 0; k8 < kGK; k8 += 8) {
            uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int r = wm * 32 + mt * 16 + gid;
                split_tf32(As[buf][r][k8 + tig], a_hi[mt][0], a_lo[mt][0]);
                split_tf32(As[buf][r + 8][k8 + tig], a_hi[mt][1], a_lo[mt][1]);
                split_tf32(As[buf][r][k8 + tig + 4], a_hi[mt][2], a_lo[mt][2]);
                split_tf32(As[buf][r + 8][k8 + tig + 4], a_hi[mt][3], a_lo[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 6; ++nt) {
                const int col = (nt / 2) * kBU + wn * 16 + (nt % 2) * 8 + gid;
                uint32_t b_hi[2], b_lo[2];
                split_tf32(Bs[buf][k8 + tig][col], b_hi[0], b_lo[0]);
                split_tf32(Bs[buf][k8 + tig + 4][col], b_hi[1], b_lo[1]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
            }
        }
        if (s + 1 < n_stages) coef_store(st, As[buf ^ 1], Bs[buf ^ 1], tid);
        __syncthreads();
    }

    // Epilogue: fragment (f / 2, f % 2) of tile (mt, ut) is row wm*32 + mt*16
    // + gid + 8 * (f / 2), unit wn*16 + ut*8 + 2*tig + f % 2.
    const float* px = dir == 0 ? px_f : px_b;
#pragma unroll
    for (int ut = 0; ut < 2; ++ut) {
        const int u = u0 + wn * 16 + ut * 8 + 2 * tig;
        if (u >= H) continue;
        const float* b = b_hh + dir * H3 + u;
        const float2 br = ldg2(b), bz = ldg2(b + H), bn = ldg2(b + 2 * H);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = m0 + wm * 32 + mt * 16 + gid + 8 * half;
                if (m >= M) continue;
                const long long src = (long long)m + shift;
                const float* p = px + (size_t)m * H3 + u;
                const float2 xr = ldg2(p), xz = ldg2(p + H), xn = ldg2(p + 2 * H);
                const float2 hp =
                    (src >= 0 && src < M) ? ldg2(ys + src * H + u) : make_float2(0.f, 0.f);
                float out[kNC][2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int f = 2 * half + j;
                    const float hr = acc[mt][0 + ut][f] + (j ? br.y : br.x);
                    const float hz = acc[mt][2 + ut][f] + (j ? bz.y : bz.x);
                    const float hn = acc[mt][4 + ut][f] + (j ? bn.y : bn.x);
                    const float r = sigmoid((j ? xr.y : xr.x) + hr);
                    const float z = sigmoid((j ? xz.y : xz.x) + hz);
                    const float c = tanhf((j ? xn.y : xn.x) + r * hn);
                    const float h_prev = j ? hp.y : hp.x;
                    out[0][j] = z;
                    out[1][j] = (1.f - z) * (1.f - c * c);
                    out[2][j] = (h_prev - c) * z * (1.f - z);
                    out[3][j] = r;
                    out[4][j] = hn * r * (1.f - r);
                }
                float* o = coef + (((size_t)dir * M + m) * kNC) * H + u;
#pragma unroll
                for (int q = 0; q < kNC; ++q)
                    *reinterpret_cast<float2*>(o + (size_t)q * H) =
                        make_float2(out[q][0], out[q][1]);
            }
        }
    }
}

// ---------------------------------------------------------------------
// (b) the chain

constexpr int kDS = 3 * kBU + 4;       // row stride of the dph slice

constexpr int kChainThreads = 512;
constexpr int kJQ = 4;                 // the block's 96 dph columns split over warp groups
constexpr int kJW = 3 * kBU / kJQ;     // dph columns per thread
constexpr int kUnits = kMaxCluster * kBU;  // widest H

size_t chain_smem(int rows, int n_tiles) {
    return sizeof(float) * ((size_t)2 * n_tiles * rows * kBU + (size_t)rows * kDS +
                            (size_t)kJQ * rows * kUnits);
}

// R batch rows per block (a multiple of 4, at most 32). Requires H % 8 ==
// 0 and a cluster of ceil(H / kBU) <= 8 blocks along x, equal to gridDim.x.
template <int R>
__global__ void __launch_bounds__(kChainThreads, 1)
gru_bwd_chain_kernel(const float* __restrict__ dy_f, const float* __restrict__ dy_b,
                     const float* __restrict__ w_hh, const float* __restrict__ coef,
                     float* __restrict__ dpx_f, float* __restrict__ dpx_b, int T, int N, int H) {
    constexpr int kThreads = kChainThreads;
    constexpr int kPairs = R * (kBU / 2);  // elements come in pairs of units
    constexpr int kNE = (kPairs + kThreads - 1) / kThreads;
    static_assert(R % 4 == 0 && 2 * kUnits == kThreads && kJQ * 2 * 64 == kThreads,
                  "tile sizes");
    extern __shared__ __align__(16) float smem[];
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    float* recv = smem;                      // [2][n_peers][R][kBU]: partial dh, by parity
    float* ds = recv + 2 * n_peers * R * kBU;  // [R][kDS]: this block's dph slice
    float* part = ds + R * kDS;              // [kJQ][R][kUnits]: products per column group

    const int dir = blockIdx.z;
    const int u0 = (int)rank * kBU;
    const int n0 = blockIdx.y * R;
    const int H3 = 3 * H;
    const int M = T * N;
    const int tid = threadIdx.x;
    // Product tile of this thread: the block's dph columns [24 jq, 24 jq +
    // 24) times W_hh^T for the units `unit0` and `unit0 + 32`; a warp shares
    // jq, so its reads of dph are broadcasts.
    const int warp = tid / 32, lane = tid % 32;
    const int jq = warp / 4;
    const int unit0 = (warp % 4) * 64 + lane;

    // This thread's W_hh entries, for all steps: rows unit0 and unit0 + 32,
    // its 24 of the block's 96 columns.
    float w[2][kJW];
    {
        const float* W = w_hh + (size_t)dir * H * H3 + u0;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int x = 0; x < kJW; ++x) {
                const int unit = unit0 + 32 * c;
                const int g = (jq * kJW + x) / kBU, ul = (jq * kJW + x) % kBU;
                w[c][x] = (unit < H && u0 + ul < H) ? __ldg(W + (size_t)unit * H3 + g * H + ul)
                                                    : 0.f;
            }
    }

    const float* dy = dir == 0 ? dy_f : dy_b;
    float* dpx = dir == 0 ? dpx_f : dpx_b;
    const float* cf = coef + (size_t)dir * M * kNC * H;

    // Elements of this thread: pairs e = tid + j * kThreads, row e / 16,
    // units 2 * (e % 16) and the next. Coefficients and dy of the first
    // step; zero where the tile hangs over N or H, so that those elements
    // give zero gradients and zero partial sums.
    const float2 zero2 = make_float2(0.f, 0.f);
    float2 c[kNE][kNC], dyv[kNE], dhz[kNE];  // dhz: dht * z of the previous step
    {
        const int t = dir == 0 ? T - 1 : 0;
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
            const bool ok = e < kPairs && row < N && u < H;
            const size_t m = (size_t)t * N + row;
#pragma unroll
            for (int q = 0; q < kNC; ++q) c[j][q] = ok ? ldg2(cf + (m * kNC + q) * H + u) : zero2;
            dyv[j] = ok ? ldg2(dy + m * H + u) : zero2;
            dhz[j] = zero2;
        }
    }

    // No block of the cluster writes into a peer before that peer runs.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? T - 1 - step : step;
        const int par = step & 1;
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
                const float* src = recv + (((par ^ 1) * n_peers) * R + er) * kBU + eu;
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
            if (!last) {  // the last step's dh is not needed
                float* d = ds + er * kDS + eu;
                io::st2(d, da_r0, da_r1);
                io::st2(d + kBU, da_z0, da_z1);
                io::st2(d + 2 * kBU, dhn0, dhn1);
            }
        }

        if (!last) {
            __syncthreads();
            // Two chunks of R / 2 rows, so that the accumulators and the 48
            // registers of W_hh fit 128 registers a thread.
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
                constexpr int kRC = R / 2;
                const float* drow = ds + ch * kRC * kDS + jq * kJW;
                float acc[kRC][2];
#pragma unroll
                for (int r = 0; r < kRC; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
                for (int r = 0; r < kRC; r += 2) {
#pragma unroll
                    for (int j = 0; j < kJW; j += 4) {
                        float4 dv[2];
#pragma unroll
                        for (int i = 0; i < 2; ++i)
                            dv[i] = *reinterpret_cast<const float4*>(drow + (r + i) * kDS + j);
#pragma unroll
                        for (int i = 0; i < 2; ++i)
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                float a = acc[r + i][c];
                                a = fmaf(dv[i].x, w[c][j], a);
                                a = fmaf(dv[i].y, w[c][j + 1], a);
                                a = fmaf(dv[i].z, w[c][j + 2], a);
                                a = fmaf(dv[i].w, w[c][j + 3], a);
                                acc[r + i][c] = a;
                            }
                    }
                }
#pragma unroll
                for (int r = 0; r < kRC; ++r)
#pragma unroll
                    for (int c = 0; c < 2; ++c)
                        part[(jq * R + ch * kRC + r) * kUnits + unit0 + 32 * c] = acc[r][c];
            }
            __syncthreads();
            // Add the column groups in a fixed order; a warp holds 32 units
            // of one row, all of one peer, and hands them over.
#pragma unroll
            for (int i = 0; i < R * kUnits / kThreads; ++i) {
                const int o = tid + i * kThreads;
                const int r = o / kUnits, unit = o % kUnits;
                const uint32_t peer = unit / kBU;
                if (peer < n_peers) {
                    float v = part[o];
#pragma unroll
                    for (int q = 1; q < kJQ; ++q) v += part[q * R * kUnits + o];
                    st_peer_f1(recv + ((par * n_peers + rank) * R + r) * kBU + lane, peer, v);
                }
            }
        }
        cluster_arrive();
        if (!last) {
            const int tn = dir == 0 ? T - 2 - step : step + 1;
#pragma unroll
            for (int j = 0; j < kNE; ++j) {
                const int e = tid + j * kThreads;
                const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
                if (e < kPairs && row < N && u < H) {
                    const size_t m = (size_t)tn * N + row;
#pragma unroll
                    for (int q = 0; q < kNC; ++q) c[j][q] = ldg2(cf + (m * kNC + q) * H + u);
                    dyv[j] = ldg2(dy + m * H + u);
                }
            }
        }
        cluster_wait();
    }
}

// ---------------------------------------------------------------------
// (c) dW and db partials, (d) their sum

constexpr int kDK = 128;               // rows of dW (k) per block
constexpr int kDR = 16;                // (t, n) rows per stage
constexpr int kDAS = kDK + 8;          // row stride of the h_prev stage
constexpr int kDDS = 3 * kBU + 8;      // row stride of the dph stage

struct DwStage {
    float4 a[2];
    float4 d[2];
};

// dph rows, read as dpx with its n columns times r.
__device__ __forceinline__ void dw_load(DwStage& s, const float* __restrict__ ys,
                                        const float* __restrict__ dsrc,
                                        const float* __restrict__ cr, int r0, int r_end, int k0,
                                        int u0, long long shift, int M, int H, int tid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int H3 = 3 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        {
            const int m = r0 + idx / (kDK / 4), k = k0 + 4 * (idx % (kDK / 4));
            const long long src = (long long)m + shift;
            s.a[i] = (m < r_end && src >= 0 && src < M && k < H) ? ldg4(ys + src * H + k) : zero;
        }
        if (idx < kDR * 3 * (kBU / 4)) {
            const int m = r0 + idx / (3 * (kBU / 4));
            const int g = (idx / (kBU / 4)) % 3;
            const int u = u0 + 4 * (idx % (kBU / 4));
            float4 v = zero;
            if (m < r_end && u < H) {
                v = ldg4(dsrc + (size_t)m * H3 + g * H + u);
                if (g == 2) {  // dph's n columns are da_c * r
                    const float4 r = ldg4(cr + (size_t)m * kNC * H + u);
                    v = make_float4(v.x * r.x, v.y * r.y, v.z * r.z, v.w * r.w);
                }
            }
            s.d[i] = v;
        }
    }
}

__device__ __forceinline__ void dw_store(const DwStage& s, float (*As)[kDAS],
                                         float (*Ds)[kDDS], int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<float4*>(&As[idx / (kDK / 4)][4 * (idx % (kDK / 4))]) = s.a[i];
        if (idx < kDR * 3 * (kBU / 4))
            *reinterpret_cast<float4*>(&Ds[idx / (3 * (kBU / 4))][4 * (idx % (3 * (kBU / 4)))]) =
                s.d[i];
    }
}

// dwp[split][dir][k][j] = sum over the split's rows m of h_prev[m][k] * dph[m][j];
// dbp[split][dir][j] = sum of dph[m][j]. blockIdx.z = split * 2 + dir.
// dsrc_f, dsrc_b: dpx per direction.
__global__ void __launch_bounds__(kThreads)
gru_bwd_dw_kernel(const float* __restrict__ ys_f, const float* __restrict__ ys_b,
                  const float* __restrict__ dsrc_f, const float* __restrict__ dsrc_b,
                  const float* __restrict__ coef, float* __restrict__ dwp,
                  float* __restrict__ dbp, int rows_per_split, int T, int N, int H) {
    // Strides 136 and 104: the fragment loads below hit 32 different banks.
    __shared__ __align__(16) float As[2][kDR][kDAS];
    __shared__ __align__(16) float Ds[2][kDR][kDDS];

    const int dir = blockIdx.z % 2;
    const int split = blockIdx.z / 2;
    const int u0 = blockIdx.x * kBU;
    const int k0 = blockIdx.y * kDK;
    const int M = T * N;
    const int H3 = 3 * H;
    const int tid = threadIdx.x;
    // Warp tile: 32 rows of dW (k) x 48 of the block's 96 columns, as 2 x 6
    // mma tiles; the contraction runs over the stage's 16 (t, n) rows.
    const int warp = tid / 32, gid = (tid % 32) / 4, tig = tid % 4;
    const int wk = warp % 4, wj = warp / 4;
    const float* ys = dir == 0 ? ys_f : ys_b;
    const float* dsrc = dir == 0 ? dsrc_f : dsrc_b;
    const float* cr = coef + ((size_t)dir * M * kNC + 3) * H;  // r of row 0
    const long long shift = dir == 0 ? -(long long)N : (long long)N;
    const int r_beg = split * rows_per_split;
    const int r_end = min(M, r_beg + rows_per_split);
    const bool with_db = blockIdx.y == 0 && tid < 3 * kBU;

    float acc[2][6][4];                // [k tile][column tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;
    float dbacc = 0.f;

    DwStage st;
    dw_load(st, ys, dsrc, cr, r_beg, r_end, k0, u0, shift, M, H, tid);
    dw_store(st, As[0], Ds[0], tid);
    __syncthreads();
    int buf = 0;
    for (int r0 = r_beg; r0 < r_end; r0 += kDR, buf ^= 1) {
        const bool more = r0 + kDR < r_end;
        if (more) dw_load(st, ys, dsrc, cr, r0 + kDR, r_end, k0, u0, shift, M, H, tid);
#pragma unroll
        for (int m8 = 0; m8 < kDR; m8 += 8) {
            uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int k = wk * 32 + mt * 16 + gid;
                split_tf32(As[buf][m8 + tig][k], a_hi[mt][0], a_lo[mt][0]);
                split_tf32(As[buf][m8 + tig][k + 8], a_hi[mt][1], a_lo[mt][1]);
                split_tf32(As[buf][m8 + tig + 4][k], a_hi[mt][2], a_lo[mt][2]);
                split_tf32(As[buf][m8 + tig + 4][k + 8], a_hi[mt][3], a_lo[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 6; ++nt) {
                const int col = wj * 48 + nt * 8 + gid;
                uint32_t b_hi[2], b_lo[2];
                const float d0 = Ds[buf][m8 + tig][col], d1 = Ds[buf][m8 + tig + 4][col];
                split_tf32(d0, b_hi[0], b_lo[0]);
                split_tf32(d1, b_hi[1], b_lo[1]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
            }
        }
        if (with_db) {
#pragma unroll
            for (int mm = 0; mm < kDR; ++mm) dbacc += Ds[buf][mm][tid];
        }
        if (more) dw_store(st, As[buf ^ 1], Ds[buf ^ 1], tid);
        __syncthreads();
    }

    // Fragment (f / 2, f % 2) of tile (mt, nt) is row k0 + wk*32 + mt*16 + gid
    // + 8 * (f / 2) of dW, column wj*48 + nt*8 + 2*tig + f % 2 of the block's 96.
    float* out = dwp + (size_t)blockIdx.z * H * H3;
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
        const int jl = wj * 48 + nt * 8 + 2 * tig;
        const int g = jl / kBU, u = u0 + jl % kBU;
        if (u >= H) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int k = k0 + wk * 32 + mt * 16 + gid + 8 * half;
                if (k < H)
                    *reinterpret_cast<float2*>(out + (size_t)k * H3 + g * H + u) =
                        make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
            }
    }
    if (with_db && u0 + tid % kBU < H)
        dbp[(size_t)blockIdx.z * H3 + (tid / kBU) * H + u0 + tid % kBU] = dbacc;
}

// dw[i] = sum over splits of dwp[split][i], in split order; db[j] = sum
// over parts of dbp[part][j], in part order (f32: the dW splits; bf16: the
// chain's batch tiles).
__global__ void __launch_bounds__(kThreads)
gru_bwd_dw_sum_kernel(const float* __restrict__ dwp, const float* __restrict__ dbp,
                      float* __restrict__ dw, float* __restrict__ db, int splits, int db_parts,
                      int n_dw, int n_db) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < n_dw) {
        float s = dwp[i];
        for (int p = 1; p < splits; ++p) s += dwp[(size_t)p * n_dw + i];
        dw[i] = s;
    } else if (i < n_dw + n_db) {
        const int j = i - n_dw;
        float s = dbp[j];
        for (int p = 1; p < db_parts; ++p) s += dbp[(size_t)p * n_db + j];
        db[j] = s;
    }
}

// ---------------------------------------------------------------------
// bf16: every product on the tensor cores (see the head of the file)

namespace bf {

// bf16 copies of the f32 tiles below are read with `ldmatrix`; the row
// strides (80, 208 and 272 bytes) put the eight rows of an 8x8 matrix in
// eight different 16-byte bank groups.

// (a) coefficients
constexpr int kCK = 32;                // k per stage (two k16 steps)
constexpr int kCAS = kCK + 8;          // bf16 row stride of the h_prev stage
constexpr int kCBS = 3 * kBU + 8;      // bf16 row stride of the W_hh stage

struct CoefStage {
    uint4 a[2];                        // 8 bf16 of h_prev each
    float4 b[3];                       // 4 f32 (bf16 values) of W_hh each
};

// Global loads of one k stage: 128 x 32 of h_prev and 32 x 96 of W_hh.
__device__ __forceinline__ void coef_load(CoefStage& s, const io::bf16* __restrict__ ys,
                                          const float* __restrict__ W, int k0, int m0, int u0,
                                          long long shift, int M, int H, int tid) {
    const int H3 = 3 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kCK / 8), k = k0 + 8 * (idx % (kCK / 8));
        const long long src = (long long)(m0 + r) + shift;  // row of h_prev in ys
        s.a[i] = (m0 + r < M && src >= 0 && src < M && k < H)
                     ? __ldg(reinterpret_cast<const uint4*>(ys + src * H + k))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int idx = tid + i * kThreads;
        const int kb = k0 + idx / (3 * kBU / 4), c = idx % (3 * kBU / 4);
        const int g = c / (kBU / 4), u = u0 + 4 * (c % (kBU / 4));
        s.b[i] = (kb < H && u < H) ? ldg4(W + (size_t)kb * H3 + g * H + u)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ void coef_store(const CoefStage& s, io::bf16 (*As)[kCAS],
                                           io::bf16 (*Bs)[kCBS], int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(&As[idx / (kCK / 8)][8 * (idx % (kCK / 8))]) = s.a[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int idx = tid + i * kThreads;
        const int c = idx % (3 * kBU / 4);
        *reinterpret_cast<uint2*>(&Bs[idx / (3 * kBU / 4)][4 * c]) =
            make_uint2(pack_bf16(s.b[i].x, s.b[i].y), pack_bf16(s.b[i].z, s.b[i].w));
    }
}

// The f32 kernel's coef from bf16 px and ys: 128 rows x 32 units x 3 gates
// per block, warp tiles of 32 rows x (16 units x 3 gates), m16n8k16 bf16.
// Two blocks an SM (at most 128 registers a thread): one block leaves its
// loads' latency bare.
__global__ void __launch_bounds__(kThreads, 2)
gru_bwd_coef_bf16_kernel(const io::bf16* __restrict__ px_f, const io::bf16* __restrict__ px_b,
                         const io::bf16* __restrict__ ys_f, const io::bf16* __restrict__ ys_b,
                         const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                         float* __restrict__ coef, int T, int N, int H) {
    __shared__ __align__(16) io::bf16 As[2][kGM][kCAS];
    __shared__ __align__(16) io::bf16 Bs[2][kCK][kCBS];

    const int dir = blockIdx.z;
    const int u0 = blockIdx.x * kBU;
    const int m0 = blockIdx.y * kGM;
    const int M = T * N;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, lane = tid % 32;
    const int warp = tid / 32, gid = lane / 4, tig = lane % 4;
    const int wm = warp % 4, wn = warp / 4;
    const io::bf16* ys = dir == 0 ? ys_f : ys_b;
    const long long shift = dir == 0 ? -(long long)N : (long long)N;
    const float* W = w_hh + (size_t)dir * H * H3;

    float acc[2][6][4];                // [row tile][gate * 2 + unit tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;

    // ldmatrix rows of this lane: A (rows m) row lane % 16 at k (lane / 16) * 8;
    // B (rows k, transposed) row (lane & 7) + 8 ((lane >> 3) & 1) at unit
    // 8 (lane >> 4), which gives both n8 tiles of a gate's 16 units.
    const int a_row = wm * 32 + lane % 16, a_col = (lane / 16) * 8;
    const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1), b_col = wn * 16 + 8 * (lane >> 4);

    CoefStage st;
    coef_load(st, ys, W, 0, m0, u0, shift, M, H, tid);
    coef_store(st, As[0], Bs[0], tid);
    __syncthreads();
    const int n_stages = (H + kCK - 1) / kCK;
    for (int s = 0; s < n_stages; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_stages) coef_load(st, ys, W, (s + 1) * kCK, m0, u0, shift, M, H, tid);
#pragma unroll
        for (int kk = 0; kk < kCK; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(a[mt], smem_u32(&As[buf][a_row + mt * 16][kk + a_col]));
#pragma unroll
            for (int g = 0; g < 3; ++g) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, smem_u32(&Bs[buf][kk + b_row][g * kBU + b_col]));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[mt][2 * g], a[mt], b[0], b[1]);
                    mma_bf16(acc[mt][2 * g + 1], a[mt], b[2], b[3]);
                }
            }
        }
        if (s + 1 < n_stages) coef_store(st, As[buf ^ 1], Bs[buf ^ 1], tid);
        __syncthreads();
    }

    // Epilogue: fragment (f / 2, f % 2) of tile (mt, g * 2 + ut) is row
    // wm*32 + mt*16 + gid + 8 * (f / 2), unit wn*16 + ut*8 + 2*tig + f % 2.
    const io::bf16* px = dir == 0 ? px_f : px_b;
#pragma unroll
    for (int ut = 0; ut < 2; ++ut) {
        const int u = u0 + wn * 16 + ut * 8 + 2 * tig;
        if (u >= H) continue;
        const float* b = b_hh + dir * H3 + u;
        const float2 br = ldg2(b), bz = ldg2(b + H), bn = ldg2(b + 2 * H);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = m0 + wm * 32 + mt * 16 + gid + 8 * half;
                if (m >= M) continue;
                const long long src = (long long)m + shift;
                const io::bf16* p = px + (size_t)m * H3 + u;
                const float2 xr = ldg2(p), xz = ldg2(p + H), xn = ldg2(p + 2 * H);
                const float2 hp =
                    (src >= 0 && src < M) ? ldg2(ys + src * H + u) : make_float2(0.f, 0.f);
                float out[kNC][2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int f = 2 * half + j;
                    const float hr = acc[mt][0 + ut][f] + (j ? br.y : br.x);
                    const float hz = acc[mt][2 + ut][f] + (j ? bz.y : bz.x);
                    const float hn = acc[mt][4 + ut][f] + (j ? bn.y : bn.x);
                    const float r = sigmoid((j ? xr.y : xr.x) + hr);
                    const float z = sigmoid((j ? xz.y : xz.x) + hz);
                    const float c = tanhf((j ? xn.y : xn.x) + r * hn);
                    const float h_prev = j ? hp.y : hp.x;
                    out[0][j] = z;
                    out[1][j] = (1.f - z) * (1.f - c * c);
                    out[2][j] = (h_prev - c) * z * (1.f - z);
                    out[3][j] = r;
                    out[4][j] = hn * r * (1.f - r);
                }
                float* o = coef + (((size_t)dir * M + m) * kNC) * H + u;
#pragma unroll
                for (int q = 0; q < kNC; ++q)
                    *reinterpret_cast<float2*>(o + (size_t)q * H) =
                        make_float2(out[q][0], out[q][1]);
            }
        }
    }
}

// (b) the chain
constexpr int kChainThreads = 256;     // 8 warps: warp w makes the partial of block w's units
constexpr int kDSB = 3 * kBU + 8;      // bf16 row stride of the dph slice
constexpr int kJSteps = 3 * kBU / 16;  // k16 steps over the block's 96 dph columns

size_t chain_smem(int rows, int n_tiles) {
    const size_t need = sizeof(float) * 4 * n_tiles * rows * kBU + sizeof(io::bf16) * rows * kDSB +
                        2 * sizeof(uint64_t);
    return need > kSoleBlockSmem ? need : kSoleBlockSmem;
}

int chain_threads(int) { return kChainThreads; }

// R batch rows per block (16, 32 or 48). Requires H % 8 == 0 and a
// cluster of ceil(H / kBU) <= 8 blocks along x, equal to gridDim.x. Writes
// dpx and bf16(dhn) [2][T*N][H] for `dw`, and this block's db over its rows
// to dbp[blockIdx.y][dir][3H].
template <int R>
__global__ void __launch_bounds__(kChainThreads, 1)
gru_bwd_chain_bf16_kernel(const io::bf16* __restrict__ dy_f, const io::bf16* __restrict__ dy_b,
                          const float* __restrict__ w_hh, const float* __restrict__ coef,
                          io::bf16* __restrict__ dpx_f, io::bf16* __restrict__ dpx_b,
                          io::bf16* __restrict__ dhn, float* __restrict__ dbp, int T, int N,
                          int H) {
    constexpr int kThreads = kChainThreads;
    constexpr int MT = R / 16;
    constexpr int kPairs = R * (kBU / 2);  // elements come in pairs of units
    constexpr int kNE = (kPairs + kThreads - 1) / kThreads;
    static_assert(R % 16 == 0 && kThreads / 32 == kMaxCluster, "tile sizes");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t n_peers = cluster_size();
    const uint32_t rank = cluster_rank();
    constexpr int kPart = R * kBU;  // one partial dh: R rows x 32 units, f32
    float* recv = reinterpret_cast<float*>(smem_raw);  // [2][n_peers][R][kBU]: from each block
    float* stage = recv + 2 * n_peers * kPart;         // [2][n_peers][R][kBU]: for each block
    io::bf16* ds = reinterpret_cast<io::bf16*>(stage + 2 * n_peers * kPart);  // [R][kDSB]
    uint64_t* bars = reinterpret_cast<uint64_t*>(ds + R * kDSB);             // [2]

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
                        n < H && u0 + ul < H ? pack_bf16(__ldg(w), __ldg(w + 1)) : 0u;
                }
    }

    const io::bf16* dy = dir == 0 ? dy_f : dy_b;
    io::bf16* dpx = dir == 0 ? dpx_f : dpx_b;
    io::bf16* dn = dhn + (size_t)dir * M * H;
    const float* cf = coef + (size_t)dir * M * kNC * H;

    // Elements of this thread: pairs e = tid + j * kThreads, row e / 16,
    // units 2 * (e % 16) and the next; zero where the tile hangs over N or
    // H, so that those elements give zero gradients and partial sums.
    const float2 zero2 = make_float2(0.f, 0.f);
    float2 c[kNE][kNC], dyv[kNE], dhz[kNE];  // dhz: dht * z of the previous step
    float2 dbacc[kNE][3];                    // sums of the unrounded da_r, da_z, dhn
    {
        const int t = dir == 0 ? T - 1 : 0;
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
            const int e = tid + j * kThreads;
            const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
            const bool ok = e < kPairs && row < N && u < H;
            const size_t m = (size_t)t * N + row;
#pragma unroll
            for (int q = 0; q < kNC; ++q) c[j][q] = ok ? ldg2(cf + (m * kNC + q) * H + u) : zero2;
            dyv[j] = ok ? ldg2(dy + m * H + u) : zero2;
            dhz[j] = zero2;
            dbacc[j][0] = dbacc[j][1] = dbacc[j][2] = zero2;
        }
    }

    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        fence_mbar_init();
    }
    // No block of the cluster copies into a peer before that peer has set
    // up its mbarriers.
    __syncthreads();
    cluster_arrive();
    cluster_wait();

    // This lane's ldmatrix row of an A tile of the dph slice.
    const uint32_t a_lane = smem_u32(ds) + 2u * ((lane % 16) * kDSB + (lane / 16) * 8);
    for (int step = 0; step < T; ++step) {
        const int t = dir == 0 ? T - 1 - step : step;
        const int par = step & 1;
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
                const float* src = recv + (par ^ 1) * n_peers * kPart + er * kBU + eu;
                for (uint32_t p = 0; p < n_peers; ++p) {
                    const float2 v = *reinterpret_cast<const float2*>(src + p * kPart);
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
            if (!last) {  // the product's operand: bf16(dph); the last step's dh is not needed
                uint32_t* d = reinterpret_cast<uint32_t*>(ds + er * kDSB + eu);
                d[0] = pack_bf16(da_r0, da_r1);
                d[kBU / 2] = pack_bf16(da_z0, da_z1);
                d[kBU] = pack_bf16(dhn0, dhn1);
            }
        }

        if (!last) {
            __syncthreads();
            if (wok) {
                // Warp w: the partial dh of block w's 32 units over this
                // block's 96 columns, [R, 32], staged for block w (this
                // block's own straight into its receive buffer).
                float acc[MT][4][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                        for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;
#pragma unroll
                for (int ks = 0; ks < kJSteps; ++ks) {
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        uint32_t a[4];
                        ldmatrix_x4(a, a_lane + 2u * (mt * 16 * kDSB + ks * 16));
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt)
                            mma_bf16(acc[mt][nt], a, wf[ks][nt][0], wf[ks][nt][1]);
                    }
                }
                // Pairs of lanes trade halves so that each holds 4 units of
                // one row: the even lane row gid, the odd lane row gid + 8.
                const bool odd = tig & 1;
                float* dst = warp == (int)rank ? recv + (par * n_peers + rank) * kPart
                                               : stage + (par * n_peers + warp) * kPart;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const float* a = acc[mt][nt];
                        const float rx = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
                        const float ry = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
                        const uint4 v = odd ? make_uint4(__float_as_uint(rx), __float_as_uint(ry),
                                                         __float_as_uint(a[2]), __float_as_uint(a[3]))
                                            : make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                                                         __float_as_uint(rx), __float_as_uint(ry));
                        const int row = mt * 16 + gid + (odd ? 8 : 0);
                        const int col = nt * 8 + 4 * (tig / 2);
                        *reinterpret_cast<uint4*>(dst + row * kBU + col) = v;
                    }
            }
            // Each staged partial to its block; the other blocks' partials
            // for this one into recv[par]. Both buffers of this parity were
            // last used two steps ago, before every block's copies of the
            // step between.
            fence_proxy_async();
            __syncthreads();
            uint64_t* bar = &bars[par];
            if ((uint32_t)tid < n_peers && (uint32_t)tid != rank)
                bulk_to_peer(recv + (par * n_peers + rank) * kPart,
                             stage + (par * n_peers + tid) * kPart, 4u * kPart, bar, tid);
            if (tid == 0) mbar_arrive_expect_tx(bar, (n_peers - 1) * 4u * kPart);
            // The next step's coefficients and dy load while the copies run
            // (issued earlier, before the product, the chain took 1.2 times
            // as long: PERF.md).
            const int tn = dir == 0 ? T - 2 - step : step + 1;
#pragma unroll
            for (int j = 0; j < kNE; ++j) {
                const int e = tid + j * kThreads;
                const int row = n0 + e / (kBU / 2), u = u0 + 2 * (e % (kBU / 2));
                if (e < kPairs && row < N && u < H) {
                    const size_t m = (size_t)tn * N + row;
#pragma unroll
                    for (int q = 0; q < kNC; ++q) c[j][q] = ldg2(cf + (m * kNC + q) * H + u);
                    dyv[j] = ldg2(dy + m * H + u);
                }
            }
            mbar_wait(bar, (step >> 1) & 1);
        }
    }
    // Every copy into and out of this block has landed once all blocks are
    // here; the db rows then reuse the buffers.
    cluster_arrive();
    cluster_wait();

    // db of this block's 96 columns over its rows, in row order.
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

// (c) dW partials
constexpr int kWR = 32;                // (t, n) rows per stage (two k16 steps)
constexpr int kWAS = kDK + 8;          // bf16 row stride of the h_prev stage
constexpr int kWDS = 3 * kBU + 8;      // bf16 row stride of the dph stage

struct DwStage {
    uint4 a[2];                        // 8 bf16 of h_prev each
    uint4 d[2];                        // 8 bf16 of dph each
};

// Rows of h_prev (from ys) and of bf16(dph) = [dpx's r and z columns, dhn].
__device__ __forceinline__ void dw_load(DwStage& s, const io::bf16* __restrict__ ys,
                                        const io::bf16* __restrict__ dpx,
                                        const io::bf16* __restrict__ dn, int r0, int r_end,
                                        int k0, int u0, long long shift, int M, int H, int tid) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int H3 = 3 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        {
            const int m = r0 + idx / (kDK / 8), k = k0 + 8 * (idx % (kDK / 8));
            const long long src = (long long)m + shift;
            s.a[i] = (m < r_end && src >= 0 && src < M && k < H)
                         ? __ldg(reinterpret_cast<const uint4*>(ys + src * H + k)) : zero;
        }
        if (idx < kWR * 3 * (kBU / 8)) {
            const int m = r0 + idx / (3 * (kBU / 8)), c = idx % (3 * (kBU / 8));
            const int g = c / (kBU / 8), u = u0 + 8 * (c % (kBU / 8));
            const io::bf16* p = g < 2 ? dpx + (size_t)m * H3 + g * H + u : dn + (size_t)m * H + u;
            s.d[i] = (m < r_end && u < H) ? __ldg(reinterpret_cast<const uint4*>(p)) : zero;
        }
    }
}

__device__ __forceinline__ void dw_store(const DwStage& s, io::bf16 (*As)[kWAS],
                                         io::bf16 (*Ds)[kWDS], int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(&As[idx / (kDK / 8)][8 * (idx % (kDK / 8))]) = s.a[i];
        if (idx < kWR * 3 * (kBU / 8))
            *reinterpret_cast<uint4*>(&Ds[idx / (3 * (kBU / 8))][8 * (idx % (3 * (kBU / 8)))]) =
                s.d[i];
    }
}

// dwp[split][dir][k][j] = sum over the split's rows m of h_prev[m][k] *
// bf16(dph)[m][j], blockIdx.z = split * 2 + dir; 128 x 96 output tiles,
// warp tiles 32 k x 48 j, m16n8k16 bf16 with the contraction along the
// stages' rows (both operands read with ldmatrix.trans).
__global__ void __launch_bounds__(kThreads)
gru_bwd_dw_bf16_kernel(const io::bf16* __restrict__ ys_f, const io::bf16* __restrict__ ys_b,
                       const io::bf16* __restrict__ dpx_f, const io::bf16* __restrict__ dpx_b,
                       const io::bf16* __restrict__ dhn, float* __restrict__ dwp,
                       int rows_per_split, int T, int N, int H) {
    __shared__ __align__(16) io::bf16 As[2][kWR][kWAS];
    __shared__ __align__(16) io::bf16 Ds[2][kWR][kWDS];

    const int dir = blockIdx.z % 2;
    const int split = blockIdx.z / 2;
    const int u0 = blockIdx.x * kBU;
    const int k0 = blockIdx.y * kDK;
    const int M = T * N;
    const int H3 = 3 * H;
    const int tid = threadIdx.x, lane = tid % 32;
    const int warp = tid / 32, gid = lane / 4, tig = lane % 4;
    const int wk = warp % 4, wj = warp / 4;
    const io::bf16* ys = dir == 0 ? ys_f : ys_b;
    const io::bf16* dpx = dir == 0 ? dpx_f : dpx_b;
    const io::bf16* dn = dhn + (size_t)dir * M * H;
    const long long shift = dir == 0 ? -(long long)N : (long long)N;
    const int r_beg = split * rows_per_split;
    const int r_end = min(M, r_beg + rows_per_split);

    float acc[2][6][4];                // [k tile][column tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;

    // ldmatrix.trans rows (stage rows m) of this lane: for A (k across the
    // columns) matrices (m 0, k 0), (m 0, k 8), (m 8, k 0), (m 8, k 8); for
    // B (j across the columns) (m 0, j 0), (m 8, j 0), (m 0, j 8), (m 8, j 8).
    const int a_row = (lane & 7) + 8 * ((lane >> 4) & 1), a_col = wk * 32 + 8 * ((lane >> 3) & 1);
    const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1), b_col = wj * 48 + 8 * (lane >> 4);

    DwStage st;
    dw_load(st, ys, dpx, dn, r_beg, r_end, k0, u0, shift, M, H, tid);
    dw_store(st, As[0], Ds[0], tid);
    __syncthreads();
    int buf = 0;
    for (int r0 = r_beg; r0 < r_end; r0 += kWR, buf ^= 1) {
        const bool more = r0 + kWR < r_end;
        if (more) dw_load(st, ys, dpx, dn, r0 + kWR, r_end, k0, u0, shift, M, H, tid);
#pragma unroll
        for (int mm = 0; mm < kWR; mm += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4_trans(a[mt], smem_u32(&As[buf][mm + a_row][a_col + mt * 16]));
#pragma unroll
            for (int np = 0; np < 3; ++np) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, smem_u32(&Ds[buf][mm + b_row][b_col + np * 16]));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
                    mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                }
            }
        }
        if (more) dw_store(st, As[buf ^ 1], Ds[buf ^ 1], tid);
        __syncthreads();
    }

    // Fragment (f / 2, f % 2) of tile (mt, nt) is row k0 + wk*32 + mt*16 + gid
    // + 8 * (f / 2) of dW, column wj*48 + nt*8 + 2*tig + f % 2 of the block's 96.
    float* out = dwp + (size_t)blockIdx.z * H * H3;
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
        const int jl = wj * 48 + nt * 8 + 2 * tig;
        const int g = jl / kBU, u = u0 + jl % kBU;
        if (u >= H) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int k = k0 + wk * 32 + mt * 16 + gid + 8 * half;
                if (k < H)
                    *reinterpret_cast<float2*>(out + (size_t)k * H3 + g * H + u) =
                        make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
            }
    }
}

constexpr int kRows[] = {16, 32, 48};

const void* chain_for(int rows) {
    switch (rows) {
        case 16: return (const void*)gru_bwd_chain_bf16_kernel<16>;
        case 32: return (const void*)gru_bwd_chain_bf16_kernel<32>;
        default: return (const void*)gru_bwd_chain_bf16_kernel<48>;
    }
}

}  // namespace bf

const void* chain_for(int rows) {
    return rows == 16 ? (const void*)gru_bwd_chain_kernel<16> : (const void*)gru_bwd_chain_kernel<20>;
}

int chain_threads(int) { return kChainThreads; }

constexpr int kRowsF32[] = {16, 20};
int reported_f32[kMaxChoices * (kMaxCluster + 1)], reported_bf16[kMaxChoices * (kMaxCluster + 1)];
const Family kChain = {chain_for, chain_smem, chain_threads, kRowsF32, 2, 14, kMaxCluster,
                       reported_f32};
const Family kChainBf16 = {bf::chain_for, bf::chain_smem, bf::chain_threads, bf::kRows, 3,
                           kBf16StepCost, kMaxCluster, reported_bf16};

// The chain's launch: `rows` > 0 forces that many batch rows per block
// (one of the family's choices), 0 lets pick_rows choose.
cudaError_t chain_config(const Family& chain, int* rows, int N, int H, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr, cudaStream_t s) {
    int max_active = 0;
    cudaError_t err = *rows > 0 ? (offers(chain, *rows) ? cudaSuccess : cudaErrorInvalidValue)
                                : pick_rows(chain, N, H, rows, &max_active);
    if (err == cudaSuccess) err = configure(chain, *rows, N, H, cfg, attr);
    cfg->stream = s;
    return err;
}

int rows_per_split(int M, int splits, int stage) {
    const int r = (M + splits - 1) / splits;
    return (r + stage - 1) / stage * stage;
}

// The phases outside the chain, which any H % 8 == 0 takes (gru_wide.cu's
// chain runs between them for the widths the cluster chain does not take).
// (a) the coefficients.
cudaError_t coef_f32(const float* px_f, const float* px_b, const float* ys_f, const float* ys_b,
                     const float* w_hh, const float* b_hh, float* coef, int T, int N, int H,
                     cudaStream_t s) {
    const dim3 coef_grid((H + kBU - 1) / kBU, (T * N + kGM - 1) / kGM, 2);
    gru_bwd_coef_kernel<<<coef_grid, kThreads, 0, s>>>(px_f, px_b, ys_f, ys_b, w_hh, b_hh, coef,
                                                       T, N, H);
    return cudaGetLastError();
}

// (c) and (d): dW and db from dpx and coef.
cudaError_t dw_f32(const float* ys_f, const float* ys_b, const float* dpx_f, const float* dpx_b,
                   const float* coef, float* dwp, float* dbp, float* dw, float* db, int splits,
                   int T, int N, int H, cudaStream_t s) {
    const dim3 dw_grid((H + kBU - 1) / kBU, (H + kDK - 1) / kDK, 2 * splits);
    gru_bwd_dw_kernel<<<dw_grid, kThreads, 0, s>>>(ys_f, ys_b, dpx_f, dpx_b, coef, dwp, dbp,
                                                   rows_per_split(T * N, splits, kDR), T, N, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n_dw = 2 * H * 3 * H, n_db = 2 * 3 * H;
    gru_bwd_dw_sum_kernel<<<(n_dw + n_db + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dwp, dbp, dw, db, splits, splits, n_dw, n_db);
    return cudaGetLastError();
}

// bf16 (a).
cudaError_t coef_bf16(const io::bf16* px_f, const io::bf16* px_b, const io::bf16* ys_f,
                      const io::bf16* ys_b, const float* w_hh, const float* b_hh, float* coef,
                      int T, int N, int H, cudaStream_t s) {
    const dim3 coef_grid((H + kBU - 1) / kBU, (T * N + kGM - 1) / kGM, 2);
    bf::gru_bwd_coef_bf16_kernel<<<coef_grid, kThreads, 0, s>>>(px_f, px_b, ys_f, ys_b, w_hh,
                                                                b_hh, coef, T, N, H);
    return cudaGetLastError();
}

// bf16 (c) and (d): dW from dpx and the chain's dhn, db from its
// `db_parts` partials.
cudaError_t dw_bf16(const io::bf16* ys_f, const io::bf16* ys_b, const io::bf16* dpx_f,
                    const io::bf16* dpx_b, const io::bf16* dhn, float* dwp, const float* dbp,
                    int db_parts, float* dw, float* db, int splits, int T, int N, int H,
                    cudaStream_t s) {
    const dim3 dw_grid((H + kBU - 1) / kBU, (H + kDK - 1) / kDK, 2 * splits);
    bf::gru_bwd_dw_bf16_kernel<<<dw_grid, kThreads, 0, s>>>(
        ys_f, ys_b, dpx_f, dpx_b, dhn, dwp, rows_per_split(T * N, splits, bf::kWR), T, N, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n_dw = 2 * H * 3 * H, n_db = 2 * 3 * H;
    gru_bwd_dw_sum_kernel<<<(n_dw + n_db + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dwp, dbp, dw, db, splits, db_parts, n_dw, n_db);
    return cudaGetLastError();
}

// The four f32 launches.
int launch_f32(int device, const float* px_f, const float* px_b, const float* ys_f,
               const float* ys_b, const float* dy_f, const float* dy_b, const float* w_hh,
               const float* b_hh, float* dpx_f, float* dpx_b, float* coef, float* dwp,
               float* dbp, float* dw, float* db, int splits, int T, int N, int H, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1 || splits < 1) return (int)cudaErrorInvalidValue;
    int rows = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = chain_config(kChain, &rows, N, H, &cfg, &attr, s);
    if (err != cudaSuccess) return (int)err;

    err = coef_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh, coef, T, N, H, s);
    if (err != cudaSuccess) return (int)err;

    const float* coef_in = coef;
    void* args[] = {&dy_f, &dy_b, &w_hh, &coef_in, &dpx_f, &dpx_b, &T, &N, &H};
    err = cudaLaunchKernelExC(&cfg, kChain.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;

    return (int)dw_f32(ys_f, ys_b, dpx_f, dpx_b, coef, dwp, dbp, dw, db, splits, T, N, H, s);
}

// The four bf16 launches; `rows` as for chain_config.
int launch_bf16(int device, const io::bf16* px_f, const io::bf16* px_b, const io::bf16* ys_f,
                const io::bf16* ys_b, const io::bf16* dy_f, const io::bf16* dy_b,
                const float* w_hh, const float* b_hh, io::bf16* dpx_f, io::bf16* dpx_b,
                float* coef, io::bf16* dhn, float* dwp, float* dbp, float* dw, float* db,
                int splits, int T, int N, int H, int rows, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1 || splits < 1) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = chain_config(kChainBf16, &rows, N, H, &cfg, &attr, s);
    if (err != cudaSuccess) return (int)err;

    err = coef_bf16(px_f, px_b, ys_f, ys_b, w_hh, b_hh, coef, T, N, H, s);
    if (err != cudaSuccess) return (int)err;

    const float* coef_in = coef;
    void* args[] = {&dy_f, &dy_b, &w_hh, &coef_in, &dpx_f, &dpx_b, &dhn, &dbp, &T, &N, &H};
    err = cudaLaunchKernelExC(&cfg, kChainBf16.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;

    return (int)dw_bf16(ys_f, ys_b, dpx_f, dpx_b, dhn, dwp, dbp, (N + rows - 1) / rows, dw, db,
                        splits, T, N, H, s);
}

// Checks and selects the device for a phase entry.
cudaError_t phase_setup(int device, int T, int N, int H, int splits) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return T >= 1 && N >= 1 && H >= 8 && H % 8 == 0 && splits >= 1 ? cudaSuccess
                                                                      : cudaErrorInvalidValue;
}

int max_clusters(const Family& chain, int device, int N, int H, int* rows_out) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int max_active = 0;
    err = pick_rows(chain, N, H, rows_out, &max_active);
    return err == cudaSuccess ? max_active : -(int)err;
}

}  // namespace

extern "C" {

// See the contract above. Scratch: coef [2, T*N, 5, H], dwp [splits, 2, H, 3H],
// dbp [splits, 2, 3H]; `splits` >= 1 ranges of rows for the dW reduction.
// All float32, contiguous, on CUDA device `device`, whose stream is
// `stream`. H % 8 == 0 and H <= 256. Returns the first CUDA error of the
// four launches, or 0.
int ocrs_gru_bwd(int device, const float* px_f, const float* px_b, const float* ys_f,
                 const float* ys_b, const float* dy_f, const float* dy_b, const float* w_hh,
                 const float* b_hh, float* dpx_f, float* dpx_b, float* coef, float* dwp,
                 float* dbp, float* dw, float* db, int splits, int T, int N, int H,
                 void* stream) {
    return launch_f32(device, px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, dpx_f, dpx_b, coef,
                      dwp, dbp, dw, db, splits, T, N, H, stream);
}

// The same with px, ys, dy, dpx bf16 (w_hh float32 holding bf16 values;
// b_hh, coef, dw, db and the scratch float32), and one more scratch, dhn
// [2, T*N, H] bf16; dbp holds [max(splits, ceil(N / 16)), 2, 3H] (the
// chain's db per batch tile).
int ocrs_gru_bwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                      const io::bf16* ys_f, const io::bf16* ys_b, const io::bf16* dy_f,
                      const io::bf16* dy_b, const float* w_hh, const float* b_hh,
                      io::bf16* dpx_f, io::bf16* dpx_b, float* coef, io::bf16* dhn, float* dwp,
                      float* dbp, float* dw, float* db, int splits, int T, int N, int H,
                      void* stream) {
    return launch_bf16(device, px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, dpx_f, dpx_b,
                       coef, dhn, dwp, dbp, dw, db, splits, T, N, H, 0, stream);
}

// ocrs_gru_bwd_bf16 with `rows` batch rows per chain block (16, 32, 48 or
// 64) instead of the one it picks: for measuring the row choices.
int ocrs_gru_bwd_bf16_rows(int device, const io::bf16* px_f, const io::bf16* px_b,
                           const io::bf16* ys_f, const io::bf16* ys_b, const io::bf16* dy_f,
                           const io::bf16* dy_b, const float* w_hh, const float* b_hh,
                           io::bf16* dpx_f, io::bf16* dpx_b, float* coef, io::bf16* dhn,
                           float* dwp, float* dbp, float* dw, float* db, int splits, int T,
                           int N, int H, int rows, void* stream) {
    if (rows < 1) return (int)cudaErrorInvalidValue;
    return launch_bf16(device, px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, dpx_f, dpx_b,
                       coef, dhn, dwp, dbp, dw, db, splits, T, N, H, rows, stream);
}

// The phases around the chain alone, for any H % 8 == 0 (gru_wide.cu's
// chain runs between them where H > 256): the coefficients, one launch,
// coef [2, T*N, 5, H] float32 as above ...
int ocrs_gru_bwd_coef(int device, const float* px_f, const float* px_b, const float* ys_f,
                      const float* ys_b, const float* w_hh, const float* b_hh, float* coef,
                      int T, int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = phase_setup(device, T, N, H, 1);
    if (err == cudaSuccess)
        err = coef_f32(px_f, px_b, ys_f, ys_b, w_hh, b_hh, coef, T, N, H, (cudaStream_t)stream);
    return (int)err;
}

int ocrs_gru_bwd_coef_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                           const io::bf16* ys_f, const io::bf16* ys_b, const float* w_hh,
                           const float* b_hh, float* coef, int T, int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = phase_setup(device, T, N, H, 1);
    if (err == cudaSuccess)
        err = coef_bf16(px_f, px_b, ys_f, ys_b, w_hh, b_hh, coef, T, N, H, (cudaStream_t)stream);
    return (int)err;
}

// ... and dW, db from the chain's dpx (and coef's r), two launches, with
// the scratch of ocrs_gru_bwd ...
int ocrs_gru_bwd_dw(int device, const float* ys_f, const float* ys_b, const float* dpx_f,
                    const float* dpx_b, const float* coef, float* dwp, float* dbp, float* dw,
                    float* db, int splits, int T, int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = phase_setup(device, T, N, H, splits);
    if (err == cudaSuccess)
        err = dw_f32(ys_f, ys_b, dpx_f, dpx_b, coef, dwp, dbp, dw, db, splits, T, N, H,
                     (cudaStream_t)stream);
    return (int)err;
}

// ... in bf16 from dpx and the chain's dhn [2, T*N, H] bf16, and db from
// its `db_parts` partials dbp [db_parts, 2, 3H].
int ocrs_gru_bwd_dw_bf16(int device, const io::bf16* ys_f, const io::bf16* ys_b,
                         const io::bf16* dpx_f, const io::bf16* dpx_b, const io::bf16* dhn,
                         float* dwp, const float* dbp, int db_parts, float* dw, float* db,
                         int splits, int T, int N, int H, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = phase_setup(device, T, N, H, splits);
    if (err == cudaSuccess && db_parts < 1) err = cudaErrorInvalidValue;
    if (err == cudaSuccess)
        err = dw_bf16(ys_f, ys_b, dpx_f, dpx_b, dhn, dwp, dbp, db_parts, dw, db, splits, T, N, H,
                      (cudaStream_t)stream);
    return (int)err;
}

// How many clusters of the chain's launch for (N, H) the device can hold
// at once (cudaOccupancyMaxActiveClusters); *rows_out gets the batch rows
// per block that ocrs_gru_bwd picks for that shape. Returns the count, or
// minus the CUDA error code.
int ocrs_gru_bwd_max_clusters(int device, int N, int H, int* rows_out) {
    return max_clusters(kChain, device, N, H, rows_out);
}

// The same for ocrs_gru_bwd_bf16's chain.
int ocrs_gru_bwd_bf16_max_clusters(int device, int N, int H, int* rows_out) {
    return max_clusters(kChainBf16, device, N, H, rows_out);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
