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
// 16-row tiles of `mma` at the cluster sizes that fit the card. H > 256
// would need a cluster of more than 8 blocks; the wrapper raises for it.
//
// bf16 (`compute_dtype=jnp.bfloat16`): px, ys, dy are read and dpx written
// in bf16; coef, dW, db stay f32. The rounding points are the Pallas
// kernel's: h_prev is the bf16 ys (so `coef` recomputes the gates from the
// rounded state, as the Pallas kernel does); the chain's product takes
// bf16(dph) and the wrapper's bf16-rounded W_hh; dW sums h_prev^T bf16(dph)
// and db the UNROUNDED dph, both in f32. So the chain also writes the f32
// dph = [da_r, da_z, dhn] to scratch of the call ([2, T*N, 3H]), which `dw`
// reads instead of dpx * r: dpx holds bf16(da_c), and bf16(bf16(da_c) r)
// is not bf16(da_c r). With both operands bf16 values, the products of
// `coef` and `dw` are exact in TF32, so each tile takes one `mma` instead
// of three. At T=257, N=128, H=256 the bytes the function must move are
// px, ys, dy and dpx in bf16: 269.6 MB, 80 us, which bound it; the products
// take 78 us at the bf16 tensor-core rate (989 TFLOP/s). This kernel also
// writes and reads the dph scratch in f32 (404 MB, 0.12 ms) and runs the
// chain's products as f32 FMAs (1.16 ms for all products at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "gru_cluster.cuh"

namespace {

using namespace gru_cluster;

constexpr int kThreads = 256;
constexpr int kNC = 5;                 // coefficients per element

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

// The operands of a product whose inputs hold bf16 values (kExact) are
// exact in TF32: no lo part, one `mma`. Otherwise the 3xTF32 split.
template <bool kExact>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    if (kExact) {
        hi = __float_as_uint(x);
        lo = 0u;
    } else {
        split_tf32(x, hi, lo);
    }
}

template <bool kExact>
__device__ __forceinline__ void tf32_mma(float (&c)[4], const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                         const uint32_t (&b_lo)[2]) {
    if (kExact)
        mma_tf32(c, a_hi, b_hi);
    else
        mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
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
template <typename E>
__device__ __forceinline__ void coef_load(CoefStage& s, const E* __restrict__ ys,
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
// 3 r, 4 hn r (1-r). Requires H % 8 == 0. E: the element type of px and ys.
template <typename E>
__global__ void __launch_bounds__(kThreads)
gru_bwd_coef_kernel(const E* __restrict__ px_f, const E* __restrict__ px_b,
                    const E* __restrict__ ys_f, const E* __restrict__ ys_b,
                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                    float* __restrict__ coef, int T, int N, int H) {
    constexpr bool kBf16 = io::is_bf16<E>::value;
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
    const E* ys = dir == 0 ? ys_f : ys_b;
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
                tf32_split<kBf16>(As[buf][r][k8 + tig], a_hi[mt][0], a_lo[mt][0]);
                tf32_split<kBf16>(As[buf][r + 8][k8 + tig], a_hi[mt][1], a_lo[mt][1]);
                tf32_split<kBf16>(As[buf][r][k8 + tig + 4], a_hi[mt][2], a_lo[mt][2]);
                tf32_split<kBf16>(As[buf][r + 8][k8 + tig + 4], a_hi[mt][3], a_lo[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 6; ++nt) {
                const int col = (nt / 2) * kBU + wn * 16 + (nt % 2) * 8 + gid;
                uint32_t b_hi[2], b_lo[2];
                tf32_split<kBf16>(Bs[buf][k8 + tig][col], b_hi[0], b_lo[0]);
                tf32_split<kBf16>(Bs[buf][k8 + tig + 4][col], b_hi[1], b_lo[1]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    tf32_mma<kBf16>(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
            }
        }
        if (s + 1 < n_stages) coef_store(st, As[buf ^ 1], Bs[buf ^ 1], tid);
        __syncthreads();
    }

    // Epilogue: fragment (f / 2, f % 2) of tile (mt, ut) is row wm*32 + mt*16
    // + gid + 8 * (f / 2), unit wn*16 + ut*8 + 2*tig + f % 2.
    const E* px = dir == 0 ? px_f : px_b;
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
                const E* p = px + (size_t)m * H3 + u;
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
// E: the element type of dy and dpx. In bf16 the f32 dph goes to `dph`
// [2][T*N][3H] for `dw` (unused in f32).
template <int R, typename E>
__global__ void __launch_bounds__(kChainThreads, 1)
gru_bwd_chain_kernel(const E* __restrict__ dy_f, const E* __restrict__ dy_b,
                     const float* __restrict__ w_hh, const float* __restrict__ coef,
                     E* __restrict__ dpx_f, E* __restrict__ dpx_b, float* __restrict__ dph,
                     int T, int N, int H) {
    constexpr bool kBf16 = io::is_bf16<E>::value;
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

    const E* dy = dir == 0 ? dy_f : dy_b;
    E* dpx = dir == 0 ? dpx_f : dpx_b;
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
                E* o = dpx + ((size_t)t * N + row) * H3 + u;
                io::st2(o, da_r0, da_r1);
                io::st2(o + H, da_z0, da_z1);
                io::st2(o + 2 * H, da_c0, da_c1);
                if (kBf16) {
                    float* q = dph + ((size_t)dir * M + (size_t)t * N + row) * H3 + u;
                    io::st2(q, da_r0, da_r1);
                    io::st2(q + H, da_z0, da_z1);
                    io::st2(q + 2 * H, dhn0, dhn1);
                }
            }
            if (!last) {  // the last step's dh is not needed
                float* d = ds + er * kDS + eu;
                if (kBf16) {  // the product's operand is bf16(dph)
                    io::st2(d, io::round_bf16(da_r0), io::round_bf16(da_r1));
                    io::st2(d + kBU, io::round_bf16(da_z0), io::round_bf16(da_z1));
                    io::st2(d + 2 * kBU, io::round_bf16(dhn0), io::round_bf16(dhn1));
                } else {
                    io::st2(d, da_r0, da_r1);
                    io::st2(d + kBU, da_z0, da_z1);
                    io::st2(d + 2 * kBU, dhn0, dhn1);
                }
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

// dph rows from `dsrc`: in f32 dpx with its n columns times r, in bf16 the
// chain's f32 dph (kept unrounded here: db sums it so; the product rounds
// it).
template <typename E>
__device__ __forceinline__ void dw_load(DwStage& s, const E* __restrict__ ys,
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
                if (!io::is_bf16<E>::value && g == 2) {  // dph's n columns are da_c * r
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
// E: the element type of ys. dsrc_f, dsrc_b: dpx (f32) or the chain's dph
// (bf16), per direction.
template <typename E>
__global__ void __launch_bounds__(kThreads)
gru_bwd_dw_kernel(const E* __restrict__ ys_f, const E* __restrict__ ys_b,
                  const float* __restrict__ dsrc_f, const float* __restrict__ dsrc_b,
                  const float* __restrict__ coef, float* __restrict__ dwp,
                  float* __restrict__ dbp, int rows_per_split, int T, int N, int H) {
    constexpr bool kBf16 = io::is_bf16<E>::value;
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
    const E* ys = dir == 0 ? ys_f : ys_b;
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
                tf32_split<kBf16>(As[buf][m8 + tig][k], a_hi[mt][0], a_lo[mt][0]);
                tf32_split<kBf16>(As[buf][m8 + tig][k + 8], a_hi[mt][1], a_lo[mt][1]);
                tf32_split<kBf16>(As[buf][m8 + tig + 4][k], a_hi[mt][2], a_lo[mt][2]);
                tf32_split<kBf16>(As[buf][m8 + tig + 4][k + 8], a_hi[mt][3], a_lo[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 6; ++nt) {
                const int col = wj * 48 + nt * 8 + gid;
                uint32_t b_hi[2], b_lo[2];
                float d0 = Ds[buf][m8 + tig][col], d1 = Ds[buf][m8 + tig + 4][col];
                if (kBf16) {  // the product's operand is bf16(dph)
                    d0 = io::round_bf16(d0);
                    d1 = io::round_bf16(d1);
                }
                tf32_split<kBf16>(d0, b_hi[0], b_lo[0]);
                tf32_split<kBf16>(d1, b_hi[1], b_lo[1]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    tf32_mma<kBf16>(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
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

// dw[i] = sum over splits of dwp[split][i], in split order; db likewise.
__global__ void __launch_bounds__(kThreads)
gru_bwd_dw_sum_kernel(const float* __restrict__ dwp, const float* __restrict__ dbp,
                      float* __restrict__ dw, float* __restrict__ db, int splits, int n_dw,
                      int n_db) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < n_dw) {
        float s = dwp[i];
        for (int p = 1; p < splits; ++p) s += dwp[(size_t)p * n_dw + i];
        dw[i] = s;
    } else if (i < n_dw + n_db) {
        const int j = i - n_dw;
        float s = dbp[j];
        for (int p = 1; p < splits; ++p) s += dbp[(size_t)p * n_db + j];
        db[j] = s;
    }
}

template <typename E>
const void* chain_for(int rows) {
    return rows == 16 ? (const void*)gru_bwd_chain_kernel<16, E>
                      : (const void*)gru_bwd_chain_kernel<20, E>;
}

int reported_f32[kNumChoices][kMaxCluster + 1], reported_bf16[kNumChoices][kMaxCluster + 1];
const Family kChain = {chain_for<float>, chain_smem, kChainThreads, reported_f32};
const Family kChainBf16 = {chain_for<io::bf16>, chain_smem, kChainThreads, reported_bf16};

// The four launches for element type E; `dph` is the bf16 path's scratch.
template <typename E>
int launch(const Family& chain, int device, const E* px_f, const E* px_b, const E* ys_f,
           const E* ys_b, const E* dy_f, const E* dy_b, const float* w_hh, const float* b_hh,
           E* dpx_f, E* dpx_b, float* coef, float* dph, float* dwp, float* dbp, float* dw,
           float* db, int splits, int T, int N, int H, void* stream) {
    constexpr bool kBf16 = io::is_bf16<E>::value;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T < 1 || splits < 1) return (int)cudaErrorInvalidValue;
    int rows = 0, max_active = 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = pick_rows(chain, N, H, &rows, &max_active);
    if (err == cudaSuccess) err = configure(chain, rows, N, H, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    cfg.stream = s;
    const int M = T * N;
    const int n_tiles = (H + kBU - 1) / kBU;

    const dim3 coef_grid(n_tiles, (M + kGM - 1) / kGM, 2);
    gru_bwd_coef_kernel<E><<<coef_grid, kThreads, 0, s>>>(px_f, px_b, ys_f, ys_b, w_hh, b_hh,
                                                          coef, T, N, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const float* coef_in = coef;
    void* args[] = {&dy_f, &dy_b, &w_hh, &coef_in, &dpx_f, &dpx_b, &dph, &T, &N, &H};
    err = cudaLaunchKernelExC(&cfg, chain.kernel(rows), args);
    if (err != cudaSuccess) return (int)err;

    int rows_per_split = (M + splits - 1) / splits;
    rows_per_split = (rows_per_split + kDR - 1) / kDR * kDR;
    const dim3 dw_grid(n_tiles, (H + kDK - 1) / kDK, 2 * splits);
    const float* dsrc_f = kBf16 ? dph : reinterpret_cast<const float*>(dpx_f);
    const float* dsrc_b = kBf16 ? dph + (size_t)M * 3 * H : reinterpret_cast<const float*>(dpx_b);
    gru_bwd_dw_kernel<E><<<dw_grid, kThreads, 0, s>>>(ys_f, ys_b, dsrc_f, dsrc_b, coef, dwp, dbp,
                                                      rows_per_split, T, N, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int n_dw = 2 * H * 3 * H, n_db = 2 * 3 * H;
    gru_bwd_dw_sum_kernel<<<(n_dw + n_db + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dwp, dbp, dw, db, splits, n_dw, n_db);
    return (int)cudaGetLastError();
}

int max_clusters(const Family& chain, int device, int N, int H, int* rows_out) {
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
    return launch<float>(kChain, device, px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, dpx_f,
                         dpx_b, coef, nullptr, dwp, dbp, dw, db, splits, T, N, H, stream);
}

// The same with px, ys, dy, dpx bf16 (w_hh float32 holding bf16 values;
// b_hh, coef, dw, db and the scratch float32), and one more scratch, dph
// [2, T*N, 3H] float32.
int ocrs_gru_bwd_bf16(int device, const io::bf16* px_f, const io::bf16* px_b,
                      const io::bf16* ys_f, const io::bf16* ys_b, const io::bf16* dy_f,
                      const io::bf16* dy_b, const float* w_hh, const float* b_hh,
                      io::bf16* dpx_f, io::bf16* dpx_b, float* coef, float* dph, float* dwp,
                      float* dbp, float* dw, float* db, int splits, int T, int N, int H,
                      void* stream) {
    return launch<io::bf16>(kChainBf16, device, px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh,
                            dpx_f, dpx_b, coef, dph, dwp, dbp, dw, db, splits, T, N, H, stream);
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
