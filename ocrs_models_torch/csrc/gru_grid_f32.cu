// Bidirectional GRU recurrence of one layer in float32 at hidden widths
// above 512 ("the f32 grid form" of the wide route): the forward, and the
// backward's chain of dependent steps, each in ONE persistent launch over
// the whole card, W_hh's f32 slice resident in shared memory, the products
// on the tensor cores in error-compensated TF32 ("3xTF32").
//
// Replaces: the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py, forward (`_fwd_call`, body
// `_fwd_kernel`) and the chain of its backward (`_bwd_call`, body
// `_bwd_kernel`), in f32 compute at the widths that no thread block cluster
// of gru_wide.cu's persistent form holds: the wrapper (ops/gru.py,
// `gru_route`, `grid_f32_plan`) sends f32 layers of padded width 512 < H <=
// 1056 (GRID_F32_MAX_HIDDEN on an H100) here, after zero-padding H to a
// multiple of 8; wider f32 layers keep gru_wide.cu's kernels of one launch
// a step. The backward's other phases, the coefficients before the chain
// and the dW/db reduction after it, are gru_bwd.cu's f32 entries.
//
// Contract, that of gru_wide.cu's f32 entries: px_f, px_b [T, N, 3H] are x
// @ W_ih + b_ih per direction in natural time order (the backward direction
// reads step T-1-i); w_hh [2, H, 3H] for h @ W; b_hh [2, 3H]; gate order r,
// z, n with n = tanh(xn + r * (W_hn h + b_hn)); everything in f32, the
// products as three TF32 products each (plain TF32 fails the tolerances;
// what 3xTF32 drops is below 2^-20 of a product). The chain takes the coefficients [2,
// T*N, 5, H] of gru_bwd.cu's `coef` and dy, carries dht * z in f32 and
// writes dpx = [da_r, da_z, da_c] (dW's phase recomputes dhn from dpx and
// the coefficients).
//
// Bound on an H100 SXM (67 TFLOP/s float32 outside the tensor cores, 3.35
// TB/s HBM). At T=257, N=128, H=1024 the forward multiplies [N,H] x [H,3H]
// per step and direction: 2 * 257 * 2*128*1024*3072 = 413.9 GFLOP, 6.18 ms,
// 24 us a step; its bytes (px read, ys written) are 0.54 GB, 0.16 ms. The
// chain's product [N,3H] x [3H,H] is as large. Operations bound both, and
// the T dependent steps bound them harder. (On the tensor cores, 495
// TFLOP/s TF32 dense, three products a product run the f32 work at up to
// 165 TFLOP/s.)
//
// Design: ONE cooperative launch a call (the cooperative attribute through
// cudaLaunchKernelExC): a grid that the card cannot hold at once is refused
// at launch instead of hanging in a barrier. The plan comes from the
// wrapper (ops/gru.py `grid_f32_plan`): a block owns U = 16 hidden units x
// R batch rows (a multiple of 16) of one direction; ceil(H/16) unit tiles x
// ceil(N/R) row tiles per direction, one block an SM (64 unit tiles x 2
// directions = 128 blocks at H=1024, N=128).
// - W: the block loads its f32 slice of W_hh once into shared memory and
//   keeps it for all T steps: the forward's 3U = 48 columns of W_hh (its
//   units' r, z and n columns) over the contraction H, the chain's U rows
//   of W_hh (W_hh^T's columns) over 3H, both as [k/4][columns] float4 (4
//   consecutive k of one column in 16 bytes), zero past H (the last unit
//   tile) and past the contraction (padded to 16): 12 * U * H bytes either
//   way, 196,608 at H=1024.
// - The products, 8 warps, `mma.sync.m16n8k8` tf32 -> f32. In passes of
//   128 batch rows, warp w owns the m16 tile w of the pass (rows 16 w ..
//   16 w + 15) and every n8 tile of the block's columns: the forward's 48
//   (the r, z and n columns of its 16 units), the chain's 16. Per k8 step a
//   lane reads its 4 A fragment values (LDS.32: the stage's swizzle puts a
//   warp's 32 reads in 32 banks) and each n8 tile's 2 B fragment values
//   (32 consecutive floats a warp), splits each x into hi, its upper 19
//   bits (a mask), and lo = x - hi, and runs three mma (a_lo b_hi, a_hi
//   b_lo, a_hi b_hi), each into partial sums of its own (in the chain,
//   with only 2 n8 tiles, also alternating between two sets by k8 step), so
//   that an mma rarely waits for the one before it; the partials are added
//   in a fixed order at the end. A thread's C fragments hold rows gid and
//   gid + 8 (gid = lane / 4) and, of every n8 tile, columns 2 tig and 2 tig
//   + 1 (tig = lane % 4): in the forward all three gates of its 4 units, so
//   the gate math of an element runs in the thread that summed it.
// - The A operand, what the previous step wrote for the warp's 16 rows
//   (h [N, H] in the forward, dph [N, 3H] in the chain, f32 in device
//   memory), goes through shared memory in chunks of 16 k: the warp copies
//   its own 16 x 16 floats per chunk with `cp.async.cg` (from L2, never a
//   stale L1; 16 bytes a copy, two a lane), S chunks ahead in a ring of its
//   own (S = 3 or 4 stages from the plan, by the shared memory left beside W),
//   so only `__syncwarp` orders a stage's copies before its reads and its
//   reads before its next fill: no block barrier inside a step. A stage is
//   [16 rows][4 float4], float4 column c of row r at r * 4 + (c ^ (r / 2 %
//   4)), so that a warp's reads of an A fragment value (8 rows x 4 k) fall
//   in 32 banks.
// - The gate math's inputs (px, or the coefficients and dy, and the f32
//   state) load into registers before the product and are in flight during
//   it. The f32 state h (forward) and dht * z (chain) of an element live in
//   scratch of the call's own, read and written only by the thread that
//   owns the element; the forward's h in two buffers by step parity, [2][2,
//   N, H], which the next step's products read; the chain's dph [2][2, N,
//   3H] the same way and dht * z in [2, N, H].
// - Between steps, a counter per (direction, row tile) in device memory:
//   after its last write of a step a block adds 1 (`red.release.gpu`); a
//   block reads the previous step's state once the counter shows every unit
//   tile of its row tile done (`ld.acquire.gpu`; a counter that never
//   arrives traps after about ten seconds instead of hanging). The state
//   alternates between two buffers by step parity: one is rewritten only
//   after every block of the row tile has passed the next barrier. The
//   counters are scratch of the call's own (torch.empty), zeroed by block 0
//   before one grid-wide sync (cooperative_groups) at the start.
// Trouble spots, and what the design does about them:
// - L2 traffic of the state: every block reads all H (3H) columns of its
//   rows each step, 128 blocks x 128 rows x 1024 x 4 B = 64 MB a forward
//   step and 192 MB a chain step at H=1024, from L2 (the state buffers,
//   4-6 MB, stay there). The ring keeps S - 1 chunks in flight while one
//   multiplies. On an H100 at H=1024 a build whose copies read nothing
//   (zero-filled) runs 9% (forward) and 2% (chain) faster (grid_probe
//   --f32), so blocks of a row tile sharing their reads (a cluster of 2
//   multicasting its chunks by TMA) could gain at most that; not built.
// - The FMA pipes first (the first build): lanes of 4 rows x 6 (2)
//   columns, one LDS.128 per row and column each 4 k, took 12.95 / 19.49 ms
//   (forward / chain) at T=257, N=128, H=1024, its products 88-90% of a
//   step and 1.9x / 2.8x their FMA time; 4 warps of 8 x 6 / 4 x 4 lane tiles
//   (fewer shared-memory bytes an FMA) ran 2-35% slower, at 249-255
//   registers with spills. 3xTF32 with one set of sums ran 8.65 / 15.59
//   ms, with the partial sums apart 8.83 / 14.50 (kept: one code path;
//   kernel_ab, grid_probe; PERF.md).
// - Shared memory: 232,448 bytes a block at most; W takes 196,608 at
//   H=1024 and 202,752 at 1056, the ring 8 KB a stage (8 warps x 1 KB):
//   the plan picks the most of 4 and 3 stages that fit, 4 up to H=1040
//   (229,376 bytes at 1024), 3 at 1048 and 1056.
// - Registers: one block an SM (`__launch_bounds__(256, 1)`, up to 255 a
//   thread): the forward holds 72 partial sums (24 sums of 3 products), 24
//   px values, 8 states and 6 biases besides a k8 step's split fragments.
// - Ragged shapes: rows past N are zero in the staged A (cp.async's source
//   size 0) and skipped in the gate math; a warp whose 16 rows all lie past
//   the block's rows sits the pass out; units past H have zero W columns
//   and no gate math; k past the contraction is zero in both operands.
// - The step barrier costs 1.3-4.3 k cycles (gru_grid.cu's, PERF.md).
// Every sum runs in a fixed order and there are no atomics on data, so
// reruns agree bit for bit.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "grid_step.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace grid_step;
using namespace tc;

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kU = 16;                 // hidden units a block
constexpr int kPassRows = 16 * kWarps; // batch rows a pass: 16 a warp
constexpr int kKC = 16;                // k of a staged chunk
constexpr int kStageF4 = 16 * kKC / 4; // float4 of a warp's stage (16 rows x 16 k)
constexpr int kNC = 5;                 // coefficients per element (gru_bwd.cu's coef)

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Columns of the W slice: the forward's 3U (r, z, n of its units), the
// chain's U; its contraction, H or 3H, padded to the chunks.
__host__ __device__ constexpr int w_cols(int kind) { return kind == 0 ? 3 * kU : kU; }
__host__ __device__ constexpr int w_k(int kind, int H) { return round16(kind == 0 ? H : 3 * H); }

// Dynamic shared memory of kind 0 (forward) or 1 (chain) at padded width H
// with S ring stages: the W slice, then each warp's ring.
size_t grid_f32_smem(int kind, int H, int S) {
    return (size_t)4 * w_cols(kind) * w_k(kind, H) + (size_t)kWarps * S * kStageF4 * 16;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float comp2(const float2& v, int e) { return e == 0 ? v.x : v.y; }

// The float4 of a stage holding row r, k columns 4c .. 4c + 3 (swizzled).
__device__ __forceinline__ int stage_slot(int r, int c) { return r * 4 + (c ^ ((r >> 1) & 3)); }

// ---------------------------------------------------------------------
// the product

// Chunk `c` of this warp's rows of A [N, lda] (rows row0 .. row0 + 15, the
// first `valid` of them real; k from 16 c, zero at K and past it) into the
// warp's stage `st`, then one commit.
__device__ __forceinline__ void stage_chunk(float4* st, const float* A, int lda, int row0,
                                            int valid, int c, int K, int lane) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = lane + 32 * h, r = q >> 2, kc = q & 3, k = c * kKC + 4 * kc;
        const bool ok = r < valid && k < K;
        const float* src = ok ? A + (size_t)(row0 + r) * lda + k : A;
        cp_async16(st + stage_slot(r, kc), src, ok ? 16 : 0);
    }
    cp_async_commit();
}

// Error-compensated TF32 products on the tensor cores ("3xTF32", as
// gru_bwd.cu's coef and dw): x is split into hi, its upper 19 bits, and lo
// = x - hi (exact), of which the tensor core in turn reads the upper 19
// bits; a * b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
// accumulation. What is dropped is below 2^-20 of the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], one warp: with gid = lane / 4 and tig =
// lane % 4 a thread holds a (gid, tig), (gid + 8, tig), (gid, tig + 4),
// (gid + 8, tig + 4); b (tig, gid), (tig + 4, gid); c (gid, 2 tig), (gid,
// 2 tig + 1), (gid + 8, 2 tig), (gid + 8, 2 tig + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nt] (mma's C fragment of n8 tile nt) += sum over k < K of A[row0 ..
// row0 + 15][k] * W[k][8 nt .. 8 nt + 7], NT n8 tiles, W the block's slice
// `w` ([K16 / 4][8 NT] float4), A staged through the warp's ring `ring` of
// S stages. Each k8 step's three m16n8k8 tf32 products go to partial sums
// of their own, and with KP > 1 the k8 steps alternate between KP sets of
// them, so that 3 KP NT products are independent (an mma's result waits
// for the one before it into the same sums); the partials are added in a
// fixed order at the end.
template <int NT, int KP, int S>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const float4* __restrict__ w,
                                             float4* ring, const float* A, int lda, int row0,
                                             int valid, int K, int lane) {
    constexpr int WC = 8 * NT;  // float4 a k4 row of W
    float part[KP][NT][3][4];
#pragma unroll
    for (int p = 0; p < KP; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int x = 0; x < 3; ++x)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[p][nt][x][e] = 0.f;
    const int gid = lane / 4, tig = lane % 4;
    const int chunks = (K + kKC - 1) / kKC;
#pragma unroll
    for (int c = 0; c < S - 1; ++c) {
        if (c < chunks) stage_chunk(ring + c * kStageF4, A, lda, row0, valid, c, K, lane);
        else cp_async_commit();
    }
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<S - 2>();
        __syncwarp();
        const int next = c + S - 1;
        if (next < chunks)
            stage_chunk(ring + (next % S) * kStageF4, A, lda, row0, valid, next, K, lane);
        else
            cp_async_commit();
        const float* st = reinterpret_cast<const float*>(ring + (c % S) * kStageF4);
        const float* wk = reinterpret_cast<const float*>(w + (size_t)c * (kKC / 4) * WC);
#pragma unroll
        for (int k8 = 0; k8 < kKC / 8; ++k8) {
            uint32_t a_hi[4], a_lo[4];
            split_tf32(st[stage_slot(gid, 2 * k8) * 4 + tig], a_hi[0], a_lo[0]);
            split_tf32(st[stage_slot(gid + 8, 2 * k8) * 4 + tig], a_hi[1], a_lo[1]);
            split_tf32(st[stage_slot(gid, 2 * k8 + 1) * 4 + tig], a_hi[2], a_lo[2]);
            split_tf32(st[stage_slot(gid + 8, 2 * k8 + 1) * 4 + tig], a_hi[3], a_lo[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                uint32_t b_hi[2], b_lo[2];
                split_tf32(wk[((2 * k8) * WC + 8 * nt + gid) * 4 + tig], b_hi[0], b_lo[0]);
                split_tf32(wk[((2 * k8 + 1) * WC + 8 * nt + gid) * 4 + tig], b_hi[1], b_lo[1]);
                float (&pk)[NT][3][4] = part[k8 % KP];
                mma_tf32(pk[nt][0], a_lo, b_hi);
                mma_tf32(pk[nt][1], a_hi, b_lo);
                mma_tf32(pk[nt][2], a_hi, b_hi);
            }
        }
    }
    __syncwarp();  // every lane's last reads before the ring's next fill
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float sum = 0.f;
#pragma unroll
            for (int p = 0; p < KP; ++p) sum += part[p][nt][2][e] + (part[p][nt][0][e] + part[p][nt][1][e]);
            acc[nt][e] += sum;
        }
}

// ---------------------------------------------------------------------
// forward

struct FwdArgs {
    const float* px_f;
    const float* px_b;
    const float* w_hh;
    const float* b_hh;
    float* hs;        // [2 parities][2, N, H] the f32 state
    float* ys_f;
    float* ys_b;
    unsigned* ctr;    // [2 * RT] step counters
    int T, N, H, R;
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_f32_fwd_kernel(const FwdArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, KP = round16(H);
    const Tile tl = block_tile(N, H, kU, a.R);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;  // rows gid + 8 i, units 8 j + 2 tig + e
    float4* w = reinterpret_cast<float4*>(smem_raw);  // [KP / 4][48]: column g U + u = W[:, g H + u0 + u]
    float4* ring = w + (size_t)KP / 4 * 3 * kU + (size_t)warp * S * kStageF4;
    {
        const float* src = a.w_hh + (size_t)tl.dir * H * H3;
        float* wf = reinterpret_cast<float*>(w);
        for (int idx = tid; idx < KP * 3 * kU; idx += kThreads) {
            const int k = idx / (3 * kU), col = idx % (3 * kU), u = tl.u0 + col % kU;
            const float v = k < H && u < H ? src[(size_t)k * H3 + (col / kU) * H + u] : 0.f;
            wf[((k >> 2) * 3 * kU + col) * 4 + (k & 3)] = v;
        }
    }
    // Units are a multiple of 8 from u0 (H % 8 == 0), so a pair 2 tig, 2
    // tig + 1 lies wholly inside or past H.
    float2 b[3][2];
    bool uok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int u = tl.u0 + 8 * j + 2 * tig;
        uok[j] = u < H;
#pragma unroll
        for (int g = 0; g < 3; ++g)
            b[g][j] = uok[j] ? io::ldg2(a.b_hh + tl.dir * H3 + g * H + u) : make_float2(0.f, 0.f);
    }
    zero_counters<kThreads>(a.ctr, 2 * tl.RT);

    const float* px = tl.dir == 0 ? a.px_f : a.px_b;
    float* ys = tl.dir == 0 ? a.ys_f : a.ys_b;
    const size_t plane = (size_t)N * H;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? step : T - 1 - step;
        const float* hprev = a.hs + ((size_t)((step + 1) & 1) * 2 + tl.dir) * plane;
        float* hnext = a.hs + ((size_t)(step & 1) * 2 + tl.dir) * plane;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int row0 = tl.n0 + p * kPassRows + 16 * warp;  // the warp's first row
            const int valid = min(16, tl.n0 + tl.rows - row0);
            if (valid <= 0) continue;  // warp-uniform
            // The gate math's inputs, in flight during the product: rows
            // gid + 8 i, units u0 + 8 j + 2 tig + e.
            float2 x[2][3][2], hp[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int m = row0 + gid + 8 * i;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const bool ok = gid + 8 * i < valid && uok[j];
                    const int u = tl.u0 + 8 * j + 2 * tig;
                    const float* pr = px + ((size_t)t * N + m) * H3 + u;
#pragma unroll
                    for (int g = 0; g < 3; ++g)
                        x[i][g][j] = ok ? __ldcs(reinterpret_cast<const float2*>(pr + g * H))
                                        : make_float2(0.f, 0.f);
                    hp[i][j] = ok && step > 0 ? *reinterpret_cast<const float2*>(hprev + (size_t)m * H + u)
                                              : make_float2(0.f, 0.f);
                }
            }
            float acc[6][4];  // n8 tile 2 g + j: gate g of units 8 j .. 8 j + 7
#pragma unroll
            for (int nt = 0; nt < 6; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
            if (step > 0) warp_product<6, 1, S>(acc, w, ring, hprev, H, row0, valid, H, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (gid + 8 * i >= valid) continue;
                const int m = row0 + gid + 8 * i;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    if (!uok[j]) continue;
                    const int u = tl.u0 + 8 * j + 2 * tig;
                    float h[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float r = sigmoid(comp2(x[i][0][j], e) + (acc[j][2 * i + e] + comp2(b[0][j], e)));
                        const float z = sigmoid(comp2(x[i][1][j], e) + (acc[2 + j][2 * i + e] + comp2(b[1][j], e)));
                        const float c = tanhf(comp2(x[i][2][j], e) + r * (acc[4 + j][2 * i + e] + comp2(b[2][j], e)));
                        h[e] = (1.f - z) * c + z * comp2(hp[i][j], e);
                    }
                    *reinterpret_cast<float2*>(hnext + (size_t)m * H + u) = make_float2(h[0], h[1]);
                    *reinterpret_cast<float2*>(ys + ((size_t)t * N + m) * H + u) = make_float2(h[0], h[1]);
                }
            }
        }
        signal_step(ctr);
    }
}

// ---------------------------------------------------------------------
// the backward's chain: step s of both directions' reverse scans (the
// forward direction at t = T-1-s, the backward one at t = s).
//   dh = carry + dph_{s-1} @ W_hh^T (0 at s = 0);  dht = dh + dy[t];  with
//   the coefficients q of (t, n): da_c = dht q1, da_z = dht q2, dhn = da_c
//   q3, da_r = da_c q4;  dpx[t] = [da_r, da_z, da_c];  dph_s = [da_r, da_z,
//   dhn];  carry = dht q0 (q0 = z).

struct ChainArgs {
    const float* dy_f;
    const float* dy_b;
    const float* w_hh;
    const float* coef;   // [2, T*N, 5, H]
    float* dph;          // [2 parities][2, N, 3H]
    float* carry;        // [2, N, H] dht * z
    float* dpx_f;
    float* dpx_b;
    unsigned* ctr;
    int T, N, H, R;
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_f32_chain_kernel(const ChainArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, KP = round16(H3);
    const Tile tl = block_tile(N, H, kU, a.R);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;  // rows gid + 8 i, units 8 j + 2 tig + e
    float4* w = reinterpret_cast<float4*>(smem_raw);  // [KP / 4][16]: column u = W_hh[u0 + u, :]
    float4* ring = w + (size_t)KP / 4 * kU + (size_t)warp * S * kStageF4;
    {
        const float* src = a.w_hh + (size_t)tl.dir * H * H3;
        const int k4s = KP / 4;
        for (int idx = tid; idx < kU * k4s; idx += kThreads) {
            const int u = idx / k4s, k4 = idx % k4s;
            w[k4 * kU + u] = tl.u0 + u < H && 4 * k4 < H3
                                 ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(tl.u0 + u) * H3) + k4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    bool uok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) uok[j] = tl.u0 + 8 * j + 2 * tig < H;
    zero_counters<kThreads>(a.ctr, 2 * tl.RT);

    const float* dy = tl.dir == 0 ? a.dy_f : a.dy_b;
    float* dpx = tl.dir == 0 ? a.dpx_f : a.dpx_b;
    const float* cf = a.coef + (size_t)tl.dir * T * N * kNC * H;
    float* carry = a.carry + (size_t)tl.dir * N * H;
    const size_t plane = (size_t)N * H3;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? T - 1 - step : step;
        const float* dprev = a.dph + ((size_t)((step + 1) & 1) * 2 + tl.dir) * plane;
        float* dnext = a.dph + ((size_t)(step & 1) * 2 + tl.dir) * plane;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int row0 = tl.n0 + p * kPassRows + 16 * warp;
            const int valid = min(16, tl.n0 + tl.rows - row0);
            if (valid <= 0) continue;  // warp-uniform
            float2 q[2][2][kNC], g[2][2], cz[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int m = row0 + gid + 8 * i;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const bool ok = gid + 8 * i < valid && uok[j];
                    const int u = tl.u0 + 8 * j + 2 * tig;
                    const float* qp = cf + ((size_t)t * N + m) * kNC * H + u;
                    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
                    for (int e = 0; e < kNC; ++e)
                        q[i][j][e] = ok ? __ldcs(reinterpret_cast<const float2*>(qp + e * H)) : zero;
                    g[i][j] = ok ? __ldcs(reinterpret_cast<const float2*>(dy + ((size_t)t * N + m) * H + u))
                                 : zero;
                    cz[i][j] = ok && step > 0 ? *reinterpret_cast<const float2*>(carry + (size_t)m * H + u)
                                              : zero;
                }
            }
            float acc[2][4];  // n8 tile j: units 8 j .. 8 j + 7
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            if (step > 0) warp_product<2, 2, S>(acc, w, ring, dprev, H3, row0, valid, H3, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (gid + 8 * i >= valid) continue;
                const int m = row0 + gid + 8 * i;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    if (!uok[j]) continue;
                    const int u = tl.u0 + 8 * j + 2 * tig;
                    float da_r[2], da_z[2], da_c[2], dhn[2], keep[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float dh = step > 0 ? comp2(cz[i][j], e) + acc[j][2 * i + e] : 0.f;
                        const float dht = dh + comp2(g[i][j], e);
                        da_c[e] = dht * comp2(q[i][j][1], e);
                        da_z[e] = dht * comp2(q[i][j][2], e);
                        dhn[e] = da_c[e] * comp2(q[i][j][3], e);
                        da_r[e] = da_c[e] * comp2(q[i][j][4], e);
                        keep[e] = dht * comp2(q[i][j][0], e);
                    }
                    float* o = dpx + ((size_t)t * N + m) * H3 + u;
                    *reinterpret_cast<float2*>(o) = make_float2(da_r[0], da_r[1]);
                    *reinterpret_cast<float2*>(o + H) = make_float2(da_z[0], da_z[1]);
                    *reinterpret_cast<float2*>(o + 2 * H) = make_float2(da_c[0], da_c[1]);
                    float* d = dnext + (size_t)m * H3 + u;
                    *reinterpret_cast<float2*>(d) = make_float2(da_r[0], da_r[1]);
                    *reinterpret_cast<float2*>(d + H) = make_float2(da_z[0], da_z[1]);
                    *reinterpret_cast<float2*>(d + 2 * H) = make_float2(dhn[0], dhn[1]);
                    *reinterpret_cast<float2*>(carry + (size_t)m * H + u) = make_float2(keep[0], keep[1]);
                }
            }
        }
        signal_step(ctr);
    }
}

// ---------------------------------------------------------------------
// launches

// The plan's grid: 2 directions x ceil(N/R) row tiles x ceil(H/16) unit
// tiles; 0 for a plan the kernels do not take (R a multiple of 16, S of
// 3 or 4 stages).
int grid_blocks(int T, int N, int H, int R, int S) {
    if (T < 1 || N < 1 || H < 8 || H % 8 || R < 16 || R % 16 || S < 3 || S > 4) return 0;
    return 2 * ((N + R - 1) / R) * ((H + kU - 1) / kU);
}

const void* fwd_kernel(int S) {
    return S == 3 ? (const void*)gru_grid_f32_fwd_kernel<3>
                  : (const void*)gru_grid_f32_fwd_kernel<4>;
}

const void* chain_kernel(int S) {
    return S == 3 ? (const void*)gru_grid_f32_chain_kernel<3>
                  : (const void*)gru_grid_f32_chain_kernel<4>;
}

}  // namespace

extern "C" {

// Dynamic shared memory of kind 0 (the forward) or 1 (the chain) at padded
// width H with S ring stages (ops/gru.py `grid_f32_smem` counts the same).
long long ocrs_gru_grid_f32_smem(int kind, int H, int S) {
    return (long long)grid_f32_smem(kind, H, S);
}

// The forward: px_f, px_b [T, N, 3H], w_hh [2, H, 3H], b_hh [2, 3H]
// float32; scratch (any contents) hs [2, 2, N, H] and ctr [2 * ceil(N /
// R)]; out ys_f, ys_b [T, N, H]. H % 8 == 0; U (units a block, 16), R (rows
// a block, a multiple of 16) and S (ring stages, 3 or 4) from the plan. One
// cooperative launch (grid_step.cuh), then cudaGetLastError.
int ocrs_gru_grid_f32_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                          const float* b_hh, float* hs, float* ys_f, float* ys_b, unsigned* ctr,
                          int T, int N, int H, int U, int R, int S, void* stream) {
    const int blocks = grid_blocks(T, N, H, R, S);
    if (blocks == 0 || U != kU) return (int)cudaErrorInvalidValue;
    const FwdArgs args = {px_f, px_b, w_hh, b_hh, hs, ys_f, ys_b, ctr, T, N, H, R};
    return launch<kThreads>(fwd_kernel(S), device, args, blocks, grid_f32_smem(0, H, S), stream);
}

// The backward's chain: dy_f, dy_b [T, N, H]; w_hh as above; coef [2, T*N,
// 5, H] from gru_bwd.cu's f32 coefficients; scratch (any contents) dph [2,
// 2, N, 3H], carry [2, N, H] and ctr [2 * ceil(N / R)]; out dpx_f, dpx_b
// [T, N, 3H]. The plan as for the forward. One cooperative launch.
int ocrs_gru_grid_f32_chain(int device, const float* dy_f, const float* dy_b, const float* w_hh,
                            const float* coef, float* dph, float* carry, float* dpx_f,
                            float* dpx_b, unsigned* ctr, int T, int N, int H, int U, int R, int S,
                            void* stream) {
    const int blocks = grid_blocks(T, N, H, R, S);
    if (blocks == 0 || U != kU) return (int)cudaErrorInvalidValue;
    const ChainArgs args = {dy_f, dy_b, w_hh, coef, dph, carry, dpx_f, dpx_b, ctr, T, N, H, R};
    return launch<kThreads>(chain_kernel(S), device, args, blocks, grid_f32_smem(1, H, S), stream);
}

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
