// Bidirectional GRU recurrence of one layer in float32 at hidden widths
// above 512 ("the f32 grid form" of the wide route): the forward, and the
// backward's chain of dependent steps, each in ONE persistent launch over
// the whole card, the products on the tensor cores in error-compensated
// TF32 ("3xTF32"); W_hh's f32 slice resident in shared memory up to H =
// 1056, partly streamed each step above.
//
// Replaces: the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py, forward (`_fwd_call`, body
// `_fwd_kernel`) and the chain of its backward (`_bwd_call`, body
// `_bwd_kernel`), in f32 compute at the widths that no thread block cluster
// of gru_wide.cu's persistent form holds: the wrapper (ops/gru.py,
// `gru_route`, `grid_f32_plan`) sends f32 layers of padded width 512 < H <=
// 2112 (GRID_F32_MAX_HIDDEN on an H100) here, after zero-padding H to a
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
// 165 TFLOP/s: 39.0 us a step at H=2048, 10.5 at 1064.)
//
// Design: ONE cooperative launch a call (the cooperative attribute through
// cudaLaunchKernelExC): a grid that the card cannot hold at once is refused
// at launch instead of hanging in a barrier. The plan comes from the
// wrapper (ops/gru.py `grid_f32_plan`): a block owns U hidden units x R
// batch rows (a multiple of 16) of one direction; ceil(H/U) unit tiles x
// ceil(N/R) row tiles per direction, one block an SM. U = 16 up to H =
// 1056 (64 unit tiles x 2 directions = 128 blocks at H=1024, N=128), above
// it the least of 24 and 32 whose unit tiles fit the SMs: 24 up to 1584
// (90 blocks at 1064, 122 at 1448), 32 up to 2112 (128 at 2048).
// - W: the block's f32 slice of W_hh, the forward's 3U columns of W_hh (its
//   units' r, z and n columns) over the contraction H, the chain's U rows
//   of W_hh (W_hh^T's columns) over 3H, both as [k/4][columns] float4 (4
//   consecutive k of one column in 16 bytes), zero past H (the last unit
//   tile) and past the contraction (padded to 16): 12 * U * H bytes either
//   way, 196,608 at H=1024, 786,432 at 2048. Up to 1056 all of it stays in
//   shared memory for all T steps. Above, the block keeps its first KR k16
//   steps resident (loaded once) and streams the rest every step through
//   a ring of SW stages in shared memory, chunks of kFwdChunk (forward) or
//   kChainChunk (chain) k16 steps, 9-12 KB, zero past the contraction. The
//   wrapper's call first writes a device copy of every block's streamed
//   chunks in the exact layout of a stage (one launch a call,
//   `gru_grid_f32_stream_layout_kernel`), so a chunk is one contiguous
//   `cp.async.bulk` (1-D TMA) completing on its stage's mbarrier. Thread 0
//   issues the first SW chunks before the grid-wide sync; after that each
//   warp frees a stage with one arrival, and the last of the 8 (elected by
//   a counter a stage in shared memory) refills it with the chunk SW
//   further on, so that SW chunks stay in flight whichever warp runs ahead,
//   and the next pass's and step's first chunks land while the block does
//   its gate math, waits at the step barrier and multiplies its resident k
//   steps. The copies are marked evict-first in L2, so that the stream
//   (82 MB a step at 2048, more than the L2) does not push out the state
//   every block reads: on an H100 that ran 1-3% faster at 1064, 1448 and
//   2048 than copies with the default policy, all of them or as many as
//   32 MB of the L2 would hold (grid_probe --f32, PERF.md).
// - The products, 8 warps, `mma.sync.m16n8k8` tf32 -> f32 (wgmma's tf32
//   reads B from shared memory, so the hi and lo halves of W would both
//   have to be there and stream: twice the bytes; mma.sync splits a
//   fragment in registers, so a streamed byte is streamed once). In passes
//   of 128 batch rows, warp w owns the m16 tile w of the pass (rows 16 w ..
//   16 w + 15) and every n8 tile of the block's columns: the forward's 3U
//   (the r, z and n columns of its U units), the chain's U. Per k8 step a
//   lane reads its 4 A fragment values (LDS.32: the stage's swizzle puts a
//   warp's 32 reads in 32 banks) and each n8 tile's 2 B fragment values
//   (32 consecutive floats a warp), splits each x into hi, its upper 19
//   bits (a mask), and lo = x - hi, and runs three mma (a_lo b_hi, a_hi
//   b_lo, a_hi b_hi). At U=16 each product into partial sums of its own,
//   so that an mma rarely waits for the one before it; at U = 24 and 32
//   one set, which the forward's 9 or 12 n8 tiles keep busy (three sets
//   would take 108-144 accumulators a thread). The chain alternates
//   between two sets by k8 step (it has only U / 8 n8 tiles; at 24 units
//   one set of each ran its calls 3-4% faster than three sets, at 32 units
//   as fast: kernel_ab, PERF.md). The partials are added in a fixed order
//   at the end. A thread's C fragments hold rows gid and gid + 8 (gid =
//   lane / 4) and, of every n8 tile, columns 2 tig and 2 tig + 1 (tig =
//   lane % 4): in the forward all three gates of its U / 4 units, so the
//   gate math of an element runs in the thread that summed it. The
//   resident k16 steps multiply first, then the streamed ones as their
//   stages land, in the order of k.
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
//   it; the chain's at U = 24 and 32 (5 coefficients of U / 4 units x 2
//   rows: 60-80 registers) are only prefetched into L2 then and read after
//   it. The f32 state h (forward) and dht * z (chain) of an element live in
//   scratch of the call's own, read and written only by the thread that
//   owns the element; the forward's h in two buffers by step parity, [2][2,
//   N, H], which the next step's products read; the chain's dph [2][2, N,
//   3H] the same way and dht * z in [2, N, H].
// - Between steps, a counter per (direction, row tile) in device memory:
//   after its last write of a step a block adds 1 (`red.release.gpu`); a
//   block reads the previous step's state once the counter shows every unit
//   tile of its row tile done (`ld.acquire.gpu`; a counter that never
//   arrives traps after about ten seconds instead of hanging; so does a
//   ring phase). The state
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
//   ms, with the partial sums apart 8.83 / 14.50 (kept at U=16: one code
//   path then; kernel_ab, grid_probe; PERF.md).
// - Bytes against products above 1056: at U=32, H=2048 about 80% of a
//   block's 768 KB slice streams each step, 82 MB for the card, more than
//   the L2; at the 3xTF32 peak a step's products take 39 us, in which
//   device memory moves about 100 MB, so the stream fits under the products
//   where it overlaps them: hence the ring, and its chunks few and large
//   (each `cp.async.bulk` costs about a latency; gru_grid.cu, PERF.md).
// - Idle SMs: at H=1064, U=24 uses 90 of the 132 SMs (U=16 would need 134
//   blocks); the products' share of the card's tensor pipes is then 68%.
// - Shared memory: 232,448 bytes a block at most; the resident W, the ring
//   (SW stages and two mbarriers a stage) and the A rings (8 KB a stage, 8
//   warps x 1 KB): the resident plans take the most of 4 and 3 A stages
//   that fit, 4 up to H=1040 (229,376 bytes at 1024), 3 at 1048 and 1056;
//   the streamed plans 4 A stages, about 48 KB of ring (20 bytes a stage
//   of mbarriers and counter) and as many resident k16 steps as fit beside
//   them (ops/gru.py `grid_f32_split`, which counts the same bytes as
//   `grid_f32_smem` here).
// - Registers: one block an SM (`__launch_bounds__(256, 1)`, up to 255 a
//   thread): at U=16 the forward holds 72 partial sums, 24 px values and 8
//   states besides a k8 step's split fragments (223-225 registers); at U =
//   24 and 32 its 36-48 sums and the split fragments of all its n8 tiles,
//   its gate math's inputs read after the product (190 / 241 registers;
//   read before it, at 24 units, 1% slower). The chain at 32 units takes
//   255 registers with 48 bytes of spills; the biases are read from L1 for
//   the gate math.
// - Ragged shapes: rows past N are zero in the staged A (cp.async's source
//   size 0) and skipped in the gate math; a warp whose 16 rows all lie past
//   the block's rows sits the pass out (it still waits for and frees each
//   streamed chunk, so that the ring's phases stay in step); units past H
//   have zero W columns and no gate math; k past the contraction is zero
//   in both operands.
// - The step barrier costs 1.3-4.3 k cycles (gru_grid.cu's, PERF.md).
// Every sum runs in a fixed order and there are no atomics on data, so
// reruns agree bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
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
constexpr int kPassRows = 16 * kWarps; // batch rows a pass: 16 a warp
constexpr int kKC = 16;                // k of a staged chunk
constexpr int kStageF4 = 16 * kKC / 4; // float4 of a warp's stage (16 rows x 16 k)
constexpr int kNC = 5;                 // coefficients per element (gru_bwd.cu's coef)
constexpr int kFwdChunk = 2;           // k16 steps of W in a ring stage: the forward's
constexpr int kChainChunk = 6;         // the chain's

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Columns of the W slice: the forward's 3U (r, z, n of its units), the
// chain's U; its k16 steps, of H or 3H padded to 16; a ring stage's.
__host__ __device__ constexpr int w_cols(int kind, int U) { return kind == 0 ? 3 * U : U; }
__host__ __device__ constexpr int w_k16(int kind, int H) { return round16(kind == 0 ? H : 3 * H) / 16; }
__host__ __device__ constexpr int chunk_k16(int kind) { return kind == 0 ? kFwdChunk : kChainChunk; }
// Floats of a ring stage (a chunk): chunk_k16 k16 steps of w_cols columns.
__host__ __device__ constexpr int chunk_floats(int kind, int U) {
    return chunk_k16(kind) * 16 * w_cols(kind, U);
}

// Dynamic shared memory of kind 0 (forward) or 1 (chain) with U units a
// block, KR k16 steps of W resident, a ring of SW stages of W (and two
// mbarriers and a counter a stage) and S stages of each warp's A ring.
size_t grid_f32_smem(int kind, int U, int KR, int SW, int S) {
    return (size_t)4 * 16 * w_cols(kind, U) * KR + (size_t)SW * (4 * chunk_floats(kind, U) + 20) +
           (size_t)kWarps * S * kStageF4 * 16;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float comp2(const float2& v, int e) { return e == 0 ? v.x : v.y; }

// The float4 of a stage holding row r, k columns 4c .. 4c + 3 (swizzled).
__device__ __forceinline__ int stage_slot(int r, int c) { return r * 4 + (c ^ ((r >> 1) & 3)); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// ---------------------------------------------------------------------
// the ring of streamed W (above H = 1056)

// Chunk g of the call (g = product * NC + chunk, `total` of them, a product
// being one pass of one step from the second on) comes from `src` (this
// block's NC chunks, contiguous) into stage g % SW; its use of the stage
// is g / SW. Stage s is full on full[s] (the issuing thread's arrival and
// the copy's bytes) and free on empty[s] (one arrival of each warp). Thread
// 0 issues the first SW chunks; after that the last warp to free a stage
// (counted in `freed[s]`) refills it with the chunk SW further on, so that
// SW chunks stay in flight whichever warp runs ahead. No producer warp, so
// that the 8 warps keep every register.
struct WRing {
    const float* src;
    float* stage0;
    uint64_t* full;
    uint64_t* empty;
    unsigned* freed;
    uint32_t bytes;
    int NC, SW;
    unsigned total;
};

// Chunk g into its stage, whose previous use every warp has freed, marked
// evict-first in L2.
__device__ __forceinline__ void ring_issue(const WRing& r, unsigned g) {
    const unsigned s = g % (unsigned)r.SW;
    mbar_arrive_expect_tx(r.full + s, r.bytes);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(r.stage0 + (size_t)s * (r.bytes / 4));
    const float* src = r.src + (size_t)(g % (unsigned)r.NC) * (r.bytes / 4);
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(src), "r"(r.bytes), "r"(bar_addr(r.full + s)), "l"(policy) : "memory");
}

// The stage of chunk g, once it has landed.
__device__ __forceinline__ const float* ring_wait(const WRing& r, unsigned g) {
    mbar_wait(r.full + g % (unsigned)r.SW, (g / (unsigned)r.SW) & 1u);
    return r.stage0 + (size_t)(g % (unsigned)r.SW) * (r.bytes / 4);
}

// A warp is done with chunk g (every read of it has completed). The last
// of the 8 warps to free the stage waits for the others' arrivals (so that
// their reads come before the copy) and issues chunk g + SW into it.
__device__ __forceinline__ void ring_release(const WRing& r, unsigned g) {
    __syncwarp();
    if (threadIdx.x % 32 != 0) return;
    const unsigned s = g % (unsigned)r.SW;
    mbar_arrive(r.empty + s);
    if (atomicAdd(r.freed + s, 1u) % kWarps == kWarps - 1 && g + r.SW < r.total) {
        mbar_wait(r.empty + s, (g / (unsigned)r.SW) & 1u);
        ring_issue(r, g + r.SW);
    }
}

// The ring's mbarriers and counters (thread 0), made visible to the copies
// and (by the block barrier that follows in zero_counters) to the warps,
// then its first SW chunks: they depend on nothing the launch writes.
__device__ __forceinline__ void ring_start(const WRing& r) {
    if (threadIdx.x != 0 || r.SW == 0) return;
    for (int s = 0; s < r.SW; ++s) {
        mbar_init(r.full + s, 1);
        mbar_init(r.empty + s, kWarps);
        r.freed[s] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (unsigned g = 0; g < min((unsigned)r.SW, r.total); ++g) ring_issue(r, g);
}

// `kind`'s ring for this block: its chunks in the layout copy `wst` ([2
// dirs][unit tiles][NC][chunk]), its stages at `stage0`, their mbarriers
// and counters at `bars`; `products` products of NC chunks each.
__device__ __forceinline__ WRing make_ring(int kind, int U, const float* wst, const Tile& tl, int NC,
                                           int SW, float* stage0, uint64_t* bars,
                                           int products) {
    WRing r;
    const size_t chunk = (size_t)chunk_floats(kind, U);
    r.src = wst + ((size_t)tl.dir * tl.UT + tl.u0 / U) * NC * chunk;
    r.stage0 = stage0;
    r.full = bars;
    r.empty = bars + SW;
    r.freed = reinterpret_cast<unsigned*>(bars + 2 * SW);
    r.bytes = (uint32_t)(4 * chunk);
    r.NC = NC;
    r.SW = SW;
    r.total = (unsigned)(products * NC);
    return r;
}

// A warp that sits a pass out still waits for and frees each of its
// chunks, so that every stage's phases stay in step.
__device__ __forceinline__ void ring_skip(const WRing& r, unsigned g0) {
    for (int c = 0; c < r.NC; ++c) {
        ring_wait(r, g0 + c);
        ring_release(r, g0 + c);
    }
}

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
// row0 + 15][k] * W[k][8 nt .. 8 nt + 7], NT n8 tiles, W the block's slice:
// its first KR k16 steps in `w` ([4 KR][8 NT] float4), the rest in the
// ring's chunks of CK k16 steps (`g0` the first chunk of this product), A
// staged through the warp's ring `aring` of S stages (without STREAM all
// of W is resident and the ring is never touched). With SPLIT each k8
// step's three m16n8k8 tf32 products go to partial sums of their own
// (else all three to one), and with KP > 1 the k8 steps alternate between
// KP sets of them, so that SPLIT? 3 : 1 x KP x NT products are independent
// (an mma's result waits for the one before it into the same sums); the
// partials are added in a fixed order at the end.
template <int NT, int KP, bool SPLIT, bool STREAM, int S, int CK>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const float4* __restrict__ w,
                                             int KR, const WRing& ring, unsigned g0, float4* aring,
                                             const float* A, int lda, int row0, int valid, int K,
                                             int lane) {
    constexpr int WC = 8 * NT;  // float4 a k4 row of W
    constexpr int SETS = SPLIT ? 3 : 1;
    float part[KP][NT][SETS][4];
#pragma unroll
    for (int p = 0; p < KP; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int x = 0; x < SETS; ++x)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[p][nt][x][e] = 0.f;
    const int gid = lane / 4, tig = lane % 4;
    const int chunks = (K + kKC - 1) / kKC;
#pragma unroll
    for (int c = 0; c < S - 1; ++c) {
        if (c < chunks) stage_chunk(aring + c * kStageF4, A, lda, row0, valid, c, K, lane);
        else cp_async_commit();
    }
    const float* wring = nullptr;
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<S - 2>();
        __syncwarp();
        const int next = c + S - 1;
        if (next < chunks)
            stage_chunk(aring + (next % S) * kStageF4, A, lda, row0, valid, next, K, lane);
        else
            cp_async_commit();
        const float* st = reinterpret_cast<const float*>(aring + (c % S) * kStageF4);
        const int j = STREAM ? c - KR : -1;  // the streamed k16 step, if >= 0
        if (j >= 0 && j % CK == 0) wring = ring_wait(ring, g0 + j / CK);
        const float* wk = j < 0 ? reinterpret_cast<const float*>(w + (size_t)c * (kKC / 4) * WC)
                                : wring + (size_t)(j % CK) * kKC * WC;
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
                float (&pk)[NT][SETS][4] = part[k8 % KP];
                mma_tf32(pk[nt][0], a_lo, b_hi);
                mma_tf32(pk[nt][SPLIT ? 1 : 0], a_hi, b_lo);
                mma_tf32(pk[nt][SPLIT ? 2 : 0], a_hi, b_hi);
            }
        }
        if (j >= 0 && (j % CK == CK - 1 || c == chunks - 1)) ring_release(ring, g0 + j / CK);
    }
    __syncwarp();  // every lane's last reads before the ring's next fill
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float sum = 0.f;
#pragma unroll
            for (int p = 0; p < KP; ++p)
                sum += SPLIT ? part[p][nt][SETS - 1][e] + (part[p][nt][0][e] + part[p][nt][SPLIT ? 1 : 0][e])
                             : part[p][nt][0][e];
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
    const float* wst; // the streamed chunks (gru_grid_f32_stream_layout_kernel), or null
    float* hs;        // [2 parities][2, N, H] the f32 state
    float* ys_f;
    float* ys_b;
    unsigned* ctr;    // [2 * RT] step counters
    int T, N, H, R, KR, SW;
};

template <int U, int S>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_f32_fwd_kernel(const FwdArgs a) {
    constexpr int UJ = U / 8, NT = 3 * UJ, COLS = 3 * U;
    // 16 units keep all of W resident (no ring code), their three products'
    // sums apart and the gate math's inputs in registers during the
    // product; wider blocks stream part of W, keep one set of sums and
    // only prefetch those inputs into L2 then, reading them after it.
    constexpr bool kStream = U != 16, kEarly = !kStream;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, KR = a.KR, SW = a.SW;
    const int NC = SW ? (w_k16(0, H) - KR + kFwdChunk - 1) / kFwdChunk : 0;
    const Tile tl = block_tile(N, H, U, a.R);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;  // rows gid + 8 i, units 8 j + 2 tig + e
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    // [4 KR][3U]: column g U + u = W[:, g H + u0 + u]; then the ring's
    // stages, the warps' A rings and the ring's mbarriers.
    float4* w = reinterpret_cast<float4*>(smem_raw);
    float4* wring = w + (size_t)4 * KR * COLS;
    float4* arings = wring + (size_t)SW * chunk_floats(0, U) / 4;
    float4* aring = arings + (size_t)warp * S * kStageF4;
    WRing ring = make_ring(0, U, a.wst, tl, NC, SW, reinterpret_cast<float*>(wring),
                           reinterpret_cast<uint64_t*>(arings + (size_t)kWarps * S * kStageF4),
                           (T - 1) * passes);
    ring_start(ring);
    {
        const float* src = a.w_hh + (size_t)tl.dir * H * H3;
        float* wf = reinterpret_cast<float*>(w);
        for (int idx = tid; idx < 16 * KR * COLS; idx += kThreads) {
            const int k = idx / COLS, col = idx % COLS, u = tl.u0 + col % U;
            const float v = k < H && u < H ? src[(size_t)k * H3 + (col / U) * H + u] : 0.f;
            wf[((k >> 2) * COLS + col) * 4 + (k & 3)] = v;
        }
    }
    // Units are a multiple of 8 from u0 (H % 8 == 0), so a pair 2 tig, 2
    // tig + 1 lies wholly inside or past H.
    bool uok[UJ];
#pragma unroll
    for (int j = 0; j < UJ; ++j) uok[j] = tl.u0 + 8 * j + 2 * tig < H;
    zero_counters<kThreads>(a.ctr, 2 * tl.RT);

    const float* px = tl.dir == 0 ? a.px_f : a.px_b;
    const float* bh = a.b_hh + tl.dir * H3;
    float* ys = tl.dir == 0 ? a.ys_f : a.ys_b;
    const size_t plane = (size_t)N * H;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? step : T - 1 - step;
        const float* hprev = a.hs + ((size_t)((step + 1) & 1) * 2 + tl.dir) * plane;
        float* hnext = a.hs + ((size_t)(step & 1) * 2 + tl.dir) * plane;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int row0 = tl.n0 + p * kPassRows + 16 * warp;  // the warp's first row
            const int valid = min(16, tl.n0 + tl.rows - row0);
            const unsigned g0 = (unsigned)((step - 1) * passes + p) * NC;
            if (valid <= 0) {  // warp-uniform
                if (kStream && step > 0) ring_skip(ring, g0);
                continue;
            }
            // The gate math's inputs: rows gid + 8 i, units u0 + 8 j + 2 tig + e.
            float2 x[2][3][UJ], hp[2][UJ];
            auto load = [&]() {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int m = row0 + gid + 8 * i;
#pragma unroll
                    for (int j = 0; j < UJ; ++j) {
                        const bool ok = gid + 8 * i < valid && uok[j];
                        const int u = tl.u0 + 8 * j + 2 * tig;
                        const float* pr = px + ((size_t)t * N + m) * H3 + u;
#pragma unroll
                        for (int g = 0; g < 3; ++g)
                            x[i][g][j] = ok ? __ldcs(reinterpret_cast<const float2*>(pr + g * H))
                                            : make_float2(0.f, 0.f);
                        hp[i][j] = ok && step > 0
                                       ? *reinterpret_cast<const float2*>(hprev + (size_t)m * H + u)
                                       : make_float2(0.f, 0.f);
                    }
                }
            };
            if (kEarly) {
                load();
            } else if (tig == 0) {  // the 4 lanes of a row's 8 units read one 32-byte sector
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int m = row0 + gid + 8 * i;
#pragma unroll
                    for (int j = 0; j < UJ; ++j) {
                        if (gid + 8 * i >= valid || !uok[j]) continue;
                        const float* pr = px + ((size_t)t * N + m) * H3 + tl.u0 + 8 * j;
#pragma unroll
                        for (int g = 0; g < 3; ++g) prefetch_l2(pr + g * H);
                    }
                }
            }
            float acc[NT][4];  // n8 tile g UJ + j: gate g of units 8 j .. 8 j + 7
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
            if (step > 0)
                warp_product<NT, 1, !kStream, kStream, S, kFwdChunk>(acc, w, KR, ring, g0, aring, hprev, H,
                                                           row0, valid, H, lane);
            if (!kEarly) load();
#pragma unroll
            for (int j = 0; j < UJ; ++j) {
                if (!uok[j]) continue;
                const int u = tl.u0 + 8 * j + 2 * tig;
                float2 b[3];
#pragma unroll
                for (int g = 0; g < 3; ++g) b[g] = io::ldg2(bh + g * H + u);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    if (gid + 8 * i >= valid) continue;
                    const int m = row0 + gid + 8 * i;
                    float h[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float r = sigmoid(comp2(x[i][0][j], e) + (acc[j][2 * i + e] + comp2(b[0], e)));
                        const float z = sigmoid(comp2(x[i][1][j], e) + (acc[UJ + j][2 * i + e] + comp2(b[1], e)));
                        const float c = tanhf(comp2(x[i][2][j], e) + r * (acc[2 * UJ + j][2 * i + e] + comp2(b[2], e)));
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
    const float* wst;    // the streamed chunks, or null
    float* dph;          // [2 parities][2, N, 3H]
    float* carry;        // [2, N, H] dht * z
    float* dpx_f;
    float* dpx_b;
    unsigned* ctr;
    int T, N, H, R, KR, SW;
};

template <int U, int S>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_f32_chain_kernel(const ChainArgs a) {
    constexpr int UJ = U / 8, NT = UJ;
    // 16 units keep all of W resident (no ring code), their three products'
    // sums apart and the gate math's inputs in registers during the
    // product; wider blocks stream part of W, keep one set of sums and
    // only prefetch those inputs into L2 then, reading them after it.
    constexpr bool kStream = U != 16, kEarly = !kStream;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, KR = a.KR, SW = a.SW;
    const int NC = SW ? (w_k16(1, H) - KR + kChainChunk - 1) / kChainChunk : 0;
    const Tile tl = block_tile(N, H, U, a.R);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;  // rows gid + 8 i, units 8 j + 2 tig + e
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    float4* w = reinterpret_cast<float4*>(smem_raw);  // [4 KR][U]: column u = W_hh[u0 + u, :]
    float4* wring = w + (size_t)4 * KR * U;
    float4* arings = wring + (size_t)SW * chunk_floats(1, U) / 4;
    float4* aring = arings + (size_t)warp * S * kStageF4;
    WRing ring = make_ring(1, U, a.wst, tl, NC, SW, reinterpret_cast<float*>(wring),
                           reinterpret_cast<uint64_t*>(arings + (size_t)kWarps * S * kStageF4),
                           (T - 1) * passes);
    ring_start(ring);
    {
        const float* src = a.w_hh + (size_t)tl.dir * H * H3;
        const int k4s = 4 * KR;
        for (int idx = tid; idx < U * k4s; idx += kThreads) {
            const int u = idx / k4s, k4 = idx % k4s;
            w[k4 * U + u] = tl.u0 + u < H && 4 * k4 < H3
                                ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(tl.u0 + u) * H3) + k4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    bool uok[UJ];
#pragma unroll
    for (int j = 0; j < UJ; ++j) uok[j] = tl.u0 + 8 * j + 2 * tig < H;
    zero_counters<kThreads>(a.ctr, 2 * tl.RT);

    const float* dy = tl.dir == 0 ? a.dy_f : a.dy_b;
    float* dpx = tl.dir == 0 ? a.dpx_f : a.dpx_b;
    const float* cf = a.coef + (size_t)tl.dir * T * N * kNC * H;
    float* carry = a.carry + (size_t)tl.dir * N * H;
    const size_t plane = (size_t)N * H3;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? T - 1 - step : step;
        const float* dprev = a.dph + ((size_t)((step + 1) & 1) * 2 + tl.dir) * plane;
        float* dnext = a.dph + ((size_t)(step & 1) * 2 + tl.dir) * plane;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int row0 = tl.n0 + p * kPassRows + 16 * warp;
            const int valid = min(16, tl.n0 + tl.rows - row0);
            const unsigned g0 = (unsigned)((step - 1) * passes + p) * NC;
            if (valid <= 0) {  // warp-uniform
                if (kStream && step > 0) ring_skip(ring, g0);
                continue;
            }
            float2 q[2][UJ][kNC], g[2][UJ], cz[2][UJ];
            const float2 zero = make_float2(0.f, 0.f);
            // Rows gid + 8 i, units u0 + 8 j + 2 tig + e.
            auto load = [&]() {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int m = row0 + gid + 8 * i;
#pragma unroll
                    for (int j = 0; j < UJ; ++j) {
                        const bool ok = gid + 8 * i < valid && uok[j];
                        const int u = tl.u0 + 8 * j + 2 * tig;
                        const float* qp = cf + ((size_t)t * N + m) * kNC * H + u;
#pragma unroll
                        for (int e = 0; e < kNC; ++e)
                            q[i][j][e] = ok ? __ldcs(reinterpret_cast<const float2*>(qp + e * H)) : zero;
                        g[i][j] = ok ? __ldcs(reinterpret_cast<const float2*>(dy + ((size_t)t * N + m) * H + u))
                                     : zero;
                        cz[i][j] = ok && step > 0 ? *reinterpret_cast<const float2*>(carry + (size_t)m * H + u)
                                                  : zero;
                    }
                }
            };
            if (kEarly) {
                load();
            } else if (tig == 0) {  // the 4 lanes of a row's 8 units read one 32-byte sector
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int m = row0 + gid + 8 * i;
#pragma unroll
                    for (int j = 0; j < UJ; ++j) {
                        if (gid + 8 * i >= valid || !uok[j]) continue;
                        const int u = tl.u0 + 8 * j;
                        const float* qp = cf + ((size_t)t * N + m) * kNC * H + u;
#pragma unroll
                        for (int e = 0; e < kNC; ++e) prefetch_l2(qp + e * H);
                        prefetch_l2(dy + ((size_t)t * N + m) * H + u);
                    }
                }
            }
            float acc[NT][4];  // n8 tile j: units 8 j .. 8 j + 7
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            if (step > 0)
                warp_product<NT, 2, !kStream, kStream, S, kChainChunk>(acc, w, KR, ring, g0, aring, dprev, H3,
                                                           row0, valid, H3, lane);
            if (!kEarly) load();
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (gid + 8 * i >= valid) continue;
                const int m = row0 + gid + 8 * i;
#pragma unroll
                for (int j = 0; j < UJ; ++j) {
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
// the streamed chunks' layout

// Every block's streamed chunks of its W slice, [2 dirs][unit tiles][NC][a
// chunk's floats], each chunk in its ring stage's layout, [4 chunk_k16(kind)
// k4 rows][w_cols(kind, U) columns] float4 with k counted from the chunk's
// first k16 step, 16 (KR + chunk_k16(kind) c): kind 0 the forward's column
// g U + u = W[k][g H + u0 + u], kind 1 the chain's column u = W[u0 + u][k];
// zero past H and past the contraction.
__global__ void __launch_bounds__(kThreads) gru_grid_f32_stream_layout_kernel(
    const float* __restrict__ w_hh, float* __restrict__ out, int H, int U, int KR, int NC, int kind) {
    const int H3 = 3 * H, UT = (H + U - 1) / U, cols = w_cols(kind, U);
    const size_t elems = (size_t)chunk_floats(kind, U);
    const size_t total = (size_t)2 * UT * NC * elems;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        const size_t e = i % elems, rest = i / elems;
        const int c = (int)(rest % NC), ut = (int)(rest / NC % UT), dir = (int)(rest / NC / UT);
        const int col = (int)(e / 4 % cols);
        const int k = 16 * (KR + chunk_k16(kind) * c) + 4 * (int)(e / (4 * cols)) + (int)(e % 4);
        const float* W = w_hh + (size_t)dir * H * H3;
        float v = 0.f;
        if (kind == 0) {
            const int u = ut * U + col % U;
            if (k < H && u < H) v = W[(size_t)k * H3 + (col / U) * H + u];
        } else {
            const int u = ut * U + col;
            if (k < H3 && u < H) v = W[(size_t)u * H3 + k];
        }
        out[i] = v;
    }
}

// ---------------------------------------------------------------------
// launches

// The plan's grid: 2 directions x ceil(N/R) row tiles x ceil(H/U) unit
// tiles; 0 for a plan the kernels do not take (U of 16, 24 and 32, R a
// multiple of 16, S of 3 or 4 stages at U=16 and 4 above; U=16 keeps all
// of W resident).
int grid_blocks(int T, int N, int H, int U, int R, int S, int SW) {
    if (T < 1 || N < 1 || H < 8 || H % 8 || R < 16 || R % 16) return 0;
    if (!(U == 16 ? (S == 3 || S == 4) && SW == 0 : (U == 24 || U == 32) && S == 4)) return 0;
    return 2 * ((N + R - 1) / R) * ((H + U - 1) / U);
}

// The streamed chunks of kind's split: KR resident k16 steps of KS and a
// ring of SW stages (0: all resident, KR == KS), or -1 for a split the
// kernels do not take.
int stream_chunks(int kind, int H, int KR, int SW) {
    const int KS = w_k16(kind, H);
    if (SW == 0) return KR == KS ? 0 : -1;
    if (SW < 2 || KR < 0 || KR >= KS) return -1;
    return (KS - KR + chunk_k16(kind) - 1) / chunk_k16(kind);
}

#define F32_KERNEL(name, U, S) (const void*)name<U, S>

const void* fwd_kernel(int U, int S) {
    if (U == 16) return S == 3 ? F32_KERNEL(gru_grid_f32_fwd_kernel, 16, 3)
                               : F32_KERNEL(gru_grid_f32_fwd_kernel, 16, 4);
    return U == 24 ? F32_KERNEL(gru_grid_f32_fwd_kernel, 24, 4)
                   : F32_KERNEL(gru_grid_f32_fwd_kernel, 32, 4);
}

const void* chain_kernel(int U, int S) {
    if (U == 16) return S == 3 ? F32_KERNEL(gru_grid_f32_chain_kernel, 16, 3)
                               : F32_KERNEL(gru_grid_f32_chain_kernel, 16, 4);
    return U == 24 ? F32_KERNEL(gru_grid_f32_chain_kernel, 24, 4)
                   : F32_KERNEL(gru_grid_f32_chain_kernel, 32, 4);
}

#undef F32_KERNEL

// The streamed chunks of `kind` into `wst` (of `wst_len` floats, refused
// if too short), one launch; nothing where the plan streams none.
int write_stream(int kind, const float* w_hh, float* wst, long long wst_len, int H, int U, int KR,
                 int NC, cudaStream_t stream) {
    if (NC == 0) return 0;
    const size_t total = (size_t)2 * ((H + U - 1) / U) * NC * chunk_floats(kind, U);
    if (wst == nullptr || wst_len < (long long)total) return (int)cudaErrorInvalidValue;
    const int blocks = (int)std::min((total + kThreads - 1) / kThreads, (size_t)132 * 16);
    gru_grid_f32_stream_layout_kernel<<<blocks, kThreads, 0, stream>>>(w_hh, wst, H, U, KR, NC, kind);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of kind 0 (the forward) or 1 (the chain) with U
// units a block, KR k16 steps of W resident, a W ring of SW stages and A
// rings of S stages (ops/gru.py `grid_f32_kernel_smem` counts the same).
long long ocrs_gru_grid_f32_smem(int kind, int U, int KR, int SW, int S) {
    return (long long)grid_f32_smem(kind, U, KR, SW, S);
}

// The forward: px_f, px_b [T, N, 3H], w_hh [2, H, 3H], b_hh [2, 3H]
// float32; scratch (any contents) hs [2, 2, N, H] and ctr [2 * ceil(N /
// R)], and where the plan streams part of W (SW > 0) wst, wst_len floats
// (ops/gru.py `grid_f32_stream_elems`); out ys_f, ys_b [T, N, H]. H % 8 ==
// 0; U (units a block: 16, 24 or 32), R (rows a block, a multiple of 16),
// S (A ring stages), KR (resident k16 steps) and SW (W ring stages) from
// the plan. The streamed chunks' layout (one launch, where SW > 0), then
// one cooperative launch (grid_step.cuh), then cudaGetLastError.
int ocrs_gru_grid_f32_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                          const float* b_hh, float* hs, float* ys_f, float* ys_b, unsigned* ctr,
                          float* wst, long long wst_len, int T, int N, int H, int U, int R, int S,
                          int KR, int SW, void* stream) {
    const int blocks = grid_blocks(T, N, H, U, R, S, SW), NC = stream_chunks(0, H, KR, SW);
    if (blocks == 0 || NC < 0) return (int)cudaErrorInvalidValue;
    {
        const RestoreDevice restore_device;
        int rc = (int)cudaSetDevice(device);
        if (rc == 0) rc = write_stream(0, w_hh, wst, wst_len, H, U, KR, NC, (cudaStream_t)stream);
        if (rc != 0) return rc;
    }
    const FwdArgs args = {px_f, px_b, w_hh, b_hh, wst, hs, ys_f, ys_b, ctr, T, N, H, R, KR, SW};
    return launch<kThreads>(fwd_kernel(U, S), device, args, blocks, grid_f32_smem(0, U, KR, SW, S),
                            stream);
}

// The backward's chain: dy_f, dy_b [T, N, H]; w_hh as above; coef [2, T*N,
// 5, H] from gru_bwd.cu's f32 coefficients; scratch (any contents) dph [2,
// 2, N, 3H], carry [2, N, H] and ctr [2 * ceil(N / R)], and wst as for the
// forward; out dpx_f, dpx_b [T, N, 3H]. The plan as for the forward. The
// streamed chunks' layout where SW > 0, then one cooperative launch.
int ocrs_gru_grid_f32_chain(int device, const float* dy_f, const float* dy_b, const float* w_hh,
                            const float* coef, float* dph, float* carry, float* dpx_f,
                            float* dpx_b, unsigned* ctr, float* wst, long long wst_len, int T,
                            int N, int H, int U, int R, int S, int KR, int SW, void* stream) {
    const int blocks = grid_blocks(T, N, H, U, R, S, SW), NC = stream_chunks(1, H, KR, SW);
    if (blocks == 0 || NC < 0) return (int)cudaErrorInvalidValue;
    {
        const RestoreDevice restore_device;
        int rc = (int)cudaSetDevice(device);
        if (rc == 0) rc = write_stream(1, w_hh, wst, wst_len, H, U, KR, NC, (cudaStream_t)stream);
        if (rc != 0) return rc;
    }
    const ChainArgs args = {dy_f, dy_b, w_hh, coef, wst, dph, carry, dpx_f, dpx_b, ctr,
                            T, N, H, R, KR, SW};
    return launch<kThreads>(chain_kernel(U, S), device, args, blocks, grid_f32_smem(1, U, KR, SW, S),
                            stream);
}

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
