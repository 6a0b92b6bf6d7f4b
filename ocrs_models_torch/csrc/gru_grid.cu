// Bidirectional GRU recurrence of one layer in bfloat16 at hidden widths
// above 512 ("the grid form" of the wide route): the forward, and the
// backward's chain of dependent steps, each in ONE persistent launch over
// the whole card, their products on the tensor cores.
//
// Replaces: the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py, forward (`_fwd_call`, body
// `_fwd_kernel`) and the chain of its backward (`_bwd_call`, body
// `_bwd_kernel`), in bf16 compute at the widths that no thread block
// cluster of gru_wide.cu's persistent form holds (padded H > 512). The
// wrapper (ops/gru.py, `gru_route`, `grid_plan`) sends bf16 layers of
// padded width 512 < H <= 1440 here, after zero-padding H to a multiple of
// 8; f32, and bf16 above 1440, keep gru_wide.cu's kernels of one launch a
// step. The backward's other phases, the coefficients before the chain and
// the dW/db reduction after it, are gru_bwd.cu's bf16 entries.
//
// Contract and rounding points, those of gru_wide.cu's bf16 entries (the
// Pallas kernel's): px_f, px_b [T, N, 3H] bf16 are x @ W_ih + b_ih per
// direction in natural time order (the backward direction reads step
// T-1-i); w_hh [2, H, 3H] float32 holding bf16 values (for h @ W), b_hh
// [2, 3H] float32; gate order r, z, n with n = tanh(xn + r * (W_hn h +
// b_hn)), gate math in f32. The forward carries the state h in f32,
// multiplies bf16(h) by bf16(W_hh) with f32 sums, adds the f32 b_hh and
// writes ys = bf16(h). The chain multiplies bf16(dph) by bf16(W_hh)^T with
// f32 sums, carries dht * z in f32, writes dpx = bf16([da_r, da_z, da_c]),
// bf16(dhn) [2, T*N, H] for gru_bwd.cu's bf16 dW phase, and db's partials
// [batch tiles, 2, 3H] summed from the unrounded dph.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
// HBM). At T=257, N=128, H=1024 the forward multiplies [N,H] x [H,3H] per
// step and direction: 2 * 257 * 2*128*1024*3072 = 413.9 GFLOP, 0.419 ms;
// its bytes (px read, ys written once, bf16) are 0.27 GB, 0.08 ms. The
// whole backward (the coefficients' and dW's products beside the chain's)
// is three times the operations, 1.256 ms. Operations bound both on paper;
// in practice the T dependent steps do: a step's product is too small to
// fill the card, and each step must wait for every block's previous one.
//
// Design: ONE cooperative launch a call (the cooperative attribute through
// cudaLaunchKernelExC): a grid that the card cannot hold at once is
// refused at launch instead of hanging in a barrier. The plan, (U, R),
// comes from the wrapper (ops/gru.py `grid_plan`, which also picks this
// form: chosen before the launch, by width, dtype, batch and the card's SM
// count and shared memory): a block owns U hidden units (32, or 24 above H
// = 1072) x R batch rows (a multiple of 16) of one direction; ceil(H/U)
// unit tiles x ceil(N/R) row tiles per direction, at most one block an SM
// (two directions of 32 x 2 blocks at H=1024, N=128).
// - W: the block loads its bf16 slice of W_hh once into shared memory and
//   keeps it for all T steps: the forward's 3U rows (its units' r, z, n
//   columns of W_hh) of H, in wgmma's K-major layout of 8 x 8 core
//   matrices (128 contiguous bytes each, no swizzle); the chain's U rows
//   (its units' rows of W_hh, i.e. W_hh^T's columns) of 3H, rows padded to
//   an odd multiple of 16 bytes so that `ldmatrix` reads 8 rows in 8 bank
//   groups; 6 * U * H bytes either way.
// - The products, in passes of 64 batch rows, 8 warps. Forward:
//   `wgmma.mma_async` m64n(3U)k16 bf16 -> f32, A from registers, B from
//   shared memory by descriptor; warp w holds the m16 tile w % 4 of the
//   pass, warpgroup w / 4 takes the k16 steps of that parity (its "k
//   group"). Chain (N = U, too narrow for wgmma to pay for its fences):
//   `mma.sync.m16n8k16` bf16 -> f32 (mma_bf16.cuh); warp w takes the m16
//   tiles 2 (w % 2) and the next, whose products share each B fragment,
//   and the k16 steps congruent to w / 2 mod 4. The k groups' partial sums
//   meet in shared memory and are added in k-group order.
// - The A operand, what the previous step wrote for the block's rows:
//   bf16(h) (forward) or bf16(dph) (chain), K = H or 3H. The gate math
//   that makes it also writes it to scratch of the call's own in device
//   memory in the order of mma's A fragments, [2 step parities][ceil(N/16)
//   m16 tiles][K/16 k16 steps][32 lanes][4 x 32 bits] per direction: the
//   thread that owns an element pair of the gate math writes it into the
//   fragment of the lane with its own lane index (the accumulator and A
//   layouts line up, and wgmma's A registers are mma's), and a warp reads a
//   whole fragment per k16 step as one 16-byte load a lane (`ld.global.cg`:
//   from L2, never a stale L1), the next batch of k16 steps loading while
//   one multiplies (forward: 4 steps; chain: 2 of each tile). No shared
//   memory ring and no block barrier inside the product.
// - The gate math runs on the accumulator fragments: a thread owns 2 units
//   x 2 rows of up to two unit groups (forward) or 2 units x 4 rows of one
//   (chain); its loads (px, or the coefficients and dy, and the f32 state)
//   are issued together before the product.
//   The f32 state h (forward) and dht * z (chain) of an element live in
//   scratch of the call's own, [2, N, H], read and written only by the
//   thread that owns the element, so any batch runs in passes with bounded
//   registers. The chain sums its db partials per column over a warp's
//   rows by shuffles, then over the steps in registers, then over its two
//   warps of a unit group in m-tile order.
// - Between steps, a counter per (direction, row tile) in device memory:
//   after its last write of a step a block adds 1 (`red.release.gpu`); a
//   block reads the previous step's fragments once the counter shows every
//   unit tile of its row tile done (`ld.acquire.gpu`; a counter that never
//   arrives traps after about ten seconds instead of hanging). Fragments
//   alternate between two buffers by step parity: one is rewritten only
//   after every block of the row tile has passed the next barrier. The
//   counters are scratch of the call's own (torch.empty), zeroed by block 0
//   before one grid-wide sync (cooperative_groups) at the start.
// Every sum runs in a fixed order and there are no atomics on data, so
// reruns agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "device_guard.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace tc;
using io::bf16;

constexpr int kPassRows = 64;                 // batch rows a pass multiplies
constexpr int kMT = kPassRows / 16;           // its m16 tiles, one a warp of a k group
constexpr int kThreads = 256;                 // 8 warps: 4 m16 tiles x 2 k groups
constexpr int kFwdBatch = 4;                  // A fragments a forward warp loads at once (k16 steps)
constexpr int kChainAhead = 2;                // the chain's A fragments loaded ahead, each tile
constexpr int kNC = 5;                        // coefficients per element (gru_bwd.cu's coef)
// Shared memory where the k groups' partial sums meet, [k groups][warps of
// a k group][slots][32 lanes] float4, a slot one n8 tile of one m16 tile
// handed to another group: the forward's 2 k groups x 4 warps x (2 unit
// groups x 3 gates); the chain's 4 k groups x 2 warps x (3 unit groups x
// 2 m16 tiles).
constexpr int kFwdSlots = 6;
constexpr int kChainSlots = 6;
constexpr int kFwdXchg = 2 * kMT * kFwdSlots * 32 * 16;
constexpr int kChainXchg = 4 * 2 * kChainSlots * 32 * 16;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The forward's W slice of n rows (output columns) and contraction K in
// shared memory, bf16 in wgmma's K-major layout without swizzle: 8 x 8
// "core matrices" (8 rows of 8 consecutive k, 128 contiguous bytes), the
// n/8 of each 8 k side by side, k chunk after k chunk: row c, column k at
// element ((k / 8) (n / 8) + c / 8) 64 + (c % 8) 8 + k % 8, K padded to
// the k16 steps with zeros.
__device__ __forceinline__ int w_index(int c, int k, int n_groups) {
    return (((k >> 3) * n_groups + (c >> 3)) << 6) + ((c & 7) << 3) + (k & 7);
}

// bf16 row stride of the chain's W slice (rows for ldmatrix), whose
// contraction is K: past the k16 steps by 8, an odd multiple of 16 bytes,
// so that ldmatrix reads 8 rows in 8 bank groups.
__host__ __device__ constexpr int w_stride(int K) { return round16(K) + 8; }

size_t fwd_smem(int H, int U) { return 2 * (size_t)3 * U * round16(H) + kFwdXchg; }

size_t chain_smem(int H, int U) { return 2 * (size_t)U * w_stride(3 * H) + kChainXchg; }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float4 frag4(const float (&c)[4]) { return make_float4(c[0], c[1], c[2], c[3]); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float2 as2(uint32_t v) { return make_float2(lo_bf16(v), hi_bf16(v)); }

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Orders this thread's shared-memory writes before later reads of them by
// wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps a register live, unmoved, up to this point: an operand of an
// asynchronous wgmma must not be reused before the wait that ends it.
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// The shared-memory descriptor of a K-major W slice (no swizzle) at byte
// address `addr`: `lbo` bytes between its two 8-k halves of a k16 step,
// `sbo` bytes between its 8-row groups.
__device__ __forceinline__ uint64_t w_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

// wgmma.mma_async m64nNk16 for the forward's N = 3U (96 or 72), A from
// registers (mma.sync's A fragment layout, one m16 tile a warp of the
// warpgroup), B from shared memory by descriptor, f32 accumulators in
// mma.sync's C layout, one n8 tile after another; D += A B.
template <int N>
struct Wgmma;

template <>
struct Wgmma<96> {
    __device__ __forceinline__ static void mma(float (&d)[12][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<72> {
    __device__ __forceinline__ static void mma(float (&d)[9][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};


// This block's step is written: one more on its (direction, row tile)'s
// counter, after every thread's writes (release at GPU scope).
__device__ __forceinline__ void signal_step(unsigned* ctr) {
    __syncthreads();
    if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
}

// Wait until the counter reaches `target`, with the signalling blocks'
// writes visible to every thread of this block after it.
__device__ __forceinline__ void wait_steps(const unsigned* ctr, unsigned target) {
    if (threadIdx.x == 0) {
        const long long start = clock64();
        unsigned v;
        do {
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
            if (v < target && clock64() - start > (1ll << 34)) __trap();
        } while (v < target);
    }
    __syncthreads();
}

// The block's place in the grid: blockIdx.x = (dir * RT + row tile) * UT +
// unit tile.
struct Tile {
    int dir, rt, u0, n0, rows, UT, RT;
};

__device__ __forceinline__ Tile block_tile(int N, int H, int U, int R) {
    Tile t;
    t.UT = (H + U - 1) / U;
    t.RT = (N + R - 1) / R;
    int b = blockIdx.x;
    t.dir = b / (t.UT * t.RT);
    b %= t.UT * t.RT;
    t.rt = b / t.UT;
    t.u0 = (b % t.UT) * U;
    t.n0 = t.rt * R;
    t.rows = min(R, N - t.n0);
    return t;
}

// Where the element pair (row r, columns k, k + 1; k even) of an A operand
// with KS k16 steps sits in its fragment buffer, in 32-bit words: m16 tile
// r / 16, k16 step k / 16, lane (r % 8) * 4 + (k % 8) / 2, register (r % 16
// >= 8) + 2 (k % 16 >= 8).
__device__ __forceinline__ size_t frag_word(int r, int k, int KS) {
    return (((size_t)(r / 16) * KS + k / 16) * 32 + (r % 8) * 4 + (k % 8) / 2) * 4 +
           ((r % 16) / 8 + 2 * ((k % 16) / 8));
}

// The warpgroup's product (warps 4 kg .. 4 kg + 3, m16 tile w % 4 each):
// the A fragments of this warp's tile, `frag` ([KS][32] uint4; zero where
// the tile holds no batch row, `rows`), at the k16 steps kg, kg + 2, ...,
// times the W slice at shared address `w` (8 NT rows, wgmma's layout),
// into acc, one wgmma m64n(8 NT)k16 a step. The upper half of the last
// k16 step is zero where K is not a multiple of 16 (`pad`). In batches of
// `Batch` steps, the next batch's fragments loading while this one's
// products run; wgmma.fence waits for every pending load into a register,
// so they are issued after the products. Every warp of both warpgroups
// runs the same number of steps (a step past KS multiplies zeros): control
// flow that ptxas cannot prove uniform in the warpgroup serialises wgmma.
template <int NT, int Batch>
__device__ __forceinline__ void wg_product(float (&acc)[NT][4], const uint4* frag, bool rows, int KS,
                                           int kg, bool pad, uint32_t w) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const int nk = (KS + 1) / 2;  // k16 steps of either k group, rounded up
    const uint32_t lbo = (uint32_t)NT * 128, sbo = 128;
    const auto load = [&](uint32_t (&a)[Batch][4], int i0) {
#pragma unroll
        for (int d = 0; d < Batch; ++d) {
            const int ks = kg + 2 * (i0 + d);
            const uint4 v = rows && ks < KS ? __ldcg(frag + (size_t)ks * 32 + lane)
                                            : make_uint4(0u, 0u, 0u, 0u);
            const bool hi = !(pad && ks == KS - 1);
            a[d][0] = v.x;
            a[d][1] = v.y;
            a[d][2] = hi ? v.z : 0u;
            a[d][3] = hi ? v.w : 0u;
        }
    };
    uint32_t cur[Batch][4], nxt[Batch][4];
    load(cur, 0);
#pragma unroll 1
    for (int i0 = 0; i0 < nk; i0 += Batch) {
        // Every input register of the batch's products is set before its
        // fence: ptxas serialises products whose inputs are set between
        // them.
        uint64_t desc[Batch];
#pragma unroll
        for (int d = 0; d < Batch; ++d)
            desc[d] = w_desc(w + (uint32_t)min(kg + 2 * (i0 + d), KS - 1) * 2 * lbo, lbo, sbo);
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < Batch; ++d) Wgmma<8 * NT>::mma(acc, cur[d], desc[d]);
        wgmma_commit();
        load(nxt, i0 + Batch);
        wgmma_wait_all();
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int f = 0; f < 4; ++f) keep(acc[t][f]);
#pragma unroll
        for (int d = 0; d < Batch; ++d)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                keep(cur[d][r]);
                cur[d][r] = nxt[d][r];
            }
    }
}

// The warp's product: the A fragments of its MW m16 tiles (`frag`, each
// [KS][32] uint4, tile i at frag + i * KS * 32; the first `mw` of them
// exist) at the k16 steps kg, kg + KG, ... times the W slice `w` (rows of
// stride ws; n8 tile t at rows brow(t)), into acc. The upper half of the
// last k16 step is zero where K is not a multiple of 16 (`pad`). The
// fragments of the next `Ahead` steps load while the warp multiplies
// `Ahead` steps; each B fragment serves all MW tiles.
template <int MW, int NT, int KG, int Ahead, class Rows>
__device__ __forceinline__ void warp_product(float (&acc)[MW][NT][4], const uint4* frag, int mw,
                                             int KS, int kg, bool pad, const bf16* w, int ws,
                                             const Rows& brow) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;
    const int nk = (KS - kg + KG - 1) / KG;  // this k group's k16 steps
    const size_t tile = (size_t)KS * 32;
    uint32_t b_lane[(NT + 1) / 2];  // this lane's ldmatrix row of each pair of B tiles
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
        const int row = (lane < 16 || t + 1 >= NT ? brow(t) : brow(t + 1)) + lane % 8;
        b_lane[t / 2] = smem_u32(w + (size_t)row * ws + ((lane / 8) % 2) * 8);
    }
    uint4 cur[Ahead][MW], nxt[Ahead][MW];
#pragma unroll
    for (int d = 0; d < Ahead; ++d)
#pragma unroll
        for (int i = 0; i < MW; ++i)
            if (d < nk && i < mw) cur[d][i] = __ldcg(frag + i * tile + (size_t)(kg + KG * d) * 32 + lane);
#pragma unroll 1
    for (int i0 = 0; i0 < nk; i0 += Ahead) {
#pragma unroll
        for (int d = 0; d < Ahead; ++d)
#pragma unroll
            for (int i = 0; i < MW; ++i)
                if (i0 + Ahead + d < nk && i < mw)
                    nxt[d][i] = __ldcg(frag + i * tile + (size_t)(kg + KG * (i0 + Ahead + d)) * 32 + lane);
#pragma unroll
        for (int d = 0; d < Ahead; ++d) {
            const int ks = kg + KG * (i0 + d);
            if (i0 + d < nk) {
                const uint32_t koff = 32u * ks;  // bytes of 16 bf16
                uint32_t b[NT][2];
#pragma unroll
                for (int t = 0; t < NT; t += 2) {
                    if (t + 1 < NT) {
                        uint32_t r[4];
                        ldmatrix_x4(r, b_lane[t / 2] + koff);
                        b[t][0] = r[0];
                        b[t][1] = r[1];
                        b[t + 1][0] = r[2];
                        b[t + 1][1] = r[3];
                    } else {
                        ldmatrix_x2(b[t], b_lane[t / 2] + koff);
                    }
                }
#pragma unroll
                for (int i = 0; i < MW; ++i) {
                    if (i < mw) {
                        uint32_t a[4] = {cur[d][i].x, cur[d][i].y, cur[d][i].z, cur[d][i].w};
                        if (pad && ks == KS - 1) a[2] = a[3] = 0u;
#pragma unroll
                        for (int t = 0; t < NT; ++t) mma_bf16(acc[i][t], a, b[t][0], b[t][1]);
                    }
                }
            }
        }
#pragma unroll
        for (int d = 0; d < Ahead; ++d)
#pragma unroll
            for (int i = 0; i < MW; ++i) cur[d][i] = nxt[d][i];
    }
}

// The W slice of the forward, 3U rows (w_index layout): row g U + ul,
// column k = W[k][g H + u0 + ul] (zero past H). A warp reads 8 rows k of 4
// float4s (64 contiguous bytes each).
__device__ __forceinline__ void load_w_fwd(bf16* wt, const float* W, int H, int U, int u0, int KP) {
    const int H3 = 3 * H;
    const int q4 = 3 * U / 4;  // float4s of the slice in a row k
    const int total = KP * q4;
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * kThreads) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * kThreads;
            const int kb = i / (8 * q4), w8 = i % (8 * q4);
            const int k = 8 * kb + w8 % 8, c = 4 * (w8 / 8), g = c / U, ul = c % U;
            v[j] = i < total && k < H && u0 + ul < H ? io::ldg4(W + (size_t)k * H3 + g * H + u0 + ul)
                                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * kThreads;
            if (i < total) {
                const int kb = i / (8 * q4), w8 = i % (8 * q4);
                const int k = 8 * kb + w8 % 8, c = 4 * (w8 / 8), ng = 3 * U / 8;
                wt[w_index(c, k, ng)] = __float2bfloat16_rn(v[j].x);
                wt[w_index(c + 1, k, ng)] = __float2bfloat16_rn(v[j].y);
                wt[w_index(c + 2, k, ng)] = __float2bfloat16_rn(v[j].z);
                wt[w_index(c + 3, k, ng)] = __float2bfloat16_rn(v[j].w);
            }
        }
    }
}

// The W_hh^T slice of the chain, [U][ws] bf16: the block's U rows of
// W_hh, contiguous (zero past 3H and H).
__device__ __forceinline__ void load_w_chain(bf16* wc, const float* W, int H, int U, int u0, int KP,
                                             int ws) {
    const int H3 = 3 * H;
    const int q4 = KP / 4;
    const int total = U * q4;
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * kThreads) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * kThreads;
            const int ul = i / q4, k = 4 * (i % q4);
            v[j] = i < total && k < H3 && u0 + ul < H ? io::ldg4(W + (size_t)(u0 + ul) * H3 + k)
                                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = i0 + j * kThreads;
            if (i < total) {
                const int ul = i / q4, k = 4 * (i % q4);
                uint2 p;
                p.x = pack_bf16(v[j].x, v[j].y);
                p.y = pack_bf16(v[j].z, v[j].w);
                *reinterpret_cast<uint2*>(wc + (size_t)ul * ws + k) = p;
            }
        }
    }
}

// Zero the step counters (block 0), then one grid-wide sync: every block
// has loaded its W slice, visible to wgmma, and sees zeroed counters.
__device__ __forceinline__ void start(unsigned* ctr, int n) {
    fence_proxy_async();
    if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < n; i += kThreads) ctr[i] = 0u;
    __syncthreads();
    cooperative_groups::this_grid().sync();
}

// ---------------------------------------------------------------------
// forward

struct FwdArgs {
    const bf16* px_f;
    const bf16* px_b;
    const float* w_hh;
    const float* b_hh;
    float* hs;        // [2, N, H] the f32 state
    uint32_t* frag;   // [2 dirs][2 parities][ceil(N/16)][H/16][32][4] bf16(h) as A fragments
    bf16* ys_f;
    bf16* ys_b;
    unsigned* ctr;    // [2 * row tiles]
    int T, N, H, U, R;
};

// UG unit groups of 8 a block (U = 8 UG). Warp (mt, kg) does the gate math
// of unit groups 2 kg and 2 kg + 1 (those below UG) of its m16 tile.
template <int UG>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_fwd_kernel(const FwdArgs a) {
    constexpr int U = 8 * UG, NT = 3 * UG;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H;
    const Tile tl = block_tile(N, H, U, a.R);
    const int KP = round16(H), KS = KP / 16;
    bf16* wt = reinterpret_cast<bf16*>(smem_raw);  // 3U rows x KP: row g U + ul = W[:, g H + u0 + ul]
    float4* xchg = reinterpret_cast<float4*>(wt + (size_t)3 * U * KP);  // [2][kMT][kFwdSlots][32]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int mt = warp % kMT, kg = warp / kMT;

    load_w_fwd(wt, a.w_hh + (size_t)tl.dir * H * H3, H, U, tl.u0, KP);
    // This thread's gate-math units: unit + 8 j of group 2 kg + j, j < 2.
    const int unit = tl.u0 + 16 * kg + 2 * tig;
    bool uok[2];
    float2 bias[2][3];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        uok[j] = 2 * kg + j < UG && unit + 8 * j < H;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
            bias[j][gt] = uok[j] ? io::ldg2(a.b_hh + tl.dir * H3 + gt * H + unit + 8 * j)
                                 : make_float2(0.f, 0.f);
    }
    start(a.ctr, 2 * tl.RT);

    const bf16* px = tl.dir == 0 ? a.px_f : a.px_b;
    bf16* ys = tl.dir == 0 ? a.ys_f : a.ys_b;
    float* hs = a.hs + (size_t)tl.dir * N * H;
    const size_t frag_len = (size_t)((N + 15) / 16) * KS * 32 * 4;  // words of one parity
    uint32_t* frag = a.frag + (size_t)tl.dir * 2 * frag_len;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? step : T - 1 - step;
        const uint32_t* fprev = frag + (size_t)((step + 1) & 1) * frag_len;
        uint32_t* fnext = frag + (size_t)(step & 1) * frag_len;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int m0 = tl.n0 + p * kPassRows;  // the pass's first batch row
            const int rows = min(kPassRows, tl.rows - p * kPassRows);
            const bool active = 16 * mt < rows;  // warp-uniform
            // The gate math's inputs, all loads at once, in flight during
            // the product.
            uint32_t xv[2][2][3];
            float2 h0[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 16 * mt + gid + 8 * half;
                    const bool ok = active && uok[j] && row < rows;
                    const size_t m = (size_t)m0 + row;
                    const bf16* x = px + ((size_t)t * N + m) * H3 + unit + 8 * j;
#pragma unroll
                    for (int gt = 0; gt < 3; ++gt)
                        xv[j][half][gt] = ok ? __ldg(reinterpret_cast<const unsigned int*>(x + gt * H)) : 0u;
                    h0[j][half] = ok && step > 0 ? *reinterpret_cast<const float2*>(hs + m * H + unit + 8 * j)
                                                 : make_float2(0.f, 0.f);
                }
            // n8 tile t of acc: gate t / UG, unit group t % UG.
            float acc[NT][4];
            if (step > 0) {
                __syncthreads();  // the warpgroup reconverged: wgmma runs it as one
                wg_product<NT, kFwdBatch>(
                    acc, reinterpret_cast<const uint4*>(fprev) + (size_t)(m0 / 16 + mt) * KS * 32, active,
                    KS, kg, H % 16 != 0, smem_u32(wt));
            }
            // s[j][gt]: the sums of gate gt of group 2 kg + j, k group 0's
            // partial plus group 1's. (Register arrays take compile-time
            // indices only: the groups are picked by value.)
            float4 s[2][3];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int gt = 0; gt < 3; ++gt) s[j][gt] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (step > 0) {
                __syncthreads();  // the previous pass's sums have been read
                if (active) {
                    float4* mine = xchg + (size_t)(kg * kMT + mt) * kFwdSlots * 32;
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            // group 2 (1 - kg) + j: the other k group's
                            const int g0 = gt * UG + j, g1 = gt * UG + (2 + j < UG ? 2 + j : 0);
                            mine[(j * 3 + gt) * 32 + lane] = kg == 0 ? frag4(acc[g1]) : frag4(acc[g0]);
                        }
                }
                __syncthreads();
                if (active) {
                    const float4* other = xchg + (size_t)((1 - kg) * kMT + mt) * kFwdSlots * 32;
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            const int g0 = gt * UG + j, g1 = gt * UG + (2 + j < UG ? 2 + j : 0);
                            const float4 own = kg == 0 ? frag4(acc[g0]) : frag4(acc[g1]);
                            const float4 o = other[(j * 3 + gt) * 32 + lane];
                            s[j][gt] = kg == 0 ? add4(own, o) : add4(o, own);
                        }
                }
            }
            if (!active) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 16 * mt + gid + 8 * half;
                    if (!uok[j] || row >= rows) continue;
                    const int u = unit + 8 * j;
                    const size_t m = (size_t)m0 + row;
                    const float2 xr = as2(xv[j][half][0]), xz = as2(xv[j][half][1]),
                                 xn = as2(xv[j][half][2]);
                    const float sr[2] = {half ? s[j][0].z : s[j][0].x, half ? s[j][0].w : s[j][0].y};
                    const float sz[2] = {half ? s[j][1].z : s[j][1].x, half ? s[j][1].w : s[j][1].y};
                    const float sn[2] = {half ? s[j][2].z : s[j][2].x, half ? s[j][2].w : s[j][2].y};
                    float h[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float r = sigmoid((e ? xr.y : xr.x) + (sr[e] + (e ? bias[j][0].y : bias[j][0].x)));
                        const float z = sigmoid((e ? xz.y : xz.x) + (sz[e] + (e ? bias[j][1].y : bias[j][1].x)));
                        const float cn =
                            tanhf((e ? xn.y : xn.x) + r * (sn[e] + (e ? bias[j][2].y : bias[j][2].x)));
                        h[e] = (1.f - z) * cn + z * (e ? h0[j][half].y : h0[j][half].x);
                    }
                    *reinterpret_cast<float2*>(hs + m * H + u) = make_float2(h[0], h[1]);
                    const uint32_t hw = pack_bf16(h[0], h[1]);
                    *reinterpret_cast<uint32_t*>(ys + ((size_t)t * N + m) * H + u) = hw;
                    fnext[frag_word((int)m, u, KS)] = hw;
                }
        }
        if (step + 1 < T) signal_step(ctr);
    }
}

// ---------------------------------------------------------------------
// the backward's chain: both directions' reverse scans (the forward
// direction at t = T-1-step, the backward one at t = step).
//   dh = carry + bf16(dph[t']) @ bf16(W_hh)^T (t' the previous step);
//   dht = dh + dy[t]; with the coefficients q of (t, n): da_c = dht q1,
//   da_z = dht q2, dhn = da_c q3, da_r = da_c q4; dpx[t] = [da_r, da_z,
//   da_c]; dph = [da_r, da_z, dhn]; carry = dht q0 (q0 = z).

struct ChainArgs {
    const bf16* dy_f;
    const bf16* dy_b;
    const float* w_hh;
    const float* coef;  // [2, T*N, 5, H]
    float* carry;       // [2, N, H] dht * z
    uint32_t* frag;     // [2 dirs][2 parities][ceil(N/16)][3H/16][32][4] bf16(dph) as A fragments
    bf16* dpx_f;
    bf16* dpx_b;
    bf16* dhn;       // [2, T*N, H]
    float* dbp;      // [row tiles, 2, 3H]
    unsigned* ctr;   // [2 * row tiles]
    int T, N, H, U, R;
};

// UG unit groups of 8 a block (U = 8 UG). Warp w: m16 tiles 2 mp, 2 mp + 1
// of a pass (mp = w % 2) and the k16 steps kg, kg + 4, ... (kg = w / 2);
// it does the gate math of unit group kg (if below UG) of its two tiles.
template <int UG>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_chain_kernel(const ChainArgs a) {
    constexpr int U = 8 * UG;
    constexpr int KG = 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, M = T * N;
    const Tile tl = block_tile(N, H, U, a.R);
    const int KP = round16(H3), KS = KP / 16, WS = w_stride(H3);
    bf16* wc = reinterpret_cast<bf16*>(smem_raw);  // [U][WS]: wc[ul][j] = W[u0 + ul][j]
    float4* xchg = reinterpret_cast<float4*>(wc + (size_t)U * WS);  // [KG][2][kChainSlots][32]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int mp = warp % 2, kg = warp / 2;

    load_w_chain(wc, a.w_hh + (size_t)tl.dir * H * H3, H, U, tl.u0, KP, WS);
    const int u = tl.u0 + 8 * kg + 2 * tig;  // this thread's two units (group kg)
    const bool uok = kg < UG && u < H;
    const auto brow = [](int t) { return 8 * t; };
    start(a.ctr, 2 * tl.RT);

    const bf16* dy = tl.dir == 0 ? a.dy_f : a.dy_b;
    bf16* dpx = tl.dir == 0 ? a.dpx_f : a.dpx_b;
    bf16* dn = a.dhn + (size_t)tl.dir * M * H;
    const float* cf = a.coef + (size_t)tl.dir * M * kNC * H;
    float* carry = a.carry + (size_t)tl.dir * N * H;
    const size_t frag_len = (size_t)((N + 15) / 16) * KS * 32 * 4;
    uint32_t* frag = a.frag + (size_t)tl.dir * 2 * frag_len;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    const int passes = (tl.rows + kPassRows - 1) / kPassRows;
    // db: this warp's column sums of da_r, da_z, dhn over its rows and the
    // steps so far, by gate and unit e (every lane of a tig).
    float dbs[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};

    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? T - 1 - step : step;
        const uint32_t* fprev = frag + (size_t)((step + 1) & 1) * frag_len;
        uint32_t* fnext = frag + (size_t)(step & 1) * frag_len;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int m0 = tl.n0 + p * kPassRows;
            const int rows = min(kPassRows, tl.rows - p * kPassRows);
            const int mw = min(2, max(0, (rows - 32 * mp + 15) / 16));  // this warp's tiles (warp-uniform)
            // The gate math's inputs, all loads at once, in flight during
            // the product.
            float2 cv[2][2][kNC], c0[2][2];
            uint32_t g2[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 32 * mp + 16 * i + gid + 8 * half;
                    const bool ok = uok && row < rows;
                    const size_t n = (size_t)m0 + row;
                    const size_t m = (size_t)t * N + n;
#pragma unroll
                    for (int q = 0; q < kNC; ++q)
                        cv[i][half][q] = ok ? io::ldg2(cf + (m * kNC + q) * H + u) : make_float2(0.f, 0.f);
                    g2[i][half] = ok ? __ldg(reinterpret_cast<const unsigned int*>(dy + m * H + u)) : 0u;
                    c0[i][half] = ok && step > 0 ? *reinterpret_cast<const float2*>(carry + n * H + u)
                                                 : make_float2(0.f, 0.f);
                }
            float acc[2][UG][4];
            if (step > 0 && mw > 0)
                warp_product<2, UG, KG, kChainAhead>(
                    acc, reinterpret_cast<const uint4*>(fprev) + (size_t)(m0 / 16 + 2 * mp) * KS * 32, mw, KS,
                    kg, H % 16 != 0, wc, WS, brow);
            // s[i]: dh's product for group kg of tile i, the four k groups'
            // partials added in k-group order. (Register arrays take
            // compile-time indices only: the tiles are picked by value.)
            float4 s[2];
            s[0] = s[1] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (step > 0) {
                __syncthreads();  // the previous pass's sums have been read
                if (mw > 0) {
                    float4* mine = xchg + (size_t)(kg * 2 + mp) * kChainSlots * 32;
#pragma unroll
                    for (int g = 0; g < UG; ++g)
#pragma unroll
                        for (int i = 0; i < 2; ++i)
                            if (g != kg) mine[((g < kg ? g : g - 1) * 2 + i) * 32 + lane] = frag4(acc[i][g]);
                }
                __syncthreads();
                if (mw > 0 && kg < UG) {
#pragma unroll
                    for (int q = 0; q < KG; ++q) {
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                            if (q == kg) {
#pragma unroll
                                for (int g = 0; g < UG; ++g)
                                    if (g == kg) v = frag4(acc[i][g]);
                            } else {
                                v = xchg[((size_t)(q * 2 + mp) * kChainSlots + (kg < q ? kg : kg - 1) * 2 + i) * 32 + lane];
                            }
                            s[i] = add4(s[i], v);
                        }
                    }
                }
            }
            if (mw == 0 || kg >= UG) continue;  // warp-uniform
            float d[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};  // column sums of da_r, da_z, dhn
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 32 * mp + 16 * i + gid + 8 * half;
                    const bool ok = uok && row < rows;
                    const size_t n = (size_t)m0 + row;
                    const size_t m = (size_t)t * N + n;
                    const float2 dyv = as2(g2[i][half]);
                    const float sp[2] = {half ? s[i].z : s[i].x, half ? s[i].w : s[i].y};
                    const float2* c = cv[i][half];
                    float da_r[2], da_z[2], da_c[2], dhn[2], keep[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float dht = ((e ? c0[i][half].y : c0[i][half].x) + sp[e]) + (e ? dyv.y : dyv.x);
                        da_c[e] = dht * (e ? c[1].y : c[1].x);
                        da_z[e] = dht * (e ? c[2].y : c[2].x);
                        dhn[e] = da_c[e] * (e ? c[3].y : c[3].x);
                        da_r[e] = da_c[e] * (e ? c[4].y : c[4].x);
                        keep[e] = dht * (e ? c[0].y : c[0].x);
                        if (ok) {
                            d[0][e] += da_r[e];
                            d[1][e] += da_z[e];
                            d[2][e] += dhn[e];
                        }
                    }
                    if (!ok) continue;
                    bf16* o = dpx + m * H3 + u;
                    const uint32_t wr = pack_bf16(da_r[0], da_r[1]), wz = pack_bf16(da_z[0], da_z[1]),
                                   wn = pack_bf16(dhn[0], dhn[1]);
                    *reinterpret_cast<uint32_t*>(o) = wr;
                    *reinterpret_cast<uint32_t*>(o + H) = wz;
                    io::st2(o + 2 * H, da_c[0], da_c[1]);
                    *reinterpret_cast<uint32_t*>(dn + m * H + u) = wn;
                    *reinterpret_cast<float2*>(carry + n * H + u) = make_float2(keep[0], keep[1]);
                    fnext[frag_word((int)n, u, KS)] = wr;
                    fnext[frag_word((int)n, H + u, KS)] = wz;
                    fnext[frag_word((int)n, 2 * H + u, KS)] = wn;
                }
            // The column sums over the warp's 32 rows: its own four, then
            // the 8 lanes of a tig (lane bits 2-4).
#pragma unroll
            for (int q = 0; q < 3; ++q)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = d[q][e];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    dbs[q][e] += v;
                }
        }
        if (step + 1 < T) signal_step(ctr);
    }

    // db of the block's 3U columns over its rows and all steps: the two
    // m-pair warps' sums added in order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(xchg);  // [2][3][U]
    if (gid == 0 && kg < UG) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e) red[(mp * 3 + q) * U + 8 * kg + 2 * tig + e] = dbs[q][e];
    }
    __syncthreads();
    for (int i = tid; i < 3 * U; i += kThreads) {
        const int q = i / U, ul = i % U;
        if (tl.u0 + ul >= H) continue;
        a.dbp[((size_t)tl.rt * 2 + tl.dir) * H3 + q * H + tl.u0 + ul] = red[q * U + ul] + red[(3 + q) * U + ul];
    }
}

// ---------------------------------------------------------------------
// launches

// The plan's grid: 2 directions x ceil(N/R) row tiles x ceil(H/U) unit
// tiles; 0 for a plan the kernels do not take (U 24 or 32).
int grid_blocks(int T, int N, int H, int U, int R) {
    if (T < 1 || N < 1 || H < 8 || H % 8 || (U != 24 && U != 32) || R < 16 || R % 16) return 0;
    return 2 * ((N + R - 1) / R) * ((H + U - 1) / U);
}

// One cooperative launch of `kernel` with `blocks` blocks of kThreads and
// `smem` bytes of dynamic shared memory. Refuses (with the error the
// launch would give) a grid that the card cannot hold at once.
template <class Args>
int launch(const void* kernel, int device, Args args, int blocks, size_t smem, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    int optin = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    void* kargs[] = {&args};
    err = cudaLaunchKernelExC(&cfg, kernel, kargs);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The card's numbers that the plan (ops/gru.py `grid_plan`) rests on: its
// SM count and the dynamic shared memory a block may opt into.
int ocrs_gru_grid_limits(int device, int* sms, int* smem) {
    cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return (int)err;
}

// Dynamic shared memory of each kernel for padded width H and U units a
// block (kind 0: the forward, 1: the chain).
long long ocrs_gru_grid_smem(int kind, int H, int U) {
    return (long long)(kind == 0 ? fwd_smem(H, U) : chain_smem(H, U));
}

// The forward: px_f, px_b [T, N, 3H] bf16; w_hh [2, H, 3H] float32 holding
// bf16 values; b_hh [2, 3H] float32; scratch (any contents) hs [2, N, H]
// float32, frag [2, 2, 16 ceil(N/16), round16(H)] bf16 and ctr [2 *
// ceil(N / R)]; out ys_f, ys_b [T, N, H] bf16. H % 8 == 0; U (units a
// block, 24 or 32) and R (rows a block, a multiple of 16) from the plan.
// One cooperative launch.
int ocrs_gru_grid_fwd_bf16(int device, const bf16* px_f, const bf16* px_b, const float* w_hh,
                           const float* b_hh, float* hs, uint32_t* frag, bf16* ys_f, bf16* ys_b,
                           unsigned* ctr, int T, int N, int H, int U, int R, void* stream) {
    const FwdArgs args = {px_f, px_b, w_hh, b_hh, hs, frag, ys_f, ys_b, ctr, T, N, H, U, R};
    const void* kernel = U == 24 ? (const void*)gru_grid_fwd_kernel<3> : (const void*)gru_grid_fwd_kernel<4>;
    return launch(kernel, device, args, grid_blocks(T, N, H, U, R), fwd_smem(H, U), stream);
}

// The backward's chain: dy_f, dy_b [T, N, H] bf16; w_hh as above; coef [2,
// T*N, 5, H] from gru_bwd.cu's ocrs_gru_bwd_coef_bf16; scratch carry [2, N,
// H] float32, frag [2, 2, 16 ceil(N/16), round16(3H)] bf16 and ctr [2 *
// ceil(N / R)]; out dpx_f, dpx_b [T, N, 3H] bf16, dhn [2, T*N, H] bf16 and
// dbp [db_parts, 2, 3H] float32 (db's partial per row tile, for
// gru_bwd.cu's ocrs_gru_bwd_dw_bf16; refused if db_parts < ceil(N / R)).
// One cooperative launch.
int ocrs_gru_grid_chain_bf16(int device, const bf16* dy_f, const bf16* dy_b, const float* w_hh,
                             const float* coef, float* carry, uint32_t* frag, bf16* dpx_f,
                             bf16* dpx_b, bf16* dhn, float* dbp, int db_parts, unsigned* ctr, int T,
                             int N, int H, int U, int R, void* stream) {
    if (R < 1 || db_parts < (N + R - 1) / R) return (int)cudaErrorInvalidValue;
    const ChainArgs args = {dy_f, dy_b, w_hh, coef, carry, frag, dpx_f, dpx_b, dhn, dbp, ctr,
                            T, N, H, U, R};
    const void* kernel =
        U == 24 ? (const void*)gru_grid_chain_kernel<3> : (const void*)gru_grid_chain_kernel<4>;
    return launch(kernel, device, args, grid_blocks(T, N, H, U, R), chain_smem(H, U), stream);
}

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
