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
// padded width 512 < H <= 6336 (GRID_MAX_HIDDEN on an H100) here, after
// zero-padding H to a multiple of 8; f32, and bf16 above that, keep
// gru_wide.cu's kernels of one launch a step. The backward's other phases,
// the coefficients before the chain and the dW/db reduction after it, are
// gru_bwd.cu's bf16 entries (gru_bwd_wide.cu's above H = 512).
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
// bf16(dhn) [2, T*N, H] for the bf16 dW phase, and db's partials [batch
// tiles, 2, 3H] summed from the unrounded dph.
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
// refused at launch instead of hanging in a barrier. The plan comes from
// the wrapper (ops/gru.py `grid_plan`, which also picks this form: chosen
// before the launch, by width, dtype, batch and the card's SM count and
// shared memory): a block owns U hidden units x R batch rows (a multiple
// of 16) of one direction; ceil(H/U) unit tiles x ceil(N/R) row tiles per
// direction, at most one block an SM (two directions of 32 x 2 blocks at
// H=1024, N=128). Up to H = 1440 U is 32, or 24 above H = 1072, and the
// whole W slice stays in shared memory; above, U is the least multiple of
// 8 whose blocks fit the SMs (24 at 1448, 32 at 2048, 64 at 4096, 80 at
// 5280, 88 at 5288, 96 from 5816 to 6336), and the slice is split (below,
// "streamed W"). Past 80 units ("the per-gate plans", kGateUnits) the
// forward's 3U columns exceed wgmma's n = 256 and the bf16 W_hh (335.6 MB
// at 5288) outgrows the L2 and the SMs' shared memory together, so it
// comes from device memory every step; there both kernels run on wgmma in
// passes of 128 rows split between the warpgroups, so each streams its
// slice once a step. The forward's ring copies are marked evict-first in
// L2 (the state and A fragments that every block reads each step stay
// there). The forward parks its 3U accumulators in its 4 ring stages for
// the gate math (in registers ptxas spilled them: on an H100 at 5288 the
// gate math took 104 k cycles a step, 64 k parked, grid_probe) and
// refills the stages once the gate math has read them. The chain streams
// chunks of kGateChunk k16 steps: each stage's copy cost about a latency
// that nothing hid, so fewer, larger copies (82 a step at 5288, not 248)
// took its call from 100.5 ms to 59.1 (grid_probe's operands).
// - W: the block loads its bf16 slice of W_hh once into shared memory and
//   keeps it for all T steps: the forward's 3U rows (its units' r, z, n
//   columns of W_hh) of H, in wgmma's K-major layout of 8 x 8 core
//   matrices (128 contiguous bytes each, no swizzle); the chain's U rows
//   (its units' rows of W_hh, i.e. W_hh^T's columns) of 3H, rows padded to
//   an odd multiple of 16 bytes so that `ldmatrix` reads 8 rows in 8 bank
//   groups; 6 * U * H bytes either way.
// - Streamed W (above H = 1440, where 6 U H bytes do not fit): the block
//   keeps the first KR k16 steps of its slice in shared memory and streams
//   the rest through a ring of S stages, chunks of 4 k16 steps (forward)
//   or 8 (chain; kGateChunk in the per-gate plans' chain). The wrapper's
//   call first writes, once a call, a device
//   copy of every block's streamed chunks in the exact layout of a ring
//   stage (one launch, `gru_grid_stream_layout_kernel`), so a chunk is one
//   contiguous `cp.async.bulk` (1-D TMA) into a stage, completing on that
//   stage's mbarrier. The chunks do not depend on the step: thread 0
//   issues the first S before the grid-wide sync and then, each time the
//   warps free a stage, the chunk S further on, so the next step's first
//   chunks land while the block does its gate math and waits at the step
//   barrier, and later ones while the resident k steps multiply. The
//   products take the resident k16 steps first, then the streamed ones as
//   their stages land, in the same summation order; each warp frees a
//   stage with one arrival. (A ninth, producer warp would cap every
//   thread at 168 registers.)
// - The products, 8 warps. Forward: `wgmma.mma_async` m64n(3U)k16 bf16 ->
//   f32 (above kGateUnits one m64nUk16 a gate, each from its gate's rows
//   of the same slice and the same A registers; a sum keeps the order of
//   one product), A from registers, B from shared memory by descriptor.
//   In passes
//   of 64 batch rows warp w holds the m16 tile w % 4 of the pass and
//   warpgroup w / 4 takes the k16 steps of that parity (its "k group");
//   in the streamed plans where a block has more than 64 rows, passes of
//   128 rows split by warpgroup instead (warp w holds tile w, each
//   warpgroup all k16 steps: no partial sums to exchange, the ring read
//   once for all the rows). Chain (N = U, too narrow for wgmma to pay for
//   its fences): `mma.sync.m16n8k16` bf16 -> f32 (mma_bf16.cuh); warp w
//   takes MW m16 tiles from MW (w % 2), whose products share each B
//   fragment (MW = 2, passes of 64 rows; 4, passes of 128, in the streamed
//   plans of up to 32 units where a block has more than 64 rows), and the
//   k16 steps congruent to w / 2 mod 4. The k groups' partial sums meet in
//   shared memory and are added in k-group order. The per-gate plans'
//   chain (gru_grid_chain_gate_kernel) multiplies as the forward does at
//   128 rows a pass: one wgmma m64nUk16 a k16 step, B its U rows of
//   W_hh^T in the forward's layout (streamed chunks of kGateChunk k16
//   steps), A staged in shared memory, no partial sums to exchange (at 88 units
//   gru_grid_chain_kernel's warps hold 2 m16 tiles in passes of 64 rows,
//   as 4 would take 176 accumulators a thread, and stream the slice twice
//   a step from device memory).
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
//   one multiplies (forward: 4 steps; chain: 2 of each tile). The streamed
//   forward stages them instead through shared memory with `cp.async`
//   (batches of 2 steps, or 4 where its warpgroups split the rows, two
//   batches ahead), so that wgmma.fence, which waits for every load into a
//   register, waits for none from device memory.
// - The gate math runs on the accumulator fragments: a thread owns 2 units
//   x 2 rows of the unit groups of its k group (forward: the first or
//   second half of the block's ceil(U/8) groups; all of them where the
//   warpgroups split the rows) or 2 units x 2 MW rows of the groups
//   congruent to its k group mod 4 (chain); in the kernels of up to 32
//   units with 2 tiles a warp its loads (px, or the coefficients and dy,
//   and the f32 state) are issued together before the product, else after
//   it.
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

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "device_guard.cuh"
#include "grid_step.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace grid_step;
using namespace tc;
using io::bf16;

constexpr int kPassRows = 64;                 // batch rows a pass multiplies
constexpr int kMT = kPassRows / 16;           // its m16 tiles, one a warp of a k group
constexpr int kThreads = 256;                 // 8 warps: 4 m16 tiles x 2 k groups
constexpr int kFwdBatch = 4;                  // A fragments a forward warp loads at once (k16 steps)
constexpr int kChainAhead = 2;                // the chain's A fragments loaded ahead, each tile
constexpr int kNC = 5;                        // coefficients per element (gru_bwd.cu's coef)
constexpr int kFwdChunk = 4;                  // k16 steps of W in a forward ring stage
constexpr int kAStages = 3;                   // streamed forward: A batches a warp stages in shared memory
constexpr int kChainChunk = 8;                // in a chain ring stage (two of each k group)
constexpr int kGateUnits = 80;                // most units whose forward is one wgmma of n = 3U
constexpr int kMaxUnits = 96;                 // most units a block (the per-gate plans above kGateUnits)

// The forward's A fragments loaded at once (k16 steps of a k group):
// kFwdBatch in the kernels that keep all of W resident, 2 in the streamed
// ones (a batch then spans one ring chunk, their staging takes 24 KB, and
// at 80 units a block the accumulators take 120 registers a thread; on an
// H100 at H=1448 the forward read 9.09 ms with 2 against 10.38 with 4,
// grid_probe).
__host__ __device__ constexpr int fwd_batch(bool stream) { return stream ? 2 : kFwdBatch; }

// The plan (ops/gru.py `grid_split`) picks each kernel's variant: the
// streamed kernels (a ring of W, A staged in shared memory) where it has a
// ring (S > 0), and the rows a pass, PR, 64 or 128. At 128 the streamed
// forward splits a block's rows between its two warpgroups (each takes
// 64 rows over the whole contraction, no partial sums to exchange, the
// ring read once for them all) rather than the contraction (MS), and a
// warp of the streamed chain of up to 32 units takes 4 m16 tiles instead
// of 2 (MW = PR / 32: each B fragment serves four tiles, and a warp has
// twice the independent products a k16 step).

// The streamed forward's A staging: kAStages batches of `batch` k16 steps
// (4 where the rows are split) of each of its 8 warps, 32 lanes x 16 bytes
// a step.
__host__ __device__ constexpr int fwd_astage(int batch) { return 8 * kAStages * batch * 32 * 16; }

// Shared memory where the k groups' partial sums meet, [k groups][warps of
// a k group][slots][32 lanes] float4, a slot one n8 tile of one m16 tile
// handed to another group: the forward's 2 k groups x 4 warps x (its
// ceil(UG/2) unit groups x 3 gates); the chain's 4 k groups x 2 warps x
// (the unit groups other k groups own x 2 m16 tiles), 6 slots either way
// up to 32 units a block (24 KB).
__host__ __device__ constexpr int fwd_slots(int UG) { return 3 * ((UG + 1) / 2); }
__host__ __device__ constexpr int chain_slots(int UG) { return 2 * (UG - UG / 4); }
__host__ __device__ constexpr int fwd_xchg(int UG) { return 2 * kMT * fwd_slots(UG) * 32 * 16; }
__host__ __device__ constexpr int chain_xchg(int UG, int MW = 2) {
    return 4 * 2 * chain_slots(UG) * MW / 2 * 32 * 16;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The forward's W slice of n rows (output columns) and contraction K in
// shared memory, bf16 in wgmma's K-major layout without swizzle: 8 x 8
// "core matrices" (8 rows of 8 consecutive k, 128 contiguous bytes), the
// n/8 of each 8 k side by side, k chunk after k chunk: row c, column k at
// element ((k / 8) (n / 8) + c / 8) 64 + (c % 8) 8 + k % 8, K padded to
// the k16 steps with zeros. A streamed chunk is the same layout, k counted
// from its first step.
__device__ __forceinline__ int w_index(int c, int k, int n_groups) {
    return (((k >> 3) * n_groups + (c >> 3)) << 6) + ((c & 7) << 3) + (k & 7);
}

// bf16 row stride of the chain's W slice (rows for ldmatrix), whose
// contraction is K: past the k16 steps by 8, an odd multiple of 16 bytes,
// so that ldmatrix reads 8 rows in 8 bank groups.
__host__ __device__ constexpr int w_stride(int K) { return round16(K) + 8; }

// Bytes of one ring stage (a streamed chunk): the forward's 4 k16 steps of
// 3U rows, the chain's U rows of 8 k16 steps (row stride w_stride(128)).
__host__ __device__ constexpr size_t fwd_chunk_bytes(int U) { return (size_t)kFwdChunk * 96 * U; }
__host__ __device__ constexpr size_t chain_chunk_bytes(int U) {
    return (size_t)2 * U * w_stride(16 * kChainChunk);
}
// The per-gate plans' chain (above kGateUnits): a ring stage holds
// kGateChunk k16 steps of its U rows in the forward's layout (w_index), as
// wgmma reads them, and its products take one stage a batch: a stage's
// copy (one cp.async.bulk) cost about a latency that nothing hid, so a
// stage is as large as the shared memory allows beside 2 batches of A
// staging (kGateAStages of each of the 8 warps, 512 bytes a k16 step).
constexpr int kGateChunk = 12;
__host__ __device__ constexpr size_t gate_chain_chunk_bytes(int U) { return (size_t)kGateChunk * 32 * U; }
constexpr int kGateAStages = 2;
__host__ __device__ constexpr int gate_chain_astage() { return 8 * kGateAStages * kGateChunk * 32 * 16; }

// Dynamic shared memory of each kernel with the first KR k16 steps of W
// resident, a ring of S stages (S = 0: the whole slice resident, KR the
// contraction's k16 steps) and passes of PR rows: the slice, the
// exchange, the streamed forward's A staging, the ring and its two
// mbarriers a stage.
size_t fwd_smem(int U, int KR, int S, int PR) {
    const bool ms = PR > kPassRows;
    return (size_t)96 * U * KR + (ms ? 0 : fwd_xchg(U / 8)) +
           (S > 0 ? fwd_astage(ms ? 4 : fwd_batch(true)) : 0) + (size_t)S * (fwd_chunk_bytes(U) + 16);
}

size_t chain_smem(int U, int KR, int S, int PR) {
    if (U > kGateUnits)  // the slice in wgmma's layout, the A staging, the ring, db's sums
        return (size_t)32 * U * KR + gate_chain_astage() + (size_t)S * (gate_chain_chunk_bytes(U) + 16) +
               (size_t)8 * 3 * U * 4;
    return (size_t)2 * U * w_stride(16 * KR) + chain_xchg(U / 8, PR / 32) +
           (size_t)S * (chain_chunk_bytes(U) + 16);
}

// Whether the kernels are built for a plan: U units a block (24 or 32 where
// the whole slice is resident, up to kMaxUnits with a ring), PR rows a pass
// (128 only with a ring, and in the chain only up to 32 units; always
// above kGateUnits, where both kernels split the rows between their
// warpgroups and take 4 stages or more).
bool grid_variant_ok(int kind, int U, int S, int PR) {
    if (U % 8 != 0) return false;
    if (S == 0) return (U == 24 || U == 32) && PR == kPassRows;
    if (U < 24 || U > kMaxUnits) return false;
    // The per-gate forward parks its sums in 4 stages; the chain's next
    // batch lands in a second stage while one multiplies.
    if (U > kGateUnits) return PR == 2 * kPassRows && S >= (kind == 0 ? 4 : 2);
    return PR == kPassRows || (PR == 2 * kPassRows && (kind == 0 || U <= 32));
}

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

// wgmma.mma_async m64nNk16 for the forward's N = 3U (72 to 240), A from
// registers (mma.sync's A fragment layout, one m16 tile a warp of the
// warpgroup), B from shared memory by descriptor, f32 accumulators in
// mma.sync's C layout, one n8 tile after another; D += A B.
template <int N>
struct Wgmma;

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

template <>
struct Wgmma<88> {
    __device__ __forceinline__ static void mma(float (&d)[11][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, {%44, %45, %46, %47}, %48, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

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
struct Wgmma<120> {
    __device__ __forceinline__ static void mma(float (&d)[15][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, {%60, %61, %62, %63}, %64, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<144> {
    __device__ __forceinline__ static void mma(float (&d)[18][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<168> {
    __device__ __forceinline__ static void mma(float (&d)[21][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %89, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83}, {%84, %85, %86, %87}, %88, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<192> {
    __device__ __forceinline__ static void mma(float (&d)[24][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<216> {
    __device__ __forceinline__ static void mma(float (&d)[27][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %113, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107}, {%108, %109, %110, %111}, %112, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

template <>
struct Wgmma<240> {
    __device__ __forceinline__ static void mma(float (&d)[30][4], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %125, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119}, {%120, %121, %122, %123}, %124, p, 1, 1, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
    }
};

// ---------------------------------------------------------------------
// the ring of streamed W (above H = 1440)

// The ring: the slice's k16 steps from KR on, NC chunks a product, read
// from `src` (this block's chunks, contiguous) through S stages of `bytes`
// each at `stage0`, stage s full on full[s] (the issuing thread's arrival
// and the copy's bytes) and free on empty[s] (one arrival of each warp).
// Chunk g of the call (g = product * NC + chunk, `total` of them) lands in
// stage g % S; its use of the stage is g / S. Thread 0 issues the chunks
// in order (`issued`: how many so far, in its registers): without a warp
// of its own, so that the 8 warps keep every register (a ninth warp would
// cap them at 168). `first`: the copies are marked evict-first in L2 (the
// per-gate forward, whose W_hh outgrows the L2 and comes from device
// memory each step), so that they do not push out what every block reads
// each step (the A fragments, the state): on an H100 at 5288 that helped
// the forward and slowed the chain, each by a few per cent. Chunks from
// `limit` on are issued only when a product waits for them (the per-gate
// forward holds its accumulators in the stages between its products:
// thread 0 raises the limit once they are read). `lazy`: a warp's release issues the next
// chunks only into stages already free, without waiting for the other
// warps (the per-gate chain: a release that waits holds the first
// warpgroup to the second's pace; the ring_wait of a chunk issues it if
// no release did).
struct Ring {
    int KR, NC, S;
    uint32_t bytes;
    const unsigned char* src;
    unsigned char* stage0;
    uint64_t* full;
    uint64_t* empty;
    unsigned total, issued, limit;
    bool first, lazy;
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem_end_of_slices, const bf16* src,
                                          int KR, int NC, int S, size_t bytes, bool first = false) {
    Ring r;
    r.KR = KR;
    r.NC = NC;
    r.S = S;
    r.bytes = (uint32_t)bytes;
    r.src = reinterpret_cast<const unsigned char*>(src);
    r.stage0 = smem_end_of_slices;
    r.full = reinterpret_cast<uint64_t*>(smem_end_of_slices + (size_t)S * bytes);
    r.empty = r.full + S;
    r.total = r.issued = 0;
    r.limit = ~0u;
    r.first = first;
    r.lazy = false;
    return r;
}

// Thread 0: chunk g into its stage, once every warp has freed the stage's
// previous use.
__device__ __forceinline__ void ring_issue(const Ring& r, unsigned g) {
    const unsigned s = g % (unsigned)r.S, use = g / (unsigned)r.S;
    if (use > 0) mbar_wait(r.empty + s, (use - 1) & 1u);
    mbar_arrive_expect_tx(r.full + s, r.bytes);
    const uint32_t dst = smem_u32(r.stage0 + (size_t)s * r.bytes), bar = smem_u32(r.full + s);
    const unsigned char* src = r.src + (size_t)(g % (unsigned)r.NC) * r.bytes;
    if (r.first) {
        uint64_t policy;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
            " [%0], [%1], %2, [%3], %4;"
            :: "r"(dst), "l"(src), "r"(r.bytes), "r"(bar), "l"(policy) : "memory");
    } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            :: "r"(dst), "l"(src), "r"(r.bytes), "r"(bar) : "memory");
    }
}

// The chunks that may be issued ahead of a wait for them.
__device__ __forceinline__ unsigned ring_end(const Ring& r) { return min(r.total, r.limit); }

// Thread 0 issues the first S chunks of the call (every stage is free).
__device__ __forceinline__ void ring_fill(Ring& r) {
    if (threadIdx.x == 0)
        while (r.issued < ring_end(r) && r.issued < (unsigned)r.S) ring_issue(r, r.issued++);
}

// Whether the stage of chunk g is free for it (its previous use released
// by every warp), without waiting.
__device__ __forceinline__ bool ring_free(const Ring& r, unsigned g) {
    const unsigned use = g / (unsigned)r.S;
    if (use == 0) return true;
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(r.empty + g % (unsigned)r.S)), "r"((use - 1) & 1u) : "memory");
    return done != 0;
}

// The shared address of chunk g, once it has landed. Thread 0 first issues
// it if it has not yet, waiting for the stages to free: every other warp
// has freed the chunks before the one it waits for, all issued, so this
// never waits on itself.
__device__ __forceinline__ uint32_t ring_wait(Ring& r, unsigned g) {
    const unsigned s = g % (unsigned)r.S;
    if (threadIdx.x == 0)
        while (r.issued <= g) ring_issue(r, r.issued++);
    mbar_wait(r.full + s, (g / (unsigned)r.S) & 1u);
    return smem_u32(r.stage0) + s * r.bytes;
}

// A warp is done with chunk g (every read of it has completed). Thread 0
// then refills g's stage with chunk g + S as soon as every warp has freed
// it (warp 0 waits for the others' last reads of the chunk, which they
// make at about the same time), so that S chunks are in flight.
__device__ __forceinline__ void ring_release(Ring& r, unsigned g) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + g % (unsigned)r.S);
    if (threadIdx.x == 0)
        while (r.issued <= g + (unsigned)r.S && r.issued < ring_end(r) &&
               (!r.lazy || ring_free(r, r.issued)))
            ring_issue(r, r.issued++);
}

// The ring's mbarriers (thread 0), made visible to the copies.
__device__ __forceinline__ void ring_init(const Ring& r) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < r.S; ++s) {
            mbar_init(r.full + s, 1);
            mbar_init(r.empty + s, kThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
}

// Where the element pair (row r, columns k, k + 1; k even) of an A operand
// with KS k16 steps sits in its fragment buffer, in 32-bit words: m16 tile
// r / 16, k16 step k / 16, lane (r % 8) * 4 + (k % 8) / 2, register (r % 16
// >= 8) + 2 (k % 16 >= 8).
__device__ __forceinline__ size_t frag_word(int r, int k, int KS) {
    return (((size_t)(r / 16) * KS + k / 16) * 32 + (r % 8) * 4 + (k % 8) / 2) * 4 +
           ((r % 16) / 8 + 2 * ((k % 16) / 8));
}

// The first n8 tile of sub-product q of Subs over NT tiles (their widths
// differ by one tile at most).
template <int NT, int Subs>
__device__ __forceinline__ uint32_t sub_tile(int q) { return (uint32_t)(q * NT / Subs); }

// One k16 step of the warpgroup: Subs wgmma over consecutive n8 tiles of
// acc (sub-product Q: tiles Q NT / Subs ..), each from its own rows of the
// W slice (descriptor desc[Q]) and the same A registers. Independent
// accumulators, so the products of a step overlap in the tensor cores.
template <int NT, int Subs, int Q = 0>
__device__ __forceinline__ void wg_mmas(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const uint64_t (&desc)[Subs]) {
    if constexpr (Q < Subs) {
        constexpr int off = Q * NT / Subs, w = (Q + 1) * NT / Subs - off;
        Wgmma<8 * w>::mma(*reinterpret_cast<float(*)[w][4]>(&acc[off][0]), a, desc[Q]);
        wg_mmas<NT, Subs, Q + 1>(acc, a, desc);
    }
}

// The warpgroup's product (warps 4 kg .. 4 kg + 3, m16 tile w % 4 each):
// the A fragments of this warp's tile, `frag` ([KS][32] uint4; zero where
// the tile holds no batch row, `rows`), at the k16 steps kg, kg + KS2, ...
// (KS2 = 2: the two warpgroups split the contraction; 1: each takes all of
// it for rows of its own, kg = 0),
// times the W slice at shared address `w` (8 NT rows, wgmma's layout),
// into acc, one wgmma m64n(8 NT)k16 a step. The upper half of the last
// k16 step is zero where K is not a multiple of 16 (`pad`). In batches of
// `Batch` steps, the next batch's fragments loading while this one's
// products run; wgmma.fence waits for every pending load into a register,
// so they are issued after the products. Every warp of both warpgroups
// runs the same number of steps (a step past KS multiplies zeros): control
// flow that ptxas cannot prove uniform in the warpgroup serialises wgmma.
// Streamed (`Stream`, ring.NC > 0): the k16 steps from ring.KR on come
// from the ring, chunk c of this product being the call's chunk g0 + c; a
// batch (2 Batch steps of both k groups, 4-step chunks) waits for its
// chunks before its fence and frees them after its wait, the same in
// every warp. A step past the last chunk reads that chunk's last step
// (times zeros). The streamed kernels also bring the A fragments through
// this warp's `astage` ([AStages][Batch][32] uint4 in shared memory) with
// cp.async, AStages - 1 batches ahead, and read each batch from there
// just before its fence: the fence then waits for no load from device
// memory. `Gates` > 1 (the per-gate plans' forward, 3 U > 256 columns): a
// k16 step is that many wgmma over consecutive n8 tiles (wg_mmas), each
// from its own rows of the slice and the same A registers: every sum
// keeps the order of one product. `Chunk`: k16 steps of a ring stage.
template <int NT, int Batch, bool Stream, int KS2 = 2, int Gates = 1, int AStages = kAStages,
          int Chunk = kFwdChunk>
__device__ __forceinline__ void wg_product(float (&acc)[NT][4], const uint4* frag, bool rows, int KS,
                                           int kg, bool pad, uint32_t w, Ring& ring,
                                           unsigned g0, uint4* astage) {
    constexpr int kHalves = KS2 * Batch / Chunk;  // chunks a batch spans
    static_assert(kHalves >= 1 && KS2 * Batch % Chunk == 0, "a batch spans whole chunks");
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const int nk = (KS + KS2 - 1) / KS2;  // k16 steps of either k group, rounded up
    const uint32_t lbo = (uint32_t)NT * 128, sbo = 128;
    const auto load = [&](uint32_t (&a)[Batch][4], int i0) {
#pragma unroll
        for (int d = 0; d < Batch; ++d) {
            const int ks = kg + KS2 * (i0 + d);
            const uint4 v = rows && ks < KS ? __ldcg(frag + (size_t)ks * 32 + lane)
                                            : make_uint4(0u, 0u, 0u, 0u);
            const bool hi = !(pad && ks == KS - 1);
            a[d][0] = v.x;
            a[d][1] = v.y;
            a[d][2] = hi ? v.z : 0u;
            a[d][3] = hi ? v.w : 0u;
        }
    };
    const auto stage = [&](int i0) {  // the batch from k group step i0 into its slot
        uint4* dst = astage + (size_t)(i0 / Batch % AStages) * Batch * 32;
#pragma unroll
        for (int d = 0; d < Batch; ++d) {
            const int ks = kg + KS2 * (i0 + d);
            const bool ok = rows && ks < KS;
            const int nbytes = ok ? 16 : 0;
            cp_async16(dst + d * 32 + lane, ok ? frag + (size_t)ks * 32 + lane : frag, nbytes);
        }
        cp_async_commit();
    };
    const auto staged = [&](uint32_t (&a)[Batch][4], int i0) {
        const uint4* src = astage + (size_t)(i0 / Batch % AStages) * Batch * 32;
#pragma unroll
        for (int d = 0; d < Batch; ++d) {
            const uint4 v = src[d * 32 + lane];
            const bool hi = !(pad && kg + KS2 * (i0 + d) == KS - 1);
            a[d][0] = v.x;
            a[d][1] = v.y;
            a[d][2] = hi ? v.z : 0u;
            a[d][3] = hi ? v.w : 0u;
        }
    };
    const bool streamed = Stream && ring.NC > 0;
    uint32_t cur[Batch][4], nxt[Batch][4];
    if (Stream) {
#pragma unroll
        for (int b = 0; b < AStages - 1; ++b) stage(b * Batch);
    } else {
        load(cur, 0);
    }
#pragma unroll 1
    for (int i0 = 0; i0 < nk; i0 += Batch) {
        if (Stream) {
            stage(i0 + (AStages - 1) * Batch);
            cp_async_wait<AStages - 1>();
            staged(cur, i0);
        }
        // Every input register of the batch's products is set before its
        // fence: ptxas serialises products whose inputs are set between
        // them.
        uint64_t desc[Batch][Gates];
        int chunk[kHalves];  // the ring chunk of each 4-step half of the batch, or -1
        if (streamed) {
            uint32_t base[kHalves];
#pragma unroll
            for (int q = 0; q < kHalves; ++q) {
                const int s0 = KS2 * i0 + Chunk * q;
                const int c = (s0 - ring.KR) / Chunk;
                chunk[q] = s0 >= ring.KR && c < ring.NC ? c : -1;
                base[q] = chunk[q] >= 0 ? ring_wait(ring, g0 + chunk[q]) : 0u;
            }
#pragma unroll
            for (int d = 0; d < Batch; ++d) {
                const int ks = kg + KS2 * (i0 + d);
                const int q = (ks - KS2 * i0) / Chunk;
                uint32_t addr;
                if (ks < ring.KR)
                    addr = w + (uint32_t)ks * 2 * lbo;
                else if (chunk[q] >= 0)
                    addr = base[q] + (uint32_t)((ks - KS2 * i0) % Chunk) * 2 * lbo;
                else  // past the last chunk, which the batch's first half holds
                    addr = base[0] + (uint32_t)(Chunk - 1) * 2 * lbo;
#pragma unroll
                for (int q = 0; q < Gates; ++q) desc[d][q] = w_desc(addr + sub_tile<NT, Gates>(q) * 128, lbo, sbo);
            }
        } else {
#pragma unroll
            for (int d = 0; d < Batch; ++d)
#pragma unroll
                for (int q = 0; q < Gates; ++q)
                    desc[d][q] = w_desc(w + (uint32_t)min(kg + KS2 * (i0 + d), KS - 1) * 2 * lbo +
                                            sub_tile<NT, Gates>(q) * 128, lbo, sbo);
        }
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < Batch; ++d) wg_mmas<NT, Gates>(acc, cur[d], desc[d]);
        wgmma_commit();
        if (!Stream) load(nxt, i0 + Batch);
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
                if (!Stream) cur[d][r] = nxt[d][r];
            }
        if (streamed) {
#pragma unroll
            for (int q = 0; q < kHalves; ++q)
                if (chunk[q] >= 0) ring_release(ring, g0 + chunk[q]);
        }
    }
    if (Stream) cp_async_wait<0>();  // the batches staged past the last: their slots are reused next
}

// The warp's product: the A fragments of its MW m16 tiles (`frag`, each
// [KS][32] uint4, tile i at frag + i * KS * 32; the first `mw` of them
// exist) at the k16 steps kg, kg + KG, ... times the W slice `w` (rows of
// stride ws; n8 tile t at rows brow(t)), into acc. The upper half of the
// last k16 step is zero where K is not a multiple of 16 (`pad`). The
// fragments of the next `Ahead` steps load while the warp multiplies
// `Ahead` steps; each B fragment serves all MW tiles. Streamed (`Stream`,
// ring.NC > 0): the k16 steps from ring.KR on come from the ring, a chunk
// the KG * Ahead steps of one round of every warp (chunk c of this product
// the call's chunk g0 + c, rows of stride w_stride(128)); every warp, with
// tiles or not, runs every round, waits for a streamed round's chunk and
// frees it.
template <int MW, int NT, int KG, int Ahead, bool Stream, class Rows>
__device__ __forceinline__ void warp_product(float (&acc)[MW][NT][4], const uint4* frag, int mw,
                                             int KS, int kg, bool pad, const bf16* w, int ws,
                                             const Rows& brow, Ring& ring, unsigned g0) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;
    const int nk = (KS - kg + KG - 1) / KG;  // this k group's k16 steps
    const size_t tile = (size_t)KS * 32;
    const bool streamed = Stream && ring.NC > 0;
    // Rounds: this warp's own up to 32 units a block; with a ring, every
    // warp runs all of them.
    const int rounds = streamed ? (KS + KG * Ahead - 1) / (KG * Ahead) : (nk + Ahead - 1) / Ahead;
    uint32_t b_lane[(NT + 1) / 2];  // this lane's ldmatrix row of each pair of B tiles
    uint32_t r_lane[Stream ? (NT + 1) / 2 : 1];  // the same in a ring stage
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
        const int row = (lane < 16 || t + 1 >= NT ? brow(t) : brow(t + 1)) + lane % 8;
        b_lane[t / 2] = smem_u32(w + (size_t)row * ws + ((lane / 8) % 2) * 8);
        if (Stream) r_lane[Stream ? t / 2 : 0] = (uint32_t)(row * w_stride(16 * kChainChunk) + ((lane / 8) % 2) * 8) * 2;
    }
    uint4 cur[Ahead][MW], nxt[Ahead][MW];
#pragma unroll
    for (int d = 0; d < Ahead; ++d)
#pragma unroll
        for (int i = 0; i < MW; ++i)
            if (d < nk && i < mw) cur[d][i] = __ldcg(frag + i * tile + (size_t)(kg + KG * d) * 32 + lane);
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
        const int i0 = r * Ahead;
        int chunk = -1;
        uint32_t stage = 0;
        if (streamed && KG * i0 >= ring.KR) {
            chunk = (KG * i0 - ring.KR) / (KG * Ahead);
            stage = ring_wait(ring, g0 + chunk);
        }
#pragma unroll
        for (int d = 0; d < Ahead; ++d)
#pragma unroll
            for (int i = 0; i < MW; ++i)
                if (i0 + Ahead + d < nk && i < mw)
                    nxt[d][i] = __ldcg(frag + i * tile + (size_t)(kg + KG * (i0 + Ahead + d)) * 32 + lane);
#pragma unroll
        for (int d = 0; d < Ahead; ++d) {
            const int ks = kg + KG * (i0 + d);
            if (i0 + d < nk && mw > 0) {
                uint32_t b[NT][2];
#pragma unroll
                for (int t = 0; t < NT; t += 2) {
                    const uint32_t addr = chunk >= 0 ? stage + r_lane[Stream ? t / 2 : 0] + 32u * (ks - KG * i0)
                                                     : b_lane[t / 2] + 32u * ks;  // bytes of 16 bf16
                    if (t + 1 < NT) {
                        uint32_t q[4];
                        ldmatrix_x4(q, addr);
                        b[t][0] = q[0];
                        b[t][1] = q[1];
                        b[t + 1][0] = q[2];
                        b[t + 1][1] = q[3];
                    } else {
                        ldmatrix_x2(b[t], addr);
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
        if (chunk >= 0) ring_release(ring, g0 + chunk);
#pragma unroll
        for (int d = 0; d < Ahead; ++d)
#pragma unroll
            for (int i = 0; i < MW; ++i) cur[d][i] = nxt[d][i];
    }
}

// The W slice of the forward, 3U rows (w_index layout): row g U + ul,
// column k = W[k][g H + u0 + ul] (zero past H), for k < KP. A warp reads 8
// rows k of 4 float4s (64 contiguous bytes each).
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
// W_hh, contiguous (zero past 3H and H), for k < KP.
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
    zero_counters<kThreads>(ctr, n);
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
    const bf16* wst;  // the streamed chunks [2][unit tiles][NC][chunk] (gru_grid_stream_layout_kernel)
    int T, N, H, U, R;
    int KR, NC, S;    // resident k16 steps, chunks a product, ring stages (S = 0: all resident)
};

// UG unit groups of 8 a block (U = 8 UG). Warp (mt, kg) does the gate math
// of unit groups kg G .. kg G + G - 1 (those below UG; G = ceil(UG / 2)) of
// its m16 tile. `Stream`: the kernel of the streamed plans (a ring, S >
// 0). `MS` (passes of 128 rows): warp w takes m16 tile w of a pass over
// it. Above kGateUnits (MS only) the product is one wgmma a gate, n = U.
template <int UG, bool Stream, bool MS>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_fwd_kernel(const FwdArgs a) {
    constexpr int U = 8 * UG, NT = 3 * UG;
    constexpr int Gates = U > kGateUnits ? 3 : 1;  // wgmma products a k16 step
    // The per-gate plans park the accumulators in the ring's stages (4
    // stages of 4 k16 steps x 3U rows: 128 rows x 3U f32, exactly) for the
    // gate math, which then reads them a group at a time: 3U accumulators
    // a thread left too few registers for its loads (ptxas spilled them).
    constexpr bool Park = U > kGateUnits;
    constexpr int G = MS ? UG : (UG + 1) / 2;   // unit groups of a warp's gate math
    constexpr int Batch = MS ? 4 : fwd_batch(Stream);
    constexpr bool Pre = UG <= 4 && !MS;        // its inputs loaded before the product
    constexpr int Slots = fwd_slots(UG);
    constexpr int PR = MS ? 2 * kPassRows : kPassRows;  // rows a pass
    constexpr int Xchg = MS ? 0 : fwd_xchg(UG);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H;
    const Tile tl = block_tile(N, H, U, a.R);
    const int KP = round16(H), KS = KP / 16;
    const int KR = Stream && a.S > 0 ? a.KR : KS;  // resident k16 steps
    bf16* wt = reinterpret_cast<bf16*>(smem_raw);  // 3U rows x 16 KR: row g U + ul = W[:, g H + u0 + ul]
    float4* xchg = reinterpret_cast<float4*>(wt + (size_t)3 * U * 16 * KR);  // [2][kMT][Slots][32]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int mt = warp % kMT, kg = MS ? 0 : warp / kMT;
    const int mtile = MS ? warp : mt;  // the warp's m16 tile in a pass
    const int passes = (tl.rows + PR - 1) / PR;

    // The streamed kernel's A staging, this warp's part, after the exchange.
    uint4* astage = reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xchg) + Xchg) +
                    (size_t)warp * kAStages * Batch * 32;
    Ring ring = {};
    if (Stream && a.S > 0) {
        ring = make_ring(reinterpret_cast<unsigned char*>(xchg) + Xchg + fwd_astage(Batch),
                         a.wst + ((size_t)tl.dir * tl.UT + tl.u0 / U) * a.NC * (fwd_chunk_bytes(U) / 2),
                         KR, a.NC, a.S, fwd_chunk_bytes(U), U > kGateUnits);
        ring_init(ring);
        ring.total = (unsigned)(T - 1) * passes * a.NC;
        if (Park) ring.limit = a.NC;  // the first product's chunks
        __syncthreads();
        ring_fill(ring);  // the first S chunks: they depend on nothing the launch writes
    }
    float4* park = reinterpret_cast<float4*>(ring.stage0);  // [NT][kThreads]
    load_w_fwd(wt, a.w_hh + (size_t)tl.dir * H * H3, H, U, tl.u0, 16 * KR);
    // This thread's gate-math units: unit + 8 j of group kg G + j, j < G.
    const int unit = tl.u0 + 8 * G * kg + 2 * tig;
    bool uok[G];
    float2 bias[Pre ? G : 1][3];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        uok[j] = kg * G + j < UG && unit + 8 * j < H;
        if (Pre) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt)
                bias[Pre ? j : 0][gt] = uok[j] ? io::ldg2(a.b_hh + tl.dir * H3 + gt * H + unit + 8 * j)
                                               : make_float2(0.f, 0.f);
        }
    }
    start(a.ctr, 2 * tl.RT);

    const bf16* px = tl.dir == 0 ? a.px_f : a.px_b;
    bf16* ys = tl.dir == 0 ? a.ys_f : a.ys_b;
    float* hs = a.hs + (size_t)tl.dir * N * H;
    const size_t frag_len = (size_t)((N + 15) / 16) * KS * 32 * 4;  // words of one parity
    uint32_t* frag = a.frag + (size_t)tl.dir * 2 * frag_len;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;
    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? step : T - 1 - step;
        const uint32_t* fprev = frag + (size_t)((step + 1) & 1) * frag_len;
        uint32_t* fnext = frag + (size_t)(step & 1) * frag_len;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int m0 = tl.n0 + p * PR;  // the pass's first batch row
            const int rows = min(PR, tl.rows - p * PR);
            const bool active = 16 * mtile < rows;  // warp-uniform
            // The gate math's inputs of group j, row half `half`: px's
            // three gates and the f32 state. Up to 32 units a block all
            // loads at once, in flight during the product.
            const auto inputs = [&](int j, int half, uint32_t (&x)[3], float2& h) {
                const int row = 16 * mtile + gid + 8 * half;
                const bool ok = active && uok[j] && row < rows;
                const size_t m = (size_t)m0 + row;
                const bf16* xp = px + ((size_t)t * N + m) * H3 + unit + 8 * j;
#pragma unroll
                for (int gt = 0; gt < 3; ++gt)
                    x[gt] = ok ? __ldg(reinterpret_cast<const unsigned int*>(xp + gt * H)) : 0u;
                h = ok && step > 0 ? *reinterpret_cast<const float2*>(hs + m * H + unit + 8 * j)
                                   : make_float2(0.f, 0.f);
            };
            uint32_t xv[Pre ? G : 1][2][3];
            float2 h0[Pre ? G : 1][2];
            if (Pre) {
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int half = 0; half < 2; ++half) inputs(j, half, xv[Pre ? j : 0][half], h0[Pre ? j : 0][half]);
            }
            // n8 tile t of acc: gate t / UG, unit group t % UG.
            float acc[NT][4];
            if (step > 0) {
                __syncthreads();  // the warpgroup reconverged: wgmma runs it as one
                // (Park: every thread has read the last pass's sums; its
                // ring may refill the stages up to this product's end.)
                if (Park && tid == 0) ring.limit = (unsigned)((step - 1) * passes + p + 1) * a.NC;
                wg_product<NT, Batch, Stream, MS ? 1 : 2, Gates>(
                    acc, reinterpret_cast<const uint4*>(fprev) + (size_t)(m0 / 16 + mtile) * KS * 32, active,
                    KS, kg, H % 16 != 0, smem_u32(wt), ring, (unsigned)((step - 1) * passes + p) * a.NC,
                    astage);
            }
            // s[j][gt]: the sums of gate gt of group kg G + j, k group 0's
            // partial plus group 1's (MS: the warp's own). (Register arrays
            // take compile-time indices only: the groups are picked by
            // value.)
            float4 s[G][3];
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
                for (int gt = 0; gt < 3; ++gt) s[j][gt] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (step > 0 && MS && !Park) {
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int gt = 0; gt < 3; ++gt) s[j][gt] = frag4(acc[gt * UG + (MS ? j : 0)]);
            }
            if (step > 0) {
                __syncthreads();  // the previous pass's sums have been read
                if (active && !MS) {
                    float4* mine = xchg + (size_t)(kg * kMT + mt) * Slots * 32;
#pragma unroll
                    for (int j = 0; j < G; ++j)
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            // group G (1 - kg) + j: the other k group's
                            const int g0 = gt * UG + j, g1 = gt * UG + (G + j < UG ? G + j : j);
                            mine[(j * 3 + gt) * 32 + lane] = kg == 0 ? frag4(acc[g1]) : frag4(acc[g0]);
                        }
                }
                if (Park) {  // every product has read its last chunk: the stages hold the sums
#pragma unroll
                    for (int i = 0; i < NT; ++i) park[(size_t)i * kThreads + tid] = frag4(acc[i]);
                    fence_proxy_async();  // before the ring's copies overwrite them
                }
                if (!MS) __syncthreads();
                if (active && !MS) {
                    const float4* other = xchg + (size_t)((1 - kg) * kMT + mt) * Slots * 32;
#pragma unroll
                    for (int j = 0; j < G; ++j)
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            const int g0 = gt * UG + j, g1 = gt * UG + (G + j < UG ? G + j : j);
                            const float4 own = kg == 0 ? frag4(acc[g0]) : frag4(acc[g1]);
                            const float4 o = other[(j * 3 + gt) * 32 + lane];
                            s[j][gt] = kg == 0 ? add4(own, o) : add4(o, own);
                        }
                }
            }
            if (!active) continue;
            // Park: the next group's inputs load before this group's stores
            // (which the compiler must assume may alias them), so that a
            // group's loads wait one latency, not each of them in turn (on
            // an H100 at 5288 the gate math took 65 k cycles a step
            // without, 11 groups a thread).
            uint32_t xq[Park ? 2 : 1][2][3];
            float2 hq[Park ? 2 : 1][2], bq[Park ? 2 : 1][3];
            const auto fetch = [&](int j, int b) {
#pragma unroll
                for (int half = 0; half < 2; ++half) inputs(j, half, xq[b][half], hq[b][half]);
#pragma unroll
                for (int gt = 0; gt < 3; ++gt)
                    bq[b][gt] = uok[j] ? io::ldg2(a.b_hh + tl.dir * H3 + gt * H + unit + 8 * j)
                                       : make_float2(0.f, 0.f);
            };
            if (Park) fetch(0, 0);
#pragma unroll
            for (int j = 0; j < G; ++j) {
                if (Park && j + 1 < G) fetch(j + 1, Park ? (j + 1) & 1 : 0);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 16 * mtile + gid + 8 * half;
                    if (!uok[j] || row >= rows) continue;
                    const int u = unit + 8 * j;
                    const size_t m = (size_t)m0 + row;
                    uint32_t xl[3];
                    float2 hl;
                    float2 bl[3];
                    if (Park) {
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            xl[gt] = xq[Park ? j & 1 : 0][half][gt];
                            bl[gt] = bq[Park ? j & 1 : 0][gt];
                        }
                        hl = hq[Park ? j & 1 : 0][half];
                    } else if (Pre) {
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) {
                            xl[gt] = xv[Pre ? j : 0][half][gt];
                            bl[gt] = bias[Pre ? j : 0][gt];
                        }
                        hl = h0[Pre ? j : 0][half];
                    } else {
                        inputs(j, half, xl, hl);
#pragma unroll
                        for (int gt = 0; gt < 3; ++gt) bl[gt] = io::ldg2(a.b_hh + tl.dir * H3 + gt * H + u);
                    }
                    const float2 xr = as2(xl[0]), xz = as2(xl[1]), xn = as2(xl[2]);
                    float4 sg[3];
#pragma unroll
                    for (int gt = 0; gt < 3; ++gt)
                        sg[gt] = !Park ? s[j][gt] : step > 0 ? park[(size_t)(gt * UG + j) * kThreads + tid]
                                                             : make_float4(0.f, 0.f, 0.f, 0.f);
                    const float sr[2] = {half ? sg[0].z : sg[0].x, half ? sg[0].w : sg[0].y};
                    const float sz[2] = {half ? sg[1].z : sg[1].x, half ? sg[1].w : sg[1].y};
                    const float sn[2] = {half ? sg[2].z : sg[2].x, half ? sg[2].w : sg[2].y};
                    float h[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float r = sigmoid((e ? xr.y : xr.x) + (sr[e] + (e ? bl[0].y : bl[0].x)));
                        const float z = sigmoid((e ? xz.y : xz.x) + (sz[e] + (e ? bl[1].y : bl[1].x)));
                        const float cn =
                            tanhf((e ? xn.y : xn.x) + r * (sn[e] + (e ? bl[2].y : bl[2].x)));
                        h[e] = (1.f - z) * cn + z * (e ? hl.y : hl.x);
                    }
                    *reinterpret_cast<float2*>(hs + m * H + u) = make_float2(h[0], h[1]);
                    const uint32_t hw = pack_bf16(h[0], h[1]);
                    *reinterpret_cast<uint32_t*>(ys + ((size_t)t * N + m) * H + u) = hw;
                    fnext[frag_word((int)m, u, KS)] = hw;
                }
            }
        }
        if (step + 1 < T) signal_step(ctr);
        if (Park && tid == 0 && step + 1 < T) {
            // signal_step's barrier: every thread has read this step's sums,
            // so the next product's first chunks may land in the stages.
            const unsigned g0 = (unsigned)(step * passes) * a.NC;
            ring.limit = g0 + a.NC;
            while (ring.issued < ring_end(ring) && ring.issued < g0 + a.S && ring_free(ring, ring.issued))
                ring_issue(ring, ring.issued++);
        }
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
    const bf16* wst; // the streamed chunks, as the forward's
    int T, N, H, U, R;
    int KR, NC, S;
};

// Unit groups of 8 below UG that k group q (of 4) does not own (g % 4 !=
// q) and come before g: where a warp of group q puts group g's partials
// among its slots.
__device__ __forceinline__ int chain_rank(int g, int q) { return g - (g > q ? (g - q + 3) / 4 : 0); }

// UG unit groups of 8 a block (U = 8 UG). Warp w: m16 tiles MW mp .. MW mp
// + MW - 1 of a pass of 32 MW rows (mp = w % 2; MW = PR / 32) and the
// k16 steps kg, kg + 4, ... (kg = w / 2); it does the gate math of the
// unit groups kg, kg + 4, ... (those below UG) of its tiles. `Stream` as
// for the forward.
template <int UG, bool Stream, int MW>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_chain_kernel(const ChainArgs a) {
    constexpr int U = 8 * UG;
    constexpr int KG = 4;
    constexpr int OWN = (UG + KG - 1) / KG;  // unit groups a k group owns, at most
    constexpr bool Pre = UG <= 4 && MW == 2; // the gate math's inputs loaded before the product
    constexpr int Slots = chain_slots(UG) * MW / 2;
    constexpr int PR = 32 * MW;              // rows a pass (a round of the k groups, KG * kChainAhead
                                             // k16 steps, is one ring chunk, kChainChunk)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, M = T * N;
    const Tile tl = block_tile(N, H, U, a.R);
    const int KP = round16(H3), KS = KP / 16;
    const int KR = Stream && a.S > 0 ? a.KR : KS, WS = w_stride(16 * KR);
    bf16* wc = reinterpret_cast<bf16*>(smem_raw);  // [U][WS]: wc[ul][j] = W[u0 + ul][j]
    float4* xchg = reinterpret_cast<float4*>(wc + (size_t)U * WS);  // [KG][2][Slots][32]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int mp = warp % 2, kg = warp / 2;
    const int passes = (tl.rows + PR - 1) / PR;

    Ring ring = {};
    if (Stream && a.S > 0) {
        ring = make_ring(reinterpret_cast<unsigned char*>(xchg) + chain_xchg(UG, MW),
                         a.wst + ((size_t)tl.dir * tl.UT + tl.u0 / U) * a.NC * (chain_chunk_bytes(U) / 2),
                         KR, a.NC, a.S, chain_chunk_bytes(U));
        ring_init(ring);
        ring.total = (unsigned)(T - 1) * passes * a.NC;
        __syncthreads();
        ring_fill(ring);  // the first S chunks: they depend on nothing the launch writes
    }
    load_w_chain(wc, a.w_hh + (size_t)tl.dir * H * H3, H, U, tl.u0, 16 * KR, WS);
    const int u = tl.u0 + 8 * kg + 2 * tig;  // this thread's two units of group kg (+ 32 o of group kg + 4 o)
    bool uok[OWN];
#pragma unroll
    for (int o = 0; o < OWN; ++o) uok[o] = kg + KG * o < UG && u + 32 * o < H;
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
    // db: this warp's column sums of da_r, da_z, dhn over its rows and the
    // steps so far, by owned group, gate and unit e (every lane of a tig).
    float dbs[OWN][3][2];
#pragma unroll
    for (int o = 0; o < OWN; ++o)
#pragma unroll
        for (int q = 0; q < 3; ++q) dbs[o][q][0] = dbs[o][q][1] = 0.f;

    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? T - 1 - step : step;
        const uint32_t* fprev = frag + (size_t)((step + 1) & 1) * frag_len;
        uint32_t* fnext = frag + (size_t)(step & 1) * frag_len;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int m0 = tl.n0 + p * PR;
            const int rows = min(PR, tl.rows - p * PR);
            const int mw = min(MW, max(0, (rows - 16 * MW * mp + 15) / 16));  // this warp's tiles (warp-uniform)
            // The gate math's inputs of owned group o, tile i, row half
            // `half`: the coefficients, dy and the carried dht * z. Up to 32
            // units a block all loads at once, in flight during the product.
            const auto inputs = [&](int o, int i, int half, float2 (&c)[kNC], uint32_t& g, float2& c0) {
                const int row = 16 * MW * mp + 16 * i + gid + 8 * half;
                const bool ok = uok[o] && row < rows;
                const size_t n = (size_t)m0 + row;
                const size_t m = (size_t)t * N + n;
                const int uo = u + 32 * o;
#pragma unroll
                for (int q = 0; q < kNC; ++q)
                    c[q] = ok ? io::ldg2(cf + (m * kNC + q) * H + uo) : make_float2(0.f, 0.f);
                g = ok ? __ldg(reinterpret_cast<const unsigned int*>(dy + m * H + uo)) : 0u;
                c0 = ok && step > 0 ? *reinterpret_cast<const float2*>(carry + n * H + uo)
                                    : make_float2(0.f, 0.f);
            };
            float2 cv[MW][2][Pre ? kNC : 1], c0v[MW][2];
            uint32_t g2[MW][2];
            if (Pre) {
#pragma unroll
                for (int i = 0; i < MW; ++i)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        float2 c[kNC];
                        inputs(0, i, half, c, g2[i][half], c0v[i][half]);
#pragma unroll
                        for (int q = 0; q < (Pre ? kNC : 1); ++q) cv[i][half][q] = c[q];
                    }
            }
            float acc[MW][UG][4];
            if (step > 0 && (Stream || mw > 0))
                warp_product<MW, UG, KG, kChainAhead, Stream>(
                    acc, reinterpret_cast<const uint4*>(fprev) + (size_t)(m0 / 16 + MW * mp) * KS * 32, mw, KS,
                    kg, H % 16 != 0, wc, WS, brow, ring, (unsigned)((step - 1) * passes + p) * a.NC);
            // s[o][i]: dh's product for owned group o of tile i, the four k
            // groups' partials added in k-group order. (Register arrays
            // take compile-time indices only: the groups are picked by
            // value.)
            float4 s[OWN][MW];
#pragma unroll
            for (int o = 0; o < OWN; ++o)
#pragma unroll
                for (int i = 0; i < MW; ++i) s[o][i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (step > 0) {
                __syncthreads();  // the previous pass's sums have been read
                if (mw > 0) {
                    float4* mine = xchg + (size_t)(kg * 2 + mp) * Slots * 32;
#pragma unroll
                    for (int g = 0; g < UG; ++g)
#pragma unroll
                        for (int i = 0; i < MW; ++i)
                            if (g % KG != kg) mine[(chain_rank(g, kg) * MW + i) * 32 + lane] = frag4(acc[i][g]);
                }
                __syncthreads();
                if (mw > 0) {
#pragma unroll
                    for (int o = 0; o < OWN; ++o) {
                        const int og = kg + KG * o;
                        if (og >= UG) continue;  // warp-uniform
#pragma unroll
                        for (int q = 0; q < KG; ++q) {
#pragma unroll
                            for (int i = 0; i < MW; ++i) {
                                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                                if (q == kg) {
#pragma unroll
                                    for (int g = 0; g < UG; ++g)
                                        if (g == og) v = frag4(acc[i][g]);
                                } else {
                                    v = xchg[((size_t)(q * 2 + mp) * Slots + chain_rank(og, q) * MW + i) * 32 + lane];
                                }
                                s[o][i] = add4(s[o][i], v);
                            }
                        }
                    }
                }
            }
            if (mw == 0) continue;  // warp-uniform
#pragma unroll
            for (int o = 0; o < OWN; ++o) {
                if (kg + KG * o >= UG) continue;  // warp-uniform
                const int uo = u + 32 * o;
                float d[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};  // column sums of da_r, da_z, dhn
#pragma unroll
                for (int i = 0; i < MW; ++i)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = 16 * MW * mp + 16 * i + gid + 8 * half;
                        const bool ok = uok[o] && row < rows;
                        const size_t n = (size_t)m0 + row;
                        const size_t m = (size_t)t * N + n;
                        float2 c[kNC], c0;
                        uint32_t gw;
                        if (Pre) {
#pragma unroll
                            for (int q = 0; q < kNC; ++q) c[q] = cv[i][half][Pre ? q : 0];
                            gw = g2[i][half];
                            c0 = c0v[i][half];
                        } else {
                            inputs(o, i, half, c, gw, c0);
                        }
                        const float2 dyv = as2(gw);
                        const float sp[2] = {half ? s[o][i].z : s[o][i].x, half ? s[o][i].w : s[o][i].y};
                        float da_r[2], da_z[2], da_c[2], dhn[2], keep[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float dht = ((e ? c0.y : c0.x) + sp[e]) + (e ? dyv.y : dyv.x);
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
                        bf16* out = dpx + m * H3 + uo;
                        const uint32_t wr = pack_bf16(da_r[0], da_r[1]), wz = pack_bf16(da_z[0], da_z[1]),
                                       wn = pack_bf16(dhn[0], dhn[1]);
                        *reinterpret_cast<uint32_t*>(out) = wr;
                        *reinterpret_cast<uint32_t*>(out + H) = wz;
                        io::st2(out + 2 * H, da_c[0], da_c[1]);
                        *reinterpret_cast<uint32_t*>(dn + m * H + uo) = wn;
                        *reinterpret_cast<float2*>(carry + n * H + uo) = make_float2(keep[0], keep[1]);
                        fnext[frag_word((int)n, uo, KS)] = wr;
                        fnext[frag_word((int)n, H + uo, KS)] = wz;
                        fnext[frag_word((int)n, 2 * H + uo, KS)] = wn;
                    }
                // The column sums over the warp's 16 MW rows: its own 2 MW,
                // then the 8 lanes of a tig (lane bits 2-4).
#pragma unroll
                for (int q = 0; q < 3; ++q)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float v = d[q][e];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        dbs[o][q][e] += v;
                    }
            }
        }
        if (step + 1 < T) signal_step(ctr);
    }

    // db of the block's 3U columns over its rows and all steps: the two
    // m-pair warps' sums added in order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(xchg);  // [2][3][U]
    if (gid == 0) {
#pragma unroll
        for (int o = 0; o < OWN; ++o)
            if (kg + KG * o < UG)
#pragma unroll
                for (int q = 0; q < 3; ++q)
#pragma unroll
                    for (int e = 0; e < 2; ++e) red[(mp * 3 + q) * U + 8 * (kg + KG * o) + 2 * tig + e] = dbs[o][q][e];
    }
    __syncthreads();
    for (int i = tid; i < 3 * U; i += kThreads) {
        const int q = i / U, ul = i % U;
        if (tl.u0 + ul >= H) continue;
        a.dbp[((size_t)tl.rt * 2 + tl.dir) * H3 + q * H + tl.u0 + ul] = red[q * U + ul] + red[(3 + q) * U + ul];
    }
}

// The W_hh^T slice of the per-gate plans' chain in the forward's layout
// (w_index, U rows): row ul, column k = W[u0 + ul][k] (zero past 3H and
// H), for k < KP. A thread reads 4 consecutive k of a row (one float4) and
// writes them as one 8-byte word (k % 8 stays inside a core matrix's row).
__device__ __forceinline__ void load_w_chain_gate(bf16* wt, const float* W, int H, int U, int u0,
                                                  int KP) {
    const int H3 = 3 * H, q4 = KP / 4, total = U * q4;
    for (int i = threadIdx.x; i < total; i += kThreads) {
        const int ul = i / q4, k = 4 * (i % q4);
        const float4 v = k < H3 && u0 + ul < H ? io::ldg4(W + (size_t)(u0 + ul) * H3 + k)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
        uint2 p;
        p.x = pack_bf16(v.x, v.y);
        p.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(wt + w_index(ul, k, U / 8)) = p;
    }
}

// The chain of the per-gate plans (U = 8 UG above kGateUnits units a
// block, W streamed; the same contract as gru_grid_chain_kernel). Its
// product runs on wgmma as the forward's does (wg_product, one m64nUk16 a
// k16 step, B the block's U rows of W_hh^T in the forward's layout through
// a ring of kGateChunk-step chunks, A staged in shared memory by
// cp.async): passes of 128 rows, warp w holds m16 tile w of a pass over
// the whole contraction, so no partial sums meet and the ring is read once
// a pass for all of its rows (gru_grid_chain_kernel's warps would take 2
// m16 tiles each in passes of 64 rows, and stream the slice once for each
// pass). A thread then does the gate math of its tile's two rows for
// every unit group (2 units each). db: a warp's column sums over its rows
// by shuffles, then over the steps in shared memory (in registers they
// took 66 a thread at 88 units), then over the 8 warps in warp order.
template <int UG>
__global__ void __launch_bounds__(kThreads, 1) gru_grid_chain_gate_kernel(const ChainArgs a) {
    constexpr int U = 8 * UG, PR = 2 * kPassRows, Batch = kGateChunk;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int T = a.T, N = a.N, H = a.H, H3 = 3 * H, M = T * N;
    const Tile tl = block_tile(N, H, U, a.R);
    const int KS = round16(H3) / 16, KR = a.KR;
    bf16* wt = reinterpret_cast<bf16*>(smem_raw);  // U rows x 16 KR (w_index): row ul = W[u0 + ul][:]
    unsigned char* after = smem_raw + (size_t)32 * U * KR;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int passes = (tl.rows + PR - 1) / PR;
    uint4* astage = reinterpret_cast<uint4*>(after) + (size_t)warp * kGateAStages * Batch * 32;
    Ring ring = make_ring(after + gate_chain_astage(),
                          a.wst + ((size_t)tl.dir * tl.UT + tl.u0 / U) * a.NC * (gate_chain_chunk_bytes(U) / 2),
                          KR, a.NC, a.S, gate_chain_chunk_bytes(U));
    ring.lazy = true;
    ring_init(ring);
    ring.total = (unsigned)(T - 1) * passes * a.NC;
    // db: each warp's column sums of da_r, da_z, dhn over its rows and the
    // steps so far, [8 warps][3][U], after the ring.
    float* red = reinterpret_cast<float*>(ring.empty + a.S);
    for (int i = tid; i < 8 * 3 * U; i += kThreads) red[i] = 0.f;
    __syncthreads();
    ring_fill(ring);  // the first S chunks: they depend on nothing the launch writes
    load_w_chain_gate(wt, a.w_hh + (size_t)tl.dir * H * H3, H, U, tl.u0, 16 * KR);
    const int u = tl.u0 + 2 * tig;  // this thread's two units of group 0 (+ 8 g of group g)
    start(a.ctr, 2 * tl.RT);

    const bf16* dy = tl.dir == 0 ? a.dy_f : a.dy_b;
    bf16* dpx = tl.dir == 0 ? a.dpx_f : a.dpx_b;
    bf16* dn = a.dhn + (size_t)tl.dir * M * H;
    const float* cf = a.coef + (size_t)tl.dir * M * kNC * H;
    float* carry = a.carry + (size_t)tl.dir * N * H;
    const size_t frag_len = (size_t)((N + 15) / 16) * KS * 32 * 4;
    uint32_t* frag = a.frag + (size_t)tl.dir * 2 * frag_len;
    unsigned* ctr = a.ctr + tl.dir * tl.RT + tl.rt;

    for (int step = 0; step < T; ++step) {
        const int t = tl.dir == 0 ? T - 1 - step : step;
        const uint32_t* fprev = frag + (size_t)((step + 1) & 1) * frag_len;
        uint32_t* fnext = frag + (size_t)(step & 1) * frag_len;
        if (step > 0) wait_steps(ctr, (unsigned)(tl.UT * step));
#pragma unroll 1
        for (int p = 0; p < passes; ++p) {
            const int m0 = tl.n0 + p * PR;
            const int rows = min(PR, tl.rows - p * PR);
            const bool active = 16 * warp < rows;  // warp-uniform
            // n8 tile g of acc: unit group g, rows gid (+8) of the warp's tile.
            float acc[UG][4];
            if (step > 0) {
                __syncthreads();  // the warpgroup reconverged: wgmma runs it as one
                wg_product<UG, Batch, true, 1, 1, kGateAStages, kGateChunk>(
                    acc, reinterpret_cast<const uint4*>(fprev) + (size_t)(m0 / 16 + warp) * KS * 32, active,
                    KS, 0, H3 % 16 != 0, smem_u32(wt), ring, (unsigned)((step - 1) * passes + p) * a.NC,
                    astage);
            } else {
#pragma unroll
                for (int g = 0; g < UG; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
            }
            if (!active) continue;
            // The gate math's inputs of group g (the coefficients, dy, the
            // carried dht * z), each row half: the next group's load before
            // this group's stores (which the compiler must assume may alias
            // them), so that a group's loads wait one latency, not each in
            // turn.
            float2 cq[2][2][kNC], c0q[2][2];
            uint32_t dq[2][2];
            const auto fetch = [&](int g, int b) {
                const int uo = u + 8 * g;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 16 * warp + gid + 8 * half;
                    const bool ok = uo < H && row < rows;
                    const size_t n = (size_t)m0 + row;
                    const size_t m = (size_t)t * N + n;
#pragma unroll
                    for (int q = 0; q < kNC; ++q)
                        cq[b][half][q] = ok ? io::ldg2(cf + (m * kNC + q) * H + uo) : make_float2(0.f, 0.f);
                    dq[b][half] = ok ? __ldg(reinterpret_cast<const unsigned int*>(dy + m * H + uo)) : 0u;
                    c0q[b][half] = ok && step > 0 ? *reinterpret_cast<const float2*>(carry + n * H + uo)
                                                  : make_float2(0.f, 0.f);
                }
            };
            fetch(0, 0);
#pragma unroll
            for (int g = 0; g < UG; ++g) {
                if (g + 1 < UG) fetch(g + 1, (g + 1) & 1);
                const int uo = u + 8 * g;
                float d[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};  // column sums of da_r, da_z, dhn
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = 16 * warp + gid + 8 * half;
                    const bool ok = uo < H && row < rows;
                    const size_t n = (size_t)m0 + row;
                    const size_t m = (size_t)t * N + n;
                    const float2 (&c)[kNC] = cq[g & 1][half];
                    const float2 dyv = as2(dq[g & 1][half]), c0 = c0q[g & 1][half];
                    const float sp[2] = {acc[g][2 * half], acc[g][2 * half + 1]};
                    float da_r[2], da_z[2], da_c[2], dhn[2], keep[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float dht = ((e ? c0.y : c0.x) + sp[e]) + (e ? dyv.y : dyv.x);
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
                    bf16* out = dpx + m * H3 + uo;
                    const uint32_t wr = pack_bf16(da_r[0], da_r[1]), wz = pack_bf16(da_z[0], da_z[1]),
                                   wn = pack_bf16(dhn[0], dhn[1]);
                    *reinterpret_cast<uint32_t*>(out) = wr;
                    *reinterpret_cast<uint32_t*>(out + H) = wz;
                    io::st2(out + 2 * H, da_c[0], da_c[1]);
                    *reinterpret_cast<uint32_t*>(dn + m * H + uo) = wn;
                    *reinterpret_cast<float2*>(carry + n * H + uo) = make_float2(keep[0], keep[1]);
                    fnext[frag_word((int)n, uo, KS)] = wr;
                    fnext[frag_word((int)n, H + uo, KS)] = wz;
                    fnext[frag_word((int)n, 2 * H + uo, KS)] = wn;
                }
                // The column sums over the warp's 16 rows: its own 2, then
                // the 8 lanes of a tig (lane bits 2-4), into the warp's sums.
#pragma unroll
                for (int q = 0; q < 3; ++q)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float v = d[q][e];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        if (gid == 0) red[(warp * 3 + q) * U + 8 * g + 2 * tig + e] += v;
                    }
            }
        }
        if (step + 1 < T) signal_step(ctr);
    }

    // db of the block's 3U columns over its rows and all steps: the 8
    // warps' sums added in warp order.
    __syncthreads();
    for (int i = tid; i < 3 * U; i += kThreads) {
        const int q = i / U, ul = i % U;
        if (tl.u0 + ul >= H) continue;
        float v = red[q * U + ul];
        for (int w = 1; w < kThreads / 32; ++w) v += red[(w * 3 + q) * U + ul];
        a.dbp[((size_t)tl.rt * 2 + tl.dir) * H3 + q * H + tl.u0 + ul] = v;
    }
}

// ---------------------------------------------------------------------
// the streamed chunks

// The bytes of a streamed chunk of kind 0 (the forward), 1 (the chain) or
// 2 (the per-gate plans' chain).
__host__ __device__ constexpr size_t stream_chunk_bytes(int kind, int U) {
    return kind == 0 ? fwd_chunk_bytes(U) : kind == 1 ? chain_chunk_bytes(U) : gate_chain_chunk_bytes(U);
}

// Every block's streamed chunks of its W slice, [2 dirs][unit tiles][NC][a
// chunk's elements] bf16, each chunk in its ring stage's layout: kind 0 the
// forward's (3U rows, wgmma's K-major core matrices of w_index, k counted
// from the chunk's first step, 16 (KR + 4 c)), kind 1 the chain's ([U]
// rows W_hh[u0 + ul] of stride w_stride(128) from k = 16 (KR + 8 c), the 8
// past each row zero), kind 2 the per-gate plans' chain's (U rows W_hh[u0
// + ul] in w_index from k = 16 (KR + 4 c)); zero past H and 3H.
__global__ void __launch_bounds__(kThreads) gru_grid_stream_layout_kernel(
    const float* __restrict__ w_hh, bf16* __restrict__ out, int H, int U, int KR, int NC, int kind) {
    const int H3 = 3 * H, UT = (H + U - 1) / U;
    const size_t elems = stream_chunk_bytes(kind, U) / 2;
    const size_t total = (size_t)2 * UT * NC * elems;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        const size_t e = i % elems, rest = i / elems;
        const int c = (int)(rest % NC), ut = (int)(rest / NC % UT), dir = (int)(rest / NC / UT);
        const int u0 = ut * U;
        const float* W = w_hh + (size_t)dir * H * H3;
        float v = 0.f;
        if (kind == 0) {
            const int ng = 3 * U / 8, q = (int)(e >> 6);
            const int cc = (q % ng) * 8 + (int)((e >> 3) & 7), kl = (q / ng) * 8 + (int)(e & 7);
            const int k = 16 * (KR + kFwdChunk * c) + kl, g = cc / U, ul = cc % U;
            if (k < H && u0 + ul < H) v = W[(size_t)k * H3 + g * H + u0 + ul];
        } else if (kind == 2) {
            const int ng = U / 8, q = (int)(e >> 6);
            const int ul = (q % ng) * 8 + (int)((e >> 3) & 7), kl = (q / ng) * 8 + (int)(e & 7);
            const int k = 16 * (KR + kGateChunk * c) + kl;
            if (k < H3 && u0 + ul < H) v = W[(size_t)(u0 + ul) * H3 + k];
        } else {
            const int ws = w_stride(16 * kChainChunk), ul = (int)(e / ws), j = (int)(e % ws);
            const int k = 16 * (KR + kChainChunk * c) + j;
            if (j < 16 * kChainChunk && k < H3 && u0 + ul < H) v = W[(size_t)(u0 + ul) * H3 + k];
        }
        out[i] = __float2bfloat16_rn(v);
    }
}

// ---------------------------------------------------------------------
// launches

// The plan's grid: 2 directions x ceil(N/R) row tiles x ceil(H/U) unit
// tiles; 0 for a plan the kernels do not take (U a multiple of 8 from 24
// to kMaxUnits, R a multiple of 16).
int grid_blocks(int T, int N, int H, int U, int R) {
    if (T < 1 || N < 1 || H < 8 || H % 8 || U < 24 || U > kMaxUnits || U % 8 || R < 16 || R % 16) return 0;
    return 2 * ((N + R - 1) / R) * ((H + U - 1) / U);
}

// The split of a kernel's KS k16 steps (chunks of CK): S = 0 keeps all
// resident (KR = KS); else KR < KS resident steps, a multiple of CK, and
// the chunks a product streams (-1 for a split the kernels do not take).
int stream_chunks(int KS, int KR, int S, int CK) {
    if (S == 0) return KR == KS ? 0 : -1;
    if (S < 1 || KR < 0 || KR >= KS || KR % CK) return -1;
    return (KS - KR + CK - 1) / CK;
}

// The streamed chunks of kind 0 (forward), 1 (chain) or 2 (the per-gate
// plans' chain) into `wst` (of `wst_len` elements, refused if too short),
// one launch; nothing where the plan streams none.
int write_stream(int kind, const float* w_hh, bf16* wst, long long wst_len, int H, int U, int KR,
                 int NC, cudaStream_t stream) {
    if (NC == 0) return 0;
    const size_t elems = stream_chunk_bytes(kind, U) / 2;
    const size_t total = (size_t)2 * ((H + U - 1) / U) * NC * elems;
    if (wst == nullptr || wst_len < (long long)total) return (int)cudaErrorInvalidValue;
    const int blocks = (int)std::min((total + kThreads - 1) / kThreads, (size_t)132 * 16);
    gru_grid_stream_layout_kernel<<<blocks, kThreads, 0, stream>>>(w_hh, wst, H, U, KR, NC, kind);
    return (int)cudaGetLastError();
}

// The forward of the plan: 24 or 32 units with all of W resident without
// the ring; every other plan with it, its rows split (MS) where the plan
// takes passes of 128 rows (always above kGateUnits).
const void* gru_grid_fwd_kernel_for(int UG, bool stream, bool ms) {
    if (!stream) return UG == 3 ? (const void*)gru_grid_fwd_kernel<3, false, false> : (const void*)gru_grid_fwd_kernel<4, false, false>;
    if (UG > kGateUnits / 8)
        return UG == 11 ? (const void*)gru_grid_fwd_kernel<11, true, true> : (const void*)gru_grid_fwd_kernel<12, true, true>;
#define FWD(ug) (ms ? (const void*)gru_grid_fwd_kernel<ug, true, true> : (const void*)gru_grid_fwd_kernel<ug, true, false>)
    switch (UG) {
        case 3: return FWD(3);
        case 4: return FWD(4);
        case 5: return FWD(5);
        case 6: return FWD(6);
        case 7: return FWD(7);
        case 8: return FWD(8);
        case 9: return FWD(9);
        default: return FWD(10);
    }
#undef FWD
}

// The chain of the plan: as the forward's, the streamed ones of 24 or 32
// units with 4 tiles a warp where the plan takes passes of 128 rows, and
// above kGateUnits the per-gate plans' chain on wgmma.
const void* gru_grid_chain_kernel_for(int UG, bool stream, int MW) {
    if (!stream) return UG == 3 ? (const void*)gru_grid_chain_kernel<3, false, 2> : (const void*)gru_grid_chain_kernel<4, false, 2>;
    if (UG > kGateUnits / 8)
        return UG == 11 ? (const void*)gru_grid_chain_gate_kernel<11> : (const void*)gru_grid_chain_gate_kernel<12>;
    if (MW == 4) return UG == 3 ? (const void*)gru_grid_chain_kernel<3, true, 4> : (const void*)gru_grid_chain_kernel<4, true, 4>;
    switch (UG) {
        case 3: return (const void*)gru_grid_chain_kernel<3, true, 2>;
        case 4: return (const void*)gru_grid_chain_kernel<4, true, 2>;
        case 5: return (const void*)gru_grid_chain_kernel<5, true, 2>;
        case 6: return (const void*)gru_grid_chain_kernel<6, true, 2>;
        case 7: return (const void*)gru_grid_chain_kernel<7, true, 2>;
        case 8: return (const void*)gru_grid_chain_kernel<8, true, 2>;
        case 9: return (const void*)gru_grid_chain_kernel<9, true, 2>;
        default: return (const void*)gru_grid_chain_kernel<10, true, 2>;
    }
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

// Dynamic shared memory of each kernel (kind 0: the forward, 1: the chain)
// for U units a block with KR k16 steps of W resident, a ring of S stages
// (S = 0: all of W resident, KR its k16 steps) and passes of PR rows.
long long ocrs_gru_grid_smem(int kind, int U, int KR, int S, int PR) {
    return (long long)(kind == 0 ? fwd_smem(U, KR, S, PR) : chain_smem(U, KR, S, PR));
}

// The forward: px_f, px_b [T, N, 3H] bf16; w_hh [2, H, 3H] float32 holding
// bf16 values; b_hh [2, 3H] float32; scratch (any contents) hs [2, N, H]
// float32, frag [2, 2, 16 ceil(N/16), round16(H)] bf16, ctr [2 * ceil(N /
// R)] and wst (wst_len bf16: every block's streamed chunks, written here;
// none where S = 0); out ys_f, ys_b [T, N, H] bf16. H % 8 == 0; U (units a
// block), R (rows a block, a multiple of 16), KR (resident k16 steps), S
// (ring stages) and PR (rows a pass) from the plan. The streamed chunks'
// layout (one launch where the plan streams), then one cooperative launch.
int ocrs_gru_grid_fwd_bf16(int device, const bf16* px_f, const bf16* px_b, const float* w_hh,
                           const float* b_hh, float* hs, uint32_t* frag, bf16* ys_f, bf16* ys_b,
                           unsigned* ctr, bf16* wst, long long wst_len, int T, int N, int H, int U,
                           int R, int KR, int S, int PR, void* stream) {
    const int NC = stream_chunks(round16(H) / 16, KR, S, kFwdChunk);
    const int blocks = grid_blocks(T, N, H, U, R);
    if (NC < 0 || blocks == 0 || !grid_variant_ok(0, U, S, PR)) return (int)cudaErrorInvalidValue;
    {
        const RestoreDevice restore_device;
        cudaError_t err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
        const int rc = write_stream(0, w_hh, wst, wst_len, H, U, KR, NC, (cudaStream_t)stream);
        if (rc != 0) return rc;
    }
    const FwdArgs args = {px_f, px_b, w_hh, b_hh, hs, frag, ys_f, ys_b, ctr, wst,
                          T, N, H, U, R, KR, NC, S};
    return launch<kThreads>(gru_grid_fwd_kernel_for(U / 8, S > 0, PR > kPassRows), device, args,
                            blocks, fwd_smem(U, KR, S, PR), stream);
}

// The backward's chain: dy_f, dy_b [T, N, H] bf16; w_hh as above; coef [2,
// T*N, 5, H] from the bf16 coefficients phase; scratch carry [2, N, H]
// float32, frag [2, 2, 16 ceil(N/16), round16(3H)] bf16, ctr [2 * ceil(N /
// R)] and wst as for the forward; out dpx_f, dpx_b [T, N, 3H] bf16, dhn
// [2, T*N, H] bf16 and dbp [db_parts, 2, 3H] float32 (db's partial per row
// tile, for the bf16 dW phase; refused if db_parts < ceil(N / R)). The
// streamed chunks' layout (one launch where the plan streams), then one
// cooperative launch.
int ocrs_gru_grid_chain_bf16(int device, const bf16* dy_f, const bf16* dy_b, const float* w_hh,
                             const float* coef, float* carry, uint32_t* frag, bf16* dpx_f,
                             bf16* dpx_b, bf16* dhn, float* dbp, int db_parts, unsigned* ctr,
                             bf16* wst, long long wst_len, int T, int N, int H, int U, int R,
                             int KR, int S, int PR, void* stream) {
    const bool gate = U > kGateUnits;  // the per-gate plans' chain: wgmma, the forward's chunks
    const int NC = stream_chunks(round16(3 * H) / 16, KR, S, gate ? kGateChunk : kChainChunk);
    const int blocks = grid_blocks(T, N, H, U, R);
    if (NC < 0 || blocks == 0 || !grid_variant_ok(1, U, S, PR) || db_parts < (N + R - 1) / R)
        return (int)cudaErrorInvalidValue;
    {
        const RestoreDevice restore_device;
        cudaError_t err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
        const int rc = write_stream(gate ? 2 : 1, w_hh, wst, wst_len, H, U, KR, NC, (cudaStream_t)stream);
        if (rc != 0) return rc;
    }
    const ChainArgs args = {dy_f, dy_b, w_hh, coef, carry, frag, dpx_f, dpx_b, dhn, dbp, ctr, wst,
                            T, N, H, U, R, KR, NC, S};
    return launch<kThreads>(gru_grid_chain_kernel_for(U / 8, S > 0, PR / 32), device, args,
                            blocks, chain_smem(U, KR, S, PR), stream);
}

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
