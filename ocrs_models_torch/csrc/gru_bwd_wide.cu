// The biGRU backward's two products outside its chain at hidden widths
// above 512, on Hopper's asynchronous tensor-core path (`wgmma`, operands
// brought by the Tensor Memory Accelerator): the coefficients (`coef`) and
// the dW partials (`dw`, with `dw_sum`), in bf16 and (namespace f32) in
// float32 as 3xTF32.
//
// Replaces: the products of the backward of the Pallas kernel
// `gru_recurrence4` in ocrs_models_tpu/ops/pallas/gru_kernel4.py
// (`_bwd_call`, body `_bwd_kernel`): the recomputed ph = h_prev @ W_hh +
// b_hh with the gates, and dW_hh = h_prev^T dph, at the widths of the wide
// route's forms above 512 (ops/gru.py `gru_wide_bwd`, `bwd_phases`; up to
// 512, gru_bwd.cu's `mma.sync` tiles, built for H <= 256). Same
// contract and rounding points as gru_bwd.cu's phases: h_prev is ys in
// scan order (ys_f[t-1], ys_b[t+1], zero at each direction's first step),
// products are summed in f32; `coef` writes per element the five f32
// numbers the chain reads, z, (1-z)(1-c^2), (h_prev-c) z (1-z), r, hn r
// (1-r), into coef [2, T*N, 5, H]; `dw` sums h_prev^T dph over ranges of
// rows into partials that `dw_sum` adds in range order. bf16: ys and W_hh
// bf16, dph = bf16(dph) = [dpx's r and z columns, the chain's dhn], db
// from the chain's partials in tile order. f32: dph = [dpx's r and z
// columns, its n columns times coef's r], db summed here per range, the
// products error-compensated TF32 ("3xTF32", gru_bwd.cu's split).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 495 TFLOP/s TF32, so 165 in
// 3xTF32; 3.35 TB/s HBM): at T=257, N=128, H=1024 each is one product of
// 2 * 257*128 * 1024 * 3072 * 2 directions = 413.9 GFLOP, 0.419 ms in
// bf16, 2.51 ms in 3xTF32 (10.03 ms at H=2048); `coef` also writes its
// 1.35 GB of coefficients (0.40 ms) and `dw` reads ys, dpx and dhn in
// bf16 (0.35 GB); in f32 the pre-passes move W_hh three times (0.08 GB)
// and ys three times (0.81 GB).
//
// Design: two large products over all T*N rows, the shape of a GEMM. A
// block computes 128 x 192 output tiles, one after another (persistent:
// as many blocks as SMs), with three warpgroups: warpgroup 0's first
// thread brings each stage's operands into a ring (bf16: 5 stages of 40
// KB, 64 of the contraction; f32: coef 6 of 32 KB, dw 5 of 40 KB, 16 of
// it) with 2-D TMA copies (`cp.async.bulk.tensor`) in the 128- or
// 64-byte swizzle (a few large copies a stage, whole sectors, rows outside
// the tensors read as zeros), completing on the stage's mbarrier;
// warpgroups 1 and 2 each multiply 64 of the rows, one `wgmma.mma_async`
// m64n192k16 (bf16 -> f32) per k16 step with both operands in shared
// memory by descriptor, K-major or MN-major (through wgmma's transpose
// bit, so that no operand is copied transposed), or in f32 three
// m64n192k8 (tf32 -> f32) per k8 step, A from registers (see namespace
// f32 for why), and free a stage with one arrival a warp once its
// products have read it.
// The copies run ahead across tiles, so one tile's epilogue overlaps the
// next tile's loads. Registers move to the multiplying warpgroups
// (`setmaxnreg`: 40 for the copying one, 232 for them).
// - `coef`: rows (t, n) x 64 units x 3 gates (the r, z, n columns of the
//   units, so that a thread's accumulators hold all three gates of its
//   elements); A = h_prev [rows][H] K-major, B = W_hh [H][3H] MN-major
//   (f32: W_hh^T hi and lo, K-major).
//   The gate epilogue reads px and h_prev and writes the five coefficients
//   straight from the accumulators.
// - `dw`: rows k of dW x 192 columns j of dpx's first 2H or of dhn,
//   contracting over a range of rows (t, n); A = h_prev^T and B =
//   bf16(dph), both MN-major (their rows are the contraction). At H >=
//   1024 its tiles, 2 * ceil(H/128) * (ceil(2H/192) + ceil(H/192)), fill
//   the card in one range (ops/gru.py `_dw_splits`), so the partials add
//   one [2, H, 3H] write and read. f32: the transposed product, rows j
//   of dph (A, from registers) x 192 rows k of dW (B = h_prev^T hi and
//   lo, K-major), 2 * ceil(H/192) * (ceil(2H/128) + ceil(H/128)) tiles.
// - Tile order (tile_place): grouped. At H = 5288 a direction's W_hh (168
//   MB) and h_prev (348 MB) outgrow the 50 MB L2; with the column tiles
//   fastest, the 132 blocks in flight span all of a direction's W_hh
//   columns (coef) or all of dph's (dw) for one or two row tiles, and
//   every wave reads them again from device memory (coef about 86 GB a
//   call, dw 57). In groups of 16 row tiles (coef) or 12 k tiles (dw; f32
//   8), row tiles fastest, the blocks in flight share a few column tiles,
//   each read once a group, while the group's rows stay in L2. In f32 a
//   direction's W_hh^T hi and lo alone fill the L2 at H = 2048.
// Every sum runs in a fixed order and there are no atomics, so reruns
// agree bit for bit.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "bf16_io.cuh"
#include "device_guard.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace tc;
using io::bf16;

constexpr int kThreads = 384;              // warpgroup 0 copies, 1 and 2 multiply
constexpr int kConsumerWarps = 8;
constexpr int kBM = 128;                   // output rows a tile (64 a multiplying warpgroup)
constexpr int kBN = 192;                   // output columns a tile
constexpr int kBK = 64;                    // contraction a stage (4 k16 steps)
constexpr int kStages = 5;
constexpr int kUnits = kBN / 3;            // coef: units a tile (x 3 gates)
constexpr int kNC = 5;                     // coefficients per element
constexpr uint32_t kABytes = kBM * kBK * 2;   // A of a stage (16 KB)
constexpr uint32_t kBBytes = kBK * kBN * 2;   // B of a stage (24 KB)
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr uint32_t kBox = 64 * 64 * 2;        // one 64 x 64 box (8 KB)
// The ring (1024-byte aligned, as the 128-byte swizzle wants), then its
// mbarriers; 1 KB more to align the dynamic shared memory's start.
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kCoefGroup = 16;             // coef: row tiles of a group (grouped order)
constexpr int kDwGroup = 12;               // dw: dW row tiles (k) of a group (grouped order)

// The tile order of the persistent loop over a product's tiles, within
// one direction (coef) or one range of rows and direction (dw), of `outer`
// tiles along the operand that changes slowest in the plain order (coef:
// row tiles of h_prev, RT; dw: row tiles k of dW, KT) x `inner` along the
// other (coef: unit tiles of W_hh's columns, UT; dw: column tiles of dph,
// JT). Order 0, the plain one: inner fastest, so at a wide H the 132
// blocks in flight span every inner tile (a whole direction's W_hh in
// coef, all of dph's columns in dw) for one or two outer tiles, and each
// wave reads those again from device memory. Order 1, grouped: groups of
// `group` outer tiles, within a group outer fastest, so the blocks in
// flight share a few inner tiles (each read once a group) and the group's
// outer tiles stay in L2 while its inner tiles pass. A tile's own sums
// are the same in both: the results are bit for bit equal.
__device__ __forceinline__ void tile_place(int i, int outer, int inner, int group, int order,
                                           int& o, int& in) {
    if (order == 0) {
        o = i / inner;
        in = i % inner;
        return;
    }
    const int first = i / (group * inner) * group, g = min(group, outer - first);
    i -= first * inner;
    o = first + i % g;
    in = i / g;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// The shared-memory descriptor of an operand in the 128-byte swizzle:
// 1024 bytes between groups of 8 rows (its atoms), `lbo` bytes between its
// 64-element blocks along M or N (MN-major; unused K-major).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, bf16 -> f32, A and B from shared memory by
// descriptor, TA / TB their transpose bits (1: MN-major); D = A B +
// (scale_d ? D : 0), the accumulators in mma.sync's C layout, one n8 tile
// after another.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<192> {
    template <int TA, int TB>
    __device__ __forceinline__ static void mma(float (&d)[24][4], uint64_t da, uint64_t db, uint32_t scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
            : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed (traps
// after about ten seconds instead of hanging).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (!done && clock64() - start > (1ll << 34)) __trap();
    } while (!done);
}

// One 2-D TMA copy: the box of `map` at element (c0, c1) (column, row; out
// of the tensor reads as zero) into shared address `dst`, on `bar`.
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                      uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
}

// The ring: stage s at base + s * kStageBytes (A, then B), full[s] when its
// copies have landed (count 1 and the bytes), empty[s] when every
// multiplying warp has read it (count 8). Stage use g of the call (over
// tiles and their k stages) is stage g % kStages, phase g / kStages.
struct Ring {
    uint32_t base;
    uint64_t* full;
    uint64_t* empty;
};

template <int Stages = kStages, uint32_t StageBytes = kStageBytes>
__device__ __forceinline__ Ring ring_setup(unsigned char* smem_raw) {
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    Ring r;
    r.base = smem_u32(smem);
    r.full = reinterpret_cast<uint64_t*>(smem + Stages * StageBytes);
    r.empty = r.full + Stages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < Stages; ++s) {
            mbar_init(r.full + s, 1);
            mbar_init(r.empty + s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return r;
}

// The copying thread: stage use g is free again (its previous use read);
// `bytes` will land in it.
template <int Stages = kStages, uint32_t StageBytes = kStageBytes>
__device__ __forceinline__ uint32_t ring_claim(const Ring& r, unsigned g, uint32_t bytes = StageBytes) {
    const unsigned s = g % Stages, use = g / Stages;
    if (use > 0) mbar_wait(r.empty + s, (use - 1) & 1u);
    mbar_arrive_expect_tx(r.full + s, bytes);
    return r.base + s * StageBytes;
}

// The tile's product in a multiplying warpgroup (wg 0 or 1): n_kt stages
// of uses g0.. of the ring, A at `a_off` in each stage's A (this
// warpgroup's 64 rows), A transposed if TA (then its 64-element block's
// k16 steps 2048 bytes apart; else the 64 k of a row, 32 bytes a k16
// step), B's three 64-element blocks kBox apart, transposed if TB. Each
// warp frees a stage once its products have read it.
template <int TA, int TB>
__device__ __forceinline__ void multiply(float (&acc)[kBN / 8][4], const Ring& r, unsigned g0,
                                         int n_kt, uint32_t a_off) {
    if (n_kt == 0) {
#pragma unroll
        for (int t = 0; t < kBN / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
        return;
    }
    const int lane = threadIdx.x % 32;
#pragma unroll 1
    for (int kt = 0; kt < n_kt; ++kt) {
        const unsigned g = g0 + kt, s = g % kStages;
        mbar_wait(r.full + s, (g / kStages) & 1u);
        const uint32_t a = r.base + s * kStageBytes + a_off, b = r.base + s * kStageBytes + kABytes;
        uint64_t da[kBK / 16], db[kBK / 16];
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
            da[k] = desc(a + (uint32_t)k * (TA ? 2048 : 32), kBox);
            db[k] = desc(b + (uint32_t)k * (TB ? 2048 : 32), kBox);
        }
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
            WgmmaSS<kBN>::template mma<TA, TB>(acc, da[k], db[k], kt > 0 || k > 0);  // the first overwrites
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0) {  // the previous stage's products are done
            __syncwarp();
            if (lane == 0) mbar_arrive(r.empty + (g - 1) % kStages);
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t)
#pragma unroll
        for (int f = 0; f < 4; ++f) keep(acc[t][f]);
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + (g0 + n_kt - 1) % kStages);
}

// The copying warpgroup keeps few registers, the multiplying ones many.
__device__ __forceinline__ void regs_copying() { asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory"); }
__device__ __forceinline__ void regs_multiplying() { asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory"); }

// (a) the coefficients. Tiles (direction, row tile, unit tile) in
// `order` (tile_place: unit tiles fastest, or grouped by kCoefGroup row
// tiles); the maps: h_prev's source ys_f, ys_b ([T*N][H], boxes 64 x
// 128), and W_hh of each direction ([H][3H], boxes 64 x 64).
struct CoefMaps {
    CUtensorMap ys[2];
    CUtensorMap w[2];
};

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_coef_wide_kernel(const __grid_constant__ CoefMaps maps, const bf16* __restrict__ px_f,
                         const bf16* __restrict__ px_b, const bf16* __restrict__ ys_f,
                         const bf16* __restrict__ ys_b, const float* __restrict__ b_hh,
                         float* __restrict__ coef, int T, int N, int H, int order) {
    extern __shared__ unsigned char smem_raw[];
    const Ring r = ring_setup(smem_raw);
    const int M = T * N, H3 = 3 * H, tid = threadIdx.x;
    const int UT = (H + kUnits - 1) / kUnits, RT = (M + kBM - 1) / kBM, tiles = 2 * UT * RT;
    const int n_kt = (H + kBK - 1) / kBK;
    if (tid < 128) {
        regs_copying();
        if (tid != 0) return;
        unsigned g = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int rt, ut;
            tile_place(tile % (UT * RT), RT, UT, kCoefGroup, order, rt, ut);
            const int u0 = ut * kUnits, m0 = rt * kBM, dir = tile / UT / RT;
            const int src = m0 + (dir == 0 ? -N : N);  // h_prev's first row in ys
            for (int kt = 0; kt < n_kt; ++kt, ++g) {
                const uint32_t st = ring_claim(r, g);
                uint64_t* bar = r.full + g % kStages;
                tma2d(st, &maps.ys[dir], kt * kBK, src, bar);
                for (int gt = 0; gt < 3; ++gt)
                    tma2d(st + kABytes + gt * kBox, &maps.w[dir], gt * H + u0, kt * kBK, bar);
            }
        }
        return;
    }
    regs_multiplying();
    const int wg = tid / 128 - 1, lane = tid % 32, warp = tid / 32 % 4, gid = lane / 4, tig = lane % 4;
    unsigned g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g += n_kt) {
        int rt, ut;
        tile_place(tile % (UT * RT), RT, UT, kCoefGroup, order, rt, ut);
        const int u0 = ut * kUnits, m0 = rt * kBM, dir = tile / UT / RT;
        float acc[kBN / 8][4];
        multiply<0, 1>(acc, r, g, n_kt, (uint32_t)wg * 64 * 128);

        // Epilogue: n8 tile g * 8 + ug holds gate g of units u0 + 8 ug + 2
        // tig (+1), rows m0 + 64 wg + 16 warp + gid (+8).
        const bf16* ys = dir == 0 ? ys_f : ys_b;
        const long long shift = dir == 0 ? -(long long)N : (long long)N;
        const int rbase = m0 + 64 * wg + 16 * warp + gid;
        const bf16* px = dir == 0 ? px_f : px_b;
#pragma unroll
        for (int ug = 0; ug < kUnits / 8; ++ug) {
            const int u = u0 + 8 * ug + 2 * tig;
            if (u >= H) continue;
            const float* bp = b_hh + dir * H3 + u;
            const float2 br = io::ldg2(bp), bz = io::ldg2(bp + H), bn = io::ldg2(bp + 2 * H);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = rbase + 8 * half;
                if (m >= M) continue;
                const long long src = (long long)m + shift;
                const bf16* p = px + (size_t)m * H3 + u;
                const float2 xr = io::ldg2(p), xz = io::ldg2(p + H), xn = io::ldg2(p + 2 * H);
                const float2 hp = (src >= 0 && src < M) ? io::ldg2(ys + src * H + u) : make_float2(0.f, 0.f);
                float out[kNC][2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int f = 2 * half + j;
                    const float hr = acc[ug][f] + (j ? br.y : br.x);
                    const float hz = acc[8 + ug][f] + (j ? bz.y : bz.x);
                    const float hn = acc[16 + ug][f] + (j ? bn.y : bn.x);
                    const float rg = sigmoid((j ? xr.y : xr.x) + hr);
                    const float z = sigmoid((j ? xz.y : xz.x) + hz);
                    const float c = tanhf((j ? xn.y : xn.x) + rg * hn);
                    const float h_prev = j ? hp.y : hp.x;
                    out[0][j] = z;
                    out[1][j] = (1.f - z) * (1.f - c * c);
                    out[2][j] = (h_prev - c) * z * (1.f - z);
                    out[3][j] = rg;
                    out[4][j] = hn * rg * (1.f - rg);
                }
                float* o = coef + (((size_t)dir * M + m) * kNC) * H + u;
#pragma unroll
                for (int q = 0; q < kNC; ++q)
                    *reinterpret_cast<float2*>(o + (size_t)q * H) = make_float2(out[q][0], out[q][1]);
            }
        }
    }
}

// (c) dW partials: dwp[split][dir][k][j] = sum over the split's rows m of
// h_prev[m][k] bf16(dph)[m][j]. Tiles (split * 2 + dir, k tile, column
// tile) in `order` (tile_place: column tiles fastest, or grouped by
// kDwGroup k tiles): JD tiles over dpx's first 2H columns,
// then ceil(H/192) over dhn's H. The maps: ys_f, ys_b ([T*N][H]), dpx_f,
// dpx_b ([T*N][2H] of row pitch 3H), dhn of each direction ([T*N][H]), all
// boxes 64 x 64.
struct DwMaps {
    CUtensorMap ys[2];
    CUtensorMap dpx[2];
    CUtensorMap dhn[2];
};

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_dw_wide_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ dwp,
                       int rows_per_split, int splits, int T, int N, int H, int order) {
    extern __shared__ unsigned char smem_raw[];
    const Ring r = ring_setup(smem_raw);
    const int M = T * N, H3 = 3 * H, tid = threadIdx.x;
    const int JD = (2 * H + kBN - 1) / kBN, JT = JD + (H + kBN - 1) / kBN;
    const int KT = (H + kBM - 1) / kBM, tiles = 2 * splits * KT * JT;
    // The tile's place: its split's rows, its dW rows k0.. and its columns
    // (map `from_dhn`, first column jm there, j0 in dW).
    struct Place {
        int dir, k0, jm, j0, r_beg, n_kt;
        bool from_dhn;
    };
    const auto place = [&](int tile) {
        Place p;
        int kt, jt;
        tile_place(tile % (KT * JT), KT, JT, kDwGroup, order, kt, jt);
        const int z = tile / JT / KT;
        p.k0 = kt * kBM;
        p.dir = z % 2;
        p.from_dhn = jt >= JD;
        p.jm = (p.from_dhn ? jt - JD : jt) * kBN;
        p.j0 = p.from_dhn ? 2 * H + p.jm : p.jm;
        p.r_beg = z / 2 * rows_per_split;
        p.n_kt = (max(0, min(M, p.r_beg + rows_per_split) - p.r_beg) + kBK - 1) / kBK;
        return p;
    };
    if (tid < 128) {
        regs_copying();
        if (tid != 0) return;
        unsigned g = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const Place p = place(tile);
            const int shift = p.dir == 0 ? -N : N;
            const CUtensorMap* bmap = p.from_dhn ? &maps.dhn[p.dir] : &maps.dpx[p.dir];
            for (int kt = 0; kt < p.n_kt; ++kt, ++g) {
                const uint32_t st = ring_claim(r, g);
                uint64_t* bar = r.full + g % kStages;
                const int r0 = p.r_beg + kt * kBK;
                for (int c = 0; c < 2; ++c) tma2d(st + c * kBox, &maps.ys[p.dir], p.k0 + 64 * c, r0 + shift, bar);
                for (int c = 0; c < 3; ++c) tma2d(st + kABytes + c * kBox, bmap, p.jm + 64 * c, r0, bar);
            }
        }
        return;
    }
    regs_multiplying();
    const int wg = tid / 128 - 1, lane = tid % 32, warp = tid / 32 % 4, gid = lane / 4, tig = lane % 4;
    unsigned g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Place p = place(tile);
        float acc[kBN / 8][4];
        multiply<1, 1>(acc, r, g, p.n_kt, (uint32_t)wg * kBox);
        g += p.n_kt;

        // n8 tile t holds columns j0 + 8 t + 2 tig (+1) of rows k0 + 64 wg
        // + 16 warp + gid (+8).
        const int kbase = p.k0 + 64 * wg + 16 * warp + gid;
        const int j_end = p.from_dhn ? H3 : 2 * H;
        float* out = dwp + ((size_t)(tile / JT / KT)) * H * H3;
#pragma unroll
        for (int t = 0; t < kBN / 8; ++t) {
            const int j = p.j0 + 8 * t + 2 * tig;
            if (j >= j_end) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int k = kbase + 8 * half;
                if (k < H)
                    *reinterpret_cast<float2*>(out + (size_t)k * H3 + j) =
                        make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
            }
        }
    }
}

// (d) dw[i] = sum over splits of dwp[split][i], in split order; db[j] =
// sum over parts of dbp[part][j], in part order (gru_bwd.cu's dw_sum).
__global__ void __launch_bounds__(256)
gru_bwd_dw_sum_wide_kernel(const float* __restrict__ dwp, const float* __restrict__ dbp,
                           float* __restrict__ dw, float* __restrict__ db, int splits,
                           int db_parts, int n_dw, int n_db) {
    const int i = blockIdx.x * 256 + threadIdx.x;
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
// float32: the same two products in 3xTF32 on wgmma (namespace f32)
//
// tf32 `wgmma` has no transpose bit: B must lie K-major in shared memory
// (its contraction contiguous), and only A may come from registers. Each
// product therefore takes A from registers, split there into hi and lo
// once per element a tile (each element of A is read by one thread), and
// B, the operand whose hi and lo parts the tensor core reads from shared
// memory, from a K-major hi/lo copy that a pre-pass writes (`split_t`):
// - `coef`: A = h_prev rows (t, n) [128][16 k] a stage, K-major as ys
//   lies, read with `ldmatrix` (one x4 gives a warp an m16k8 tf32
//   fragment); B = W_hh^T [3H][H] hi and lo, from the pre-pass.
// - `dw`: the rows of the tile are 128 columns j of dph and its columns
//   192 rows k of dW (the product dW^T = dph^T h_prev): A = dph^T, loaded
//   from dpx stages [16 rows][128 j] (and r's [16][128], for dph's n
//   columns, dhn = da_c r) with four scalar loads a k8 step, multiplied by
//   r there and summed into db on the way; B = h_prev^T [H][T*N] hi and
//   lo, from the pre-pass over ys, which also shifts ys to h_prev (so
//   that every copy starts on a 16-byte boundary: TMA reads the
//   contraction as the inner dimension there).
// The split is the mask of gru_bwd.cu's `split_tf32`: hi = the upper 19
// bits of x, lo = the upper 19 bits of x - hi (as the tensor core reads
// them); a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, three `wgmma`
// m64n192k8 a k8 step and warpgroup, summed in f32.

namespace f32 {

constexpr int kBK = 16;                             // contraction a stage (2 k8 steps)
constexpr uint32_t kBBox = 64 * kBK * 4;            // 64 K-major rows of B (4 KB, 64-byte swizzle)
constexpr uint32_t kBPart = 3 * kBBox;              // B's hi or lo of a stage (192 rows, 12 KB)
constexpr uint32_t kAStage = kBM * kBK * 4;         // A's source of a stage (8 KB)
constexpr uint32_t kDwBox = 32 * kBK * 4;           // dw: 32 columns x 16 rows of dpx or r (2 KB)
constexpr int kCoefStages = 6;
constexpr uint32_t kCoefStage = kAStage + 2 * kBPart;      // h_prev, W^T hi, lo: 32 KB
constexpr int kDwStages = 5;
constexpr uint32_t kDwStage = 2 * kAStage + 2 * kBPart;    // dpx, r, h_prev^T hi, lo: 40 KB
constexpr int kCoefSmem = kCoefStages * kCoefStage + 2 * kCoefStages * 8 + 1024;
constexpr int kDwSmem = kDwStages * kDwStage + 2 * kDwStages * 8 + 1024;
constexpr int kCoefGroup = 16;                      // coef: row tiles of a group (grouped order)
constexpr int kDwGroup = 8;                         // dw: k tiles of a group (grouped order)
constexpr uint32_t kMask = 0xffffe000u;             // a tf32 value's bits of an f32

// The split of one f32 value, as gru_bwd.cu's split_tf32, with lo cut to
// the bits the tensor core reads.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
    hi = x & kMask;
    lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) & kMask;
}

// The shared-memory descriptor of a K-major operand of 16-element rows in
// the 64-byte swizzle: 512 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
           (2ull << 62);
}

// wgmma.mma_async m64n192k8, tf32 -> f32, A from registers (a0 (gid, tig),
// a1 (gid+8, tig), a2 (gid, tig+4), a3 (gid+8, tig+4) of the warp's 16
// rows), B K-major from shared memory by descriptor; D = A B + (scale_d ?
// D : 0), the accumulators as WgmmaSS<192>'s.
__device__ __forceinline__ void wgmma_tf32(float (&d)[24][4], const uint32_t (&a)[4], uint64_t db,
                                           uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// One stage of a tile's product in a multiplying warpgroup: wait for
// stage use g, split its A fragments into hi, lo (`frag(stage address,
// k8 step, hi, lo)`), three wgmma a k8 step against B's hi and lo at
// `b_off` in the stage, and once the previous stage's products are done,
// free it (one arrival a warp). hi, lo must not be the previous stage's.
template <int Stages, uint32_t StageBytes, class Frag>
__device__ __forceinline__ void stage_product(float (&acc)[24][4], uint32_t (&hi)[2][4],
                                              uint32_t (&lo)[2][4], const Ring& r, unsigned g,
                                              bool first, uint32_t b_off, Frag& frag) {
    const unsigned s = g % Stages;
    mbar_wait(r.full + s, (g / Stages) & 1u);
    const uint32_t st = r.base + s * StageBytes;
#pragma unroll
    for (int k = 0; k < 2; ++k) frag(st, k, hi[k], lo[k]);
    const uint32_t bh = st + b_off, bl = bh + kBPart;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        wgmma_tf32(acc, lo[k], desc64(bh + 32 * k), !first || k > 0);  // the first overwrites
        wgmma_tf32(acc, hi[k], desc64(bl + 32 * k), 1);
        wgmma_tf32(acc, hi[k], desc64(bh + 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (!first) {  // the previous stage's products are done
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + (g - 1) % Stages);
    }
}

// The tile's product: n_kt stages of uses g0.., A's fragments in two sets
// of registers by turns (a set is written again only after the products
// that read it are done).
template <int Stages, uint32_t StageBytes, class Frag>
__device__ __forceinline__ void multiply(float (&acc)[24][4], const Ring& r, unsigned g0, int n_kt,
                                         uint32_t b_off, Frag& frag) {
    if (n_kt == 0) {
#pragma unroll
        for (int t = 0; t < 24; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
        return;
    }
    uint32_t hi0[2][4], lo0[2][4], hi1[2][4], lo1[2][4];
#pragma unroll 1
    for (int kt = 0; kt < n_kt; kt += 2) {
        stage_product<Stages, StageBytes>(acc, hi0, lo0, r, g0 + kt, kt == 0, b_off, frag);
        if (kt + 1 < n_kt)
            stage_product<Stages, StageBytes>(acc, hi1, lo1, r, g0 + kt + 1, false, b_off, frag);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 24; ++t)
#pragma unroll
        for (int f = 0; f < 4; ++f) keep(acc[t][f]);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + (g0 + n_kt - 1) % Stages);
}

// (p) The pre-pass: dst[b][0][c][r] = hi(x), dst[b][1][c][r] = lo(x) for
// r < R, c < C, x = src_b[r + shift_b][c] (0 outside src_b [R][C]; dst
// rows `pitch` apart), b = blockIdx.z: 32 x 32 tiles through shared
// memory, both sides coalesced. Two names, so that each phase's time
// shows as its own.
__device__ __forceinline__ void split_t(const float* __restrict__ src0,
                                        const float* __restrict__ src1, float* __restrict__ dst,
                                        int R, int C, int pitch, int shift0, int shift1) {
    __shared__ float tile[32][33];
    const float* src = blockIdx.z == 0 ? src0 : src1;
    const int shift = blockIdx.z == 0 ? shift0 : shift1;
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32, tx = threadIdx.x % 32;
    for (int i = threadIdx.x / 32; i < 32; i += 8) {
        const int r = r0 + i + shift, c = c0 + tx;
        tile[i][tx] = (r >= 0 && r < R && c < C) ? src[(size_t)r * C + c] : 0.f;
    }
    __syncthreads();
    float* hi = dst + (size_t)blockIdx.z * 2 * C * pitch;
    float* lo = hi + (size_t)C * pitch;
    for (int i = threadIdx.x / 32; i < 32; i += 8) {
        const int c = c0 + i, r = r0 + tx;
        if (c < C && r < R) {
            uint32_t h, l;
            split(__float_as_uint(tile[tx][i]), h, l);
            hi[(size_t)c * pitch + r] = __uint_as_float(h);
            lo[(size_t)c * pitch + r] = __uint_as_float(l);
        }
    }
}

__global__ void __launch_bounds__(256)
gru_bwd_coef_split_kernel(const float* __restrict__ w_hh, float* __restrict__ wt, int H) {
    split_t(w_hh, w_hh + (size_t)H * 3 * H, wt, H, 3 * H, H, 0, 0);
}

__global__ void __launch_bounds__(256)
gru_bwd_dw_split_kernel(const float* __restrict__ ys_f, const float* __restrict__ ys_b,
                        float* __restrict__ yt, int M, int N, int H, int pitch) {
    split_t(ys_f, ys_b, yt, M, H, pitch, -N, N);  // h_prev: ys_f[m - N], ys_b[m + N]
}

// (a) the coefficients, as the bf16 kernel's: tiles (direction, row tile,
// unit tile) in `order`; the maps: h_prev's source ys_f, ys_b ([T*N][H],
// boxes 16 x 128) and the pre-pass's W_hh^T hi and lo of each direction
// ([3H][H], boxes 16 x 64).
struct CoefMaps {
    CUtensorMap ys[2];
    CUtensorMap wt[2][2];
};

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_coef_wide_f32_kernel(const __grid_constant__ CoefMaps maps, const float* __restrict__ px_f,
                             const float* __restrict__ px_b, const float* __restrict__ ys_f,
                             const float* __restrict__ ys_b, const float* __restrict__ b_hh,
                             float* __restrict__ coef, int T, int N, int H, int order) {
    extern __shared__ unsigned char smem_raw[];
    const Ring r = ring_setup<kCoefStages, kCoefStage>(smem_raw);
    const int M = T * N, H3 = 3 * H, tid = threadIdx.x;
    const int UT = (H + kUnits - 1) / kUnits, RT = (M + kBM - 1) / kBM, tiles = 2 * UT * RT;
    const int n_kt = (H + kBK - 1) / kBK;
    if (tid < 128) {
        regs_copying();
        if (tid != 0) return;
        unsigned g = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int rt, ut;
            tile_place(tile % (UT * RT), RT, UT, kCoefGroup, order, rt, ut);
            const int u0 = ut * kUnits, m0 = rt * kBM, dir = tile / UT / RT;
            const int src = m0 + (dir == 0 ? -N : N);  // h_prev's first row in ys
            for (int kt = 0; kt < n_kt; ++kt, ++g) {
                const uint32_t st = ring_claim<kCoefStages, kCoefStage>(r, g);
                uint64_t* bar = r.full + g % kCoefStages;
                tma2d(st, &maps.ys[dir], kt * kBK, src, bar);
                for (int part = 0; part < 2; ++part)
                    for (int gt = 0; gt < 3; ++gt)
                        tma2d(st + kAStage + part * kBPart + gt * kBBox, &maps.wt[dir][part], kt * kBK,
                              gt * H + u0, bar);
            }
        }
        return;
    }
    regs_multiplying();
    const int wg = tid / 128 - 1, lane = tid % 32, warp = tid / 32 % 4, gid = lane / 4, tig = lane % 4;
    // ldmatrix: lane l gives row l % 8 (+8 for matrices 1, 3) of this
    // warp's 16, 16-byte chunk 2 k8 + (matrices 2, 3), in the swizzle.
    uint32_t a_off[2];
    {
        const int row = 64 * wg + 16 * warp + lane % 8 + 8 * (lane / 8 % 2);
#pragma unroll
        for (int k = 0; k < 2; ++k)
            a_off[k] = row * 64 + (((2 * k + lane / 16) ^ ((row >> 1) & 3)) << 4);
    }
    auto frag = [&](uint32_t st, int k, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        uint32_t x[4];
        ldmatrix_x4(x, st + a_off[k]);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
    };
    unsigned g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g += n_kt) {
        int rt, ut;
        tile_place(tile % (UT * RT), RT, UT, kCoefGroup, order, rt, ut);
        const int u0 = ut * kUnits, m0 = rt * kBM, dir = tile / UT / RT;
        float acc[kBN / 8][4];
        multiply<kCoefStages, kCoefStage>(acc, r, g, n_kt, kAStage, frag);

        // Epilogue (the bf16 kernel's): n8 tile g * 8 + ug holds gate g of
        // units u0 + 8 ug + 2 tig (+1), rows m0 + 64 wg + 16 warp + gid (+8).
        const float* ys = dir == 0 ? ys_f : ys_b;
        const long long shift = dir == 0 ? -(long long)N : (long long)N;
        const int rbase = m0 + 64 * wg + 16 * warp + gid;
        const float* px = dir == 0 ? px_f : px_b;
#pragma unroll
        for (int ug = 0; ug < kUnits / 8; ++ug) {
            const int u = u0 + 8 * ug + 2 * tig;
            if (u >= H) continue;
            const float* bp = b_hh + dir * H3 + u;
            const float2 br = io::ldg2(bp), bz = io::ldg2(bp + H), bn = io::ldg2(bp + 2 * H);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = rbase + 8 * half;
                if (m >= M) continue;
                const long long src = (long long)m + shift;
                const float* p = px + (size_t)m * H3 + u;
                const float2 xr = io::ldg2(p), xz = io::ldg2(p + H), xn = io::ldg2(p + 2 * H);
                const float2 hp = (src >= 0 && src < M) ? io::ldg2(ys + src * H + u) : make_float2(0.f, 0.f);
                float out[kNC][2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int f = 2 * half + j;
                    const float hr = acc[ug][f] + (j ? br.y : br.x);
                    const float hz = acc[8 + ug][f] + (j ? bz.y : bz.x);
                    const float hn = acc[16 + ug][f] + (j ? bn.y : bn.x);
                    const float rg = sigmoid((j ? xr.y : xr.x) + hr);
                    const float z = sigmoid((j ? xz.y : xz.x) + hz);
                    const float c = tanhf((j ? xn.y : xn.x) + rg * hn);
                    const float h_prev = j ? hp.y : hp.x;
                    out[0][j] = z;
                    out[1][j] = (1.f - z) * (1.f - c * c);
                    out[2][j] = (h_prev - c) * z * (1.f - z);
                    out[3][j] = rg;
                    out[4][j] = hn * rg * (1.f - rg);
                }
                float* o = coef + (((size_t)dir * M + m) * kNC) * H + u;
#pragma unroll
                for (int q = 0; q < kNC; ++q)
                    *reinterpret_cast<float2*>(o + (size_t)q * H) = make_float2(out[q][0], out[q][1]);
            }
        }
    }
}

// (c) dW^T and db partials: dwp[split][dir][k][j] = sum over the split's
// rows m of h_prev[m][k] dph[m][j], dbp[split][dir][j] = sum of dph[m][j]
// (written by the tiles of the first k tile). Tiles (split * 2 + dir, k
// tile, column tile) in `order` (tile_place: column tiles fastest, or
// grouped by kDwGroup k tiles): JD tiles of 128 columns over dpx's first
// 2H, then ceil(H/128) over its last H, times r (dph's n columns). The
// maps: dpx_f, dpx_b ([T*N][2H] and from column 2H [T*N][H], row pitch
// 3H) and r of each direction (coef's [T*N][H] of row pitch 5H), boxes 32
// x 16; the pre-pass's h_prev^T hi and lo ([H][T*N]), boxes 16 x 64.
struct DwMaps {
    CUtensorMap dpx[2];
    CUtensorMap dpx_n[2];
    CUtensorMap r[2];
    CUtensorMap yt[2][2];
};

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_dw_wide_f32_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ dwp,
                           float* __restrict__ dbp, int rows_per_split, int splits, int T, int N,
                           int H, int order) {
    extern __shared__ unsigned char smem_raw[];
    const Ring r = ring_setup<kDwStages, kDwStage>(smem_raw);
    const int M = T * N, H3 = 3 * H, tid = threadIdx.x;
    const int JD = (2 * H + kBM - 1) / kBM, JT = JD + (H + kBM - 1) / kBM;
    const int KT = (H + kBN - 1) / kBN, tiles = 2 * splits * KT * JT;
    struct Place {
        int dir, kt, k0, jm, j0, r_beg, n_kt;
        bool from_n;
    };
    const auto place = [&](int tile) {
        Place p;
        int jt;
        tile_place(tile % (KT * JT), KT, JT, kDwGroup, order, p.kt, jt);
        const int z = tile / JT / KT;
        p.k0 = p.kt * kBN;
        p.dir = z % 2;
        p.from_n = jt >= JD;
        p.jm = (p.from_n ? jt - JD : jt) * kBM;
        p.j0 = p.from_n ? 2 * H + p.jm : p.jm;
        p.r_beg = z / 2 * rows_per_split;
        p.n_kt = (max(0, min(M, p.r_beg + rows_per_split) - p.r_beg) + kBK - 1) / kBK;
        return p;
    };
    if (tid < 128) {
        regs_copying();
        if (tid != 0) return;
        unsigned g = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const Place p = place(tile);
            const CUtensorMap* amap = p.from_n ? &maps.dpx_n[p.dir] : &maps.dpx[p.dir];
            for (int kt = 0; kt < p.n_kt; ++kt, ++g) {
                const uint32_t st = ring_claim<kDwStages, kDwStage>(
                    r, g, p.from_n ? kDwStage : kDwStage - kAStage);
                uint64_t* bar = r.full + g % kDwStages;
                const int r0 = p.r_beg + kt * kBK;
                for (int c = 0; c < kBM / 32; ++c) {
                    tma2d(st + c * kDwBox, amap, p.jm + 32 * c, r0, bar);
                    if (p.from_n) tma2d(st + kAStage + c * kDwBox, &maps.r[p.dir], p.jm + 32 * c, r0, bar);
                }
                for (int part = 0; part < 2; ++part)
                    for (int c = 0; c < 3; ++c)
                        tma2d(st + 2 * kAStage + part * kBPart + c * kBBox, &maps.yt[p.dir][part],
                              r0, p.k0 + 64 * c, bar);
            }
        }
        return;
    }
    regs_multiplying();
    const int wg = tid / 128 - 1, lane = tid % 32, warp = tid / 32 % 4, gid = lane / 4, tig = lane % 4;
    // A fragment element (row j, k8 slot m) of this thread: j = jl (+8), m
    // = tig (+4) of the k8 step; offsets in the 128-byte swizzle of a
    // stage's 2 KB boxes of 32 columns (k8 step 1: 8 rows, 1024 bytes on).
    const int jl = 64 * wg + 16 * warp + gid;
    uint32_t e_off[4];  // (m, j), (m, j + 8), (m + 4, j), (m + 4, j + 8)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int j = jl + 8 * (i & 1), m = tig + 4 * (i >> 1);
        e_off[i] = (j / 32) * kDwBox + m * 128 + ((((j % 32) / 4) ^ (m & 7)) << 4) + (j % 4) * 4;
    }
    unsigned g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Place p = place(tile);
        float db0 = 0.f, db1 = 0.f;  // dph summed over this thread's rows, columns j, j + 8
        const bool scale = p.from_n;
        auto frag = [&](uint32_t st, int k, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint32_t a = st + e_off[i] + 1024 * k;
                asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[i]) : "r"(a));
                if (scale) {
                    float rv;
                    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(rv) : "r"(a + kAStage));
                    v[i] *= rv;
                }
            }
            db0 += v[0];
            db0 += v[2];
            db1 += v[1];
            db1 += v[3];
#pragma unroll
            for (int i = 0; i < 4; ++i) split(__float_as_uint(v[i]), hi[i], lo[i]);
        };
        float acc[kBN / 8][4];
        multiply<kDwStages, kDwStage>(acc, r, g, p.n_kt, 2 * kAStage, frag);
        g += p.n_kt;

        // n8 tile t holds rows k0 + 8 t + 2 tig (+1) of dW for its columns
        // j0 + jl (+8).
        const int z = tile / JT / KT;
        const int j_end = p.from_n ? H3 : 2 * H;
        float* out = dwp + (size_t)z * H * H3;
        const int j = p.j0 + jl;
#pragma unroll
        for (int t = 0; t < kBN / 8; ++t) {
            const int k = p.k0 + 8 * t + 2 * tig;
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int kk = k + (f & 1), jj = j + 8 * (f >> 1);
                if (kk < H && jj < j_end) out[(size_t)kk * H3 + jj] = acc[t][f];
            }
        }
        // db: the four threads of a row add their parts in a fixed order.
        db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
        db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
        if (p.kt == 0 && tig == 0) {
            if (j < j_end) dbp[(size_t)z * H3 + j] = db0;
            if (j + 8 < j_end) dbp[(size_t)z * H3 + j + 8] = db1;
        }
    }
}

}  // namespace f32

// ---------------------------------------------------------------------
// launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's tensor-map encoder, asked of the runtime once.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

// A 2-D tensor of `rows` rows of `width` elements, `pitch` elements apart,
// read in boxes of box_w x box_rows in `swizzle`, zero outside it; bf16
// unless `f32`.
bool map2d(CUtensorMap* m, const void* base, uint64_t width, uint64_t rows, uint64_t pitch,
           uint32_t box_rows, bool f32 = false, uint32_t box_w = 64,
           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {width, rows}, strides[1] = {pitch * (f32 ? 4 : 2)};
    const cuuint32_t box[2] = {box_w, box_rows}, estr[2] = {1, 1};
    return enc(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks, selects the device, lets `kernel` use `smem` bytes and gives the
// grid for `tiles` (one block an SM at most).
cudaError_t setup(int device, int T, int N, int H, const void* kernel, long long tiles, int* grid,
                  int smem = kSmem) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (T < 1 || N < 1 || H < 8 || H % 8 || (long long)T * N >= (1ll << 31)) return cudaErrorInvalidValue;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    *grid = (int)std::min<long long>(tiles, sms);
    return err;
}

}  // namespace

extern "C" {

// The coefficients: px_f, px_b [T, N, 3H], ys_f, ys_b [T, N, H] bf16; w16
// [2, H, 3H] bf16 (W_hh for h @ W); b_hh [2, 3H] float32; out coef [2,
// T*N, 5, H] float32. H % 8 == 0; `order` the tiles' (0: unit tiles
// fastest; 1: grouped, what the wrapper runs; the same bits). One launch.
int ocrs_gru_bwd_coef_wide_bf16(int device, const bf16* px_f, const bf16* px_b, const bf16* ys_f,
                                const bf16* ys_b, const bf16* w16, const float* b_hh, float* coef,
                                int T, int N, int H, int order, void* stream) {
    const RestoreDevice restore_device;
    const long long M = (long long)T * N;
    int grid = 0;
    cudaError_t err = setup(device, T, N, H, (const void*)gru_bwd_coef_wide_kernel,
                            2 * ((H + kUnits - 1) / kUnits) * ((M + kBM - 1) / kBM), &grid);
    if (err != cudaSuccess) return (int)err;
    CoefMaps maps;
    for (int d = 0; d < 2; ++d)
        if (!map2d(&maps.ys[d], d == 0 ? ys_f : ys_b, H, M, H, kBM) ||
            !map2d(&maps.w[d], w16 + (size_t)d * H * 3 * H, 3 * H, H, 3 * H, 64))
            return (int)cudaErrorInvalidValue;
    if (order != 0 && order != 1) return (int)cudaErrorInvalidValue;
    gru_bwd_coef_wide_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        maps, px_f, px_b, ys_f, ys_b, b_hh, coef, T, N, H, order);
    return (int)cudaGetLastError();
}

// dW and db: ys_f, ys_b [T, N, H], dpx_f, dpx_b [T, N, 3H] and the chain's
// dhn [2, T*N, H] bf16; scratch dwp [splits, 2, H, 3H] float32; dbp
// [db_parts, 2, 3H] the chain's db partials; out dw [2, H, 3H], db [2, 3H]
// float32. `splits` ranges of rows (each a multiple of 64 rows but the
// last); `order` as for the coefficients. Two launches.
int ocrs_gru_bwd_dw_wide_bf16(int device, const bf16* ys_f, const bf16* ys_b, const bf16* dpx_f,
                              const bf16* dpx_b, const bf16* dhn, float* dwp, const float* dbp,
                              int db_parts, float* dw, float* db, int splits, int T, int N, int H,
                              int order, void* stream) {
    const RestoreDevice restore_device;
    if (splits < 1 || db_parts < 1 || (order != 0 && order != 1)) return (int)cudaErrorInvalidValue;
    const long long M = (long long)T * N;
    const int tiles_j = (2 * H + kBN - 1) / kBN + (H + kBN - 1) / kBN;
    int grid = 0;
    cudaError_t err = setup(device, T, N, H, (const void*)gru_bwd_dw_wide_kernel,
                            2LL * splits * ((H + kBM - 1) / kBM) * tiles_j, &grid);
    if (err != cudaSuccess) return (int)err;
    DwMaps maps;
    for (int d = 0; d < 2; ++d)
        if (!map2d(&maps.ys[d], d == 0 ? ys_f : ys_b, H, M, H, 64) ||
            !map2d(&maps.dpx[d], d == 0 ? dpx_f : dpx_b, 2 * H, M, 3 * H, 64) ||
            !map2d(&maps.dhn[d], dhn + (size_t)d * M * H, H, M, H, 64))
            return (int)cudaErrorInvalidValue;
    const int rows = (int)(((M + splits - 1) / splits + kBK - 1) / kBK * kBK);
    gru_bwd_dw_wide_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(maps, dwp, rows, splits,
                                                                              T, N, H, order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = 2 * H * 3 * H, n_db = 2 * 3 * H;
    gru_bwd_dw_sum_wide_kernel<<<(n_dw + n_db + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        dwp, dbp, dw, db, splits, db_parts, n_dw, n_db);
    return (int)cudaGetLastError();
}

// The float32 coefficients, in 3xTF32: px_f, px_b [T, N, 3H], ys_f, ys_b
// [T, N, H], w_hh [2, H, 3H] (for h @ W), b_hh [2, 3H]; scratch wt [2, 2,
// 3H, H] (the pre-pass's W_hh^T hi and lo); out coef [2, T*N, 5, H]; all
// float32. H % 8 == 0; `order` as for the bf16 entry. Two launches: the
// pre-pass, the coefficients.
int ocrs_gru_bwd_coef_wide_f32(int device, const float* px_f, const float* px_b, const float* ys_f,
                               const float* ys_b, const float* w_hh, const float* b_hh, float* wt,
                               float* coef, int T, int N, int H, int order, void* stream) {
    const RestoreDevice restore_device;
    const long long M = (long long)T * N;
    int grid = 0;
    cudaError_t err = setup(device, T, N, H, (const void*)f32::gru_bwd_coef_wide_f32_kernel,
                            2 * ((H + kUnits - 1) / kUnits) * ((M + kBM - 1) / kBM), &grid,
                            f32::kCoefSmem);
    if (err != cudaSuccess) return (int)err;
    if (order != 0 && order != 1) return (int)cudaErrorInvalidValue;
    f32::CoefMaps maps;
    for (int d = 0; d < 2; ++d) {
        if (!map2d(&maps.ys[d], d == 0 ? ys_f : ys_b, H, M, H, kBM, true, f32::kBK,
                   CU_TENSOR_MAP_SWIZZLE_64B))
            return (int)cudaErrorInvalidValue;
        for (int part = 0; part < 2; ++part)
            if (!map2d(&maps.wt[d][part], wt + (size_t)(2 * d + part) * 3 * H * H, H, 3 * H, H, 64,
                       true, f32::kBK, CU_TENSOR_MAP_SWIZZLE_64B))
                return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    f32::gru_bwd_coef_split_kernel<<<dim3((3 * H + 31) / 32, (H + 31) / 32, 2), 256, 0, s>>>(w_hh, wt, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    f32::gru_bwd_coef_wide_f32_kernel<<<grid, kThreads, f32::kCoefSmem, s>>>(
        maps, px_f, px_b, ys_f, ys_b, b_hh, coef, T, N, H, order);
    return (int)cudaGetLastError();
}

// The row pitch of the dW pre-pass's h_prev^T copies (T*N rounded up to 4
// elements, as a tensor map's row pitch must be a multiple of 16 bytes).
int ocrs_gru_bwd_dw_wide_f32_pitch(int T, int N) { return (T * N + 3) / 4 * 4; }

// float32 dW and db, in 3xTF32: ys_f, ys_b [T, N, H], dpx_f, dpx_b [T, N,
// 3H] (the chain's), coef [2, T*N, 5, H] (its r); scratch yt [2, 2, H,
// pitch] (the pre-pass's h_prev^T hi and lo), dwp [splits, 2, H, 3H], dbp
// [splits, 2, 3H]; out dw [2, H, 3H], db [2, 3H]; all float32. `splits`
// ranges of rows (each a multiple of 16 rows but the last); `order` as
// for the coefficients. Three launches: the pre-pass, dW and db partials,
// their sum in range order.
int ocrs_gru_bwd_dw_wide_f32(int device, const float* ys_f, const float* ys_b, const float* dpx_f,
                             const float* dpx_b, const float* coef, float* yt, float* dwp,
                             float* dbp, float* dw, float* db, int splits, int T, int N, int H,
                             int order, void* stream) {
    const RestoreDevice restore_device;
    if (splits < 1 || (order != 0 && order != 1)) return (int)cudaErrorInvalidValue;
    const long long M = (long long)T * N;
    const int tiles_j = (2 * H + kBM - 1) / kBM + (H + kBM - 1) / kBM;
    int grid = 0;
    cudaError_t err = setup(device, T, N, H, (const void*)f32::gru_bwd_dw_wide_f32_kernel,
                            2LL * splits * ((H + kBN - 1) / kBN) * tiles_j, &grid, f32::kDwSmem);
    if (err != cudaSuccess) return (int)err;
    const int pitch = ocrs_gru_bwd_dw_wide_f32_pitch(T, N);
    f32::DwMaps maps;
    for (int d = 0; d < 2; ++d) {
        const float* dpx = d == 0 ? dpx_f : dpx_b;
        if (!map2d(&maps.dpx[d], dpx, 2 * H, M, 3 * H, f32::kBK, true, 32) ||
            !map2d(&maps.dpx_n[d], dpx + 2 * H, H, M, 3 * H, f32::kBK, true, 32) ||
            !map2d(&maps.r[d], coef + (size_t)d * M * kNC * H + 3 * H, H, M, kNC * H, f32::kBK,
                   true, 32))
            return (int)cudaErrorInvalidValue;
        for (int part = 0; part < 2; ++part)
            if (!map2d(&maps.yt[d][part], yt + (size_t)(2 * d + part) * H * pitch, M, H, pitch, 64,
                       true, f32::kBK, CU_TENSOR_MAP_SWIZZLE_64B))
                return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    f32::gru_bwd_dw_split_kernel<<<dim3((H + 31) / 32, (unsigned)((M + 31) / 32), 2), 256, 0, s>>>(
        ys_f, ys_b, yt, (int)M, N, H, pitch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rows = (int)(((M + splits - 1) / splits + f32::kBK - 1) / f32::kBK * f32::kBK);
    f32::gru_bwd_dw_wide_f32_kernel<<<grid, kThreads, f32::kDwSmem, s>>>(maps, dwp, dbp, rows, splits,
                                                                          T, N, H, order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = 2 * H * 3 * H, n_db = 2 * 3 * H;
    gru_bwd_dw_sum_wide_kernel<<<(n_dw + n_db + 255) / 256, 256, 0, s>>>(dwp, dbp, dw, db, splits,
                                                                          splits, n_dw, n_db);
    return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the f32 coefficients (kind 0) or
// dW (kind 1) asks for.
int ocrs_gru_bwd_wide_f32_smem(int kind) { return kind == 0 ? f32::kCoefSmem : f32::kDwSmem; }

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
