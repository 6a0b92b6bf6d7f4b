// The bf16 biGRU backward's two products outside its chain at hidden
// widths above 512, on Hopper's asynchronous tensor-core path (`wgmma`,
// operands brought by the Tensor Memory Accelerator): the coefficients
// (`coef`) and the dW partials (`dw`, with `dw_sum`).
//
// Replaces: the products of the backward of the Pallas kernel
// `gru_recurrence4` in ocrs_models_tpu/ops/pallas/gru_kernel4.py
// (`_bwd_call`, body `_bwd_kernel`): the recomputed ph = h_prev @ W_hh +
// b_hh with the gates, and dW_hh = h_prev^T dph, at the widths of the wide
// route's bf16 forms above 512 (ops/gru.py `gru_wide_bwd`; up to 512, and
// in f32, gru_bwd.cu's `mma.sync` tiles, built for H <= 256). Same
// contract and rounding points as gru_bwd.cu's bf16 phases: h_prev is the
// bf16 ys in scan order (ys_f[t-1], ys_b[t+1], zero at each direction's
// first step), W_hh is bf16, products are summed in f32; `coef` writes per
// element the five f32 numbers the chain reads, z, (1-z)(1-c^2), (h_prev-c)
// z (1-z), r, hn r (1-r), into coef [2, T*N, 5, H]; `dw` sums h_prev^T
// bf16(dph), bf16(dph) = [dpx's r and z columns, the chain's dhn], over
// ranges of rows into partials that `dw_sum` adds in range order, with db
// from the chain's partials in tile order.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s HBM): at T=257,
// N=128, H=1024 each is one product of 2 * 257*128 * 1024 * 3072 * 2
// directions = 413.9 GFLOP, 0.419 ms; `coef` also writes its 1.35 GB of
// coefficients (0.40 ms) and `dw` reads ys, dpx and dhn in bf16 (0.35 GB).
//
// Design: two large products over all T*N rows, the shape of a GEMM. A
// block computes 128 x 192 output tiles, one after another (persistent:
// as many blocks as SMs), with three warpgroups: warpgroup 0's first
// thread brings each stage's operands, 64 of the contraction, into a ring
// of 5 stages (40 KB each) with 2-D TMA copies (`cp.async.bulk.tensor`)
// of 64-element rows in the 128-byte swizzle (a few large copies a stage,
// whole sectors, rows outside the tensors read as zeros), completing on
// the stage's mbarrier; warpgroups 1 and 2 each multiply 64 of the rows,
// one `wgmma.mma_async` m64n192k16 (bf16 -> f32) per k16 step with both
// operands in shared memory by descriptor, K-major or MN-major (through
// wgmma's transpose bit, so that no operand is copied transposed), and
// free a stage with one arrival a warp once its products have read it.
// The copies run ahead across tiles, so one tile's epilogue overlaps the
// next tile's loads. Registers move to the multiplying warpgroups
// (`setmaxnreg`: 40 for the copying one, 232 for them).
// - `coef`: rows (t, n) x 64 units x 3 gates (the r, z, n columns of the
//   units, so that a thread's accumulators hold all three gates of its
//   elements); A = h_prev [rows][H] K-major, B = W_hh [H][3H] MN-major.
//   The gate epilogue reads px and h_prev and writes the five coefficients
//   straight from the accumulators.
// - `dw`: rows k of dW x 192 columns j of dpx's first 2H or of dhn,
//   contracting over a range of rows (t, n); A = h_prev^T and B =
//   bf16(dph), both MN-major (their rows are the contraction). At H >=
//   1024 its tiles, 2 * ceil(H/128) * (ceil(2H/192) + ceil(H/192)), fill
//   the card in one range (ops/gru.py `_dw_splits`), so the partials add
//   one [2, H, 3H] write and read.
// - Tile order (tile_place): grouped. At H = 5288 a direction's W_hh (168
//   MB) and h_prev (348 MB) outgrow the 50 MB L2; with the column tiles
//   fastest, the 132 blocks in flight span all of a direction's W_hh
//   columns (coef) or all of dph's (dw) for one or two row tiles, and
//   every wave reads them again from device memory (coef about 86 GB a
//   call, dw 57). In groups of 16 row tiles (coef) or 12 k tiles (dw),
//   row tiles fastest, the blocks in flight share a few column tiles,
//   each read once a group, while the group's rows stay in L2.
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

__device__ __forceinline__ Ring ring_setup(unsigned char* smem_raw) {
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    Ring r;
    r.base = smem_u32(smem);
    r.full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
    r.empty = r.full + kStages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(r.full + s, 1);
            mbar_init(r.empty + s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return r;
}

// The copying thread: stage use g is free again (its previous use read).
__device__ __forceinline__ uint32_t ring_claim(const Ring& r, unsigned g) {
    const unsigned s = g % kStages, use = g / kStages;
    if (use > 0) mbar_wait(r.empty + s, (use - 1) & 1u);
    mbar_arrive_expect_tx(r.full + s, kStageBytes);
    return r.base + s * kStageBytes;
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

// A 2-D bf16 tensor of `rows` rows of `width` elements, `pitch` elements
// apart, read in boxes of 64 x box_rows in the 128-byte swizzle, zero
// outside it.
bool map2d(CUtensorMap* m, const void* base, uint64_t width, uint64_t rows, uint64_t pitch,
           uint32_t box_rows) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {width, rows}, strides[1] = {pitch * 2};
    const cuuint32_t box[2] = {64, box_rows}, estr[2] = {1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
               estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks, selects the device, lets `kernel` use kSmem and gives the grid
// for `tiles` (one block an SM at most).
cudaError_t setup(int device, int T, int N, int H, const void* kernel, long long tiles, int* grid) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (T < 1 || N < 1 || H < 8 || H % 8 || (long long)T * N >= (1ll << 31)) return cudaErrorInvalidValue;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
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

const char* ocrs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
