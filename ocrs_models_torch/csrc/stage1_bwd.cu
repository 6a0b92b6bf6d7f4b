// Recognition stage 1, backward: the weight and bias gradients of
// y = maxpool2x2(relu(conv3x3_pad1(x) + b)), 1 -> 32 channels, in float32
// or bfloat16.
//
// Replaces: the backward of the Pallas kernel `stage1_fused` in
// ocrs_models_tpu/ops/pallas/stage1_kernel.py (`_bwd_call`, body
// `_bwd_kernel`). Same function: recompute the four pre-activations of each
// pool window, send dy to the FIRST maximum of the ReLU'd values in window
// order (0,0), (0,1), (1,0), (1,1), pass it only where that pre-activation
// is > 0, and sum dy * patch over the batch into dW [32, 9] and db [32]. The
// image gradient is not computed (training never asks for it). Both entries
// take weight [32, 9] and bias [32] as torch keeps them and write dW and db
// directly: two launches a call, nothing else.
//
// Determinism, both dtypes: the first pass's grid is sized from the card
// (SM count x resident blocks), each block walks an equal share of the
// items in a fixed order that depends on the shapes and the block index
// alone, and writes one partial [32, 10] of its own, scratch of the call;
// a second kernel adds the few hundred partials, 32 outputs per block with
// 8 warps striding over the partials and a fixed order across warps. No
// float atomics: reruns agree bit for bit. Pooling floors odd sizes, like
// torch's MaxPool2d; any h and w are taken.
//
// float32. Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside
// the tensor cores): at N=256, H=64, W=256 the function must read x once
// (16.8 MB) and dy once (256*32*32*128*4 B = 134.2 MB): 151 MB, 45 us.
// The arithmetic is, per pooled output and channel, 4 pre-activations of
// 9 FMAs and 10 FMAs of the selected patch: 33.6M * 46 FMA = 3.1 GFLOP,
// 46 us. Both bounds are about equal; reading dy is 89% of the bytes. The
// Pallas kernel's f32 products are pinned to HIGHEST precision, so this
// path stays on FMAs. Design: FMAs, not loads, set the pace:
// - A lane owns a pooled POSITION: a warp takes 32 neighbouring pooled
//   columns, so its dy loads (one per channel) and x loads are coalesced
//   with no transposing stage. The lane keeps its 4 x 4 input patch in 16
//   registers and reuses it for the kGroup (4) channels of its warp, whose
//   40 gradient sums also stay in registers; the 8 warps of a block are the
//   8 channel groups of one tile. A patch row is two loads per lane
//   (columns 2j, 2j+1; the outer two come from the neighbouring lanes by
//   shuffle, the tile's two edge columns by one extra load), and walking
//   down the rows only the two new input rows are loaded.
// - The weights wait in shared memory and come as three 16-byte broadcast
//   loads per channel and row: held in registers (40 of 128) they made the
//   compiler spill and recompute addresses, 462 instructions a row against
//   414 now. 8 channels per warp, or registers cut for a third block per
//   SM, lost to 4 channels and two blocks.
// - Loads stay in flight: the x rows and dy values of pooled row ph + 1 are
//   requested into registers before the FMAs of row ph.
// - The arg-max is three compares on the pre-activations (first maximum in
//   window order; equal to the first maximum of the ReLU'd values whenever
//   a gradient passes), the patch is routed by 12 selects on the column and
//   two masked gradients on the row (one is 0, so the sum is the selected
//   product exactly): 55 FMAs and 23 compares and selects per (position,
//   channel). Selecting rows, then columns (21 selects, 9 FMAs), and four
//   masked gradients (36 FMAs) were both slower.
// - Sums over positions stay in a lane's registers for the whole walk and
//   cross lanes once by shuffles in a fixed order.
//
// bfloat16 (`dt=jnp.bfloat16`): x and dy are bf16, the taps and the bias
// rounded to bf16 by the kernel, so the recomputed pre-activations are the
// bf16 forward's and every product dy * patch is exact (dy is already a
// bf16 value, so the Pallas kernel's cast of d4 to bf16 changes nothing);
// partials, dW and db are f32. At N=128, H=64, W=1024 the bytes halve
// (16.8 + 134.2 MB, 45 us) and bound it: the products take 6 us at the
// bf16 tensor-core rate (989 TFLOP/s), 92 us as f32 FMAs. So both products
// of the Pallas kernel run on mma.sync m16n8k16 (bf16, f32 accumulation).
// Design:
// - The pre-activations as stage1_fwd.cu's bf16 kernel computes them: A the
//   weights (two m16 channel tiles x K = 9 taps, bias, 6 zeros) in
//   registers, B the patch of 8 pooled positions straight from the input
//   tile in shared memory, one B per window member, so a lane holds all
//   four pre-activations of its (channel, position) pairs and picks the
//   member in registers.
// - The gradient product needs no transpose: the accumulator of two
//   adjacent 8-position groups (channel rows, position columns) is, packed
//   to bf16 pairs, exactly the A fragment of an m16n8k16 product whose K is
//   those 16 positions (FlashAttention-2 reuses P so). A lane forms
//   G_m[c, pos] there: its dy pair, masked to 0 where member m was not taken
//   or the gate is closed. Then dW10[c, k] += sum_pos G_m[c, pos] P_m[pos, k]
//   with N = 16 columns (9 taps, the bias's 1.0, zeros), B again read from
//   the input tile by offsets; the sums stay in the accumulators for the
//   block's whole walk.
// - A tile is 4 pooled rows x 64 pooled columns of one image; a block
//   walks its share of the tiles with the next two in flight: their input
//   rows (4-byte cp.async) and their dy (89% of the bytes, 16-byte
//   cp.async; element by element where W/2 is no multiple of 8), with zeros
//   past the image, in a ring of three stages of 21 KB (dynamic shared
//   memory, two blocks an SM).
// - Measured on an H100 (kernel_ab, PERF.md): the routing (3 compares, 2
//   selects and 4 predicates an output, then the four masked A fragments)
//   takes about half of the time; the rest is the two products' fragment
//   loads and mma.sync, with two blocks of 8 warps an SM at 128 registers.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"
#include "bf16_io.cuh"
#include "stage1_tile.cuh"

namespace {

constexpr int kC = 32;                // output channels
constexpr int kK = 10;                // 9 taps (dy * 3 + dx) + bias
constexpr int kGroup = 4;             // channels per warp
constexpr int kWarps = kC / kGroup;   // warps per block: all channels of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;             // pooled columns per item: one per lane
constexpr int kMinBlocks = 2;         // resident blocks per SM the registers are held to
constexpr unsigned kFull = 0xffffffffu;

// What a lane loads of one input row: columns 2j and 2j + 1 of its pooled
// column j, and (lanes 0 and 31) the tile's outer column.
struct RawRow {
    float v0, v1, edge;
};

// Which of the three the image holds (fixed over a run of rows).
struct Cols {
    bool ok0, ok1, eok;
};

// `at`: the row's column 2j; `edge_at`: its outer column; `in`: the row is
// inside the image. Outside, zeros (the convolution's padding).
__device__ __forceinline__ RawRow load_row(const float* __restrict__ at,
                                           const float* __restrict__ edge_at, bool in,
                                           const Cols& c) {
    RawRow r;
    r.v0 = in && c.ok0 ? io::ldg(at) : 0.f;
    r.v1 = in && c.ok1 ? io::ldg(at + 1) : 0.f;
    r.edge = in && c.eok ? io::ldg(edge_at) : 0.f;
    return r;
}

// The four patch columns 2j - 1 .. 2j + 2 of a row, from the lane's two and
// its neighbours'.
__device__ __forceinline__ void expand_row(const RawRow& r, int lane, float out[4]) {
    const float left = __shfl_up_sync(kFull, r.v1, 1);
    const float right = __shfl_down_sync(kFull, r.v0, 1);
    out[0] = lane == 0 ? r.edge : left;
    out[1] = r.v0;
    out[2] = r.v1;
    out[3] = lane == 31 ? r.edge : right;
}

// One pooled row of one warp: the gradients g of its kGroup channels at the
// lane's position, whose 4 x 4 patch is the row pairs `top` and `bot`.
__device__ __forceinline__ void accumulate(const float (&top)[2][4], const float (&bot)[2][4],
                                           const float (&g)[kGroup],
                                           const float4* __restrict__ ws,
                                           float (&acc)[kGroup][kK]) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        p[0][i] = top[0][i];
        p[1][i] = top[1][i];
        p[2][i] = bot[0][i];
        p[3][i] = bot[1][i];
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
        // The channel's taps and bias: three 16-byte broadcast loads.
        const float4 wa = ws[3 * j], wb = ws[3 * j + 1], wc = ws[3 * j + 2];
        const float wr[kK] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w, wc.x, wc.y};
        // The four pre-activations, in the forward kernel's FMA order.
        float y[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float s = wr[9];
#pragma unroll
                for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                    for (int kx = 0; kx < 3; ++kx)
                        s = fmaf(wr[ky * 3 + kx], p[a + ky][q + kx], s);
                y[a][q] = s;
            }
        // First maximum in window order (0,0), (0,1), (1,0), (1,1): a later
        // one wins only if strictly greater. Where the maximum is > 0 it is
        // also the first maximum of the ReLU'd values; where it is not, no
        // gradient passes.
        const bool qt = y[0][1] > y[0][0];
        const bool qb = y[1][1] > y[1][0];
        const float yt = qt ? y[0][1] : y[0][0];
        const float yb = qb ? y[1][1] : y[1][0];
        const bool a = yb > yt;
        const bool q = a ? qb : qt;
        const float gg = (a ? yb : yt) > 0.f ? g[j] : 0.f;
        const float g0 = a ? 0.f : gg;  // the window's upper row took it
        const float g1 = a ? gg : 0.f;  // the lower row
        // acc[ky][kx] += gg * p[a + ky][q + kx]: the column by select, the
        // row by the two masked gradients (one of them is 0).
        float v[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) v[i][kx] = q ? p[i][kx + 1] : p[i][kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
                acc[j][ky * 3 + kx] =
                    fmaf(g1, v[ky + 1][kx], fmaf(g0, v[ky][kx], acc[j][ky * 3 + kx]));
        acc[j][9] += gg;
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage1_bwd_partial_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                          const float* __restrict__ bias, const float* __restrict__ dy,
                          float* __restrict__ partial,
                          int n, int h, int w) {
    const int lane = threadIdx.x & 31;
    const int c0 = (threadIdx.x >> 5) * kGroup;
    const int hp = h / 2, wp = w / 2;
    const int ntile = (wp + kTile - 1) / kTile;
    const size_t plane = (size_t)hp * wp;
    const long long total = (long long)n * ntile * hp;  // items: (image, column tile, pooled row)
    long long it = total * blockIdx.x / gridDim.x;
    const long long end = total * (blockIdx.x + 1) / gridDim.x;

    // The weights wait in shared memory, 12 floats a channel: in registers
    // they would be 40 of a thread's 128.
    __shared__ float4 ws[kC][3];
    for (int i = threadIdx.x; i < kC * 12; i += kThreads) {
        const int ch = i / 12, k = i % 12;
        reinterpret_cast<float*>(ws[ch])[k] =
            k < 9 ? __ldg(weight + ch * 9 + k) : k == 9 ? __ldg(bias + ch) : 0.f;
    }
    __syncthreads();
    float acc[kGroup][kK];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[j][k] = 0.f;

    while (it < end) {
        // A run of pooled rows of one (image, column tile).
        const int ph0 = (int)(it % hp);
        const long long rest = it / hp;
        const int ct = (int)(rest % ntile);
        const int b = (int)(rest / ntile);
        const int rows = (int)min((long long)(hp - ph0), end - it);
        const int pw = ct * kTile + lane;
        const bool live = pw < wp;
        const int col = 2 * pw;
        const int ecol = lane == 0 ? col - 1 : col + 2;
        Cols c;
        c.ok0 = col < w;
        c.ok1 = col + 1 < w;
        c.eok = (lane == 0 && ecol >= 0) || (lane == 31 && ecol < w);
        // Input row 2 * ph0 - 1 at the lane's columns; pointers outside the
        // image are never read through.
        const float* at = x + ((size_t)b * h + 2 * ph0) * w - w + col;
        const float* edge_at = at + (ecol - col);
        const float* dyr = dy + ((size_t)b * kC + c0) * plane + (size_t)ph0 * wp + pw;

        // The patch as two row pairs: going down a pooled row, the lower
        // pair becomes the upper one and only the new lower pair is loaded.
        float top[2][4], bot[2][4], g[kGroup], gn[kGroup];
        expand_row(load_row(at, edge_at, ph0 > 0, c), lane, top[0]);
        expand_row(load_row(at + w, edge_at + w, true, c), lane, top[1]);
        at += 2 * w;  // from here on: the row of n2, input row 2 * ph + 1
        edge_at += 2 * w;
        RawRow n2 = load_row(at, edge_at, true, c);
        RawRow n3 = load_row(at + w, edge_at + w, 2 * ph0 + 2 < h, c);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) gn[j] = live ? io::ldcs(dyr + j * plane) : 0.f;

        for (int r = 0; r < rows; ++r) {
            expand_row(n2, lane, bot[0]);
            expand_row(n3, lane, bot[1]);
#pragma unroll
            for (int j = 0; j < kGroup; ++j) g[j] = gn[j];
            if (r + 1 < rows) {  // the next pooled row's loads, in flight over this row's FMAs
                at += 2 * w;
                edge_at += 2 * w;
                dyr += wp;
                n2 = load_row(at, edge_at, true, c);
                n3 = load_row(at + w, edge_at + w, 2 * (ph0 + r) + 4 < h, c);
#pragma unroll
                for (int j = 0; j < kGroup; ++j) gn[j] = live ? io::ldcs(dyr + j * plane) : 0.f;
            }
            accumulate(top, bot, g, ws[c0], acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                top[0][i] = bot[0][i];
                top[1][i] = bot[1][i];
            }
        }
        it += rows;
    }

    // Lanes in a fixed butterfly order; each warp owns its channels.
    float* out = partial + (size_t)blockIdx.x * (kC * kK) + c0 * kK;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int k = 0; k < kK; ++k) {
            float s = acc[j][k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
            if (lane == 0) out[j * kK + k] = s;
        }
}

namespace bf {

using namespace s1;

// Row stride of the staged dy in elements: 36 words (144 bytes, a multiple
// of 16 for cp.async), so the 8 channels of a fragment's dy loads hit 32
// banks.
constexpr int kDS = kCols + 8;
constexpr int kStageElems = kXRows * kXS + kRows * kC * kDS;  // one stage: input, then dy
constexpr size_t kSmemBytes = (size_t)kStages * kStageElems * 2;

// Tile t's input into xs (stage_x) and its dy [kRows][32][kCols] into ds,
// zeros past the image: 16-byte cp.async where W/2 is a multiple of 8
// (`vec`), element by element otherwise.
__device__ __forceinline__ void stage(const uint16_t* __restrict__ x,
                                      const uint16_t* __restrict__ dy, int h, int w,
                                      const Tile& t, bool vec, uint16_t* xs, uint16_t* ds) {
    stage_x(x, h, w, t, xs);
    const int hp = h / 2, wp = w / 2;
    const size_t plane = (size_t)hp * wp;
    for (int job = threadIdx.x; job < kRows * kC * (kCols / 8); job += kThreads) {
        const int row = job >> 3, chunk = job & 7;
        const int rr = row / kC, ch = row % kC;
        const int ph = t.ph0 + rr, pw = t.pw0 + chunk * 8;
        uint16_t* dst = ds + row * kDS + chunk * 8;
        const bool in = ph < hp && pw < wp;
        const uint16_t* src = dy + ((size_t)t.b * kC + ch) * plane + (size_t)ph * wp + pw;
        if (vec) {
            cp_async16(dst, in ? src : dy, in ? 16 : 0);
        } else {
            for (int e = 0; e < 8; ++e) dst[e] = in && pw + e < wp ? src[e] : (uint16_t)0;
        }
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage1_bwd_partial_mma_kernel(const uint16_t* __restrict__ x, const float* __restrict__ weight,
                              const float* __restrict__ bias, const uint16_t* __restrict__ dy,
                              float* __restrict__ partial, int n, int h, int w) {
    extern __shared__ __align__(16) uint16_t smem[];  // kStages x (input, dy)

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int hp = h / 2, wp = w / 2;
    const int ntile = (wp + kCols - 1) / kCols, nrow = (hp + kRows - 1) / kRows;
    // Tiles: (image, row block, column tile), fewer than 2^31 (items_bf16).
    const long long total = (long long)n * nrow * ntile;
    const int first = (int)(total * blockIdx.x / gridDim.x);
    const int end = (int)(total * (blockIdx.x + 1) / gridDim.x);
    const bool vec = (wp & 7) == 0;

    // The first kStages - 1 tiles in flight; one commit group per tile,
    // empty past the block's last, so that a wait counts tiles.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        uint16_t* st = smem + s * kStageElems;
        if (first + s < end)
            stage(x, dy, h, w, tile_of(first + s, nrow, ntile), vec, st, st + kXRows * kXS);
        cp_async_commit();
    }

    // A of the pre-activations: the weights, rounded to bf16.
    uint32_t a[2][4];
    weight_fragments(weight, bias, gid, tig, a);
    // B of the gradient: tap gid (columns 0-7), and (columns 8-15) tap 8 at
    // gid 0, the bias's 1.0 at gid 1, zeros.
    const int off_8 = tap_offset(8), off_g = tap_offset(gid);
    // dW10 sums: channel tile t, column tile j (taps 8 j ..).
    float acc[2][2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[t][j][i] = 0.f;

    for (int it = first, k = 0; it < end; ++it, ++k) {
        const Tile tl = tile_of(it, nrow, ntile);
        // Tile it + kStages - 1 into the stage that tile it - 1 used.
        if (it + kStages - 1 < end) {
            uint16_t* st = smem + ((k + kStages - 1) % kStages) * kStageElems;
            stage(x, dy, h, w, tile_of(it + kStages - 1, nrow, ntile), vec, st,
                  st + kXRows * kXS);
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();  // this tile staged
        const uint16_t* xs = smem + (k % kStages) * kStageElems + 1;  // index 0: column 2 pw0 - 1
        const uint16_t* ds = xs - 1 + kXRows * kXS;

        // Warp: pooled row r of the tile, pooled columns 32 (warp & 1) ..
        // + 31 as two chunks of 16 (two groups of 8 each).
        const int r = warp >> 1;
        if (tl.ph0 + r < hp) {
#pragma unroll 1
            for (int ci = 0; ci < 2; ++ci) {
                const int p0 = (warp & 1) * 32 + ci * 16;
                if (tl.pw0 + p0 >= wp) break;
                // G[m][t]: the A fragment of member m's gradient, channel tile t.
                uint32_t g[4][2][4];
#pragma unroll
                for (int gr = 0; gr < 2; ++gr) {
                    const int pg = p0 + 8 * gr;
                    float c[4][2][4];
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        uint32_t b0, b1;
                        patch_fragment(xs, r, m, pg, gid, tig, b0, b1);
#pragma unroll
                        for (int t = 0; t < 2; ++t) {
#pragma unroll
                            for (int i = 0; i < 4; ++i) c[m][t][i] = 0.f;
                            mma_bf16(c[m][t], a[t], b0, b1);
                        }
                    }
                    // c[m][t][2 half + e]: channel 16 t + gid + 8 half at the
                    // group's position 2 tig + e.
#pragma unroll
                    for (int t = 0; t < 2; ++t)
#pragma unroll
                        for (int half = 0; half < 2; ++half) {
                            const int ch = 16 * t + gid + 8 * half;
                            const uint32_t dyw = *reinterpret_cast<const uint32_t*>(
                                ds + (r * kC + ch) * kDS + pg + 2 * tig);
                            // taken[e][m]: member m takes position 2 tig + e's dy.
                            bool taken[2][4];
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int i = 2 * half + e;
                                const float y0 = c[0][t][i], y1 = c[1][t][i];
                                const float y2 = c[2][t][i], y3 = c[3][t][i];
                                // First maximum in window order; a later member
                                // wins only if strictly greater. The gate: the
                                // maximum is > 0 (then it is also the first
                                // maximum of the ReLU'd values).
                                const bool qt = y1 > y0, qb = y3 > y2;
                                const float yt = qt ? y1 : y0, yb = qb ? y3 : y2;
                                const bool lower = yb > yt;
                                const bool up = !lower && yt > 0.f, down = lower && yb > 0.f;
                                taken[e][0] = up && !qt;
                                taken[e][1] = up && qt;
                                taken[e][2] = down && !qb;
                                taken[e][3] = down && qb;
                            }
                            const uint32_t dlo = dyw & 0xffffu, dhi = dyw & 0xffff0000u;
#pragma unroll
                            for (int m = 0; m < 4; ++m)
                                g[m][t][2 * gr + half] = taken[0][m]
                                                             ? (taken[1][m] ? dyw : dlo)
                                                             : (taken[1][m] ? dhi : 0u);
                        }
                }
                // dW10[c, k] += sum over the chunk's 16 positions of
                // G_m[c, pos] * P_m[pos, k], for each member m.
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    // Positions 2 tig, 2 tig + 1 (b?0) and + 8, + 9 (b?1).
                    const uint16_t* xr = xs + (2 * r + (m >> 1)) * kXS + 2 * p0 + (m & 1);
                    const int p = 4 * tig;
                    const uint32_t b00 =
                        (uint32_t)xr[off_g + p] | (uint32_t)xr[off_g + p + 2] << 16;
                    const uint32_t b01 =
                        (uint32_t)xr[off_g + p + 16] | (uint32_t)xr[off_g + p + 18] << 16;
                    uint32_t b10 = 0u, b11 = 0u;
                    if (gid == 0) {
                        b10 = (uint32_t)xr[off_8 + p] | (uint32_t)xr[off_8 + p + 2] << 16;
                        b11 = (uint32_t)xr[off_8 + p + 16] | (uint32_t)xr[off_8 + p + 18] << 16;
                    } else if (gid == 1) {
                        b10 = b11 = kOne | kOne << 16;
                    }
#pragma unroll
                    for (int t = 0; t < 2; ++t) {
                        mma_bf16(acc[t][0], g[m][t], b00, b01);
                        mma_bf16(acc[t][1], g[m][t], b10, b11);
                    }
                }
            }
        }
        __syncthreads();  // this tile's stage free
    }

    // The 8 warps' sums, added in warp order, to this block's partial (its
    // stages are free: what is still in flight is empty).
    float* red = reinterpret_cast<float*>(smem);  // [8 warps][32 channels][16 columns]
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int ch = 16 * t + gid + 8 * (i >> 1), col = 8 * j + 2 * tig + (i & 1);
                red[(warp * kC + ch) * 16 + col] = acc[t][j][i];
            }
    __syncthreads();
    for (int i = threadIdx.x; i < kC * kK; i += kThreads) {
        const int ch = i / kK, k = i % kK;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kThreads / 32; ++q) s += red[(q * kC + ch) * 16 + k];
        partial[(size_t)blockIdx.x * (kC * kK) + i] = s;
    }
}

}  // namespace bf

// dW and db = sums over the blocks' partials of partial[block][i]. A block
// takes 32 of the 320 sums (one per lane); warp g adds partials g, g + 8,
// ... in order, and the 8 warps' sums are added in warp order.
constexpr int kFinishWarps = 8;

__global__ void __launch_bounds__(32 * kFinishWarps)
stage1_bwd_finish_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                         float* __restrict__ db, int n_part) {
    __shared__ float red[kFinishWarps][32];
    const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5;
    const int i = blockIdx.x * 32 + lane;
    float s = 0.f;
#pragma unroll 4
    for (int p = wq; p < n_part; p += kFinishWarps) s += partial[(size_t)p * (kC * kK) + i];
    red[wq][lane] = s;
    __syncthreads();
    if (wq == 0) {
        float t = 0.f;
#pragma unroll
        for (int g = 0; g < kFinishWarps; ++g) t += red[g][lane];
        const int c = i / kK, k = i % kK;
        if (k < 9) {
            dw[c * 9 + k] = t;
        } else {
            db[c] = t;
        }
    }
}

// Blocks of a first pass: what the card holds at once, no more than items.
template <typename Kernel>
int partial_blocks(int device, Kernel kernel, long long items, size_t smem = 0) {
    const RestoreDevice restore_device;
    if (cudaSetDevice(device) != cudaSuccess || items < 0) return -1;
    if (items == 0) return 0;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
            cudaSuccess ||
        sms < 1 || per_sm < 1)
        return -1;
    const long long held = (long long)sms * per_sm;
    return (int)(held < items ? held : items);
}

// f32 items: (image, 32-column tile, pooled row); bf16: (image, block of 4
// pooled rows, 64-column tile).
long long items_f32(int n, int h, int w) {
    return (long long)n * ((w / 2 + kTile - 1) / kTile) * (h / 2);
}

long long items_bf16(int n, int h, int w) {
    const int hp = h / 2, wp = w / 2;
    if (hp <= 0 || wp <= 0) return 0;
    const long long items =
        (long long)n * ((hp + bf::kRows - 1) / bf::kRows) * ((wp + bf::kCols - 1) / bf::kCols);
    return items > 0x7fffffffLL ? -1 : items;
}

// The bf16 first pass's shared memory is above the 48 KB a launch gets
// without asking: asked once for device `device` (the current one).
cudaError_t allow_bf16_smem(int device) {
    static bool asked[64];
    if (device >= 0 && device < 64 && asked[device]) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(bf::stage1_bwd_partial_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bf::kSmemBytes);
    if (err == cudaSuccess && device >= 0 && device < 64) asked[device] = true;
    return err;
}

cudaError_t finish(const float* partial, float* dw, float* db, int n_part, cudaStream_t s) {
    stage1_bwd_finish_kernel<<<kC * kK / 32, 32 * kFinishWarps, 0, s>>>(partial, dw, db, n_part);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The weights come as weight [32, 9] and bias [32], float32, and the
// gradients leave as dW [32, 9] and db [32] (set for tools that time this
// source against one that took and gave [32, 10] arrays).
int ocrs_stage1_takes_weight_and_bias(void) { return 1; }

// Number of per-block partials ([blocks, 320] floats) ocrs_stage1_bwd needs
// on CUDA device `device`: the grid of its first pass. -1 if the card
// cannot be asked.
int ocrs_stage1_bwd_blocks(int device, int n, int h, int w) {
    return partial_blocks(device, stage1_bwd_partial_kernel, items_f32(n, h, w));
}

// x [n, 1, h, w], weight [32, 9], bias [32], dy [n, 32, h/2, w/2];
// partial: scratch of `n_part` * 320 floats, n_part as
// ocrs_stage1_bwd_blocks(device, n, h, w) gave it; dw [32, 9] and db [32]
// out. All float32, contiguous, on CUDA device `device`, whose stream is
// `stream`. Returns cudaGetLastError().
int ocrs_stage1_bwd(int device, const float* x, const float* weight, const float* bias,
                    const float* dy, float* partial, float* dw, float* db, int n, int h, int w,
                    int n_part, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_part < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_part > 0) {
        stage1_bwd_partial_kernel<<<n_part, kThreads, 0, s>>>(x, weight, bias, dy, partial, n, h,
                                                              w);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)finish(partial, dw, db, n_part, s);
}

// The same for bf16 x and dy (weight, bias, partial, dw and db float32),
// with the grid of ocrs_stage1_bwd_bf16_blocks.
int ocrs_stage1_bwd_bf16_blocks(int device, int n, int h, int w) {
    const RestoreDevice restore_device;
    if (cudaSetDevice(device) != cudaSuccess || allow_bf16_smem(device) != cudaSuccess)
        return -1;
    return partial_blocks(device, bf::stage1_bwd_partial_mma_kernel, items_bf16(n, h, w),
                          bf::kSmemBytes);
}

int ocrs_stage1_bwd_bf16(int device, const io::bf16* x, const float* weight, const float* bias,
                         const io::bf16* dy, float* partial, float* dw, float* db, int n, int h,
                         int w, int n_part, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_part < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_part > 0) {
        err = allow_bf16_smem(device);
        if (err != cudaSuccess) return (int)err;
        bf::stage1_bwd_partial_mma_kernel<<<n_part, kThreads, bf::kSmemBytes, s>>>(
            reinterpret_cast<const uint16_t*>(x), weight, bias,
            reinterpret_cast<const uint16_t*>(dy), partial, n, h, w);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)finish(partial, dw, db, n_part, s);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
