// What the two bf16 stage-1 kernels (stage1_fwd.cu, stage1_bwd.cu) share:
// the tile of pooled positions a block takes, its staged input, the window
// members' offsets into it, and the weights as mma.sync A fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace s1 {

using namespace tc;

constexpr int kThreads = 256;          // threads of a block: 8 warps
constexpr int kRows = 4;               // pooled rows of a tile
constexpr int kCols = 64;              // pooled columns of a tile
constexpr int kXRows = 2 * kRows + 2;  // input rows a tile reads
// A staged input row holds columns 2 pw0 - 2 .. 2 pw0 + 2 kCols + 1 (index
// 0 is column 2 pw0 - 2), as kXPairs 4-byte pairs: with w even, a pair is
// 4-byte aligned in x and lies wholly inside the image or wholly outside.
// Row stride 76 words, so that the tap offsets of a fragment's lanes fall
// on distinct banks.
constexpr int kXPairs = kCols + 2;
constexpr int kXS = 152;
constexpr int kStages = 3;             // tiles whose input is in flight or staged
constexpr uint32_t kOne = 0x3f80u;     // bf16 1.0

// A tile: pooled rows ph0 .. ph0 + kRows - 1 and columns pw0 .. pw0 +
// kCols - 1 of image b; tiles run with the column tile fastest.
struct Tile {
    int b, ph0, pw0;
};

__device__ __forceinline__ Tile tile_of(int it, int nrow, int ntile) {
    Tile t;
    const int rest = it / ntile;
    t.pw0 = (it - rest * ntile) * kCols;
    t.ph0 = (rest % nrow) * kRows;
    t.b = rest / nrow;
    return t;
}

// Weight k of channel c: tap k < 9, the bias at 9, then zeros.
__device__ __forceinline__ float wval(const float* __restrict__ weight,
                                      const float* __restrict__ bias, int c, int k) {
    return k < 9 ? __ldg(weight + c * 9 + k) : k == 9 ? __ldg(bias + c) : 0.f;
}

// The weights as the A fragments of the two channel tiles (K: the 9 taps,
// the bias against the patch's constant 1.0, 6 zeros), rounded to bf16.
__device__ __forceinline__ void weight_fragments(const float* __restrict__ weight,
                                                 const float* __restrict__ bias, int gid, int tig,
                                                 uint32_t (&a)[2][4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        const int c0 = 16 * t + gid, c1 = c0 + 8, k = 2 * tig;
        a[t][0] = pack_bf16(wval(weight, bias, c0, k), wval(weight, bias, c0, k + 1));
        a[t][1] = pack_bf16(wval(weight, bias, c1, k), wval(weight, bias, c1, k + 1));
        a[t][2] = pack_bf16(wval(weight, bias, c0, k + 8), wval(weight, bias, c0, k + 9));
        a[t][3] = pack_bf16(wval(weight, bias, c1, k + 8), wval(weight, bias, c1, k + 9));
    }
}

// Offset of tap k (dy * 3 + dx) in the staged input.
__device__ __forceinline__ int tap_offset(int k) { return (k / 3) * kXS + k % 3; }

// The tile's input rows 2 ph0 - 1 .. 2 ph0 + 2 kRows into buffer xs, zeros
// outside the image (real zeros: B reads them): 4-byte cp.async for an
// even w, element by element otherwise.
__device__ __forceinline__ void stage_x(const uint16_t* __restrict__ x, int h, int w,
                                        const Tile& t, uint16_t* xs) {
    const uint16_t* xb = x + (size_t)t.b * h * w;
    const int col0 = 2 * t.pw0 - 2;
    if ((w & 1) == 0) {
        for (int i = threadIdx.x; i < kXRows * kXPairs; i += kThreads) {
            const int r = i / kXPairs, c = i - r * kXPairs;
            const int yy = 2 * t.ph0 - 1 + r, xx = col0 + 2 * c;
            const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
            cp_async4(xs + r * kXS + 2 * c, in ? xb + (size_t)yy * w + xx : xb, in ? 4 : 0);
        }
    } else {
        for (int i = threadIdx.x; i < kXRows * 2 * kXPairs; i += kThreads) {
            const int r = i / (2 * kXPairs), j = i - r * (2 * kXPairs);
            const int yy = 2 * t.ph0 - 1 + r, xx = col0 + j;
            xs[r * kXS + j] = yy >= 0 && yy < h && xx >= 0 && xx < w
                                  ? xb[(size_t)yy * w + xx] : (uint16_t)0;
        }
    }
}

// B of the forward product for window member m of the 8 pooled positions
// from p0 (the tile's pooled row r), lane (gid, tig): taps 2 tig, 2 tig + 1
// of position p0 + gid in b0; tap 8 and the bias's 1.0 in b1 at tig 0,
// zeros elsewhere. xs: the staged input from index 1 (column 2 pw0 - 1).
__device__ __forceinline__ void patch_fragment(const uint16_t* xs, int r, int m, int p0, int gid,
                                               int tig, uint32_t& b0, uint32_t& b1) {
    const uint16_t* xr = xs + (2 * r + (m >> 1)) * kXS + 2 * (p0 + gid) + (m & 1);
    b0 = (uint32_t)xr[tap_offset(2 * tig)] | (uint32_t)xr[tap_offset(2 * tig + 1)] << 16;
    b1 = tig == 0 ? ((uint32_t)xr[tap_offset(8)] | kOne << 16) : 0u;
}

}  // namespace s1
