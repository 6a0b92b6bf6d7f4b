// Recognition stage 1, forward: y = maxpool2x2(relu(conv3x3_pad1(x) + b)),
// 1 -> 32 channels, in float32 or bfloat16.
//
// Replaces: the forward of the Pallas kernel `stage1_fused` in
// ocrs_models_tpu/ops/pallas/stage1_kernel.py (`_fwd_call`, body
// `_fwd_kernel`). The TPU kernel needed a polyphase split of x in XLA and an
// NHCW -> NHWC relayout of its output; this one reads x as it is and writes
// NCHW directly. Both entries take the weights as torch keeps them,
// weight [32, 9] (tap dy * 3 + dx) and bias [32], so the wrapper launches
// nothing but the kernel.
//
// float32. Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32
// outside the tensor cores): at N=128, H=64, W=800 the function must read
// x once (128*64*800*4 B = 26.2 MB) and write y once (128*32*32*400*4 B =
// 209.7 MB): 236 MB, 70 us. The arithmetic is 4 conv outputs per pooled
// output, each 9 FMAs plus the bias, for 32 channels: 52.4M pooled outputs
// * 4 * 19 flop = 4.0 GFLOP, 60 us. Bytes bound it, narrowly, and the
// output write is 89% of them. The Pallas kernel's f32 product is pinned
// to HIGHEST precision, so it stays on the CUDA cores. Design: one thread per
// pooled position (n, ph, pw) loads the 4x4 input patch its 2x2 window of
// 3x3 convolutions covers into registers once (zero outside the image),
// then loops over the 32 channels with the 32x10 weights in shared memory,
// where every thread of a warp reads the same word (a broadcast). For each
// channel a warp stores 32 consecutive floats of one NCHW row, so the write
// is coalesced and there is no relayout pass.
//
// bfloat16 (`dt=jnp.bfloat16`, the Pallas kernel's default): x, the taps
// and the bias are bf16 values, their products exact and summed in f32,
// ReLU and max in f32, y rounded once to bf16. At N=128, H=64, W=800 the
// bytes halve (13.1 + 104.9 MB, 35 us) and bound it: the 4.0 GFLOP take
// 4 us at the bf16 tensor-core rate (989 TFLOP/s), against 60 us as f32
// FMAs. So the products run on the tensor cores, as the Pallas kernel's
// `_dot(w_bf, patches)` does on the MXU. Design, around the write:
// - An implicit GEMM on mma.sync m16n8k16 (bf16, f32 accumulation). A is
//   the weights: 32 channels as two m16 tiles x K = 16, the 9 taps, the
//   bias against a constant 1.0 row of the patch, and 6 zeros; it is built
//   once per thread in registers, each value rounded to bf16. B is the
//   patch of 8 pooled positions, built straight from the input tile in
//   shared memory: a lane needs two or three of its position's taps, whose
//   offsets depend on the lane alone, so no im2col tile is written.
// - Each window member (0,0), (0,1), (1,0), (1,1) has its own B over the
//   same 8 positions, so a lane ends with all four pre-activations of its
//   (channel, position) pairs: max, ReLU and the rounding happen in
//   registers. The four run the same instructions, so equal patches give
//   equal sums.
// - Near 0 the tensor cores' sum is not used: their f32 accumulation keeps
//   fewer low bits of the smaller products than a chain of rounded FMAs,
//   which a result of cancelling terms can feel by more than a bf16 ulp.
//   Where a pooled sum lies within 2^-14 of the largest its terms can sum
//   to (sum |w| times the largest |x| the warp's patches read, plus |b|),
//   the lane sums that output again as the f32 kernel does (f32_pool).
//   Such sums are rare, and a warp's group of 256 outputs takes that path
//   only when one of them needs it. Without it, outputs two and more bf16
//   ulps from the plain version's appeared at the GPU tests' shapes.
// - A tile is 4 pooled rows x 64 pooled columns of one image, and a block
//   walks a share of the tiles (the grid is what the card holds at once):
//   the input of the next two tiles is in flight (4-byte cp.async into
//   three buffers) while one is computed. The output goes through shared
//   memory (two buffers; rows padded so that the fragment stores hit 32
//   banks) and leaves as 16-byte stores, 128 contiguous bytes per
//   (channel, row); where W/2 is no multiple of 8 the rows are not 16-byte
//   aligned and are stored element by element.
// Pooling floors odd sizes, like torch's MaxPool2d; any h and w are taken.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"
#include "bf16_io.cuh"
#include "stage1_tile.cuh"

namespace {

constexpr int kC = 32;        // output channels
constexpr int kK = 10;        // 9 taps (dy * 3 + dx) + bias
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stage1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, float* __restrict__ y, int n, int h, int w) {
    __shared__ float ws[kC * kK];
    for (int i = threadIdx.x; i < kC * kK; i += blockDim.x) {
        const int c = i / kK, k = i % kK;
        ws[i] = k < 9 ? weight[c * 9 + k] : bias[c];
    }
    __syncthreads();

    const int hp = h / 2, wp = w / 2;
    const long long total = (long long)n * hp * wp;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int pw = (int)(idx % wp);
    const long long rest = idx / wp;
    const int ph = (int)(rest % hp);
    const int b = (int)(rest / hp);

    const float* xb = x + (size_t)b * h * w;
    const int y0 = 2 * ph - 1, x0 = 2 * pw - 1;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int yy = y0 + i;
        const bool row_ok = yy >= 0 && yy < h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int xx = x0 + j;
            p[i][j] = (row_ok && xx >= 0 && xx < w) ? __ldg(xb + (size_t)yy * w + xx) : 0.f;
        }
    }

    const size_t plane = (size_t)hp * wp;
    float* yb = y + (size_t)b * kC * plane + (size_t)ph * wp + pw;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
        const float* wc = ws + c * kK;
        float m = -INFINITY;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float s = wc[9];
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        s = fmaf(wc[dy * 3 + dx], p[a + dy][q + dx], s);
                    }
                }
                m = fmaxf(m, s);
            }
        }
        yb[c * plane] = fmaxf(m, 0.f);  // relu(max(.)) == max(relu(.))
    }
}

namespace bf {

using namespace s1;

// Row stride of the staged output in elements: 36 words (144 bytes, a
// multiple of 16), so the 8 channels of a fragment store hit 32 banks.
constexpr int kYS = kCols + 8;
// A pooled sum closer to 0 than this share of the largest its terms can
// sum to (sum |w| max|x| + |b|) is summed again as the f32 kernel sums it
// (f32_pool).
constexpr float kNear = 0x1p-14f;

// The pooled output at the tile's pooled row r, column p of the channel
// whose weights (bf16 values) are w10, as the f32 kernel computes it: each
// member's sum by f32 FMAs from the bias in tap order, then max, ReLU and
// one rounding to bf16. Taken where the tensor cores' sum lies near 0: their
// f32 accumulation keeps fewer low bits of the smaller products than a
// chain of rounded FMAs does, which a result of cancelling terms can feel
// by more than a bf16 ulp, and a sum near 0 by its sign.
__device__ __forceinline__ uint32_t f32_pool(const uint16_t* xs, const float* w10, int r, int p) {
    float best = -INFINITY;
    for (int m = 0; m < 4; ++m) {
        const uint16_t* xr = xs + (2 * r + (m >> 1)) * kXS + 2 * p + (m & 1);
        float s = w10[9];
        for (int k = 0; k < 9; ++k) s = fmaf(w10[k], io::widen(xr[tap_offset(k)]), s);
        best = fmaxf(best, s);
    }
    return pack_bf16(fmaxf(best, 0.f), 0.f) & 0xffffu;
}

// The bf16 pair nearest to (relu(lo), relu(hi)), lo in the lower half.
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

__global__ void __launch_bounds__(kThreads)
stage1_fwd_kernel_mma(const uint16_t* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, uint16_t* __restrict__ y, int n, int h,
                      int w) {
    __shared__ __align__(16) uint16_t xs_ring[kStages][kXRows * kXS];
    __shared__ __align__(16) uint16_t ys[2][kRows * kC * kYS];
    __shared__ float ws[kC * kK];  // the weights as bf16 values, for f32_pool

    const int hp = h / 2, wp = w / 2;
    const int ntile = (wp + kCols - 1) / kCols, nrow = (hp + kRows - 1) / kRows;
    const long long total = (long long)n * nrow * ntile;  // < 2^31 (launch_bf16)
    const int first = (int)(total * blockIdx.x / gridDim.x);
    const int end = (int)(total * (blockIdx.x + 1) / gridDim.x);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const bool vec = (wp & 7) == 0;
    const size_t plane = (size_t)hp * wp;

    // The first kStages - 1 tiles' input in flight; one commit group per
    // tile, empty past the block's last, so that a wait counts tiles.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (first + s < end) stage_x(x, h, w, tile_of(first + s, nrow, ntile), xs_ring[s]);
        cp_async_commit();
    }
    for (int i = threadIdx.x; i < kC * kK; i += kThreads) {
        const int c = i / kK, k = i % kK;
        ws[i] = __bfloat162float(__float2bfloat16_rn(k < 9 ? weight[c * 9 + k] : bias[c]));
    }
    uint32_t a[2][4];
    weight_fragments(weight, bias, gid, tig, a);
    __syncthreads();
    // The lane's channels 16 t + gid + 8 half: sum |w| over the taps, and |b|.
    float w_abs[2][2], b_abs[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float* w10 = ws + (16 * t + gid + 8 * half) * kK;
            float s = 0.f;
            for (int k = 0; k < 9; ++k) s += fabsf(w10[k]);
            w_abs[t][half] = s;
            b_abs[t][half] = fabsf(w10[9]);
        }

    // Warp: pooled row r of the tile, pooled columns 32 (warp & 1) .. + 31
    // in four groups of 8; it reads input rows 2 r .. 2 r + 3, columns
    // (index) 64 (warp & 1) .. + 66.
    const int r = warp >> 1, wcol = 64 * (warp & 1);
    for (int it = first, k = 0; it < end; ++it, ++k) {
        const Tile tl = tile_of(it, nrow, ntile);
        // Tile it + kStages - 1 into the buffer that tile it - 1 used.
        if (it + kStages - 1 < end)
            stage_x(x, h, w, tile_of(it + kStages - 1, nrow, ntile),
                    xs_ring[(k + kStages - 1) % kStages]);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();  // this tile's input staged; ys[k & 1]'s last stores are done
        const uint16_t* xs = xs_ring[k % kStages];
        uint16_t* yt = ys[k & 1];

        // The largest |x| the warp's patches read.
        uint32_t xm = 0;
#pragma unroll
        for (int e = 0; e < (4 * 66 + 31) / 32; ++e) {
            const int i = lane + 32 * e;
            const int rr = i / 66;
            if (i < 4 * 66)
                xm = max(xm, (uint32_t)(xs[(2 * r + rr) * kXS + wcol + 1 + i - rr * 66] & 0x7fffu));
        }
        const float x_abs = io::widen((uint16_t)__reduce_max_sync(0xffffffffu, xm));
        // Below near[t][half], the sum of channel 16 t + gid + 8 half is
        // summed again by f32_pool.
        float near[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int half = 0; half < 2; ++half)
                near[t][half] = kNear * fmaf(w_abs[t][half], x_abs, b_abs[t][half]);

        if (tl.ph0 + r < hp) {
#pragma unroll 1
            for (int gi = 0; gi < 4; ++gi) {
                const int p0 = (warp & 1) * 32 + gi * 8;
                if (tl.pw0 + p0 >= wp) break;
                float c[4][2][4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    uint32_t b0, b1;
                    patch_fragment(xs + 1, r, m, p0, gid, tig, b0, b1);
#pragma unroll
                    for (int t = 0; t < 2; ++t) {
#pragma unroll
                        for (int i = 0; i < 4; ++i) c[m][t][i] = 0.f;
                        mma_bf16(c[m][t], a[t], b0, b1);
                    }
                }
                // c[m][t][2 half + e]: channel 16 t + gid + 8 half at the
                // group's position 2 tig + e; the pooled sums v.
                float v[2][2][2];
                bool near0 = false;
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int i = 2 * half + e;
                            v[t][half][e] = fmaxf(fmaxf(c[0][t][i], c[1][t][i]),
                                                  fmaxf(c[2][t][i], c[3][t][i]));
                            near0 |= fabsf(v[t][half][e]) < near[t][half];
                        }
                uint32_t out[2][2];
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        out[t][half] = pack_relu_bf16(v[t][half][0], v[t][half][1]);
                if (__any_sync(0xffffffffu, near0)) {  // rare: sums near 0 in the warp
#pragma unroll
                    for (int t = 0; t < 2; ++t)
#pragma unroll
                        for (int half = 0; half < 2; ++half)
#pragma unroll
                            for (int e = 0; e < 2; ++e)
                                if (fabsf(v[t][half][e]) < near[t][half]) {
                                    const uint32_t bits = f32_pool(
                                        xs + 1, ws + (16 * t + gid + 8 * half) * kK, r,
                                        p0 + 2 * tig + e);
                                    out[t][half] = e ? (out[t][half] & 0xffffu) | bits << 16
                                                     : (out[t][half] & 0xffff0000u) | bits;
                                }
                }
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        *reinterpret_cast<uint32_t*>(
                            yt + (r * kC + 16 * t + gid + 8 * half) * kYS + p0 + 2 * tig) =
                            out[t][half];
            }
        }
        __syncthreads();  // ys[k & 1] complete; this tile's input buffer free

        // The tile's rows (pooled row, channel) to y, 8 pooled columns a
        // thread at a time: one 16-byte store where the row holds all 8 and
        // is 16-byte aligned (W/2 a multiple of 8), else element by element.
        for (int job = threadIdx.x; job < kRows * kC * (kCols / 8); job += kThreads) {
            const int row = job >> 3, chunk = job & 7;
            const int rr = row / kC, ch = row % kC;
            const int ph = tl.ph0 + rr, pw = tl.pw0 + chunk * 8;
            if (ph >= hp || pw >= wp) continue;
            const uint16_t* src = yt + row * kYS + chunk * 8;
            uint16_t* dst = y + ((size_t)tl.b * kC + ch) * plane + (size_t)ph * wp + pw;
            if (vec && pw + 8 <= wp) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int e = 0; e < 8 && pw + e < wp; ++e) dst[e] = src[e];
            }
        }
    }
}

}  // namespace bf

cudaError_t launch_f32(const float* x, const float* weight, const float* bias, float* y, int n,
                       int h, int w, cudaStream_t s) {
    const long long total = (long long)n * (h / 2) * (w / 2);
    if (total > 0) {
        const long long blocks = (total + kThreads - 1) / kThreads;
        stage1_fwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, weight, bias, y, n, h, w);
    }
    return cudaGetLastError();
}

// Blocks the card holds at once of the bf16 kernel: SM count x resident
// blocks, asked of device `device` once.
int resident_blocks(int device) {
    static int held[64];
    if (device < 0 || device >= 64) return -1;
    if (held[device] == 0) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bf::stage1_fwd_kernel_mma,
                                                          kThreads, 0) != cudaSuccess ||
            sms < 1 || per_sm < 1)
            return -1;
        held[device] = sms * per_sm;
    }
    return held[device];
}

cudaError_t launch_bf16(int device, const uint16_t* x, const float* weight, const float* bias,
                        uint16_t* y, int n, int h, int w, cudaStream_t s) {
    const int hp = h / 2, wp = w / 2;
    if ((long long)n * hp * wp > 0) {
        const long long tiles = (long long)n * ((hp + bf::kRows - 1) / bf::kRows) *
                                ((wp + bf::kCols - 1) / bf::kCols);
        const int held = resident_blocks(device);
        if (held < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
        const int blocks = (int)(tiles < held ? tiles : held);
        bf::stage1_fwd_kernel_mma<<<blocks, kThreads, 0, s>>>(x, weight, bias, y, n, h, w);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The weights come as weight [32, 9] and bias [32], float32 (set for tools
// that time this source against one that took them as one [32, 10] array).
int ocrs_stage1_takes_weight_and_bias(void) { return 1; }

// x [n, 1, h, w], weight [32, 9], bias [32], y [n, 32, h/2, w/2]; all
// float32, contiguous, on CUDA device `device`, whose stream is `stream`.
// Returns cudaGetLastError().
int ocrs_stage1_fwd(int device, const float* x, const float* weight, const float* bias,
                    float* y, int n, int h, int w, void* stream) {
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_f32(x, weight, bias, y, n, h, w, (cudaStream_t)stream);
}

// The same with x and y bf16 (weight and bias float32, rounded to bf16 by
// the kernel).
int ocrs_stage1_fwd_bf16(int device, const io::bf16* x, const float* weight, const float* bias,
                         io::bf16* y, int n, int h, int w, void* stream) {
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_bf16(device, reinterpret_cast<const uint16_t*>(x), weight, bias,
                            reinterpret_cast<uint16_t*>(y), n, h, w, (cudaStream_t)stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
