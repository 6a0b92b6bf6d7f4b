// Recognition stage 1, backward: the weight and bias gradients of
// y = maxpool2x2(relu(conv3x3_pad1(x) + b)), 1 -> 32 channels, in float32.
//
// Replaces: the backward of the Pallas kernel `stage1_fused` in
// ocrs_models_tpu/ops/pallas/stage1_kernel.py (`_bwd_call`, body
// `_bwd_kernel`). Same function: recompute the four pre-activations of each
// pool window, send dy to the FIRST maximum of the ReLU'd values in window
// order (0,0), (0,1), (1,0), (1,1), pass it only where that pre-activation
// is > 0, and sum dy * patch over the batch into dW [32, 9] and db [32]. The
// image gradient is not computed (training never asks for it).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At N=256, H=64, W=256 the function must read x once
// (16.8 MB) and dy once (256*32*32*128*4 B = 134.2 MB): 151 MB, 45 us.
// The arithmetic is, per pooled output and channel, 4 pre-activations of
// 9 FMAs and 10 FMAs of the selected patch: 33.6M * 46 FMA = 3.1 GFLOP,
// 46 us. Both bounds are about equal; reading dy is 89% of the bytes.
//
// Design: a block owns 64 pooled columns of one image and walks its 32
// pooled rows. Per row it stages the 4 x 130 input patch rows and the
// 32 x 64 tile of dy in shared memory, both with coalesced loads (dy rows
// are contiguous per channel). Thread (c, g) takes channel c = tid % 32 and
// every 8th column from g = tid / 32, so the 32 lanes of a warp share one
// pooled position: its patch reads are broadcasts, its dy reads hit 32
// banks (the tile is padded to 65 columns). Each thread keeps its
// channel's 10 weights and 10 gradient sums in registers over all 32 x 8
// positions; the 8 groups are summed through shared memory into one
// partial [32, 10] per block, and a second kernel adds the partials in
// block order. No float atomics, so repeated runs agree bit for bit.
// Pooling floors odd sizes, like torch's MaxPool2d.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 32;                  // output channels
constexpr int kK = 10;                  // 9 taps (dy * 3 + dx) + bias
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kC;  // column groups per block
constexpr int kSeg = 64;                // pooled columns per block
constexpr int kXW = 2 * kSeg + 2;       // input columns those need

__global__ void __launch_bounds__(kThreads)
stage1_bwd_partial_kernel(const float* __restrict__ x, const float* __restrict__ w10,
                          const float* __restrict__ dy, float* __restrict__ partial,
                          int h, int w) {
    __shared__ float xs[4][kXW];
    __shared__ float dys[kC][kSeg + 1];
    __shared__ float red[kGroups][kC * kK];

    const int hp = h / 2, wp = w / 2;
    const int b = blockIdx.y;
    const int pw0 = blockIdx.x * kSeg;
    const int c = threadIdx.x % kC;
    const int grp = threadIdx.x / kC;
    const float* xb = x + (size_t)b * h * w;
    const float* dyb = dy + (size_t)b * kC * hp * wp;

    float wc[kK], acc[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        wc[k] = w10[c * kK + k];
        acc[k] = 0.f;
    }

    for (int ph = 0; ph < hp; ++ph) {
        __syncthreads();  // the previous row's tiles are no longer read
        for (int i = threadIdx.x; i < 4 * kXW; i += kThreads) {
            const int r = i / kXW, col = i % kXW;
            const int yy = 2 * ph - 1 + r, xx = 2 * pw0 - 1 + col;
            xs[r][col] = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? xb[(size_t)yy * w + xx] : 0.f;
        }
        for (int i = threadIdx.x; i < kC * kSeg; i += kThreads) {
            const int cc = i / kSeg, j = i % kSeg;
            dys[cc][j] = pw0 + j < wp ? dyb[((size_t)cc * hp + ph) * wp + pw0 + j] : 0.f;
        }
        __syncthreads();

        for (int j = grp; j < kSeg && pw0 + j < wp; j += kGroups) {
            const float g = dys[c][j];
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) p[i][q] = xs[i][2 * j + q];
            // The four pre-activations, in the forward kernel's FMA order.
            float y4[4];
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    float s = wc[9];
#pragma unroll
                    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                        for (int kx = 0; kx < 3; ++kx) s = fmaf(wc[ky * 3 + kx], p[a + ky][q + kx], s);
                    y4[a * 2 + q] = s;
                }
            }
            // First maximum of the ReLU'd values in window order; the
            // gradient passes only where its pre-activation is > 0.
            int best = 0;
            float m = fmaxf(y4[0], 0.f);
#pragma unroll
            for (int k = 1; k < 4; ++k) {
                const float r = fmaxf(y4[k], 0.f);
                if (r > m) {
                    m = r;
                    best = k;
                }
            }
            float sel = y4[0];
#pragma unroll
            for (int k = 1; k < 4; ++k) sel = best == k ? y4[k] : sel;
            const float gg = sel > 0.f ? g : 0.f;
            const int a = best >> 1, q = best & 1;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                    // p[a + ky][q + kx] with a, q in {0, 1}, without dynamic
                    // register indexing.
                    const float v0 = a ? p[1 + ky][kx] : p[ky][kx];
                    const float v1 = a ? p[1 + ky][1 + kx] : p[ky][1 + kx];
                    acc[ky * 3 + kx] = fmaf(gg, q ? v1 : v0, acc[ky * 3 + kx]);
                }
            }
            acc[9] += gg;
        }
    }

#pragma unroll
    for (int k = 0; k < kK; ++k) red[grp][c * kK + k] = acc[k];
    __syncthreads();
    float* out = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (kC * kK);
    for (int i = threadIdx.x; i < kC * kK; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) s += red[g][i];
        out[i] = s;
    }
}

// dw10[i] = sum over blocks, in block order, of partial[block][i].
__global__ void stage1_bwd_finish_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw10, int n_part) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= kC * kK) return;
    float s = 0.f;
    for (int p = 0; p < n_part; ++p) s += partial[(size_t)p * (kC * kK) + i];
    dw10[i] = s;
}

dim3 partial_grid(int n, int w) { return dim3((w / 2 + kSeg - 1) / kSeg, n); }

}  // namespace

extern "C" {

// Number of per-block partials ([blocks, 320] floats) ocrs_stage1_bwd needs.
int ocrs_stage1_bwd_blocks(int n, int h, int w) {
    if (h / 2 == 0 || w / 2 == 0) return 0;
    const dim3 g = partial_grid(n, w);
    return (int)(g.x * g.y);
}

// x [n, 1, h, w], w10 [32, 10] (taps + bias), dy [n, 32, h/2, w/2];
// partial: scratch of ocrs_stage1_bwd_blocks(n, h, w) * 320 floats; dw10
// [32, 10] out (dW taps, db). All float32, contiguous, on CUDA device
// `device`, whose stream is `stream`. Returns cudaGetLastError().
int ocrs_stage1_bwd(int device, const float* x, const float* w10, const float* dy,
                    float* partial, float* dw10, int n, int h, int w, void* stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_part = ocrs_stage1_bwd_blocks(n, h, w);
    if (n_part > 0) {
        stage1_bwd_partial_kernel<<<partial_grid(n, w), kThreads, 0, s>>>(x, w10, dy, partial, h, w);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    stage1_bwd_finish_kernel<<<(kC * kK + 127) / 128, 128, 0, s>>>(partial, dw10, n_part);
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
