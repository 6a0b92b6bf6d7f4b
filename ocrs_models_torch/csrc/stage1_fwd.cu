// Recognition stage 1, forward: y = maxpool2x2(relu(conv3x3_pad1(x) + b)),
// 1 -> 32 channels, in float32.
//
// Replaces: the forward of the Pallas kernel `stage1_fused` in
// ocrs_models_tpu/ops/pallas/stage1_kernel.py (`_fwd_call`, body
// `_fwd_kernel`). The TPU kernel needed a polyphase split of x in XLA and an
// NHCW -> NHWC relayout of its output; this one reads x as it is and writes
// NCHW directly.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At N=128, H=64, W=800 the function must read x once
// (128*64*800*4 B = 26.2 MB) and write y once (128*32*32*400*4 B =
// 209.7 MB): 236 MB, 70 us. The arithmetic is 4 conv outputs per pooled
// output, each 9 FMAs plus the bias, for 32 channels: 52.4M pooled outputs
// * 4 * 19 flop = 4.0 GFLOP, 60 us. Bytes bound it, narrowly, and the
// output write is 89% of them.
//
// Design: one thread per pooled position (n, ph, pw). It loads the 4x4
// input patch that its 2x2 window of 3x3 convolutions covers into
// registers once (zero outside the image), then loops over the 32 channels
// with the 32x10 weights (9 taps + bias) in shared memory, where every
// thread of a warp reads the same word (a broadcast). For each channel a
// warp stores 32 consecutive floats of one NCHW row, so the 210 MB write is
// coalesced and there is no relayout pass. K = 10 is far too small for the
// tensor cores; the FMAs run on the CUDA cores. Pooling floors odd sizes,
// like torch's MaxPool2d.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 32;        // output channels
constexpr int kK = 10;        // 9 taps (dy * 3 + dx) + bias
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stage1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w10,
                  float* __restrict__ y, int n, int h, int w) {
    __shared__ float ws[kC * kK];
    for (int i = threadIdx.x; i < kC * kK; i += blockDim.x) ws[i] = w10[i];
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

}  // namespace

extern "C" {

// x [n, 1, h, w], w10 [32, 10], y [n, 32, h/2, w/2]; all float32,
// contiguous, on CUDA device `device`, whose stream is `stream`. Returns
// cudaGetLastError().
int ocrs_stage1_fwd(int device, const float* x, const float* w10, float* y, int n, int h,
                    int w, void* stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)n * (h / 2) * (w / 2);
    if (total > 0) {
        const long long blocks = (total + kThreads - 1) / kThreads;
        stage1_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
            x, w10, y, n, h, w);
    }
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
