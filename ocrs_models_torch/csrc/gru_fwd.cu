// Bidirectional GRU recurrence of one layer, forward, in float32.
//
// Replaces: the forward of the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py (`_fwd_call`, body
// `_fwd_kernel`). Same contract: px_f, px_b [T, N, 3H] are x @ W_ih + b_ih
// per direction in natural time order; the backward direction reads step
// T-1-i and writes its output back in natural order. w_hh [2, H, 3H] is
// laid out for h @ W (direction 0 = forward), b_hh [2, 3H]. Gate order is
// r, z, n with n = tanh(xn + r * (W_hn h + b_hn)); all gate math is f32.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At T=201, N=128, H=256: each step is one [N,H] x [H,3H]
// product per direction, 2 * 2*128*256*768 = 100.7 MFLOP for both, and
// the T steps form a chain of dependent products, so the whole call is
// 20.2 GFLOP, 0.30 ms at the f32 rate. The device-memory traffic is px
// read once (158 MB), ys written once (52.7 MB) and W_hh (1.6 MB): 212 MB,
// 63 us. Operations bound it. Besides, W_hh is read again from L2 at
// every step, 1.6 MB per step for each batch tile that needs it.
//
// Design: one launch per step, with the loop over steps in the C entry
// (one ctypes call per layer); stream order is the barrier between steps.
// The grid is (tiles of 32 hidden units, tiles of 16 batch rows,
// direction), 128 blocks at H=256, N=128. A block owns the r, z and n
// columns of its 32 units, so it finishes the gate math itself and writes
// h_t with no second pass. Each step it stages its 256x96 slice of W_hh
// (96 KB, from L2, in unrolled 16-byte loads) and its 16 rows of h_{t-1}
// in shared memory; every thread then computes a 2-row x 2-unit x 3-gate
// register tile over half of the k range (the two halves are summed through shared memory), with
// one float4 read of h per 4 k and one float2 read of W per gate and k:
// 14 shared loads per 48 FMAs. The threads that do the gate math fetch
// their x-projections first, so that HBM latency hides under the staging.
// h lives in two ping-pong buffers in device memory, f32. Keeping W_hh on chip across steps (a persistent grid or
// thread block clusters with DSMEM) and wgmma are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBU = 32;                // hidden units per block
constexpr int kBN = 16;                // batch rows per block
constexpr int kTU = kBU / 2;           // thread columns: 2 units each
constexpr int kTR = kBN / 2;           // thread rows: 2 batch rows each
constexpr int kKSplit = 2;             // k range split across thread groups
constexpr int kThreads = kTU * kTR * kKSplit;  // 256

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ constexpr int h_stride(int H) { return H + 4; }  // keeps float4 alignment

size_t smem_bytes(int H) {
    return sizeof(float) * ((size_t)H * 3 * kBU + (size_t)kBN * h_stride(H) + kBN * 3 * kBU);
}

// Requires H % 8 == 0 (16-byte loads of W_hh and h; float4 reads of h
// over each half of k).
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const float* __restrict__ px_f, const float* __restrict__ px_b,
                const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                float* __restrict__ ys_f, float* __restrict__ ys_b,
                const float* __restrict__ h_in, float* __restrict__ h_out,
                int step, int T, int N, int H) {
    extern __shared__ __align__(16) float smem[];
    const int HS = h_stride(H);
    float* ws = smem;                        // [H][3][kBU]: this block's W_hh columns
    float* hs = ws + (size_t)H * 3 * kBU;    // [kBN][HS]: rows of h_{t-1}
    float* red = hs + kBN * HS;              // [kBN][3][kBU]: partials of k-half 1

    const int dir = blockIdx.z;
    const int u0 = blockIdx.x * kBU;
    const int n0 = blockIdx.y * kBN;
    const int t = dir == 0 ? step : T - 1 - step;
    const int H3 = 3 * H;
    const size_t state = (size_t)N * H;

    const int half = threadIdx.x / (kTU * kTR);
    const int tu = threadIdx.x % kTU;
    const int tr = (threadIdx.x / kTU) % kTR;

    // Group 0 does the gate math: fetch its x-projections and biases now,
    // so their latency hides under the staging and the k loop.
    const float* px = (dir == 0 ? px_f : px_b) + (size_t)t * N * H3;
    const float* b = b_hh + dir * H3;
    float xg[3][2][2], bg[3][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int u = u0 + 2 * tu + j;
        const bool u_ok = half == 0 && u < H;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            bg[g][j] = u_ok ? b[g * H + u] : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = n0 + 2 * tr + i;
                xg[g][i][j] = u_ok && row < N ? px[(size_t)row * H3 + g * H + u] : 0.f;
            }
        }
    }

    // Stage the block's W_hh columns and its rows of h_{t-1}, 16 bytes per
    // load, unrolled so that many loads are in flight at once.
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* W = w_hh + (size_t)dir * H * H3;
    constexpr int kQ = kBU / 4;  // float4 per (k, gate) row of the slice
#pragma unroll 8
    for (int i = threadIdx.x; i < H * 3 * kQ; i += kThreads) {
        const int k = i / (3 * kQ);
        const int g = (i / kQ) % 3;
        const int u = u0 + 4 * (i % kQ);
        reinterpret_cast<float4*>(ws)[i] =
            u < H ? __ldg(reinterpret_cast<const float4*>(W + (size_t)k * H3 + g * H + u)) : zero;
    }
    const float* hin = h_in + dir * state;
    const int h4 = H / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBN * h4; i += kThreads) {
        const int r = i / h4, k = 4 * (i % h4);
        *reinterpret_cast<float4*>(hs + r * HS + k) =
            n0 + r < N ? *reinterpret_cast<const float4*>(hin + (size_t)(n0 + r) * H + k) : zero;
    }
    __syncthreads();

    const float* h0 = hs + (2 * tr) * HS;
    const float* h1 = h0 + HS;
    float acc[3][2][2];
#pragma unroll
    for (int g = 0; g < 3; ++g)
        acc[g][0][0] = acc[g][0][1] = acc[g][1][0] = acc[g][1][1] = 0.f;

    const int kbeg = half * (H / kKSplit), kend = kbeg + H / kKSplit;
#pragma unroll 2
    for (int k = kbeg; k < kend; k += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(h0 + k);
        const float4 b4 = *reinterpret_cast<const float4*>(h1 + k);
        const float ha[4] = {a4.x, a4.y, a4.z, a4.w};
        const float hb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
                const float2 w = *reinterpret_cast<const float2*>(
                    ws + ((k + kk) * 3 + g) * kBU + 2 * tu);
                acc[g][0][0] = fmaf(ha[kk], w.x, acc[g][0][0]);
                acc[g][0][1] = fmaf(ha[kk], w.y, acc[g][0][1]);
                acc[g][1][0] = fmaf(hb[kk], w.x, acc[g][1][0]);
                acc[g][1][1] = fmaf(hb[kk], w.y, acc[g][1][1]);
            }
        }
    }

    // Sum the two k-halves; group 0 finishes the gate math.
    if (half == 1) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    red[((2 * tr + i) * 3 + g) * kBU + 2 * tu + j] = acc[g][i][j];
    }
    __syncthreads();
    if (half == 1) return;

    float* ys = dir == 0 ? ys_f : ys_b;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r_local = 2 * tr + i;
        const int row = n0 + r_local;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int u = u0 + 2 * tu + j;
            if (u >= H) continue;
            const float* part = red + (r_local * 3) * kBU + 2 * tu + j;
            const float hr = acc[0][i][j] + part[0];
            const float hz = acc[1][i][j] + part[kBU];
            const float hn = acc[2][i][j] + part[2 * kBU];
            const float r = sigmoid(xg[0][i][j] + (hr + bg[0][j]));
            const float z = sigmoid(xg[1][i][j] + (hz + bg[1][j]));
            const float c = tanhf(xg[2][i][j] + r * (hn + bg[2][j]));
            const float h_new = (1.f - z) * c + z * hs[r_local * HS + u];
            h_out[dir * state + (size_t)row * H + u] = h_new;
            ys[((size_t)t * N + row) * H + u] = h_new;
        }
    }
}

}  // namespace

extern "C" {

// px_f, px_b [T, N, 3H]; w_hh [2, H, 3H]; b_hh [2, 3H]; ys_f, ys_b [T, N, H];
// h_buf: scratch of 2 * 2 * N * H floats (ping-pong x direction). All
// float32, contiguous, on CUDA device `device`, whose stream is `stream`.
// Returns the first CUDA error of the T launches, or 0.
int ocrs_gru_fwd(int device, const float* px_f, const float* px_b, const float* w_hh,
                 const float* b_hh, float* ys_f, float* ys_b, float* h_buf,
                 int T, int N, int H, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (H % 8 != 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t buf = (size_t)2 * N * H;  // both directions
    err = cudaMemsetAsync(h_buf, 0, buf * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = smem_bytes(H);
    err = cudaFuncSetAttribute(gru_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((H + kBU - 1) / kBU, (N + kBN - 1) / kBN, 2);
    for (int step = 0; step < T; ++step) {
        const float* h_in = h_buf + (step % 2) * buf;
        float* h_out = h_buf + ((step + 1) % 2) * buf;
        gru_step_kernel<<<grid, kThreads, smem, s>>>(px_f, px_b, w_hh, b_hh, ys_f, ys_b,
                                                     h_in, h_out, step, T, N, H);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
