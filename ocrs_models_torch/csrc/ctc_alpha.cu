// CTC forward (alpha) recursion in log space, in float32.
//
// Replaces: the Pallas kernel `ctc_kernel._alpha_call` in
// ocrs_models_tpu/ops/pallas/ctc_kernel.py (body `_alpha_kernel`). Same
// recursion over the S = 2L+1 extended-label positions:
//   alpha[t, p] = lse(alpha[t-1, p], alpha[t-1, p-1],
//                     alpha[t-1, p-2] + skip[p]) + emit[t, p]
// for 1 <= t < input_len; later steps are frozen (alpha[t] = alpha[t-1]).
// The Pallas design read a precomputed [T, N, S] additive gate for that;
// this kernel compares t with the sample's length. alpha[0] = alpha0.
// NEG_INF is -1e30 with the JAX package's `_lse3` guard, so unreachable
// states stay finite. Out: all T states, or only alpha[T-1] (`final_only`,
// the no-gradient path).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32). At N=128,
// T=257, S=129: emit read once (17.0 MB) and the states written once
// (17.0 MB): 34 MB, 10 us; about 14 operations per state, 0.9 us. The
// real limit is neither: T-1 dependent steps, each a few hundred cycles
// of shared-memory and special-function latency.
//
// Design: samples are independent, so one block per sample holds its S
// states in shared memory (double-buffered, two leading NEG_INF lanes so
// the p-1 / p-2 reads need no branch) and loops over all T steps in one
// launch with one __syncthreads per step. Thread p owns position p; its
// emission row is contiguous per sample in the [N, T, S] layout the
// gather produces. expf/logf, no fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float m = fmaxf(fmaxf(a, b), c);
    const float ms = fmaxf(m, kNegInf);
    const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
    return m <= kNegInf ? kNegInf : out;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                 const float* __restrict__ alpha0, const int* __restrict__ lens,
                                 float* __restrict__ out, int T, int S, int final_only) {
    extern __shared__ float st[];  // two buffers of S + 2 lanes
    const int n = blockIdx.x;
    const int p = threadIdx.x;
    const bool active = p < S;
    const float* e = emit + (size_t)n * T * S;
    float* o = out + (size_t)n * (final_only ? 1 : T) * S;
    const int len = lens[n];
    float* cur = st;
    float* nxt = st + S + 2;
    if (p < 2) cur[p] = nxt[p] = kNegInf;
    const float sk = active ? skip[(size_t)n * S + p] : 0.f;
    if (active) {
        const float a = alpha0[(size_t)n * S + p];
        cur[p + 2] = a;
        if (!final_only) o[p] = a;
    }
    __syncthreads();
    for (int t = 1; t < T; ++t) {
        if (active) {
            const float e_t = e[(size_t)t * S + p];
            const float v = t < len ? lse3(cur[p + 2], cur[p + 1], cur[p] + sk) + e_t : cur[p + 2];
            nxt[p + 2] = v;
            if (!final_only) o[(size_t)t * S + p] = v;
        }
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    if (final_only && active) o[p] = cur[p + 2];
}

}  // namespace

extern "C" {

// emit [n, T, S], skip [n, S] (0 or -1e30), alpha0 [n, S], lens [n] int32;
// out [n, T, S], or [n, 1, S] when final_only. All contiguous, on CUDA
// device `device`, whose stream is `stream`. S <= 1024. Returns
// cudaGetLastError().
int ocrs_ctc_alpha(int device, const float* emit, const float* skip, const float* alpha0,
                   const int* lens, float* out, int n, int T, int S, int final_only,
                   void* stream) {
    if (S < 1 || S > 1024 || T < 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        const int threads = (S + 31) / 32 * 32;
        const size_t smem = sizeof(float) * 2 * (S + 2);
        ctc_alpha_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(emit, skip, alpha0, lens, out,
                                                                     T, S, final_only);
    }
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
