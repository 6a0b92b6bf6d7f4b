// CTC backward: the reverse weighted-beta recursion in log space, in
// float32, emitting the emission gradient.
//
// Replaces: the Pallas kernel `ctc_kernel._beta_call` in
// ocrs_models_tpu/ops/pallas/ctc_kernel.py (body `_beta_kernel`) and the
// sign and step-0 handling of its caller `_vjp_bwd`. With the cotangent d
// of alpha[T-1] folded into the seed B[T-1] = log|d| - alpha[T-1] (NEG_INF
// where d = 0), for t = T-2 down to 0:
//   B[t, p] = lse(B[t+1, p]   + e[t+1, p],
//                 B[t+1, p+1] + e[t+1, p+1],
//                 B[t+1, p+2] + e[t+1, p+2] + skip[p+2])
// while step t+1 is active (t+1 < input_len), else B[t] = B[t+1]. Out:
// demit[t, p] = sign * exp(alpha[t, p] + B[t, p]) for active 1 <= t, 0 at
// frozen steps and at t = 0, whose value goes to dalpha0 instead. `sign`
// is the sample's cotangent sign (uniform within a sample). NEG_INF is
// -1e30 with the JAX package's `_lse3` guard.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32). At N=128,
// T=257, S=129: emit and alphas read once and demit written once:
// 3 * 17.0 MB = 51 MB, 15 us; about 20 operations per state, 1.3 us. As
// in the alpha kernel, the T-1 dependent steps are the real limit.
//
// Design: one block per sample, thread p owns position p, the S states
// double-buffered in shared memory with two trailing NEG_INF lanes for the
// p+1 / p+2 reads, one launch looping over all T steps with one
// __syncthreads per step. Emissions, alphas and demit are contiguous per
// sample ([N, T, S]). expf/logf, no fast-math.

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

__global__ void ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                const float* __restrict__ alphas, const float* __restrict__ seed,
                                const float* __restrict__ sign, const int* __restrict__ lens,
                                float* __restrict__ demit, float* __restrict__ dalpha0,
                                int T, int S) {
    extern __shared__ float st[];  // two buffers of S + 2 lanes
    const int n = blockIdx.x;
    const int p = threadIdx.x;
    const bool active = p < S;
    const size_t base = (size_t)n * T * S;
    const float* e = emit + base;
    const float* al = alphas + base;
    float* de = demit + base;
    const int len = lens[n];
    const float sg = sign[n];
    float* cur = st;
    float* nxt = st + S + 2;
    if (p < 2) cur[S + p] = nxt[S + p] = kNegInf;
    const float sk2 = p + 2 < S ? skip[(size_t)n * S + p + 2] : kNegInf;
    float b = 0.f;
    if (active) {
        b = seed[(size_t)n * S + p];
        cur[p] = b;
    }
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
        if (t < T - 1) {
            if (active) {
                const float* et = e + (size_t)(t + 1) * S;
                const float e0 = et[p];
                const float e1 = p + 1 < S ? et[p + 1] : 0.f;
                const float e2 = p + 2 < S ? et[p + 2] : 0.f;
                b = t + 1 < len ? lse3(cur[p] + e0, cur[p + 1] + e1, cur[p + 2] + e2 + sk2)
                                : cur[p];
                nxt[p] = b;
            }
            __syncthreads();
            float* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        if (active) {
            const float g = sg * expf(al[(size_t)t * S + p] + b);
            if (t == 0) {
                dalpha0[(size_t)n * S + p] = g;
                de[p] = 0.f;
            } else {
                de[(size_t)t * S + p] = t < len ? g : 0.f;
            }
        }
    }
}

}  // namespace

extern "C" {

// emit, alphas [n, T, S]; skip, seed [n, S]; sign [n]; lens [n] int32;
// out demit [n, T, S], dalpha0 [n, S]. All contiguous, on CUDA device
// `device`, whose stream is `stream`. S <= 1024. Returns
// cudaGetLastError().
int ocrs_ctc_beta(int device, const float* emit, const float* skip, const float* alphas,
                  const float* seed, const float* sign, const int* lens, float* demit,
                  float* dalpha0, int n, int T, int S, void* stream) {
    if (S < 1 || S > 1024 || T < 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        const int threads = (S + 31) / 32 * 32;
        const size_t smem = sizeof(float) * 2 * (S + 2);
        ctc_beta_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(emit, skip, alphas, seed, sign,
                                                                    lens, demit, dalpha0, T, S);
    }
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
