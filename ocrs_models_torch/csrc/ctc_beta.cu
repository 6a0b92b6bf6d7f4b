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
// -1e30 with the JAX package's `_lse3` guard (ctc_step.cuh).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32). At N=128,
// T=257, S=129: emit and alphas read once and demit written once:
// 3 * 17.0 MB = 51 MB, 15 us; about 20 operations per state, 1.3 us. No
// recursion of T-1 dependent steps reaches that: a step is a shared-memory
// round trip, a barrier and an lse3 (three expf, one logf), some 230-280
// cycles, so T-1 steps take 30-36 us. The chain, not the bytes, is what
// this kernel can be held to; `ocrs_ctc_beta_probe` measures it.
//
// Design: nothing but the chain is on the chain.
// - One block per sample, thread p owns position p. The owner adds its own
//   emission: it publishes v[p] = B[t+1, p] + e[t+1, p] in shared memory
//   (double-buffered, two trailing NEG_INF lanes), one __syncthreads, and
//   reads v[p+1], v[p+2]. The sums are the ones the definition names, so
//   the result is the plain version's bit for bit, and a thread needs one
//   emission per step, not three. A sample of S <= 32 is one warp:
//   neighbours by __shfl_down_sync, no shared state, no block barrier.
// - No global load is waited for inside a step: a thread copies its
//   emission and saved alpha of a row into a ring in shared memory 8 steps
//   ahead (cp.async, 4 bytes each: a sample's base is not 16-byte aligned
//   for odd S; 4 steps ahead above S = 512), waits for its own copy of
//   the row it needs next, and reads the pair back with one 8-byte load.
//   Each thread reads only what it copied, so the ring needs no barrier.
//   Loads into registers did not do: with two per step in flight the step
//   waited for the newest of them.
// - demit is off the chain: sign * exp(alpha + B) of a row is computed
//   when B is known, from the prefetched alpha, and stored one step later,
//   so neither the expf nor the store is waited for.
// - Frozen steps are skipped: the recursion starts at row len - 1 with the
//   seed; rows at or above len are zero-filled before it, by all threads.
// - The loop has no branch: threads beyond S copy and compute like the
//   others on the last position's inputs, hold NEG_INF (the padding the
//   definition reads at p + 1, p + 2 >= S) and store nothing. It is
//   unrolled by two so that the two state buffers are fixed addresses.
// Measured and lost: helper warps that copy and write the gradient while
// the others only recurse (twice the warps at the barrier lengthen the
// chain by as much), and one warp holding several positions per lane for
// S > 32 (its lse3 run one after another).
// expf/logf, no fast-math.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"
#include "ctc_step.cuh"

namespace {

using ctc::kNegInf;

constexpr int kWarpMaxS = 32;           // up to here a sample is one warp
constexpr int kDeep = 8, kShallow = 4;  // ring rows: S <= 512, and above

// kWarp: the block is one warp and neighbours are exchanged by shuffles;
// else through shared memory. kRing: rows of inputs in flight or landed in
// the ring (a power of two). kProbe: the chain alone, on made-up emissions
// in registers, timed by the block's own clocks (no global access in the
// loop).
template <bool kWarp, int kRing, bool kProbe>
__global__ void ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                const float* __restrict__ alphas, const float* __restrict__ seed,
                                const float* __restrict__ sign, const int* __restrict__ lens,
                                float* __restrict__ demit, float* __restrict__ dalpha0,
                                int T, int S, long long* __restrict__ probe) {
    static_assert((kRing & (kRing - 1)) == 0, "kRing is a power of two");
    // Shared floats: [!kWarp: v, two buffers of blockDim.x + 2] [the ring:
    // kRing x blockDim.x pairs (emission, saved alpha)].
    extern __shared__ float2 st2[];
    float* st = reinterpret_cast<float*>(st2);
    const int n = blockIdx.x;
    const int p = threadIdx.x;
    const int P = blockDim.x;
    const bool act = p < S;
    const size_t base = (size_t)n * T * S;
    const float* e_col = emit + base + min(p, S - 1);
    const float* a_col = alphas + base + min(p, S - 1);
    float* de = demit + base + p;
    float* v_even = st + p;           // the state buffer of even iterations
    float* v_odd = v_even + (P + 2);  // ... and of odd ones
    float2* ring = st2 + (kWarp ? 0 : P + 2) + p;
    const int len = kProbe ? T : lens[n];
    const int tl = min(max(len, 1), T) - 1;  // the row that holds the seed
    const float sg = kProbe ? 1.f : sign[n];

    // This thread's inputs of `row` into the ring, one group per row. A row
    // below 0 copies row 0 again, into a slot no row above 0 is read from.
    auto fetch = [&](int row) {
        if (!kProbe) {
            const unsigned src = (unsigned)(max(row, 0) * S);
            float2* dst = ring + (row & (kRing - 1)) * P;
            ctc::cp_async4(&dst->x, e_col + src);
            ctc::cp_async4(&dst->y, a_col + src);
        }
        ctc::cp_async_commit();
    };
    // ... and back out of it, once `row` is the oldest group in flight.
    auto landed = [&](int row) {
        ctc::cp_async_wait<kRing - 1>();
        if (kProbe) return make_float2(-3.f - 0.1f * (row & 3), 0.f);
        float2 ea = ring[(row & (kRing - 1)) * P];
        if (!act) ea.x = 0.f;
        return ea;
    };

#pragma unroll
    for (int d = 0; d < kRing; ++d) fetch(tl - d);
    float b, sk2;
    if (kProbe) {
        b = act ? -1.f - 0.01f * p : kNegInf;
        sk2 = (p & 1) && p + 2 < S ? 0.f : kNegInf;
    } else {
        b = act ? seed[(size_t)n * S + p] : kNegInf;
        sk2 = p + 2 < S ? skip[(size_t)n * S + p + 2] : kNegInf;
    }
    if (!kWarp && p < 2) v_even[P] = v_odd[P] = kNegInf;
    if (!kProbe) {
        // Frozen rows (t >= len) and row 0 carry no gradient.
        float* rows = demit + base;
        for (size_t i = (size_t)(tl + 1) * S + p; i < (size_t)T * S; i += P) rows[i] = 0.f;
        for (int i = p; i < S; i += P) rows[i] = 0.f;
    }
    const float2 first = landed(tl);
    float e_r = first.x, a_r = first.y, g_pend = 0.f;
    long long c0 = 0;
    unsigned long long ns0 = 0;
    if (kProbe) {
        __syncthreads();
        c0 = clock64();
        ns0 = ctc::global_ns();
    }

    // Iteration i holds B[r], r = tl - i, and makes B[r - 1]. The order
    // within it: what the other threads wait for first (publish, barrier,
    // read), then the copies, loads and stores nothing waits for, then the
    // arithmetic, which the compiler interleaves.
    auto step = [&](int i, float* vb) {
        const int r = tl - i;
        const float v0 = b + e_r;
        float v1, v2;
        if (kWarp) {
            const float n1 = __shfl_down_sync(0xffffffffu, v0, 1);
            const float n2 = __shfl_down_sync(0xffffffffu, v0, 2);
            v1 = p < 31 ? n1 : kNegInf;
            v2 = p < 30 ? n2 : kNegInf;
        } else {
            vb[0] = v0;
            __syncthreads();
            v1 = vb[1];
            v2 = vb[2];
        }
        fetch(r - kRing);  // into the slot of row r, whose values are in registers
        const float2 next = landed(r - 1);
        if (!kProbe) {
            // The gradient of the row above: its expf was issued a whole
            // step ago.
            if (i > 0 && act) de[(unsigned)((r + 1) * S)] = g_pend;
            g_pend = sg * expf(a_r + b);
        }
        b = ctc::lse3(v0, v1, v2 + sk2);
        e_r = next.x;
        a_r = next.y;
    };
    int i = 0;
    for (; i + 1 < tl; i += 2) {
        step(i, v_even);
        step(i + 1, v_odd);
    }
    if (i < tl) step(i, v_even);

    if (kProbe) {
        __syncthreads();
        const long long c1 = clock64();
        const unsigned long long ns1 = ctc::global_ns();
        if (p == 0) {
            probe[0] = c1 - c0;
            probe[1] = (long long)(ns1 - ns0);
        }
        if (b == 12345.f) probe[2] = 1;  // keep the chain alive: its result decides a store
        return;
    }
    // Here b is B[0] and a_r row 0's saved alpha: its value goes to dalpha0.
    if (act) {
        if (tl >= 1) de[S] = g_pend;
        dalpha0[(size_t)n * S + p] = sg * expf(a_r + b);
    }
}

template <bool kProbe>
cudaError_t launch(const float* emit, const float* skip, const float* alphas, const float* seed,
                   const float* sign, const int* lens, float* demit, float* dalpha0, int n, int T,
                   int S, long long* probe, cudaStream_t s) {
    const int P = (S + 31) / 32 * 32;
#define OCRS_CTC_BETA(warp, ring, floats)                                               \
    ctc_beta_kernel<warp, ring, kProbe><<<n, P, sizeof(float) * (floats), s>>>(           \
        emit, skip, alphas, seed, sign, lens, demit, dalpha0, T, S, probe)
    if (S <= kWarpMaxS)
        OCRS_CTC_BETA(true, kDeep, 2 * kDeep * P);
    else if (S <= 512)
        OCRS_CTC_BETA(false, kDeep, 2 * (P + 2) + 2 * kDeep * P);
    else
        OCRS_CTC_BETA(false, kShallow, 2 * (P + 2) + 2 * kShallow * P);
#undef OCRS_CTC_BETA
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// emit, alphas [n, T, S]; skip, seed [n, S]; sign [n]; lens [n] int32;
// out demit [n, T, S], dalpha0 [n, S]. All contiguous, on CUDA device
// `device`, whose stream is `stream`. S <= 1024 and T * S < 2^31. Returns
// cudaGetLastError().
int ocrs_ctc_beta(int device, const float* emit, const float* skip, const float* alphas,
                  const float* seed, const float* sign, const int* lens, float* demit,
                  float* dalpha0, int n, int T, int S, void* stream) {
    if (S < 1 || S > 1024 || T < 1 || (long long)T * S > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return (int)cudaGetLastError();
    return (int)launch<false>(emit, skip, alphas, seed, sign, lens, demit, dalpha0, n, T, S,
                              nullptr, (cudaStream_t)stream);
}

// The dependent chain alone: one sample of T steps and S positions runs the
// recursion on made-up emissions held in registers, with no global access
// in the loop, in the design ocrs_ctc_beta picks for S. out[0]: cycles
// (clock64) of the T - 1 steps, out[1]: their nanoseconds (%globaltimer),
// out[2]: unused.
int ocrs_ctc_beta_probe(int device, int T, int S, long long* out, void* stream) {
    if (S < 1 || S > 1024 || T < 1 || (long long)T * S > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             1, T, S, out, (cudaStream_t)stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
