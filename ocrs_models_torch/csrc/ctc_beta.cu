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
// - Above S = 1024 a block holds 1024 threads at most, so a thread owns
//   an even k = 2 ceil(S / 2048) positions and V lives in shared memory
//   (or, past what a block's shared memory holds, B in demit's own rows):
//   ctc_beta_kernel_wide. The Pallas kernel takes any S; so does this one,
//   up to the 32-bit offsets' T * S < 2^31.
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

// S > 1024 (ctc_step.cuh, "Wide samples"): thread p owns the k positions
// j = p + i P. Iteration q makes B[q] from V[q+1] = B[q+1] + e[q+1], which
// the step before published in one buffer (two trailing NEG_INF lanes, and
// lanes at or past S hold NEG_INF: the padding the definition reads), and
// publishes V[q] into the other, then one __syncthreads. B[q] itself is
// used at once: demit[q] = sign * exp(alpha[q] + B[q]) is stored (dalpha0
// at q = 0) and V[q] = B[q] + e[q] published, so nothing but V crosses a
// step. In kRing V and the skip terms of p + 2 are in shared memory, and
// each thread copies its (emission, saved alpha) pairs of a row into a
// ring kWideRing - 1 steps ahead (one cp.async group a row, 2k copies in
// it; a slot is refilled one step after its row was read, past the
// barrier that ends that read).
// In kGlobal demit's own rows hold B: row q gets B[q], and row q + 2, read
// by no thread after the step before, is turned into its gradient in
// place by the thread that owns each position; row 1 follows the loop, and
// row 0's B goes to dalpha0 before the row is zeroed. Each sum is the
// plain version's, in its order, so the results stay its bit for bit.
template <int kDesign, bool kProbe>
__global__ void __launch_bounds__(ctc::kMaxThreads)
    ctc_beta_kernel_wide(const float* __restrict__ emit, const float* __restrict__ skip,
                         const float* __restrict__ alphas, const float* __restrict__ seed,
                         const float* __restrict__ sign, const int* __restrict__ lens, float* demit,
                         float* __restrict__ dalpha0, int T, int S, long long* __restrict__ probe) {
    using namespace ctc;
    static_assert(kDesign != kGlobal || !kProbe, "the probe keeps the state in shared memory");
    constexpr bool kInShared = kDesign == kRing;
    constexpr int R = kWideRing;
    // Shared floats: [V buffer 0: W + 2][V buffer 1: W + 2][skip of p + 2: W]
    // [ring: R x W pairs (emission, saved alpha)].
    extern __shared__ float2 st2[];
    float* const st = reinterpret_cast<float*>(st2);
    const Wide w = wide_shape(S);
    const int k = w.k, P = blockDim.x, W = w.W;
    const int n = blockIdx.x, p = threadIdx.x;
    float* const buf0 = st;
    float* const buf1 = st + (W + 2);
    float* const sk2s = st + 2 * (W + 2);
    float2* const ring = reinterpret_cast<float2*>(sk2s + W);
    const size_t base = (size_t)n * T * S;
    const float* e_n = emit + base;
    const float* a_n = alphas + base;
    float* de = demit + base;
    const int len = kProbe ? T : lens[n];
    const int tl = min(max(len, 1), T) - 1;  // the row that holds the seed
    const float sg = kProbe ? 1.f : sign[n];

    // This thread's pairs of `row` into the ring, one group per row. A row
    // below 0 copies row 0 again, into a slot no row above 0 is read from.
    auto fetch = [&](int row) {
        if (!kInShared) return;
        if (!kProbe) {
            const unsigned src = (unsigned)(max(row, 0) * S);
            float2* dst = ring + (row & (R - 1)) * W;
            for (int i = 0; i < k; ++i) {
                const int j = p + i * P, q = min(j, S - 1);
                cp_async4(&dst[j].x, e_n + src + q);
                cp_async4(&dst[j].y, a_n + src + q);
            }
        }
        cp_async_commit();
    };
    // (emission, saved alpha) of `row` at position j, from the ring.
    auto inputs = [&](int row, int j) {
        if (kProbe) return make_float2(-3.f - 0.1f * (row & 3), 0.f);
        return ring[(row & (R - 1)) * W + j];
    };
    // A gradient of `row`: demit's row, or dalpha0 at row 0.
    auto put_grad = [&](int row, int j, float g) {
        if (row >= 1)
            de[(unsigned)(row * S) + j] = g;
        else
            dalpha0[(size_t)n * S + j] = g;
    };

    if (!kProbe) {
        // Frozen rows (t > tl) and row 0 carry no gradient (kGlobal zeroes
        // row 0 once its B is used).
        for (size_t i = (size_t)(tl + 1) * S + p; i < (size_t)T * S; i += P) de[i] = 0.f;
        if (kInShared)
            for (int j = p; j < S; j += P) de[j] = 0.f;
    }
    for (int d = 0; d < R; ++d) fetch(tl - d);
    if (kInShared) {
        cp_async_wait<R - 1>();
        float* v = (tl & 1) ? buf1 : buf0;
        for (int i = 0; i < k; ++i) {
            const int j = p + i * P;
            float b, sk2;
            if (kProbe) {
                b = j < S ? -1.f - 0.01f * j : kNegInf;
                sk2 = (j & 1) && j + 2 < S ? 0.f : kNegInf;
            } else {
                b = j < S ? seed[(size_t)n * S + j] : kNegInf;
                sk2 = j + 2 < S ? skip[(size_t)n * S + j + 2] : kNegInf;
            }
            sk2s[j] = sk2;
            const float2 ea = inputs(tl, j);
            if (!kProbe && j < S) put_grad(tl, j, sg * expf(ea.y + b));
            v[j] = j < S ? b + ea.x : kNegInf;
        }
        if (p < 2) buf0[W + p] = buf1[W + p] = kNegInf;
    } else if (tl >= 1) {
        for (int j = p; j < S; j += P) de[(unsigned)(tl * S) + j] = seed[(size_t)n * S + j];
    }
    __syncthreads();
    long long c0 = 0;
    unsigned long long ns0 = 0;
    if (kProbe) {
        c0 = clock64();
        ns0 = global_ns();
    }

    // Iteration q: B[q] from row q + 1.
    auto step = [&](int q) {
        if (kInShared) {
            const float* vr = ((q + 1) & 1) ? buf1 : buf0;
            float* vq = (q & 1) ? buf1 : buf0;
            fetch(q - R + 1);  // into the slot of row q + 1, read in the step before
            cp_async_wait<R - 1>();
            // Two positions at a time (k is even), both read before either
            // is written.
            for (int i0 = 0; i0 < k; i0 += 2) {
                float b[2];
                float2 ea[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int j = p + (i0 + c) * P;
                    b[c] = lse3(vr[j], vr[j + 1], vr[j + 2] + sk2s[j]);
                    ea[c] = inputs(q, j);
                }
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int j = p + (i0 + c) * P;
                    if (!kProbe && j < S) put_grad(q, j, sg * expf(ea[c].y + b[c]));
                    vq[j] = j < S ? b[c] + ea[c].x : kNegInf;
                }
            }
        } else {
            const float* br = de + (unsigned)((q + 1) * S);
            const float* er = e_n + (unsigned)((q + 1) * S);
            for (int j = p; j < S; j += P) {
                const float v0 = br[j] + er[j];
                const float v1 = j + 1 < S ? br[j + 1] + er[j + 1] : kNegInf;
                const float v2 = j + 2 < S ? br[j + 2] + er[j + 2] : kNegInf;
                const float sk2 = j + 2 < S ? skip[(size_t)n * S + j + 2] : kNegInf;
                de[(unsigned)(q * S) + j] = lse3(v0, v1, v2 + sk2);
                if (q + 2 <= tl) {
                    const unsigned at = (unsigned)((q + 2) * S) + j;
                    de[at] = sg * expf(a_n[at] + de[at]);
                }
            }
        }
        __syncthreads();
    };
    for (int q = tl - 1; q >= 0; --q) step(q);

    if (kProbe) {
        const long long c1 = clock64();
        const unsigned long long ns1 = global_ns();
        if (p == 0) {
            probe[0] = c1 - c0;
            probe[1] = (long long)(ns1 - ns0);
        }
        if (buf0[p] == 12345.f) probe[2] = 1;  // keep the chain alive
        return;
    }
    if (!kInShared) {
        for (int j = p; j < S; j += P) {
            if (tl >= 1) {
                const unsigned at = (unsigned)S + j;
                de[at] = sg * expf(a_n[at] + de[at]);
            }
            const float b0 = tl >= 1 ? de[j] : seed[(size_t)n * S + j];
            dalpha0[(size_t)n * S + j] = sg * expf(a_n[j] + b0);
            de[j] = 0.f;
        }
    }
}

template <int kDesign, bool kProbe>
cudaError_t launch_wide(const float* emit, const float* skip, const float* alphas, const float* seed,
                        const float* sign, const int* lens, float* demit, float* dalpha0, int n,
                        int T, int S, long long* probe, size_t smem, size_t max_smem, int device,
                        cudaStream_t s) {
    static size_t asked[64];
    const auto kernel = ctc_beta_kernel_wide<kDesign, kProbe>;
    if (smem > 48 * 1024) {
        const cudaError_t err = ctc::allow_smem(kernel, max_smem, device, asked);
        if (err != cudaSuccess) return err;
    }
    kernel<<<n, ctc::wide_shape(S).P, smem, s>>>(emit, skip, alphas, seed, sign, lens, demit,
                                                  dalpha0, T, S, probe);
    return cudaGetLastError();
}

// The design ocrs_ctc_beta takes for S on `device` (ctc::Design), and its
// dynamic shared memory.
cudaError_t design_of(int device, int S, ctc::Design* design, size_t* smem, size_t* max_bytes) {
    const cudaError_t err = ctc::max_smem(device, max_bytes);
    if (err != cudaSuccess) return err;
    *design = ctc::wide_design(S, 2, *max_bytes, smem);
    return cudaSuccess;
}

template <bool kProbe>
cudaError_t launch(const float* emit, const float* skip, const float* alphas, const float* seed,
                   const float* sign, const int* lens, float* demit, float* dalpha0, int n, int T,
                   int S, long long* probe, int device, cudaStream_t s) {
    if (S > ctc::kMaxThreads) {
        ctc::Design design;
        size_t smem, max_bytes;
        const cudaError_t err = design_of(device, S, &design, &smem, &max_bytes);
        if (err != cudaSuccess) return err;
#define OCRS_CTC_BETA_WIDE(d)                                                                \
    launch_wide<d, kProbe>(emit, skip, alphas, seed, sign, lens, demit, dalpha0, n, T, S, probe, \
                           smem, max_bytes, device, s)
        if (design == ctc::kRing) return OCRS_CTC_BETA_WIDE(ctc::kRing);
        if constexpr (!kProbe) return OCRS_CTC_BETA_WIDE(ctc::kGlobal);
#undef OCRS_CTC_BETA_WIDE
        return cudaErrorInvalidValue;  // the probe with the state in device memory
    }
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
// `device`, whose stream is `stream`. T * S < 2^31 (32-bit offsets within
// a sample). Returns cudaGetLastError().
int ocrs_ctc_beta(int device, const float* emit, const float* skip, const float* alphas,
                  const float* seed, const float* sign, const int* lens, float* demit,
                  float* dalpha0, int n, int T, int S, void* stream) {
    if (S < 1 || T < 1 || (long long)T * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return (int)cudaGetLastError();
    return (int)launch<false>(emit, skip, alphas, seed, sign, lens, demit, dalpha0, n, T, S,
                              nullptr, device, (cudaStream_t)stream);
}

// The design ocrs_ctc_beta takes for S on CUDA device `device`
// (ctc_step.cuh): 0 one thread a position (S <= 1024); above, the state in
// shared memory with a ring of inputs (1), or in device memory (2).
// Negative: -(the CUDA error) where the card cannot be asked.
int ocrs_ctc_beta_design(int device, int S) {
    if (S < 1) return -(int)cudaErrorInvalidValue;
    ctc::Design design;
    size_t smem, max_bytes;
    const cudaError_t err = design_of(device, S, &design, &smem, &max_bytes);
    return err != cudaSuccess ? -(int)err : (int)design;
}

// The dependent chain alone: one sample of T steps and S positions runs the
// recursion on made-up emissions held in registers (or, above 1024
// positions, in the state's shared buffers), with no global access in the
// loop, in the design ocrs_ctc_beta picks for S, which must keep the state
// in shared memory. out[0]: cycles (clock64) of the T - 1 steps, out[1]:
// their nanoseconds (%globaltimer), out[2]: unused.
int ocrs_ctc_beta_probe(int device, int T, int S, long long* out, void* stream) {
    if (S < 1 || T < 1 || (long long)T * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             1, T, S, out, device, (cudaStream_t)stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
