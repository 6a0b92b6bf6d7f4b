// CTC forward (alpha) recursion in log space, in float32.
//
// Replaces: the Pallas kernel `ctc_kernel._alpha_call` in
// ocrs_models_tpu/ops/pallas/ctc_kernel.py (body `_alpha_kernel`). Same
// recursion over the S = 2L+1 extended-label positions:
//   alpha[t, p] = lse(alpha[t-1, p], alpha[t-1, p-1],
//                     alpha[t-1, p-2] + skip[p]) + emit[t, p]
// for 1 <= t < input_len; later steps are frozen (alpha[t] = alpha[t-1]),
// and a length of 0 acts as 1. The Pallas design read a precomputed
// [T, N, S] additive gate for that; this kernel compares t with the
// sample's length. alpha[0] = alpha0. NEG_INF is -1e30 with the JAX
// package's `_lse3` guard (ctc_step.cuh), so unreachable states stay
// finite. Out: all T states, or only alpha[T-1] (`final_only`, the
// no-gradient path).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32). At N=128,
// T=257, S=129: emit read once (17.0 MB) and the states written once
// (17.0 MB): 34 MB, 10 us; about 14 operations per state, 0.9 us. No
// recursion of T-1 dependent steps reaches that: a step is a shared-memory
// round trip, a barrier and an lse3 (three expf, one logf), some 230-290
// cycles, so T-1 steps take 30-40 us. The chain, not the bytes, is what
// this kernel can be held to; `ocrs_ctc_alpha_probe` measures it.
//
// Design: nothing but the chain is on the chain, as in ctc_beta.cu.
// - One block per sample, thread p owns position p, and a step starts with
//   what the other threads wait for: the thread publishes its state
//   alpha[t-1, p] in shared memory (double-buffered, two leading NEG_INF
//   lanes, so the reads of p-1 and p-2 need no branch), one __syncthreads,
//   and reads p-1 and p-2. The sum is the plain version's, in its order,
//   so the result is the plain version's bit for bit. A sample of S <= 32
//   is one warp: neighbours by __shfl_up_sync, no shared state, no block
//   barrier.
// - No global load is waited for inside a step: a thread copies its
//   emission of a row into a ring in shared memory 8 steps ahead (cp.async,
//   4 bytes: a sample's base is not 16-byte aligned for odd S; 4 steps
//   ahead above S = 512) and waits only for its own copy of the row it
//   needs next. Each thread reads only what it copied, so the ring needs no
//   barrier.
// - The states are stored off the chain: the state published at step t is
//   stored as row t-1 after the barrier, and nothing waits for the store.
// - Frozen steps are skipped: the loop runs t = 1 .. len-1 only, then each
//   thread writes its final state into rows len-1 .. T-1 (one row for
//   `final_only`). Rows above len-1 are never copied into the ring.
// - The loop has no branch: threads beyond S copy and compute like the
//   others on the inputs of position S-1 and store nothing (their lanes are
//   read only by threads beyond S, since reads go to p-1 and p-2). It is
//   unrolled by two so that the two state buffers are fixed addresses.
// - Above S = 1024 a block holds 1024 threads at most, so a thread owns
//   an even k = 2 ceil(S / 2048) positions and the state lives in shared
//   memory (or, past what a block's shared memory holds, in `out`):
//   ctc_alpha_kernel_wide. The Pallas kernel takes any S; so does this one,
//   up to the 32-bit offsets' T * S < 2^31.
// What holds it on an H100 SXM: the chain, some 80% of its time at T=257;
// then the per-step store and the ring's copy, wait and shared load (a
// build without either one ran some 13% faster; neither can go). Measured
// and lost (PERF.md): the emission loaded into a register one step ahead
// (the step waits for it whenever the row is not in L2), the store after
// the lse3 instead of after the barrier, a ring of 16 rows (4 did as well
// as 8).
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
// else through shared memory. kRing: rows of emissions in flight or landed
// in the ring (a power of two). kFinal: only alpha[T-1] is stored. kProbe:
// the chain alone, on made-up emissions in registers, timed by the block's
// own clocks (no global access in the loop).
template <bool kWarp, int kRing, bool kFinal, bool kProbe>
__global__ void ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                 const float* __restrict__ alpha0, const int* __restrict__ lens,
                                 float* __restrict__ out, int T, int S,
                                 long long* __restrict__ probe) {
    static_assert((kRing & (kRing - 1)) == 0, "kRing is a power of two");
    // Shared floats: [!kWarp: two state buffers of blockDim.x + 2] [the
    // ring: kRing x blockDim.x emissions].
    extern __shared__ float st[];
    const int n = blockIdx.x;
    const int p = threadIdx.x;
    const int P = blockDim.x;
    const bool act = p < S;
    const int q = min(p, S - 1);  // the position whose inputs this thread reads
    const float* e_col = emit + (size_t)n * T * S + q;
    float* o = out + (size_t)n * (kFinal ? 1 : T) * S + p;
    float* v_odd = st + p;            // the state buffer of steps 1, 3, 5, ...
    float* v_even = v_odd + (P + 2);  // ... and of steps 2, 4, 6, ...
    float* ring = st + (kWarp ? 0 : 2 * (P + 2)) + p;
    const int len = kProbe ? T : lens[n];
    const int tl = min(max(len, 1), T) - 1;  // the last active step

    // This thread's emission of `row` into the ring, one group per row. A
    // row above tl copies nothing: the group is empty.
    auto fetch = [&](int row) {
        if (!kProbe && row <= tl)
            ctc::cp_async4(ring + (row & (kRing - 1)) * P, e_col + (unsigned)(row * S));
        ctc::cp_async_commit();
    };
    // ... and back out of it, once `row` is the oldest group in flight.
    auto landed = [&](int row) {
        ctc::cp_async_wait<kRing - 1>();
        if (kProbe) return -3.f - 0.1f * (row & 3);
        return ring[(row & (kRing - 1)) * P];
    };

#pragma unroll
    for (int d = 1; d <= kRing; ++d) fetch(d);
    float a, sk;
    if (kProbe) {
        a = p < 2 ? -1.f - 0.5f * p : kNegInf;
        sk = (p & 1) && p >= 3 ? 0.f : kNegInf;
    } else {
        a = act ? alpha0[(size_t)n * S + p] : kNegInf;
        sk = skip[(size_t)n * S + q];
    }
    if (!kWarp && p < 2) v_odd[0] = v_even[0] = kNegInf;
    float e_t = landed(1);
    long long c0 = 0;
    unsigned long long ns0 = 0;
    if (kProbe) {
        __syncthreads();
        c0 = clock64();
        ns0 = ctc::global_ns();
    }

    // Step t holds alpha[t-1] in `a` and emit[t] in `e_t`, and makes
    // alpha[t]. The order within it: what the other threads wait for first
    // (publish, barrier, read), then the store, copy and load nothing waits
    // for, then the arithmetic, which the compiler interleaves.
    auto step = [&](int t, float* vb) {
        float a1, a2;
        if (kWarp) {
            const float n1 = __shfl_up_sync(0xffffffffu, a, 1);
            const float n2 = __shfl_up_sync(0xffffffffu, a, 2);
            a1 = p >= 1 ? n1 : kNegInf;
            a2 = p >= 2 ? n2 : kNegInf;
        } else {
            vb[2] = a;
            __syncthreads();
            a1 = vb[1];
            a2 = vb[0];
        }
        if (!kFinal && !kProbe && act) o[(unsigned)((t - 1) * S)] = a;
        fetch(t + kRing);  // into the slot of row t, whose emission is in e_t
        const float e_next = landed(t + 1);
        a = ctc::lse3(a, a1, a2 + sk) + e_t;
        e_t = e_next;
    };
    int t = 1;
    for (; t < tl; t += 2) {
        step(t, v_odd);
        step(t + 1, v_even);
    }
    if (t == tl) step(t, v_odd);

    if (kProbe) {
        __syncthreads();
        const long long c1 = clock64();
        const unsigned long long ns1 = ctc::global_ns();
        if (p == 0) {
            probe[0] = c1 - c0;
            probe[1] = (long long)(ns1 - ns0);
        }
        if (a == 12345.f) probe[2] = 1;  // keep the chain alive: its result decides a store
        return;
    }
    // Here a is alpha[tl]: it is also every frozen row's value.
    if (act) {
        if (kFinal) {
            o[0] = a;
        } else {
            for (int r = tl; r < T; ++r) o[(unsigned)(r * S)] = a;
        }
    }
}

// S > 1024 (ctc_step.cuh, "Wide samples"): thread p owns the k positions
// j = p + i P. The state lives in a buffer, not in registers: step t reads
// alpha[t-1] at j, j-1 and j-2 from one buffer and writes alpha[t] into the
// other, then one __syncthreads; the buffers alternate, so a step needs one
// barrier, as above. In kRing the buffers are shared memory with two
// leading NEG_INF lanes, the skip terms sit beside them, and each thread
// copies its emissions of a row into a ring kWideRing - 1 steps ahead (one
// cp.async group a row, k copies in it; a slot is refilled at the start of
// the step after its row was read, past the barrier that ends that read).
// In kGlobal the buffers are rows t-1 and t
// of `out` itself (all T rows stored, so no final_only), and a step reads
// its emissions and skip terms from device memory. Each sum is the plain
// version's, in its order, so the results stay its bit for bit. Frozen
// steps are skipped as above: the final state fills rows tl+1 .. T-1.
template <int kDesign, bool kFinal, bool kProbe>
__global__ void __launch_bounds__(ctc::kMaxThreads)
    ctc_alpha_kernel_wide(const float* __restrict__ emit, const float* __restrict__ skip,
                          const float* __restrict__ alpha0, const int* __restrict__ lens, float* out,
                          int T, int S, long long* __restrict__ probe) {
    using namespace ctc;
    static_assert(kDesign != kGlobal || (!kFinal && !kProbe), "kGlobal keeps every row");
    constexpr bool kInShared = kDesign == kRing;
    constexpr int R = kWideRing;
    extern __shared__ float st[];
    const Wide w = wide_shape(S);
    const int k = w.k, P = blockDim.x, W = w.W;
    const int n = blockIdx.x, p = threadIdx.x;
    // Shared floats: [state buffer 0: W + 2][buffer 1: W + 2][skip: W][ring: R x W].
    float* const buf0 = st;
    float* const buf1 = st + (W + 2);
    float* const sks = st + 2 * (W + 2);
    float* const ring = sks + W;
    const float* e_n = emit + (size_t)n * T * S;
    float* o = out + (size_t)n * (kFinal ? 1 : T) * S;
    const int len = kProbe ? T : lens[n];
    const int tl = min(max(len, 1), T) - 1;  // the last active step

    // This thread's emissions of `row` into the ring, one group per row.
    auto fetch = [&](int row) {
        if (!kInShared) return;
        if (!kProbe && row <= tl)
            for (int i = 0; i < k; ++i) {
                const int j = p + i * P;
                cp_async4(ring + (row & (R - 1)) * W + j, e_n + (unsigned)(row * S) + min(j, S - 1));
            }
        cp_async_commit();
    };
    for (int d = 1; d < R; ++d) fetch(d);
    if (kInShared) {
        for (int i = 0; i < k; ++i) {
            const int j = p + i * P;
            float a, sk;
            if (kProbe) {
                a = j < 2 ? -1.f - 0.5f * j : kNegInf;
                sk = (j & 1) && j >= 3 ? 0.f : kNegInf;
            } else {
                a = j < S ? alpha0[(size_t)n * S + j] : kNegInf;
                sk = skip[(size_t)n * S + min(j, S - 1)];
            }
            buf0[j + 2] = a;
            sks[j] = sk;
            if (!kFinal && !kProbe && j < S) o[j] = a;
        }
        if (p < 2) buf0[p] = buf1[p] = kNegInf;
    } else {
        for (int j = p; j < S; j += P) o[j] = alpha0[(size_t)n * S + j];
    }
    __syncthreads();
    long long c0 = 0;
    unsigned long long ns0 = 0;
    if (kProbe) {
        c0 = clock64();
        ns0 = global_ns();
    }

    // Step t: alpha[t-1] in `prev`, alpha[t] into `next`.
    auto step = [&](int t, const float* prev, float* next) {
        if (kInShared) {
            fetch(t + R - 1);  // into the slot of row t-1, read in the step before
            cp_async_wait<R - 1>();
            const float* er = ring + (t & (R - 1)) * W;
            // Two positions at a time (k is even), both read before either
            // is written: their sums overlap (the compiler cannot tell
            // `prev` from `next`).
            for (int i0 = 0; i0 < k; i0 += 2) {
                float v[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int j = p + (i0 + c) * P;
                    const float e = kProbe ? -3.f - 0.1f * (t & 3) : er[j];
                    v[c] = lse3(prev[j + 2], prev[j + 1], prev[j] + sks[j]) + e;
                }
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int j = p + (i0 + c) * P;
                    next[j + 2] = v[c];
                    if (!kFinal && !kProbe && j < S) o[(unsigned)(t * S) + j] = v[c];
                }
            }
        } else {
            const float* a_prev = o + (unsigned)((t - 1) * S);
            float* a_next = o + (unsigned)(t * S);
            for (int j = p; j < S; j += P) {
                const float a1 = j >= 1 ? a_prev[j - 1] : kNegInf;
                const float a2 = j >= 2 ? a_prev[j - 2] : kNegInf;
                a_next[j] = lse3(a_prev[j], a1, a2 + skip[(size_t)n * S + j]) +
                            e_n[(unsigned)(t * S) + j];
            }
        }
        __syncthreads();
    };
    int t = 1;
    for (; t < tl; t += 2) {
        step(t, buf0, buf1);
        step(t + 1, buf1, buf0);
    }
    if (t == tl) step(t, buf0, buf1);
    const float* fin = (tl & 1) ? buf1 : buf0;

    if (kProbe) {
        const long long c1 = clock64();
        const unsigned long long ns1 = global_ns();
        if (p == 0) {
            probe[0] = c1 - c0;
            probe[1] = (long long)(ns1 - ns0);
        }
        if (fin[p + 2] == 12345.f) probe[2] = 1;  // keep the chain alive
        return;
    }
    // Each thread fills its own positions of the frozen rows.
    if (kInShared) {
        for (int i = 0; i < k; ++i) {
            const int j = p + i * P;
            if (j >= S) break;
            const float a = fin[j + 2];
            if (kFinal) {
                o[j] = a;
            } else {
                for (int r = tl + 1; r < T; ++r) o[(unsigned)(r * S) + j] = a;
            }
        }
    } else {
        for (int j = p; j < S; j += P) {
            const float a = o[(unsigned)(tl * S) + j];
            for (int r = tl + 1; r < T; ++r) o[(unsigned)(r * S) + j] = a;
        }
    }
}

template <int kDesign, bool kFinal, bool kProbe>
cudaError_t launch_wide(const float* emit, const float* skip, const float* alpha0, const int* lens,
                        float* out, int n, int T, int S, long long* probe, size_t smem,
                        size_t max_smem, int device, cudaStream_t s) {
    static size_t asked[64];
    const auto kernel = ctc_alpha_kernel_wide<kDesign, kFinal, kProbe>;
    if (smem > 48 * 1024) {
        const cudaError_t err = ctc::allow_smem(kernel, max_smem, device, asked);
        if (err != cudaSuccess) return err;
    }
    kernel<<<n, ctc::wide_shape(S).P, smem, s>>>(emit, skip, alpha0, lens, out, T, S, probe);
    return cudaGetLastError();
}

// The design ocrs_ctc_alpha takes for S on `device` (ctc::Design), and its
// dynamic shared memory.
cudaError_t design_of(int device, int S, ctc::Design* design, size_t* smem, size_t* max_bytes) {
    const cudaError_t err = ctc::max_smem(device, max_bytes);
    if (err != cudaSuccess) return err;
    *design = ctc::wide_design(S, 1, *max_bytes, smem);
    return cudaSuccess;
}

template <bool kFinal, bool kProbe>
cudaError_t launch(const float* emit, const float* skip, const float* alpha0, const int* lens,
                   float* out, int n, int T, int S, long long* probe, int device, cudaStream_t s) {
    if (S > ctc::kMaxThreads) {
        ctc::Design design;
        size_t smem, max_bytes;
        const cudaError_t err = design_of(device, S, &design, &smem, &max_bytes);
        if (err != cudaSuccess) return err;
#define OCRS_CTC_ALPHA_WIDE(d)                                                             \
    launch_wide<d, kFinal, kProbe>(emit, skip, alpha0, lens, out, n, T, S, probe, smem,   \
                                   max_bytes, device, s)
        if (design == ctc::kRing) return OCRS_CTC_ALPHA_WIDE(ctc::kRing);
        if constexpr (!kFinal && !kProbe) return OCRS_CTC_ALPHA_WIDE(ctc::kGlobal);
#undef OCRS_CTC_ALPHA_WIDE
        return cudaErrorInvalidValue;  // final_only or the probe with the state in device memory
    }
    const int P = (S + 31) / 32 * 32;
#define OCRS_CTC_ALPHA(warp, ring, floats)                                                   \
    ctc_alpha_kernel<warp, ring, kFinal, kProbe><<<n, P, sizeof(float) * (floats), s>>>(   \
        emit, skip, alpha0, lens, out, T, S, probe)
    if (S <= kWarpMaxS)
        OCRS_CTC_ALPHA(true, kDeep, kDeep * P);
    else if (S <= 512)
        OCRS_CTC_ALPHA(false, kDeep, 2 * (P + 2) + kDeep * P);
    else
        OCRS_CTC_ALPHA(false, kShallow, 2 * (P + 2) + kShallow * P);
#undef OCRS_CTC_ALPHA
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// emit [n, T, S], skip [n, S] (0 or -1e30), alpha0 [n, S], lens [n] int32;
// out [n, T, S], or [n, 1, S] when final_only. All contiguous, on CUDA
// device `device`, whose stream is `stream`. T * S < 2^31 (32-bit offsets
// within a sample); final_only needs the state in shared memory
// (ocrs_ctc_alpha_design below 2): above, ask for every row. Returns
// cudaGetLastError().
int ocrs_ctc_alpha(int device, const float* emit, const float* skip, const float* alpha0,
                   const int* lens, float* out, int n, int T, int S, int final_only,
                   void* stream) {
    if (S < 1 || T < 1 || (long long)T * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return (int)cudaGetLastError();
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)(final_only
                     ? launch<true, false>(emit, skip, alpha0, lens, out, n, T, S, nullptr, device, s)
                     : launch<false, false>(emit, skip, alpha0, lens, out, n, T, S, nullptr, device,
                                            s));
}

// The design ocrs_ctc_alpha takes for S on CUDA device `device`
// (ctc_step.cuh): 0 one thread a position (S <= 1024); above, the state in
// shared memory with a ring of emissions (1), or in device memory (2).
// Negative: -(the CUDA error) where the card cannot be asked.
int ocrs_ctc_alpha_design(int device, int S) {
    if (S < 1) return -(int)cudaErrorInvalidValue;
    ctc::Design design;
    size_t smem, max_bytes;
    const cudaError_t err = design_of(device, S, &design, &smem, &max_bytes);
    return err != cudaSuccess ? -(int)err : (int)design;
}

// The dependent chain alone: one sample of T steps and S positions runs the
// recursion on made-up emissions held in registers (or, above 1024
// positions, in the state's shared buffers), with no global access in the
// loop, in the design ocrs_ctc_alpha picks for S, which must keep the state
// in shared memory. out[0]: cycles (clock64) of the T - 1 steps, out[1]:
// their nanoseconds (%globaltimer), out[2]: unused.
int ocrs_ctc_alpha_probe(int device, int T, int S, long long* out, void* stream) {
    if (S < 1 || T < 1 || (long long)T * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const RestoreDevice restore_device;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<false, true>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, T, S, out,
                                    device, (cudaStream_t)stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
