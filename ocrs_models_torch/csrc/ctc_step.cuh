// What the CTC recursion kernels share: the log-space constants and sum,
// the asynchronous 4-byte copies that keep a step's inputs ahead of the
// recursion, and the timer the chain probe reads beside clock64.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ctc {

// "Minus infinity" of the log space: finite, so that 0 * state stays 0.
constexpr float kNegInf = -1e30f;

// A thread's inputs of a step are copied from device memory into a ring in
// shared memory this many steps ahead (cp.async: no register waits for
// them, so no step of the recursion waits for device memory). Each thread
// reads back only what it copied itself, after cp_async_wait, so the ring
// needs no barrier. 4-byte copies: a sample's base is not 16-byte aligned
// for odd S.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// log(exp(a) + exp(b) + exp(c)), the three terms added in this order, with
// the JAX package's `_lse3` guard: all terms at or below kNegInf give
// kNegInf, not NaN. expf/logf, no fast-math.
__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float m = fmaxf(fmaxf(a, b), c);
    const float ms = fmaxf(m, kNegInf);
    const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
    return m <= kNegInf ? kNegInf : out;
}

// Nanoseconds of the device's global timer (32 ns steps on an H100).
__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// ---- Wide samples (S > 1024): a block of at most 1024 threads.
//
// Thread p owns an even number k of positions, p, p + P, ..., p + (k-1) P,
// the fewest that 1024 threads hold (k = 2 ceil(S / 2048)), and P is the
// fewest whole warps that hold S in k rows of positions: each row of a
// step's loads, copies and stores is one coalesced access, and a thread
// takes its positions two at a time, both read before either is written,
// so that their sums overlap. The block's W = k * P lanes cover S; lanes
// at or past S compute on padding, are never stored, and are read only by
// lanes at or past S.
constexpr int kMaxThreads = 1024;
constexpr int kWideRing = 4;  // rows of inputs a wide block copies ahead (a power of two)

struct Wide {
    int k, P, W;
};

__host__ __device__ inline Wide wide_shape(int S) {
    const int k = 2 * ((S + 2 * kMaxThreads - 1) / (2 * kMaxThreads));
    const int P = ((S + k - 1) / k + 31) / 32 * 32;
    return {k, P, k * P};
}

// Where a block keeps a sample's state. kPerPosition: one thread a position
// (S <= 1024), as designed in ctc_alpha.cu and ctc_beta.cu. Above: kRing,
// in shared memory, two state buffers of W + 2 lanes, W skip terms and a
// ring of kWideRing rows of inputs copied ahead, while that fits the card's
// opt-in limit (some 8 k positions for alpha, 5 k for beta on an H100);
// past it kGlobal, the state in the output's own rows in device memory
// (inside one block __syncthreads orders device memory as it does shared
// memory).
enum Design { kPerPosition = 0, kRing = 1, kGlobal = 2 };

// The design for S, and the dynamic shared memory it takes in `bytes`.
// `ring_floats`: floats a lane of one ring row holds (1 for alpha's
// emission, 2 for beta's emission and saved alpha).
inline Design wide_design(int S, int ring_floats, size_t max_bytes, size_t* bytes) {
    *bytes = 0;
    if (S <= kMaxThreads) return kPerPosition;
    const Wide w = wide_shape(S);
    const size_t base = sizeof(float) * (3 * (size_t)w.W + 4);
    const size_t ring = sizeof(float) * (size_t)kWideRing * ring_floats * w.W;
    if (base + ring > max_bytes) return kGlobal;
    *bytes = base + ring;
    return kRing;
}

// The card's limit on a block's dynamic shared memory, once asked for.
inline cudaError_t max_smem(int device, size_t* bytes) {
    int v = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    *bytes = (size_t)v;
    return err;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory on `device`
// (the current one) where that is above the 48 KB a launch gets without
// asking. `asked`: what was asked so far, per device, for this kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, size_t* asked) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    const bool known = device >= 0 && device < 64;
    if (known && asked[device] >= bytes) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && known) asked[device] = bytes;
    return err;
}

}  // namespace ctc
