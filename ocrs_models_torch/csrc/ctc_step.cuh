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

}  // namespace ctc
