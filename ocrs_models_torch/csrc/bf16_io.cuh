// Loads and stores of the element type a kernel reads and writes, float or
// __nv_bfloat16, as float32 in registers: the kernels template on the type
// and compute in f32 either way. A bf16 value widens to f32 exactly (its
// bits in the upper half); f32 narrows to bf16 by round-to-nearest-even,
// as XLA's convert does. The bf16 loads read the raw 16- or 32-bit words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace io {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float widen(uint16_t bits) { return __uint_as_float((uint32_t)bits << 16); }

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) {
    return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Streaming load (read once, evict first).
__device__ __forceinline__ float ldcs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ldcs(const bf16* p) {
    return widen(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// Elements p[0], p[1] (p aligned to two elements).
__device__ __forceinline__ float2 ldg2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Elements p[0..3] (p aligned to four elements).
__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// p[0] = x, p[1] = y (p aligned to two elements).
__device__ __forceinline__ void st2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace io
