// The bf16 tensor-core helpers the kernels share: fragment packing, shared
// memory addresses, ldmatrix and mma.sync m16n8k16 (bf16 operands, f32
// accumulation), and the cp.async copies that stage their operands.
// Included by the biGRU kernels (through gru_cluster.cuh) and the stage-1
// kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// bf16 tensor-core fragments (mma.sync m16n8k16, f32 accumulation). With
// gid = lane / 4 and tig = lane % 4 a thread holds, as pairs of bf16 in one
// 32-bit register (the lower k or column in the lower half):
//   A [16 x 16]: a0 (gid, 2tig..), a1 (gid+8, 2tig..), a2 (gid, 2tig+8..),
//                a3 (gid+8, 2tig+8..)  (row, k);
//   B [16 x 8]:  b0 (2tig.., gid), b1 (2tig+8.., gid)  (k, column);
//   C [16 x 8]:  c0, c1 (gid, 2tig and 2tig+1), c2, c3 (gid+8, the same).

// The bf16 values nearest to lo and hi as one register, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i gets matrix i in the A/B layout
// above (`trans`: each matrix transposed, for operands whose contraction
// runs along memory rows).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b, one warp.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copies global -> shared of 4 or 16 bytes: the bytes past
// `src_bytes` (0 for a copy wholly outside the source) are written as zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace tc
