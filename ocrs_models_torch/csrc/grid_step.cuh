// The skeleton of the biGRU's grid forms (gru_grid.cu in bf16,
// gru_grid_f32.cu in f32): one cooperative launch a call over the whole
// card, a block per (direction, row tile, unit tile), and between steps a
// counter per (direction, row tile) in device memory.
//
// After its last write of a step a block adds 1 to its counter
// (`red.release.gpu`); a block reads the previous step's state once the
// counter shows every unit tile of its row tile done (`ld.acquire.gpu`; a
// counter that never arrives traps after about ten seconds instead of
// hanging). The counters are scratch of the call's own (torch.empty),
// zeroed by block 0 before one grid-wide sync at the start. The
// cooperative launch refuses a grid that the card cannot hold at once
// instead of hanging in a barrier.
//
// Also the mbarrier operations of the rings through which the streamed
// plans of both forms copy the part of W_hh a block does not keep.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace grid_step {

// Block 0 zeroes the `n` counters, then every block of the grid waits for
// it (the launch is cooperative).
template <int Threads>
__device__ __forceinline__ void zero_counters(unsigned* ctr, int n) {
    if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < n; i += Threads) ctr[i] = 0u;
    __syncthreads();
    cooperative_groups::this_grid().sync();
}

// This block's step is written: one more on its (direction, row tile)'s
// counter, after every thread's writes (release at GPU scope).
__device__ __forceinline__ void signal_step(unsigned* ctr) {
    __syncthreads();
    if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
}

// Wait until the counter reaches `target`, with the signalling blocks'
// writes visible to every thread of this block after it.
__device__ __forceinline__ void wait_steps(const unsigned* ctr, unsigned target) {
    if (threadIdx.x == 0) {
        const long long start = clock64();
        unsigned v;
        do {
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
            if (v < target && clock64() - start > (1ll << 34)) __trap();
        } while (v < target);
    }
    __syncthreads();
}

// mbarriers in shared memory (CTA scope).
__device__ __forceinline__ uint32_t bar_addr(const uint64_t* bar) {
    return (uint32_t)__cvta_generic_to_shared(bar);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar_addr(bar)), "r"(bytes) : "memory");
}

// Whether the phase of `bar` with parity `parity` has completed, without
// waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar_addr(bar)), "r"(parity) : "memory");
    return done != 0;
}

// Wait until the phase of `bar` with parity `parity` has completed (a
// phase that never completes traps after about ten seconds instead of
// hanging).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar_addr(bar)), "r"(parity) : "memory");
        if (!done && clock64() - start > (1ll << 34)) __trap();
    } while (!done);
}

// The block's place in the grid: blockIdx.x = (dir * RT + row tile) * UT +
// unit tile, U units x R rows a block.
struct Tile {
    int dir, rt, u0, n0, rows, UT, RT;
};

__device__ __forceinline__ Tile block_tile(int N, int H, int U, int R) {
    Tile t;
    t.UT = (H + U - 1) / U;
    t.RT = (N + R - 1) / R;
    int b = blockIdx.x;
    t.dir = b / (t.UT * t.RT);
    b %= t.UT * t.RT;
    t.rt = b / t.UT;
    t.u0 = (b % t.UT) * U;
    t.n0 = t.rt * R;
    t.rows = min(R, N - t.n0);
    return t;
}

// One cooperative launch of `kernel` with `blocks` blocks of Threads and
// `smem` bytes of dynamic shared memory. Refuses (with the error the launch
// would give) a grid that the card cannot hold at once.
template <int Threads, class Args>
int launch(const void* kernel, int device, Args args, int blocks, size_t smem, void* stream) {
    const RestoreDevice restore_device;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    int optin = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(Threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    void* kargs[] = {&args};
    err = cudaLaunchKernelExC(&cfg, kernel, kargs);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace grid_step
