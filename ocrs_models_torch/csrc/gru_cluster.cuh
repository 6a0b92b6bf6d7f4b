// What the persistent biGRU kernels (gru_fwd.cu, gru_bwd.cu's chain, and
// gru_wide.cu's persistent forward and chain) share: the thread block
// cluster primitives, the cluster launch, and the choice of batch rows per
// block (the bf16 tensor-core helpers come from mma_bf16.cuh).
//
// Every such kernel runs one cluster of ceil(H / 32) blocks per (tile of R
// batch rows, direction). A family of kernels has its own largest cluster:
// 8 blocks (the portable limit) for gru_fwd.cu and gru_bwd.cu, which take
// H <= 256; 16 (non-portable, allowed per kernel at launch) for
// gru_wide.cu's, which take H <= 512. The card holds fewer clusters at once
// than its SM count suggests: on an H100 SXM (132 SMs)
// cudaOccupancyMaxActiveClusters reports 15 clusters of 8, not 16, and a
// launch that needs more runs in rounds, each a full pass over the T
// steps. So R is chosen per call from the batch size and that report, with
// a cost model of each kernel family's own: the f32 kernels take R=20 at
// N=128 (14 clusters, one round), not R=16 (16 clusters, two rounds: twice
// the time, measured).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace gru_cluster {

using namespace tc;

constexpr int kBU = 32;                // hidden units per block
constexpr int kMaxCluster = 8;         // portable cluster size (gru_fwd.cu, gru_bwd.cu)
constexpr int kMaxWideCluster = 16;    // non-portable cluster size (gru_wide.cu)
constexpr int kMaxChoices = 4;         // most row choices a family offers
// Dynamic shared memory the bf16 kernels ask for at least: more than half
// of an SM's 227 KB, so that two blocks never share an SM (a block whose
// own needs are small would otherwise let the runtime stack clusters on
// the same SMs, and the rounds that pick_rows counts would mean nothing).
constexpr size_t kSoleBlockSmem = 120 * 1024;

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
    return r;
}

// One barrier across the cluster, split so that work can go between the
// two halves. Writes into a peer's shared memory made before `arrive` are
// visible to the peer after its `wait`.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address `p` of this block's shared memory, in block `rank`'s.
__device__ __forceinline__ uint32_t peer_address(const void* p, uint32_t rank) {
    const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

__device__ __forceinline__ void st_peer_f1(const float* p, uint32_t rank, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;"
                 :: "r"(peer_address(p, rank)), "f"(v) : "memory");
}

__device__ __forceinline__ void st_peer_f2(const float* p, uint32_t rank, float x, float y) {
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
                 :: "r"(peer_address(p, rank)), "f"(x), "f"(y) : "memory");
}

// ---------------------------------------------------------------------
// mbarriers and bulk copies between the blocks of a cluster (the bf16
// kernels' exchange): a block writes what a peer needs into its own shared
// memory, one thread copies it with `cp.async.bulk` into the peer's, and
// the copy's bytes complete a phase of the peer's mbarrier, on which the
// peer waits. No cluster barrier in the step.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// Makes the mbarrier inits visible to the cluster (a cluster barrier follows).
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This thread's arrival on `bar`, which then also waits for `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// Orders this thread's shared-memory writes before later bulk copies of them.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from `src` in this block's shared memory to
// the address of `dst` in block `rank`'s, completing on that block's
// mbarrier at the address of `bar`.
__device__ __forceinline__ void bulk_to_peer(const void* dst, const void* src, uint32_t bytes,
                                             const uint64_t* bar, uint32_t rank) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(peer_address(dst, rank)), "r"(smem_u32(src)), "r"(bytes),
           "r"(peer_address(bar, rank))
        : "memory");
}

// A kernel templated on the batch rows per block R: its instance, dynamic
// shared memory and block size for each of its row choices, the choices,
// the fixed cost of a step in rows for pick_rows, its largest cluster, and
// where pick_rows keeps the runtime's reports for it (zero-initialised
// storage of its own, [kMaxChoices][max_cluster + 1]: kernels of one family
// may hold other numbers of clusters than another's).
struct Family {
    const void* (*kernel)(int rows);
    size_t (*smem)(int rows, int n_tiles);
    int (*threads)(int rows);
    const int* row_choices;
    int n_choices;
    int step_cost;
    int max_cluster;
    int* reported;
};

inline bool shape_ok(const Family& f, int N, int H) {
    return H % 8 == 0 && H >= 8 && (H + kBU - 1) / kBU <= f.max_cluster && N >= 1;
}

// The launch of `f` with `rows` rows per block: grid (unit tiles, batch
// tiles, 2 directions), clusters of all unit tiles. `attr` must live as
// long as `cfg`.
inline cudaError_t configure(const Family& f, int rows, int N, int H, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
    if (!shape_ok(f, N, H)) return cudaErrorInvalidValue;
    const int n_tiles = (H + kBU - 1) / kBU;
    const size_t smem = f.smem(rows, n_tiles);
    cudaError_t err = cudaFuncSetAttribute(f.kernel(rows),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && n_tiles > kMaxCluster)
        err = cudaFuncSetAttribute(f.kernel(rows),
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(n_tiles, (N + rows - 1) / rows, 2);
    cfg->blockDim = dim3(f.threads(rows), 1, 1);
    cfg->dynamicSmemBytes = smem;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = n_tiles;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

inline bool offers(const Family& f, int rows) {
    for (int c = 0; c < f.n_choices; ++c)
        if (f.row_choices[c] == rows) return true;
    return false;
}

// Rows per block for batch N: the choice with the least rounds * (fixed
// cost of a step + rows), where the fixed cost of a step (barriers, gate
// math, exchange) is the family's `step_cost`, in rows of products
// (measured for each family). The answer depends on the shape and the card
// only. *max_active gets the runtime's report for the chosen launch.
inline cudaError_t pick_rows(const Family& f, int N, int H, int* rows, int* max_active) {
    if (!shape_ok(f, N, H)) return cudaErrorInvalidValue;
    const int n_tiles = (H + kBU - 1) / kBU;
    long best = -1;
    for (int c = 0; c < f.n_choices; ++c) {
        const int r = f.row_choices[c];
        int& cached = f.reported[c * (f.max_cluster + 1) + n_tiles];
        if (cached == 0) {
            cudaLaunchConfig_t cfg;
            cudaLaunchAttribute attr;
            int n = 0;
            cudaError_t err = configure(f, r, N, H, &cfg, &attr);
            if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, f.kernel(r), &cfg);
            if (err != cudaSuccess) return err;
            if (n < 1) return cudaErrorLaunchOutOfResources;
            cached = n;
        }
        const int cap = cached;
        const int clusters = 2 * ((N + r - 1) / r);
        const long cost = (long)((clusters + cap - 1) / cap) * (f.step_cost + r);
        if (best < 0 || cost < best) {
            best = cost;
            *rows = r;
            *max_active = cap;
        }
    }
    return cudaSuccess;
}

}  // namespace gru_cluster
