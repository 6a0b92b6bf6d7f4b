// What the two persistent biGRU kernels (gru_fwd.cu, gru_bwd.cu's chain)
// share: the thread block cluster primitives, the cluster launch, and the
// choice of batch rows per block.
//
// Both kernels run one cluster of ceil(H / 32) blocks per (tile of R batch
// rows, direction). The card holds fewer clusters of 8 at once than its SM
// count suggests: on an H100 SXM (132 SMs) cudaOccupancyMaxActiveClusters
// reports 15, not 16, and a launch that needs more runs in rounds, each a
// full pass over the T steps. So R is chosen per call from the batch size
// and that report: N=128 takes R=20 (14 clusters, one round), not R=16 (16
// clusters, two rounds: twice the time, measured).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gru_cluster {

constexpr int kBU = 32;                // hidden units per block
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kRowChoices[] = {16, 20};
constexpr int kNumChoices = 2;

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
__device__ __forceinline__ uint32_t peer_address(const float* p, uint32_t rank) {
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

// A kernel templated on the batch rows per block R: its instance and its
// dynamic shared memory for each of kRowChoices, its block size, and where
// pick_rows keeps the runtime's reports for it (zero-initialised storage of
// its own: kernels of one family may hold other numbers of clusters than
// another's).
struct Family {
    const void* (*kernel)(int rows);
    size_t (*smem)(int rows, int n_tiles);
    int threads;
    int (*reported)[kMaxCluster + 1];  // [kNumChoices][kMaxCluster + 1]
};

inline bool shape_ok(int N, int H) {
    return H % 8 == 0 && H >= 8 && (H + kBU - 1) / kBU <= kMaxCluster && N >= 1;
}

// The launch of `f` with `rows` rows per block: grid (unit tiles, batch
// tiles, 2 directions), clusters of all unit tiles. `attr` must live as
// long as `cfg`.
inline cudaError_t configure(const Family& f, int rows, int N, int H, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
    if (!shape_ok(N, H)) return cudaErrorInvalidValue;
    const int n_tiles = (H + kBU - 1) / kBU;
    const size_t smem = f.smem(rows, n_tiles);
    cudaError_t err = cudaFuncSetAttribute(f.kernel(rows),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(n_tiles, (N + rows - 1) / rows, 2);
    cfg->blockDim = dim3(f.threads, 1, 1);
    cfg->dynamicSmemBytes = smem;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = n_tiles;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

// Rows per block for batch N: the choice with the least rounds * (fixed
// cost of a step + rows), where a step's fixed cost (barriers, gate math,
// exchange) weighs about as much as 14 rows of products (measured). The
// answer depends on the shape and the card only. *max_active gets the
// runtime's report for the chosen launch.
inline cudaError_t pick_rows(const Family& f, int N, int H, int* rows, int* max_active) {
    int (*reported)[kMaxCluster + 1] = f.reported;
    if (!shape_ok(N, H)) return cudaErrorInvalidValue;
    const int n_tiles = (H + kBU - 1) / kBU;
    long best = -1;
    for (int c = 0; c < kNumChoices; ++c) {
        const int r = kRowChoices[c];
        if (reported[c][n_tiles] == 0) {
            cudaLaunchConfig_t cfg;
            cudaLaunchAttribute attr;
            int n = 0;
            cudaError_t err = configure(f, r, N, H, &cfg, &attr);
            if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, f.kernel(r), &cfg);
            if (err != cudaSuccess) return err;
            if (n < 1) return cudaErrorLaunchOutOfResources;
            reported[c][n_tiles] = n;
        }
        const int cap = reported[c][n_tiles];
        const int clusters = 2 * ((N + r - 1) / r);
        const long cost = (long)((clusters + cap - 1) / cap) * (14 + r);
        if (best < 0 || cost < best) {
            best = cost;
            *rows = r;
            *max_active = reported[c][n_tiles];
        }
    }
    return cudaSuccess;
}

}  // namespace gru_cluster
