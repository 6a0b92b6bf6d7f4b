// Bidirectional GRU recurrence of one layer, backward, in float32.
//
// Replaces: the backward of the Pallas kernel `gru_recurrence4` in
// ocrs_models_tpu/ops/pallas/gru_kernel4.py (`_bwd_call`, body
// `_bwd_kernel`). Same math: both directions' reverse scans in one pass
// (the forward direction walks time backwards, the backward direction
// forwards); at each step h_prev in scan order (ys_f[t-1] or ys_b[t+1],
// zero at each direction's first step), ph = h_prev @ W_hh + b_hh and the
// gates are recomputed, and
//   dht = dh + dy[t];  dc = dht (1 - z);  da_c = dc (1 - c^2);
//   da_z = dht (h_prev - c) z (1 - z);  dhn = da_c r;
//   da_r = da_c hn r (1 - r);
//   dpx[t] = [da_r, da_z, da_c];  dph = [da_r, da_z, dhn];
//   dh <- dht z + dph @ W_hh^T;  dW_hh += h_prev^T dph;  db_hh += sum dph.
// Contract: px_f, px_b [T, N, 3H] (x @ W_ih + b_ih, natural time order),
// ys_f, ys_b [T, N, H] the forward's outputs, dy_f, dy_b [T, N, H] their
// cotangents; w_hh [2, H, 3H] (for h @ W), b_hh [2, 3H]; out dpx_f, dpx_b
// [T, N, 3H], dw [2, H, 3H], db [2, 3H]. Gate order r, z, n.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At T=257, N=128, H=256, per step and direction the
// function multiplies [N,H] x [H,3H] (the recomputed ph) and [N,3H] x
// [3H,H] (dh), and dW_hh is [H, T*N] x [T*N, 3H]: 3 * 2*128*256*768 FLOP
// * 257 steps * 2 directions = 77.6 GFLOP, 1.16 ms at the f32 rate. The
// bytes are px, ys, dy read once and dpx written once: 2 * (101 + 33.7 +
// 33.7 + 101) MB = 539 MB, 0.16 ms. Operations bound it; besides, two
// of the three products form a chain of T dependent steps.
//
// Design: per step two launches, in stream order, each with the forward
// kernel's tiling (a block owns 32 hidden units x 16 batch rows of one
// direction; 2 x 2 register tiles; the k range split over two thread
// groups). (a) `gates` stages its W_hh columns (96 KB) and 16 rows of
// h_prev, recomputes its units' r, z and n pre-activations, finishes the
// gate math, and writes dpx[t], dph (into a [2, T, N, 3H] buffer) and
// dht * z. (b) `dh` stages its units' rows of W_hh^T (96 KB, from a
// transposed copy) and the 16 rows of dph across all 3H columns (48 KB)
// and writes the new dh = dht z + dph @ W_hh^T. dh ping-pongs between two
// buffers in device memory. After the loop, (c) `dw` reduces
// h_prev^T dph over all T*N rows: a 32 x 64 output tile per block, 16-row
// stages in shared memory, 4 x 4 register tiles; the blocks of the first
// row tile also sum dph's columns into db. Every sum runs in a fixed
// order, so repeated runs agree bit for bit. Keeping W_hh on chip across
// steps and wgmma are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBU = 32;                // hidden units per block
constexpr int kBN = 16;                // batch rows per block
constexpr int kTU = kBU / 2;           // thread columns: 2 units each
constexpr int kTR = kBN / 2;           // thread rows: 2 batch rows each
constexpr int kKSplit = 2;             // k range split across thread groups
constexpr int kThreads = kTU * kTR * kKSplit;  // 256
constexpr int kMaxSmem = 232448;       // per block on an H100

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ constexpr int pad_stride(int k) { return k + 4; }  // keeps float4 alignment

size_t gates_smem(int H) {
    return sizeof(float) * ((size_t)H * 3 * kBU + (size_t)kBN * pad_stride(H) + kBN * 3 * kBU);
}

size_t dh_smem(int H) {
    return sizeof(float) * ((size_t)3 * H * kBU + (size_t)kBN * pad_stride(3 * H) + kBN * kBU);
}

// (a) Recompute the gates at step `step` and write dpx[t], dph[dir][t] and
// dhz = dht * z. Requires H % 8 == 0.
__global__ void __launch_bounds__(kThreads)
gru_bwd_gates_kernel(const float* __restrict__ px_f, const float* __restrict__ px_b,
                     const float* __restrict__ ys_f, const float* __restrict__ ys_b,
                     const float* __restrict__ dy_f, const float* __restrict__ dy_b,
                     const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                     float* __restrict__ dpx_f, float* __restrict__ dpx_b,
                     float* __restrict__ dph, const float* __restrict__ dh_in,
                     float* __restrict__ dhz, int step, int T, int N, int H) {
    extern __shared__ __align__(16) float smem[];
    const int HS = pad_stride(H);
    float* ws = smem;                        // [H][3][kBU]: this block's W_hh columns
    float* hs = ws + (size_t)H * 3 * kBU;    // [kBN][HS]: rows of h_prev
    float* red = hs + kBN * HS;              // [kBN][3][kBU]: partials of k-half 1

    const int dir = blockIdx.z;
    const int u0 = blockIdx.x * kBU;
    const int n0 = blockIdx.y * kBN;
    const int t = dir == 0 ? T - 1 - step : step;
    const bool has_prev = dir == 0 ? t > 0 : t < T - 1;
    const int H3 = 3 * H;
    const size_t state = (size_t)N * H;

    const int half = threadIdx.x / (kTU * kTR);
    const int tu = threadIdx.x % kTU;
    const int tr = (threadIdx.x / kTU) % kTR;

    // Group 0 finishes the gate math: fetch its operands now, so their
    // latency hides under the staging and the k loop.
    const float* px = (dir == 0 ? px_f : px_b) + (size_t)t * N * H3;
    const float* dy = (dir == 0 ? dy_f : dy_b) + (size_t)t * N * H;
    const float* dhi = dh_in + dir * state;
    const float* b = b_hh + dir * H3;
    float xg[3][2][2], bg[3][2], dht[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int u = u0 + 2 * tu + j;
        const bool u_ok = half == 0 && u < H;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            bg[g][j] = u_ok ? b[g * H + u] : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = n0 + 2 * tr + i;
                xg[g][i][j] = u_ok && row < N ? px[(size_t)row * H3 + g * H + u] : 0.f;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = n0 + 2 * tr + i;
            dht[i][j] = u_ok && row < N ? dhi[(size_t)row * H + u] + dy[(size_t)row * H + u] : 0.f;
        }
    }

    // Stage the block's W_hh columns and its rows of h_prev (zero at the
    // direction's first step), 16 bytes per load.
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* W = w_hh + (size_t)dir * H * H3;
    constexpr int kQ = kBU / 4;
#pragma unroll 8
    for (int i = threadIdx.x; i < H * 3 * kQ; i += kThreads) {
        const int k = i / (3 * kQ);
        const int g = (i / kQ) % 3;
        const int u = u0 + 4 * (i % kQ);
        reinterpret_cast<float4*>(ws)[i] =
            u < H ? __ldg(reinterpret_cast<const float4*>(W + (size_t)k * H3 + g * H + u)) : zero;
    }
    const float* hprev = !has_prev ? ys_f
                         : dir == 0 ? ys_f + (size_t)(t - 1) * state
                                    : ys_b + (size_t)(t + 1) * state;
    const int h4 = H / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBN * h4; i += kThreads) {
        const int r = i / h4, k = 4 * (i % h4);
        *reinterpret_cast<float4*>(hs + r * HS + k) =
            has_prev && n0 + r < N
                ? __ldg(reinterpret_cast<const float4*>(hprev + (size_t)(n0 + r) * H + k))
                : zero;
    }
    __syncthreads();

    const float* h0 = hs + (2 * tr) * HS;
    const float* h1 = h0 + HS;
    float acc[3][2][2];
#pragma unroll
    for (int g = 0; g < 3; ++g)
        acc[g][0][0] = acc[g][0][1] = acc[g][1][0] = acc[g][1][1] = 0.f;

    const int kbeg = half * (H / kKSplit), kend = kbeg + H / kKSplit;
#pragma unroll 2
    for (int k = kbeg; k < kend; k += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(h0 + k);
        const float4 b4 = *reinterpret_cast<const float4*>(h1 + k);
        const float ha[4] = {a4.x, a4.y, a4.z, a4.w};
        const float hb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
                const float2 w = *reinterpret_cast<const float2*>(
                    ws + ((k + kk) * 3 + g) * kBU + 2 * tu);
                acc[g][0][0] = fmaf(ha[kk], w.x, acc[g][0][0]);
                acc[g][0][1] = fmaf(ha[kk], w.y, acc[g][0][1]);
                acc[g][1][0] = fmaf(hb[kk], w.x, acc[g][1][0]);
                acc[g][1][1] = fmaf(hb[kk], w.y, acc[g][1][1]);
            }
        }
    }

    if (half == 1) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    red[((2 * tr + i) * 3 + g) * kBU + 2 * tu + j] = acc[g][i][j];
    }
    __syncthreads();
    if (half == 1) return;

    float* dpx = (dir == 0 ? dpx_f : dpx_b) + (size_t)t * N * H3;
    float* dp = dph + ((size_t)dir * T + t) * N * H3;
    float* dz_out = dhz + dir * state;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r_local = 2 * tr + i;
        const int row = n0 + r_local;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int u = u0 + 2 * tu + j;
            if (u >= H) continue;
            const float* part = red + (r_local * 3) * kBU + 2 * tu + j;
            const float hr = acc[0][i][j] + part[0] + bg[0][j];
            const float hz = acc[1][i][j] + part[kBU] + bg[1][j];
            const float hn = acc[2][i][j] + part[2 * kBU] + bg[2][j];
            const float r = sigmoid(xg[0][i][j] + hr);
            const float z = sigmoid(xg[1][i][j] + hz);
            const float c = tanhf(xg[2][i][j] + r * hn);
            const float h_prev = hs[r_local * HS + u];
            const float d = dht[i][j];
            const float da_c = d * (1.f - z) * (1.f - c * c);
            const float da_z = d * (h_prev - c) * z * (1.f - z);
            const float dhn = da_c * r;
            const float da_r = da_c * hn * r * (1.f - r);
            const size_t o = (size_t)row * H3 + u;
            dpx[o] = da_r;
            dpx[o + H] = da_z;
            dpx[o + 2 * H] = da_c;
            dp[o] = da_r;
            dp[o + H] = da_z;
            dp[o + 2 * H] = dhn;
            dz_out[(size_t)row * H + u] = d * z;
        }
    }
}

// (b) dh_out = dhz + dph[dir][t] @ W_hh^T for this block's units and rows.
__global__ void __launch_bounds__(kThreads)
gru_bwd_dh_kernel(const float* __restrict__ w_t, const float* __restrict__ dph,
                  const float* __restrict__ dhz, float* __restrict__ dh_out,
                  int step, int T, int N, int H) {
    extern __shared__ __align__(16) float smem[];
    const int H3 = 3 * H;
    const int DS = pad_stride(H3);
    float* ws = smem;                        // [3H][kBU]: W_hh^T rows for this block's units
    float* ds = ws + (size_t)H3 * kBU;       // [kBN][DS]: rows of dph
    float* red = ds + kBN * DS;              // [kBN][kBU]: partials of k-half 1

    const int dir = blockIdx.z;
    const int u0 = blockIdx.x * kBU;
    const int n0 = blockIdx.y * kBN;
    const int t = dir == 0 ? T - 1 - step : step;
    const size_t state = (size_t)N * H;

    const int half = threadIdx.x / (kTU * kTR);
    const int tu = threadIdx.x % kTU;
    const int tr = (threadIdx.x / kTU) % kTR;

    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* Wt = w_t + (size_t)dir * H3 * H;
    constexpr int kQ = kBU / 4;
#pragma unroll 8
    for (int i = threadIdx.x; i < H3 * kQ; i += kThreads) {
        const int k = i / kQ;
        const int u = u0 + 4 * (i % kQ);
        reinterpret_cast<float4*>(ws)[i] =
            u < H ? __ldg(reinterpret_cast<const float4*>(Wt + (size_t)k * H + u)) : zero;
    }
    const float* dp = dph + ((size_t)dir * T + t) * N * H3;
    const int d4 = H3 / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBN * d4; i += kThreads) {
        const int r = i / d4, k = 4 * (i % d4);
        *reinterpret_cast<float4*>(ds + r * DS + k) =
            n0 + r < N ? *reinterpret_cast<const float4*>(dp + (size_t)(n0 + r) * H3 + k) : zero;
    }
    __syncthreads();

    const float* d0 = ds + (2 * tr) * DS;
    const float* d1 = d0 + DS;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const int kbeg = half * (H3 / kKSplit), kend = kbeg + H3 / kKSplit;
#pragma unroll 2
    for (int k = kbeg; k < kend; k += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(d0 + k);
        const float4 b4 = *reinterpret_cast<const float4*>(d1 + k);
        const float da[4] = {a4.x, a4.y, a4.z, a4.w};
        const float db[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float2 w = *reinterpret_cast<const float2*>(ws + (k + kk) * kBU + 2 * tu);
            acc[0][0] = fmaf(da[kk], w.x, acc[0][0]);
            acc[0][1] = fmaf(da[kk], w.y, acc[0][1]);
            acc[1][0] = fmaf(db[kk], w.x, acc[1][0]);
            acc[1][1] = fmaf(db[kk], w.y, acc[1][1]);
        }
    }

    if (half == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) red[(2 * tr + i) * kBU + 2 * tu + j] = acc[i][j];
    }
    __syncthreads();
    if (half == 1) return;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = n0 + 2 * tr + i;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int u = u0 + 2 * tu + j;
            if (u >= H) continue;
            const size_t o = dir * state + (size_t)row * H + u;
            dh_out[o] = dhz[o] + (acc[i][j] + red[(2 * tr + i) * kBU + 2 * tu + j]);
        }
    }
}

// (c) dw[dir][k][j] = sum over rows (t, n) of h_prev(t)[n][k] * dph[dir][t][n][j],
// and db[dir][j] = sum of dph[dir][t][n][j], in row order.
constexpr int kTK = 32;                  // rows of dW (k) per block
constexpr int kTJ = 64;                  // columns of dW (j) per block
constexpr int kR = 16;                   // (t, n) rows per stage
constexpr int kDwThreads = (kTK / 4) * (kTJ / 4);  // 128

__global__ void __launch_bounds__(kDwThreads)
gru_bwd_dw_kernel(const float* __restrict__ ys_f, const float* __restrict__ ys_b,
                  const float* __restrict__ dph, float* __restrict__ dw,
                  float* __restrict__ db, int T, int N, int H) {
    __shared__ __align__(16) float as[kR][kTK];
    __shared__ __align__(16) float bs[kR][kTJ];
    const int dir = blockIdx.z;
    const int j0 = blockIdx.x * kTJ;
    const int k0 = blockIdx.y * kTK;
    const int H3 = 3 * H;
    const int rows = T * N;
    const int tx = threadIdx.x % (kTJ / 4);
    const int ty = threadIdx.x / (kTJ / 4);
    const bool with_db = blockIdx.y == 0 && threadIdx.x < kTJ;
    const float* D = dph + (size_t)dir * rows * H3;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    float acc[4][4] = {};
    float dbacc = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kR) {
        {   // h_prev rows: kR x kTK floats, one float4 per thread.
            const int rr = threadIdx.x / (kTK / 4), q = threadIdx.x % (kTK / 4);
            const int r = r0 + rr, k = k0 + 4 * q;
            float4 v = zero;
            if (r < rows && k < H) {
                const int t = r / N, n = r % N;
                if (dir == 0 ? t > 0 : t < T - 1) {
                    const float* src = dir == 0 ? ys_f + ((size_t)(t - 1) * N + n) * H
                                                : ys_b + ((size_t)(t + 1) * N + n) * H;
                    v = __ldg(reinterpret_cast<const float4*>(src + k));
                }
            }
            *reinterpret_cast<float4*>(&as[rr][4 * q]) = v;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // dph rows: kR x kTJ floats, two float4 per thread.
            const int i = threadIdx.x + s * kDwThreads;
            const int rr = i / (kTJ / 4), q = i % (kTJ / 4);
            const int r = r0 + rr, j = j0 + 4 * q;
            *reinterpret_cast<float4*>(&bs[rr][4 * q]) =
                r < rows && j < H3 ? *reinterpret_cast<const float4*>(D + (size_t)r * H3 + j) : zero;
        }
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
            const float4 a4 = *reinterpret_cast<const float4*>(&as[rr][4 * ty]);
            const float4 b4 = *reinterpret_cast<const float4*>(&bs[rr][4 * tx]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (with_db) {
#pragma unroll
            for (int rr = 0; rr < kR; ++rr) dbacc += bs[rr][threadIdx.x];
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * ty + i;
        if (k >= H) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int jj = j0 + 4 * tx + j;
            if (jj < H3) dw[((size_t)dir * H + k) * H3 + jj] = acc[i][j];
        }
    }
    if (with_db && j0 + threadIdx.x < H3) db[dir * H3 + j0 + threadIdx.x] = dbacc;
}

}  // namespace

extern "C" {

// See the contract above. w_t [2, 3H, H] is w_hh transposed per direction;
// scratch: dph [2, T, N, 3H], dh_buf [2 (ping-pong), 2, N, H], dhz [2, N, H].
// All float32, contiguous, on CUDA device `device`, whose stream is
// `stream`. Returns the first CUDA error of the launches, or 0.
int ocrs_gru_bwd(int device, const float* px_f, const float* px_b, const float* ys_f,
                 const float* ys_b, const float* dy_f, const float* dy_b, const float* w_hh,
                 const float* w_t, const float* b_hh, float* dpx_f, float* dpx_b, float* dph,
                 float* dh_buf, float* dhz, float* dw, float* db, int T, int N, int H,
                 void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (H % 8 != 0) return (int)cudaErrorInvalidValue;
    const size_t smem_a = gates_smem(H), smem_b = dh_smem(H);
    if (smem_a > kMaxSmem || smem_b > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t buf = (size_t)2 * N * H;  // both directions
    err = cudaMemsetAsync(dh_buf, 0, buf * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gru_bwd_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gru_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((H + kBU - 1) / kBU, (N + kBN - 1) / kBN, 2);
    for (int step = 0; step < T; ++step) {
        const float* dh_in = dh_buf + (step % 2) * buf;
        float* dh_out = dh_buf + ((step + 1) % 2) * buf;
        gru_bwd_gates_kernel<<<grid, kThreads, smem_a, s>>>(
            px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh, dpx_f, dpx_b, dph, dh_in, dhz,
            step, T, N, H);
        if (step + 1 < T) {  // the last step's dh is not needed
            gru_bwd_dh_kernel<<<grid, kThreads, smem_b, s>>>(w_t, dph, dhz, dh_out, step, T, N, H);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 dw_grid((3 * H + kTJ - 1) / kTJ, (H + kTK - 1) / kTK, 2);
    gru_bwd_dw_kernel<<<dw_grid, kDwThreads, 0, s>>>(ys_f, ys_b, dph, dw, db, T, N, H);
    return (int)cudaGetLastError();
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
