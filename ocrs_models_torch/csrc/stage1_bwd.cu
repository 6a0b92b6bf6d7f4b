// Recognition stage 1, backward: the weight and bias gradients of
// y = maxpool2x2(relu(conv3x3_pad1(x) + b)), 1 -> 32 channels, in float32
// or bfloat16.
//
// Replaces: the backward of the Pallas kernel `stage1_fused` in
// ocrs_models_tpu/ops/pallas/stage1_kernel.py (`_bwd_call`, body
// `_bwd_kernel`). Same function: recompute the four pre-activations of each
// pool window, send dy to the FIRST maximum of the ReLU'd values in window
// order (0,0), (0,1), (1,0), (1,1), pass it only where that pre-activation
// is > 0, and sum dy * patch over the batch into dW [32, 9] and db [32]. The
// image gradient is not computed (training never asks for it).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores). At N=256, H=64, W=256 the function must read x once
// (16.8 MB) and dy once (256*32*32*128*4 B = 134.2 MB): 151 MB, 45 us.
// The arithmetic is, per pooled output and channel, 4 pre-activations of
// 9 FMAs and 10 FMAs of the selected patch: 33.6M * 46 FMA = 3.1 GFLOP,
// 46 us. Both bounds are about equal; reading dy is 89% of the bytes.
//
// Design: FMAs, not loads, set the pace.
// - A lane owns a pooled POSITION: a warp takes 32 neighbouring pooled
//   columns, so its dy loads (one per channel) and x loads are coalesced
//   with no transposing stage. The lane keeps its 4 x 4 input patch in 16
//   registers and reuses it for the kGroup (4) channels of its warp, whose
//   40 gradient sums also stay in registers; the 8 warps of a block are the
//   8 channel groups of one tile. A patch row is two loads per lane
//   (columns 2j, 2j+1; the outer two come from the neighbouring lanes by
//   shuffle, the tile's two edge columns by one extra load), and walking
//   down the rows only the two new input rows are loaded.
// - The weights wait in shared memory and come as three 16-byte broadcast
//   loads per channel and row: held in registers (40 of 128) they made the
//   compiler spill and recompute addresses, 462 instructions a row against
//   414 now. 8 channels per warp, or registers cut for a third block per
//   SM, lost to 4 channels and two blocks.
// - Loads stay in flight: the x rows and dy values of pooled row ph + 1 are
//   requested into registers before the FMAs of row ph.
// - The arg-max is three compares on the pre-activations (first maximum in
//   window order; equal to the first maximum of the ReLU'd values whenever
//   a gradient passes), the patch is routed by 12 selects on the column and
//   two masked gradients on the row (one is 0, so the sum is the selected
//   product exactly): 55 FMAs and 23 compares and selects per (position,
//   channel). Selecting rows, then columns (21 selects, 9 FMAs), and four
//   masked gradients (36 FMAs) were both slower.
// - The grid is sized from the card: SM count x resident blocks, each block
//   walking an equal share of the (image, column tile, pooled row) items in
//   a fixed order that depends on the shapes and the block index alone.
// - Sums over positions stay in a lane's registers for the whole walk,
//   cross lanes once by shuffles in a fixed order, and go to one partial
//   [32, 10] per block, scratch of the call; a second kernel adds the few
//   hundred partials, 32 outputs per block with 8 warps striding over the
//   partials and a fixed order across warps. No float atomics: reruns agree
//   bit for bit.
// Pooling floors odd sizes, like torch's MaxPool2d; any w is taken (the
// loads are one element each, predicated at the edges).
//
// bf16 (`dt=jnp.bfloat16`): the same kernels read x and dy as bf16; the
// wrapper rounds the taps and the bias to bf16 values, so the recomputed
// pre-activations are those of the bf16 forward, and every product
// dy * patch is exact in f32 (dy is already a bf16 value, the cotangent of
// a bf16 output, so the Pallas kernel's cast of d4 to bf16 changes
// nothing). Partials and dW10 stay f32; the tie-break and the gate are the
// f32 version's. At N=128, H=64, W=1024 the bytes halve (16.8 + 134.2 MB,
// 45 us) and bound it: the products take 6 us at the bf16 tensor-core rate
// (989 TFLOP/s). This kernel runs them as f32 FMAs, 92 us at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_io.cuh"

namespace {

constexpr int kC = 32;                // output channels
constexpr int kK = 10;                // 9 taps (dy * 3 + dx) + bias
constexpr int kGroup = 4;             // channels per warp
constexpr int kWarps = kC / kGroup;   // warps per block: all channels of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;             // pooled columns per item: one per lane
constexpr int kMinBlocks = 2;         // resident blocks per SM the registers are held to
constexpr unsigned kFull = 0xffffffffu;

// What a lane loads of one input row: columns 2j and 2j + 1 of its pooled
// column j, and (lanes 0 and 31) the tile's outer column.
struct RawRow {
    float v0, v1, edge;
};

// Which of the three the image holds (fixed over a run of rows).
struct Cols {
    bool ok0, ok1, eok;
};

// `at`: the row's column 2j; `edge_at`: its outer column; `in`: the row is
// inside the image. Outside, zeros (the convolution's padding).
template <typename T>
__device__ __forceinline__ RawRow load_row(const T* __restrict__ at, const T* __restrict__ edge_at,
                                           bool in, const Cols& c) {
    RawRow r;
    r.v0 = in && c.ok0 ? io::ldg(at) : 0.f;
    r.v1 = in && c.ok1 ? io::ldg(at + 1) : 0.f;
    r.edge = in && c.eok ? io::ldg(edge_at) : 0.f;
    return r;
}

// The four patch columns 2j - 1 .. 2j + 2 of a row, from the lane's two and
// its neighbours'.
__device__ __forceinline__ void expand_row(const RawRow& r, int lane, float out[4]) {
    const float left = __shfl_up_sync(kFull, r.v1, 1);
    const float right = __shfl_down_sync(kFull, r.v0, 1);
    out[0] = lane == 0 ? r.edge : left;
    out[1] = r.v0;
    out[2] = r.v1;
    out[3] = lane == 31 ? r.edge : right;
}

// One pooled row of one warp: the gradients g of its kGroup channels at the
// lane's position, whose 4 x 4 patch is the row pairs `top` and `bot`.
__device__ __forceinline__ void accumulate(const float (&top)[2][4], const float (&bot)[2][4],
                                           const float (&g)[kGroup],
                                           const float4* __restrict__ ws,
                                           float (&acc)[kGroup][kK]) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        p[0][i] = top[0][i];
        p[1][i] = top[1][i];
        p[2][i] = bot[0][i];
        p[3][i] = bot[1][i];
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
        // The channel's taps and bias: three 16-byte broadcast loads.
        const float4 wa = ws[3 * j], wb = ws[3 * j + 1], wc = ws[3 * j + 2];
        const float wr[kK] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w, wc.x, wc.y};
        // The four pre-activations, in the forward kernel's FMA order.
        float y[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float s = wr[9];
#pragma unroll
                for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                    for (int kx = 0; kx < 3; ++kx)
                        s = fmaf(wr[ky * 3 + kx], p[a + ky][q + kx], s);
                y[a][q] = s;
            }
        // First maximum in window order (0,0), (0,1), (1,0), (1,1): a later
        // one wins only if strictly greater. Where the maximum is > 0 it is
        // also the first maximum of the ReLU'd values; where it is not, no
        // gradient passes.
        const bool qt = y[0][1] > y[0][0];
        const bool qb = y[1][1] > y[1][0];
        const float yt = qt ? y[0][1] : y[0][0];
        const float yb = qb ? y[1][1] : y[1][0];
        const bool a = yb > yt;
        const bool q = a ? qb : qt;
        const float gg = (a ? yb : yt) > 0.f ? g[j] : 0.f;
        const float g0 = a ? 0.f : gg;  // the window's upper row took it
        const float g1 = a ? gg : 0.f;  // the lower row
        // acc[ky][kx] += gg * p[a + ky][q + kx]: the column by select, the
        // row by the two masked gradients (one of them is 0).
        float v[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) v[i][kx] = q ? p[i][kx + 1] : p[i][kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
                acc[j][ky * 3 + kx] =
                    fmaf(g1, v[ky + 1][kx], fmaf(g0, v[ky][kx], acc[j][ky * 3 + kx]));
        acc[j][9] += gg;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage1_bwd_partial_kernel(const T* __restrict__ x, const float* __restrict__ w10,
                          const T* __restrict__ dy, float* __restrict__ partial,
                          int n, int h, int w) {
    const int lane = threadIdx.x & 31;
    const int c0 = (threadIdx.x >> 5) * kGroup;
    const int hp = h / 2, wp = w / 2;
    const int ntile = (wp + kTile - 1) / kTile;
    const size_t plane = (size_t)hp * wp;
    const long long total = (long long)n * ntile * hp;  // items: (image, column tile, pooled row)
    long long it = total * blockIdx.x / gridDim.x;
    const long long end = total * (blockIdx.x + 1) / gridDim.x;

    // The weights wait in shared memory, 12 floats a channel: in registers
    // they would be 40 of a thread's 128.
    __shared__ float4 ws[kC][3];
    for (int i = threadIdx.x; i < kC * 12; i += kThreads) {
        const int ch = i / 12, k = i % 12;
        reinterpret_cast<float*>(ws[ch])[k] = k < kK ? __ldg(w10 + ch * kK + k) : 0.f;
    }
    __syncthreads();
    float acc[kGroup][kK];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[j][k] = 0.f;

    while (it < end) {
        // A run of pooled rows of one (image, column tile).
        const int ph0 = (int)(it % hp);
        const long long rest = it / hp;
        const int ct = (int)(rest % ntile);
        const int b = (int)(rest / ntile);
        const int rows = (int)min((long long)(hp - ph0), end - it);
        const int pw = ct * kTile + lane;
        const bool live = pw < wp;
        const int col = 2 * pw;
        const int ecol = lane == 0 ? col - 1 : col + 2;
        Cols c;
        c.ok0 = col < w;
        c.ok1 = col + 1 < w;
        c.eok = (lane == 0 && ecol >= 0) || (lane == 31 && ecol < w);
        // Input row 2 * ph0 - 1 at the lane's columns; pointers outside the
        // image are never read through.
        const T* at = x + ((size_t)b * h + 2 * ph0) * w - w + col;
        const T* edge_at = at + (ecol - col);
        const T* dyr = dy + ((size_t)b * kC + c0) * plane + (size_t)ph0 * wp + pw;

        // The patch as two row pairs: going down a pooled row, the lower
        // pair becomes the upper one and only the new lower pair is loaded.
        float top[2][4], bot[2][4], g[kGroup], gn[kGroup];
        expand_row(load_row(at, edge_at, ph0 > 0, c), lane, top[0]);
        expand_row(load_row(at + w, edge_at + w, true, c), lane, top[1]);
        at += 2 * w;  // from here on: the row of n2, input row 2 * ph + 1
        edge_at += 2 * w;
        RawRow n2 = load_row(at, edge_at, true, c);
        RawRow n3 = load_row(at + w, edge_at + w, 2 * ph0 + 2 < h, c);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) gn[j] = live ? io::ldcs(dyr + j * plane) : 0.f;

        for (int r = 0; r < rows; ++r) {
            expand_row(n2, lane, bot[0]);
            expand_row(n3, lane, bot[1]);
#pragma unroll
            for (int j = 0; j < kGroup; ++j) g[j] = gn[j];
            if (r + 1 < rows) {  // the next pooled row's loads, in flight over this row's FMAs
                at += 2 * w;
                edge_at += 2 * w;
                dyr += wp;
                n2 = load_row(at, edge_at, true, c);
                n3 = load_row(at + w, edge_at + w, 2 * (ph0 + r) + 4 < h, c);
#pragma unroll
                for (int j = 0; j < kGroup; ++j) gn[j] = live ? io::ldcs(dyr + j * plane) : 0.f;
            }
            accumulate(top, bot, g, ws[c0], acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                top[0][i] = bot[0][i];
                top[1][i] = bot[1][i];
            }
        }
        it += rows;
    }

    // Lanes in a fixed butterfly order; each warp owns its channels.
    float* out = partial + (size_t)blockIdx.x * (kC * kK) + c0 * kK;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int k = 0; k < kK; ++k) {
            float s = acc[j][k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
            if (lane == 0) out[j * kK + k] = s;
        }
}

// dw10[i] = sum over the blocks' partials of partial[block][i]. A block
// takes 32 outputs (one per lane); warp g adds partials g, g + 8, ... in
// order, and the 8 warps' sums are added in warp order.
constexpr int kFinishWarps = 8;

__global__ void __launch_bounds__(32 * kFinishWarps)
stage1_bwd_finish_kernel(const float* __restrict__ partial, float* __restrict__ dw10,
                         int n_part) {
    __shared__ float red[kFinishWarps][32];
    const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5;
    const int i = blockIdx.x * 32 + lane;
    float s = 0.f;
#pragma unroll 4
    for (int p = wq; p < n_part; p += kFinishWarps) s += partial[(size_t)p * (kC * kK) + i];
    red[wq][lane] = s;
    __syncthreads();
    if (wq == 0) {
        float t = 0.f;
#pragma unroll
        for (int g = 0; g < kFinishWarps; ++g) t += red[g][lane];
        dw10[i] = t;
    }
}

// Blocks of the first pass: what the card holds at once, no more than items.
template <typename T>
int partial_blocks(int device, int n, int h, int w) {
    const long long total = (long long)n * ((w / 2 + kTile - 1) / kTile) * (h / 2);
    if (total <= 0) return 0;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage1_bwd_partial_kernel<T>,
                                                      kThreads, 0) != cudaSuccess ||
        sms < 1 || per_sm < 1)
        return -1;
    const long long held = (long long)sms * per_sm;
    return (int)(held < total ? held : total);
}

template <typename T>
int blocks(int device, int n, int h, int w) {
    if (cudaSetDevice(device) != cudaSuccess) return -1;
    return partial_blocks<T>(device, n, h, w);
}

template <typename T>
int launch(int device, const T* x, const float* w10, const T* dy, float* partial, float* dw10,
           int n, int h, int w, int n_part, void* stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_part < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_part > 0) {
        stage1_bwd_partial_kernel<T><<<n_part, kThreads, 0, s>>>(x, w10, dy, partial, n, h, w);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    stage1_bwd_finish_kernel<<<kC * kK / 32, 32 * kFinishWarps, 0, s>>>(partial, dw10, n_part);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials ([blocks, 320] floats) ocrs_stage1_bwd needs
// on CUDA device `device`: the grid of its first pass. -1 if the card
// cannot be asked.
int ocrs_stage1_bwd_blocks(int device, int n, int h, int w) {
    return blocks<float>(device, n, h, w);
}

// x [n, 1, h, w], w10 [32, 10] (taps + bias), dy [n, 32, h/2, w/2];
// partial: scratch of `n_part` * 320 floats, n_part as
// ocrs_stage1_bwd_blocks(device, n, h, w) gave it; dw10 [32, 10] out (dW
// taps, db). All float32, contiguous, on CUDA device `device`, whose stream
// is `stream`. Returns cudaGetLastError().
int ocrs_stage1_bwd(int device, const float* x, const float* w10, const float* dy,
                    float* partial, float* dw10, int n, int h, int w, int n_part, void* stream) {
    return launch(device, x, w10, dy, partial, dw10, n, h, w, n_part, stream);
}

// The same for bf16 x and dy (w10 float32 holding bf16 values; partial and
// dw10 float32), with the grid of ocrs_stage1_bwd_bf16_blocks.
int ocrs_stage1_bwd_bf16_blocks(int device, int n, int h, int w) {
    return blocks<io::bf16>(device, n, h, w);
}

int ocrs_stage1_bwd_bf16(int device, const io::bf16* x, const float* w10, const io::bf16* dy,
                         float* partial, float* dw10, int n, int h, int w, int n_part,
                         void* stream) {
    return launch(device, x, w10, dy, partial, dw10, n, h, w, n_part, stream);
}

const char* ocrs_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
