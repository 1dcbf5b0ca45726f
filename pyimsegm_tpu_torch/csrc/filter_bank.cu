// Texture filter bank (LM or Gabor): every battery's orientation maximum of
// every channel in one pass over the image.
//
// Replaces no TPU kernel: the JAX package leaves the bank to lax.conv
// (pyimsegm_tpu/ops/filters.py:filter_bank_raw).  The plain twin is
// pyimsegm_tpu_torch/ops/filters.py:_filter_bank_raw_plain (one F.conv2d a
// battery over the 'symmetric' padding, amax over the battery, clamp);
// the wrapper is pyimsegm_tpu_torch/ops/filters_cuda.py:filter_bank.
//
// Bound: f32 FFMA issue.  The short LM bank is 33 filters of 33 x 33 taps,
// 35,937 multiply-adds a pixel and channel: 1.59 TFLOP on a 2048 x 3600 x 3
// tile, 23.7 ms at the 67 TFLOP/s of an NVIDIA H100 SXM (700 W); it takes
// 32.5 ms there, 73% of the bound (PERF.md, row 16).  Bytes are small
// beside it: the image is read once and each battery's maximum written
// once (1.42 GB, 0.42 ms at 3.35 TB/s).
// Design: a block owns a FB_TH x FB_TW tile of outputs of one channel
// (grid z).  It stages the tile and its halo once in shared memory with the
// symmetric border applied as it stages (reflect(), the rule of
// ops/slic._symmetric_index), then walks the bank pass by pass.  A pass is
// one battery, or a run of small batteries that share it (a sigma's
// Gaussian, LoG and LoG2); its flipped taps are staged in shared memory as
// [ky][kx][group][4] so that one broadcast 16-byte load gives four
// filters' tap.  Each thread holds FB_R neighbouring outputs of a row x
// every filter of the pass in registers; per run of FB_KC taps it loads
// its FB_R + FB_KC input window as 16-byte loads (eight lanes of a
// quarter-warp on eight rows, a row stride of 4 mod 8 words: no bank
// conflict) and issues FB_R x NF FFMAs a tap, so loads are ~5% of the
// issued instructions.  Sums run in one fixed order (ky, then kx,
// ascending), so a result repeats bit for bit.  The epilogue takes each
// battery's maximum (NaN-propagating, as torch.amax), clamps it and stores
// it into the (B, H, W, C) result; no filter's response reaches device
// memory.  A battery wider than a pass (8 filters) runs as several passes,
// each later one merging its maximum with the stored one.  No tensor cores
// and no TF32: the result keeps f32 products and sums.  The register block
// follows the bank's battery sizes: filter_bank_kernel<1> runs passes of
// up to 4 filters (80 registers, 3 blocks an SM), <2> up to 8 (115, 2).

#include <cstdint>
#include <cuda_runtime.h>

#define FB_THREADS 256
#define FB_TH 32            // output tile rows (4 warp rows of 8)
#define FB_TW 64            // output tile columns (2 warp columns of 32)
#define FB_R 8              // outputs of a thread's row run
#define FB_KC 8             // taps of a run
#define FB_MAX_SUPPORT 33
#define FB_ENTRY 14         // ints of a pass entry (filters_cuda.ENTRY)

static_assert(FB_TW == 2 * 4 * FB_R && FB_TH == 4 * 8, "tile");
static_assert(FB_R % 4 == 0 && FB_KC % 4 == 0, "16-byte window loads");

// pass entry: tap offset (float4s), filters (template instance), float4
// groups a tap, first battery, batteries, merge with the stored maximum,
// then each filter's battery (from the first; -1 for padding)
enum { E_TAPS = 0, E_NF, E_NG, E_BAT0, E_NBAT, E_MERGE, E_FB };

// numpy 'symmetric' padding (ops/slic._symmetric_index): d c b a | a b c d
__device__ __forceinline__ int reflect(int i, int n) {
    while (i < 0 || i >= n) {
        if (i < 0) i = -i - 1;
        if (i >= n) i = 2 * n - i - 1;
    }
    return i;
}

// NaN-propagating maximum (torch.amax): NaN once either side is NaN
__device__ __forceinline__ float nan_max(float m, float v) {
    return (v > m || v != v) ? v : m;
}

__host__ __device__ __forceinline__ int fb_cols(int support) {
    return FB_TW + FB_KC * ((support + FB_KC - 1) / FB_KC);
}

// row stride of the staged tile: 4 mod 8 words, so the eight rows of a
// quarter-warp's 16-byte loads fall in eight distinct bank groups
__host__ __device__ __forceinline__ int fb_stride(int support) {
    return fb_cols(support) + 4;
}

static size_t fb_smem(int support, int groups) {
    return sizeof(float) * (size_t)(FB_TH + support - 1) * fb_stride(support)
        + sizeof(float4) * (size_t)support * support * groups;
}

// FB_KC taps (n of them when TAIL) of one tap row: the window of FB_R +
// FB_KC inputs from `row`, the taps from `t` (NG float4s a tap)
template <int NF, bool TAIL>
__device__ __forceinline__ void tap_run(float (&acc)[FB_R][NF],
                                        const float* row, const float4* t,
                                        int n) {
    constexpr int NG = (NF + 3) / 4;
    float v[FB_R + FB_KC];
#pragma unroll
    for (int q = 0; q < (FB_R + FB_KC) / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(row)[q];
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < FB_KC; ++j) {
        if (TAIL && j >= n) break;
        float k[4 * NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            const float4 y = t[j * NG + g];
            k[4 * g] = y.x;
            k[4 * g + 1] = y.y;
            k[4 * g + 2] = y.z;
            k[4 * g + 3] = y.w;
        }
#pragma unroll
        for (int r = 0; r < FB_R; ++r)
#pragma unroll
            for (int f = 0; f < NF; ++f)
                acc[r][f] = fmaf(v[r + j], k[f], acc[r][f]);
    }
}

// One pass: NF filters' responses at the thread's FB_R outputs, then each
// battery's maximum into `out`.
template <int NF>
__device__ __forceinline__ void run_pass(const float* s_in,
                                         const float4* s_taps, const int* e,
                                         float* __restrict__ out, int h,
                                         int w, int c, int ch, int support,
                                         int y, int x, int ty, int tx,
                                         float clamp) {
    constexpr int NG = (NF + 3) / 4;
    const int stride = fb_stride(support);
    const int full = support / FB_KC, tail = support - full * FB_KC;
    float acc[FB_R][NF];
#pragma unroll
    for (int r = 0; r < FB_R; ++r)
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[r][f] = 0.0f;
#pragma unroll 1
    for (int ky = 0; ky < support; ++ky) {
        const float* row = s_in + (ty + ky) * stride + tx;
        const float4* t = s_taps + ky * support * NG;
#pragma unroll 1
        for (int kc = 0; kc < full; ++kc)
            tap_run<NF, false>(acc, row + kc * FB_KC, t + kc * FB_KC * NG,
                               FB_KC);
        if (tail)
            tap_run<NF, true>(acc, row + full * FB_KC, t + full * FB_KC * NG,
                              tail);
    }
    if (y >= h) return;
    const int bat0 = __ldg(e + E_BAT0), nbat = __ldg(e + E_NBAT);
    const bool merge = __ldg(e + E_MERGE) != 0;
    int fb[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) fb[f] = __ldg(e + E_FB + f);
    const long long plane = (long long)h * w * c;
    for (int b = 0; b < nbat; ++b) {
        float* o = out + (bat0 + b) * plane + ((long long)y * w + x) * c + ch;
#pragma unroll
        for (int r = 0; r < FB_R; ++r) {
            if (x + r >= w) break;
            float m = -INFINITY;
#pragma unroll
            for (int f = 0; f < NF; ++f)
                if (fb[f] == b) m = nan_max(m, acc[r][f]);
            m = m > clamp ? clamp : m;               // NaN stays NaN
            if (merge) m = nan_max(o[r * c], m);
            o[r * c] = m;
        }
    }
}

// WIDE: float4 groups of the widest pass (1: up to 4 filters, 2: up to 8)
template <int WIDE>
__global__ void __launch_bounds__(FB_THREADS, WIDE == 1 ? 3 : 2)
filter_bank_kernel(const float* __restrict__ img,
                   const float4* __restrict__ taps,
                   const int* __restrict__ table, float* __restrict__ out,
                   int h, int w, int c, int support, int n_pass, float clamp) {
    extern __shared__ float4 smem[];
    float* s_in = reinterpret_cast<float*>(smem);
    const int rows = FB_TH + support - 1, cols = fb_cols(support);
    const int stride = fb_stride(support), valid = FB_TW + support - 1;
    float4* s_taps = smem + rows * stride / 4;
    const int radius = support / 2, ch = blockIdx.z;
    const int x0 = blockIdx.x * FB_TW, y0 = blockIdx.y * FB_TH;
    for (int i = threadIdx.x; i < rows * cols; i += FB_THREADS) {
        const int sy = i / cols, sx = i - sy * cols;
        float v = 0.0f;                    // past the last tap: never used
        if (sx < valid)
            v = __ldg(img + ((long long)reflect(y0 + sy - radius, h) * w
                             + reflect(x0 + sx - radius, w)) * c + ch);
        s_in[sy * stride + sx] = v;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ty = (warp >> 1) * 8 + (lane & 7);
    const int tx = (warp & 1) * 32 + (lane >> 3) * FB_R;
    const int y = y0 + ty, x = x0 + tx;
    for (int p = 0; p < n_pass; ++p) {
        const int* e = table + p * FB_ENTRY;
        const int nf = __ldg(e + E_NF);
        const float4* src = taps + __ldg(e + E_TAPS);
        const int n4 = support * support * __ldg(e + E_NG);
        __syncthreads();                   // the last pass is done with s_taps
        for (int i = threadIdx.x; i < n4; i += FB_THREADS)
            s_taps[i] = __ldg(src + i);
        __syncthreads();
        switch (nf) {
        case 1: run_pass<1>(s_in, s_taps, e, out, h, w, c, ch, support, y, x,
                            ty, tx, clamp); break;
        case 2: run_pass<2>(s_in, s_taps, e, out, h, w, c, ch, support, y, x,
                            ty, tx, clamp); break;
        case 3: run_pass<3>(s_in, s_taps, e, out, h, w, c, ch, support, y, x,
                            ty, tx, clamp); break;
        case 4: run_pass<4>(s_in, s_taps, e, out, h, w, c, ch, support, y, x,
                            ty, tx, clamp); break;
        default:
            if (WIDE == 2) {
                if (nf == 6)
                    run_pass<6>(s_in, s_taps, e, out, h, w, c, ch, support, y,
                                x, ty, tx, clamp);
                else if (nf == 8)
                    run_pass<8>(s_in, s_taps, e, out, h, w, c, ch, support, y,
                                x, ty, tx, clamp);
            }
        }
    }
}

// The whole bank in one launch.  `taps` and `table` as
// filters_cuda.pack_bank lays them out; (gx, gy) the grid
// (filters_cuda.grid_dims), checked against the image.
extern "C" int filter_bank(const void* img, const void* taps,
                           const void* table, void* out, int h, int w, int c,
                           int support, int n_pass, int wide, int gx, int gy,
                           float clamp, void* stream) {
    if (h < 1 || w < 1 || c < 1 || c > 65535 || n_pass < 1 || support < 1
        || support > FB_MAX_SUPPORT || support % 2 == 0
        || (wide != 1 && wide != 2) || gx != (w + FB_TW - 1) / FB_TW
        || gy != (h + FB_TH - 1) / FB_TH || gy > 65535)
        return (int)cudaErrorInvalidValue;
    static size_t set[64][2];              // dynamic shared memory allowed
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    const size_t smem = fb_smem(support, wide);
    const void* kernel = wide == 1 ? (const void*)filter_bank_kernel<1>
                                   : (const void*)filter_bank_kernel<2>;
    if (set[dev][wide - 1] < smem) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        set[dev][wide - 1] = smem;
    }
    const dim3 grid(gx, gy, c);
    cudaStream_t s = (cudaStream_t)stream;
    if (wide == 1)
        filter_bank_kernel<1><<<grid, FB_THREADS, smem, s>>>(
            (const float*)img, (const float4*)taps, (const int*)table,
            (float*)out, h, w, c, support, n_pass, clamp);
    else
        filter_bank_kernel<2><<<grid, FB_THREADS, smem, s>>>(
            (const float*)img, (const float4*)taps, (const int*)table,
            (float*)out, h, w, c, support, n_pass, clamp);
    return (int)cudaGetLastError();
}
