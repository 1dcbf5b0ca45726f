// SLIC preprocessing: sigma=1 Gaussian blur + [0,1] rescale + sRGB->CIE Lab.
//
// Replaces the TPU kernel pyimsegm_tpu/ops/prep_pallas.py:blur_lab_pallas
// (_prep_kernel), with the global min / max it takes first.  Same arithmetic
// as the plain twin pyimsegm_tpu_torch/ops/prep_cuda.py:_blur_lab_plain,
// which follows pyimsegm_tpu/ops/slic.py:_prepare_image: lo / hi of the raw
// image (NaN when any pixel is NaN, as torch.aminmax); a 9-tap separable
// blur under numpy 'symmetric' padding, vertical pass first, each pass
// summing its taps in order; then (v - lo) / max(hi - lo, 1e-12); then the
// exp/log Lab forms.
//
// Bound: instruction issue.  Per pixel 12 B are read (f32 RGB, twice: the
// second read hits L2) and 6 B written (bf16 Lab planes): 5.7 us at
// 884x1200 at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W).  The
// separately rounded blur (2 x 3 x 17 operations), six accurate expf / logf
// and nine IEEE divisions cost ~590 issued instructions a pixel in the
// SASS: 18.7 us at 884x1200 on the same card, issuing from 528 schedulers
// at 1.98 GHz (PERF.md).
// Design: two launches, no host-to-device copy.  minmax_kernel reads the
// image once with 16-byte loads and writes one (lo, hi) partial per block;
// the taps go by value as kernel parameters.  blur_lab_kernel takes one
// output tile per block: it stages the tile's reflected row and column
// indices once; each thread runs a vertical strip of PREP_S outputs of one
// halo column from a register window (each input read once per strip, no
// shared reads) into a shared (3, PREP_TH, TW + 8) buffer; the block then
// reduces the min / max partials (2 KB from L2); then each thread takes 4
// neighbouring outputs of a row, reads their 12-wide window of every
// channel as three 16-byte shared loads, runs the horizontal taps and the
// Lab conversion in registers and stores each plane's 4 bf16 as one 8-byte
// word where the width allows.  Products and sums use __fmul_rn/__fadd_rn
// so the compiler does not contract them into FMAs: the result then matches
// the twin's separately rounded operations bit for bit, apart from the last
// ulp of expf/logf.  The two arms of each select are branches, so a warp
// runs an arm only where one of its lanes takes it.  Divisions stay
// __fdiv_rn: the three-FMA form by a rounded reciprocal gave the same bits
// for every f32 input at each constant divisor (tools/ab_kernels.py
// --kernel prep) but no faster kernel in same-call A/Bs (PERF.md).  Tiles
// are PREP_TW columns wide, and PREP_TW_WIDE from PREP_WIDE_PIXELS pixels
// on (fewer halo columns; at 884x1200 the narrow tile's grid leaves a
// smaller last wave).

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define RADIUS 4
#define NTAPS (2 * RADIUS + 1)
// blur + Lab: output tile columns (PREP_TW_WIDE from PREP_WIDE_PIXELS
// pixels on) and rows, rows of a thread's vertical strip, block threads and
// blocks an SM must hold (same-call A/Bs, PERF.md)
#define PREP_TW 32
#define PREP_TW_WIDE 64
#define PREP_WIDE_PIXELS 4194304
#define PREP_TH 32
#define PREP_S 8
#define PREP_THREADS 256
#define PREP_MIN_BLOCKS 4
// min / max: block threads and the most blocks (one partial each)
#define MM_THREADS 512
#define MM_BLOCKS 256
#define FULL 0xffffffffu

constexpr int RUN = 4;                       // outputs of a thread's row run
static_assert(PREP_TW % RUN == 0 && PREP_TW_WIDE % RUN == 0
              && PREP_TH % PREP_S == 0, "tile");
static_assert(PREP_THREADS >= PREP_TH + 4 * RADIUS + PREP_TW_WIDE,
              "index tables");

struct Taps {
    float k[NTAPS];
};

// numpy 'symmetric' padding: d c b a | a b c d | d c b a
__device__ __forceinline__ int reflect(int i, int n) {
    while (i < 0 || i >= n) {
        if (i < 0) i = -i - 1;
        if (i >= n) i = 2 * n - i - 1;
    }
    return i;
}

// torch.clamp(v, 0, 1): a NaN stays NaN
__device__ __forceinline__ float clamp01(float v) {
    v = v < 0.0f ? 0.0f : v;
    return v > 1.0f ? 1.0f : v;
}

// The arms of a select are branches: a warp whose lanes all take one arm
// skips the other; a divergent warp runs both, one after the other.
__device__ __forceinline__ float srgb_to_linear(float v) {
    v = clamp01(v);
    if (v > 0.04045f)
        return expf(__fmul_rn(2.4f, logf(fmaxf(
            __fdiv_rn(__fadd_rn(v, 0.055f), 1.055f), 1e-30f))));
    return __fdiv_rn(v, 12.92f);
}

__device__ __forceinline__ float lab_f(float t) {
    const float eps = (float)((6.0 / 29.0) * (6.0 / 29.0) * (6.0 / 29.0));
    const float den = (float)(3.0 * (6.0 / 29.0) * (6.0 / 29.0));
    const float off = (float)(4.0 / 29.0);
    if (t > eps) return expf(__fdiv_rn(logf(fmaxf(t, 1e-30f)), 3.0f));
    return __fadd_rn(__fdiv_rn(t, den), off);
}

// One (lo, hi) partial per block, (NaN, NaN) where the block saw a NaN.
__device__ __forceinline__ void reduce_minmax(float& lo, float& hi, bool& nan,
                                              float* s_lo, float* s_hi,
                                              int* s_nan) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(FULL, lo, m));
        hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, m));
    }
    nan = __any_sync(FULL, nan);
    if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x >> 5] = lo;
        s_hi[threadIdx.x >> 5] = hi;
        s_nan[threadIdx.x >> 5] = nan;
    }
}

__device__ __forceinline__ void add_minmax(float v, float& lo, float& hi,
                                           bool& nan) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
    nan |= v != v;
}

template <bool VEC>
__global__ void __launch_bounds__(MM_THREADS)
minmax_kernel(const float* __restrict__ img, long long n,
              float2* __restrict__ part) {
    __shared__ float s_lo[MM_THREADS / 32], s_hi[MM_THREADS / 32];
    __shared__ int s_nan[MM_THREADS / 32];
    float lo = INFINITY, hi = -INFINITY;
    bool nan = false;
    const long long stride = (long long)gridDim.x * MM_THREADS;
    const long long first = (long long)blockIdx.x * MM_THREADS + threadIdx.x;
    long long i = first;
    if (VEC) {
        const float4* p = reinterpret_cast<const float4*>(img);
        const long long n4 = n >> 2;
        for (; i + 3 * stride < n4; i += 4 * stride) {   // 4 loads in flight
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = __ldg(p + i + u * stride);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                add_minmax(v[u].x, lo, hi, nan);
                add_minmax(v[u].y, lo, hi, nan);
                add_minmax(v[u].z, lo, hi, nan);
                add_minmax(v[u].w, lo, hi, nan);
            }
        }
        for (; i < n4; i += stride) {
            const float4 v = __ldg(p + i);
            add_minmax(v.x, lo, hi, nan);
            add_minmax(v.y, lo, hi, nan);
            add_minmax(v.z, lo, hi, nan);
            add_minmax(v.w, lo, hi, nan);
        }
        i = (n4 << 2) + first;
    }
    for (; i < n; i += stride) add_minmax(__ldg(img + i), lo, hi, nan);
    reduce_minmax(lo, hi, nan, s_lo, s_hi, s_nan);
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < MM_THREADS / 32; ++k) {
            lo = fminf(lo, s_lo[k]);
            hi = fmaxf(hi, s_hi[k]);
            nan |= s_nan[k] != 0;
        }
        part[blockIdx.x] = nan ? make_float2(NAN, NAN) : make_float2(lo, hi);
    }
}

template <int TW>
__global__ void __launch_bounds__(PREP_THREADS, PREP_MIN_BLOCKS)
blur_lab_kernel(const float* __restrict__ img,     // (H, W, 3)
                const float2* __restrict__ part,   // (nparts,) (lo, hi)
                int nparts, const Taps taps,
                __nv_bfloat16* __restrict__ out,   // (3, H, W)
                int h, int w) {
    constexpr int HWID = TW + 2 * RADIUS;     // staged columns of a tile
    __shared__ __align__(16) float vert[3][PREP_TH][HWID];
    __shared__ int rows[PREP_TH + 2 * RADIUS], cols[HWID];
    __shared__ float s_lo[PREP_THREADS / 32], s_hi[PREP_THREADS / 32];
    __shared__ int s_nan[PREP_THREADS / 32];
    const int tid = threadIdx.x;
    const int y0 = blockIdx.y * PREP_TH, x0 = blockIdx.x * TW;
    if (tid < PREP_TH + 2 * RADIUS)
        rows[tid] = reflect(y0 - RADIUS + tid, h);
    else if (tid < PREP_TH + 2 * RADIUS + HWID)
        cols[tid - PREP_TH - 2 * RADIUS] =
            reflect(x0 - RADIUS + tid - PREP_TH - 2 * RADIUS, w);
    __syncthreads();
    // vertical taps (axis 0 first, as gaussian_blur does): a strip of
    // PREP_S outputs of one halo column a task, its PREP_S + 8 inputs of a
    // channel in registers
    const size_t w3 = (size_t)3 * w;
    for (int t = tid; t < HWID * (PREP_TH / PREP_S); t += PREP_THREADS) {
        const int c = t % HWID, r0 = t / HWID * PREP_S;
        const float* col = img + 3 * cols[c];
        size_t off[PREP_S + 2 * RADIUS];
#pragma unroll
        for (int j = 0; j < PREP_S + 2 * RADIUS; ++j)
            off[j] = rows[r0 + j] * w3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            float v[PREP_S + 2 * RADIUS];
#pragma unroll
            for (int j = 0; j < PREP_S + 2 * RADIUS; ++j)
                v[j] = __ldg(col + off[j] + ch);
#pragma unroll
            for (int i = 0; i < PREP_S; ++i) {
                float acc = __fmul_rn(taps.k[0], v[i]);
#pragma unroll
                for (int k = 1; k < NTAPS; ++k)
                    acc = __fadd_rn(acc, __fmul_rn(taps.k[k], v[i + k]));
                vert[ch][r0 + i][c] = acc;
            }
        }
    }
    // lo / hi from the min / max partials
    float lo = INFINITY, hi = -INFINITY;
    bool nan = false;
    for (int i = tid; i < nparts; i += PREP_THREADS) {
        const float2 p = part[i];
        lo = fminf(lo, p.x);
        hi = fmaxf(hi, p.y);
        nan |= p.x != p.x;
    }
    reduce_minmax(lo, hi, nan, s_lo, s_hi, s_nan);
    __syncthreads();
    for (int k = 0; k < PREP_THREADS / 32; ++k) {
        lo = fminf(lo, s_lo[k]);
        hi = fmaxf(hi, s_hi[k]);
        nan |= s_nan[k] != 0;
    }
    if (nan) lo = hi = NAN;
    const float d = __fsub_rn(hi, lo);
    const float rng = d < 1e-12f ? 1e-12f : d;     // torch.clamp_min
    const size_t plane = (size_t)h * w;
    const bool quad = (w & 3) == 0;
    // horizontal taps + rescale + Lab: RUN neighbouring outputs of a row a
    // task
    for (int t = tid; t < PREP_TH * (TW / RUN); t += PREP_THREADS) {
        const int r = t / (TW / RUN), c0 = t % (TW / RUN) * RUN;
        float lin[3][RUN];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            float u[RUN + 2 * RADIUS];
            const float4* src = reinterpret_cast<const float4*>(
                &vert[ch][r][c0]);
#pragma unroll
            for (int q = 0; q < (RUN + 2 * RADIUS) / 4; ++q) {
                const float4 f = src[q];
                u[4 * q] = f.x;
                u[4 * q + 1] = f.y;
                u[4 * q + 2] = f.z;
                u[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int i = 0; i < RUN; ++i) {
                float acc = __fmul_rn(taps.k[0], u[i]);
#pragma unroll
                for (int k = 1; k < NTAPS; ++k)
                    acc = __fadd_rn(acc, __fmul_rn(taps.k[k], u[i + k]));
                lin[ch][i] = srgb_to_linear(
                    __fdiv_rn(__fsub_rn(acc, lo), rng));
            }
        }
        float lab[3][RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
            const float X = __fadd_rn(__fadd_rn(__fmul_rn(0.412453f, lin[0][i]),
                                                __fmul_rn(0.357580f, lin[1][i])),
                                      __fmul_rn(0.180423f, lin[2][i]));
            const float Y = __fadd_rn(__fadd_rn(__fmul_rn(0.212671f, lin[0][i]),
                                                __fmul_rn(0.715160f, lin[1][i])),
                                      __fmul_rn(0.072169f, lin[2][i]));
            const float Z = __fadd_rn(__fadd_rn(__fmul_rn(0.019334f, lin[0][i]),
                                                __fmul_rn(0.119193f, lin[1][i])),
                                      __fmul_rn(0.950227f, lin[2][i]));
            const float fx = lab_f(__fdiv_rn(X, 0.95047f));
            const float fy = lab_f(Y);
            const float fz = lab_f(__fdiv_rn(Z, 1.08883f));
            lab[0][i] = __fsub_rn(__fmul_rn(116.0f, fy), 16.0f);
            lab[1][i] = __fmul_rn(500.0f, __fsub_rn(fx, fy));
            lab[2][i] = __fmul_rn(200.0f, __fsub_rn(fy, fz));
        }
        const int y = y0 + r, x = x0 + c0;
        if (y >= h) continue;
        const size_t o = (size_t)y * w + x;
        if (quad && x + RUN <= w) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                __nv_bfloat162 lo2 = __floats2bfloat162_rn(lab[ch][0], lab[ch][1]);
                __nv_bfloat162 hi2 = __floats2bfloat162_rn(lab[ch][2], lab[ch][3]);
                uint2 word;
                word.x = *reinterpret_cast<unsigned int*>(&lo2);
                word.y = *reinterpret_cast<unsigned int*>(&hi2);
                *reinterpret_cast<uint2*>(out + ch * plane + o) = word;
            }
        } else {
#pragma unroll
            for (int i = 0; i < RUN; ++i) {
                if (x + i >= w) break;
#pragma unroll
                for (int ch = 0; ch < 3; ++ch)
                    out[ch * plane + o + i] = __float2bfloat16_rn(lab[ch][i]);
            }
        }
    }
}

// img (H, W, 3) f32, part (max_parts, 2) f32 scratch, out (3, H, W) bf16;
// k0..k8 the blur taps.  Two launches.
extern "C" int blur_lab(const void* img, void* part, void* out, int h, int w,
                        int max_parts, float k0, float k1, float k2, float k3,
                        float k4, float k5, float k6, float k7, float k8,
                        void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long n = (long long)h * w * 3;
    const long long per_block = (long long)MM_THREADS * 16;
    int blocks = (int)((n + per_block - 1) / per_block);
    blocks = blocks < max_parts ? blocks : max_parts;
    blocks = blocks < MM_BLOCKS ? blocks : MM_BLOCKS;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)img & 15) == 0)
        minmax_kernel<true><<<blocks, MM_THREADS, 0, st>>>(
            (const float*)img, n, (float2*)part);
    else
        minmax_kernel<false><<<blocks, MM_THREADS, 0, st>>>(
            (const float*)img, n, (float2*)part);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    const Taps taps = {{k0, k1, k2, k3, k4, k5, k6, k7, k8}};
    const unsigned int gy = (h + PREP_TH - 1) / PREP_TH;
    if ((long long)h * w < PREP_WIDE_PIXELS)
        blur_lab_kernel<PREP_TW><<<dim3((w + PREP_TW - 1) / PREP_TW, gy),
                                   PREP_THREADS, 0, st>>>(
            (const float*)img, (const float2*)part, blocks, taps,
            (__nv_bfloat16*)out, h, w);
    else
        blur_lab_kernel<PREP_TW_WIDE><<<
            dim3((w + PREP_TW_WIDE - 1) / PREP_TW_WIDE, gy), PREP_THREADS, 0,
            st>>>((const float*)img, (const float2*)part, blocks, taps,
                  (__nv_bfloat16*)out, h, w);
    return (int)cudaGetLastError();
}
