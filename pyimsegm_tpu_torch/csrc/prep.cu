// SLIC preprocessing: sigma=1 Gaussian blur + [0,1] rescale + sRGB->CIE Lab.
//
// Replaces the TPU kernel pyimsegm_tpu/ops/prep_pallas.py:blur_lab_pallas
// (_prep_kernel).  Same arithmetic as the plain twin
// pyimsegm_tpu_torch/ops/prep_cuda.py:_blur_lab_plain, which follows
// pyimsegm_tpu/ops/slic.py:_prepare_image: a 9-tap separable blur under
// numpy 'symmetric' padding, vertical pass first, each pass summing its taps
// in order; then (v - lo) / max(hi - lo, 1e-12); then the exp/log Lab forms.
//
// Bound: device memory.  Per pixel 12 B are read (f32 RGB) and 6 B written
// (bf16 Lab planes); the 18 multiply-adds and ~6 transcendentals per pixel
// are far below the card's compute rate.
// Design: one block per 32x32 output tile.  The block stages its tile plus a
// 4-px halo (40x40x3 f32) in shared memory once, so every input pixel is
// read from device memory about 1.6 times; the vertical pass goes to a
// second shared buffer (32x40x3) and the horizontal pass and the colour
// conversion run in registers.  Products and sums use __fmul_rn/__fadd_rn so
// the compiler does not contract them into FMAs: the result then matches
// the plain twin's separately rounded operations bit for bit, apart from the
// last ulp of expf/logf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define TILE 32
#define RADIUS 4
#define HALO (TILE + 2 * RADIUS)
#define NTAPS (2 * RADIUS + 1)

// numpy 'symmetric' padding: d c b a | a b c d | d c b a
__device__ __forceinline__ int reflect(int i, int n) {
    while (i < 0 || i >= n) {
        if (i < 0) i = -i - 1;
        if (i >= n) i = 2 * n - i - 1;
    }
    return i;
}

__device__ __forceinline__ float srgb_to_linear(float v) {
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    float big = expf(__fmul_rn(2.4f, logf(fmaxf(__fdiv_rn(__fadd_rn(v, 0.055f), 1.055f), 1e-30f))));
    return v > 0.04045f ? big : __fdiv_rn(v, 12.92f);
}

__device__ __forceinline__ float lab_f(float t) {
    const float eps = (float)((6.0 / 29.0) * (6.0 / 29.0) * (6.0 / 29.0));
    const float den = (float)(3.0 * (6.0 / 29.0) * (6.0 / 29.0));
    const float off = (float)(4.0 / 29.0);
    float cbrt = expf(__fdiv_rn(logf(fmaxf(t, 1e-30f)), 3.0f));
    return t > eps ? cbrt : __fadd_rn(__fdiv_rn(t, den), off);
}

__global__ void blur_lab_kernel(const float* __restrict__ img,   // (H, W, 3)
                                const float* __restrict__ lohi,  // [lo, hi]
                                const float* __restrict__ taps,  // (9,)
                                __nv_bfloat16* __restrict__ out, // (3, H, W)
                                int h, int w) {
    __shared__ float src[HALO][HALO][3];
    __shared__ float vert[TILE][HALO][3];
    __shared__ float k[NTAPS];
    const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;
    if (tid < NTAPS) k[tid] = taps[tid];
    for (int i = tid; i < HALO * HALO; i += nthr) {
        int sy = reflect(y0 - RADIUS + i / HALO, h);
        int sx = reflect(x0 - RADIUS + i % HALO, w);
        const float* p = img + ((size_t)sy * w + sx) * 3;
        src[i / HALO][i % HALO][0] = p[0];
        src[i / HALO][i % HALO][1] = p[1];
        src[i / HALO][i % HALO][2] = p[2];
    }
    __syncthreads();
    // vertical taps (axis 0 first, as gaussian_blur does)
    for (int i = tid; i < TILE * HALO; i += nthr) {
        int r = i / HALO, c = i % HALO;
        for (int ch = 0; ch < 3; ++ch) {
            float acc = __fmul_rn(k[0], src[r][c][ch]);
            for (int t = 1; t < NTAPS; ++t)
                acc = __fadd_rn(acc, __fmul_rn(k[t], src[r + t][c][ch]));
            vert[r][c][ch] = acc;
        }
    }
    __syncthreads();
    const float lo = lohi[0];
    const float rng = fmaxf(__fsub_rn(lohi[1], lo), 1e-12f);
    for (int i = tid; i < TILE * TILE; i += nthr) {
        int r = i / TILE, c = i % TILE;
        int y = y0 + r, x = x0 + c;
        if (y >= h || x >= w) continue;
        float lin[3];
        for (int ch = 0; ch < 3; ++ch) {
            float acc = __fmul_rn(k[0], vert[r][c][ch]);
            for (int t = 1; t < NTAPS; ++t)
                acc = __fadd_rn(acc, __fmul_rn(k[t], vert[r][c + t][ch]));
            lin[ch] = srgb_to_linear(__fdiv_rn(__fsub_rn(acc, lo), rng));
        }
        float X = __fadd_rn(__fadd_rn(__fmul_rn(0.412453f, lin[0]), __fmul_rn(0.357580f, lin[1])),
                            __fmul_rn(0.180423f, lin[2]));
        float Y = __fadd_rn(__fadd_rn(__fmul_rn(0.212671f, lin[0]), __fmul_rn(0.715160f, lin[1])),
                            __fmul_rn(0.072169f, lin[2]));
        float Z = __fadd_rn(__fadd_rn(__fmul_rn(0.019334f, lin[0]), __fmul_rn(0.119193f, lin[1])),
                            __fmul_rn(0.950227f, lin[2]));
        float fx = lab_f(__fdiv_rn(X, 0.95047f));
        float fy = lab_f(Y);
        float fz = lab_f(__fdiv_rn(Z, 1.08883f));
        size_t plane = (size_t)h * w, o = (size_t)y * w + x;
        out[o] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(116.0f, fy), 16.0f));
        out[plane + o] = __float2bfloat16_rn(__fmul_rn(500.0f, __fsub_rn(fx, fy)));
        out[2 * plane + o] = __float2bfloat16_rn(__fmul_rn(200.0f, __fsub_rn(fy, fz)));
    }
}

extern "C" int blur_lab(const void* img, const void* lohi, const void* taps,
                        void* out, int h, int w, void* stream) {
    dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
    dim3 block(32, 8);
    blur_lab_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)lohi, (const float*)taps,
        (__nv_bfloat16*)out, h, w);
    return (int)cudaGetLastError();
}
