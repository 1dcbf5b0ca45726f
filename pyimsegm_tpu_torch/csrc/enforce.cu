// Connectivity enforcement: anchor seed, reach sweeps, absorb rounds.
//
// Replaces the TPU kernel enforce_fused_pallas (_enforce_fused_kernel) of
// pyimsegm_tpu/ops/enforce_pallas.py.  The contract is the JAX package's
// global XLA path (pyimsegm_tpu/ops/grid.py: enforce_grid_connectivity,
// _connect_components, _absorb_unreached), which the TPU kernel equals on a
// single band; the TPU kernel's bands and its cut scan windows were VMEM
// workarounds, and the card keeps the whole label plane in L2, so there are
// no bands here.  The plain twin is in pyimsegm_tpu_torch/ops/enforce_cuda.py.
//
// Bound: latency.  The seed reads 4 B of label and writes 13 B per pixel
// (d2, the label copy, the reach flag) once; the reach sweeps and absorb
// rounds are the cooperative kernel of enforce.cuh.
// Design: four launches per call.
//   seed  - one block per seed tile computes d2 per pixel (every operation
//           rounded on its own, no FMA contraction, so the 1e-3 threshold
//           sits where the twin's does), copies the labels to the output and
//           takes the tile's per-offset minimum (warp shuffles, then a shared
//           atomicMin on the float bits, which order like the floats for
//           d2 >= 0); one thread per seed takes the minimum over the 9 tiles
//           that route to it; one thread per pixel column of SEED_ROWS rows
//           applies the threshold.  The per-pixel d2min is read as the
//           reference's one-hot contraction reads it: an inf among the
//           tile's other 3x3 seeds (an empty superpixel) makes it NaN, and
//           the pixel is no anchor.  A thread loads all its labels before it
//           uses any, so that its L2 round trips overlap.
//   reach + absorb - one cooperative launch of enforce.cuh (shared with
//           csrc/connectivity.cu, rows 13 and 14).

#include <cuda_runtime.h>
#include <stdint.h>

#include "enforce.cuh"

#define NOFF 9
#define SEED_THREADS 256
#define SEED_BATCH 8          // tile pixels per thread per batch
#define SEED_ROWS 8           // rows per thread of the threshold
#define F_INF __int_as_float(0x7f800000)

__device__ __forceinline__ int window_code(int l, int y, int x, int gw,
                                           int step) {
    if (l < 0) return -1;
    const int oy = l / gw - y / step + 1, ox = l % gw - x / step + 1;
    return (oy >= 0 && oy < 3 && ox >= 0 && ox < 3) ? oy * 3 + ox : -1;
}

// The seed pass over the pixels p = 0 .. step^2 - 1 of tile (ty, tx), p
// counted in I: int where step^2 fits, else 64-bit (a step above 46340).
template <typename I>
__device__ __forceinline__ void seed_tile_pixels(
        const float* __restrict__ centers, const int* __restrict__ labels,
        int* __restrict__ copy, float* __restrict__ d2, int height, int width,
        int gw, int step, int k, int ty, int tx, float* local) {
    const I area = (I)step * step;
    for (I p0 = threadIdx.x; p0 < area; p0 += SEED_THREADS * SEED_BATCH) {
        int l[SEED_BATCH];
#pragma unroll
        for (int b = 0; b < SEED_BATCH; ++b) {
            const I p = p0 + SEED_THREADS * b;
            const int py = (int)(p / step);
            const int y = ty * step + py;
            const int x = tx * step + (int)(p - (I)py * step);
            l[b] = p < area && y < height && x < width
                ? labels[(size_t)y * width + x] : -1;
        }
#pragma unroll
        for (int b = 0; b < SEED_BATCH; ++b) {
            const I p = p0 + SEED_THREADS * b;
            const int py = (int)(p / step);
            const int y = ty * step + py;
            const int x = tx * step + (int)(p - (I)py * step);
            if (p >= area || y >= height || x >= width) continue;
            const size_t idx = (size_t)y * width + x;
            if (copy != nullptr) copy[idx] = l[b];
            const int o = window_code(l[b], y, x, gw, step);
            float cy = 0.0f, cx = 0.0f;
            if (o >= 0 && l[b] < k) {
                cy = centers[2 * (size_t)l[b]];
                cx = centers[2 * (size_t)l[b] + 1];
            }
            const float dy = __fsub_rn((float)y, cy);
            const float dx = __fsub_rn((float)x, cx);
            const float d = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
            d2[idx] = d;
#pragma unroll
            for (int oi = 0; oi < NOFF; ++oi)
                if (oi == o) local[oi] = fminf(local[oi], d);
        }
    }
}

__global__ void __launch_bounds__(SEED_THREADS)
seed_tile_min_kernel(const float* __restrict__ centers,  // (K, 2)
                     const int* __restrict__ labels,     // (H, W)
                     int* __restrict__ copy,             // (H, W) or null
                     float* __restrict__ d2,             // (H, W)
                     float* __restrict__ tile_min,       // (gh, gw, 9)
                     int height, int width, int gh, int gw, int step) {
    __shared__ unsigned int mins[NOFF];
    const int tx = blockIdx.x, ty = blockIdx.y;
    const int k = gh * gw;
    if (threadIdx.x < NOFF) mins[threadIdx.x] = 0x7f800000u;   // +inf
    __syncthreads();
    float local[NOFF];
#pragma unroll
    for (int o = 0; o < NOFF; ++o) local[o] = F_INF;
    if ((long long)step * step + SEED_THREADS * SEED_BATCH <= 0x7fffffffLL)
        seed_tile_pixels<int>(centers, labels, copy, d2, height, width, gw,
                              step, k, ty, tx, local);
    else
        seed_tile_pixels<long long>(centers, labels, copy, d2, height, width,
                                    gw, step, k, ty, tx, local);
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        float v = local[o];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
            v = fminf(v, __shfl_xor_sync(FULL, v, m));
        if ((threadIdx.x & 31) == 0) atomicMin(&mins[o], __float_as_uint(v));
    }
    __syncthreads();
    if (threadIdx.x < NOFF)
        tile_min[((size_t)ty * gw + tx) * NOFF + threadIdx.x] =
            __uint_as_float(mins[threadIdx.x]);
}

// One thread per seed: the minimum over the 9 (tile, offset) slots that
// route to it; +inf for an empty superpixel.
__global__ void seed_min_kernel(const float* __restrict__ tile_min,
                                float* __restrict__ d2min, int gh, int gw) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= gh * gw) return;
    const int y = s / gw, x = s % gw;
    float m = F_INF;
    for (int o = 0; o < NOFF; ++o) {
        const int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
        m = fminf(m, tile_min[((size_t)sy * gw + sx) * NOFF + o]);
    }
    d2min[s] = m;
}

// One thread per pixel column of SEED_ROWS rows (grid-stride over row
// groups past 65535).
__global__ void reach0_kernel(const int* __restrict__ labels,
                              const float* __restrict__ d2,
                              const float* __restrict__ d2min,
                              uint8_t* __restrict__ reached,
                              int height, int width, int gh, int gw,
                              int step) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= width) return;
    const int tx = x / step;
    for (int y0 = blockIdx.y * SEED_ROWS; y0 < height;
         y0 += gridDim.y * SEED_ROWS) {
        int l[SEED_ROWS];
        float d[SEED_ROWS];
#pragma unroll
        for (int b = 0; b < SEED_ROWS; ++b) {
            const size_t i = (size_t)(y0 + b) * width + x;
            l[b] = y0 + b < height ? labels[i] : -1;
            d[b] = y0 + b < height ? d2[i] : 0.0f;
        }
#pragma unroll
        for (int b = 0; b < SEED_ROWS; ++b) {
            const int y = y0 + b;
            if (y >= height) continue;
            const int ty = y / step;
            const int o = window_code(l[b], y, x, gw, step);
            // sum_o onehot[o] * d2min[seed o]: the own slot's value, NaN
            // when any other on-grid slot is inf (0 * inf), 0 off the grid
            // or out of window
            float own = 0.0f;
            bool nan = false;
            for (int oi = 0; oi < NOFF; ++oi) {
                const int sy = ty + oi / 3 - 1, sx = tx + oi % 3 - 1;
                if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
                const float v = d2min[sy * gw + sx];
                if (oi == o) own = v;
                else if (isinf(v)) nan = true;
            }
            reached[(size_t)y * width + x] =
                (!nan && d[b] <= __fadd_rn(own, 1e-3f)) ? 1 : 0;
        }
    }
}

// The anchor seed: d2, the per-tile minima, the per-seed minima and the
// reached plane: three kernels on one stream; the first also copies the
// labels to 'copy' when it is given.  Returns a CUDA error code.
static int launch_seed(const float* centers, const int* lab, int* copy,
                       uint8_t* rch, float* d2, float* tile_min,
                       float* d2min, int height, int width, int gh, int gw,
                       int step, cudaStream_t st) {
    const int k = gh * gw;
    const int row_groups = (height + SEED_ROWS - 1) / SEED_ROWS;
    seed_tile_min_kernel<<<dim3(gw, gh), SEED_THREADS, 0, st>>>(
        centers, lab, copy, d2, tile_min, height, width, gh, gw, step);
    seed_min_kernel<<<(k + 127) / 128, 128, 0, st>>>(tile_min, d2min, gh, gw);
    reach0_kernel<<<dim3((width + 127) / 128,
                         row_groups < 65535 ? row_groups : 65535),
                    128, 0, st>>>(lab, d2, d2min, rch, height, width, gh, gw,
                                  step);
    return (int)cudaGetLastError();
}

// The anchor seed alone (the seed of rows 13 and 14): reached (H, W) u8.
extern "C" int anchor_seed(const void* centers, const void* labels,
                           void* reached, void* d2, void* tile_min,
                           void* d2min, int height, int width, int gh, int gw,
                           int step, void* stream) {
    return launch_seed((const float*)centers, (const int*)labels, nullptr,
                       (uint8_t*)reached, (float*)d2, (float*)tile_min,
                       (float*)d2min, height, width, gh, gw, step,
                       (cudaStream_t)stream);
}

// Seed, then reach + absorb in one cooperative launch.  The enforced labels
// go to 'out'; flags holds max_sweeps + 1 + n_rounds + 1 ints, zeroed by
// the cooperative kernel.
extern "C" int enforce_fused(const void* centers, const void* labels,
                             void* out, void* reached, void* d2,
                             void* tile_min, void* d2min, void* flags,
                             int height, int width, int gh, int gw, int step,
                             int pack, int max_sweeps, int n_rounds,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int err = launch_seed(
        (const float*)centers, (const int*)labels, (int*)out,
        (uint8_t*)reached, (float*)d2, (float*)tile_min, (float*)d2min,
        height, width, gh, gw, step, st);
    if (err) return err;
    const PassArgs a = {(int*)out, (uint8_t*)reached, (int*)flags, height,
                        width, gw, step, pack, max_sweeps, n_rounds};
    return launch_reach_absorb<true, true>(a, st);
}
