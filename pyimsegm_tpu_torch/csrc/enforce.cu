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
// Bound: launch count and L2 latency.  The seed reads 4 B of label and
// writes 9 B per pixel once; a reach sweep or absorb round reads 5 B per
// pixel per direction (all in L2 at the bench size), and a converged one
// returns at once.
// Design:
//   seed  - one block per seed tile computes d2 per pixel (every operation
//           rounded on its own, no FMA contraction, so the 1e-3 threshold
//           sits where the twin's does) and the tile's per-offset minimum
//           (warp shuffles, then a shared atomicMin on the float bits, which
//           order like the floats for d2 >= 0); one thread per seed takes
//           the minimum over the 9 tiles that route to it; one thread per
//           pixel applies the threshold.  The per-pixel d2min is read as the
//           reference's one-hot contraction reads it: an inf among the
//           tile's other 3x3 seeds (an empty superpixel) makes it NaN, and
//           the pixel is no anchor.
//   lines - one warp per row (or column), the line scans of lines.cuh
//           (shared with csrc/connectivity.cu, rows 13 and 14).
//   caps  - the host enqueues every sweep (MAX_SWEEPS) and round (2*step)
//           up to the reference's caps; flags[i] != 0 says round i-1
//           changed something, so a converged launch returns at once and
//           the result equals the reference's early exit exactly, with no
//           host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lines.cuh"

#define NOFF 9
#define SEED_THREADS 256

__device__ __forceinline__ int window_code(int l, int y, int x, int gw,
                                           int step) {
    if (l < 0) return -1;
    const int oy = l / gw - y / step + 1, ox = l % gw - x / step + 1;
    return (oy >= 0 && oy < 3 && ox >= 0 && ox < 3) ? oy * 3 + ox : -1;
}

__global__ void __launch_bounds__(SEED_THREADS)
seed_tile_min_kernel(const float* __restrict__ centers,  // (K, 2)
                     const int* __restrict__ labels,     // (H, W)
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
    for (int o = 0; o < NOFF; ++o) local[o] = __int_as_float(0x7f800000);
    for (int p = threadIdx.x; p < step * step; p += SEED_THREADS) {
        const int y = ty * step + p / step, x = tx * step + p % step;
        if (y >= height || x >= width) continue;
        const size_t idx = (size_t)y * width + x;
        const int l = labels[idx];
        const int o = window_code(l, y, x, gw, step);
        float cy = 0.0f, cx = 0.0f;
        if (o >= 0 && l < k) {
            cy = centers[2 * (size_t)l];
            cx = centers[2 * (size_t)l + 1];
        }
        const float dy = __fsub_rn((float)y, cy), dx = __fsub_rn((float)x, cx);
        const float d = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
        d2[idx] = d;
#pragma unroll
        for (int oi = 0; oi < NOFF; ++oi)
            if (oi == o) local[oi] = fminf(local[oi], d);
    }
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
    float m = __int_as_float(0x7f800000);
    for (int o = 0; o < NOFF; ++o) {
        const int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
        m = fminf(m, tile_min[((size_t)sy * gw + sx) * NOFF + o]);
    }
    d2min[s] = m;
}

__global__ void reach0_kernel(const int* __restrict__ labels,
                              const float* __restrict__ d2,
                              const float* __restrict__ d2min,
                              uint8_t* __restrict__ reached,
                              int height, int width, int gh, int gw, int step) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * width) return;
    const int y = (int)(i / width), x = (int)(i % width);
    const int ty = y / step, tx = x / step;
    const int o = window_code(labels[i], y, x, gw, step);
    // sum_o onehot[o] * d2min[seed o]: the own slot's value, NaN when any
    // other on-grid slot is inf (0 * inf), 0 off the grid or out of window
    float own = 0.0f;
    bool nan = false;
    for (int oi = 0; oi < NOFF; ++oi) {
        const int sy = ty + oi / 3 - 1, sx = tx + oi % 3 - 1;
        if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
        const float v = d2min[sy * gw + sx];
        if (oi == o) own = v;
        else if (isinf(v)) nan = true;
    }
    reached[i] = (!nan && d2[i] <= __fadd_rn(own, 1e-3f)) ? 1 : 0;
}

// Reach (ABSORB false) or absorb (ABSORB true) along every line, forward
// then reverse; a launch returns at once when flag_in says the previous
// sweep or round changed nothing.
template <bool ABSORB>
__global__ void __launch_bounds__(LINE_WARPS * 32)
line_pass_kernel(int* __restrict__ labels, uint8_t* __restrict__ reached,
                 const int* __restrict__ flag_in, int* __restrict__ flag_out,
                 int n_lines, int len, int line_stride, int elem_stride,
                 int rows, int gw, int step, int pack) {
    if (flag_in != nullptr && *(volatile const int*)flag_in == 0) return;
    const int line = blockIdx.x * LINE_WARPS + (threadIdx.x >> 5);
    if (line >= n_lines) return;                 // uniform across the warp
    if (line_pass<ABSORB>(labels, reached, line, len, line_stride,
                          elem_stride, rows, gw, step, pack)
            && (threadIdx.x & 31) == 0)
        *flag_out = 1;
}

template <bool ABSORB>
static void launch_sweep(int* labels, uint8_t* reached, const int* flag_in,
                         int* flag_out, int height, int width, int gw,
                         int step, int pack, cudaStream_t st) {
    const int threads = LINE_WARPS * 32;
    line_pass_kernel<ABSORB><<<(height + LINE_WARPS - 1) / LINE_WARPS,
                               threads, 0, st>>>(
        labels, reached, flag_in, flag_out, height, width, width, 1, 1, gw,
        step, pack);
    line_pass_kernel<ABSORB><<<(width + LINE_WARPS - 1) / LINE_WARPS,
                               threads, 0, st>>>(
        labels, reached, flag_in, flag_out, width, height, 1, width, 0, gw,
        step, pack);
}

// The anchor seed: d2, the per-tile minima, the per-seed minima and the
// reached plane: three kernels on one stream.
static void launch_seed(const float* centers, const int* lab, uint8_t* rch,
                        float* d2, float* tile_min, float* d2min, int height,
                        int width, int gh, int gw, int step, cudaStream_t st) {
    const int k = gh * gw;
    const size_t n = (size_t)height * width;
    seed_tile_min_kernel<<<dim3(gw, gh), SEED_THREADS, 0, st>>>(
        centers, lab, d2, tile_min, height, width, gh, gw, step);
    seed_min_kernel<<<(k + 127) / 128, 128, 0, st>>>(tile_min, d2min, gh, gw);
    reach0_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        lab, d2, d2min, rch, height, width, gh, gw, step);
}

// The anchor seed alone (the seed of rows 13 and 14): reached (H, W) u8.
extern "C" int anchor_seed(const void* centers, const void* labels,
                           void* reached, void* d2, void* tile_min,
                           void* d2min, int height, int width, int gh, int gw,
                           int step, void* stream) {
    launch_seed((const float*)centers, (const int*)labels, (uint8_t*)reached,
                (float*)d2, (float*)tile_min, (float*)d2min, height, width,
                gh, gw, step, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// labels is enforced in place.  flags holds max_sweeps + 1 + n_rounds + 1
// zeroed ints.
extern "C" int enforce_fused(const void* centers, void* labels, void* reached,
                             void* d2, void* tile_min, void* d2min,
                             void* flags, int height, int width, int gh,
                             int gw, int step, int pack, int max_sweeps,
                             int n_rounds, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int* lab = (int*)labels;
    uint8_t* rch = (uint8_t*)reached;
    int* fl = (int*)flags;
    launch_seed((const float*)centers, lab, rch, (float*)d2,
                (float*)tile_min, (float*)d2min, height, width, gh, gw, step,
                st);
    for (int s = 0; s < max_sweeps; ++s)
        launch_sweep<false>(lab, rch, s == 0 ? nullptr : fl + s, fl + s + 1,
                            height, width, gw, step, pack, st);
    int* af = fl + max_sweeps + 1;
    for (int i = 0; i < n_rounds; ++i)
        launch_sweep<true>(lab, rch, i == 0 ? nullptr : af + i, af + i + 1,
                           height, width, gw, step, pack, st);
    return (int)cudaGetLastError();
}
