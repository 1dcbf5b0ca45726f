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
//   lines - one warp per row (or column).  The warp walks the line in
//           32-pixel segments; each lane owns one pixel of a segment, warp
//           shuffles give the segment's inclusive max/min scan, and the
//           segment's last value carries into the next.  A lane reads and
//           writes only its own pixels, in the forward and the reverse walk
//           alike, so no memory is shared between lanes.  Reach: a pixel
//           joins when the nearest reached position behind it (ahead of it)
//           lies in its own same-label run (the scan of run starts/ends).
//           Absorb: the nearest reached pixel's packed (position, label)
//           is the max scan of pos*pack + label (forward) or
//           -pos*pack + label (reverse); the label comes back by floor-mod,
//           written as '& (pack - 1)' since pack is a power of two (C's '%'
//           truncates toward zero).
//   caps  - the host enqueues every sweep (MAX_SWEEPS) and round (2*step)
//           up to the reference's caps; flags[i] != 0 says round i-1
//           changed something, so a converged launch returns at once and
//           the result equals the reference's early exit exactly, with no
//           host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#define NOFF 9
#define FULL 0xffffffffu
#define SEED_THREADS 256
#define LINE_WARPS 8
#define POS_INF (1 << 30)
#define PACK_NONE (-(1 << 30))

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

__device__ __forceinline__ int scan_max_up(int v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v = max(v, o);
    }
    return v;
}

__device__ __forceinline__ int scan_min_down(int v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_down_sync(FULL, v, d);
        if (lane + d < 32) v = min(v, o);
    }
    return v;
}

__device__ __forceinline__ int scan_max_down(int v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_down_sync(FULL, v, d);
        if (lane + d < 32) v = max(v, o);
    }
    return v;
}

// Reach (ABSORB false) or absorb (ABSORB true) along every line, forward
// then reverse.  Lines are rows (rows = 1: line = y, pos = x) or columns
// (rows = 0: line = x, pos = y).
template <bool ABSORB>
__global__ void __launch_bounds__(LINE_WARPS * 32)
line_pass_kernel(int* __restrict__ labels, uint8_t* __restrict__ reached,
                 const int* __restrict__ flag_in, int* __restrict__ flag_out,
                 int n_lines, int len, int line_stride, int elem_stride,
                 int rows, int gw, int step, int pack) {
    if (flag_in != nullptr && *(volatile const int*)flag_in == 0) return;
    const int lane = threadIdx.x & 31;
    const int line = blockIdx.x * LINE_WARPS + (threadIdx.x >> 5);
    if (line >= n_lines) return;                 // uniform across the warp
    int* lab = labels + (size_t)line * line_stride;
    uint8_t* rch = reached + (size_t)line * line_stride;
    const int nseg = (len + 31) / 32;
    bool changed = false;

    // forward
    int carry_a = ABSORB ? PACK_NONE : -POS_INF, carry_b = -POS_INF;
    int prev_last = -9;
    for (int seg = 0; seg < nseg; ++seg) {
        const int pos = seg * 32 + lane;
        const bool in = pos < len;
        const size_t at = (size_t)pos * elem_stride;
        const int l = in ? lab[at] : -9;
        const bool r = in && rch[at];
        if (ABSORB) {
            const int packed = r ? pos * pack + l : PACK_NONE;
            const int near = max(carry_a, scan_max_up(packed, lane));
            if (in && !r && near > PACK_NONE / 2) {
                const int dl = near & (pack - 1);
                const int y = rows ? line : pos, x = rows ? pos : line;
                if (abs(dl / gw - y / step) <= 1 && abs(dl % gw - x / step) <= 1) {
                    lab[at] = dl;
                    rch[at] = 1;
                    changed = true;
                }
            }
            carry_a = __shfl_sync(FULL, near, 31);
        } else {
            int prev = __shfl_up_sync(FULL, l, 1);
            if (lane == 0) prev = prev_last;
            const int m = max(carry_a, scan_max_up(r ? pos : -POS_INF, lane));
            const int s = max(carry_b, scan_max_up(
                (in && l != prev) ? pos : -POS_INF, lane));
            if (in && !r && m >= s) {
                rch[at] = 1;
                changed = true;
            }
            carry_a = __shfl_sync(FULL, m, 31);
            carry_b = __shfl_sync(FULL, s, 31);
            prev_last = __shfl_sync(FULL, l, 31);
        }
    }

    // reverse (each lane revisits its own pixels)
    carry_a = ABSORB ? PACK_NONE : POS_INF;
    carry_b = POS_INF;
    int next_first = -9;
    for (int seg = nseg - 1; seg >= 0; --seg) {
        const int pos = seg * 32 + lane;
        const bool in = pos < len;
        const size_t at = (size_t)pos * elem_stride;
        const int l = in ? lab[at] : -9;
        const bool r = in && rch[at];
        if (ABSORB) {
            const int packed = r ? -pos * pack + l : PACK_NONE;
            const int near = max(carry_a, scan_max_down(packed, lane));
            if (in && !r && near > PACK_NONE / 2) {
                const int dl = near & (pack - 1);
                const int y = rows ? line : pos, x = rows ? pos : line;
                if (abs(dl / gw - y / step) <= 1 && abs(dl % gw - x / step) <= 1) {
                    lab[at] = dl;
                    rch[at] = 1;
                    changed = true;
                }
            }
            carry_a = __shfl_sync(FULL, near, 0);
        } else {
            int next = __shfl_down_sync(FULL, l, 1);
            if (lane == 31) next = next_first;
            const int m = min(carry_a, scan_min_down(r ? pos : POS_INF, lane));
            const int e = min(carry_b, scan_min_down(
                (in && l != next) ? pos : POS_INF, lane));
            if (in && !r && m <= e) {
                rch[at] = 1;
                changed = true;
            }
            carry_a = __shfl_sync(FULL, m, 0);
            carry_b = __shfl_sync(FULL, e, 0);
            next_first = __shfl_sync(FULL, l, 0);
        }
    }
    if (__any_sync(FULL, changed) && lane == 0) *flag_out = 1;
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
    const int k = gh * gw;
    const size_t n = (size_t)height * width;
    seed_tile_min_kernel<<<dim3(gw, gh), SEED_THREADS, 0, st>>>(
        (const float*)centers, lab, (float*)d2, (float*)tile_min, height,
        width, gh, gw, step);
    seed_min_kernel<<<(k + 127) / 128, 128, 0, st>>>(
        (const float*)tile_min, (float*)d2min, gh, gw);
    reach0_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        lab, (const float*)d2, (const float*)d2min, rch, height, width, gh,
        gw, step);
    for (int s = 0; s < max_sweeps; ++s)
        launch_sweep<false>(lab, rch, s == 0 ? nullptr : fl + s, fl + s + 1,
                            height, width, gw, step, pack, st);
    int* af = fl + max_sweeps + 1;
    for (int i = 0; i < n_rounds; ++i)
        launch_sweep<true>(lab, rch, i == 0 ? nullptr : af + i, af + i + 1,
                           height, width, gw, step, pack, st);
    return (int)cudaGetLastError();
}
