// SLIC assignment + per-offset pooling, and the centre update.
//
// Replaces the TPU kernels of pyimsegm_tpu/ops/slic_pallas.py:
//   slic_multi_update_pallas (_multi_update_kernel): the n_iter-1 assign +
//     update iterations, here a host loop of (slic_assign_pool, slic_update),
//     in plain or SLICO mode;
//   slic_update_labels_pallas (_slic_pass_kernel with labels and partials):
//     the final assignment, here one slic_assign_pool with labels and,
//     optionally, the colour moments of a feature image;
//   slic_assign_pallas (_slic_pass_kernel, labels only, plain or SLICO):
//     slic_assign_pool with no partials;
//   slic_update_pallas (_slic_pass_kernel, partials only): slic_assign_pool
//     with no labels.
// The plain twins are in pyimsegm_tpu_torch/ops/slic_cuda.py.
//
// Bound: device memory and issue rate.  A pass reads 6 B/px of bf16 Lab
// (plus 12 B/px of f32 feature image and 4 B/px of written labels in the
// final pass) and evaluates 9 candidate distances (~15 flops each) per
// pixel; the pooled sums per pixel are 6 (or 12) predicated adds.  The
// labels-only pass reads 6 B/px and writes 4 B/px and pools nothing.
// Design: one block per seed tile (step x step pixels).  The 3x3 neighbour
// centres sit in shared memory.  Each thread walks the tile's pixels with a
// block stride and keeps 9 x CH running sums in registers (the offset index
// is unrolled, so the array never spills to local memory).  At the end of
// the tile the sums are reduced with warp shuffles and then across warps in
// shared memory in a fixed order, and written as per-(tile, offset) partials:
// no global atomics, so a run is deterministic.  The TPU kernel's
// dot-product scoring and selector-matmul pooling are TPU tricks and are not
// carried over; the distance is the explicit difference form of
// pyimsegm_tpu/ops/slic.py:_slic_segment_xla, dc2 + (ds2 * sw) * m2 (SLICO:
// dc2 / max(M, 1e-6) + ds2 * sw with the cluster's colour normaliser M in a
// sixth centre column), with every operation rounded on its own (no FMA
// contraction), so labels match the plain twin exactly.  In SLICO mode the
// pass also pools, per (tile, offset), the maximum dc2 of the pixels that
// took that offset (a max is order-free, so it is exact), and the update
// sets M = max(max dc2 over the 9 routed offsets, 1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define NOFF 9
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

// CH pooled sum channels: 0 (labels only), 6 ([l, a, b, y, x, count]) or 12
// (+ [v, v^2] of a 3-channel feature image).  SLICO adds one max channel
// (the largest dc2) after the sums, so a partial holds CH + SLICO floats.
template <int CH, bool SLICO>
__global__ void __launch_bounds__(NTHREADS)
slic_assign_pool_kernel(const __nv_bfloat16* __restrict__ lab,  // (3, ph, pw)
                        const float* __restrict__ centers,      // (gh, gw, NC)
                        const float* __restrict__ feat,         // (3, ph, pw) or null
                        int* __restrict__ labels,               // (ph, pw) or null
                        float* __restrict__ partials,           // (gh, gw, 9, PCH)
                        float sw, float m2, int height, int width,
                        int gh, int gw, int step) {
    constexpr int NC = SLICO ? 6 : 5;                // centre columns
    constexpr bool POOL = CH > 0;
    constexpr int PCH = CH + (SLICO && POOL ? 1 : 0);
    constexpr int ACH = POOL ? CH : 1;               // register array extent
    __shared__ float cen[NOFF][NC];
    __shared__ int cen_ok[NOFF];
    __shared__ float red[NWARPS][NOFF * (PCH > 0 ? PCH : 1)];
    const int tx = blockIdx.x, ty = blockIdx.y;
    const int tid = threadIdx.x;
    const int pw = gw * step;
    const size_t plane = (size_t)gh * step * pw;
    if (tid < NOFF) {
        int sy = ty + tid / 3 - 1, sx = tx + tid % 3 - 1;
        int ok = sy >= 0 && sy < gh && sx >= 0 && sx < gw;
        cen_ok[tid] = ok;
        for (int c = 0; c < NC; ++c)
            cen[tid][c] = ok ? centers[((size_t)sy * gw + sx) * NC + c] : 0.0f;
    }
    __syncthreads();

    float acc[NOFF][ACH];
    float mx[NOFF];
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        mx[o] = 0.0f;
#pragma unroll
        for (int c = 0; c < ACH; ++c) acc[o][c] = 0.0f;
    }

    const int npix = step * step;
    for (int p = tid; p < npix; p += NTHREADS) {
        const int y = ty * step + p / step, x = tx * step + p % step;
        const size_t idx = (size_t)y * pw + x;
        const float l0 = __bfloat162float(lab[idx]);
        const float l1 = __bfloat162float(lab[plane + idx]);
        const float l2 = __bfloat162float(lab[2 * plane + idx]);
        const float fy = (float)y, fx = (float)x;
        float best_d = 1e10f, best_dc2 = 0.0f;
        int best_o = 0;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
            if (!cen_ok[o]) continue;
            float d0 = __fsub_rn(l0, cen[o][0]);
            float d1 = __fsub_rn(l1, cen[o][1]);
            float d2 = __fsub_rn(l2, cen[o][2]);
            float dc2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                  __fmul_rn(d2, d2));
            float dy = __fsub_rn(fy, cen[o][3]);
            float dx = __fsub_rn(fx, cen[o][4]);
            float ds2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
            float d;
            if constexpr (SLICO)
                d = __fadd_rn(__fdiv_rn(dc2, fmaxf(cen[o][NC - 1], 1e-6f)),
                              __fmul_rn(ds2, sw));
            else
                d = __fadd_rn(dc2, __fmul_rn(__fmul_rn(ds2, sw), m2));
            if (d < best_d) { best_d = d; best_o = o; best_dc2 = dc2; }
        }
        if (labels != nullptr)
            labels[idx] = (ty + best_o / 3 - 1) * gw + (tx + best_o % 3 - 1);
        if constexpr (POOL) {
            if (y >= height || x >= width) continue;   // pad pixels add nothing
            float v[ACH];
            v[0] = l0; v[1] = l1; v[2] = l2; v[3] = fy; v[4] = fx; v[5] = 1.0f;
            if constexpr (CH == 12) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    float f = feat[c * plane + idx];
                    v[6 + c] = f;
                    v[9 + c] = __fmul_rn(f, f);
                }
            }
#pragma unroll
            for (int o = 0; o < NOFF; ++o) {
                if (o == best_o) {
#pragma unroll
                    for (int c = 0; c < CH; ++c) acc[o][c] = __fadd_rn(acc[o][c], v[c]);
                    if constexpr (SLICO) mx[o] = fmaxf(mx[o], best_dc2);
                }
            }
        }
    }
    if constexpr (POOL) {
        const int warp = tid / 32, lane = tid % 32;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                float s = acc[o][c];
#pragma unroll
                for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
                if (lane == 0) red[warp][o * PCH + c] = s;
            }
            if constexpr (SLICO) {
                float s = mx[o];
#pragma unroll
                for (int m = 16; m > 0; m >>= 1)
                    s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, m));
                if (lane == 0) red[warp][o * PCH + CH] = s;
            }
        }
        __syncthreads();
        float* out = partials + ((size_t)ty * gw + tx) * NOFF * PCH;
        for (int k = tid; k < NOFF * PCH; k += NTHREADS) {
            const bool is_max = SLICO && (k % PCH) == CH;
            float s = red[0][k];
            for (int wi = 1; wi < NWARPS; ++wi)
                s = is_max ? fmaxf(s, red[wi][k]) : s + red[wi][k];
            out[k] = s;
        }
    }
}

// One thread per seed: route the 9 offset partials to their target seed in
// the order of combine_sums, divide by the count, keep the centre of an empty
// cluster.  partials has [l, a, b, y, x, count] (+ max dc2 in SLICO mode);
// in SLICO mode the centre's sixth column becomes max(routed max dc2, 1).
template <bool SLICO>
__global__ void slic_update_kernel(const float* __restrict__ partials,
                                   float* __restrict__ centers, int gh, int gw) {
    constexpr int PCH = SLICO ? 7 : 6;
    constexpr int NC = SLICO ? 6 : 5;
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= gh * gw) return;
    const int y = s / gw, x = s % gw;
    float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float maxdc = 0.0f;
    for (int o = 0; o < NOFF; ++o) {
        // pixels of tile (y - di, x - dj) that chose offset o belong to seed (y, x)
        int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
        const float* p = partials + (((size_t)sy * gw + sx) * NOFF + o) * PCH;
        for (int c = 0; c < 6; ++c) sums[c] = __fadd_rn(sums[c], p[c]);
        if (SLICO) maxdc = fmaxf(maxdc, p[6]);
    }
    if (sums[5] > 0.0f) {
        float cnt = fmaxf(sums[5], 1.0f);
        for (int c = 0; c < 5; ++c) centers[(size_t)s * NC + c] = __fdiv_rn(sums[c], cnt);
    }
    if (SLICO) centers[(size_t)s * NC + 5] = fmaxf(maxdc, 1.0f);
}

template <int CH, bool SLICO>
static void launch_assign_pool(dim3 grid, cudaStream_t st, const void* lab,
                               const void* centers, const void* feat,
                               void* labels, void* partials, float sw, float m2,
                               int height, int width, int gh, int gw, int step) {
    slic_assign_pool_kernel<CH, SLICO><<<grid, NTHREADS, 0, st>>>(
        (const __nv_bfloat16*)lab, (const float*)centers, (const float*)feat,
        (int*)labels, (float*)partials, sw, m2, height, width, gh, gw, step);
}

// partials == nullptr: labels only.  feat != nullptr: 12 pooled channels
// (plain mode only).  slico != 0: centres (gh, gw, 6), partials 7 channels.
extern "C" int slic_assign_pool(const void* lab, const void* centers,
                                const void* feat, void* labels, void* partials,
                                float sw, float m2, int height, int width,
                                int gh, int gw, int step, int slico,
                                void* stream) {
    dim3 grid(gw, gh);
    cudaStream_t st = (cudaStream_t)stream;
    if (partials == nullptr && labels == nullptr) return (int)cudaErrorInvalidValue;
    if (slico && feat != nullptr) return (int)cudaErrorInvalidValue;
    if (slico) {
        if (partials == nullptr)
            launch_assign_pool<0, true>(grid, st, lab, centers, nullptr, labels,
                                        nullptr, sw, m2, height, width, gh, gw, step);
        else
            launch_assign_pool<6, true>(grid, st, lab, centers, nullptr, labels,
                                        partials, sw, m2, height, width, gh, gw, step);
    } else if (partials == nullptr) {
        launch_assign_pool<0, false>(grid, st, lab, centers, nullptr, labels,
                                     nullptr, sw, m2, height, width, gh, gw, step);
    } else if (feat != nullptr) {
        launch_assign_pool<12, false>(grid, st, lab, centers, feat, labels,
                                      partials, sw, m2, height, width, gh, gw, step);
    } else {
        launch_assign_pool<6, false>(grid, st, lab, centers, nullptr, labels,
                                     partials, sw, m2, height, width, gh, gw, step);
    }
    return (int)cudaGetLastError();
}

extern "C" int slic_update(const void* partials, void* centers, int gh, int gw,
                           int slico, void* stream) {
    int n = gh * gw;
    if (slico)
        slic_update_kernel<true><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
            (const float*)partials, (float*)centers, gh, gw);
    else
        slic_update_kernel<false><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
            (const float*)partials, (float*)centers, gh, gw);
    return (int)cudaGetLastError();
}
