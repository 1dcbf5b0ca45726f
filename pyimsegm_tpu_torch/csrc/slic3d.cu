// 3D anisotropic SLIC supervoxels: the assignment pass (labels or per-offset
// partial sums) and the centre update.
//
// Replaces the TPU kernel of pyimsegm_tpu/ops/slic3d_pallas.py:
//   slic3d_iterate_pallas (_slic3d_pass_kernel through _pass3d): n_iter - 1
//     partials passes, each followed by the centre update, then one labels
//     pass, here a host loop of (slic3d_pass with partials, slic3d_update)
//     and a last slic3d_pass with labels.
// The plain twins are in pyimsegm_tpu_torch/ops/slic3d_cuda.py.
//
// Bound: f32 operations.  A pass reads 4 B/voxel of f32 volume (and writes
// 4 B/voxel of labels in the labels pass) but evaluates 27 candidate
// distances of ~17 operations each per voxel, which no FMA may contract:
// ~460 operations per 4-8 bytes, far above the card's f32 ridge (~20
// operations per byte).  The partials pass adds 5 predicated sums per voxel.
// Design: one block per seed tile (sz x sy x sx voxels).  The 27 candidate
// centres sit in shared memory.  Each thread walks the tile's voxels with a
// block stride and keeps 27 x 5 running sums in registers (the offset index
// is unrolled, so the array never spills to local memory).  At the end of the
// tile the sums are reduced with warp shuffles and then across warps in
// shared memory in a fixed order and written as per-(tile, offset) partials:
// no global atomics, so a run is deterministic.  The TPU kernel's dot-product
// scoring and selector matmuls are TPU tricks and are not carried over; the
// distance is the explicit-difference form of
// pyimsegm_tpu/ops/slic3d.py:_slic3d_segment_xla,
//   d = (v - cv)^2 + ((((z - cz) sz)^2 + ((y - cy) sy)^2) + ((x - cx) sx)^2)
//       * sw * m2,
// over the offsets in lexicographic (dz, dy, dx) order with a strict '<',
// every operation rounded on its own (no FMA contraction), so labels match
// the plain twin exactly.  Candidates outside the grid are skipped: the XLA
// path gives them centres at 1e10, which never win.

#include <cuda_runtime.h>

#define NOFF 27
#define NCH 5
#define NTHREADS 128
#define NWARPS (NTHREADS / 32)

template <bool POOL>
__global__ void __launch_bounds__(NTHREADS)
slic3d_pass_kernel(const float* __restrict__ vol,      // (dp, hp, wp)
                   const float* __restrict__ centers,  // (gz, gy, gx, 4)
                   int* __restrict__ labels,           // (dp, hp, wp) or null
                   float* __restrict__ partials,       // (gz, gy, gx, 27, 5)
                   float s_z, float s_y, float s_x, float sw, float m2,
                   int depth, int height, int width, int gz, int gy, int gx,
                   int sz, int sy, int sx) {
    constexpr int ACH = POOL ? NCH : 1;              // register array extent
    __shared__ float cen[NOFF][4];
    __shared__ int cen_ok[NOFF];
    __shared__ int cen_id[NOFF];
    __shared__ float red[NWARPS][NOFF * NCH];
    const int tx = blockIdx.x, ty = blockIdx.y, tz = blockIdx.z;
    const int tid = threadIdx.x;
    const int hp = gy * sy, wp = gx * sx;
    if (tid < NOFF) {
        const int nz = tz + tid / 9 - 1, ny = ty + (tid / 3) % 3 - 1,
                  nx = tx + tid % 3 - 1;
        const int ok = nz >= 0 && nz < gz && ny >= 0 && ny < gy && nx >= 0 && nx < gx;
        const int id = ok ? (nz * gy + ny) * gx + nx : 0;
        cen_ok[tid] = ok;
        cen_id[tid] = id;
        for (int c = 0; c < 4; ++c) cen[tid][c] = ok ? centers[(size_t)id * 4 + c] : 1e10f;
    }
    __syncthreads();

    float acc[NOFF][ACH];
#pragma unroll
    for (int o = 0; o < NOFF; ++o)
#pragma unroll
        for (int c = 0; c < ACH; ++c) acc[o][c] = 0.0f;

    const int plane = sy * sx, nvox = sz * plane;
    for (int p = tid; p < nvox; p += NTHREADS) {
        const int lz = p / plane, r = p - lz * plane, ly = r / sx, lx = r - ly * sx;
        const int z = tz * sz + lz, y = ty * sy + ly, x = tx * sx + lx;
        const size_t idx = ((size_t)z * hp + y) * wp + x;
        const float v = vol[idx];
        const float fz = (float)z, fy = (float)y, fx = (float)x;
        float best_d = 1e10f;
        int best_o = 0, best_id = 0;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
            if (!cen_ok[o]) continue;
            const float dv = __fsub_rn(v, cen[o][0]);
            const float a = __fmul_rn(__fsub_rn(fz, cen[o][1]), s_z);
            const float b = __fmul_rn(__fsub_rn(fy, cen[o][2]), s_y);
            const float c = __fmul_rn(__fsub_rn(fx, cen[o][3]), s_x);
            const float ds2 = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                                        __fmul_rn(c, c));
            const float d = __fadd_rn(__fmul_rn(dv, dv),
                                      __fmul_rn(__fmul_rn(ds2, sw), m2));
            if (d < best_d) { best_d = d; best_o = o; best_id = cen_id[o]; }
        }
        if constexpr (!POOL) {
            labels[idx] = best_id;
        } else {
            if (z >= depth || y >= height || x >= width) continue;  // pad adds nothing
            const float vals[NCH] = {v, fz, fy, fx, 1.0f};
#pragma unroll
            for (int o = 0; o < NOFF; ++o) {
                if (o == best_o) {
#pragma unroll
                    for (int c = 0; c < NCH; ++c) acc[o][c] = __fadd_rn(acc[o][c], vals[c]);
                }
            }
        }
    }
    if constexpr (POOL) {
        const int warp = tid / 32, lane = tid % 32;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                float s = acc[o][c];
#pragma unroll
                for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
                if (lane == 0) red[warp][o * NCH + c] = s;
            }
        }
        __syncthreads();
        float* out = partials + (((size_t)tz * gy + ty) * gx + tx) * NOFF * NCH;
        for (int k = tid; k < NOFF * NCH; k += NTHREADS) {
            float s = red[0][k];
            for (int wi = 1; wi < NWARPS; ++wi) s += red[wi][k];
            out[k] = s;
        }
    }
}

// One thread per seed: route the 27 offset partials to their target seed in
// the order of the XLA path's shifted sums, divide by the count, keep the
// centre of an empty cluster.  partials hold [v, z, y, x, count].
__global__ void slic3d_update_kernel(const float* __restrict__ partials,
                                     float* __restrict__ centers, int gz, int gy,
                                     int gx) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= gz * gy * gx) return;
    const int x = s % gx, y = (s / gx) % gy, z = s / (gx * gy);
    float sums[NCH] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < NOFF; ++o) {
        // voxels of tile (z, y, x) - offset that chose the offset belong here
        const int tz = z - (o / 9 - 1), ty = y - ((o / 3) % 3 - 1), tx = x - (o % 3 - 1);
        if (tz < 0 || tz >= gz || ty < 0 || ty >= gy || tx < 0 || tx >= gx) continue;
        const float* p = partials + ((((size_t)tz * gy + ty) * gx + tx) * NOFF + o) * NCH;
        for (int c = 0; c < NCH; ++c) sums[c] = __fadd_rn(sums[c], p[c]);
    }
    if (sums[4] > 0.0f) {
        const float cnt = fmaxf(sums[4], 1.0f);
        for (int c = 0; c < 4; ++c) centers[(size_t)s * 4 + c] = __fdiv_rn(sums[c], cnt);
    }
}

// partials == nullptr: labels pass; labels == nullptr: partials pass.
extern "C" int slic3d_pass(const void* vol, const void* centers, void* labels,
                           void* partials, float s_z, float s_y, float s_x,
                           float sw, float m2, int depth, int height, int width,
                           int gz, int gy, int gx, int sz, int sy, int sx,
                           void* stream) {
    if ((labels == nullptr) == (partials == nullptr)) return (int)cudaErrorInvalidValue;
    dim3 grid(gx, gy, gz);
    cudaStream_t st = (cudaStream_t)stream;
    if (partials == nullptr)
        slic3d_pass_kernel<false><<<grid, NTHREADS, 0, st>>>(
            (const float*)vol, (const float*)centers, (int*)labels, nullptr, s_z, s_y,
            s_x, sw, m2, depth, height, width, gz, gy, gx, sz, sy, sx);
    else
        slic3d_pass_kernel<true><<<grid, NTHREADS, 0, st>>>(
            (const float*)vol, (const float*)centers, nullptr, (float*)partials, s_z,
            s_y, s_x, sw, m2, depth, height, width, gz, gy, gx, sz, sy, sx);
    return (int)cudaGetLastError();
}

extern "C" int slic3d_update(const void* partials, void* centers, int gz, int gy,
                             int gx, void* stream) {
    const int n = gz * gy * gx;
    slic3d_update_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const float*)partials, (float*)centers, gz, gy, gx);
    return (int)cudaGetLastError();
}
