// 3D anisotropic SLIC supervoxels: the whole schedule (partials passes,
// centre updates and the labels pass) in one cooperative launch.
//
// Replaces the TPU kernel of pyimsegm_tpu/ops/slic3d_pallas.py:
//   slic3d_iterate_pallas (_slic3d_pass_kernel through _pass3d): n_iter - 1
//     rounds of (assign every voxel, pool per (tile, offset), route and
//     divide), then one labels pass.  Here slic3d_kernel runs them all; the
//     standalone labels pass (n_upd = 0 with labels) and partials pass
//     (n_upd = 0 without labels) are the same kernel and the same body.
// The plain twins are in pyimsegm_tpu_torch/ops/slic3d_cuda.py.
//
// Distance: the explicit-difference form of
// pyimsegm_tpu/ops/slic3d.py:_slic3d_segment_xla,
//   d = (v - cv)^2 + ((((z - cz) sz)^2 + ((y - cy) sy)^2) + ((x - cx) sx)^2)
//       * sw * m2,
// over the offsets in lexicographic (dz, dy, dx) order with a strict '<'
// against a running best that starts at 1e10 (offset 0, label 0 when no
// candidate beats it), every operation rounded on its own (no FMA
// contraction), so labels match the plain twin exactly.  The TPU kernel's
// dot-product scoring and selector matmuls are TPU tricks and are not
// carried over.
//
// Bound: f32 operations.  A pass reads 4 B/voxel of f32 volume (and writes
// 4 B/voxel of labels in the labels pass) but evaluates 27 candidates per
// voxel.  What the design does about it:
//   * per-tile tables: ((z - cz) sz)^2 depends only on (candidate, lz),
//     ((y - cy) sy)^2 only on (candidate, ly) and ((x - cx) sx)^2 only on
//     (candidate, lx); a tile builds them once in shared memory with the
//     same rounded operations.  Each thread owns whole rows (lz, ly) of its
//     tile: it adds the first two tables once per row per candidate and
//     keeps the sums and the candidates' values in registers, and walks its
//     row along x, where the threads of a warp read the same x entry of the
//     third table (a broadcast, four candidates per 16-byte load).  The
//     per-candidate work is then sub, mul, add (spatial), mul, mul, add and
//     the compare, with no division and no per-candidate branch; an
//     out-of-grid candidate has an infinite z table, whose distance never
//     wins;
//   * pooling: each valid voxel adds [v, z, y, x, 1] into per-thread sums
//     in shared memory indexed by the winning offset, laid out
//     [channel][thread] (no bank conflicts, no register array); at the end
//     of a tile each (offset, channel) is summed by one thread over the
//     threads in order into per-(tile, offset) partials: no float atomics,
//     so a run is deterministic;
//   * the work items of a block (chunks of T rows of a tile) run as a
//     two-stage pipeline: while one is evaluated from shared memory, the
//     asynchronous copies (cp.async) of the next one's voxels, and of the
//     next tile's 27 candidate centres, are in flight;
//   * the per-tile work outside the candidates is kept short (it is a
//     tile's own latency, paid 40 times in a row by every block): the
//     tables are built one (axis, candidate) a thread with no division;
//   * a chunk's labels replace its voxels in shared memory and are stored
//     along x (a row a thread would scatter 32 rows a store);
//   * one cooperative grid of as many blocks as the card holds co-resident
//     (a launch the card refuses returns its error), striding over the
//     tiles.  A round is the partials pass, a grid barrier, the centre
//     update (one thread per seed: the 27 offset partials routed in the
//     order of the XLA path's shifted sums with __fadd_rn, __fdiv_rn by
//     max(count, 1), an empty cluster keeps its centre), and a barrier.
//     The last phase is the labels pass.  The seeds are read, never
//     written: round 0 reads them, the update writes the working centres.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NOFF 27
#define NCH 5
#define XSTRIDE 28          // x table row: 27 candidates and a pad

// Block size T and the blocks an SM must hold (which caps the registers).
// Chosen by same-call A/B runs on the card (PERF.md).
struct Cfg3 {
    static constexpr int T = 32;
    static constexpr int MIN_BLOCKS = 4;
    static constexpr int NACC = NOFF * NCH;           // per-thread sums
    static constexpr int ACCS = T + 1;                // a channel's stride
    static constexpr int PER_THREAD = (NACC + T - 1) / T;
    static_assert(T % 32 == 0 && T >= NOFF, "whole warps, one per candidate");
};

struct Args3 {
    const float* vol;        // (dp, hp, wp)
    const float* seeds;      // (gz, gy, gx, 4) [v, z, y, x]
    float* work;             // (gz, gy, gx, 4) working centres, or null
    int* labels;             // (dp, hp, wp), or null: partials-only pass
    float* part;             // (gz, gy, gx, 27, 5), or null: labels only
    float s_z, s_y, s_x, sw, m2;
    int depth, height, width, gz, gy, gx, sz, sy, sx, n_upd;
};

// Asynchronous copies into shared memory (cp.async): 16 bytes through L2
// only (data that other blocks wrote before a grid barrier), 4 bytes
// through L1 (the read-only volume); one group per work item.
__device__ __forceinline__ void copy16_cg(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void copy_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Candidate o of a voxel against the best so far: ab = a^2 + b^2 of the
// row, c2 = c^2 of the column, cv the candidate's value.  Evaluated in
// offset order, a strict '<' keeps the first best.
__device__ __forceinline__ void candidate3(float v, float cv, float ab,
                                           float c2, int o, float sw, float m2,
                                           float& best_d, int& best_o) {
    const float ds2 = __fadd_rn(ab, c2);
    const float sp = __fmul_rn(__fmul_rn(ds2, sw), m2);
    const float dv = __fsub_rn(v, cv);
    const float d = __fadd_rn(__fmul_rn(dv, dv), sp);
    if (d < best_d) {
        best_d = d;
        best_o = o;
    }
}

// The shared memory of a block: dynamic (x table [sx][28], per-thread sums
// [135][T + 1], two stages [T][sx | 1] of a chunk's voxels, z table
// [27][sz], y table [27][sy]) and static (two sets of the 27 candidates'
// centres as fetched, the current tile's candidate values and seed ids).
struct Smem3 {
    float* xt;
    float* acc;
    float* stage;                // stage b at stage + b * T * (sx | 1)
    float* za;
    float* yb;
    float4 (*cc)[NOFF];
    float* cv;
    int* nid;
    long long* rowoff;           // the device offsets of a chunk's rows
};

// A work item: rows r0 .. r0 + T - 1 (a chunk) of tile t.  Issue the
// asynchronous copies of its voxels into stage b (and, for a tile's first
// chunk, of its 27 candidates' centres into cc[b]; an out-of-grid one gets
// a NaN z), as one group.
__device__ __forceinline__ void fetch_item(const Args3& a, const float* cen,
                                           const Smem3& m, int t, int r0,
                                           int b) {
    constexpr int T = Cfg3::T;
    const int tid = threadIdx.x;
    const int tx = t % a.gx, ty = (t / a.gx) % a.gy, tz = t / (a.gx * a.gy);
    const int hp = a.gy * a.sy, wp = a.gx * a.sx;
    if (r0 == 0 && tid < NOFF) {
        const int nz = tz + tid / 9 - 1, ny = ty + (tid / 3) % 3 - 1,
                  nx = tx + tid % 3 - 1;
        if (nz >= 0 && nz < a.gz && ny >= 0 && ny < a.gy && nx >= 0 &&
            nx < a.gx)
            copy16_cg(&m.cc[b][tid],
                      (const float4*)cen + (nz * a.gy + ny) * a.gx + nx);
        else
            m.cc[b][tid] = make_float4(0.0f, __int_as_float(0x7fc00000), 0.0f,
                                       0.0f);
    }
    // one row a thread, copied along x
    const int nr = min(T, a.sz * a.sy - r0);
    if (tid < nr) {
        const int r = r0 + tid, lz = r / a.sy, ly = r - lz * a.sy;
        const float* src = a.vol + ((size_t)(tz * a.sz + lz) * hp
                                    + ty * a.sy + ly) * wp + tx * a.sx;
        float* dst = m.stage + (b * T + tid) * (a.sx | 1);
        for (int lx = 0; lx < a.sx; ++lx) copy4(dst + lx, src + lx);
    }
    copy_commit();
}

// The tables of tile t from its candidates' centres cc[b] (and their values
// and seed ids): entry i of 27 * (sz + sy + sx), the squared scaled
// differences to each candidate's coordinate, the z entry infinite for an
// out-of-grid candidate.
__device__ __forceinline__ void build_tables(const Args3& a, const Smem3& m,
                                             int t, int b) {
    const int tid = threadIdx.x;
    const int tx = t % a.gx, ty = (t / a.gx) % a.gy, tz = t / (a.gx * a.gy);
    if (tid < NOFF) {
        const int nz = tz + tid / 9 - 1, ny = ty + (tid / 3) % 3 - 1,
                  nx = tx + tid % 3 - 1;
        const bool ok = nz >= 0 && nz < a.gz && ny >= 0 && ny < a.gy &&
                        nx >= 0 && nx < a.gx;
        m.nid[tid] = ok ? (nz * a.gy + ny) * a.gx + nx : 0;
        m.cv[tid] = m.cc[b][tid].x;
    }
    // item i: axis i / 27 of candidate i % 27, all its entries
    for (int i = tid; i < 3 * NOFF; i += Cfg3::T) {
        const int axis = i / NOFF, o = i - axis * NOFF;
        const float4 c = m.cc[b][o];
        if (axis == 0) {
            const bool ok = !isnan(c.y);
            for (int l = 0; l < a.sz; ++l) {
                const float f = __fmul_rn(__fsub_rn((float)(tz * a.sz + l),
                                                    c.y), a.s_z);
                m.za[o * a.sz + l] = ok ? __fmul_rn(f, f)
                                        : __int_as_float(0x7f800000);
            }
        } else if (axis == 1) {
            for (int l = 0; l < a.sy; ++l) {
                const float f = __fmul_rn(__fsub_rn((float)(ty * a.sy + l),
                                                    c.z), a.s_y);
                m.yb[o * a.sy + l] = __fmul_rn(f, f);
            }
        } else {
            for (int l = 0; l < a.sx; ++l) {
                const float f = __fmul_rn(__fsub_rn((float)(tx * a.sx + l),
                                                    c.w), a.s_x);
                m.xt[l * XSTRIDE + o] = __fmul_rn(f, f);
            }
        }
    }
}

// Tile t's per-offset partials from the per-thread sums (which it zeroes):
// thread i sums channels i, i + T, ... over the T threads in order (a
// channel's stride T + 1 keeps the lanes of a warp on distinct banks).
__device__ __forceinline__ void reduce_tile(const Args3& a, float* acc,
                                            int t) {
    constexpr int T = Cfg3::T, PT = Cfg3::PER_THREAD;
    float* out = a.part + (size_t)t * Cfg3::NACC;
    float s[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) s[p] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int p = 0; p < PT; ++p) {
            const int k = threadIdx.x + p * T;
            if (k >= Cfg3::NACC) continue;
            float* v = acc + k * Cfg3::ACCS + j;
            s[p] = __fadd_rn(s[p], *v);
            *v = 0.0f;
        }
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
        const int k = threadIdx.x + p * T;
        if (k < Cfg3::NACC) out[k] = s[p];
    }
}

// One pass over the block's tiles (blockIdx.x, + gridDim.x, ...): every
// voxel's first-best candidate, then its label (labels != null) or its
// contribution to its tile's per-offset partials.  The work items (chunks
// of T rows of a tile, one row a thread) run as a two-stage pipeline: the
// copies of item k + 1 are in flight while item k is evaluated from shared
// memory.  acc is all zero on entry and is left all zero.
template <bool POOL>
__device__ __forceinline__ void pass_tiles(const Args3& a, const float* cen,
                                           const Smem3& m) {
    constexpr int T = Cfg3::T;
    const int tid = threadIdx.x;
    const int n_tiles = a.gz * a.gy * a.gx, rows = a.sz * a.sy;
    const int sxp = a.sx | 1;                    // odd: no bank conflict
    const int hp = a.gy * a.sy, wp = a.gx * a.sx;
    const float inv_sx = 1.0f / (float)a.sx;
    int t = blockIdx.x, r0 = 0, b = 0;
    if (t < n_tiles) fetch_item(a, cen, m, t, 0, 0);
    while (t < n_tiles) {
        // the next item: the tile's next chunk, or the next tile's first
        int tn = t, rn = r0 + T;
        if (rn >= rows) { tn = t + gridDim.x; rn = 0; }
        if (tn < n_tiles) fetch_item(a, cen, m, tn, rn, b ^ 1);
        else copy_commit();                       // an empty group
        copy_wait_prior();
        __syncthreads();
        if (r0 == 0) {
            build_tables(a, m, t, b);
            __syncthreads();
        }
        const int tx = t % a.gx, ty = (t / a.gx) % a.gy,
                  tz = t / (a.gx * a.gy);
        const int nr = min(T, rows - r0);
        float* st = m.stage + b * T * sxp;
        if (tid < nr) {
            const int r = r0 + tid, lz = r / a.sy, ly = r - lz * a.sy;
            const int z = tz * a.sz + lz, y = ty * a.sy + ly, x0 = tx * a.sx;
            float cvr[NOFF], ab[NOFF];
#pragma unroll
            for (int o = 0; o < NOFF; ++o) {
                cvr[o] = m.cv[o];
                ab[o] = __fadd_rn(m.za[o * a.sz + lz], m.yb[o * a.sy + ly]);
            }
            const bool row_valid = z < a.depth && y < a.height;
            const float fz = (float)z, fy = (float)y;
            float* vrow = st + tid * sxp;
            if (!POOL) m.rowoff[tid] = ((long long)z * hp + y) * wp + x0;
            float* mine = m.acc + tid;
            for (int lx = 0; lx < a.sx; ++lx) {
                const float v = vrow[lx];
                float best_d = 1e10f;
                int best_o = -1;
#pragma unroll
                for (int q = 0; q < XSTRIDE / 4; ++q) {
                    const float4 c = *(const float4*)(m.xt + lx * XSTRIDE
                                                      + 4 * q);
                    const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int o = 4 * q + j;
                        if (o < NOFF)
                            candidate3(v, cvr[o], ab[o], cs[j], o, a.sw, a.m2,
                                       best_d, best_o);
                    }
                }
                if constexpr (!POOL) {
                    // the label replaces the voxel it was found for
                    ((int*)vrow)[lx] = best_o < 0 ? 0 : m.nid[best_o];
                } else {
                    const int x = x0 + lx;
                    if (!row_valid || x >= a.width) continue;  // pad: nothing
                    constexpr int S = Cfg3::ACCS;
                    float* s = mine + (best_o < 0 ? 0 : best_o) * NCH * S;
                    s[0] = __fadd_rn(s[0], v);
                    s[S] = __fadd_rn(s[S], fz);
                    s[2 * S] = __fadd_rn(s[2 * S], fy);
                    s[3 * S] = __fadd_rn(s[3 * S], (float)x);
                    s[4 * S] = __fadd_rn(s[4 * S], 1.0f);
                }
            }
        }
        __syncthreads();
        if (!POOL) {
            // the chunk's labels stored along x: voxel e of the chunk is
            // (row e / sx, x e % sx), the quotient exact in f32 for the
            // chunk's e < T * sx
            for (int e = tid; e < nr * a.sx; e += T) {
                const int rl = __float2int_rz(
                    __fmul_rn((float)e + 0.5f, inv_sx));
                const int lx = e - rl * a.sx;
                a.labels[m.rowoff[rl] + lx] = ((const int*)st)[rl * sxp + lx];
            }
            __syncthreads();
        } else if (r0 + T >= rows) {
            reduce_tile(a, m.acc, t);
            __syncthreads();
        }
        t = tn;
        r0 = rn;
        b ^= 1;
    }
}

// Seed s's new centre from the partials: the 27 offset partials routed in
// the order of the XLA path's shifted sums, divided by max(count, 1); an
// empty cluster keeps its centre (read from prev, written to work).
__device__ __forceinline__ void update_seed(const Args3& a, const float* prev,
                                            int s) {
    const int x = s % a.gx, y = (s / a.gx) % a.gy, z = s / (a.gx * a.gy);
    // per channel the 27 loads in flight together, then added in offset
    // order; an offset whose tile lies off the grid adds 0.0f, as the
    // shifted sums do
    float sums[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        float v[NOFF];
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
            // voxels of tile (z, y, x) - offset that chose it belong here
            const int tz = z - (o / 9 - 1), ty = y - ((o / 3) % 3 - 1),
                      tx = x - (o % 3 - 1);
            const bool ok = tz >= 0 && tz < a.gz && ty >= 0 && ty < a.gy &&
                            tx >= 0 && tx < a.gx;
            v[o] = ok ? __ldcg(a.part + ((((size_t)tz * a.gy + ty) * a.gx + tx)
                                         * NOFF + o) * NCH + c)
                      : 0.0f;
        }
        float sum = 0.0f;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) sum = __fadd_rn(sum, v[o]);
        sums[c] = sum;
    }
    const float cnt = fmaxf(sums[4], 1.0f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
        a.work[(size_t)s * 4 + c] = sums[4] > 0.0f ? __fdiv_rn(sums[c], cnt)
                                                   : __ldcg(prev + (size_t)s * 4 + c);
}

__global__ void __launch_bounds__(Cfg3::T, Cfg3::MIN_BLOCKS)
slic3d_kernel(Args3 a) {
    extern __shared__ float4 dyn4[];
    __shared__ float4 cc[2][NOFF];
    __shared__ float cv[NOFF];
    __shared__ int nid[NOFF];
    __shared__ long long rowoff[Cfg3::T];
    constexpr int T = Cfg3::T;
    Smem3 m;
    m.xt = (float*)dyn4;
    m.acc = m.xt + a.sx * XSTRIDE;
    m.stage = m.acc + Cfg3::NACC * Cfg3::ACCS;
    m.za = m.stage + 2 * T * (a.sx | 1);
    m.yb = m.za + NOFF * a.sz;
    m.cc = cc;
    m.cv = cv;
    m.nid = nid;
    m.rowoff = rowoff;
    cg::grid_group grid = cg::this_grid();
    const int n_tiles = a.gz * a.gy * a.gx;
    if (a.part != nullptr)
        for (int k = 0; k < Cfg3::NACC; ++k)
            m.acc[k * Cfg3::ACCS + threadIdx.x] = 0.0f;
    for (int r = 0; r < a.n_upd; ++r) {
        const float* cen = r == 0 ? a.seeds : a.work;
        pass_tiles<true>(a, cen, m);
        grid.sync();
        for (int s = blockIdx.x * T + threadIdx.x; s < n_tiles;
             s += gridDim.x * T)
            update_seed(a, cen, s);
        grid.sync();
    }
    const float* cen = a.n_upd == 0 ? a.seeds : a.work;
    if (a.labels != nullptr)
        pass_tiles<false>(a, cen, m);
    else
        pass_tiles<true>(a, cen, m);
}

// n_upd >= 0 rounds from the seeds, then the labels pass (labels != null),
// or with n_upd = 0 and no labels one partials pass.  work (n_upd > 0):
// the (gz, gy, gx, 4) working centres, left holding the final centres;
// partials: (gz, gy, gx, 27, 5), the output of a partials pass and the
// scratch of the rounds.  One cooperative grid of as many blocks as the
// card holds co-resident (at most one per tile); a grid the card cannot
// hold is refused and its error returned.
extern "C" int slic3d_run(const void* vol, const void* seeds, void* work,
                          void* labels, void* partials, float s_z, float s_y,
                          float s_x, float sw, float m2, int depth, int height,
                          int width, int gz, int gy, int gx, int sz, int sy,
                          int sx, int n_upd, void* stream) {
    if (n_upd < 0 || (n_upd > 0 && (work == nullptr || labels == nullptr))
        || ((n_upd > 0 || labels == nullptr) && partials == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((size_t)sx * XSTRIDE
                                         + (size_t)Cfg3::NACC * Cfg3::ACCS
                                         + (size_t)2 * Cfg3::T * (sx | 1)
                                         + (size_t)NOFF * (sz + sy));
    static struct { size_t smem; int blocks; } cache[64];   // per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (cache[dev].smem != smem) {
        int n_sm = 0, per_sm = 0;
        err = cudaFuncSetAttribute(slic3d_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, slic3d_kernel, Cfg3::T, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm * n_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        cache[dev].smem = smem;
        cache[dev].blocks = per_sm * n_sm;
    }
    Args3 a;
    a.vol = (const float*)vol;
    a.seeds = (const float*)seeds;
    a.work = (float*)work;
    a.labels = (int*)labels;
    a.part = (float*)partials;
    a.s_z = s_z; a.s_y = s_y; a.s_x = s_x; a.sw = sw; a.m2 = m2;
    a.depth = depth; a.height = height; a.width = width;
    a.gz = gz; a.gy = gy; a.gx = gx; a.sz = sz; a.sy = sy; a.sx = sx;
    a.n_upd = n_upd;
    const int blocks = min(cache[dev].blocks, gz * gy * gx);
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)slic3d_kernel, dim3(blocks),
                                      dim3(Cfg3::T), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
