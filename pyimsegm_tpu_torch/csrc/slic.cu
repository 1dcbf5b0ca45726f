// SLIC assignment + per-offset pooling, and the whole update schedule.
//
// Replaces the TPU kernels of pyimsegm_tpu/ops/slic_pallas.py:
//   slic_multi_update_pallas (_multi_update_kernel): the n_iter-1 assign +
//     update rounds, here slic_schedule_kernel, one cooperative launch for
//     the whole schedule, in plain or SLICO mode;
//   slic_update_labels_pallas (_slic_pass_kernel with labels and partials):
//     the final assignment, here one slic_assign_pool with labels and,
//     optionally, the colour moments of a feature image;
//   slic_assign_pallas (_slic_pass_kernel, labels only, plain or SLICO):
//     slic_assign_pool with no partials;
//   slic_update_pallas (_slic_pass_kernel, partials only): slic_assign_pool
//     with no labels.
// The plain twins are in pyimsegm_tpu_torch/ops/slic_cuda.py.
//
// Distance: the explicit difference form of
// pyimsegm_tpu/ops/slic.py:_slic_segment_xla, dc2 + (ds2 * sw) * m2 (SLICO:
// dc2 / max(M, 1e-6) + ds2 * sw with the cluster's colour normaliser M in a
// sixth centre column), with every operation rounded on its own (no FMA
// contraction), so labels match the plain twin exactly.  The TPU kernels'
// dot-product scoring and selector-matmul pooling are TPU tricks and are not
// carried over.  In SLICO mode a pass also pools, per (tile, offset), the
// largest dc2 of the pixels that took that offset (a max is order-free, so
// it is exact), and an update sets M = max(max dc2 over the 9 routed
// offsets, 1).
//
// slic_assign_pool_kernel (rows 3, 4, 5).  Bound: device memory and issue
// rate.  A pass reads 6 B/px of bf16 Lab (plus 12 B/px of f32 feature image
// and 4 B/px of written labels in the final pass) and evaluates 9 candidate
// distances (~17 flops each) per pixel with candidate(), the same distance
// as the schedule's.  One block per seed tile (step x step pixels); the 3x3
// neighbour centres sit in shared memory; each thread
// walks the tile's pixels with a block stride and keeps 9 x CH running sums
// in registers (the offset index unrolled); at the end of the tile the sums
// are reduced with warp shuffles and then across warps in shared memory in a
// fixed order, and written as per-(tile, offset) partials: no global
// atomics, so a run is deterministic.
//
// slic_schedule_kernel (row 2).  Bound: operations, 9 candidate distances
// per pixel and round (the 6.7 MB of bf16 Lab at 884x1200 stay in the 50 MB
// L2 across rounds).  The TPU kernel runs its (n_upd, gh) grid in order with
// the centres and sums in VMEM; here every round runs inside one cooperative
// grid of as many blocks as the card holds co-resident, striding over the
// seed tiles, with one grid barrier per round:
//   * a block first makes the 9 neighbour centres of its tile itself from
//     the previous round's per-(tile, offset) partials (offsets added from
//     0.0f in the order of combine_sums, __fdiv_rn by max(count, 1); an
//     empty cluster keeps its previous centre), and writes its own seed's
//     centre; partials and centres are double-buffered by round parity, so
//     no separate update phase or second barrier is needed;
//   * the pooling adds each pixel's [l, a, b, y, x, 1] into per-thread
//     accumulators in shared memory, indexed by the winning offset (6 adds
//     per pixel, where registers would need 54 predicated ones), laid out
//     [channel][thread] so that a warp's accesses never share a bank;
//   * the block reduction gives each (offset, channel) to one warp: a fixed
//     strided sum over the threads, then a 5-step shuffle tree (no warp
//     repeats another's tree, no float atomics: a run is deterministic);
//   * out-of-grid neighbours get NaN centres, whose distance never wins,
//     so the candidate loop has no branch;
//   * the last phase, after the last barrier, writes the final centres.
// The schedule never leaves early: the reference runs all n_upd rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

#define NOFF 9
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

// Candidate o of a pixel against the best so far, with the centre c = (l,
// a, b, max(M, 1e-6)) and p = (y, x); a NaN l never wins.  The reference
// takes the first best in row-major (di, dj) order: evaluated in that order
// a strict '<' does it; with PRUNE the own seed goes first and a tie goes to
// the lower offset.
template <bool SLICO, bool PRUNE>
__device__ __forceinline__ void candidate(
        float4 c, float2 p, int o, float l0, float l1, float l2, float fy,
        float fx, float sw, float m2, bool prune, float& best_d, int& best_o,
        float& best_dc2) {
    const float dy = __fsub_rn(fy, p.x);
    const float dx = __fsub_rn(fx, p.y);
    const float ds2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
    const float sp = SLICO ? __fmul_rn(ds2, sw)
                           : __fmul_rn(__fmul_rn(ds2, sw), m2);
    // d = RN(colour + sp) >= sp, as the colour term is >= 0: a candidate
    // whose spatial term alone exceeds the best can neither win nor tie
    if (prune && sp > best_d) return;
    const float d0 = __fsub_rn(l0, c.x);
    const float d1 = __fsub_rn(l1, c.y);
    const float d2 = __fsub_rn(l2, c.z);
    const float dc2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
    const float d = SLICO ? __fadd_rn(__fdiv_rn(dc2, c.w), sp)
                          : __fadd_rn(dc2, sp);
    if (d < best_d || (PRUNE && d == best_d && o < best_o)) {
        best_d = d;
        best_o = o;
        best_dc2 = dc2;
    }
}

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
    // (l, a, b, max(M, 1e-6), y, x) as candidate() takes them; an
    // out-of-grid neighbour has a NaN l
    __shared__ __align__(16) float cen[NOFF][8];
    __shared__ float red[NWARPS][NOFF * (PCH > 0 ? PCH : 1)];
    const int tx = blockIdx.x, ty = blockIdx.y;
    const int tid = threadIdx.x;
    const int pw = gw * step;
    const size_t plane = (size_t)gh * step * pw;
    if (tid < NOFF) {
        const int sy = ty + tid / 3 - 1, sx = tx + tid % 3 - 1;
        const bool ok = sy >= 0 && sy < gh && sx >= 0 && sx < gw;
        const float* c = centers + (ok ? ((size_t)sy * gw + sx) * NC : 0);
        cen[tid][0] = ok ? c[0] : __int_as_float(0x7fc00000);
        cen[tid][1] = ok ? c[1] : 0.0f;
        cen[tid][2] = ok ? c[2] : 0.0f;
        cen[tid][3] = SLICO && ok ? fmaxf(c[NC - 1], 1e-6f) : 0.0f;
        cen[tid][4] = ok ? c[3] : 0.0f;
        cen[tid][5] = ok ? c[4] : 0.0f;
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
        for (int o = 0; o < NOFF; ++o)
            candidate<SLICO, false>(*(const float4*)cen[o],
                                    *(const float2*)(cen[o] + 4), o, l0, l1,
                                    l2, fy, fx, sw, m2, false, best_d, best_o,
                                    best_dc2);
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

// ------------------------------------------------------------ schedule ---

#define NSUM 6

// Per mode: the block size T and the blocks an SM must hold (which caps the
// registers), and PRUNE: evaluate the tile's own seed first and skip the
// colour term of a candidate whose spatial term alone exceeds the best
// distance so far (in SLICO mode that skips a division).  Chosen by
// same-call A/B runs on the card (PERF.md): pruning pays only where
// it skips a division.
template <bool SLICO>
struct Sched {
    static constexpr int NC = SLICO ? 6 : 5;         // centre columns
    static constexpr int PCH = SLICO ? 7 : 6;        // partial channels
    static constexpr int NACC = NOFF * PCH;          // per-thread sums
    static constexpr int T = SLICO ? 64 : 128;
    static constexpr int MIN_BLOCKS = 7;
    static constexpr int WARPS = T / 32;
    static constexpr int PER_WARP = (NACC + WARPS - 1) / WARPS;
    static constexpr bool PRUNE = SLICO;
    // neighbour_centres gives each (neighbour, channel) its own thread
    static_assert(T >= NOFF * PCH, "a block must cover 9 x PCH channels");
    static_assert(T % 32 == 0, "whole warps");
};

struct ScheduleArgs {
    const __nv_bfloat16* lab;    // (3, ph, pw)
    const float* c_in;           // (gh, gw, 5) seed centres
    float* out;                  // (gh, gw, NC) final centres
    float* cen;                  // (2, gh, gw, NC) centres, by round parity
    float* part;                 // (2, gh, gw, 9, PCH) partials, by parity
    float sw, m2, init_m2;
    int height, width, gh, gw, step, n_upd;
};

// The 3x3 neighbour centres of tile t for round r into cen[9][8] (l, a, b,
// max(M, 1e-6), y, x): the seeds (r = 0; M = init_m2 in SLICO mode) or the
// update of round r - 1's partials, one thread per (neighbour, channel).
// Out-of-grid neighbours get a NaN l.  The own seed's centre goes to
// dest + t * NC; with own_only only the own seed is made.
template <bool SLICO>
__device__ __forceinline__ void neighbour_centres(
        const ScheduleArgs& a, int r, int t, float* dest, bool own_only,
        float (*red)[8], float (*cen)[8]) {
    using S = Sched<SLICO>;
    const int tid = threadIdx.x, ty = t / a.gw, tx = t - ty * a.gw;
    const size_t n_seeds = (size_t)a.gh * a.gw;
    const int n = tid / S::PCH, c = tid - n * S::PCH;
    const int sy = ty + n / 3 - 1, sx = tx + n % 3 - 1;
    const bool mine = tid < NOFF * S::PCH && (!own_only || n == 4);
    const bool in_grid = sy >= 0 && sy < a.gh && sx >= 0 && sx < a.gw;
    const size_t s = in_grid ? (size_t)sy * a.gw + sx : 0;
    float prev = 0.0f;
    if (mine && in_grid && r > 0) {
        const float* p = a.part + ((r - 1) & 1) * n_seeds * NOFF * S::PCH;
        float v[NOFF];
        // pixels of tile (sy - di, sx - dj) that chose offset o; all 9 loads
        // issued before the adds
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
            const int py = sy - (o / 3 - 1), px = sx - (o % 3 - 1);
            const bool ok = py >= 0 && py < a.gh && px >= 0 && px < a.gw;
            v[o] = ok ? __ldcg(p + (((size_t)py * a.gw + px) * NOFF + o)
                               * S::PCH + c) : 0.0f;
        }
        if (c < 5) prev = __ldcg(a.cen + ((r - 1) & 1) * n_seeds * S::NC
                                 + s * S::NC + c);
        float sum = 0.0f;
#pragma unroll
        for (int o = 0; o < NOFF; ++o) {
            const int py = sy - (o / 3 - 1), px = sx - (o % 3 - 1);
            if (py < 0 || py >= a.gh || px < 0 || px >= a.gw) continue;
            sum = (SLICO && c == NSUM) ? fmaxf(sum, v[o])
                                       : __fadd_rn(sum, v[o]);
        }
        red[n][c] = sum;
    }
    __syncthreads();
    if (mine && c < 6) {
        // slot of channel c in cen[n]: l, a, b at 0-2, y, x at 4-5, and the
        // count thread makes slot 3 (max(M, 1e-6) in SLICO mode)
        const int slot = c < 3 ? c : c < 5 ? c + 1 : 3;
        float v = __int_as_float(0x7fc00000);
        if (in_grid) {
            if (c == 5) {
                const float m = !SLICO ? 0.0f
                    : r == 0 ? a.init_m2 : fmaxf(red[n][NSUM], 1.0f);
                if (SLICO && n == 4) dest[s * S::NC + 5] = m;
                v = fmaxf(m, 1e-6f);
            } else {
                const float cnt = red[n][5];
                v = r == 0 ? a.c_in[s * 5 + c]
                    : cnt > 0.0f ? __fdiv_rn(red[n][c], fmaxf(cnt, 1.0f))
                                 : prev;
                if (n == 4) dest[s * S::NC + c] = v;
            }
        } else if (c != 0) {
            v = 0.0f;
        }
        cen[n][slot] = v;
    }
    __syncthreads();
}

// One partials-only assignment of tile t into part: per-thread sums in
// acc[channel][thread] (channel o * NSUM + c; in SLICO mode 54 + o holds the
// largest dc2), then each channel reduced by one warp.  acc is all zero on
// entry and is left all zero.
template <bool SLICO>
__device__ __forceinline__ void assign_pool_tile(
        const ScheduleArgs& a, int t, const float (*cen)[8],
        float* acc, float* part) {
    using S = Sched<SLICO>;
    constexpr int T = S::T;
    const int tid = threadIdx.x, ty = t / a.gw, tx = t - ty * a.gw;
    const int step = a.step, pw = a.gw * step;
    const size_t plane = (size_t)a.gh * step * pw;
    // pixel tid + k * T of the tile, walked as (row, column)
    const int drow = T / step, dcol = T - drow * step;
    int row = tid / step, col = tid - row * step;
    float* mine = acc + tid;
    // the 9 candidates in registers for the whole tile
    float4 cc[NOFF];
    float2 cp[NOFF];
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        cc[o] = *(const float4*)cen[o];
        cp[o] = *(const float2*)(cen[o] + 4);
    }
    while (row < step) {
        const int y = ty * step + row, x = tx * step + col;
        col += dcol;
        row += drow;
        if (col >= step) { col -= step; ++row; }
        const size_t idx = (size_t)y * pw + x;
        const float l0 = __bfloat162float(a.lab[idx]);
        const float l1 = __bfloat162float(a.lab[plane + idx]);
        const float l2 = __bfloat162float(a.lab[2 * plane + idx]);
        const float fy = (float)y, fx = (float)x;
        float best_d = 1e10f, best_dc2 = 0.0f;
        int best_o = 0;
        // with PRUNE the tile's own seed first: its distance bounds the
        // others'
        if (S::PRUNE)
            candidate<SLICO, true>(cc[4], cp[4], 4, l0, l1, l2, fy, fx, a.sw,
                                   a.m2, false, best_d, best_o, best_dc2);
#pragma unroll
        for (int o = 0; o < NOFF; ++o)
            if (!S::PRUNE || o != 4)
                candidate<SLICO, S::PRUNE>(cc[o], cp[o], o, l0, l1, l2, fy,
                                           fx, a.sw, a.m2, S::PRUNE, best_d,
                                           best_o, best_dc2);
        if (y < a.height && x < a.width) {          // pad pixels add nothing
            float* s = mine + best_o * NSUM * T;
            s[0] = __fadd_rn(s[0], l0);
            s[T] = __fadd_rn(s[T], l1);
            s[2 * T] = __fadd_rn(s[2 * T], l2);
            s[3 * T] = __fadd_rn(s[3 * T], fy);
            s[4 * T] = __fadd_rn(s[4 * T], fx);
            s[5 * T] = __fadd_rn(s[5 * T], 1.0f);
            if (SLICO) {
                float* m = mine + (NOFF * NSUM + best_o) * T;
                *m = fmaxf(*m, best_dc2);
            }
        }
    }
    __syncthreads();
    // warp w reduces channels w, w + WARPS, ...: each lane first adds its
    // T / 32 values of every channel (and zeroes them), then the channels'
    // shuffle trees run side by side
    const int warp = tid / 32, lane = tid % 32;
    float s[S::PER_WARP];
#pragma unroll
    for (int i = 0; i < S::PER_WARP; ++i) {
        const int k = warp + i * S::WARPS;
        s[i] = 0.0f;
        if (k >= S::NACC) continue;
        const bool is_max = SLICO && k >= NOFF * NSUM;
        float* ch = acc + k * T + lane;
#pragma unroll
        for (int j = 0; j < T; j += 32) {
            s[i] = is_max ? fmaxf(s[i], ch[j]) : __fadd_rn(s[i], ch[j]);
            ch[j] = 0.0f;
        }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int i = 0; i < S::PER_WARP; ++i) {
            const bool is_max = SLICO && warp + i * S::WARPS >= NOFF * NSUM;
            const float v = __shfl_xor_sync(0xffffffffu, s[i], m);
            s[i] = is_max ? fmaxf(s[i], v) : __fadd_rn(s[i], v);
        }
    float* out = part + (size_t)t * NOFF * S::PCH;
#pragma unroll
    for (int i = 0; i < S::PER_WARP; ++i) {
        const int k = warp + i * S::WARPS;
        if (lane != 0 || k >= S::NACC) continue;
        out[k >= NOFF * NSUM ? (k - NOFF * NSUM) * S::PCH + NSUM
                             : (k / NSUM) * S::PCH + k % NSUM] = s[i];
    }
}

template <bool SLICO>
__global__ void __launch_bounds__(Sched<SLICO>::T, Sched<SLICO>::MIN_BLOCKS)
slic_schedule_kernel(ScheduleArgs a) {
    using S = Sched<SLICO>;
    __shared__ float acc[S::NACC * S::T];
    __shared__ float red[NOFF][8];
    __shared__ __align__(16) float cen[NOFF][8];
    cg::grid_group grid = cg::this_grid();
    const int n_tiles = a.gh * a.gw;
    const size_t n_cen = (size_t)n_tiles * S::NC;
    const size_t n_part = (size_t)n_tiles * NOFF * S::PCH;
    for (int k = 0; k < S::NACC; ++k) acc[k * S::T + threadIdx.x] = 0.0f;
    for (int r = 0; r < a.n_upd; ++r) {
        for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
            neighbour_centres<SLICO>(a, r, t, a.cen + (r & 1) * n_cen, false,
                                     red, cen);
            assign_pool_tile<SLICO>(a, t, cen, acc, a.part + (r & 1) * n_part);
        }
        grid.sync();
    }
    // with n_upd = 0 this writes the seeds (and M = init_m2)
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        neighbour_centres<SLICO>(a, a.n_upd, t, a.out, true, red, cen);
}

// One cooperative grid of as many blocks as the card holds co-resident (at
// most one per tile); a grid the card cannot hold is refused and its error
// returned.
template <bool SLICO>
static int launch_schedule(ScheduleArgs a, cudaStream_t st) {
    void (*fn)(ScheduleArgs) = slic_schedule_kernel<SLICO>;
    static int resident[64];             // co-resident blocks, per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int n_sm = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, (const void*)fn, Sched<SLICO>::T, 0);
        if (err != cudaSuccess) return (int)err;
        if (per_sm * n_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        resident[dev] = per_sm * n_sm;
    }
    const int blocks = min(resident[dev], a.gh * a.gw);
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(Sched<SLICO>::T), args, 0, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// n_upd >= 0 rounds from the (gh, gw, 5) seeds c_in to out (gh, gw, 5|6);
// scratch holds 2 * gh * gw * (NC + 9 * PCH) floats (NC, PCH = 5, 6 or, with
// slico, 6, 7).
extern "C" int slic_schedule(const void* lab, const void* c_in, void* out,
                             void* scratch, float sw, float m2, float init_m2,
                             int height, int width, int gh, int gw, int step,
                             int n_upd, int slico, void* stream) {
    if (n_upd < 0) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)gh * gw;
    ScheduleArgs a;
    a.lab = (const __nv_bfloat16*)lab;
    a.c_in = (const float*)c_in;
    a.out = (float*)out;
    a.cen = (float*)scratch;
    a.part = a.cen + 2 * n * (slico ? 6 : 5);
    a.sw = sw;
    a.m2 = m2;
    a.init_m2 = init_m2;
    a.height = height;
    a.width = width;
    a.gh = gh;
    a.gw = gw;
    a.step = step;
    a.n_upd = n_upd;
    cudaStream_t st = (cudaStream_t)stream;
    return slico ? launch_schedule<true>(a, st) : launch_schedule<false>(a, st);
}
