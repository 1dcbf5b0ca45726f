// SLIC assignment + per-offset pooling, and the whole update schedule.
//
// Replaces the TPU kernels of pyimsegm_tpu/ops/slic_pallas.py:
//   slic_multi_update_pallas (_multi_update_kernel): the n_iter-1 assign +
//     update rounds, here slic_schedule_kernel, one cooperative launch for
//     the whole schedule, in plain or SLICO mode;
//   slic_update_labels_pallas (_slic_pass_kernel with labels and partials):
//     the final assignment, here one slic_assign_pool with labels, the
//     colour moments of a feature image and the routed per-seed sums;
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
// slic_pass_kernel (rows 3, 4, 5).  Bound: device memory and issue rate.
// A pass reads 6 B/px of bf16 Lab (plus 12 B/px of the f32 feature image
// and 4 B/px of written labels in the final pass) and evaluates 9 candidate
// distances (~17 flops each) per pixel with candidate(), the same distance
// as the schedule's.  One block per seed tile (step x step pixels) runs the
// schedule's tile body, assign_pool_tile: the 3x3 neighbour centres in
// registers, pixels walked by (row, column) increments, per-thread sums in
// shared memory indexed by the winning offset, each (offset, channel)
// reduced by one warp in a fixed order into per-(tile, offset) partials.
// The final pass (row 3) reads the (H, W, 3) feature image as it is, where
// the pixel lies in the image, and a second launch of the same C call
// (slic_route_kernel) routes the partials to per-seed sums in the order of
// combine_sums.  No global atomics, so a run is deterministic.
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

// One assignment of tile t (step x step pixels) by T threads: each pixel's
// first-best of the 9 candidates in cen (l, a, b, max(M, 1e-6), y, x), its
// label when labels != null, and with CH > 0 its pooled sums: per-thread
// sums in acc[channel][thread] (channel o * CH + c; in SLICO mode NOFF * CH
// + o holds the largest dc2), then each channel reduced by one warp into
// part (tile t's 9 x PCH partials).  CH pooled sum channels: 0 (labels
// only), 6 ([l, a, b, y, x, count]) or 12 (+ [v, v^2] of the (H, W, 3)
// feature image feat, read where the pixel lies in the image).  acc is all
// zero on entry and is left all zero.  A is any args struct with lab, sw,
// m2, height, width, gh, gw and step.
template <int T, int CH, bool SLICO>
struct Pool {
    static constexpr int PCH = CH > 0 ? CH + (SLICO ? 1 : 0) : 0;
    static constexpr int NACC = NOFF * PCH;          // per-thread sums
    static constexpr int WARPS = T / 32;
    static constexpr int PER_WARP = (NACC + WARPS - 1) / WARPS;
    // channels whose shuffle trees run side by side (registers)
    static constexpr int CHUNK = PER_WARP <= 32 ? PER_WARP : 27;
    static_assert(T % 32 == 0, "whole warps");
};

template <int T, int CH, bool SLICO, bool PRUNE, class A>
__device__ __forceinline__ void assign_pool_tile(
        const A& a, int t, const float (*cen)[8], float* acc, float* part,
        const float* feat, int* labels) {
    using P = Pool<T, CH, SLICO>;
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
        if (PRUNE)
            candidate<SLICO, true>(cc[4], cp[4], 4, l0, l1, l2, fy, fx, a.sw,
                                   a.m2, false, best_d, best_o, best_dc2);
#pragma unroll
        for (int o = 0; o < NOFF; ++o)
            if (!PRUNE || o != 4)
                candidate<SLICO, PRUNE>(cc[o], cp[o], o, l0, l1, l2, fy, fx,
                                        a.sw, a.m2, PRUNE, best_d, best_o,
                                        best_dc2);
        if (labels != nullptr)
            labels[idx] = (ty + best_o / 3 - 1) * a.gw + (tx + best_o % 3 - 1);
        if constexpr (CH > 0) {
            if (y < a.height && x < a.width) {      // pad pixels add nothing
                float* s = mine + best_o * CH * T;
                s[0] = __fadd_rn(s[0], l0);
                s[T] = __fadd_rn(s[T], l1);
                s[2 * T] = __fadd_rn(s[2 * T], l2);
                s[3 * T] = __fadd_rn(s[3 * T], fy);
                s[4 * T] = __fadd_rn(s[4 * T], fx);
                s[5 * T] = __fadd_rn(s[5 * T], 1.0f);
                if constexpr (CH == 12) {
                    const float* f = feat + ((size_t)y * a.width + x) * 3;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float v = f[c];
                        s[(6 + c) * T] = __fadd_rn(s[(6 + c) * T], v);
                        s[(9 + c) * T] = __fadd_rn(s[(9 + c) * T],
                                                   __fmul_rn(v, v));
                    }
                }
                if (SLICO) {
                    float* m = mine + (NOFF * CH + best_o) * T;
                    *m = fmaxf(*m, best_dc2);
                }
            }
        }
    }
    if constexpr (CH > 0) {
        __syncthreads();
        // warp w reduces channels w, w + WARPS, ...: each lane first adds
        // its T / 32 values of every channel (and zeroes them), then the
        // shuffle trees of CHUNK channels run side by side
        const int warp = tid / 32, lane = tid % 32;
        float* out = part + (size_t)t * P::NACC;
#pragma unroll
        for (int i0 = 0; i0 < P::PER_WARP; i0 += P::CHUNK) {
            float s[P::CHUNK];
#pragma unroll
            for (int i = 0; i < P::CHUNK; ++i) {
                const int k = warp + (i0 + i) * P::WARPS;
                s[i] = 0.0f;
                if (i0 + i >= P::PER_WARP || k >= P::NACC) continue;
                const bool is_max = SLICO && k >= NOFF * CH;
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
                for (int i = 0; i < P::CHUNK; ++i) {
                    const bool is_max =
                        SLICO && warp + (i0 + i) * P::WARPS >= NOFF * CH;
                    const float v = __shfl_xor_sync(0xffffffffu, s[i], m);
                    s[i] = is_max ? fmaxf(s[i], v) : __fadd_rn(s[i], v);
                }
#pragma unroll
            for (int i = 0; i < P::CHUNK; ++i) {
                const int k = warp + (i0 + i) * P::WARPS;
                if (lane != 0 || i0 + i >= P::PER_WARP || k >= P::NACC)
                    continue;
                out[k >= NOFF * CH ? (k - NOFF * CH) * P::PCH + CH
                                   : (k / CH) * P::PCH + k % CH] = s[i];
            }
        }
    }
}

// ---------------------------------------------------- assignment pass ---

// Block size per mode of the single pass: T_FEAT threads with the 12
// feature-moment channels, T_PLAIN otherwise (chosen by same-call A/B runs
// on the card, PERF.md).
template <int CH, bool SLICO>
struct Pass {
    static constexpr int T_FEAT = 64;
    static constexpr int T_PLAIN = 128;
    static constexpr int THREADS = CH == 12 ? T_FEAT : T_PLAIN;
};

struct PassArgs {
    const __nv_bfloat16* lab;    // (3, ph, pw)
    const float* centers;        // (gh, gw, NC)
    const float* feat;           // (height, width, 3) or null
    int* labels;                 // (ph, pw) or null
    float* part;                 // (gh, gw, 9, PCH) or null
    float sw, m2;
    int height, width, gh, gw, step;
};

// One block per seed tile: the 3x3 neighbour centres staged in shared
// memory (an out-of-grid neighbour gets a NaN l, which never wins), then
// assign_pool_tile.
template <int CH, bool SLICO>
__global__ void __launch_bounds__(Pass<CH, SLICO>::THREADS)
slic_pass_kernel(PassArgs a) {
    constexpr int T = Pass<CH, SLICO>::THREADS;
    constexpr int NC = SLICO ? 6 : 5;                // centre columns
    using P = Pool<T, CH, SLICO>;
    __shared__ float acc[P::NACC > 0 ? P::NACC * T : 1];
    __shared__ __align__(16) float cen[NOFF][8];
    const int t = blockIdx.x, tid = threadIdx.x;
    const int ty = t / a.gw, tx = t - ty * a.gw;
    if (tid < NOFF) {
        const int sy = ty + tid / 3 - 1, sx = tx + tid % 3 - 1;
        const bool ok = sy >= 0 && sy < a.gh && sx >= 0 && sx < a.gw;
        const float* c = a.centers + (ok ? ((size_t)sy * a.gw + sx) * NC : 0);
        cen[tid][0] = ok ? c[0] : __int_as_float(0x7fc00000);
        cen[tid][1] = ok ? c[1] : 0.0f;
        cen[tid][2] = ok ? c[2] : 0.0f;
        cen[tid][3] = SLICO && ok ? fmaxf(c[NC - 1], 1e-6f) : 0.0f;
        cen[tid][4] = ok ? c[3] : 0.0f;
        cen[tid][5] = ok ? c[4] : 0.0f;
    }
    for (int k = 0; k < P::NACC; ++k) acc[k * T + tid] = 0.0f;
    __syncthreads();
    assign_pool_tile<T, CH, SLICO, false>(a, t, cen, acc, a.part, a.feat,
                                          a.labels);
}

// One thread per (seed, channel): the 9 offset partials of the sum
// channels routed to their seed in the order of combine_sums (offsets
// added from 0.0f with __fadd_rn; an offset whose tile lies off the grid
// adds nothing).
__global__ void slic_route_kernel(const float* __restrict__ part,
                                  float* __restrict__ sums, int gh, int gw,
                                  int pch, int ch) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= gh * gw * ch) return;
    const int s = i / ch, c = i - s * ch, sy = s / gw, sx = s - sy * gw;
    float sum = 0.0f;
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        // pixels of tile (sy - di, sx - dj) that chose offset o
        const int py = sy - (o / 3 - 1), px = sx - (o % 3 - 1);
        if (py < 0 || py >= gh || px < 0 || px >= gw) continue;
        sum = __fadd_rn(sum, part[(((size_t)py * gw + px) * NOFF + o) * pch + c]);
    }
    sums[i] = sum;
}

template <int CH, bool SLICO>
static void launch_pass(const PassArgs& a, cudaStream_t st) {
    slic_pass_kernel<CH, SLICO><<<a.gh * a.gw, Pass<CH, SLICO>::THREADS, 0, st>>>(a);
}

// partials == nullptr: labels only.  feat != nullptr: 12 pooled channels
// (plain mode only).  slico != 0: centres (gh, gw, 6), partials 7 channels.
// sums != nullptr (with partials, plain mode): a second launch routes the
// partials to (gh, gw, 6|12) per-seed sums.
extern "C" int slic_assign_pool(const void* lab, const void* centers,
                                const void* feat, void* labels, void* partials,
                                void* sums, float sw, float m2, int height,
                                int width, int gh, int gw, int step, int slico,
                                void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (partials == nullptr && labels == nullptr) return (int)cudaErrorInvalidValue;
    if (slico && (feat != nullptr || sums != nullptr)) return (int)cudaErrorInvalidValue;
    if (sums != nullptr && partials == nullptr) return (int)cudaErrorInvalidValue;
    PassArgs a;
    a.lab = (const __nv_bfloat16*)lab;
    a.centers = (const float*)centers;
    a.feat = (const float*)feat;
    a.labels = (int*)labels;
    a.part = (float*)partials;
    a.sw = sw;
    a.m2 = m2;
    a.height = height;
    a.width = width;
    a.gh = gh;
    a.gw = gw;
    a.step = step;
    int ch = 6;
    if (slico) {
        if (partials == nullptr) launch_pass<0, true>(a, st);
        else launch_pass<6, true>(a, st);
    } else if (partials == nullptr) {
        launch_pass<0, false>(a, st);
    } else if (feat != nullptr) {
        ch = 12;
        launch_pass<12, false>(a, st);
    } else {
        launch_pass<6, false>(a, st);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || sums == nullptr) return (int)err;
    const int n = gh * gw * ch;
    slic_route_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)partials, (float*)sums, gh, gw, ch, ch);
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
            assign_pool_tile<S::T, NSUM, SLICO, S::PRUNE>(
                a, t, cen, acc, a.part + (r & 1) * n_part, nullptr, nullptr);
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
