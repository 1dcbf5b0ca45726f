// Grid-structured superpixel lookup, conn4 adjacency presence, conn4 pair
// counts, the geometry + moments reduce with the min-size donor apply, and
// the generic per-superpixel sum of an (H, W, F) image.
//
// Replaces five TPU kernels of pyimsegm_tpu/ops/grid_pallas.py:
//   grid_reduce_pallas (_reduce_kernel): per-superpixel sums of F channels
//     of f32 or bf16 data (f32 accumulation), pixels routed by the offset
//     code of their label in their tile's 3x3 window;
//   grid_lookup_pallas (_lookup_kernel): per-pixel table[label] for labels
//     that lie in the 3x3 seed window of their pixel's tile, 0 elsewhere;
//   grid_adjacency_presence_pallas (_adjacency_kernel): for each tile and
//     each routing offset of the first endpoint, a 25-bit word of which
//     relative seed offsets its conn4 right/down neighbour pairs reach;
//     here also routed to the seeds and symmetrised into the (gh, gw, 25)
//     0/1 adjacency of ops/grid.py:grid_adjacency in the same C call;
//   grid_pair_count_pallas (_pair_count_kernel): the same pairs counted per
//     (tile, offset, channel), and the tile's pixel count per offset;
//   grid_moments_apply_pallas (_moments_apply_kernel): donor[label] applied
//     where the donor seed lies in the pixel's 3x3 window, then per-(tile,
//     offset) sums of [f, f^2, 1, y, x] over the merged labels, F = 3;
//   grid_moments_pallas (_moments_kernel): the same sums without a donor
//     table, for any F (the texture batteries reduce F = 18 or 60), as the
//     reduce below over the virtual channels [f, f^2, 1, y, x].
// The plain twins are in pyimsegm_tpu_torch/ops/grid_cuda.py.
//
// Bound: device memory.  The lookup reads 4 B of label and writes 4*C B per
// pixel (the (K, C) f32 or int32 table stays in L1/L2); the adjacency and
// the pair count read 4 B of label per pixel (the down neighbour is the
// next row's read) and write 100 B (the routed adjacency) / 140 B (the
// routed triple) per seed; the moments read 4 + 12 B per pixel (and write
// 4 B of merged label) and write 324 B per tile.
// Design: the lookup is four neighbouring pixels per thread of a block row
// per image row (no 64-bit division), a gather guarded by the window test,
// templated on C (1-4, and a generic kernel) so that the stores are 16-byte
// vectors where the layout allows; it copies 4-byte words, so f32 and int32
// tables need no cast.  The other
// three are one block per tile.  The pair count (row 10) and the adjacency
// (row 11) are one pass, templated on what it keeps: it stages its tile's
// labels, one row below and one column to the right in shared memory once
// (coalesced rows; each label read from device memory about once, where
// each pixel read three), in bands of rows (and of columns where a tile row
// does not fit the stage), each label beside its window code (no division:
// the window code below; a pair's channel from the two codes, or from d =
// b - a and the first endpoint's window column where the neighbour lies
// outside the window, in place of four divisions and two modulos by gw a
// pair).  Row 10 counts pixels by nine ballots a warp and round and adds
// pairs by shared atomics (integer adds are order-free, so both are exact
// and deterministic; the f32 outputs are exact integers); row 11 sets a
// shared flag per (offset, channel) with a plain store (presence is an OR:
// idempotent and order-free, so racing stores of 1 give the same bits) and
// packs the 25 flags of each offset into its word.  A second launch routes
// to the seeds, one thread per seed and channel: row 10 adds the counts and
// symmetrises the contacts (ops/grid.py:counts_and_contacts's triple), row
// 11 ORs the routed bit with the partner seed's flipped one and masks the
// off-grid and self channels (ops/grid.py:grid_adjacency), so neither call
// runs a torch op.  The moments (row 8) add each
// pixel's 9 channels into 9 x 9 per-thread sums in shared memory, indexed
// by the merged label's offset (9 adds per pixel, where register sums would
// need 81 predicated ones; laid out [channel][thread], so a warp never shares a
// bank); each (offset, channel) is then reduced by one warp, a fixed
// strided sum and a shuffle tree: no float atomics, so a run is
// deterministic.  Where the width allows, a thread reads 4-pixel quads (16
// B of labels, 48 B of features) and stores the merged labels as one
// 16-byte vector.  The route kernel below then adds the 9 partials of each
// seed, so the call is two launches and no torch routing.  The reduce
// (rows 6 and 7) must read 4F (2F for bf16) + 4 B per pixel, and does so
// once (up to 128 channels, 256 at VEC 2 or 4; wider data goes in channel
// ranges, a grid row each, and each range reads the labels again): one
// block per tile turns the tile's labels into a byte map of
// offset codes in shared memory, a band of rows at a time (and of columns
// where a tile row is longer than the map; no division per pixel: the
// tile's row and column come from the block, the label's window offset
// from three subtractions), then thread t owns VEC = 4, 2 or 1
// neighbouring channels (16-, 8- or 4-byte loads, as F and the alignment
// allow) and walks the
// tile's pixels ng apart, so that neighbouring threads read neighbouring
// words of the (H, W, F) rows; each thread loads 8 pixels (4 at VEC = 2)
// before it adds them (staging rows through shared memory with cp.async
// measured slower: its per-band barriers left the loads idle).  Row 7 takes
// [f, f^2] from the same loaded value and [1, y, x] from the code map and
// the pixel's row and column (warp ballots and integer reduces into
// per-warp 64-bit sums: exact at any seed step, no atomics).  A thread adds
// into registers while its pixels keep one code and flushes into per-thread
// shared slots indexed by the code when it changes (no 9-way predication
// per value, no float atomics); after each band (one, as a rule) teams of
// lanes add the slots into the tile's sums in a fixed order, so two runs
// give equal bits, and no f32 chain outgrows a band at a large seed step
// (one chain over a whole 3500 x 3500 tile leaves the twin's bar on
// zero-mean data, PERF.md).  At F = 60 that is ~6 issued
// instructions per value, under the byte bound.  The route kernel, one
// thread per (seed, channel), adds the 9 partials of each seed in the order
// of combine_sums: two launches a call.  The TPU kernels' selector
// matmuls, lo/hi field packing and OR trees exist only for the TPU and are
// not carried over.
// Labels below 0 (the -2 of the image edge and the pad) are tested before any
// division: C's '/' truncates where JAX's '//' floors.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define NOFF 9
// rows 6 and 7: block threads (half where a thread loads 4 channels; a
// block takes at most threads x channels-a-thread channels), blocks an SM
// must hold (the 910 tiles of 884x1200 at sp_size 35 in one wave), pixels a
// thread loads before it adds them (16 for one sum a pixel, 8 for f and
// f^2 or 4 channels, 4 at 2 channels, where 8 spill at the register cap;
// same-call A/Bs, PERF.md), labels a block reads before it codes them, and
// bytes of the code map (a band of the tile's rows; of its columns too
// where a tile row is longer, so that any seed step fits)
#define RED_THREADS 128
#define RED_MIN_BLOCKS 8
#define RED_UNROLL(NV, VEC) \
    ((VEC) == 2 ? 4 : (NV) == 1 && (VEC) == 1 ? 16 : 8)
#define RED_LABELS_STEP 512
#define RED_CODES 16384
#define NCH 25
// rows 10 and 11: block threads, and the most labels a block stages at
// once (40 KB with their codes): a band of its tile's rows + 1 row, each
// the tile row + 1 column, while 2 x (step + 1) labels fit; else a band of
// PAIR_STAGE / 2 - 1 columns + 1 and one row + 1 (pair_band)
#define PAIR_THREADS 256
#define PAIR_STAGE 8192
// labels a thread of rows 10 and 11 loads before it codes them (1, 2, 4
// and 8 in a same-call A/B on the card, PERF.md)
#define PAIR_LOADS 4
// row 8's block size, chosen by a same-call A/B on the card against 64 and
// 128 (PERF.md)
#define MOM_THREADS 96
#define MOM_CH 9
#define FULL 0xffffffffu
#define LOOKUP_THREADS 128
#define LOOKUP_PIXELS 4

// The table's words are copied as bits (f32 or int32 alike; 0 is both
// types' zero).
__device__ __forceinline__ bool in_window(int l, int k, int gw, int ty,
                                          int tx) {
    if (l < 0 || l >= k) return false;
    const int ly = l / gw, dy = ly - ty + 1, dx = l - ly * gw - tx + 1;
    return dy >= 0 && dy < 3 && dx >= 0 && dx < 3;
}

// One block row per image row (grid-stride over rows past 65535), each
// thread LOOKUP_PIXELS pixels of the row: the tile row is one division per
// row, the tile column one per pixel, all in 32 bits.  At C = 1, where the
// width is a multiple of four, a thread takes four neighbouring pixels, one
// 16-byte load of labels and one 16-byte store; otherwise its pixels are
// LOOKUP_THREADS apart, so that neighbouring threads write neighbouring
// pixels, each pixel's C = 2 or 4 words as one vector.
template <int C>
__global__ void __launch_bounds__(LOOKUP_THREADS)
grid_lookup_kernel(const unsigned int* __restrict__ table,  // (K, C)
                   const int* __restrict__ labels,          // (H, W)
                   unsigned int* __restrict__ out,          // (H, W, C)
                   int height, int width, int c, int k, int gw, int step) {
    const int base = blockIdx.x * LOOKUP_THREADS * LOOKUP_PIXELS;
    const bool quad = C == 1 && width % LOOKUP_PIXELS == 0;
    for (int y = blockIdx.y; y < height; y += gridDim.y) {
        const size_t row = (size_t)y * width;
        const int ty = y / step;
        if (quad) {
            const int x0 = base + threadIdx.x * LOOKUP_PIXELS;
            if (x0 >= width) return;
            const int4 l = *(const int4*)(labels + row + x0);
            *(uint4*)(out + row + x0) = make_uint4(
                in_window(l.x, k, gw, ty, x0 / step) ? table[l.x] : 0u,
                in_window(l.y, k, gw, ty, (x0 + 1) / step) ? table[l.y] : 0u,
                in_window(l.z, k, gw, ty, (x0 + 2) / step) ? table[l.z] : 0u,
                in_window(l.w, k, gw, ty, (x0 + 3) / step) ? table[l.w]
                                                           : 0u);
            continue;
        }
        int l[LOOKUP_PIXELS];
#pragma unroll
        for (int j = 0; j < LOOKUP_PIXELS; ++j) {
            const int x = base + threadIdx.x + j * LOOKUP_THREADS;
            l[j] = x < width ? labels[row + x] : -1;
        }
#pragma unroll
        for (int j = 0; j < LOOKUP_PIXELS; ++j) {
            const int x = base + threadIdx.x + j * LOOKUP_THREADS;
            if (x >= width) continue;
            const size_t i = row + x;
            const bool ok = in_window(l[j], k, gw, ty, x / step);
            if constexpr (C == 2) {
                ((uint2*)out)[i] = ok ? ((const uint2*)table)[l[j]]
                                      : make_uint2(0u, 0u);
            } else if constexpr (C == 4) {
                ((uint4*)out)[i] = ok ? ((const uint4*)table)[l[j]]
                                      : make_uint4(0u, 0u, 0u, 0u);
            } else {
                const int n = C > 0 ? C : c;
                for (int m = 0; m < n; ++m)
                    out[i * n + m] = ok ? table[(size_t)l[j] * n + m] : 0u;
            }
        }
    }
}

// Row 8's window code: the offset 0..8 of label l in the 3x3 seed window
// of tile (ty, tx), -1 where l is negative (tested before any division) or
// outside the window.
__device__ __forceinline__ int tile_code(int l, int ty, int tx, int gw) {
    if (l < 0) return -1;
    const int ly = l / gw, oy = ly - ty + 1, ox = l - ly * gw - tx + 1;
    return (oy >= 0 && oy < 3 && ox >= 0 && ox < 3) ? oy * 3 + ox : -1;
}

// One pixel of row 8: the donor apply, then its 9 moment channels added into
// the thread's accumulators mine[(o * MOM_CH + c) * MOM_THREADS].  Returns
// the merged label.  D: the donor table's int32 or int64 entries.
template <typename D>
__device__ __forceinline__ int moments_pixel(int l, float f0, float f1,
                                             float f2, int y, int x,
                                             const D* __restrict__ donor,
                                             int k, int ty, int tx, int gw,
                                             float* mine) {
    int o = tile_code(l, ty, tx, gw);
    const long long nl64 = (o >= 0 && l < k) ? (long long)donor[l] : -1;
    // a donor below 0 or beyond int range lies outside every window
    const int nl = (nl64 < 0 || nl64 > 0x7fffffffLL) ? -1 : (int)nl64;
    if (nl >= 0 && abs(nl / gw - ty) <= 1 && abs(nl % gw - tx) <= 1) {
        l = nl;
        o = tile_code(l, ty, tx, gw);
    }
    if (o >= 0) {
        float* s = mine + o * MOM_CH * MOM_THREADS;
        const float v[MOM_CH] = {f0, f1, f2, __fmul_rn(f0, f0),
                                 __fmul_rn(f1, f1), __fmul_rn(f2, f2), 1.0f,
                                 (float)y, (float)x};
#pragma unroll
        for (int c = 0; c < MOM_CH; ++c)
            s[c * MOM_THREADS] = __fadd_rn(s[c * MOM_THREADS], v[c]);
    }
    return l;
}

// The donor apply + moments of row 8 (F = 3), one block per tile.  quad: the
// width is a multiple of 4 and the pointers 16-byte aligned, so a thread
// takes the 4-pixel quads that overlap the tile's columns (one 16-byte label
// load, three 16-byte feature loads, one 16-byte store where the quad lies
// inside the tile) and keeps the pixels of its own tile; otherwise one pixel
// at a time.
template <typename D>
__global__ void __launch_bounds__(MOM_THREADS)
grid_moments_kernel(const float* __restrict__ feat,    // (H, W, 3)
                    const int* __restrict__ labels,    // (H, W)
                    const D* __restrict__ donor,       // (K,)
                    int* __restrict__ merged,          // (H, W)
                    float* __restrict__ partials,      // (gh, gw, 9, 9)
                    int height, int width, int gh, int gw, int step,
                    bool quad) {
    __shared__ float acc[NOFF * MOM_CH * MOM_THREADS];
    const int tx = blockIdx.x, ty = blockIdx.y, tid = threadIdx.x;
    const int k = gh * gw;
    float* mine = acc + tid;
#pragma unroll
    for (int j = 0; j < NOFF * MOM_CH; ++j) mine[j * MOM_THREADS] = 0.0f;
    const int x0 = tx * step, x1 = min(x0 + step, width);
    const int y0 = ty * step, y1 = min(y0 + step, height);
    if (quad) {
        const int q0 = x0 / 4, nq = (x1 + 3) / 4 - q0;
        const int n = (y1 - y0) * nq;
        for (int i = tid; i < n; i += MOM_THREADS) {
            const int r = i / nq, xq = (q0 + i - r * nq) * 4, y = y0 + r;
            const size_t idx = (size_t)y * width + xq;
            const int4 l4 = *(const int4*)(labels + idx);
            const float4* fp = (const float4*)(feat + idx * 3);
            const float4 fa = fp[0], fb = fp[1], fc = fp[2];
            int m[4] = {l4.x, l4.y, l4.z, l4.w};
            const float f[12] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y,
                                 fb.z, fb.w, fc.x, fc.y, fc.z, fc.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (xq + j >= x0 && xq + j < x1)
                    m[j] = moments_pixel(m[j], f[3 * j], f[3 * j + 1],
                                         f[3 * j + 2], y, xq + j, donor, k,
                                         ty, tx, gw, mine);
            if (xq >= x0 && xq + 4 <= x1) {
                *(int4*)(merged + idx) = make_int4(m[0], m[1], m[2], m[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (xq + j >= x0 && xq + j < x1) merged[idx + j] = m[j];
            }
        }
    } else {
        const int w = x1 - x0, n = (y1 - y0) * w;
        for (int i = tid; i < n; i += MOM_THREADS) {
            const int r = i / w, y = y0 + r, x = x0 + i - r * w;
            const size_t idx = (size_t)y * width + x;
            merged[idx] = moments_pixel(labels[idx], feat[idx * 3],
                                        feat[idx * 3 + 1], feat[idx * 3 + 2],
                                        y, x, donor, k, ty, tx, gw, mine);
        }
    }
    __syncthreads();
    // each (offset, channel) reduced by one warp in a fixed order: warp w
    // takes channels w, w + MOM_WARPS, ...; each lane first adds its values
    // of every channel, then the channels' shuffle trees run side by side
    constexpr int MOM_WARPS = MOM_THREADS / 32;
    constexpr int PER_WARP = (NOFF * MOM_CH + MOM_WARPS - 1) / MOM_WARPS;
    const int warp = tid / 32, lane = tid % 32;
    float s[PER_WARP];
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
        const int j = warp + i * MOM_WARPS;
        s[i] = 0.0f;
        if (j >= NOFF * MOM_CH) continue;
#pragma unroll
        for (int r = 0; r < MOM_THREADS; r += 32)
            s[i] = __fadd_rn(s[i], acc[j * MOM_THREADS + lane + r]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i)
            s[i] = __fadd_rn(s[i], __shfl_xor_sync(FULL, s[i], m));
    float* out = partials + ((size_t)ty * gw + tx) * NOFF * MOM_CH;
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
        const int j = warp + i * MOM_WARPS;
        if (lane == 0 && j < NOFF * MOM_CH) out[j] = s[i];
    }
}

// Rows 6 and 7: the reduce.  Offset code 0..8 of label l in the 3x3 seed
// window whose top-left seed is base = (ty - 1) * gw + tx - 1, -1 where l is
// negative or outside the window.  No division: the window's three seed rows
// are three runs of labels gw apart; oxlo / oxhi drop the window columns off
// the grid's sides, where l - base would wrap into the next seed row.  A
// label >= K in the window keeps its code (the route drops it), as the twin.
__device__ __forceinline__ int window_code(int l, int base, int gw, int oxlo,
                                           int oxhi) {
    if (l < 0 || l > base + 2 * gw + 2) return -1;
    const int d = l - base;
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
        const int ox = d - oy * gw;
        if (ox >= oxlo && ox <= oxhi) return oy * 3 + ox;
    }
    return -1;
}

// Row 10: the relative seed channel (dy + 2) * 5 + dx + 2 of the conn4 pair
// (a, b), -1 where b is negative, equal to a, or not within +-2 seed rows
// and columns of a.  No division: a's seed column ax comes from its window
// code, and d = b - a = dy * gw + dx has at most one dy in -2..2 whose dx
// lies within +-2 with ax + dx on the grid (b >= 0 then makes b's seed row
// a's plus dy, as b / gw would).  A b >= K is counted wherever its dy and
// dx fall, as the twin's divisions do.
__device__ __forceinline__ int pair_ch(int a, int b, int ax, int gw) {
    if (b < 0 || b == a) return -1;
    const unsigned int d = (unsigned int)b - (unsigned int)a;
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
        const int dx = (int)(d - (unsigned int)(dy * gw));
        if (dx >= -2 && dx <= 2 && ax + dx >= 0 && ax + dx < gw)
            return (dy + 2) * 5 + dx + 2;
    }
    return -1;
}

// Row 10: the pair key o * 25 + channel of a pixel with window code o >= 0
// and its neighbour at staged index qb (-1: no pair).  Both codes in the
// window: the channel is e(ob) - e(o) + 12 with e(o) = 5 (o / 3) + o % 3
// (dy and dx from the two window cells); a neighbour outside the window
// (a label >= 0 of a seed beyond it) takes pair_ch on the labels.
__device__ __forceinline__ int pair_key(int o, int qa, int qb,
                                        const int* __restrict__ lab,
                                        const signed char* __restrict__ code,
                                        int tx, int gw) {
    const int ob = code[qb];
    if (ob == o) return -1;             // the same label
    const int oy = (o * 11) >> 5;       // o / 3 for o <= 8
    if (ob >= 0)
        return o * NCH + ob + 2 * ((ob * 11) >> 5) - o - 2 * oy + 12;
    const int b = lab[qb];
    if (b < 0) return -1;
    const int ch = pair_ch(lab[qa], b, tx - 1 + o - 3 * oy, gw);
    return ch >= 0 ? o * NCH + ch : -1;
}

// Rows 10 and 11: one block per tile.  The tile's labels with one row
// below and one column to the right (-2 off the image, as the reference
// pads) are staged in shared memory in bands of `band` rows (+ 1) by
// `bandw` columns (+ 1; the whole tile row unless it does not fit the
// stage), each beside its window code (no division: window_code); each
// pixel then reads its code and its two neighbours' from there, and a
// pair's channel from the two codes.  Row 10 (PRESENCE false): pixel counts
// by code, nine ballots a warp and round kept in registers, and pair counts
// by shared atomics (integers: exact and order-free); outputs as the
// twin's, cnt9 (gh, gw, 9, 25) and counts9 (gh, gw, 9), f32 of exact
// integers.  Row 11 (PRESENCE true): a flag per (offset, channel) set by a
// plain store (every store writes 1), packed into the words (gh, gw, 9)
// int32: bit c of word o is set where a pixel of code o has a neighbour at
// channel c.
template <bool PRESENCE>
__global__ void __launch_bounds__(PAIR_THREADS)
grid_pair_kernel(const int* __restrict__ labels,  // (H, W)
                 float* __restrict__ cnt9,        // (gh, gw, 9, 25)
                 float* __restrict__ counts9,     // (gh, gw, 9)
                 int* __restrict__ words,         // (gh, gw, 9)
                 int height, int width, int gw, int step, int band,
                 int bandw) {
    extern __shared__ int lab[];      // a band (+ 1 row, + 1 column), codes
    __shared__ int acc[NOFF * NCH];
    __shared__ int cnt[NOFF];
    const int tid = threadIdx.x, lane = tid & 31;
    const int tile = blockIdx.x, ty = tile / gw, tx = tile - ty * gw;
    const int x0 = tx * step, y0 = ty * step;
    const int tw = min(step, width - x0), th = min(step, height - y0);
    signed char* code =
        reinterpret_cast<signed char*>(lab + (band + 1) * (bandw + 1));
    const int base = (ty - 1) * gw + tx - 1;
    const int oxlo = tx == 0 ? 1 : 0, oxhi = tx == gw - 1 ? 1 : 2;
    for (int k = tid; k < NOFF * NCH; k += PAIR_THREADS) acc[k] = 0;
    if (!PRESENCE && tid < NOFF) cnt[tid] = 0;
    int count[NOFF];                    // the warp's pixels by code
#pragma unroll
    for (int o = 0; o < NOFF; ++o) count[o] = 0;
    for (int xb = 0; xb < tw; xb += bandw) {      // one, as a rule
        const int cw = min(bandw, tw - xb), sw = cw + 1;
        // row and column of a staged label and of a pixel without a
        // division: i / n = umulhi(i, ceil(2^32 / n)), exact while i * n <=
        // 2^32 (n > 1; a band one pixel wide, as 4096 at step 35 leaves,
        // takes i / 1 = i)
        const unsigned int ms = 0xffffffffu / sw + 1,
                           mp = 0xffffffffu / cw + 1;
        for (int yb = 0; yb < th; yb += band) {
            const int nb = min(band, th - yb);
            const int ns = (nb + 1) * sw, np = nb * cw;
            __syncthreads();                // the last band is counted
            for (int i0 = tid; i0 < ns; i0 += PAIR_THREADS * PAIR_LOADS) {
                int l[PAIR_LOADS];      // loaded before any is coded
#pragma unroll
                for (int u = 0; u < PAIR_LOADS; ++u) {
                    const int i = i0 + u * PAIR_THREADS;
                    const int r = __umulhi(i, ms), c = i - r * sw;
                    const int y = y0 + yb + r, x = x0 + xb + c;
                    l[u] = i < ns && y < height && x < width
                        ? __ldg(labels + (size_t)y * width + x) : -2;
                }
#pragma unroll
                for (int u = 0; u < PAIR_LOADS; ++u) {
                    const int i = i0 + u * PAIR_THREADS;
                    if (i >= ns) break;
                    lab[i] = l[u];
                    code[i] = (signed char)window_code(l[u], base, gw, oxlo,
                                                       oxhi);
                }
            }
            __syncthreads();                // the band is in
            for (int p0 = 0; p0 < np; p0 += PAIR_THREADS) {  // warp-uniform
                int o = -1, kr = -1, kd = -1;
                if (p0 + tid < np) {
                    const int r = cw == 1 ? p0 + tid
                                          : __umulhi(p0 + tid, mp);
                    const int q = p0 + tid + r;              // r sw + c
                    o = code[q];
                    if (o >= 0) {
                        kr = pair_key(o, q, q + 1, lab, code, tx, gw);
                        kd = pair_key(o, q, q + sw, lab, code, tx, gw);
                    }
                }
                if constexpr (PRESENCE) {
                    if (kr >= 0) acc[kr] = 1;
                    if (kd >= 0) acc[kd] = 1;
                } else {
#pragma unroll
                    for (int k = 0; k < NOFF; ++k)
                        count[k] += __popc(__ballot_sync(FULL, o == k));
                    if (kr >= 0) atomicAdd(&acc[kr], 1);
                    if (kd >= 0) atomicAdd(&acc[kd], 1);
                }
            }
        }
    }
    const size_t t = tile;
    if constexpr (PRESENCE) {
        __syncthreads();
        if (tid < NOFF) {
            int w = 0;
#pragma unroll
            for (int c = 0; c < NCH; ++c)
                w |= (acc[tid * NCH + c] != 0) << c;
            words[t * NOFF + tid] = w;
        }
        return;
    }
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < NOFF; ++k) atomicAdd(&cnt[k], count[k]);
    __syncthreads();
    for (int k = tid; k < NOFF * NCH; k += PAIR_THREADS)
        cnt9[t * NOFF * NCH + k] = (float)acc[k];
    if (tid < NOFF) counts9[t * NOFF + tid] = (float)cnt[tid];
}

// Row 10's route: the 9 offset partials of channel c routed to seed (y, x)
// (the tiles around it; exact integers, so any order gives the same sum).
__device__ __forceinline__ float pair_routed(const float* __restrict__ p,
                                             int y, int x, int gh, int gw,
                                             int nch, int c) {
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        const int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy >= 0 && sy < gh && sx >= 0 && sx < gw)
            s = __fadd_rn(s, p[(((size_t)sy * gw + sx) * NOFF + o) * nch + c]);
    }
    return s;
}

// One thread per (seed, channel 0..25): channel 25 the seed's pixel count,
// channel c < 25 its symmetric contact count, directed (seed -> seed at
// GRAPH_OFFSETS[c]) plus directed back (that seed -> this, channel 24 - c)
// where that seed lies on the grid (ops/grid.py:sym_contact_counts).
__global__ void grid_pair_route_kernel(const float* __restrict__ cnt9,
                                       const float* __restrict__ counts9,
                                       float* __restrict__ counts,  // (K,)
                                       float* __restrict__ sym25,   // (K, 25)
                                       int gh, int gw) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= gh * gw * (NCH + 1)) return;
    const int s = i / (NCH + 1), c = i - s * (NCH + 1);
    const int y = s / gw, x = s - y * gw;
    if (c == NCH) {
        counts[s] = pair_routed(counts9, y, x, gh, gw, 1, 0);
        return;
    }
    float v = pair_routed(cnt9, y, x, gh, gw, NCH, c);
    const int ny = y + c / 5 - 2, nx = x + c % 5 - 2;
    if (ny >= 0 && ny < gh && nx >= 0 && nx < gw)
        v = __fadd_rn(v, pair_routed(cnt9, ny, nx, gh, gw, NCH, NCH - 1 - c));
    sym25[(size_t)s * NCH + c] = v;
}

// Row 11's route: bit c of the 9 offset words routed to seed (y, x) (the
// tiles around it), OR-ed.
__device__ __forceinline__ unsigned int adj_routed(const int* __restrict__ w,
                                                   int y, int x, int gh,
                                                   int gw, int c) {
    unsigned int b = 0u;
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
        const int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy >= 0 && sy < gh && sx >= 0 && sx < gw)
            b |= (unsigned int)__ldg(w + ((size_t)sy * gw + sx) * NOFF + o);
    }
    return (b >> c) & 1u;
}

// One thread per (seed, channel c < 25): the seed's routed bit c OR the
// partner's (the seed at GRAPH_OFFSETS[c]) routed bit 24 - c, 0 where the
// partner lies off the grid and at c = 12 (the seed itself), as 0/1 f32
// (ops/grid.py:_sym_mask_adjacency).
__global__ void grid_adjacency_route_kernel(
        const int* __restrict__ words,  // (gh, gw, 9)
        float* __restrict__ adj,        // (gh, gw, 25)
        int gh, int gw) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= gh * gw * NCH) return;
    const int s = i / NCH, c = i - s * NCH;
    const int y = s / gw, x = s - y * gw;
    const int ny = y + c / 5 - 2, nx = x + c % 5 - 2;
    unsigned int v = 0u;
    if (c != NCH / 2 && ny >= 0 && ny < gh && nx >= 0 && nx < gw)
        v = adj_routed(words, y, x, gh, gw, c)
            | adj_routed(words, ny, nx, gh, gw, NCH - 1 - c);
    adj[i] = v ? 1.0f : 0.0f;
}

// Row 7's [count, sum dy, sum dx] of a warp's pixels, per offset code
// present among them (dy, dx: the pixel's row and column in its tile): a
// ballot and two integer reduces per code, added by lane 0 into the warp's
// own 64-bit sums (integers: exact, no atomics; a warp's sum of tile rows
// can pass 2^32 from a step of 2048 on).  Every lane of the warp calls it.
__device__ __forceinline__ void add_geometry(int o, int dy, int dx, int lane,
                                             unsigned long long* mine) {
    unsigned int present = __reduce_or_sync(FULL, o >= 0 ? 1u << o : 0u);
    while (present) {
        const int oi = __ffs(present) - 1;
        present &= present - 1;
        const bool hit = o == oi;
        const unsigned int cnt = __popc(__ballot_sync(FULL, hit));
        const unsigned int sy = __reduce_add_sync(FULL, hit ? (unsigned)dy : 0u);
        const unsigned int sx = __reduce_add_sync(FULL, hit ? (unsigned)dx : 0u);
        if (lane == 0) {
            mine[oi * 3] += cnt;
            mine[oi * 3 + 1] += sy;
            mine[oi * 3 + 2] += sx;
        }
    }
}

// VEC neighbouring channels of one pixel as f32: one 4-, 8- or 16-byte
// load; bf16 widened by its bits (exact).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* v) {
    if constexpr (VEC == 4) {
        const float4 q = __ldg((const float4*)p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (VEC == 2) {
        const float2 q = __ldg((const float2*)p);
        v[0] = q.x; v[1] = q.y;
    } else {
        v[0] = __ldg(p);
    }
}

__device__ __forceinline__ float bf16_lo(unsigned int u) {
    return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int u) {
    return __uint_as_float(u & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float* v) {
    if constexpr (VEC == 4) {
        const uint2 q = __ldg((const uint2*)p);
        v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
        v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    } else if constexpr (VEC == 2) {
        const unsigned int q = __ldg((const unsigned int*)p);
        v[0] = bf16_lo(q); v[1] = bf16_hi(q);
    } else {
        v[0] = bf16_lo(__ldg((const unsigned short*)p));
    }
}

// One round of the data walk: the VEC channels of U pixels ng apart from
// pixel p of the band (row r, column c of the band) and their offset codes
// (-1 past the band's n pixels), loaded before any is added; p, r and c
// step on to the next round.
template <int U, int VEC, typename T>
__device__ __forceinline__ void load_round(const T* __restrict__ row0,
                                           const signed char* codes,
                                           float (&v)[U][VEC], int (&o)[U],
                                           int& p, int& r, int& c, int n,
                                           int ng, int ddr, int ddc, int cw,
                                           int width, int f) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
        o[u] = -1;
        if (p < n) {
            load_vec<VEC>(row0 + ((size_t)r * width + c) * f, v[u]);
            o[u] = codes[p];
        }
        p += ng;
        c += ddc;
        r += ddr;
        if (c >= cw) { c -= cw; ++r; }
    }
}

// Threads of a reduce block: RED_THREADS, half of it where a thread loads 4
// channels (F = 60 has 15 threads a pixel there).
#define RED_NT(VEC) ((VEC) == 4 ? RED_THREADS / 2 : RED_THREADS)

// A reduce block's slots acc[o][v][j][t] of one band added into the
// tile's (offset, kind, channel) sums out (set by the first band): channel
// ch summed over the ng groups by a team of L lanes (as many lanes as leave
// a team for every channel, at most 32 and ng): lane li adds groups li, li
// + L, ... of all 9 x NV (offset, kind) sums side by side, then a shuffle
// tree joins the lanes; a fixed order, so two runs give equal bits.
template <int NV, int VEC, int NT>
__device__ __forceinline__ void fold_slots(const float* acc, float* out,
                                           int fc, int f, int nch, int ng,
                                           int tpp, int tid, bool first) {
    int L = 1;
    while (L < 32 && 2 * L <= ng && NT / (2 * L) >= fc) L <<= 1;
    const int team = tid / L, li = tid & (L - 1), teams = NT / L;
    for (int ch0 = 0; ch0 < fc; ch0 += teams) {           // warp-uniform
        const int ch = ch0 + team;
        float s[NOFF * NV];
#pragma unroll
        for (int k = 0; k < NOFF * NV; ++k) s[k] = 0.0f;
        if (ch < fc) {
            const float* col = acc + (ch % VEC) * NT + ch / VEC;
            for (int gi = li; gi < ng; gi += L)
#pragma unroll
                for (int k = 0; k < NOFF * NV; ++k)
                    s[k] = __fadd_rn(s[k], col[k * VEC * NT + gi * tpp]);
        }
        for (int m = L / 2; m > 0; m >>= 1)
#pragma unroll
            for (int k = 0; k < NOFF * NV; ++k)
                s[k] = __fadd_rn(s[k], __shfl_xor_sync(FULL, s[k], m));
        if (ch < fc && li == 0)
#pragma unroll
            for (int k = 0; k < NOFF * NV; ++k) {
                float* o = out + (k / NV) * nch + (k % NV) * f + ch;
                *o = first ? s[k] : __fadd_rn(*o, s[k]);
            }
    }
}

// Per-(tile, offset) sums of the F channels of (H, W, F) data (NV = 1, row
// 6) or of [f, f^2] plus [1, y, x] (NV = 2, row 7; nch = 2F + 3), one block
// per tile and range of fr <= NT x VEC channels (blockIdx.y: one range for
// F <= NT x VEC; range 0 adds row 7's [1, y, x]).  Per band of tile rows
// (the whole tile where its map fits RED_CODES bytes; a tile row longer
// than RED_CODES is cut into bands of columns as well): every thread turns
// its labels into codes in a shared byte map (row 7 also adds each warp's
// count, y and x per code); then thread t owns VEC channels lc.. and walks
// pixels g, g + ng, ... of the band (g = t / tpp) in rounds of U, each
// round's loads before its adds (at VEC > 1 issued at the end of the round
// before), so that a block-step reads ng pixels x fr words, contiguous in
// the (H, W, F) layout where one range holds all F.
// A thread adds into registers while its pixels keep one code and flushes
// them into its slots acc[o][v][j][t] when the code changes; after each
// band, fold_slots adds the ng groups' slots into the tile's sums in a
// fixed order (a slot's chain of f32 adds spans one band, at most
// RED_CODES pixels, whatever the seed step).
template <typename T, int NV, int VEC>
__global__ void __launch_bounds__(RED_NT(VEC), RED_MIN_BLOCKS)
grid_reduce_kernel(const T* __restrict__ data,        // (H, W, F)
                   const int* __restrict__ labels,    // (H, W)
                   float* __restrict__ partials,      // (gh, gw, 9, nch)
                   int height, int width, int f, int fr, int gw,
                   int step) {
    constexpr int NT = RED_NT(VEC), NR = NV * VEC;
    constexpr int U = RED_UNROLL(NV, VEC), UL = RED_LABELS_STEP / NT;
    __shared__ float acc[NOFF * NR * NT];             // [o][v][j][t]
    __shared__ unsigned long long geo[NT / 32][NOFF * 3];  // [w][o][n, y, x]
    extern __shared__ signed char codes[];            // a band of the tile
    const int tid = threadIdx.x, lane = tid & 31;
    const int tile = blockIdx.x, ty = tile / gw, tx = tile - ty * gw;
    const int x0 = tx * step, y0 = ty * step;
    const int tw = min(step, width - x0), th = min(step, height - y0);
    const int bw = min(tw, RED_CODES), band = min(th, RED_CODES / bw);
    const int base = (ty - 1) * gw + tx - 1;
    const int oxlo = tx == 0 ? 1 : 0, oxhi = tx == gw - 1 ? 1 : 2;
    const int nch = NV == 2 ? 2 * f + 3 : f;
    const int c0 = blockIdx.y * fr, fc = min(fr, f - c0);   // this range
    const bool geometry = NV == 2 && blockIdx.y == 0;      // block-uniform
    float* out = partials + (size_t)tile * NOFF * nch + c0;
    if (geometry && lane < NOFF * 3) geo[tid / 32][lane] = 0u;
    const int tpp = fc / VEC, ng = NT * VEC / fc, g = tid / tpp;
    const T* src = data + c0 + (tid - g * tpp) * VEC;
    float* mine = acc + tid;
#pragma unroll
    for (int i = 0; i < NOFF * NR; ++i) mine[i * NT] = 0.0f;
    float run[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) run[i] = 0.0f;
    int cur = -1;
    // bands of rows, then of columns (one band, as a rule)
    for (int yb = y0, xb = x0; xb < x0 + tw;
         yb = yb + band < y0 + th ? yb + band : y0,
         xb = yb == y0 ? xb + bw : xb) {
        const int cw = min(bw, x0 + tw - xb);       // the band's columns
        const int n = min(band, y0 + th - yb) * cw;
        // the code map's walk (pixels tid, tid + NT, ...) and the data walk
        // (pixels g, g + ng, ...) of a band: row and column stepped, not
        // divided
        const int cdr = NT / cw, cdc = NT - cdr * cw;
        const int cr0 = tid / cw, cc0 = tid - cr0 * cw;
        const int ddr = ng / cw, ddc = ng - ddr * cw;
        const int dr0 = g / cw, dc0 = g - dr0 * cw;
        __syncthreads();                  // the last band's map is read
        int r = cr0, c = cc0;
        for (int p0 = 0; p0 < n; p0 += NT * UL) {         // warp-uniform
            int lab[UL], ys[UL], xs[UL];
#pragma unroll
            for (int u = 0; u < UL; ++u) {
                ys[u] = yb + r;
                xs[u] = xb + c;
                lab[u] = p0 + u * NT + tid < n
                    ? labels[(size_t)ys[u] * width + xs[u]] : -1;
                c += cdc;
                r += cdr;
                if (c >= cw) { c -= cw; ++r; }
            }
#pragma unroll
            for (int u = 0; u < UL; ++u) {
                const int p = p0 + u * NT + tid;
                const int o = p < n ? window_code(lab[u], base, gw, oxlo,
                                                  oxhi) : -1;
                if (p < n) codes[p] = (signed char)o;
                if (geometry)
                    add_geometry(o, ys[u] - y0, xs[u] - x0, lane,
                                 geo[tid / 32]);
            }
        }
        __syncthreads();                  // the codes are in
        if (g < ng) {
            // a round's loads at the top of its step at VEC = 1, at the end
            // of the step before at VEC > 1: a same-call A/B of the two loops
            // took 24.9 against 27.9 us at F = 7 f32 and 88.2 against 52.1 at
            // F = 30 bf16 (PERF.md)
            const T* row0 = src + ((size_t)yb * width + xb) * f;
            float v[U][VEC];
            int o[U];
            int dp = g, dr = dr0, dc = dc0;   // the data walk's next pixel
            if constexpr (VEC > 1)
                load_round<U, VEC>(row0, codes, v, o, dp, dr, dc, n, ng,
                                   ddr, ddc, cw, width, f);
            for (int q = g; q < n; q += U * ng) {
                if constexpr (VEC == 1)
                    load_round<U, VEC>(row0, codes, v, o, dp, dr, dc, n, ng,
                                       ddr, ddc, cw, width, f);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (o[u] < 0) continue;
                    if (o[u] != cur) {
                        if (cur >= 0) {
                            float* s = mine + cur * NR * NT;
#pragma unroll
                            for (int i = 0; i < NR; ++i) {
                                s[i * NT] = __fadd_rn(s[i * NT], run[i]);
                                run[i] = 0.0f;
                            }
                        }
                        cur = o[u];
                    }
#pragma unroll
                    for (int j = 0; j < VEC; ++j) {
                        run[j] = __fadd_rn(run[j], v[u][j]);
                        if constexpr (NV == 2)
                            run[VEC + j] = __fadd_rn(
                                run[VEC + j], __fmul_rn(v[u][j], v[u][j]));
                    }
                }
                if constexpr (VEC > 1)
                    if (dp < n)
                        load_round<U, VEC>(row0, codes, v, o, dp, dr, dc,
                                           n, ng, ddr, ddc, cw, width, f);
            }
        }
        // the band's slots folded into the tile's sums, so that no slot
        // adds more than a band's pixels (one band, as a rule: then the
        // sums are the slots' reduce, as without bands)
        if (cur >= 0) {
            float* s = mine + cur * NR * NT;
#pragma unroll
            for (int i = 0; i < NR; ++i) {
                s[i * NT] = __fadd_rn(s[i * NT], run[i]);
                run[i] = 0.0f;
            }
            cur = -1;
        }
        __syncthreads();                  // the band's slots are in
        fold_slots<NV, VEC, NT>(acc, out, fc, f, nch, ng, tpp, tid,
                                yb == y0 && xb == x0);
        if (yb + band < y0 + th || xb + bw < x0 + tw) {  // a band follows
            __syncthreads();              // the slots are read
#pragma unroll
            for (int i = 0; i < NOFF * NR; ++i) mine[i * NT] = 0.0f;
        }
    }
    if (geometry && tid < NOFF * 3) {        // the warps' sums, in order
        unsigned long long sum = 0;
        for (int w = 0; w < NT / 32; ++w) sum += geo[w][tid];
        const int k = tid % 3, n = tid - k;
        if (k > 0) {                       // back to image rows / columns
            unsigned long long cnt = 0;
            for (int w = 0; w < NT / 32; ++w) cnt += geo[w][n];
            sum += cnt * (unsigned long long)(k == 1 ? y0 : x0);
        }
        out[(tid / 3) * nch + 2 * f + k] = (float)sum;   // c0 = 0
    }
}

// One thread per (seed, channel): add the 9 routed offset partials in the
// order of slic_cuda.combine_sums.
__global__ void grid_route_kernel(const float* __restrict__ partials,  // (gh, gw, 9, F)
                                  float* __restrict__ out,             // (K, F)
                                  int gh, int gw, int f) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)gh * gw * f) return;
    const int s = (int)(i / f), c = (int)(i % f);
    const int y = s / gw, x = s % gw;
    float sum = 0.0f;
    for (int o = 0; o < NOFF; ++o) {
        const int sy = y - (o / 3 - 1), sx = x - (o % 3 - 1);
        if (sy < 0 || sy >= gh || sx < 0 || sx >= gw) continue;
        sum = __fadd_rn(sum, partials[(((size_t)sy * gw + sx) * NOFF + o) * f + c]);
    }
    out[i] = sum;
}

// table (K, C) of 4-byte words (f32 or int32), out (H, W, C) of the same.
extern "C" int grid_lookup(const void* table, const void* labels, void* out,
                           int height, int width, int c, int gh, int gw,
                           int step, void* stream) {
    const int per_block = LOOKUP_THREADS * LOOKUP_PIXELS;
    const dim3 grid((width + per_block - 1) / per_block,
                    height < 65535 ? height : 65535);
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int* t = (const unsigned int*)table;
    const int* lab = (const int*)labels;
    unsigned int* o = (unsigned int*)out;
    const int k = gh * gw;
    switch (c) {
    case 1:
        grid_lookup_kernel<1><<<grid, LOOKUP_THREADS, 0, st>>>(
            t, lab, o, height, width, c, k, gw, step);
        break;
    case 2:
        grid_lookup_kernel<2><<<grid, LOOKUP_THREADS, 0, st>>>(
            t, lab, o, height, width, c, k, gw, step);
        break;
    case 3:
        grid_lookup_kernel<3><<<grid, LOOKUP_THREADS, 0, st>>>(
            t, lab, o, height, width, c, k, gw, step);
        break;
    case 4:
        grid_lookup_kernel<4><<<grid, LOOKUP_THREADS, 0, st>>>(
            t, lab, o, height, width, c, k, gw, step);
        break;
    default:
        grid_lookup_kernel<0><<<grid, LOOKUP_THREADS, 0, st>>>(
            t, lab, o, height, width, c, k, gw, step);
    }
    return (int)cudaGetLastError();
}

// Rows 10 and 11: the rows and columns of a band, for every tile, so that
// (band + 1) x (bandw + 1) labels fit PAIR_STAGE (computed here: computed
// in the kernel by the same min(), nvcc 12.8's build ran the staging loop
// past its bound): whole tile rows while two of them fit, else one row of
// PAIR_STAGE / 2 - 1 columns.
static void pair_band(int step, int* band, int* bandw) {
    if (step + 1 <= PAIR_STAGE / 2) {
        *bandw = step;
        *band = PAIR_STAGE / (step + 1) - 1 < step
            ? PAIR_STAGE / (step + 1) - 1 : step;
    } else {
        *bandw = PAIR_STAGE / 2 - 1;
        *band = 1;
    }
}

template <bool PRESENCE>
static int pair_pass(const void* labels, void* cnt9, void* counts9,
                     void* words, int height, int width, int gh, int gw,
                     int step, cudaStream_t st) {
    int band, bandw;
    pair_band(step, &band, &bandw);
    grid_pair_kernel<PRESENCE><<<gh * gw, PAIR_THREADS,
                                 (band + 1) * (bandw + 1) * 5, st>>>(
        (const int*)labels, (float*)cnt9, (float*)counts9, (int*)words,
        height, width, gw, step, band, bandw);
    return (int)cudaGetLastError();
}

// Row 11: the presence words (gh, gw, 9) int32; with adj given, also the
// routed, symmetric (gh, gw, 25) 0/1 f32 adjacency, in a second launch.
extern "C" int grid_adjacency(const void* labels, void* words, void* adj,
                              int height, int width, int gh, int gw,
                              int step, void* stream) {
    if (step < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int err = pair_pass<true>(labels, nullptr, nullptr, words, height,
                                    width, gh, gw, step, st);
    if (err || adj == nullptr) return err;
    const int n = gh * gw * NCH;
    grid_adjacency_route_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const int*)words, (float*)adj, gh, gw);
    return (int)cudaGetLastError();
}

// Row 10: cnt9 (gh, gw, 9, 25) and counts9 (gh, gw, 9); with counts and
// sym25 given, also the routed triple's (K,) pixel counts and (gh, gw, 25)
// symmetric contacts, in a second launch.
extern "C" int grid_pair_count(const void* labels, void* cnt9, void* counts9,
                               void* counts, void* sym25, int height,
                               int width, int gh, int gw, int step,
                               void* stream) {
    if (step < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int err = pair_pass<false>(labels, cnt9, counts9, nullptr, height,
                                     width, gh, gw, step, st);
    if (err || counts == nullptr) return err;
    const int n = gh * gw * (NCH + 1);
    grid_pair_route_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)cnt9, (const float*)counts9, (float*)counts,
        (float*)sym25, gh, gw);
    return (int)cudaGetLastError();
}

static int route(const void* partials, void* out, int gh, int gw, int f,
                 cudaStream_t st) {
    int err = (int)cudaGetLastError();
    if (err) return err;
    size_t n = (size_t)gh * gw * f;
    grid_route_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const float*)partials, (float*)out, gh, gw, f);
    return (int)cudaGetLastError();
}

// Rows 6 and 7: one block per tile and channel range, VEC channels a thread
// where F and the data's alignment allow 16- or 8-byte loads; the code map
// takes a band of at most RED_CODES bytes of the tile, at any seed step.  F above the block's
// channel slots is split into equal ranges of a multiple of VEC channels,
// one grid row each (every range re-reads the labels).
template <typename T, int NV, int VEC>
static int reduce_vec(const T* data, const int* labels, float* partials,
                      int height, int width, int f, int gh, int gw, int step,
                      cudaStream_t st) {
    constexpr int slots = RED_NT(VEC) * VEC;
    const int ranges = (f + slots - 1) / slots;
    const int fr = ((f + ranges - 1) / ranges + VEC - 1) / VEC * VEC;
    const size_t codes = (size_t)step * step < RED_CODES
        ? (size_t)step * step : RED_CODES;
    const dim3 grid((unsigned int)gh * gw, (unsigned int)((f + fr - 1) / fr));
    grid_reduce_kernel<T, NV, VEC><<<grid, RED_NT(VEC), codes, st>>>(
        data, labels, partials, height, width, f, fr, gw, step);
    return (int)cudaGetLastError();
}

template <typename T, int NV>
static int reduce_launch(const T* data, const int* labels, float* partials,
                         int height, int width, int f, int gh, int gw,
                         int step, cudaStream_t st) {
    if (f < 1 || step < 1) return (int)cudaErrorInvalidValue;
    const uintptr_t a = (uintptr_t)data;
    if (f % 4 == 0 && a % (4 * sizeof(T)) == 0)
        return reduce_vec<T, NV, 4>(data, labels, partials, height, width, f,
                                    gh, gw, step, st);
    if (f % 2 == 0 && a % (2 * sizeof(T)) == 0)
        return reduce_vec<T, NV, 2>(data, labels, partials, height, width, f,
                                    gh, gw, step, st);
    return reduce_vec<T, NV, 1>(data, labels, partials, height, width, f, gh,
                                gw, step, st);
}

extern "C" int grid_reduce(const void* data, const void* labels,
                           void* partials, void* out, int height, int width,
                           int f, int gh, int gw, int step, int bf16,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int err = bf16
        ? reduce_launch<__nv_bfloat16, 1>((const __nv_bfloat16*)data,
                                          (const int*)labels,
                                          (float*)partials, height, width, f,
                                          gh, gw, step, st)
        : reduce_launch<float, 1>((const float*)data, (const int*)labels,
                                  (float*)partials, height, width, f, gh, gw,
                                  step, st);
    if (err) return err;
    return route(partials, out, gh, gw, f, st);
}

// Row 7: (K, 2F+3) sums of [f, f^2, 1, y, x] for any F.
extern "C" int grid_moments(const void* feat, const void* labels,
                            void* partials, void* out, int height, int width,
                            int f, int gh, int gw, int step, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int err = reduce_launch<float, 2>(
        (const float*)feat, (const int*)labels, (float*)partials, height,
        width, f, gh, gw, step, st);
    if (err) return err;
    return route(partials, out, gh, gw, 2 * f + 3, st);
}

extern "C" int grid_moments_apply(const void* feat, const void* labels,
                                  const void* donor, void* merged,
                                  void* partials, void* out, int height,
                                  int width, int gh, int gw, int step,
                                  int donor64, void* stream) {
    dim3 grid(gw, gh);
    cudaStream_t st = (cudaStream_t)stream;
    const bool quad = width % 4 == 0
        && (((uintptr_t)feat | (uintptr_t)labels | (uintptr_t)merged) & 15) == 0;
    if (donor64)
        grid_moments_kernel<<<grid, MOM_THREADS, 0, st>>>(
            (const float*)feat, (const int*)labels, (const long long*)donor,
            (int*)merged, (float*)partials, height, width, gh, gw, step,
            quad);
    else
        grid_moments_kernel<<<grid, MOM_THREADS, 0, st>>>(
            (const float*)feat, (const int*)labels, (const int*)donor,
            (int*)merged, (float*)partials, height, width, gh, gw, step,
            quad);
    return route(partials, out, gh, gw, MOM_CH, st);
}
