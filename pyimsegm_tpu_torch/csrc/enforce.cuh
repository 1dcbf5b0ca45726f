// Reach sweeps and absorb rounds of the connectivity enforcement as one
// cooperative kernel, shared by csrc/enforce.cu (row 12: after the anchor
// seed) and csrc/connectivity.cu (rows 13 and 14: from a given seed), so
// every route gives the same labels.
//
// Semantics (the JAX package's global XLA path, pyimsegm_tpu/ops/grid.py
// _connect_components and _absorb_unreached; the plain twin is
// _connect_components of pyimsegm_tpu_torch/ops/enforce_cuda.py).  A sweep
// or round scans every row forward then in reverse, then every column
// forward then in reverse; each scan sees the writes of the scans before it
// and reads its own line's pre-scan state:
//   Reach:  a pixel joins when the nearest reached position behind it lies
//           in its own same-label run: max-scan of reached positions >=
//           max-scan of run starts.  The reverse scan runs on negated
//           positions, so both directions are max-scans.
//   Absorb: the nearest reached pixel's packed (position, label) is the
//           max-scan of pos*pack + label (negated positions in reverse); the
//           label comes back by floor-mod, written as '& (pack - 1)' since
//           pack is a power of two; an unreached pixel takes it when it lies
//           in the pixel's own 3x3 seed window.
// At most max_sweeps sweeps and n_rounds rounds; flags[i] != 0 says sweep
// or round i-1 changed something, and a phase stops once a sweep or round
// changes nothing: the reference's early exit, exactly.
//
// Bound: latency and memory instructions.  A sweep or round reads 5 B per
// pixel (4 B label, 1 B reach flag) twice, a row pass and a column pass,
// all in L2 at the bench size, and writes only what it changes; a pass
// costs a few dependent round trips and the issue of its loads, not bytes.
// Design: one cooperative launch, grid.sync() between passes; the grid is
// sized to be co-resident (occupancy x SM count), and a grid the card
// cannot hold is refused by cudaLaunchCooperativeKernel, whose error goes
// back to the wrapper.  Every thread reads the flag after the barrier, so
// the grid leaves a loop together.  A pass stages each line once in shared
// memory, label and reach flag packed into one int: 16-byte loads of four
// labels and four flags where the rows are aligned for it (VEC_BATCH of
// them in flight per thread; scalar loads, LOAD_BATCH in flight,
// elsewhere), and only the pixels it changed are stored back.  It scans the
// staged line there: every thread walks a contiguous piece of a line for
// its aggregate, the aggregates are scanned across the pieces, and each
// thread re-walks its piece from its exclusive prefix; the forward re-walk
// also takes the aggregate of the reverse scan, so a pass walks each piece
// three times.  Rows: a warp per row, a lane per piece, warp shuffles.
// Columns: a block per strip of 16 columns (64 bytes of each row), 32
// pieces per column, shuffles within a warp and a shared table across
// warps.  A line longer than the stage is processed in chunks, the scan
// state carried from one to the next.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define FULL 0xffffffffu
#define LINE_WARPS 16
#define LINE_THREADS (LINE_WARPS * 32)
// pixels a block stages, one int each (stage_pixel; 160 KB)
#define STAGE_PIXELS 40960
#define STAGE_BYTES (STAGE_PIXELS * 4)
#define ROW_CHUNK (STAGE_PIXELS / LINE_WARPS)   // pixels of a row per warp
#define STRIP 16                                // columns of a strip
#define PIECES (LINE_THREADS / STRIP)           // pieces of a strip column
#define COL_CHUNK (STAGE_PIXELS / STRIP)        // rows of a strip per chunk
#define LOAD_BATCH 4                            // loads in flight per thread
#define VEC_BATCH 4                             // 16-byte loads in flight
// the twin's -INF of positions, and its 'no donor' of the packed scans
#define NEG_INF (-(1 << 30))
// the label beyond either end of a line (the twin's shift fill)
#define OFF_LINE (-9)

struct Scan {
    int a, b;
};

__device__ __forceinline__ Scan scan_max(Scan x, Scan y) {
    return {max(x.a, y.a), max(x.b, y.b)};
}

__device__ __forceinline__ Scan shfl_up(Scan v, int d) {
    return {__shfl_up_sync(FULL, v.a, d), __shfl_up_sync(FULL, v.b, d)};
}

__device__ __forceinline__ Scan shfl_down(Scan v, int d) {
    return {__shfl_down_sync(FULL, v.a, d), __shfl_down_sync(FULL, v.b, d)};
}

__device__ __forceinline__ Scan shfl_idx(Scan v, int src) {
    return {__shfl_sync(FULL, v.a, src), __shfl_sync(FULL, v.b, src)};
}

#define SCAN_NONE Scan{NEG_INF, NEG_INF}

// A staged pixel: label * 4 + changed * 2 + reach flag (labels may be
// negative).  A pass only ever sets the reach flag (and, absorbing, the
// label with it), and marks the pixel changed, so only changed pixels are
// stored back.
__device__ __forceinline__ int stage_pixel(int label, bool reached) {
    return label * 4 + reached;
}
__device__ __forceinline__ int stage_label(int v) { return v >> 2; }
__device__ __forceinline__ bool stage_reached(int v) { return v & 1; }
__device__ __forceinline__ bool stage_changed(int v) { return v & 2; }

// A thread's piece of a staged line: elements [i0, i1) at px[i * st], the
// line position of element i is pos0 + i; 'before' / 'after' are the labels
// next to the piece's ends (OFF_LINE beyond the line).
struct Piece {
    int* px;
    int st, i0, i1, pos0, before, after;
};

// The piece's aggregate in walk order (ascending when FWD): reach a = last
// reached key, b = last run-boundary key; absorb a = max packed donor.
template <bool ABSORB, bool FWD>
__device__ __forceinline__ Scan piece_aggregate(const Piece& p, int pack) {
    // the fields in registers: stores through px cannot alias them
    const int* __restrict__ px = p.px;
    const int st = p.st, i0 = p.i0, n = p.i1 - p.i0, pos0 = p.pos0;
    Scan s = SCAN_NONE;
    int behind = FWD ? p.before : p.after;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
        const int i = FWD ? i0 + j : i0 + n - 1 - j;
        const int v = px[i * st], l = stage_label(v);
        const int key = FWD ? pos0 + i : -(pos0 + i);
        if (ABSORB) {
            if (stage_reached(v)) s.a = max(s.a, key * pack + l);
        } else {
            if (stage_reached(v)) s.a = max(s.a, key);
            if (l != behind) s.b = max(s.b, key);
            behind = l;
        }
    }
    return s;
}

// Re-walk the piece from the exclusive prefix 'run' and apply the scan;
// returns whether an element changed.  With REV (forward walks only) it
// also accumulates into 'rev' the reverse scan's aggregate of the piece as
// the forward scan leaves it.  The pixel's (y, x) is (line, pos) for a row
// and (pos, line) for a column.
template <bool ABSORB, bool FWD, bool REV>
__device__ __forceinline__ bool piece_apply(const Piece& p, Scan run,
                                            Scan& rev, int pack, int line,
                                            bool rows, int gw, int step) {
    int* __restrict__ px = p.px;
    const int st = p.st, i0 = p.i0, n = p.i1 - p.i0, pos0 = p.pos0;
    const int after = p.after;
    bool changed = false;
    const int line_tile = line / step;
    int behind = FWD ? p.before : after;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
        const int i = FWD ? i0 + j : i0 + n - 1 - j;
        const int v = px[i * st], l = stage_label(v);
        const bool r = stage_reached(v);
        const int pos = pos0 + i;
        const int key = FWD ? pos : -pos;
        if (ABSORB) {
            int now = r ? v : 0;
            if (r) {
                run.a = max(run.a, key * pack + l);
            } else if (run.a > NEG_INF / 2) {
                const int dl = run.a & (pack - 1);
                const int ty = rows ? line_tile : pos / step;
                const int tx = rows ? pos / step : line_tile;
                if (abs(dl / gw - ty) <= 1 && abs(dl % gw - tx) <= 1) {
                    now = dl * 4 + 3;
                    px[i * st] = now;
                    changed = true;
                }
            }
            if (REV && stage_reached(now))
                rev.a = max(rev.a, -pos * pack + stage_label(now));
        } else {
            if (r) run.a = max(run.a, key);
            if (l != behind) {
                run.b = max(run.b, key);
                if (REV && j > 0) rev.b = max(rev.b, -(pos - 1));
            }
            behind = l;
            bool now = r;
            if (!r && run.a >= run.b) {
                px[i * st] = v | 3;
                changed = true;
                now = true;
            }
            if (REV && now) rev.a = max(rev.a, -pos);
        }
    }
    if (REV && !ABSORB && n > 0 && behind != after)
        rev.b = max(rev.b, -(pos0 + i0 + n - 1));
    return changed;
}

// Exclusive prefix of a lane's aggregate across the warp's lanes (lane
// order is line order), and the warp's total.
template <bool FWD>
__device__ __forceinline__ Scan row_exclusive(Scan incl, Scan& total) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        if (FWD) {
            const Scan o = shfl_up(incl, d);
            if (lane >= d) incl = scan_max(incl, o);
        } else {
            const Scan o = shfl_down(incl, d);
            if (lane + d < 32) incl = scan_max(incl, o);
        }
    }
    total = shfl_idx(incl, FWD ? 31 : 0);
    const Scan excl = FWD ? shfl_up(incl, 1) : shfl_down(incl, 1);
    return lane == (FWD ? 0 : 31) ? SCAN_NONE : excl;
}

// The same for the pieces of a strip column: thread = piece * STRIP +
// column, 32 / STRIP pieces to a warp; shuffles within the warp, the warp
// totals through 'totals' across the warps.
template <bool FWD>
__device__ __forceinline__ Scan col_exclusive(Scan incl,
                                              Scan (*totals)[STRIP],
                                              Scan& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = threadIdx.x % STRIP;
#pragma unroll
    for (int d = STRIP; d < 32; d <<= 1) {
        if (FWD) {
            const Scan o = shfl_up(incl, d);
            if (lane >= d) incl = scan_max(incl, o);
        } else {
            const Scan o = shfl_down(incl, d);
            if (lane + d < 32) incl = scan_max(incl, o);
        }
    }
    Scan run = FWD ? shfl_up(incl, STRIP) : shfl_down(incl, STRIP);
    if (FWD ? lane < STRIP : lane >= 32 - STRIP) run = SCAN_NONE;
    if (lane / STRIP == (FWD ? 32 / STRIP - 1 : 0)) totals[warp][col] = incl;
    __syncthreads();
    total = SCAN_NONE;
    for (int w = 0; w < LINE_WARPS; ++w) {
        const Scan t = totals[w][col];
        total = scan_max(total, t);
        if (FWD ? w < warp : w > warp) run = scan_max(run, t);
    }
    return run;
}

// One chunk of a line, by a warp (a row) or the block (a strip of columns).
// FWD and REV: both scans on the staged chunk (the whole line); else the
// one direction, with the carry and halo label of the chunks before it.
template <bool ABSORB, bool ROWS, bool FWD, bool REV>
__device__ __forceinline__ bool line_chunk(int* px, Scan (*totals)[STRIP],
                                           int len, int pos0, Scan& carry,
                                           int& halo, int line, bool active,
                                           int gw, int step, int pack) {
    Piece p;
    int lane_piece, per;
    if (ROWS) {
        lane_piece = threadIdx.x & 31;
        per = ((len + 31) / 32) | 1;          // odd: no bank conflicts
        p.px = px;
        p.st = 1;
    } else {
        lane_piece = threadIdx.x / STRIP;
        per = ((len + PIECES - 1) / PIECES) | 1;
        p.px = px + threadIdx.x % STRIP;
        p.st = STRIP;
    }
    p.pos0 = pos0;
    p.i0 = min(len, lane_piece * per);
    p.i1 = active ? min(len, p.i0 + per) : p.i0;
    p.before = p.after = OFF_LINE;
    if (!ABSORB && active) {
        p.before = p.i0 > 0 ? stage_label(p.px[(p.i0 - 1) * p.st])
                            : (FWD ? halo : OFF_LINE);
        p.after = p.i1 < len ? stage_label(p.px[p.i1 * p.st])
                             : (FWD ? OFF_LINE : halo);
    }
    Scan total, rev = SCAN_NONE;
    const Scan agg = piece_aggregate<ABSORB, FWD>(p, pack);
    Scan run = ROWS ? row_exclusive<FWD>(agg, total)
                    : col_exclusive<FWD>(agg, totals, total);
    bool changed = piece_apply<ABSORB, FWD, REV>(
        p, scan_max(carry, run), rev, pack, line, ROWS, gw, step);
    carry = scan_max(carry, total);
    if (!ABSORB && active)
        halo = stage_label(p.px[(FWD ? len - 1 : 0) * p.st]);
    if (REV) {
        if (!ROWS) totals += LINE_WARPS;      // the reverse table
        run = ROWS ? row_exclusive<false>(rev, total)
                   : col_exclusive<false>(rev, totals, total);
        Scan unused;
        changed |= piece_apply<ABSORB, false, false>(p, run, unused, pack,
                                                     line, ROWS, gw, step);
    }
    return changed;
}

// Loads go out LOAD_BATCH at a time before any is stored to the stage, so
// that a thread has that many L2 round trips in flight, not one; where the
// rows allow it, four pixels at a time (16 B of label, 4 B of flags).
// Element k of a chunk is at line position k / n_lines, line k % n_lines
// (a row: one line; a strip: n_lines columns).
__device__ __forceinline__ void stage_load(int* px, const int* labels,
                                           const uint8_t* reached, size_t base,
                                           int len, int n_lines, int lines_ok,
                                           size_t pos_stride, int tid,
                                           int threads) {
    const int n = len * n_lines;
    const bool vec = base % 4 == 0 && (n_lines == 1 || (
        pos_stride % 4 == 0 && lines_ok == n_lines && n_lines % 4 == 0));
    const int n4 = vec ? n / 4 : 0;
    for (int q0 = tid; q0 < n4; q0 += threads * VEC_BATCH) {
        int4 lv[VEC_BATCH];
        unsigned int rv[VEC_BATCH];
#pragma unroll
        for (int b = 0; b < VEC_BATCH; ++b) {
            const int k = 4 * (q0 + threads * b);
            const size_t at = base + (size_t)(k / n_lines) * pos_stride
                + k % n_lines;
            if (k < n) {
                lv[b] = __ldcg((const int4*)(labels + at));
                rv[b] = __ldcg((const unsigned int*)(reached + at));
            }
        }
#pragma unroll
        for (int b = 0; b < VEC_BATCH; ++b) {
            const int k = 4 * (q0 + threads * b);
            if (k >= n) continue;
            *(int4*)(px + k) = make_int4(
                stage_pixel(lv[b].x, rv[b] & 0xff),
                stage_pixel(lv[b].y, (rv[b] >> 8) & 0xff),
                stage_pixel(lv[b].z, (rv[b] >> 16) & 0xff),
                stage_pixel(lv[b].w, rv[b] >> 24));
        }
    }
    for (int k0 = 4 * n4 + tid; k0 < n; k0 += threads * LOAD_BATCH) {
        int v[LOAD_BATCH];
#pragma unroll
        for (int b = 0; b < LOAD_BATCH; ++b) {
            const int k = k0 + threads * b, c = k % n_lines;
            const size_t at = base + (size_t)(k / n_lines) * pos_stride + c;
            v[b] = k < n && c < lines_ok
                ? stage_pixel(__ldcg(labels + at), __ldcg(reached + at) != 0)
                : 0;
        }
#pragma unroll
        for (int b = 0; b < LOAD_BATCH; ++b)
            if (k0 + threads * b < n) px[k0 + threads * b] = v[b];
    }
}

template <bool ABSORB>
__device__ __forceinline__ void stage_store(const int* px, int* labels,
                                            uint8_t* reached, size_t base,
                                            int len, int n_lines,
                                            int lines_ok, size_t pos_stride,
                                            int tid, int threads) {
    for (int k = tid; k < len * n_lines; k += threads) {
        const int v = px[k], c = k % n_lines;
        if (!stage_changed(v) || c >= lines_ok) continue;
        const size_t at = base + (size_t)(k / n_lines) * pos_stride + c;
        if (ABSORB) labels[at] = stage_label(v);
        reached[at] = 1;
    }
}

// Row y (ROWS: by one warp with its own stage) or the strip of columns x0
// .. x0 + STRIP - 1 (by the whole block), forward then reverse.
template <bool ABSORB, bool ROWS>
__device__ bool line_pass(int* labels, uint8_t* reached, int at, int height,
                          int width, int* px, Scan (*totals)[STRIP], int gw,
                          int step, int pack) {
    const int len_all = ROWS ? width : height;
    const int chunk = ROWS ? ROW_CHUNK : COL_CHUNK;
    const int n_lines = ROWS ? 1 : STRIP;
    const int lines_ok = ROWS ? 1 : min(STRIP, width - at);
    const size_t stride = ROWS ? 1 : width;
    const int tid = ROWS ? threadIdx.x & 31 : threadIdx.x;
    const int threads = ROWS ? 32 : LINE_THREADS;
    const int line = ROWS ? at : at + threadIdx.x % STRIP;
    const bool active = line < (ROWS ? height : width);
    const int n_chunks = (len_all + chunk - 1) / chunk;
    bool changed = false;
    Scan carry = SCAN_NONE;
    int halo = OFF_LINE;
    for (int dir = 0; dir < (n_chunks == 1 ? 1 : 2); ++dir) {
        for (int c = 0; c < n_chunks; ++c) {
            const int ci = dir ? n_chunks - 1 - c : c;
            const int pos0 = ci * chunk, len = min(chunk, len_all - pos0);
            const size_t base = ROWS ? (size_t)at * width + pos0
                                     : (size_t)pos0 * width + at;
            stage_load(px, labels, reached, base, len, n_lines, lines_ok,
                       stride, tid, threads);
            if (ROWS) __syncwarp(); else __syncthreads();
            if (n_chunks == 1)
                changed |= line_chunk<ABSORB, ROWS, true, true>(
                    px, totals, len, pos0, carry, halo, line, active, gw,
                    step, pack);
            else if (dir == 0)
                changed |= line_chunk<ABSORB, ROWS, true, false>(
                    px, totals, len, pos0, carry, halo, line, active, gw,
                    step, pack);
            else
                changed |= line_chunk<ABSORB, ROWS, false, false>(
                    px, totals + LINE_WARPS, len, pos0, carry, halo, line,
                    active, gw, step, pack);
            if (ROWS) __syncwarp(); else __syncthreads();
            stage_store<ABSORB>(px, labels, reached, base, len, n_lines,
                                lines_ok, stride, tid, threads);
            if (ROWS) __syncwarp(); else __syncthreads();
        }
        carry = SCAN_NONE;
        halo = OFF_LINE;
    }
    return changed;
}

// One sweep (ABSORB false) or round (ABSORB true): every row, then every
// column; lane 0 of a warp that changed a pixel sets *flag_out.  Ends on a
// grid barrier.
// With stop_early (reach sweeps after the first), a row pass that changes
// nothing ends the sweep before its column pass (see reach_absorb_kernel).
template <bool ABSORB>
__device__ __forceinline__ void grid_pass(cg::grid_group& grid, int* labels,
                                          uint8_t* reached, int* flag_out,
                                          bool stop_early, int height,
                                          int width, int gw, int step,
                                          int pack, int* stage,
                                          Scan (*totals)[STRIP]) {
    const int warp = threadIdx.x >> 5;
    const bool lane0 = (threadIdx.x & 31) == 0;
    bool changed = false;
    // rows: one warp each, spread over the blocks first
    for (int y = warp * gridDim.x + blockIdx.x; y < height;
         y += gridDim.x * LINE_WARPS)
        changed |= line_pass<ABSORB, true>(labels, reached, y, height, width,
                                           stage + warp * ROW_CHUNK, totals,
                                           gw, step, pack);
    if (__any_sync(FULL, changed) && lane0) *flag_out = 1;
    grid.sync();
    if (stop_early && *(volatile int*)flag_out == 0) return;
    changed = false;
    for (int s = blockIdx.x; s * STRIP < width; s += gridDim.x)
        changed |= line_pass<ABSORB, false>(labels, reached, s * STRIP,
                                            height, width, stage, totals, gw,
                                            step, pack);
    if (__any_sync(FULL, changed) && lane0) *flag_out = 1;
    grid.sync();
}

struct PassArgs {
    int* labels;              // (H, W) labels, enforced in place
    uint8_t* reached;         // (H, W) reach flags
    int* flags;               // max_sweeps + 1 + n_rounds + 1 ints
    int height, width, gw, step, pack, max_sweeps, n_rounds;
};

// REACH / ABSORB pick the phases a launch runs; a launch zeroes the flags
// of its phases first.  A reach pass is idempotent (every run that holds a
// reached pixel is full after it), so once the row pass of a sweep after
// the first changes nothing, its column pass and every later sweep would
// change nothing too, and the phase stops there.
template <bool REACH, bool ABSORB>
__global__ void __launch_bounds__(LINE_THREADS, 1)
reach_absorb_kernel(PassArgs a) {
    extern __shared__ int stage[];
    __shared__ Scan totals[2 * LINE_WARPS][STRIP];
    cg::grid_group grid = cg::this_grid();
    int* af = a.flags + a.max_sweeps + 1;
    if (blockIdx.x == 0) {
        if (REACH)
            for (int i = threadIdx.x; i <= a.max_sweeps; i += LINE_THREADS)
                a.flags[i] = 0;
        if (ABSORB)
            for (int i = threadIdx.x; i <= a.n_rounds; i += LINE_THREADS)
                af[i] = 0;
    }
    grid.sync();
    if (REACH) {
        for (int s = 0; s < a.max_sweeps; ++s) {
            if (s > 0 && *(volatile int*)(a.flags + s) == 0) break;
            grid_pass<false>(grid, a.labels, a.reached, a.flags + s + 1,
                             s > 0, a.height, a.width, a.gw, a.step, a.pack,
                             stage, totals);
        }
    }
    if (ABSORB) {
        for (int i = 0; i < a.n_rounds; ++i) {
            if (i > 0 && *(volatile int*)(af + i) == 0) break;
            grid_pass<true>(grid, a.labels, a.reached, af + i + 1, false,
                            a.height, a.width, a.gw, a.step, a.pack, stage,
                            totals);
        }
    }
}

// Launch the phases in one cooperative grid of as many blocks as the card
// holds co-resident (at most one per row or column strip); returns a CUDA
// error code.
template <bool REACH, bool ABSORB>
static int launch_reach_absorb(PassArgs a, cudaStream_t st) {
    void (*fn)(PassArgs) = reach_absorb_kernel<REACH, ABSORB>;
    static int resident[64];             // co-resident blocks, per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int n_sm = 0, per_sm = 0;
        err = cudaFuncSetAttribute((const void*)fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   STAGE_BYTES);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm,
                                         cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, (const void*)fn, LINE_THREADS, STAGE_BYTES);
        if (err != cudaSuccess) return (int)err;
        if (per_sm * n_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        resident[dev] = per_sm * n_sm;
    }
    const int strips = (a.width + STRIP - 1) / STRIP;
    const int blocks = min(resident[dev], max(a.height, strips));
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(LINE_THREADS), args, STAGE_BYTES,
                                      st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
