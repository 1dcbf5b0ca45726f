// Line scans of the connectivity enforcement, shared by csrc/enforce.cu
// (row 12: one launch per row or column pass) and csrc/connectivity.cu
// (rows 13 and 14: cooperative grids that run every pass in one launch).
//
// One warp walks one line (a row or a column) in 32-pixel segments; each
// lane owns one pixel of a segment, warp shuffles give the segment's
// inclusive max/min scan, and the segment's last value carries into the
// next.  A lane reads and writes only its own pixels, in the forward and the
// reverse walk alike, so no memory is shared between lanes.
//   Reach:  a pixel joins when the nearest reached position behind it (ahead
//           of it) lies in its own same-label run (the scan of run
//           starts/ends).
//   Absorb: the nearest reached pixel's packed (position, label) is the max
//           scan of pos*pack + label (forward) or -pos*pack + label
//           (reverse); the label comes back by floor-mod, written as
//           '& (pack - 1)' since pack is a power of two (C's '%' truncates
//           toward zero); an unreached pixel takes it when it lies in the
//           pixel's own 3x3 seed window.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define LINE_WARPS 8
#define POS_INF (1 << 30)
#define PACK_NONE (-(1 << 30))

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

// Reach (ABSORB false) or absorb (ABSORB true) along one line, forward then
// reverse, by the whole warp.  The line is a row (rows = 1: line = y,
// pos = x) or a column (rows = 0: line = x, pos = y).  Returns, uniformly
// across the warp, whether any pixel of the line changed.
template <bool ABSORB>
__device__ __forceinline__ bool line_pass(int* __restrict__ labels,
                                          uint8_t* __restrict__ reached,
                                          int line, int len, int line_stride,
                                          int elem_stride, int rows, int gw,
                                          int step, int pack) {
    const int lane = threadIdx.x & 31;
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
    return __any_sync(FULL, changed);
}
