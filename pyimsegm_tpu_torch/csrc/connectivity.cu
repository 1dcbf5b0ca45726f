// Reach + absorb of the connectivity enforcement from a given anchor seed,
// for the images too wide for row 12's route.
//
// Replaces two TPU kernels of pyimsegm_tpu/ops/connectivity_pallas.py:
//   reach_absorb_pallas (_reach_kernel, then _absorb_kernel): two launches,
//     the reach plane written to device memory between them;
//   reach_absorb_fused_pallas (_reach_absorb_kernel): both phases in one
//     launch.
// The contract is the JAX package's global XLA path (pyimsegm_tpu/ops/
// grid.py: _connect_components, _absorb_unreached): at most MAX_SWEEPS
// reach sweeps and 2*step absorb rounds, each stopping early once a sweep
// or round changes nothing.  The TPU kernels' bands, halos, band-local reach
// and 12-round absorb cap were VMEM workarounds; the card holds the whole
// label plane, so there are no bands here, and the result equals row 12's
// (csrc/enforce.cu) on the same labels and seed exactly.  The plain twin is
// _connect_components of pyimsegm_tpu_torch/ops/enforce_cuda.py.
//
// Bound: device memory.  Each sweep or round reads and writes 5 B per
// pixel (4 B label, 1 B reach flag) twice, a row pass and a column pass; at
// 4096 x 4096 the plane (84 MB) exceeds the 50 MB L2.
// Design: one cooperative grid, sized to be co-resident (occupancy x SM
// count, capped at one warp per line), whose warps loop over the lines with
// the line scans of lines.cuh; grid.sync() separates the row pass from the
// column pass and one sweep or round from the next, which the host-enqueued
// launches of row 12 do by launch order.  flags[i] != 0 says sweep or round
// i-1 changed something; every thread reads it after the barrier and the
// whole grid leaves the loop together, so a converged phase costs nothing
// and no host synchronisation is needed.  REACH / ABSORB pick the phases a
// launch runs: two launches (reach, then absorb) for row 13, one for row
// 14.  A grid the card cannot hold co-resident is refused by
// cudaLaunchCooperativeKernel, and the error goes back to the wrapper,
// which raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lines.cuh"

namespace cg = cooperative_groups;

// One sweep (ABSORB false) or round (ABSORB true): every row, then every
// column, each by one warp; lane 0 of a warp that changed a pixel sets
// *flag_out.  Ends on a grid barrier.
template <bool ABSORB>
__device__ __forceinline__ void grid_pass(cg::grid_group& grid, int* labels,
                                          uint8_t* reached, int* flag_out,
                                          int height, int width, int gw,
                                          int step, int pack) {
    const int warp0 = blockIdx.x * LINE_WARPS + (threadIdx.x >> 5);
    const int n_warps = gridDim.x * LINE_WARPS;
    const bool lane0 = (threadIdx.x & 31) == 0;
    for (int line = warp0; line < height; line += n_warps)
        if (line_pass<ABSORB>(labels, reached, line, width, width, 1, 1, gw,
                              step, pack) && lane0)
            *flag_out = 1;
    grid.sync();
    for (int line = warp0; line < width; line += n_warps)
        if (line_pass<ABSORB>(labels, reached, line, height, 1, width, 0, gw,
                              step, pack) && lane0)
            *flag_out = 1;
    grid.sync();
}

template <bool REACH, bool ABSORB>
__global__ void __launch_bounds__(LINE_WARPS * 32)
reach_absorb_kernel(int* __restrict__ labels, uint8_t* __restrict__ reached,
                    int* __restrict__ flags, int height, int width, int gw,
                    int step, int pack, int max_sweeps, int n_rounds) {
    cg::grid_group grid = cg::this_grid();
    if (REACH) {
        for (int s = 0; s < max_sweeps; ++s) {
            if (s > 0 && *(volatile int*)(flags + s) == 0) break;
            grid_pass<false>(grid, labels, reached, flags + s + 1, height,
                             width, gw, step, pack);
        }
    }
    if (ABSORB) {
        int* af = flags + max_sweeps + 1;
        for (int i = 0; i < n_rounds; ++i) {
            if (i > 0 && *(volatile int*)(af + i) == 0) break;
            grid_pass<true>(grid, labels, reached, af + i + 1, height, width,
                            gw, step, pack);
        }
    }
}

template <bool REACH, bool ABSORB>
static int launch(int* labels, uint8_t* reached, int* flags, int height,
                  int width, int gw, int step, int pack, int max_sweeps,
                  int n_rounds, cudaStream_t st) {
    void (*fn)(int*, uint8_t*, int*, int, int, int, int, int, int, int) =
        reach_absorb_kernel<REACH, ABSORB>;
    const int threads = LINE_WARPS * 32;
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, (const void*)fn, threads, 0);
    if (err != cudaSuccess) return (int)err;
    const int lines = height > width ? height : width;
    int blocks = per_sm * n_sm;
    const int need = (lines + LINE_WARPS - 1) / LINE_WARPS;
    if (blocks > need) blocks = need;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&labels, &reached, &flags, &height, &width, &gw, &step,
                    &pack, &max_sweeps, &n_rounds};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(threads), args, 0, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Row 13: the reach sweeps in one launch, the reach plane left in device
// memory, then the absorb rounds in a second.  labels and reached are
// updated in place; flags holds max_sweeps + 1 + n_rounds + 1 zeroed ints.
extern "C" int reach_absorb(void* labels, void* reached, void* flags,
                            int height, int width, int gw, int step, int pack,
                            int max_sweeps, int n_rounds, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int err = launch<true, false>((int*)labels, (uint8_t*)reached,
                                  (int*)flags, height, width, gw, step, pack,
                                  max_sweeps, n_rounds, st);
    if (err) return err;
    return launch<false, true>((int*)labels, (uint8_t*)reached, (int*)flags,
                               height, width, gw, step, pack, max_sweeps,
                               n_rounds, st);
}

// Row 14: both phases in one launch.
extern "C" int reach_absorb_fused(void* labels, void* reached, void* flags,
                                  int height, int width, int gw, int step,
                                  int pack, int max_sweeps, int n_rounds,
                                  void* stream) {
    return launch<true, true>((int*)labels, (uint8_t*)reached, (int*)flags,
                              height, width, gw, step, pack, max_sweeps,
                              n_rounds, (cudaStream_t)stream);
}
