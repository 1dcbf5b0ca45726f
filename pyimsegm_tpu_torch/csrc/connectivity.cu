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
// Design: the cooperative kernel of enforce.cuh, the one that row 12 runs
// after its seed (csrc/enforce.cu), so the three rows give the same labels:
// every pass in one grid, lines staged in shared memory, the loops stopping
// on a device flag.  Two launches (reach, then absorb, the reach plane in
// device memory between them) for row 13, one for row 14.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enforce.cuh"

// Row 13: the reach sweeps in one launch, then the absorb rounds in a
// second.  labels and reached are updated in place; flags holds max_sweeps
// + 1 + n_rounds + 1 ints, zeroed by the kernels.
extern "C" int reach_absorb(void* labels, void* reached, void* flags,
                            int height, int width, int gw, int step, int pack,
                            int max_sweeps, int n_rounds, void* stream) {
    const PassArgs a = {(int*)labels, (uint8_t*)reached, (int*)flags, height,
                        width, gw, step, pack, max_sweeps, n_rounds};
    const int err = launch_reach_absorb<true, false>(a, (cudaStream_t)stream);
    if (err) return err;
    return launch_reach_absorb<false, true>(a, (cudaStream_t)stream);
}

// Row 14: both phases in one launch.
extern "C" int reach_absorb_fused(void* labels, void* reached, void* flags,
                                  int height, int width, int gw, int step,
                                  int pack, int max_sweeps, int n_rounds,
                                  void* stream) {
    const PassArgs a = {(int*)labels, (uint8_t*)reached, (int*)flags, height,
                        width, gw, step, pack, max_sweeps, n_rounds};
    return launch_reach_absorb<true, true>(a, (cudaStream_t)stream);
}
