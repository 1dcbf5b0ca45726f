// Grid-structured superpixel lookup and conn4 adjacency presence.
//
// Replaces two TPU kernels of pyimsegm_tpu/ops/grid_pallas.py:
//   grid_lookup_pallas (_lookup_kernel): per-pixel table[label] for labels
//     that lie in the 3x3 seed window of their pixel's tile, 0 elsewhere;
//   grid_adjacency_presence_pallas (_adjacency_kernel): for each tile and
//     each routing offset of the first endpoint, a 25-bit word of which
//     relative seed offsets its conn4 right/down neighbour pairs reach.
// The plain twins are in pyimsegm_tpu_torch/ops/grid_cuda.py.
//
// Bound: device memory.  The lookup reads 4 B of label and writes 4*C B per
// pixel (the (K, C) table stays in L1/L2); the adjacency reads 4 B of label
// per pixel (its down neighbour is the next row's read) and writes 36 B per
// tile.
// Design: the lookup is one thread per pixel, a plain gather guarded by the
// window test.  The adjacency is one block per tile: each pixel ORs its two
// pair bits into one of 9 shared-memory words picked by its own offset code
// (OR is order-free, so shared atomics keep the result deterministic), and
// the block writes its 9 words.  The TPU kernel's selector matmuls and the
// OR tree over sublanes exist only for the TPU and are not carried over.
// Labels below 0 (the -2 of the image edge and the pad) are tested before any
// division: C's '/' truncates where JAX's '//' floors.

#include <cuda_runtime.h>

#define NOFF 9
#define ADJ_THREADS 256

__global__ void grid_lookup_kernel(const float* __restrict__ table,  // (K, C)
                                   const int* __restrict__ labels,   // (H, W)
                                   float* __restrict__ out,          // (H, W, C)
                                   int height, int width, int c, int gh, int gw,
                                   int step) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * width) return;
    const int y = (int)(i / width), x = (int)(i % width);
    const int l = labels[i];
    bool ok = l >= 0 && l < gh * gw;
    if (ok) {
        int dy = l / gw - y / step + 1, dx = l % gw - x / step + 1;
        ok = dy >= 0 && dy < 3 && dx >= 0 && dx < 3;
    }
    for (int k = 0; k < c; ++k)
        out[i * c + k] = ok ? table[(size_t)l * c + k] : 0.0f;
}

__device__ __forceinline__ int pair_bit(int a, int b, int gw) {
    if (b < 0 || a < 0 || a == b) return 0;
    int dy = b / gw - a / gw, dx = b % gw - a % gw;
    if (dy < -2 || dy > 2 || dx < -2 || dx > 2) return 0;
    return 1 << ((dy + 2) * 5 + (dx + 2));
}

__global__ void __launch_bounds__(ADJ_THREADS)
grid_adjacency_kernel(const int* __restrict__ labels,  // (H, W)
                      int* __restrict__ words,         // (gh, gw, 9)
                      int height, int width, int gw, int step) {
    __shared__ int acc[NOFF];
    const int tx = blockIdx.x, ty = blockIdx.y;
    if (threadIdx.x < NOFF) acc[threadIdx.x] = 0;
    __syncthreads();
    for (int p = threadIdx.x; p < step * step; p += ADJ_THREADS) {
        const int y = ty * step + p / step, x = tx * step + p % step;
        if (y >= height || x >= width) continue;   // pad pixels are -2
        const int a = labels[(size_t)y * width + x];
        if (a < 0) continue;
        const int oy = a / gw - ty + 1, ox = a % gw - tx + 1;
        if (oy < 0 || oy >= 3 || ox < 0 || ox >= 3) continue;
        const int right = x + 1 < width ? labels[(size_t)y * width + x + 1] : -2;
        const int down = y + 1 < height ? labels[(size_t)(y + 1) * width + x] : -2;
        const int bits = pair_bit(a, right, gw) | pair_bit(a, down, gw);
        if (bits) atomicOr(&acc[oy * 3 + ox], bits);
    }
    __syncthreads();
    if (threadIdx.x < NOFF)
        words[((size_t)ty * gw + tx) * NOFF + threadIdx.x] = acc[threadIdx.x];
}

extern "C" int grid_lookup(const void* table, const void* labels, void* out,
                           int height, int width, int c, int gh, int gw,
                           int step, void* stream) {
    size_t n = (size_t)height * width;
    int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    grid_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)labels, (float*)out, height, width, c,
        gh, gw, step);
    return (int)cudaGetLastError();
}

extern "C" int grid_adjacency_presence(const void* labels, void* words,
                                       int height, int width, int gh, int gw,
                                       int step, void* stream) {
    dim3 grid(gw, gh);
    grid_adjacency_kernel<<<grid, ADJ_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)labels, (int*)words, height, width, gw, step);
    return (int)cudaGetLastError();
}
