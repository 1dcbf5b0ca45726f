// The GMM fit's products over the samples (EM's weighted first moments and
// centred second moments, k-means' weighted sums), each output a chain of
// fused multiply-adds in sample order from 0.  For a batch of restarts at
// the two benchmark fits' shapes, (N, D, C, R) = (107,328, 3, 2, 9) and
// (57,600, 9, 3, 9), that is the order of the kernel cuBLAS runs there,
// checked bit for bit, so those fits keep the plain products' bits
// (chip_smoke.py asserts that cuBLAS still picks that kernel); at other
// shapes the sums are within rounding of the plain products.  Unbatched
// first moments (one fit's weights (N, C)), which cuBLAS runs as a
// split-K GEMM, take the split mode: chains over chunks of `split`
// samples, one block a chunk, then the chunks' sums added in chunk order
// in float64 (split_reduce), within rounding of cuBLAS's split-K sums and
// nearer the exact sum than one chain of N.
//
// Replaces no TPU kernel: pyimsegm_tpu/models/gmm.py leaves EM and k-means
// to XLA.  The plain twins are the products of pyimsegm_tpu_torch/models/
// gmm.py's _weighted_sums_plain (w' x) and _centred_sums_plain
// ((x - mu)' diag(w) (x - mu)); the wrapper is
// pyimsegm_tpu_torch/models/gmm_cuda.py.  On an H100 cuBLAS runs them as
// sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1
// _ffma, one CTA of 64 threads a batch (9 to 27 CTAs), each output one
// thread's sequential FFMA chain over the N samples: 1.8 and 3.1 ms a
// product at N = 107,328 (the volume's fit), 1.0 and 1.9 ms at 57,600.  A
// float32 sum of 10^5 terms in another order differs by ~1e-5, and EM on
// the volume's collinear features carries that to ~1e-3 in the fit, so the
// order is kept and only the time is taken out of it.
//
// Bound: the chain's latency, N fused multiply-adds one after the other
// (4 cycles each: ~0.22 ms at N = 107,328 and 1.98 GHz); bytes (~2 MB a
// product) and operations (~10 MFLOP) are far below it.  Design:
//   * one block a batch (a restart, or a (restart, component) for the
//     centred sums); a thread owns an output (up to GC_CH where a batch has
//     more than GC_T) and runs its chain, reading the operands of the next
//     16 samples while it adds the current ones, so a step costs about one
//     FFMA latency;
//   * the samples go through shared memory in tiles of 512 (256 where D >
//     16), two samples a thread, double buffered: each thread's global
//     loads of its samples of the next tile are in flight while the chains
//     walk the current one; the operands are staged transposed (a row of
//     the tile + 4 floats an operand column: 16-byte reads, no bank
//     conflict), the centred sums' operands computed as they are staged
//     with the twin's rounded operations ((x - mu) w and x - mu), so
//     nothing of R x C x N x D reaches device memory;
//   * a restart whose EM has stopped (active[r] == 0) does no work; its
//     outputs are 0, which EM discards as the twin's torch.where does.

#include <cuda_runtime.h>

#define GC_T 256                    // threads a block
#define GC_MAXD 32
#define GC_MAXC 8
#define GC_CH ((GC_MAXD * GC_MAXD + GC_T - 1) / GC_T)   // outputs a thread

struct ChainArgs {
    const float* x;                 // (K, D)
    const float* w;                 // (R, K, C)
    const float* mu;                // (R, C, D): centres (mode 1)
    const unsigned char* active;    // (R,) or null
    float* out;                     // (R, C, D) or (R, C, D, D), or a
                                    // chunk's partial sums (split mode)
    int k, d, c;
    int split;                      // samples a chunk (blockIdx.y), or 0
};

// A tile's shape for a bound DB of D: SPT samples a thread (2 up to D =
// 16, 1 above, where two would not fit in shared memory), TS samples a
// tile, ROW floats a staged operand column (TS + 4: 16-byte reads, rows
// 4 banks apart).
template <int DB>
struct Tile {
    static constexpr int SPT = DB <= 16 ? 2 : 1;
    static constexpr int TS = SPT * GC_T;
    static constexpr int ROW = TS + 4;
};

// A thread's raw operands of its samples of a tile in registers: their x
// rows and weights (mode 0: every component's, mode 1: cc's).
template <int DB>
struct Prefetch {
    float x[Tile<DB>::SPT][DB];
    float w[Tile<DB>::SPT][GC_MAXC];
};

template <int MODE, int DB>
__device__ __forceinline__ void fetch(const ChainArgs& a, int r, int cc,
                                      long long k0, long long kend,
                                      Prefetch<DB>& p) {
#pragma unroll
    for (int q = 0; q < Tile<DB>::SPT; ++q) {
        const long long k = k0 + threadIdx.x + q * GC_T;
        if (k >= kend) continue;
        const float* xr = a.x + k * a.d;
        const float* wr = a.w + ((size_t)r * a.k + k) * a.c;
#pragma unroll
        for (int i = 0; i < DB; ++i)
            if (i < a.d) p.x[q][i] = __ldg(xr + i);
        if (MODE == 0) {
#pragma unroll
            for (int j = 0; j < GC_MAXC; ++j)
                if (j < a.c) p.w[q][j] = __ldg(wr + j);
        } else {
            p.w[q][0] = __ldg(wr + cc);
        }
    }
}

// The fetched samples into their columns of buf: the ra rows of the left
// operand, then the d rows of the right one.
template <int MODE, int DB>
__device__ __forceinline__ void stage(const ChainArgs& a, const float* mu,
                                      int ra, int len, const Prefetch<DB>& p,
                                      float* buf) {
    constexpr int ROW = Tile<DB>::ROW;
#pragma unroll
    for (int q = 0; q < Tile<DB>::SPT; ++q) {
        const int col = threadIdx.x + q * GC_T;
        if (col >= len) continue;
        float* sb = buf + ra * ROW + col;
#pragma unroll
        for (int i = 0; i < DB; ++i) {
            if (i < a.d) {
                if (MODE == 0) {
                    sb[i * ROW] = p.x[q][i];
                } else {
                    const float df = __fsub_rn(p.x[q][i], mu[i]);
                    buf[i * ROW + col] = __fmul_rn(df, p.w[q][0]);
                    sb[i * ROW] = df;
                }
            }
        }
        if (MODE == 0) {
#pragma unroll
            for (int j = 0; j < GC_MAXC; ++j)
                if (j < a.c) buf[j * ROW + col] = p.w[q][j];
        }
    }
}

// One output's chain over a staged tile: acc = fma(pa[s], pb[s], acc) for s
// in order.  The operands of the next 16 samples are read from shared
// memory (into the other of two register sets) while the 16 fused
// multiply-adds of the current ones run, so a step costs about one FFMA
// latency.
__device__ __forceinline__ void chain_load(const float4* a4, const float4* b4,
                                           int g, float4 (&u)[4],
                                           float4 (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        u[q] = a4[4 * g + q];
        v[q] = b4[4 * g + q];
    }
}

__device__ __forceinline__ float chain_run(const float4 (&u)[4],
                                           const float4 (&v)[4], float acc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        acc = __fmaf_rn(u[q].x, v[q].x, acc);
        acc = __fmaf_rn(u[q].y, v[q].y, acc);
        acc = __fmaf_rn(u[q].z, v[q].z, acc);
        acc = __fmaf_rn(u[q].w, v[q].w, acc);
    }
    return acc;
}

__device__ __forceinline__ float chain_tile(const float* pa, const float* pb,
                                           int len, float acc) {
    const float4* a4 = (const float4*)pa;
    const float4* b4 = (const float4*)pb;
    const int n16 = len >> 4;
    float4 u0[4], v0[4], u1[4], v1[4];
    if (n16 > 0) chain_load(a4, b4, 0, u0, v0);
    int g = 0;
    for (; g + 2 <= n16; g += 2) {
        chain_load(a4, b4, g + 1, u1, v1);
        acc = chain_run(u0, v0, acc);
        if (g + 2 < n16) chain_load(a4, b4, g + 2, u0, v0);
        acc = chain_run(u1, v1, acc);
    }
    if (g < n16) acc = chain_run(u0, v0, acc);
    for (int s = n16 << 4; s < len; ++s) acc = __fmaf_rn(pa[s], pb[s], acc);
    return acc;
}

// Mode 0: out[r][c][j] = sum_k w[r][k][c] x[k][j] (a block a restart).
// Mode 1: out[r][c][i][j] = sum_k ((x[k][i] - mu_i) w[r][k][c])
//         (x[k][j] - mu_j), mu = mu[r][c] (a block a (restart, component)).
// Each sum: acc = 0, then acc = fma(left_k, right_k, acc) for k = 0..K-1,
// or, in the split mode, for k over chunk blockIdx.y's samples, written to
// that chunk's slice of a.out.
// CH: outputs a thread (1 where a batch has at most GC_T, else GC_CH); DB:
// a bound of D (4, 8, 16 or 32), the size of a sample's registers.
template <int MODE, int CH, int DB>
__global__ void __launch_bounds__(GC_T) chain_kernel(ChainArgs a) {
    extern __shared__ float4 dyn[];
    __shared__ float mu[GC_MAXD];
    const int t = threadIdx.x, d = a.d, bt = blockIdx.x;
    const int r = MODE == 0 ? bt : bt / a.c, cc = MODE == 0 ? 0 : bt % a.c;
    const int ra = MODE == 0 ? a.c : d, nch = ra * d;
    const long long kbeg = (long long)blockIdx.y * a.split;
    const long long kend = a.split > 0 ? min((long long)a.k, kbeg + a.split)
                                       : (long long)a.k;
    float* out = a.out + ((size_t)blockIdx.y * gridDim.x + bt) * nch;
    if (a.active != nullptr && a.active[r] == 0) {
        for (int e = t; e < nch; e += GC_T) out[e] = 0.0f;
        return;
    }
    constexpr int TS = Tile<DB>::TS, ROW = Tile<DB>::ROW;
    float* buf0 = (float*)dyn;
    float* buf1 = buf0 + (ra + d) * ROW;
    if (MODE == 1 && t < d) mu[t] = a.mu[(size_t)bt * d + t];
    int ia[CH], ib[CH];
    float acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
        const int ch = t + j * GC_T;
        ia[j] = (ch / d) * ROW;
        ib[j] = (ra + ch % d) * ROW;
        acc[j] = 0.0f;
    }
    const int ntiles = (int)((kend - kbeg + TS - 1) / TS);
    Prefetch<DB> p;
    fetch<MODE, DB>(a, r, cc, kbeg, kend, p);
    __syncthreads();
    for (int tile = 0; tile < ntiles; ++tile) {
        const long long k0 = kbeg + (long long)tile * TS;
        const int len = (int)min((long long)TS, kend - k0);
        float* buf = (tile & 1) ? buf1 : buf0;
        stage<MODE, DB>(a, mu, ra, len, p, buf);
        __syncthreads();
        if (tile + 1 < ntiles)
            fetch<MODE, DB>(a, r, cc, k0 + TS, kend, p);
#pragma unroll
        for (int j = 0; j < CH; ++j)
            if (t + j * GC_T < nch)
                acc[j] = chain_tile(buf + ia[j], buf + ib[j], len, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
        if (t + j * GC_T < nch) out[t + j * GC_T] = acc[j];
}

// out[e] = sum over the s chunks of part[j][e], added in chunk order in
// float64.
__global__ void split_reduce(const float* part, float* out, int s, int n) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    double acc = 0.0;
    for (int j = 0; j < s; ++j) acc += (double)part[(size_t)j * n + e];
    out[e] = (float)acc;
}

static size_t chain_smem(int mode, int d, int c) {
    const int row = d <= 16 ? Tile<16>::ROW : Tile<32>::ROW;
    return sizeof(float) * 2 * (size_t)((mode == 0 ? c : d) + d) * row;
}

// split > 0: chunks of split samples into work (ceil(k / split) x the
// outputs floats), then split_reduce into out.
static int chain_launch(int mode, const void* x, const void* w,
                        const void* mu, const void* active, void* out, int k,
                        int d, int c, int r, int split, void* work,
                        void* stream) {
    if (k < 1 || d < 1 || d > GC_MAXD || c < 1 || c > GC_MAXC || r < 1
        || split < 0 || (split > 0 && work == nullptr))
        return (int)cudaErrorInvalidValue;
    const int chunks = split > 0 ? (k + split - 1) / split : 1;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    static size_t set[64][8];       // dynamic shared memory allowed
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    // the instance: mode, outputs a thread, the bound of D (mode 1 with
    // D > 16 has more than GC_T outputs a batch)
    const int db = d <= 4 ? 0 : d <= 8 ? 1 : d <= 16 ? 2 : 3;
    static const void* const kernels[2][4] = {
        {(const void*)chain_kernel<0, 1, 4>, (const void*)chain_kernel<0, 1, 8>,
         (const void*)chain_kernel<0, 1, 16>,
         (const void*)chain_kernel<0, 1, 32>},
        {(const void*)chain_kernel<1, 1, 4>, (const void*)chain_kernel<1, 1, 8>,
         (const void*)chain_kernel<1, 1, 16>,
         (const void*)chain_kernel<1, GC_CH, 32>}};
    const void* kernel = kernels[mode][db];
    const size_t smem = chain_smem(mode, d, c);
    if (set[dev][4 * mode + db] < smem) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        set[dev][4 * mode + db] = smem;
    }
    ChainArgs a;
    a.x = (const float*)x;
    a.w = (const float*)w;
    a.mu = (const float*)mu;
    a.active = (const unsigned char*)active;
    a.out = (float*)(split > 0 ? work : out);
    a.k = k; a.d = d; a.c = c; a.split = split;
    void* args[] = {&a};
    const cudaError_t e = cudaLaunchKernel(
        kernel, dim3(mode == 0 ? r : r * c, chunks), dim3(GC_T), args, smem,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    if (split > 0) {
        const int n = r * c * d * (mode == 0 ? 1 : d);
        split_reduce<<<(n + GC_T - 1) / GC_T, GC_T, 0,
                       (cudaStream_t)stream>>>((const float*)work,
                                               (float*)out, chunks, n);
    }
    return (int)cudaGetLastError();
}

// (R, C, D) sums of w (R, K, C) times x (K, D); active (R,) bytes or null;
// split > 0: the split mode, work of ceil(k / split) x R x C x D floats.
extern "C" int gmm_weighted_sums(const void* x, const void* w,
                                 const void* active, void* out, int k, int d,
                                 int c, int r, int split, void* work,
                                 void* stream) {
    return chain_launch(0, x, w, nullptr, active, out, k, d, c, r, split,
                        work, stream);
}

// (R, C, D, D) centred sums of x (K, D) about mu (R, C, D) weighted by w
// (R, K, C); active (R,) bytes or null.
extern "C" int gmm_centred_sums(const void* x, const void* w, const void* mu,
                                const void* active, void* out, int k, int d,
                                int c, int r, void* stream) {
    return chain_launch(1, x, w, mu, active, out, k, d, c, r, 0, nullptr,
                        stream);
}
