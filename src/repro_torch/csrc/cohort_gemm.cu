// Batch-invariant strided batched GEMM for the cohort's local SGD.
//
//   c[z1, z2, m, n] = sum_{r < R} sum_{k < K}
//                       a[z1, z2, r, m, k] b[z1, z2, r, k, n]
//                     (+ bias[z1, z2, m, n])
//
// Every operand is a strided view (element strides, 0 for a broadcast
// axis), so the stacked convolution's weights broadcast over the batch,
// a transpose is a swap of strides, and a bias gradient is a product with
// a broadcast one.  The reference trains the cohort with XLA's dot
// products under vmap (src/repro/fl/client.py:283-300, no Pallas kernel);
// cuBLAS, which the port used before, picks its kernel (tiles, split-K,
// and so the order of the fp32 sums) by the batch count, so a client
// trained alone (the loop engine), in a cohort bucket (the batched
// engine) or in one rank's slice of the cohort (the client mesh) came out
// different in the last bits, and fp32 SGD carried that to 1e-2 in two
// rounds (ROADMAP C12).
//
// Design: the order of every output's sum is set by the product's own
// sizes (R, K, M, N, Z1), never by Z2, the cohort axis.  The (r, k) pairs
// are cut into 16-wide k steps, r outer, k inner, and those steps into
// `splits` contiguous runs (kernels/cohort_gemm.py::gemm_splits picks the
// count from those sizes, so that a client's own work fills the card).
// One thread owns 4 x 4 outputs of a 64 x 64 tile and accumulates each
// over its run in one register with a fused multiply-add, k ascending;
// the tile's operands are staged through shared memory 16 k at a time,
// loaded along whichever of their axes has stride 1.  Past the edges the
// staged values are 0, which add exactly.  With one run the sum goes
// straight to c; with several, each run's sum goes to its own slab of
// `work` and a second kernel adds the slabs in run order.  No atomics:
// a client's outputs are the same bits however many clients share the
// launch.  The batch sum of the weight gradients is the R axis, so it
// too has a fixed order.  The bias is added after the sum.
//
// fp64 operands (the port's fp64 checks of training on the card) run the
// same design in double.
//
// Bound: 2 M N K R Z fp32 operations over 67 TFLOP/s, or the operands'
// bytes over 3.35 TB/s; a simple CUDA-core tile design, not tuned.
#include <cuda_runtime.h>

#define CG_BM 64
#define CG_BN 64
#define CG_BK 16
#define CG_THREADS 256
#define CG_MAX_GRID_Z 65535

// The launch's operands, filled by kernels/cohort_gemm.py (ctypes).
struct CohortGemm {
  const void* a;
  const void* b;
  const void* bias;           // null: no bias
  void* c;
  void* work;                 // (splits, Z1 Z2, M, N) partial sums
  int m, n, k, z1, z2, r;
  int splits;                 // runs of k steps; 1: no work slab
  int f64;                    // 1: every operand is double, else float
  long long as[5];            // a's strides: z1, z2, r, m, k
  long long bs[5];            // b's strides: z1, z2, r, k, n
  long long cs[4];            // c's strides: z1, z2, m, n
  long long biass[4];         // bias's strides: z1, z2, m, n
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
cohort_gemm_kernel(const CohortGemm g) {
  __shared__ T as_t[CG_BK][CG_BM + 1];
  __shared__ T bs_t[CG_BK][CG_BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * CG_BM, n0 = blockIdx.x * CG_BN;
  const bool a_k_unit = g.as[4] == 1;
  const bool b_n_unit = g.bs[4] == 1;
  const int zs = g.z1 * g.z2;
  const int nkt = (g.k + CG_BK - 1) / CG_BK;
  const long long steps = (long long)g.r * nkt;
  for (long long zz = blockIdx.z; zz < (long long)zs * g.splits;
       zz += gridDim.z) {
    const int z = (int)(zz / g.splits), sp = (int)(zz % g.splits);
    const int i1 = z / g.z2, i2 = z % g.z2;
    const T* a = (const T*)g.a + i1 * g.as[0] + i2 * g.as[1];
    const T* b = (const T*)g.b + i1 * g.bs[0] + i2 * g.bs[1];
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    const long long t1 = steps * (sp + 1) / g.splits;
    for (long long t = steps * sp / g.splits; t < t1; ++t) {
      const int rr = (int)(t / nkt), k0 = (int)(t % nkt) * CG_BK;
      const T* ar = a + rr * g.as[2];
      const T* br = b + rr * g.bs[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * CG_THREADS;
        // a's tile, walked along its unit-stride axis
        const int am = a_k_unit ? idx / CG_BK : idx % CG_BM;
        const int ak = a_k_unit ? idx % CG_BK : idx / CG_BM;
        const int gm = m0 + am, gk = k0 + ak;
        as_t[ak][am] = (gm < g.m && gk < g.k)
                           ? ar[gm * g.as[3] + gk * g.as[4]] : T(0);
        const int bn = b_n_unit ? idx % CG_BN : idx / CG_BK;
        const int bk = b_n_unit ? idx / CG_BN : idx % CG_BK;
        const int gn = n0 + bn, gk2 = k0 + bk;
        bs_t[bk][bn] = (gn < g.n && gk2 < g.k)
                           ? br[gk2 * g.bs[3] + gn * g.bs[4]] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CG_BK; ++kk) {
        T av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as_t[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs_t[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fma_t(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (g.splits > 1) {               // this run's partial sums
      T* w = (T*)g.work + ((long long)sp * zs + z) * g.m * g.n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty + 16 * i;
        if (gm >= g.m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = n0 + tx + 16 * j;
          if (gn < g.n) w[(long long)gm * g.n + gn] = acc[i][j];
        }
      }
      continue;
    }
    T* c = (T*)g.c + i1 * g.cs[0] + i2 * g.cs[1];
    const T* bias = g.bias != nullptr
                        ? (const T*)g.bias + i1 * g.biass[0] + i2 * g.biass[1]
                        : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= g.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn >= g.n) continue;
        T v = acc[i][j];
        if (bias != nullptr) v += bias[gm * g.biass[2] + gn * g.biass[3]];
        c[gm * g.cs[2] + gn * g.cs[3]] = v;
      }
    }
  }
}

// The runs' partial sums added in run order, then the bias: one thread
// an output.
template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
cohort_gemm_reduce_kernel(const CohortGemm g) {
  const long long mn = (long long)g.m * g.n;
  const long long total = (long long)g.z1 * g.z2 * mn;
  for (long long e = blockIdx.x * (long long)CG_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * CG_THREADS) {
    const T* w = (const T*)g.work + e;
    T v = w[0];
    for (int sp = 1; sp < g.splits; ++sp) v += w[sp * total];
    const int z = (int)(e / mn);
    const int gm = (int)(e % mn / g.n), gn = (int)(e % g.n);
    const int i1 = z / g.z2, i2 = z % g.z2;
    if (g.bias != nullptr)
      v += ((const T*)g.bias)[i1 * g.biass[0] + i2 * g.biass[1] +
                              gm * g.biass[2] + gn * g.biass[3]];
    ((T*)g.c)[i1 * g.cs[0] + i2 * g.cs[1] + gm * g.cs[2] + gn * g.cs[3]] = v;
  }
}

extern "C" int cohort_gemm_launch(const CohortGemm* g, void* stream) {
  if (g->m <= 0 || g->n <= 0 || g->k <= 0 || g->r <= 0 || g->z1 <= 0 ||
      g->z2 <= 0 || g->splits <= 0 || (g->splits > 1 && g->work == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long zs = (long long)g->z1 * g->z2 * g->splits;
  if (zs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((g->n + CG_BN - 1) / CG_BN, (g->m + CG_BM - 1) / CG_BM,
            (unsigned)(zs < CG_MAX_GRID_Z ? zs : CG_MAX_GRID_Z));
  cudaStream_t st = (cudaStream_t)stream;
  if (g->f64)
    cohort_gemm_kernel<double><<<grid, CG_THREADS, 0, st>>>(*g);
  else
    cohort_gemm_kernel<float><<<grid, CG_THREADS, 0, st>>>(*g);
  if (g->splits > 1) {
    const long long total = zs / g->splits * g->m * g->n;
    const long long blocks = (total + CG_THREADS - 1) / CG_THREADS;
    const unsigned rgrid = (unsigned)(blocks < 65535 * 16 ? blocks
                                                          : 65535 * 16);
    if (g->f64)
      cohort_gemm_reduce_kernel<double><<<rgrid, CG_THREADS, 0, st>>>(*g);
    else
      cohort_gemm_reduce_kernel<float><<<rgrid, CG_THREADS, 0, st>>>(*g);
  }
  return (int)cudaGetLastError();
}
