// Batched Mamdani fuzzy evaluation (paper §5.3) for Hopper.
//
// Replaces repro/kernels/fuzzy_eval.py::fuzzy_eval_pallas (pallas_call at
// :125, inference core `mamdani_lanes` at :48).
//
// Bound on the H100: per participant 16 bytes in and 4 bytes out against
// ~400 scalar operations (12 exp, 324 min/max, the COG), so the kernel
// sits near the ridge of the fp32 non-tensor-core roofline: bytes and
// operations give about the same least time.  Design: one thread per
// participant, a 16-byte vector load of its row, the rule table in
// shared memory and every intermediate in registers.  With normalize=1
// a first pass writes per-block column maxima, a one-block pass folds
// them (max is exact in any order, so the result does not depend on the
// grid), and the main pass scales by the reciprocal of the maximum, as
// the TPU kernel does (fuzzy_eval.py:87).
#include <cuda_runtime.h>
#include <math.h>

#include "mamdani.cuh"

#define FE_THREADS 256
#define FE_MAX_PARTIALS 1024

__global__ void __launch_bounds__(FE_THREADS)
colmax_partial_kernel(const float4* __restrict__ x, int p,
                      float* __restrict__ partial) {
  __shared__ float red[4][FE_THREADS];
  float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += gridDim.x * blockDim.x) {
    const float4 r = x[i];
    m0 = fmaxf(m0, r.x); m1 = fmaxf(m1, r.y);
    m2 = fmaxf(m2, r.z); m3 = fmaxf(m3, r.w);
  }
  red[0][threadIdx.x] = m0; red[1][threadIdx.x] = m1;
  red[2][threadIdx.x] = m2; red[3][threadIdx.x] = m3;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[v][threadIdx.x] = fmaxf(red[v][threadIdx.x],
                                    red[v][threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) partial[blockIdx.x * 4 + threadIdx.x] =
      red[threadIdx.x][0];
}

// folds the per-block maxima into the reciprocals the main pass scales by
__global__ void __launch_bounds__(FE_THREADS)
colmax_fold_kernel(const float* __restrict__ partial, int n_partial,
                   float* __restrict__ inv_max) {
  __shared__ float red[4][FE_THREADS];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float m = -INFINITY;
    for (int b = threadIdx.x; b < n_partial; b += blockDim.x)
      m = fmaxf(m, partial[b * 4 + v]);
    red[v][threadIdx.x] = m;
  }
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[v][threadIdx.x] = fmaxf(red[v][threadIdx.x],
                                    red[v][threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 4)
    inv_max[threadIdx.x] = 1.0f / fmaxf(red[threadIdx.x][0], 1e-9f);
}

__global__ void __launch_bounds__(FE_THREADS)
fuzzy_eval_kernel(const float4* __restrict__ x, int p,
                  const float* __restrict__ inv_max_g,
                  const float* __restrict__ means,
                  const float* __restrict__ sigmas,
                  const float* __restrict__ centers,
                  const int* __restrict__ rules, int n_rules,
                  float* __restrict__ out) {
  __shared__ MamdaniTables tab;
  __shared__ float inv_max[4];
  mamdani_load(tab, means, sigmas, centers, rules, n_rules);
  if (threadIdx.x < 4 && inv_max_g != nullptr)
    inv_max[threadIdx.x] = inv_max_g[threadIdx.x];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += gridDim.x * blockDim.x) {
    const float4 r = x[i];
    float v[4] = {r.x, r.y, r.z, r.w};
    if (inv_max_g != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = fminf(fmaxf(v[k] * inv_max[k], 0.0f), 1.0f);
    }
    out[i] = mamdani_eval(v, tab);
  }
}

extern "C" int fuzzy_eval_launch(const void* x, int p, int normalize,
                                 void* partial, const void* means,
                                 const void* sigmas, const void* centers,
                                 const void* rules, int n_rules, void* out,
                                 void* stream) {
  if (p <= 0 || n_rules <= 0 || n_rules > MAMDANI_MAX_RULES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks_needed = (p + FE_THREADS - 1) / FE_THREADS;
  const int grid = blocks_needed < 4096 ? blocks_needed : 4096;
  int n_partial = 0;
  if (normalize) {
    n_partial = blocks_needed < FE_MAX_PARTIALS ? blocks_needed
                                                : FE_MAX_PARTIALS;
    colmax_partial_kernel<<<n_partial, FE_THREADS, 0, st>>>(
        (const float4*)x, p, (float*)partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    colmax_fold_kernel<<<1, FE_THREADS, 0, st>>>(
        (const float*)partial, n_partial, (float*)partial + 4 * n_partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* inv_max =
      normalize ? (const float*)partial + 4 * n_partial : nullptr;
  fuzzy_eval_kernel<<<grid, FE_THREADS, 0, st>>>(
      (const float4*)x, p, inv_max,
      (const float*)means, (const float*)sigmas, (const float*)centers,
      (const int*)rules, n_rules, (float*)out);
  return (int)cudaGetLastError();
}

// floats of scratch the caller allocates for normalize=1: 4 per partial
// block plus the 4 reciprocals of the column maxima
extern "C" int fuzzy_eval_scratch_floats(int p) {
  const int b = (p + FE_THREADS - 1) / FE_THREADS;
  return 4 * (b < FE_MAX_PARTIALS ? b : FE_MAX_PARTIALS) + 4;
}
