// Dense DCS neighbour election (paper Alg. 1) for Hopper.
//
// Replaces repro/kernels/neighbor_elect.py::neighbor_elect_pallas
// (pallas_call at :79, body `_kernel` at :38).
//
// Bound on the H100: O(N^2) comparisons against O(N) bytes, so for any
// fleet past a few hundred vehicles the kernel is bound by integer/fp32
// compare throughput; at the paper's N = 30 it is launch latency.
// Design: one thread per vehicle i holds its position, evaluation and an
// int32 count in registers and sweeps candidate tiles j staged through
// shared memory (each tile is read once per block, not once per thread).
// Out-of-range slots of the last tile carry the TPU kernel's sentinels
// (position 1e18, evaluation -1e18).  Every comparison is fp32 with fp32
// thresholds, so the mask is bit-equal to the plain version, including
// at d == comm_range and on tied evaluations (lower index wins).  The
// predicate lives in elect_predicate.cuh, shared with the windowed counts.
#include <cuda_runtime.h>

#include "elect_predicate.cuh"

#define NE_TILE 256

__global__ void __launch_bounds__(NE_TILE)
neighbor_elect_kernel(const float* __restrict__ pos,
                      const float* __restrict__ ev, int n, float comm_range,
                      float e_tau, int top_m, int* __restrict__ out) {
  __shared__ float sp[NE_TILE];
  __shared__ float se[NE_TILE];
  const int i = blockIdx.x * NE_TILE + threadIdx.x;
  const float pi = i < n ? pos[i] : 1e18f;
  const float ei = i < n ? ev[i] : -1e18f;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += NE_TILE) {
    const int j = j0 + threadIdx.x;
    sp[threadIdx.x] = j < n ? pos[j] : 1e18f;
    se[threadIdx.x] = j < n ? ev[j] : -1e18f;
    __syncthreads();
    const int lim = n - j0 < NE_TILE ? n - j0 : NE_TILE;
    for (int t = 0; t < lim; ++t)
      count += elect_better(pi, ei, i, sp[t], se[t], j0 + t, comm_range,
                            e_tau, n);
    __syncthreads();
  }
  if (i < n) out[i] = (ei >= e_tau && count < top_m) ? 1 : 0;
}

extern "C" int neighbor_elect_launch(const void* pos, const void* ev, int n,
                                     float comm_range, float e_tau,
                                     int top_m, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + NE_TILE - 1) / NE_TILE;
  neighbor_elect_kernel<<<grid, NE_TILE, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)ev, n, comm_range, e_tau, top_m,
      (int*)out);
  return (int)cudaGetLastError();
}
