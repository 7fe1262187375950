// Windowed DCS better-neighbour counts over position-sorted arrays, for
// Hopper.
//
// Replaces repro/kernels/neighbor_elect.py::windowed_counts_pallas
// (pallas_call at :156, body `_win_kernel` at :104).
//
// Input: (M,) position-sorted positions sp, evaluations se and global
// ids sg, M a multiple of `block`, sentinel-padded (pos 1e18, ev -1e18,
// id >= n_valid).  Output: counts[r] = the number of candidates c that
// elect_better(r, c) in the candidate blocks of r's row block.
//
// The candidate set is block-granular, as the TPU kernel's: row block ib
// visits the candidate blocks [ib - hops, ib + hops] clipped to
// [0, nb), hops = ceil(window / block), each block once (the Pallas grid
// clamps its index map at the edges and skips the duplicates).
//
// Bound on the H100: M * (2 hops + 1) * block fp32/int compares against
// 12 bytes per row, so it is bound by compare throughput; at the
// 4096-vehicle path (M = 4096, 11 candidate blocks of 128) the work is
// ~6M compares and the time is launch latency.
// Design: one CTA per row block, one thread per row holding (p, e, g)
// and an int32 count in registers; each visited candidate block is
// staged once through shared memory and swept by every row.  `block` is
// a runtime argument (the election picks min(128, max(32, M)), so it is
// not always a multiple of 32): the CTA has `block` rounded up to whole
// warps and the idle threads only help stage.  No atomics and no
// order-dependent reduction: the counts are integers, bit-equal to the
// plain version from run to run.
#include <cuda_runtime.h>

#include "elect_predicate.cuh"

#define WC_MAX_BLOCK 1024

__global__ void __launch_bounds__(WC_MAX_BLOCK)
windowed_counts_kernel(const float* __restrict__ sp,
                       const float* __restrict__ se,
                       const int* __restrict__ sg, int block, int nb,
                       int hops, float comm_range, float e_tau, int n_valid,
                       int* __restrict__ out) {
  extern __shared__ float smem[];
  float* cp = smem;
  float* ce = smem + block;
  int* cg = reinterpret_cast<int*>(smem + 2 * block);
  const int ib = blockIdx.x;
  const int t = threadIdx.x;
  const bool active = t < block;
  const int row = ib * block + t;
  const float pi = active ? sp[row] : 0.0f;
  const float ei = active ? se[row] : 0.0f;
  const int gi = active ? sg[row] : 0;
  const int lo = ib - hops > 0 ? ib - hops : 0;
  const int hi = ib + hops < nb - 1 ? ib + hops : nb - 1;
  int count = 0;
  for (int tgt = lo; tgt <= hi; ++tgt) {
    if (active) {
      const int c = tgt * block + t;
      cp[t] = sp[c];
      ce[t] = se[c];
      cg[t] = sg[c];
    }
    __syncthreads();
    if (active)
      for (int c = 0; c < block; ++c)
        count += elect_better(pi, ei, gi, cp[c], ce[c], cg[c], comm_range,
                              e_tau, n_valid);
    __syncthreads();
  }
  if (active) out[row] = count;
}

extern "C" int windowed_counts_launch(const void* sp, const void* se,
                                      const void* sg, int m, int block,
                                      int window, float comm_range,
                                      float e_tau, int n_valid, void* out,
                                      void* stream) {
  if (m <= 0 || block <= 0 || block > WC_MAX_BLOCK || m % block != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const int nb = m / block;
  // hops beyond nb - 1 add no candidate block; the clip keeps the sum
  // (window + block - 1) well inside int for any window
  const int hops_full = window / block + (window % block != 0 ? 1 : 0);
  const int hops = hops_full < nb ? hops_full : nb;
  const int threads = (block + 31) / 32 * 32;
  const size_t smem = 3 * (size_t)block * sizeof(float);
  windowed_counts_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const float*)sp, (const float*)se, (const int*)sg, block, nb, hops,
      comm_range, e_tau, n_valid, (int*)out);
  return (int)cudaGetLastError();
}
