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
// The candidate set is block-granular, as the TPU kernel's: row block
// ib visits the candidate blocks [ib - hops, ib + hops] clipped to
// [0, nb), hops = ceil(window / block), each block once (the Pallas grid
// clamps its index map at the edges and skips the duplicates).  Those
// blocks are one contiguous run of candidates, [lo * block, (hi + 1) *
// block).
//
// Bound on the H100: M * (2 hops + 1) * block pair tests against 12
// bytes per row, so compare throughput bounds it, and only the pairs in
// DSRC range can count: at 1 vehicle per metre a row block's window of
// 11 blocks of 128 holds ~3.5 blocks in range.
// Design (the TPU kernel walked the candidate blocks in turn; here they
// are spread over warps and the card's 132 SMs):
// - a CTA takes 32 R rows of one row block, R a lane (the same rows in
//   each of its 8 warps): R = 1 while that leaves fewer than 2 CTAs an
//   SM (M = 4096 at block 128: 128 CTAs), else 4, so that a staged
//   candidate feeds 4 pair tests from one shared-memory load and the
//   row block's run is staged once, not 4 times (M = 65,536: 512 CTAs);
// - the CTA stages the row block's candidate run once, in tiles of
//   1536 (the 1408 of M = 4096's window fit one), with 16-byte loads (4
//   candidates a thread) into shared memory;
// - staging folds the candidate-only half of elect_better (ev >= E_tau,
//   id < n_valid) into the position: a candidate that fails it is
//   staged at NaN, so its distance test fails as elect_better's `ok`
//   would.  `better` (a higher ev, or an equal one and a lower id) is
//   one unsigned 64-bit compare of order keys (ev's bits mapped to an
//   order-preserving uint32, -0 taken as +0, then the id's signed order
//   reversed),
//   exact for every ev but NaN: a NaN candidate is never `ok`, and a NaN
//   row gets the greatest key, which no candidate passes, as `ej > ei`
//   and `ej == ei` are both false against NaN.  A pair is then a
//   subtraction and three compares;
// - each sub-chunk of 32 staged candidates gets its least and greatest
//   position, and the warps take the sub-chunks round robin, so the few
//   in range spread over all 8 warps;
// - the prune: a sub-chunk is skipped when its least position minus the
//   rows' greatest (or the rows' least minus its greatest), in fp32,
//   exceeds comm_range.  Rounding to nearest is monotone and fabsf(pi -
//   pj) is that same rounded difference, so every pair skipped that way
//   would fail elect_better's `d <= comm_range`; NaN positions drop out
//   of fminf/fmaxf and never count.  The bounds are minima and maxima,
//   not end points, so the prune is exact on any input, sorted or not;
// - a sweep keeps 4 counts, each warp's partial counts go through shared
//   memory, and all are summed by integer adds: no atomics, no order
//   dependence, the counts bit-equal to the plain version from run to
//   run.
// `block` is a runtime argument (the election picks min(128, max(32, M)),
// so it is not always a multiple of 32): a row block of 40 rows is a
// CTA of 32 rows and one of 8, and a run that does not start 16-byte
// aligned, or the ragged end of one, stages with 4-byte loads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WC_MAX_BLOCK 1024
#define WC_WARPS 8                  // warps of a CTA, splitting candidates
#define WC_THREADS (WC_WARPS * 32)
#define WC_VEC 4                    // candidates a thread stages a load
#define WC_TILE 1536                // candidates staged at once
#define WC_SUB 32                   // candidates under one prune test

// ev's order key: unsigned order = float order for every ev but NaN,
// with -0 and +0 one key
__device__ __forceinline__ unsigned wc_ev_key(float e) {
  unsigned b = __float_as_uint(e);
  if (b == 0x80000000u) b = 0u;                    // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (ev key, id in reverse signed order): j beats i iff key_j > key_i
__device__ __forceinline__ unsigned long long wc_key(float e, int g) {
  return ((unsigned long long)wc_ev_key(e) << 32) |
         (unsigned long long)~((unsigned)g ^ 0x80000000u);
}

// A staged candidate: (position, or NaN if it cannot count, key high,
// key low)
__device__ __forceinline__ float4 wc_stage(float p, float e, int g,
                                           float e_tau, int n_valid) {
  const bool ok = (e >= e_tau) && (g < n_valid);
  const unsigned long long k = wc_key(e, g);
  return make_float4(ok ? p : __int_as_float(0x7fc00000),
                     __uint_as_float((unsigned)(k >> 32)),
                     __uint_as_float((unsigned)k), 0.0f);
}

// a row's key: NaN ev takes the greatest, which nothing exceeds
__device__ __forceinline__ unsigned long long wc_row_key(float e, int g) {
  return isnan(e) ? ~0ull : wc_key(e, g);
}

// elect_better (elect_predicate.cuh) against a staged candidate: the
// candidate-only test sits in its position, `better` in the keys
__device__ __forceinline__ int wc_hit(float pi, unsigned long long ki,
                                      float4 c, float comm_range) {
  const unsigned long long kj =
      ((unsigned long long)__float_as_uint(c.y) << 32) | __float_as_uint(c.z);
  return (fabsf(pi - c.x) <= comm_range && kj > ki) ? 1 : 0;
}

// registers: 6 CTAs an SM at R = 1 (the sweep is latency-bound), 4 at
// R = 4 (the grid has ~4 an SM, and 4 rows need the registers)
template <int R>
__global__ void __launch_bounds__(WC_THREADS, R == 1 ? 6 : 4)
windowed_counts_kernel(const float* __restrict__ sp,
                       const float* __restrict__ se,
                       const int* __restrict__ sg, int block, int nb,
                       int hops, int subs, float comm_range, float e_tau,
                       int n_valid, int vec_ptrs, int* __restrict__ out) {
  __shared__ float4 stage[WC_TILE];
  __shared__ float sub_lo[WC_TILE / WC_SUB], sub_hi[WC_TILE / WC_SUB];
  __shared__ int part[WC_WARPS][32 * R];
  const float nan = __int_as_float(0x7fc00000);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ib = blockIdx.x / subs;
  const int r0 = ib * block + (blockIdx.x - ib * subs) * 32 * R;
  const int r_end = min(r0 + 32 * R, (ib + 1) * block);
  float pi[R];
  unsigned long long ki[R];
  int n[R];
  // the rows' span; NaN (idle lanes) drops out of fminf / fmaxf
  float pmin = nan, pmax = nan;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + 32 * r + lane;
    const bool active = row < r_end;
    pi[r] = active ? sp[row] : nan;
    ki[r] = active ? wc_row_key(se[row], sg[row]) : ~0ull;
    n[r] = 0;
    pmin = fminf(pmin, pi[r]);
    pmax = fmaxf(pmax, pi[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    pmin = fminf(pmin, __shfl_xor_sync(0xffffffffu, pmin, o));
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
  }
  const int c_begin = max(ib - hops, 0) * block;
  const int c_end = (min(ib + hops, nb - 1) + 1) * block;
  const bool vec = vec_ptrs && (c_begin % WC_VEC) == 0;
  for (int t0 = c_begin; t0 < c_end; t0 += WC_TILE) {
    const int n_tile = min(WC_TILE, c_end - t0);
    // whole warps go round (the shuffles below take every lane); a lane
    // past the tile stages candidates that never count
    for (int k0 = WC_VEC * 32 * warp; k0 < n_tile;
         k0 += WC_VEC * WC_THREADS) {
      const int k = k0 + WC_VEC * lane;
      const int c = t0 + k;
      float4 pv, ev;
      int4 gv;
      if (vec && k + WC_VEC <= n_tile) {
        pv = *reinterpret_cast<const float4*>(sp + c);
        ev = *reinterpret_cast<const float4*>(se + c);
        gv = *reinterpret_cast<const int4*>(sg + c);
      } else {
        const bool in0 = k < n_tile, in1 = k + 1 < n_tile,
                   in2 = k + 2 < n_tile, in3 = k + 3 < n_tile;
        pv = make_float4(in0 ? sp[c] : nan, in1 ? sp[c + 1] : nan,
                         in2 ? sp[c + 2] : nan, in3 ? sp[c + 3] : nan);
        ev = make_float4(in0 ? se[c] : 0.0f, in1 ? se[c + 1] : 0.0f,
                         in2 ? se[c + 2] : 0.0f, in3 ? se[c + 3] : 0.0f);
        gv = make_int4(in0 ? sg[c] : n_valid, in1 ? sg[c + 1] : n_valid,
                       in2 ? sg[c + 2] : n_valid, in3 ? sg[c + 3] : n_valid);
      }
      const float4 s0 = wc_stage(pv.x, ev.x, gv.x, e_tau, n_valid);
      const float4 s1 = wc_stage(pv.y, ev.y, gv.y, e_tau, n_valid);
      const float4 s2 = wc_stage(pv.z, ev.z, gv.z, e_tau, n_valid);
      const float4 s3 = wc_stage(pv.w, ev.w, gv.w, e_tau, n_valid);
      stage[k] = s0; stage[k + 1] = s1; stage[k + 2] = s2; stage[k + 3] = s3;
      float qmin = fminf(fminf(s0.x, s1.x), fminf(s2.x, s3.x));
      float qmax = fmaxf(fmaxf(s0.x, s1.x), fmaxf(s2.x, s3.x));
      // a sub-chunk is 8 neighbouring threads' candidates
#pragma unroll
      for (int o = 1; o < WC_SUB / WC_VEC; o <<= 1) {
        qmin = fminf(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
        qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      }
      if (lane % (WC_SUB / WC_VEC) == 0) {
        sub_lo[k / WC_SUB] = qmin;
        sub_hi[k / WC_SUB] = qmax;
      }
    }
    __syncthreads();
    const int n_sub = (n_tile + WC_SUB - 1) / WC_SUB;
    for (int s = warp; s < n_sub; s += WC_WARPS) {
      const float lo = sub_lo[s], hi = sub_hi[s];
      // no candidate that can count, or every pair out of range
      if (isnan(lo) || lo - pmax > comm_range || pmin - hi > comm_range)
        continue;
      // a ragged last sub-chunk was staged whole, its tail at NaN
      const float4* cs = stage + s * WC_SUB;
#pragma unroll 4
      for (int j = 0; j < WC_SUB; ++j) {
        const float4 cj = cs[j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          n[r] += wc_hit(pi[r], ki[r], cj, comm_range);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) part[warp][32 * r + lane] = n[r];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + 32 * r + lane;
      if (row < r_end) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < WC_WARPS; ++w) total += part[w][32 * r + lane];
        out[row] = total;
      }
    }
  }
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
  const int vec_ptrs = ((uintptr_t)sp % 16 == 0) &&
                       ((uintptr_t)se % 16 == 0) && ((uintptr_t)sg % 16 == 0);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  // 4 rows a lane once that still leaves 2 CTAs an SM
  const int subs4 = (block + 127) / 128;
  if (nb * subs4 >= 2 * sms) {
    windowed_counts_kernel<4><<<nb * subs4, WC_THREADS, 0, st>>>(
        (const float*)sp, (const float*)se, (const int*)sg, block, nb, hops,
        subs4, comm_range, e_tau, n_valid, vec_ptrs, (int*)out);
  } else {
    const int subs1 = (block + 31) / 32;
    windowed_counts_kernel<1><<<nb * subs1, WC_THREADS, 0, st>>>(
        (const float*)sp, (const float*)se, (const int*)sg, block, nb, hops,
        subs1, comm_range, e_tau, n_valid, vec_ptrs, (int*)out);
  }
  return (int)cudaGetLastError();
}
