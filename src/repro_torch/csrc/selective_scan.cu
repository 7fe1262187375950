// Mamba-1 selective scan for Hopper.
//
// Replaces repro/kernels/selective_scan.py::selective_scan_pallas
// (pallas_call at :89, body `_kernel` at :35).
//
// Input: x, dt (B, T, Di) and bmat, cmat (B, T, N), all fp32 or all bf16
// as given; a (Di, N) fp32; h0 (B, Di, N) fp32.  Per step, for every (b, d):
//   h[n] <- exp(dt_t * a[d][n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t   = sum_n h[n] * C_t[n]
// with dt and x converted to fp32 before their product, as the TPU
// kernel and the model's scan (repro/models/mamba.py:68-76) do.
// Output: y (B, T, Di) fp32 and the final state hT (B, Di, N) fp32.
//
// The TPU kernel keeps a (256, N) state in VMEM scratch across a
// sequential grid over time chunks.  Blocks on the card run in no order,
// so the carry moves inside one block's loop: one thread per (b, d)
// channel holds h[N] and a[d][:] in registers for the whole sequence; a
// block is SS_THREADS channels of one batch row (the last block of a row
// masks the channels past Di).  Each pass stages SS_CHUNK steps in shared
// memory, converted to fp32 once: x and dt as coalesced rows along d
// (each thread then reads its own column), B_t and C_t as rows of N
// (zero-padded to the template's N, read as broadcast float4).  y sums
// over n in a fixed order (four interleaved partial sums, added
// pairwise); exp is the accurate expf, not __expf; no atomics, so the
// results repeat bit for bit.
//
// Bound on the H100: per (b, t, d) it reads x and dt and writes y; per
// (b, t, d, n) it does one exp and ~6 fp32 operations.  The exp count
// over the SFU's 16 per SM per clock is the largest of the three bounds
// at jamba's shapes (N = 16), the bytes of x, dt and y close behind.
// This design is latency-bound on the chain over t: one warp per 32
// channels, Di / 128 * B blocks of 4 warps (256 at the serving prefill,
// 64 at B = 1).  Splitting n across threads to raise occupancy is work
// for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define SS_THREADS 128
#define SS_CHUNK 32

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename TI, int NS>
__global__ void __launch_bounds__(SS_THREADS)
selective_scan_kernel(const TI* __restrict__ x, const TI* __restrict__ dt,
                      const TI* __restrict__ bmat,
                      const TI* __restrict__ cmat,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, int T, int Di, int N,
                      int dblocks, float* __restrict__ y,
                      float* __restrict__ hT) {
  __shared__ __align__(16) float sx[SS_CHUNK][SS_THREADS];
  __shared__ __align__(16) float sdt[SS_CHUNK][SS_THREADS];
  __shared__ __align__(16) float sb[SS_CHUNK][NS];
  __shared__ __align__(16) float sc[SS_CHUNK][NS];
  const int b = blockIdx.x / dblocks;
  const int tid = threadIdx.x;
  const int d = (blockIdx.x - b * dblocks) * SS_THREADS + tid;
  const bool valid = d < Di;

  // the channel's decay rates and state: entries past N stay 0, so
  // they add nothing to y and stay 0
  float av[NS], h[NS];
  const size_t hbase = ((size_t)b * Di + d) * N;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool on = valid && n < N;
    av[n] = on ? a[(size_t)d * N + n] : 0.0f;
    h[n] = on ? h0[hbase + n] : 0.0f;
  }

  const size_t row = (size_t)b * T;        // (b, t) row index = row + t
  for (int t0 = 0; t0 < T; t0 += SS_CHUNK) {
    const int len = min(SS_CHUNK, T - t0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll 4
    for (int c = 0; c < len; ++c) {
      const size_t off = (row + t0 + c) * Di + d;
      sx[c][tid] = valid ? load_f32(x + off) : 0.0f;
      sdt[c][tid] = valid ? load_f32(dt + off) : 0.0f;
    }
    for (int i = tid; i < SS_CHUNK * NS; i += SS_THREADS) {
      const int c = i / NS, n = i - (i / NS) * NS;
      const bool on = c < len && n < N;
      const size_t off = (row + t0 + c) * N + n;
      sb[c][n] = on ? load_f32(bmat + off) : 0.0f;
      sc[c][n] = on ? load_f32(cmat + off) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const float dtv = sdt[c][tid];
      const float dtx = dtv * sx[c][tid];
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sb[c][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sc[c][n]);
        h[n] = expf(dtv * av[n]) * h[n] + dtx * b4.x;
        h[n + 1] = expf(dtv * av[n + 1]) * h[n + 1] + dtx * b4.y;
        h[n + 2] = expf(dtv * av[n + 2]) * h[n + 2] + dtx * b4.z;
        h[n + 3] = expf(dtv * av[n + 3]) * h[n + 3] + dtx * b4.w;
        y0 += h[n] * c4.x;
        y1 += h[n + 1] * c4.y;
        y2 += h[n + 2] * c4.z;
        y3 += h[n + 3] * c4.w;
      }
      if (valid) y[(row + t0 + c) * Di + d] = (y0 + y1) + (y2 + y3);
    }
  }
  if (valid) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
      if (n < N) hT[hbase + n] = h[n];
  }
}

template <typename TI, int NS>
static void launch(const void* x, const void* dt, const void* bmat,
                   const void* cmat, const void* a, const void* h0, int B,
                   int T, int Di, int N, void* y, void* hT,
                   cudaStream_t stream) {
  const int dblocks = (Di + SS_THREADS - 1) / SS_THREADS;
  selective_scan_kernel<TI, NS><<<B * dblocks, SS_THREADS, 0, stream>>>(
      (const TI*)x, (const TI*)dt, (const TI*)bmat, (const TI*)cmat,
      (const float*)a, (const float*)h0, T, Di, N, dblocks, (float*)y,
      (float*)hT);
}

template <int NS>
static void dispatch(const void* x, const void* dt, const void* bmat,
                     const void* cmat, const void* a, const void* h0, int B,
                     int T, int Di, int N, int bf16, void* y, void* hT,
                     cudaStream_t st) {
  if (bf16)
    launch<__nv_bfloat16, NS>(x, dt, bmat, cmat, a, h0, B, T, Di, N, y, hT,
                              st);
  else
    launch<float, NS>(x, dt, bmat, cmat, a, h0, B, T, Di, N, y, hT, st);
}

// bf16: 1 if x, dt, bmat and cmat are bf16, 0 if fp32.  N must be 1..32
// (the N <= 16 build takes N up to 16).
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* h0, int B,
                                     int T, int Di, int N, int bf16, void* y,
                                     void* hT, void* stream) {
  if (B <= 0 || Di <= 0 || T < 0 || N <= 0 || N > 32 ||
      (long long)B * ((Di + SS_THREADS - 1) / SS_THREADS) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 16)
    dispatch<16>(x, dt, bmat, cmat, a, h0, B, T, Di, N, bf16, y, hT, st);
  else
    dispatch<32>(x, dt, bmat, cmat, a, h0, B, T, Di, N, bf16, y, hT, st);
  return (int)cudaGetLastError();
}
