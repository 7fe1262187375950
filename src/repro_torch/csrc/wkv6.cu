// RWKV-6 WKV recurrence for Hopper.
//
// Replaces repro/kernels/wkv6.py::wkv6_pallas (pallas_call at :85, body
// `_wkv6_kernel` at :30).
//
// Input: r, k, v, w (B, T, H, N) with N = 64, each fp32 or bf16 as given
// (r, k and v share one type); u (H, N) fp32; s0 (B, H, N, N) fp32,
// S[i][j] indexed key x value.  Per step, for every (b, h):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Output: y (B, T, H, N) fp32 and the final state sT (B, H, N, N) fp32.
//
// The TPU kernel keeps S in VMEM scratch across a sequential grid over
// time chunks.  Blocks on the card run in no order, so the carry moves
// inside one block's loop: one block per (b, h), N threads, thread j
// holding column j of S (64 fp32) in registers for the whole sequence.
// Each pass stages WKV_CHUNK steps of r, k, w and v in shared memory
// (coalesced 64-wide rows, converted to fp32 once); every thread then
// reads r, k, w and u as broadcast float4 loads.  y_j sums over i in a
// fixed order (four interleaved partial sums, added pairwise), and no
// atomics are used, so the results repeat bit for bit.
//
// Bound on the H100: per (b, h, t) it moves 3 N input values, N decays
// and N outputs against ~6 N^2 fp32 operations, so the card's fp32 rate
// bounds it once T is long; at the serving prefill (B = 4, T = 64,
// H = 40) the bytes of the state (s0 and sT, 2.6 MB) and of the
// sequence bound it instead.  This design leaves the state in registers
// and never writes it back before the end, and is latency-bound on the
// sequential chain over t: 2 warps per block, B * H blocks.  wgmma, TMA
// and the chunked-matmul form are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define WKV_N 64
#define WKV_CHUNK 32

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// one (i, j) term of a step: S[i][j]'s contribution to y_j, then its
// update
__device__ __forceinline__ void wkv_term(float& s, float& acc, float ri,
                                         float ki, float wi, float ui,
                                         float vj) {
  const float kv = ki * vj;
  acc += ri * (s + ui * kv);
  s = wi * s + kv;
}

template <typename TR, typename TW>
__global__ void __launch_bounds__(WKV_N)
wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
            const TR* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            int T, int H, float* __restrict__ y, float* __restrict__ sT) {
  __shared__ __align__(16) float sr[WKV_CHUNK][WKV_N];
  __shared__ __align__(16) float sk[WKV_CHUNK][WKV_N];
  __shared__ __align__(16) float sw[WKV_CHUNK][WKV_N];
  __shared__ __align__(16) float sv[WKV_CHUNK][WKV_N];
  __shared__ __align__(16) float su[WKV_N];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;

  const size_t sbase = (size_t)bh * WKV_N * WKV_N + j;
  float s[WKV_N];
#pragma unroll
  for (int i = 0; i < WKV_N; ++i) s[i] = s0[sbase + (size_t)i * WKV_N];
  su[j] = u[(size_t)h * WKV_N + j];

  const size_t tstride = (size_t)H * WKV_N;
  const size_t base = ((size_t)b * T * H + h) * WKV_N + j;
  for (int t0 = 0; t0 < T; t0 += WKV_CHUNK) {
    const int len = min(WKV_CHUNK, T - t0);
    __syncthreads();  // the previous chunk is consumed (and su written)
#pragma unroll 4
    for (int c = 0; c < len; ++c) {
      const size_t off = base + (size_t)(t0 + c) * tstride;
      sr[c][j] = load_f32(r + off);
      sk[c][j] = load_f32(k + off);
      sv[c][j] = load_f32(v + off);
      sw[c][j] = load_f32(w + off);
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const float vj = sv[c][j];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < WKV_N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        wkv_term(s[i], a0, r4.x, k4.x, w4.x, u4.x, vj);
        wkv_term(s[i + 1], a1, r4.y, k4.y, w4.y, u4.y, vj);
        wkv_term(s[i + 2], a2, r4.z, k4.z, w4.z, u4.z, vj);
        wkv_term(s[i + 3], a3, r4.w, k4.w, w4.w, u4.w, vj);
      }
      y[base + (size_t)(t0 + c) * tstride] = (a0 + a1) + (a2 + a3);
    }
  }
#pragma unroll
  for (int i = 0; i < WKV_N; ++i) sT[sbase + (size_t)i * WKV_N] = s[i];
}

template <typename TR, typename TW>
static void launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, int B,
                   int T, int H, void* y, void* sT, cudaStream_t stream) {
  wkv6_kernel<TR, TW><<<B * H, WKV_N, 0, stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w,
      (const float*)u, (const float*)s0, T, H, (float*)y, (float*)sT);
}

// rkv_bf16 / w_bf16: 1 if r, k, v (resp. w) are bf16, 0 if fp32
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           int B, int T, int H, int rkv_bf16, int w_bf16,
                           void* y, void* sT, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || (long long)B * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rkv_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, B, T, H, y, sT,
                                         st);
  else if (rkv_bf16)
    launch<__nv_bfloat16, float>(r, k, v, w, u, s0, B, T, H, y, sT, st);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(r, k, v, w, u, s0, B, T, H, y, sT, st);
  else
    launch<float, float>(r, k, v, w, u, s0, B, T, H, y, sT, st);
  return (int)cudaGetLastError();
}
