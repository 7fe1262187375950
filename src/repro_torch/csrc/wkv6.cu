// RWKV-6 WKV recurrence for Hopper: a segmented recurrence, parallel
// over (b, h, time chunk).
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
// Bound on the H100: per (b, h, t) the function reads 3 N inputs and N
// decays and writes N outputs against ~6 N^2 fp32 operations, so at a
// long prompt the fp32 rate bounds it (B = 1, T = 4096, H = 40: 0.060
// ms); at the serving prefill (B = 4, T = 64) the bytes do (0.004 ms).
//
// What held the first design back: one block per (b, h) of 64 threads,
// thread j holding column j of S for the whole sequence.  At B = 1, H =
// 40 that is 40 blocks of 2 warps on 132 SMs, and each of the 4096 steps
// waits on the one before: ~0.51 us (~900 clocks) a step, 2.10 ms in all,
// 35x the bound.  The chain was the limit, not the arithmetic.
//
// This design cuts the sequence into chunks of WKV_C steps and uses that
// the recurrence is linear in S.  Inside chunk k, started from a state
// S_in, with P_t = prod_{u < t} w_u (the decays since the chunk began):
//   S_t = diag(P_t) S_in + S_loc_t,   y_t = y_loc_t + (r_t * P_t) . S_in
// where S_loc and y_loc are the chunk's own recurrence started from 0.
//   A. one block per (b, h, chunk): the step recurrence over the chunk,
//      thread j holding column j of S in registers; chunk 0 starts from
//      s0, every other chunk from 0.  It writes y_loc into y, the
//      chunk's end state S_loc[k] and its decay product D[k] = P_C.
//   B. one block per (b, h, 128 state entries): the carry over chunks,
//      S_in[1] = S_loc[0] (s0 is in it already), S_in[k + 1] = diag(D[k])
//      S_in[k] + S_loc[k], written over S_loc[k]'s slot; the last is sT.
//      Each thread walks the chunks for one float4 of S, its loads of
//      S_loc and D issued WKV_PF chunks ahead from a ring of registers
//      (they do not depend on the carry), so the loop is not one memory
//      latency per chunk.
//   C. one block per (b, h, chunk >= 1): y_t += (r_t * P_t) . S_in[k], a
//      (C x 64) . (64 x 64) product on CUDA cores in fp32, each thread a
//      4 x 4 tile.  r_t and w_t are staged in shared memory, 64 threads
//      form the running products, and S_in[k], loaded into registers
//      meanwhile, then takes w's buffer.
// When T <= WKV_C there is one chunk, phase A starts from s0 and writes
// sT itself, and B and C do not run.  Products of decays are plain fp32
// products, not log/exp: every factor is at most 1, so nothing
// overflows, and a decay of exactly 0 stays exact.
//
// WKV_C = 64: the serving prefill (T = 64) stays one chunk and one
// launch, and at T = 4096, B = 1, H = 40 phase A has 2560 blocks, each a
// 64-step chain instead of a 4096-step one.  The cost is phase C's
// product, 2 N^2 operations a step (~7 N^2 in all with phase A's 5 N^2,
// against the function's 6 N^2), and ~42 MB of S_loc scratch, written
// by A, read and rewritten by B, read by C: ~0.46 GB moved in all, so
// the design's own bound at that shape is 0.138 ms (bytes).
//
// Phase A's step takes the bonus term out of the inner loop: y_t[j] =
// sum_i r_t[i] S[i][j] + v_t[j] * (sum_i r_t[i] u[i] k_t[i]), the scalar
// summed once a step by four lanes (a fixed shuffle order), so each
// (i, j) costs 3 instructions (FFMA, FMUL, FFMA) instead of 4.  Every sum
// runs in a fixed order and no atomics are used: the results repeat bit
// for bit.  On the card, two columns a thread (half the shared-memory
// loads per update, 12 warps an SM) made phase A slower, and 4 x 8 tiles
// left phase C as it was; wgmma on the chunked-matmul form is work for a
// later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define WKV_N 64
#define WKV_C 64          // steps per chunk (kernels/wkv6.py: CHUNK)
#define WKV_STAGE 16      // phase A: steps staged in shared memory at once
#define WKV_B_THREADS 128 // phase B: one float4 of S per thread
#define WKV_PF 8          // phase B: chunks loaded ahead
#define WKV_C_THREADS 256 // phase C: a 4 x 4 tile of the chunk's y each

// phase A: each staged step's bonus sum is split over WKV_N / WKV_STAGE
// lanes of one warp
static_assert(WKV_N % WKV_STAGE == 0 && WKV_N / WKV_STAGE <= 32,
              "phase A: bonus lanes");
static_assert(WKV_C_THREADS == (WKV_C / 4) * (WKV_N / 4), "phase C tiles");
static_assert(WKV_C == WKV_N, "phase C stages w_t in S_in's buffer");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// -- phase A: the step recurrence inside each chunk ------------------------
template <typename TR, typename TW>
__global__ void __launch_bounds__(WKV_N, 8)
wkv6_chunk_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                  const TR* __restrict__ v, const TW* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  int T, int H, int n_chunks, float* __restrict__ y,
                  float* __restrict__ sT, float* __restrict__ s_loc,
                  float* __restrict__ decay) {
  __shared__ __align__(16) float sr[WKV_STAGE][WKV_N];
  __shared__ __align__(16) float sk[WKV_STAGE][WKV_N];
  __shared__ __align__(16) float sw[WKV_STAGE][WKV_N];
  __shared__ __align__(16) float sv[WKV_STAGE][WKV_N];
  __shared__ float su[WKV_N];
  __shared__ float sbonus[WKV_STAGE];
  const int bh = blockIdx.x / n_chunks;
  const int ck = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const int t_begin = ck * WKV_C;
  const int len = min(WKV_C, T - t_begin);

  const size_t sbase = (size_t)bh * WKV_N * WKV_N + j;
  float s[WKV_N];
#pragma unroll
  for (int i = 0; i < WKV_N; ++i)
    s[i] = ck == 0 ? s0[sbase + (size_t)i * WKV_N] : 0.0f;
  su[j] = u[(size_t)h * WKV_N + j];
  float dprod = 1.0f;          // thread j as row j: prod of w_t[j]

  const size_t tstride = (size_t)H * WKV_N;
  const size_t base = ((size_t)b * T * H + h) * WKV_N + j;
  for (int c0 = 0; c0 < len; c0 += WKV_STAGE) {
    const int sl = min(WKV_STAGE, len - c0);
    __syncthreads();  // the previous stage is consumed (and su written)
#pragma unroll 4
    for (int c = 0; c < sl; ++c) {
      const size_t off = base + (size_t)(t_begin + c0 + c) * tstride;
      sr[c][j] = load_f32(r + off);
      sk[c][j] = load_f32(k + off);
      sv[c][j] = load_f32(v + off);
      sw[c][j] = load_f32(w + off);
    }
    __syncthreads();
    {
      // the bonus scalar of step c: each of kParts lanes sums a run of
      // the 64 terms, then shuffles add the parts in a fixed order
      constexpr int kParts = WKV_N / WKV_STAGE, kRun = WKV_N / kParts;
      const int c = j / kParts, part = j - c * kParts;
      float p = 0.0f;
      if (c < sl) {
#pragma unroll
        for (int i = part * kRun; i < part * kRun + kRun; ++i)
          p = fmaf(sr[c][i] * su[i], sk[c][i], p);
      }
#pragma unroll
      for (int off = 1; off < kParts; off *= 2)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (part == 0) sbonus[c] = p;
    }
    for (int c = 0; c < sl; ++c) dprod *= sw[c][j];
    __syncthreads();
    for (int c = 0; c < sl; ++c) {
      const float vj = sv[c][j];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < WKV_N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[c][i]);
        a0 = fmaf(r4.x, s[i], a0);
        a1 = fmaf(r4.y, s[i + 1], a1);
        a2 = fmaf(r4.z, s[i + 2], a2);
        a3 = fmaf(r4.w, s[i + 3], a3);
        s[i] = fmaf(w4.x, s[i], k4.x * vj);
        s[i + 1] = fmaf(w4.y, s[i + 1], k4.y * vj);
        s[i + 2] = fmaf(w4.z, s[i + 2], k4.z * vj);
        s[i + 3] = fmaf(w4.w, s[i + 3], k4.w * vj);
      }
      y[base + (size_t)(t_begin + c0 + c) * tstride] =
          fmaf(vj, sbonus[c], (a0 + a1) + (a2 + a3));
    }
  }
  if (n_chunks == 1) {
#pragma unroll
    for (int i = 0; i < WKV_N; ++i) sT[sbase + (size_t)i * WKV_N] = s[i];
  } else {
    const size_t slot = (size_t)blockIdx.x * WKV_N * WKV_N + j;
#pragma unroll
    for (int i = 0; i < WKV_N; ++i)
      s_loc[slot + (size_t)i * WKV_N] = s[i];
    decay[(size_t)blockIdx.x * WKV_N + j] = dprod;
  }
}

// -- phase B: the state carried across chunks, in order ---------------------
__global__ void __launch_bounds__(WKV_B_THREADS)
wkv6_carry_kernel(const float* __restrict__ decay, float* s_loc,
                  float* __restrict__ sT, int n_chunks) {
  constexpr int kQuads = WKV_N * WKV_N / 4;       // float4s in one state
  constexpr int kParts = kQuads / WKV_B_THREADS;  // blocks per (b, h)
  const int bh = blockIdx.x / kParts;
  const int e = (blockIdx.x - bh * kParts) * WKV_B_THREADS + threadIdx.x;
  const int i = e / (WKV_N / 4);                  // the row of this float4
  float4* slots = reinterpret_cast<float4*>(s_loc) +
                  (size_t)bh * n_chunks * kQuads + e;
  const float* d = decay + (size_t)bh * n_chunks * WKV_N + i;

  float4 carry = slots[0];                        // S_in[1] = S_loc[0]
  float4 next[WKV_PF];
  float dnext[WKV_PF];
#pragma unroll
  for (int q = 0; q < WKV_PF; ++q) {
    if (1 + q < n_chunks) {
      next[q] = slots[(size_t)(1 + q) * kQuads];
      dnext[q] = d[(size_t)(1 + q) * WKV_N];
    }
  }
  for (int k0 = 1; k0 < n_chunks; k0 += WKV_PF) {
#pragma unroll
    for (int q = 0; q < WKV_PF; ++q) {
      const int kk = k0 + q;
      if (kk < n_chunks) {
        const float4 loc = next[q];
        const float dk = dnext[q];
        if (kk + WKV_PF < n_chunks) {
          next[q] = slots[(size_t)(kk + WKV_PF) * kQuads];
          dnext[q] = d[(size_t)(kk + WKV_PF) * WKV_N];
        }
        carry.x = fmaf(dk, carry.x, loc.x);
        carry.y = fmaf(dk, carry.y, loc.y);
        carry.z = fmaf(dk, carry.z, loc.z);
        carry.w = fmaf(dk, carry.w, loc.w);
        if (kk < n_chunks - 1)
          slots[(size_t)kk * kQuads] = carry;     // S_in[kk + 1]
        else
          reinterpret_cast<float4*>(sT)[(size_t)bh * kQuads + e] = carry;
      }
    }
  }
}

// -- phase C: each chunk's y gains the state it started from ---------------
template <typename TR, typename TW>
__global__ void __launch_bounds__(WKV_C_THREADS)
wkv6_cross_kernel(const TR* __restrict__ r, const TW* __restrict__ w,
                  const float* __restrict__ s_loc, int T, int H,
                  int n_chunks, float* __restrict__ y) {
  // w_t while the decay products are formed, then S_in[k]
  __shared__ __align__(16) float ss[WKV_N][WKV_N];
  __shared__ float srp[WKV_C][WKV_N + 1];              // r_t * P_t
  const int per_bh = n_chunks - 1;
  const int bh = blockIdx.x / per_bh;
  const int ck = 1 + (blockIdx.x - bh * per_bh);
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int t_begin = ck * WKV_C;
  const int len = min(WKV_C, T - t_begin);
  const size_t tstride = (size_t)H * WKV_N;
  const size_t base = ((size_t)b * T * H + h) * WKV_N;

  // S_in[k] sits in S_loc[k - 1]'s slot after phase B: loaded into
  // registers now, stored to shared memory once the decays are used
  constexpr int kQuadsPerThread = WKV_N * WKV_N / 4 / WKV_C_THREADS;
  const float4* src = reinterpret_cast<const float4*>(
      s_loc + ((size_t)bh * n_chunks + ck - 1) * WKV_N * WKV_N);
  float4 s_in[kQuadsPerThread];
#pragma unroll
  for (int m = 0; m < kQuadsPerThread; ++m)
    s_in[m] = src[tid + m * WKV_C_THREADS];
  for (int e = tid; e < WKV_C * WKV_N; e += WKV_C_THREADS) {
    const int c = e / WKV_N, i = e - (e / WKV_N) * WKV_N;
    const size_t off = base + (size_t)(t_begin + c) * tstride + i;
    srp[c][i] = c < len ? load_f32(r + off) : 0.0f;
    ss[c][i] = c < len ? load_f32(w + off) : 0.0f;
  }
  __syncthreads();
  if (tid < WKV_N) {
    // row i's running decay product, in the order phase A took it
    float p = 1.0f;
#pragma unroll 8
    for (int c = 0; c < len; ++c) {
      srp[c][tid] *= p;
      p *= ss[c][tid];
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kQuadsPerThread; ++m)
    reinterpret_cast<float4*>(&ss[0][0])[tid + m * WKV_C_THREADS] = s_in[m];
  __syncthreads();

  const int ty = tid / 16, tx = tid - (tid / 16) * 16;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[q][m] = 0.0f;
#pragma unroll 8
  for (int i = 0; i < WKV_N; ++i) {
    const float4 sv = *reinterpret_cast<const float4*>(&ss[i][tx * 4]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a = srp[ty * 4 + q][i];
      acc[q][0] = fmaf(a, sv.x, acc[q][0]);
      acc[q][1] = fmaf(a, sv.y, acc[q][1]);
      acc[q][2] = fmaf(a, sv.z, acc[q][2]);
      acc[q][3] = fmaf(a, sv.w, acc[q][3]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = ty * 4 + q;
    if (c < len) {
      float4* dst = reinterpret_cast<float4*>(
          y + base + (size_t)(t_begin + c) * tstride + tx * 4);
      float4 o = *dst;
      o.x += acc[q][0];
      o.y += acc[q][1];
      o.z += acc[q][2];
      o.w += acc[q][3];
      *dst = o;
    }
  }
}

template <typename TR, typename TW>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, int B, int T, int H,
                  void* y, void* sT, void* scratch, cudaStream_t stream) {
  const int n_chunks = T <= WKV_C ? 1 : (T + WKV_C - 1) / WKV_C;
  const int bh = B * H;
  float* s_loc = (float*)scratch;
  float* decay = n_chunks > 1
                     ? s_loc + (size_t)bh * n_chunks * WKV_N * WKV_N
                     : nullptr;
  wkv6_chunk_kernel<TR, TW><<<bh * n_chunks, WKV_N, 0, stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w,
      (const float*)u, (const float*)s0, T, H, n_chunks, (float*)y,
      (float*)sT, s_loc, decay);
  if (n_chunks == 1) return (int)cudaGetLastError();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_carry_kernel<<<bh * (WKV_N * WKV_N / 4 / WKV_B_THREADS),
                      WKV_B_THREADS, 0, stream>>>(decay, s_loc, (float*)sT,
                                                  n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_cross_kernel<TR, TW><<<bh * (n_chunks - 1), WKV_C_THREADS, 0,
                              stream>>>((const TR*)r, (const TW*)w, s_loc, T,
                                        H, n_chunks, (float*)y);
  return (int)cudaGetLastError();
}

// rkv_bf16 / w_bf16: 1 if r, k, v (resp. w) are bf16, 0 if fp32.
// scratch: B * H * ceil(T / WKV_C) * (N * N + N) floats when T > WKV_C
// (S_loc, then D); unused, and may be null, when T <= WKV_C.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           int B, int T, int H, int rkv_bf16, int w_bf16,
                           void* y, void* sT, void* scratch, void* stream) {
  const long long n_chunks = T <= WKV_C ? 1 : (T + WKV_C - 1) / WKV_C;
  if (B <= 0 || H <= 0 || T < 0 || (long long)B * H * n_chunks > INT_MAX ||
      (n_chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rkv_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, B, T, H,
                                                y, sT, scratch, st);
  if (rkv_bf16)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, B, T, H, y, sT,
                                        scratch, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(r, k, v, w, u, s0, B, T, H, y, sT,
                                        scratch, st);
  return launch<float, float>(r, k, v, w, u, s0, B, T, H, y, sT, scratch,
                              st);
}
