// Mamba-1 selective scan for Hopper: states spread over lanes, channels
// over every SM.
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
// Output: y (B, T, Di) fp32 and the final state hT (B, Di, N) fp32; with
// hs given, also the state at every SS_SAVE-step boundary inside the
// sequence, hs (B, ceil(T / SS_SAVE) - 1, Di, N) fp32 (entry m: after
// (m + 1) SS_SAVE steps), which the backward (csrc/selective_scan_bwd.cu)
// rebuilds each chunk's states from.  Writing them changes no result.
//
// Bound on the H100: one exp per (b, t, d, n), over the SFU's 16 per SM
// per clock, is the largest of three bounds at jamba's shapes (N = 16;
// B = 1, T = 4096, Di = 8192: 0.128 ms), the bytes of x, dt and y next
// (0.080 ms), ~6 fp32 operations per (b, t, d, n) last (0.049 ms).
//
// What held the first design back: one thread per channel holding all N
// states, 128-thread blocks.  At B = 1, Di = 8192 that is 64 blocks, so
// 68 of 132 SMs sat idle and each busy one had 4 warps; the 4096-step
// chain ran at ~660 clocks a step (1.54 ms, 12x the exp bound), and each
// state called the accurate expf (~10 FMA-pipe instructions beside the
// MUFU).
//
// This design keeps the chain over time (the exps are the bound, and a
// split over time would need exp(a * cumsum(dt)) for every (t, d, n)
// again, doubling them) and changes two things:
// - SS_LANES = 8 lanes share a channel, each holding NS / 8 of the
//   states (2 at N = 16; N pads to 8, 16 or 32) and their pre-scaled
//   rates in registers.  A block is SS_CHANNELS = 16 channels of one
//   batch row (128 threads; the last block of a row masks the channels
//   past Di), so B = 1, Di = 8192 runs 512 blocks, 2048 warps: ~16
//   resident on each of the 132 SMs.  L = 8 and not 4 (~8 warps an SM)
//   or 16 (one state a lane at N = 16): on the card both ran slower.
//   Steps go in groups of 8: each lane sums its states' terms of y in
//   order for each step, then one reduce-scatter over distances 4, 2, 1
//   (__shfl_xor_sync, a fixed tree) leaves lane q with step q's whole
//   sum, which it stores: 7 shuffles a group instead of 3 a step.
// - exp(dt a) is exp2(dt a') with a' = a log2(e) set once per (d, n), as
//   the mamba authors' CUDA scan does: one MUFU.EX2 (ex2.approx.ftz;
//   outputs below 2^-126 flush to 0) instead of the accurate expf.  The
//   cost against the 1e-5 tolerance: a' rounds once, which alone moves
//   the states ~1e-7 of scale (tests/test_torch_scan_forms.py); the
//   MUFU's own errors lean one way rather than averaging out, so they
//   add up over a state's memory: the card reads up to a few 1e-6 of
//   scale at T = 4096 where expf read ~1e-7 (PERF.md).
// Each pass stages SS_CHUNK steps in shared memory, converted to fp32
// once: x and dt transposed (a channel's steps in a row, read as float4
// per 4 steps), B_t and C_t as rows of N (zero-padded to NS).  The next
// chunk's operands are loaded into registers, in their input type,
// while the current one is scanned, and two staging buffers alternate,
// so one barrier a chunk suffices.  No atomics: the results repeat bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define SS_LANES 8
#define SS_CHANNELS 16
#define SS_THREADS (SS_LANES * SS_CHANNELS)
#define SS_CHUNK 32
#define SS_GROUP SS_LANES // steps whose y sums are reduced together
#define SS_PITCH (SS_CHUNK + 4)
#define SS_SAVE 64          // steps between saved states (kernels/selective_scan.py)

static_assert(SS_GROUP == SS_LANES, "one step of a group per lane");
static_assert(SS_CHUNK % SS_GROUP == 0, "whole groups in a chunk");
static_assert(SS_SAVE % SS_CHUNK == 0, "saves fall on chunk starts");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 2^x, one MUFU.EX2
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One lane's part of SS_GROUP steps from step c0 of the staged chunk:
// its S states advance, and p[u] gets its share of y at step c0 + u.
// kTail: steps at or past len leave h as it is and add 0.
template <int S, int NS, bool kTail>
__device__ __forceinline__ void scan_group(
    float (&h)[S], const float (&a2)[S], float (&p)[SS_GROUP],
    const float* dtrow, const float* xrow, const float (*sb)[NS],
    const float (*sc)[NS], int c0, int n0, int len) {
  float dts[SS_GROUP], xs[SS_GROUP];
#pragma unroll
  for (int g = 0; g < SS_GROUP; g += 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(dtrow + c0 + g);
    const float4 x4 = *reinterpret_cast<const float4*>(xrow + c0 + g);
    dts[g] = d4.x; dts[g + 1] = d4.y; dts[g + 2] = d4.z; dts[g + 3] = d4.w;
    xs[g] = x4.x; xs[g + 1] = x4.y; xs[g + 2] = x4.z; xs[g + 3] = x4.w;
  }
#pragma unroll
  for (int u = 0; u < SS_GROUP; ++u) {
    const int c = c0 + u;
    float bv[S], cv[S];
    if constexpr (S == 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[c][n0]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sc[c][n0]);
      bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
      cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
    } else if constexpr (S == 2) {
      const float2 b2 = *reinterpret_cast<const float2*>(&sb[c][n0]);
      const float2 c2 = *reinterpret_cast<const float2*>(&sc[c][n0]);
      bv[0] = b2.x; bv[1] = b2.y;
      cv[0] = c2.x; cv[1] = c2.y;
    } else {
      bv[0] = sb[c][n0];
      cv[0] = sc[c][n0];
    }
    const float dtx = dts[u] * xs[u];
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float hn = fmaf(ex2(dts[u] * a2[s]), h[s], dtx * bv[s]);
      if (!kTail || c < len) h[s] = hn;
      acc = fmaf(h[s], cv[s], acc);
    }
    p[u] = (!kTail || c < len) ? acc : 0.0f;
  }
}

// p[u] holds one lane's share of y at step u of a group; afterwards lane
// q of the channel's 8 holds the whole sum for step q in p[0].  Three
// rounds (distances 4, 2, 1) each halve the steps a lane keeps: a fixed
// tree, so the sums repeat bit for bit.
__device__ __forceinline__ void reduce_scatter(float (&p)[SS_GROUP], int q) {
#pragma unroll
  for (int half = SS_GROUP / 2; half >= 1; half /= 2) {
    const bool upper = (q & half) != 0;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const float send = upper ? p[m] : p[m + half];
      const float keep = upper ? p[m + half] : p[m];
      p[m] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
}

template <typename TI, int NS>
__global__ void __launch_bounds__(SS_THREADS)
selective_scan_kernel(const TI* __restrict__ x, const TI* __restrict__ dt,
                      const TI* __restrict__ bmat,
                      const TI* __restrict__ cmat,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, int T, int Di, int N,
                      int dblocks, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ hs) {
  constexpr int S = NS / SS_LANES;               // states a lane holds
  static_assert(S * SS_LANES == NS, "NS must be a multiple of SS_LANES");
  // two chunks' operands (one scanned while the next is stored): x and
  // dt transposed (a channel's steps in a row), B_t and C_t as rows
  __shared__ __align__(16) float sx[2][SS_CHANNELS][SS_PITCH];
  __shared__ __align__(16) float sdt[2][SS_CHANNELS][SS_PITCH];
  __shared__ __align__(16) float sb[2][SS_CHUNK][NS];
  __shared__ __align__(16) float sc[2][SS_CHUNK][NS];
  const int b = blockIdx.x / dblocks;
  const int d0 = (blockIdx.x - b * dblocks) * SS_CHANNELS;
  const int tid = threadIdx.x;
  const int ch = tid / SS_LANES;                 // channel in the block
  const int q = tid - ch * SS_LANES;             // lane in the channel
  const int n0 = q * S;                          // the lane's first state
  const int d = d0 + ch;
  const bool valid = d < Di;

  // the lane's rates (a' = a log2 e) and states: entries past N stay 0,
  // so they add nothing to y and stay 0
  float a2[S], h[S];
  const size_t hbase = ((size_t)b * Di + d) * N;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool on = valid && n0 + s < N;
    a2[s] = on ? a[(size_t)d * N + n0 + s] * 1.4426950408889634f : 0.0f;
    h[s] = on ? h0[hbase + n0 + s] : 0.0f;
  }

  // the next chunk's operands, loaded into registers while the current
  // one is scanned: element m of each is e = tid + m * SS_THREADS.  They
  // stay in their input type until they are stored to shared memory, so
  // no instruction waits on the loads before then.
  constexpr int kXD = SS_CHUNK * SS_CHANNELS / SS_THREADS;
  constexpr int kBC = SS_CHUNK * NS / SS_THREADS;
  static_assert(kXD * SS_THREADS == SS_CHUNK * SS_CHANNELS, "x/dt split");
  static_assert(kBC * SS_THREADS == SS_CHUNK * NS, "B/C split");
  static_assert(kXD <= 32 && kBC <= 32, "one bit of a mask per element");
  TI rx[kXD], rdt[kXD], rb[kBC], rc[kBC];
  unsigned on_xd = 0, on_bc = 0;       // bit m: element m is in range
  const size_t row = (size_t)b * T;    // (b, t) row index = row + t
  auto fetch = [&](int t0) {
    const int len = min(SS_CHUNK, T - t0);
    on_xd = on_bc = 0;
#pragma unroll
    for (int m = 0; m < kXD; ++m) {
      const int e = tid + m * SS_THREADS;
      const int c = e / SS_CHANNELS, k = e - c * SS_CHANNELS;
      const bool on = c < len && d0 + k < Di;
      const size_t off = on ? (row + t0 + c) * Di + d0 + k : 0;
      rx[m] = x[off];
      rdt[m] = dt[off];
      on_xd |= (unsigned)on << m;
    }
#pragma unroll
    for (int m = 0; m < kBC; ++m) {
      const int e = tid + m * SS_THREADS;
      const int c = e / NS, n = e - c * NS;
      const bool on = c < len && n < N;
      const size_t off = on ? (row + t0 + c) * N + n : 0;
      rb[m] = bmat[off];
      rc[m] = cmat[off];
      on_bc |= (unsigned)on << m;
    }
  };
  if (T > 0) fetch(0);
  for (int t0 = 0, buf = 0; t0 < T; t0 += SS_CHUNK, buf ^= 1) {
    const int len = min(SS_CHUNK, T - t0);
    if (hs != nullptr && t0 > 0 && t0 % SS_SAVE == 0 && valid) {
      const int saves = (T + SS_SAVE - 1) / SS_SAVE - 1;
      float* dst =
          hs + (((size_t)b * saves + t0 / SS_SAVE - 1) * Di + d) * N;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (n0 + s < N) dst[n0 + s] = h[s];
    }
    // every warp passed the last barrier after scanning the chunk before
    // the previous one, so buffer buf is free
#pragma unroll
    for (int m = 0; m < kXD; ++m) {
      const int e = tid + m * SS_THREADS;
      const int c = e / SS_CHANNELS, k = e - c * SS_CHANNELS;
      const bool on = (on_xd >> m) & 1u;
      sx[buf][k][c] = on ? to_f32(rx[m]) : 0.0f;
      sdt[buf][k][c] = on ? to_f32(rdt[m]) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kBC; ++m) {
      const int e = tid + m * SS_THREADS;
      const bool on = (on_bc >> m) & 1u;
      sb[buf][e / NS][e % NS] = on ? to_f32(rb[m]) : 0.0f;
      sc[buf][e / NS][e % NS] = on ? to_f32(rc[m]) : 0.0f;
    }
    __syncthreads();
    if (t0 + SS_CHUNK < T) fetch(t0 + SS_CHUNK);
    for (int c0 = 0; c0 < len; c0 += SS_GROUP) {
      float p[SS_GROUP];
      if (c0 + SS_GROUP <= len)
        scan_group<S, NS, false>(h, a2, p, sdt[buf][ch], sx[buf][ch],
                                 sb[buf], sc[buf], c0, n0, len);
      else
        scan_group<S, NS, true>(h, a2, p, sdt[buf][ch], sx[buf][ch],
                                sb[buf], sc[buf], c0, n0, len);
      reduce_scatter(p, q);
      if (valid && c0 + q < len) y[(row + t0 + c0 + q) * Di + d] = p[0];
    }
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (n0 + s < N) hT[hbase + n0 + s] = h[s];
  }
}

template <typename TI, int NS>
static void launch(const void* x, const void* dt, const void* bmat,
                   const void* cmat, const void* a, const void* h0, int B,
                   int T, int Di, int N, void* y, void* hT, void* hs,
                   cudaStream_t stream) {
  const int dblocks = (Di + SS_CHANNELS - 1) / SS_CHANNELS;
  selective_scan_kernel<TI, NS><<<B * dblocks, SS_THREADS, 0, stream>>>(
      (const TI*)x, (const TI*)dt, (const TI*)bmat, (const TI*)cmat,
      (const float*)a, (const float*)h0, T, Di, N, dblocks, (float*)y,
      (float*)hT, (float*)hs);
}

template <int NS>
static void dispatch(const void* x, const void* dt, const void* bmat,
                     const void* cmat, const void* a, const void* h0, int B,
                     int T, int Di, int N, int bf16, void* y, void* hT,
                     void* hs, cudaStream_t st) {
  if (bf16)
    launch<__nv_bfloat16, NS>(x, dt, bmat, cmat, a, h0, B, T, Di, N, y, hT,
                              hs, st);
  else
    launch<float, NS>(x, dt, bmat, cmat, a, h0, B, T, Di, N, y, hT, hs, st);
}

// bf16: 1 if x, dt, bmat and cmat are bf16, 0 if fp32.  N must be 1..32
// (padded to 8, 16 or 32 states: 1, 2 or 4 a lane).  hs: null, or the
// saved states (B, ceil(T / 64) - 1, Di, N) fp32.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* h0, int B,
                                     int T, int Di, int N, int bf16, void* y,
                                     void* hT, void* hs, void* stream) {
  if (B <= 0 || Di <= 0 || T < 0 || N <= 0 || N > 32 ||
      (long long)B * ((Di + SS_CHANNELS - 1) / SS_CHANNELS) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8)
    dispatch<8>(x, dt, bmat, cmat, a, h0, B, T, Di, N, bf16, y, hT, hs, st);
  else if (N <= 16)
    dispatch<16>(x, dt, bmat, cmat, a, h0, B, T, Di, N, bf16, y, hT, hs, st);
  else
    dispatch<32>(x, dt, bmat, cmat, a, h0, B, T, Di, N, bf16, y, hT, hs, st);
  return (int)cudaGetLastError();
}
