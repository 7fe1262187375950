// The Mamba-1 selective scan's backward for Hopper: a reverse sweep over
// 64-step chunks, channels over every SM, as the forward spreads them.
//
// Replaces no Pallas kernel: the reference trains through the autodiff of
// its jnp scan (repro/models/mamba.py:143 calls _ssm_scan, checkpointed
// per chunk at :54-90); this is the VJP of the forward that
// csrc/selective_scan.cu computes (kernels/ref.py::selective_scan_ref).
//
// Input: x, dt (B, T, Di) and bmat, cmat (B, T, N), all fp32 or all bf16
// as the forward took them; a (Di, N) fp32; h0 (B, Di, N) fp32; the
// forward's saved states hs (B, ceil(T / 64) - 1, Di, N) fp32 (entry m:
// the state after (m + 1) 64 steps); dy (B, T, Di) fp32; dhT (B, Di, N)
// fp32 or null (zeros).  With dt and x converted to fp32 before their
// product, alpha = exp(dt_t a), and g the gradient of h_t, per step from
// the last:
//   g += dy_t C_t;  dC_t = sum_d dy_t h_t;  dB_t = sum_d g (dt_t x_t)
//   dx_t = dt_t sum_n g B_t;  ddt_t = x_t sum_n g B_t + sum_n q a
//   da += q dt_t with q = g h_{t-1} alpha;  g <- alpha g
// Output: dx, ddt, dB, dC in the inputs' type; da (Di, N) and dh0 (B, Di,
// N) fp32.
//
// Bound on the H100: ~18 fp32 operations per (b, t, d, n) (the states
// rebuilt, then the sweep) and one exp, so the fp32 rate bounds it at
// jamba's training microbatch (B = 1, T = 1024, Di = 8192, N = 16: 0.036
// ms; the exps over the SFU 0.032 ms, the bytes 0.031 ms).
//
// h_{t-1} is needed (for ddt and da) and is never rebuilt backward by
// dividing by exp(dt a), which underflows.  Each chunk, from the last, is
// walked forward from the forward's saved state at its start (h0 for the
// first), its 65 states staged in shared memory (64 x 16 x NS floats a
// block of 16 channels: 64 KB at N = 16), then walked backward against
// them.  The layout is the forward's: SB_LANES = 8 lanes share a channel,
// each holding NS / 8 of the states, a block 16 channels of one batch row
// (512 blocks at B = 1, Di = 8192).  The exps are the accurate expf (not
// the forward's MUFU.EX2): the backward reads the states from it.  Sums
// over a channel's states go through a fixed shuffle tree.  dC and dB sum
// over Di: each block sums its 16 channels in order from the staged
// states (dC) and from the staged dB terms (g (dt x), written over the
// states the sweep has used), writes a partial per (b, block, t, n), and a
// second kernel (selective_scan_bwd_sum_kernel) adds the blocks' partials
// in order, and da's B partials.  No atomics: the results repeat bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define SB_LANES 8
#define SB_CHANNELS 16
#define SB_THREADS (SB_LANES * SB_CHANNELS)
#define SB_C 64               // steps per chunk: the forward's SS_SAVE
#define SB_PITCH (SB_C + 1)
#define SB_SUM_THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the sum over a channel's 8 lanes, a fixed butterfly: each lane ends
// with the same bits
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = SB_LANES / 2; off >= 1; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int NS>
struct SbSmem {
  static constexpr size_t slab = (size_t)(SB_C + 1) * SB_CHANNELS * NS;
  static constexpr size_t rows = (size_t)SB_CHANNELS * SB_PITCH;  // one
  static constexpr size_t bc = (size_t)SB_C * NS;
  // slab; x, dt, dy, dx, ddt ([channel][step]); B, C ([step][state])
  static constexpr size_t bytes = (slab + 5 * rows + 2 * bc) * 4;
};

template <typename TI, int NS>
__global__ void __launch_bounds__(SB_THREADS)
selective_scan_bwd_kernel(const TI* __restrict__ x, const TI* __restrict__ dt,
                          const TI* __restrict__ bmat,
                          const TI* __restrict__ cmat,
                          const float* __restrict__ a,
                          const float* __restrict__ h0,
                          const float* __restrict__ hs,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT, int T, int Di,
                          int N, int dblocks, TI* __restrict__ dx,
                          TI* __restrict__ ddt, float* __restrict__ db_part,
                          float* __restrict__ dc_part,
                          float* __restrict__ da_part,
                          float* __restrict__ dh0) {
  constexpr int S = NS / SB_LANES;               // states a lane holds
  static_assert(S * SB_LANES == NS, "NS must be a multiple of SB_LANES");
  using L = SbSmem<NS>;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;                            // [c][channel][state]
  float(*sx)[SB_PITCH] = reinterpret_cast<float(*)[SB_PITCH]>(smem + L::slab);
  float(*sdt)[SB_PITCH] = sx + SB_CHANNELS;
  float(*sdy)[SB_PITCH] = sdt + SB_CHANNELS;
  float(*sdx)[SB_PITCH] = sdy + SB_CHANNELS;
  float(*sddt)[SB_PITCH] = sdx + SB_CHANNELS;
  float(*sb)[NS] = reinterpret_cast<float(*)[NS]>(smem + L::slab +
                                                  5 * L::rows);
  float(*sc)[NS] = sb + SB_C;

  const int b = blockIdx.x / dblocks;
  const int db = blockIdx.x - b * dblocks;
  const int d0 = db * SB_CHANNELS;
  const int tid = threadIdx.x;
  const int ch = tid / SB_LANES;
  const int q = tid - ch * SB_LANES;
  const int n0 = q * S;
  const int d = d0 + ch;
  const bool valid = d < Di;
  const int nvalid = min(SB_CHANNELS, Di - d0);
  const int n_chunks = (T + SB_C - 1) / SB_C;
  const size_t hbase = ((size_t)b * Di + d) * N;
  const size_t row = (size_t)b * T;              // (b, t) row = row + t

  float av[S], g[S], da_acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool on = valid && n0 + s < N;
    av[s] = on ? a[(size_t)d * N + n0 + s] : 0.0f;
    g[s] = on && dhT ? dhT[hbase + n0 + s] : 0.0f;
    da_acc[s] = 0.0f;
  }

  for (int ck = n_chunks - 1; ck >= 0; --ck) {
    const int t0 = ck * SB_C;
    const int len = min(SB_C, T - t0);
    __syncthreads();   // the previous chunk's stage and slab are consumed
    for (int e = tid; e < SB_C * SB_CHANNELS; e += SB_THREADS) {
      const int c = e / SB_CHANNELS, k = e - c * SB_CHANNELS;
      const bool on = c < len && k < nvalid;
      const size_t off = (row + t0 + c) * Di + d0 + k;
      sx[k][c] = on ? to_f32(x[off]) : 0.0f;
      sdt[k][c] = on ? to_f32(dt[off]) : 0.0f;
      sdy[k][c] = on ? dy[off] : 0.0f;
    }
    for (int e = tid; e < SB_C * NS; e += SB_THREADS) {
      const int c = e / NS, n = e - c * NS;
      const bool on = c < len && n < N;
      const size_t off = (row + t0 + c) * N + n;
      sb[c][n] = on ? to_f32(bmat[off]) : 0.0f;
      sc[c][n] = on ? to_f32(cmat[off]) : 0.0f;
    }
    // the state at the chunk's start: h0, or the forward's saved state
    float h[S];
    const float* src =
        ck == 0 ? h0 + hbase
                : hs + (((size_t)b * (n_chunks - 1) + ck - 1) * Di + d) * N;
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = valid && n0 + s < N ? src[n0 + s] : 0.0f;
    __syncthreads();

    // forward over the chunk: slab[c] = the state after c of its steps
    float* mine = slab + (size_t)ch * NS + n0;
#pragma unroll
    for (int s = 0; s < S; ++s) mine[s] = h[s];
    for (int c = 0; c < len; ++c) {
      const float dtc = sdt[ch][c];
      const float dtx = dtc * sx[ch][c];
      float* out = mine + (size_t)(c + 1) * SB_CHANNELS * NS;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = fmaf(expf(dtc * av[s]), h[s], dtx * sb[c][n0 + s]);
        out[s] = h[s];
      }
    }
    __syncthreads();

    // dC_t[n] = sum_d dy_t[d] h_t[d][n], the block's channels in order
    const size_t pbase = ((size_t)b * dblocks + db) * T;
    for (int e = tid; e < len * NS; e += SB_THREADS) {
      const int c = e / NS, n = e - c * NS;
      if (n >= N) continue;
      const float* col = slab + (size_t)(c + 1) * SB_CHANNELS * NS + n;
      float acc = 0.0f;
      for (int k = 0; k < nvalid; ++k) acc = fmaf(sdy[k][c], col[k * NS], acc);
      dc_part[(pbase + t0 + c) * N + n] = acc;
    }
    __syncthreads();   // the states h_t are read

    // backward over the chunk
    for (int c = len - 1; c >= 0; --c) {
      const float dyc = sdy[ch][c], dtc = sdt[ch][c], xc = sx[ch][c];
      const float dtx = dtc * xc;
      const float* prev = mine + (size_t)c * SB_CHANNELS * NS;
      float* term = mine + (size_t)(c + 1) * SB_CHANNELS * NS;
      float pd = 0.0f, px = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        g[s] = fmaf(dyc, sc[c][n0 + s], g[s]);
        const float al = expf(dtc * av[s]);
        const float qv = g[s] * prev[s] * al;
        pd = fmaf(qv, av[s], pd);
        da_acc[s] = fmaf(qv, dtc, da_acc[s]);
        px = fmaf(g[s], sb[c][n0 + s], px);
        term[s] = g[s] * dtx;                 // dB's term, over h_t
        g[s] *= al;
      }
      pd = lanes_sum(pd);
      px = lanes_sum(px);
      if (q == 0) {
        sdx[ch][c] = px * dtc;
        sddt[ch][c] = fmaf(px, xc, pd);
      }
    }
    __syncthreads();

    // dB_t[n] = sum_d g (dt_t x_t), the block's channels in order; dx and
    // ddt of the chunk
    for (int e = tid; e < len * NS; e += SB_THREADS) {
      const int c = e / NS, n = e - c * NS;
      if (n >= N) continue;
      const float* col = slab + (size_t)(c + 1) * SB_CHANNELS * NS + n;
      float acc = col[0];
      for (int k = 1; k < nvalid; ++k) acc += col[k * NS];
      db_part[(pbase + t0 + c) * N + n] = acc;
    }
    for (int e = tid; e < len * SB_CHANNELS; e += SB_THREADS) {
      const int c = e / SB_CHANNELS, k = e - c * SB_CHANNELS;
      if (k >= nvalid) continue;
      const size_t off = (row + t0 + c) * Di + d0 + k;
      store_as(dx + off, sdx[k][c]);
      store_as(ddt + off, sddt[k][c]);
    }
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (n0 + s < N) {
        dh0[hbase + n0 + s] = g[s];
        da_part[hbase + n0 + s] = da_acc[s];
      }
    }
  }
}

// dB and dC: the channel blocks' partials in order, one thread per (b, t,
// n); past those, da: the B partials in order, one thread per (d, n)
template <typename TI>
__global__ void __launch_bounds__(SB_SUM_THREADS)
selective_scan_bwd_sum_kernel(const float* __restrict__ db_part,
                              const float* __restrict__ dc_part,
                              const float* __restrict__ da_part, int B,
                              int T, int Di, int N, int dblocks,
                              TI* __restrict__ dbm, TI* __restrict__ dcm,
                              float* __restrict__ da) {
  const long long idx = (long long)blockIdx.x * SB_SUM_THREADS + threadIdx.x;
  const long long tn = (long long)T * N;
  const long long bc = (long long)B * tn;
  if (idx < bc) {
    const long long b = idx / tn, e = idx - b * tn;
    const float* pb = db_part + (size_t)b * dblocks * tn + e;
    const float* pc = dc_part + (size_t)b * dblocks * tn + e;
    float sb = pb[0], sc = pc[0];
    for (int k = 1; k < dblocks; ++k) {
      sb += pb[(size_t)k * tn];
      sc += pc[(size_t)k * tn];
    }
    store_as(dbm + idx, sb);
    store_as(dcm + idx, sc);
  } else if (idx < bc + (long long)Di * N) {
    const long long e = idx - bc;
    float acc = da_part[e];
    for (int bb = 1; bb < B; ++bb) acc += da_part[(size_t)bb * Di * N + e];
    da[e] = acc;
  }
}

template <typename TI, int NS>
static int launch(const void* x, const void* dt, const void* bmat,
                  const void* cmat, const void* a, const void* h0,
                  const void* hs, const void* dy, const void* dhT, int B,
                  int T, int Di, int N, void* dx, void* ddt, void* dbm,
                  void* dcm, void* da, void* dh0, void* scratch,
                  cudaStream_t stream) {
  const int dblocks = (Di + SB_CHANNELS - 1) / SB_CHANNELS;
  float* db_part = (float*)scratch;
  float* dc_part = db_part + (size_t)B * dblocks * T * N;
  float* da_part = dc_part + (size_t)B * dblocks * T * N;
  const size_t smem = SbSmem<NS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<TI, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  selective_scan_bwd_kernel<TI, NS><<<B * dblocks, SB_THREADS, smem,
                                      stream>>>(
      (const TI*)x, (const TI*)dt, (const TI*)bmat, (const TI*)cmat,
      (const float*)a, (const float*)h0, (const float*)hs, (const float*)dy,
      (const float*)dhT, T, Di, N, dblocks, (TI*)dx, (TI*)ddt, db_part,
      dc_part, da_part, (float*)dh0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * T * N + (long long)Di * N;
  selective_scan_bwd_sum_kernel<TI>
      <<<(unsigned)((n + SB_SUM_THREADS - 1) / SB_SUM_THREADS),
         SB_SUM_THREADS, 0, stream>>>(db_part, dc_part, da_part, B, T, Di, N,
                                      dblocks, (TI*)dbm, (TI*)dcm,
                                      (float*)da);
  return (int)cudaGetLastError();
}

template <int NS>
static int dispatch(const void* x, const void* dt, const void* bmat,
                    const void* cmat, const void* a, const void* h0,
                    const void* hs, const void* dy, const void* dhT, int B,
                    int T, int Di, int N, int bf16, void* dx, void* ddt,
                    void* dbm, void* dcm, void* da, void* dh0, void* scratch,
                    cudaStream_t st) {
  if (bf16)
    return launch<__nv_bfloat16, NS>(x, dt, bmat, cmat, a, h0, hs, dy, dhT,
                                     B, T, Di, N, dx, ddt, dbm, dcm, da, dh0,
                                     scratch, st);
  return launch<float, NS>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di,
                           N, dx, ddt, dbm, dcm, da, dh0, scratch, st);
}

// bf16: 1 if x, dt, bmat and cmat are bf16 (and so dx, ddt, dB, dC), 0 if
// fp32.  N must be 1..32.  hs: the forward's saved states when T > 64 (may
// be null when T <= 64); dhT may be null.  scratch: 2 * B * ceil(Di / 16)
// * T * N + B * Di * N floats.  T >= 1.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bmat, const void* cmat,
    const void* a, const void* h0, const void* hs, const void* dy,
    const void* dhT, int B, int T, int Di, int N, int bf16, void* dx,
    void* ddt, void* dbm, void* dcm, void* da, void* dh0, void* scratch,
    void* stream) {
  const long long dblocks = (Di + SB_CHANNELS - 1) / SB_CHANNELS;
  if (B <= 0 || Di <= 0 || T <= 0 || N <= 0 || N > 32 ||
      B * dblocks > INT_MAX ||
      ((long long)B * T * N + (long long)Di * N) / SB_SUM_THREADS + 1 >
          INT_MAX ||
      (T > SB_C && hs == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8)
    return dispatch<8>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                       bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
  if (N <= 16)
    return dispatch<16>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                        bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
  return dispatch<32>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                      bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
}
