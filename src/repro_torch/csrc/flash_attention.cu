// Flash attention (online softmax; GQA / MQA; causal, sliding-window and
// prefix-LM masks) for Hopper.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call at :109, body `_kernel` at :30).
//
// Input: q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), all fp32 or all
// bf16, read in place in that layout (no transpose).  Query head h reads
// kv head h / (Hq / Hkv).  Positions are the natural 0..S-1 of both
// sequences.  A (q, kv) pair is kept iff q_pos < Sq and kv_pos < Skv
// and, when causal, kv_pos <= q_pos, narrowed by `window` (q_pos - kv_pos
// < window) and widened by `prefix_len` (kv_pos < prefix_len).  A dropped
// score is NEG_INF = -1e30, finite, as in the TPU kernel: with -inf a
// fully dropped tile would give -inf - -inf = NaN.
// Output: o (B, Sq, Hq, Dh) in q's type, acc / max(l, 1e-30) rounded once.
//
// The TPU kernel's grid is (B * Hq, Sq / 128, Skv / 128) with the kv axis
// sequential, carrying the running max m, the running sum l and the
// accumulator in VMEM scratch.  Blocks on the card run in no order, so
// the carry moves into one block's loop: one block per (q tile of FA_BQ
// rows, q head, batch) walks the kv tiles (FA_BK rows) in order, holding
// m and l in shared memory and the (FA_BQ, Dh) fp32 accumulator in
// registers (16 x 16 threads, each 4 rows x Dh / 16 columns).  Per kv
// tile: K and V staged in shared memory, converted to fp32 once;
// S = Q K^T * scale (each thread a 4 x 2 tile, float4 reads along Dh,
// rows padded by 4 floats against bank conflicts); the mask; the
// online-softmax update (one warp per row, shuffles in a fixed pattern);
// acc = acc * alpha + P V.  All arithmetic is fp32 on CUDA cores; no
// atomics, and every sum runs in a fixed order, so results repeat bit
// for bit.
//
// kv tiles that the mask drops for every row of a q tile (above the
// causal diagonal, or wholly below the sliding window and outside the
// prefix) are skipped.  Every real row gives what the TPU kernel gives:
// there, such a tile leaves a row's m, l and acc unchanged once the row
// has kept a score (p = exp(-1e30 - m) = 0, alpha = 1), and before that
// it leaves finite values that the row's first kept tile multiplies by
// alpha = exp(-1e30 - m) = 0.  Every real row keeps a score (its
// diagonal, or kv 0 when Sq > Skv), except with a window and Sq > Skv
// + window, which no caller has.
//
// Bound on the H100: 4 Dh operations per kept (q, kv) pair and q head,
// against reading q, k and v and writing o once.  At a serving prefill
// (B = 4, S = 64, Hq = 8, Hkv = 1, Dh = 256) the bytes bound it and a
// launch costs more than either; at S = 8192 the operations do, and this
// fp32 design can at best reach the card's 67 TFLOP/s fp32 rate, not the
// 989 TFLOP/s of the bf16 tensor cores (wgmma, TMA and warp
// specialisation are work for a later change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_BQ 64
#define FA_BK 32
#define FA_THREADS 256
#define FA_PAD 4
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

// ROWS sequence rows from s0 of one head of a (B, S, H, DH) tensor into
// dst (ROWS x (DH + FA_PAD) fp32); rows at or past S are zeros, as the
// TPU kernel's padding
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int s0, int S, size_t row_stride,
                                          size_t base) {
  constexpr int V4 = DH / 4;
  for (int e = threadIdx.x; e < ROWS * V4; e += FA_THREADS) {
    const int r = e / V4;
    const int c = (e - r * V4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s0 + r < S) x = load4(src + base + (size_t)(s0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * (DH + FA_PAD) + c) = x;
  }
}

template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)(FA_BQ * (DH + FA_PAD) + 2 * FA_BK * (DH + FA_PAD) +
                  FA_BQ * (FA_BK + 1) + 3 * FA_BQ) *
         sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int window,
                       int prefix_len, float scale) {
  static_assert(DH % 64 == 0, "each thread holds DH / 16 columns as float4");
  constexpr int LD = DH + FA_PAD;
  constexpr int LP = FA_BK + 1;
  constexpr int NJ = DH / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // FA_BQ x LD
  float* ks = qs + FA_BQ * LD;         // FA_BK x LD
  float* vs = ks + FA_BK * LD;         // FA_BK x LD
  float* ps = vs + FA_BK * LD;         // FA_BQ x LP: scores, then p
  float* m_s = ps + FA_BQ * LP;        // running max per row
  float* l_s = m_s + FA_BQ;            // running sum per row
  float* a_s = l_s + FA_BQ;            // this tile's alpha per row

  const int nqt = (Sq + FA_BQ - 1) / FA_BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * FA_BQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;

  const size_t q_stride = (size_t)Hq * DH, kv_stride = (size_t)Hkv * DH;
  const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * DH;
  const size_t kv_base = (size_t)b * Skv * kv_stride + (size_t)hk * DH;
  load_tile<T, DH, FA_BQ>(qs, q, q0, Sq, q_stride, q_base);
  if (tid < FA_BQ) {
    m_s[tid] = FA_NEG_INF;
    l_s[tid] = 0.0f;
  }

  // the kv tiles that some row of this q tile keeps
  const int nkt = (Skv + FA_BK - 1) / FA_BK;
  int kt_lo = 0, kt_hi = nkt;
  if (causal) {
    kt_hi = (min(q0 + FA_BQ, Sq) - 1) / FA_BK + 1;
    if (window > 0) kt_lo = max(0, (q0 - window + 1) / FA_BK);
    if (prefix_len > 0) {
      kt_lo = 0;
      kt_hi = max(kt_hi, (prefix_len + FA_BK - 1) / FA_BK);
    }
    kt_hi = min(kt_hi, nkt);
  }

  // rows ty + 16 i, columns 64 j + 4 tx + e
  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile is consumed (qs, m_s, l_s set)
    load_tile<T, DH, FA_BK>(ks, k, k0, Skv, kv_stride, kv_base);
    load_tile<T, DH, FA_BK>(vs, v, k0, Skv, kv_stride, kv_base);
    __syncthreads();

    // S = Q K^T * scale, masked: rows ty + 16 i, columns tx + 16 j
    {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < 2; ++j) kv[j] = load4(ks + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const int qp = q0 + r, kp = k0 + c;
          bool ok = qp < Sq && kp < Skv;
          if (causal) {
            bool ca = kp <= qp;
            if (window > 0) ca = ca && (qp - kp) < window;
            if (prefix_len > 0) ca = ca || kp < prefix_len;
            ok = ok && ca;
          }
          ps[r * LP + c] = ok ? s[i][j] * scale : FA_NEG_INF;
        }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + 8, ...; lane c holds
    // column c.  The sum is lane 0's, so every lane uses one order.
    for (int r = warp; r < FA_BQ; r += FA_THREADS / 32) {
      const float sv = ps[r * LP + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sv - m_new);
      ps[r * LP + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sum = __shfl_sync(0xffffffffu, sum, 0);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 x = load4(vs + c * LD + 64 * j + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pv[i], x.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pv[i], x.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pv[i], x.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pv[i], x.w, acc[i][j][3]);
        }
      }
    }
  }
  __syncthreads();  // l_s is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store4(o + q_base + (size_t)qp * q_stride + 64 * j + 4 * tx,
             make_float4(acc[i][j][0] / l, acc[i][j][1] / l,
                         acc[i][j][2] / l, acc[i][j][3] / l));
  }
}

template <typename T, int DH>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                  int window, int prefix_len, float scale,
                  cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_attention_kernel<T, DH><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq, Hkv, causal,
      window, prefix_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int Dh, const void* q, const void* k, const void* v,
                    void* o, int B, int Sq, int Skv, int Hq, int Hkv,
                    int causal, int window, int prefix_len, float scale,
                    cudaStream_t st) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           prefix_len, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            prefix_len, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            prefix_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bf16: 1 if q, k, v and o are bf16, 0 if fp32; Dh one of 64, 128, 256
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dh,
                                      int bf16, int causal, int window,
                                      int prefix_len, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hq < 1 || Hq > 65535 ||
      Hkv < 1 || Hq % Hkv != 0 || window < 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                   causal, window, prefix_len, scale, st);
  return dispatch<float>(Dh, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                         prefix_len, scale, st);
}
