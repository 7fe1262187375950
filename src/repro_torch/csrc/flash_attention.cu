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
// Output: o (B, Sq, Hq, Dh) in q's type, acc / max(l, 1e-30) rounded once;
// given a non-null `lse` (B, Hq, Sq) fp32, also each row's log-sum-exp of
// its scaled scores, m + log(max(l, 1e-30)), which the backward
// (flash_attention_bwd.cu) recomputes P from.  With a null `lse` (serving)
// the kernels compute what they did before it existed, bit for bit.
//
// The TPU kernel's grid is (B * Hq, Sq / 128, Skv / 128) with the kv axis
// sequential, carrying the running max m, the running sum l and the
// accumulator in VMEM scratch.  Blocks on the card run in no order, so
// the carry moves into one block's loop over the kv tiles, in order.
// kv tiles that the mask drops for every row of a q tile (above the
// causal diagonal, or wholly below the sliding window and outside the
// prefix) are skipped.  Every real row gives what the TPU kernel gives:
// there, such a tile leaves a row's m, l and acc unchanged once the row
// has kept a score (p = exp(-1e30 - m) = 0, alpha = 1), and before that
// it leaves finite values that the row's first kept tile multiplies by
// alpha = exp(-1e30 - m) = 0.  Every real row keeps a score (its
// diagonal, or kv 0 when Sq > Skv), except with a window and Sq > Skv
// + window, which no caller has.  No atomics, and every sum runs in a
// fixed order, so results repeat bit for bit.
//
// Bound on the H100: 4 Dh operations per kept (q, kv) pair and q head,
// against reading q, k and v and writing o once.  At a serving prefill
// (B = 4, S = 64, Hq = 8, Hkv = 1, Dh = 256) the bytes bound it and a
// launch costs more than either; at S = 8192 the operations do.
//
// bf16 (flash_attention_tc_kernel): the operations run on the tensor
// cores.  A block holds 128 q rows, two warpgroups of 64; the rows are
// (position, q head) pairs of one kv head's group, position-major, so a
// GQA group's heads share one tile (gemma-2b: 16 positions x 8 heads)
// and K and V are read once per group, not once per q head.  Per kv tile
// of 64 rows: S = Q K^T by wgmma (bf16 operands from shared memory, fp32
// accumulators); the mask, on tiles that straddle the diagonal, the
// window edge or Skv only; the online softmax in registers (row max and
// row sum over the accumulator fragment, two quad shuffles for the max;
// the sum stays per thread until the end); P rounded to bf16 in
// registers and fed to a second wgmma as its A operand, V read from
// shared memory through the descriptor's MN-major (transposed) mode.  K
// and V tiles arrive through a 2-stage ring filled with cp.async (16
// bytes a thread, zero-filled past Skv; not TMA), one barrier per tile.
// Rounding P to bf16 is what the reference's jnp attention does; the
// plain version keeps fp32 p (the tolerance, 2^-7 of the largest |out|,
// covers it).  Registers at Dh = 256: the 64 x 256 fp32 O accumulator is
// 128 a thread, S 32, P 16.
//
// fp32 (flash_attention_kernel): CUDA cores, one block per (q tile of
// FA_BQ rows, q head, batch), the (FA_BQ, Dh) accumulator in registers
// (16 x 16 threads, each 4 rows x Dh / 16 columns).  Per kv tile: K and V
// staged in shared memory; S = Q K^T * scale (each thread a 4 x 2 tile,
// float4 reads along Dh, rows padded by 4 floats against bank
// conflicts); the mask; the online-softmax update (one warp per row,
// shuffles in a fixed pattern); acc = acc * alpha + P V, all in fp32 (the
// tolerance of the fp32 checks, 1e-5, leaves no room for TF32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "hopper_mma.cuh"

#define FA_BQ 64
#define FA_BK 32
#define FA_THREADS 256
#define FA_PAD 4
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ROWS sequence rows from s0 of one head of a (B, S, H, DH) tensor into
// dst (ROWS x (DH + FA_PAD) fp32); rows at or past S are zeros, as the
// TPU kernel's padding
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
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

template <int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int Sq,
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
  load_tile<DH, FA_BQ>(qs, q, q0, Sq, q_stride, q_base);
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
    load_tile<DH, FA_BK>(ks, k, k0, Skv, kv_stride, kv_base);
    load_tile<DH, FA_BK>(vs, v, k0, Skv, kv_stride, kv_base);
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
          const bool ok = fa_kept(q0 + r, k0 + c, Sq, Skv, causal, window,
                                  prefix_len);
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
  if (lse != nullptr && tid < FA_BQ && q0 + tid < Sq)
    lse[((size_t)b * Hq + h) * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(o + q_base + (size_t)qp * q_stride +
                                 64 * j + 4 * tx) =
          make_float4(acc[i][j][0] / l, acc[i][j][1] / l, acc[i][j][2] / l,
                      acc[i][j][3] / l);
  }
}

template <int DH>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                  int causal, int window, int prefix_len, float scale,
                  cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_attention_kernel<DH><<<grid, FA_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Skv, Hq, Hkv, causal, window, prefix_len, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ---------------------------------------------
#define TC_BQ 128        // q rows (position, head) per block: 2 warpgroups
#define TC_BK 64         // kv rows per tile
#define TC_THREADS 256

template <int DH>
constexpr size_t tc_smem_bytes() {
  // Q (TC_BQ x DH), then 2 stages of K and V (TC_BK x DH each), bf16;
  // 1024 bytes of slack for the swizzle's alignment
  return (size_t)(TC_BQ + 4 * TC_BK) * DH * 2 + 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ROWS rows of DH bf16 into DH / 64 swizzled slabs of ROWS x 128 bytes;
// row r's source is src_row(r), or zeros when it returns nullptr (the
// copy then reads nothing; `any` stands in as its address)
template <int DH, int ROWS, typename F>
__device__ __forceinline__ void tc_load_rows(uint32_t dst,
                                             const __nv_bfloat16* any,
                                             F src_row) {
  constexpr int CH = DH / 8;                    // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CH; e += TC_THREADS) {
    const int r = e / CH, c = e - r * CH;
    const __nv_bfloat16* row = src_row(r);
    cp_async16(dst + (c >> 3) * (ROWS * 128) + swz(r, c & 7),
               row != nullptr ? row + c * 8 : any, row != nullptr);
  }
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Skv,
                          int Hq, int Hkv, int causal, int window,
                          int prefix_len, float scale_log2) {
  constexpr int NSL = DH / 64;                  // 64-column slabs
  constexpr uint32_t Q_SLAB = TC_BQ * 128, KV_SLAB = TC_BK * 128;
  constexpr uint32_t KV_TILE = NSL * KV_SLAB;   // one of K or V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t qs = (base + 1023) & ~1023u;
  const uint32_t kv0 = qs + NSL * Q_SLAB;       // stage s: K at kv0 +
                                                // 2 s KV_TILE, V after it
  const int G = Hq / Hkv;
  const int rows_total = Sq * G;                // (position, head) pairs
  const int ntile = (rows_total + TC_BQ - 1) / TC_BQ;
  const int f0 = (ntile - 1 - (int)blockIdx.x) * TC_BQ;  // longest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int pos_lo = f0 / G;
  const int pos_hi = min(Sq - 1, (f0 + TC_BQ - 1) / G);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)Hq * DH, kv_stride = (size_t)Hkv * DH;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_stride + (size_t)hk * G * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * DH;

  // the kv tiles that some row of this q tile keeps
  const int nkt = (Skv + TC_BK - 1) / TC_BK;
  int kt_lo = 0, kt_hi = nkt;
  if (causal) {
    kt_hi = pos_hi / TC_BK + 1;
    if (window > 0) kt_lo = max(0, (pos_lo - window + 1) / TC_BK);
    if (prefix_len > 0) {
      kt_lo = 0;
      kt_hi = max(kt_hi, (prefix_len + TC_BK - 1) / TC_BK);
    }
    kt_hi = min(kt_hi, nkt);
  }

  auto load_kv = [&](int kt, int stage) {
    const uint32_t ks = kv0 + 2 * stage * KV_TILE;
    const int k0 = kt * TC_BK;
    tc_load_rows<DH, TC_BK>(ks, kb, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < Skv ? kb + (size_t)(k0 + r) * kv_stride : nullptr;
    });
    tc_load_rows<DH, TC_BK>(ks + KV_TILE, vb, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < Skv ? vb + (size_t)(k0 + r) * kv_stride : nullptr;
    });
  };

  // Q (row f = position * G + head in the group) and the first kv tile
  tc_load_rows<DH, TC_BQ>(qs, qb, [&](int r) -> const __nv_bfloat16* {
    const int f = f0 + r;
    return f < rows_total
               ? qb + (size_t)(f / G) * q_stride + (size_t)(f % G) * DH
               : nullptr;
  });
  load_kv(kt_lo, 0);
  cp_async_commit();

  // this thread's two rows of the warpgroup's 64: ra = 16 wi + g4, ra + 8
  const int ra = wg * 64 + wi * 16 + g4;
  const int qpa = (f0 + ra) / G, qpb = (f0 + ra + 8) / G;

  float oacc[NSL][32];
#pragma unroll
  for (int n = 0; n < NSL; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[n][i] = 0.0f;
  float m_a = FA_NEG_INF, m_b = FA_NEG_INF, l_a = 0.0f, l_b = 0.0f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait<0>();        // this thread's copies of tile kt landed
    fence_proxy_async();
    __syncthreads();           // everyone's landed; tile kt-1 consumed
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();

    const uint32_t ks = kv0 + 2 * stage * KV_TILE, vs = ks + KV_TILE;
    const int k0 = kt * TC_BK;

    // S = Q K^T over DH / 16 k-steps
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint64_t da = desc_kmajor(qs + (kk >> 2) * Q_SLAB +
                                      wg * 64 * 128 + off);
      const uint64_t db = desc_kmajor(ks + (kk >> 2) * KV_SLAB + off);
      wgmma_bf16_ss_n64(s, da, db, kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // scale into the log2 domain; mask where the tile is not kept whole
    bool whole = k0 + TC_BK <= Skv;
    if (causal)
      whole = whole &&
              ((k0 + TC_BK - 1 <= pos_lo &&
                (window == 0 || pos_hi - k0 < window)) ||
               (prefix_len > 0 && k0 + TC_BK <= prefix_len));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (!whole) {
          // rows past Sq (qp >= Sq) are kept like row Sq - 1's: never
          // stored, they only need finite values
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = min(e < 2 ? qpa : qpb, Sq - 1);
          if (!fa_kept(qp, kp, Sq, Skv, causal, window, prefix_len))
            x = FA_NEG_INF;
        }
        s[4 * j + e] = x;
      }

    // online softmax: rows a (e = 0, 1) and b (e = 2, 3); a row's 64
    // columns sit on the 4 lanes of a quad
    float mx_a = FA_NEG_INF, mx_b = FA_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - mn_a);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - mn_a);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - mn_b);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - mn_b);
      sum_a += s[4 * j] + s[4 * j + 1];
      sum_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * al_a + sum_a;              // this thread's 16 columns
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < NSL; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        oacc[n][4 * j] *= al_a;
        oacc[n][4 * j + 1] *= al_a;
        oacc[n][4 * j + 2] *= al_b;
        oacc[n][4 * j + 3] *= al_b;
      }

    // P (bf16) as the A fragments of 4 k16 steps, then O += P V
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NSL; ++n)
        wgmma_bf16_rs_n64_tb(oacc[n], pa[kk],
                             desc_mnmajor(vs + n * KV_SLAB + kk * 2048));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < NSL; ++n) fence_regs(oacc[n]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const int fa = f0 + ra, fb = fa + 8;
  if (lse != nullptr && t4 == 0) {
    // m is in the log2 domain of the scaled scores
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = half ? fb : fa;
      if (f < rows_total)
        lse[((size_t)b * Hq + (size_t)hk * G + f % G) * Sq + f / G] =
            ((half ? m_b : m_a) + log2f(half ? l_b : l_a)) *
            0.6931471805599453f;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = half ? fb : fa;
    if (f >= rows_total) continue;
    const float l = half ? l_b : l_a;
    __nv_bfloat16* dst = o + ((size_t)b * Sq + f / G) * q_stride +
                         ((size_t)hk * G + f % G) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < NSL; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + n * 64 + 8 * j) =
            pack_bf16(oacc[n][4 * j + 2 * half] / l,
                      oacc[n][4 * j + 2 * half + 1] / l);
  }
}

template <int DH>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                     int causal, int window, int prefix_len, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = ((long)Sq * (Hq / Hkv) + TC_BQ - 1) / TC_BQ;
  if (tiles > 0x7fffffffL || Hkv > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, Hkv, B);
  flash_attention_tc_kernel<DH><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, Sq, Skv, Hq, Hkv,
      causal, window, prefix_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_dh(int bf16, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int Sq, int Skv, int Hq,
                     int Hkv, int causal, int window, int prefix_len,
                     float scale, cudaStream_t st) {
  return bf16 ? launch_tc<DH>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal,
                              window, prefix_len, scale, st)
              : launch<DH>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, prefix_len, scale, st);
}

// bf16: 1 if q, k, v and o are bf16 (the tensor-core kernel), 0 if fp32
// (the CUDA-core kernel); Dh one of 64, 128, 256; lse (B, Hq, Sq) fp32 or
// null
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dh,
                                      int bf16, int causal, int window,
                                      int prefix_len, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hq < 1 || Hq > 65535 ||
      Hkv < 1 || Hq % Hkv != 0 || window < 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv, Hq,
                            Hkv, causal, window, prefix_len, scale, st);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv, Hq,
                            Hkv, causal, window, prefix_len, scale, st);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv, Hq,
                            Hkv, causal, window, prefix_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
