// Flash attention's backward (GQA / MQA; causal, sliding-window, prefix-LM
// and unmasked) for Hopper: dq, dk and dv of csrc/flash_attention.cu's
// forward.
//
// Replaces no Pallas kernel: the reference trains through the autodiff of
// its jnp attention (repro/models/attention.py:48 flash_attention), which
// this computes with the forward kernel's mask (flash_mask.cuh).  With
// scale = 1 / sqrt(Dh) and lse the forward's log-sum-exp of each q row:
//
//   D  = rowsum(dO * O)           P  = exp(S scale - lse), S = Q K^T
//   dV = P^T dO                   dP = dO V^T
//   dS = P * (dP - D)             dQ = scale dS K,  dK = scale dS^T Q
//
// dK and dV sum over each GQA group's q heads.  A dropped pair's P is 0
// (the forward's NEG_INF score, exp(-1e30 - lse) = 0).
//
// Input: q, o, dO (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh), all fp32 or all
// bf16; lse (B, Hq, Sq) fp32.  Output: dq, dk, dv in the inputs' type,
// and delta (B, Hq, Sq) fp32 (D above, scratch).  Two launches on one
// stream: the dQ kernel, one block per (q tile, q head, batch), loops
// over the kv tiles in order and writes its rows' D first; then the dK/dV
// kernel, one block per (kv tile, kv head, batch), loops over the q tiles
// in order and, inside each, over the group's q heads in order, so the
// group's sum stays inside the block.  Both recompute S and P from q, k
// and lse.  No atomics and every sum in a fixed order: results repeat
// bit for bit.  Tiles that the mask drops for every pair are skipped
// (fa_tile_kept).
//
// Bound on the H100: 10 Dh operations per kept (q, kv) pair and q head
// (the products S, dP, dV, dQ, dK) against reading q, k, v, o, dO and lse
// and writing dq, dk and dv once; the design recomputes S and dP in both
// kernels (14 Dh).  At gemma-2b's training shape (S = 1024, 8 q heads over
// one kv head of 256) the operations bound it.
//
// bf16 (the *_tc kernels): bf16 operands and fp32 accumulators on the
// tensor cores through mma.sync m16n8k16, one warp a 16-row slice.  Tiles
// sit in shared memory row-major with 16 bytes of padding a row, which
// makes every fragment load a conflict-free 32-bit read; a product whose
// B operand runs along the other axis (dQ += dS K, dV += P^T dO, dK +=
// dS^T Q) reads a transposed copy written while the tile is loaded.  P
// and dS stay in registers: an accumulator fragment of S is, packed to
// bf16, the A fragment of the next product.  P is rounded to bf16 for
// P^T dO, as the forward rounds it for P V; dS is rounded to bf16 for its
// two products.  Registers at Dh = 256: the dK and dV accumulators of a
// 64-row kv tile take 2 x 64 x 256 fp32, 256 a thread at 4 warps; the
// blocks take 8 warps there, each pair of warps splitting the output
// columns of one 16-row slice (both compute the slice's S and dP: the
// design's count above does not include that) and 32-row q tiles, so a
// thread holds 128 accumulators and 32 of S and dP.
//
// fp32 (the *_f32 kernels): CUDA cores, 256 threads, 32 x 32 score tiles
// in shared memory (each thread a 2 x 2 block of S and dP, float4 reads
// along Dh), the output rows of a block 32, each thread Dh / 8 columns of
// one row; all in fp32 (the fp32 checks' tolerance, 1e-5, leaves no room
// for TF32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper_mma.cuh"

#define FB_LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

// ---- bf16 on the tensor cores ----------------------------------------------
#define TB_Q 64     // dQ kernel: q rows a block
#define TB_K 64     // kv rows a tile (both kernels; a block of the dK/dV one)
#define TB_QK 32    // dK/dV kernel: q rows a tile
#define TB_PAD 8    // bf16 padding a shared-memory row (16 bytes)

template <int D>
struct TcShape {
  static constexpr int NS = D == 256 ? 2 : 1;  // output-column slices
  static constexpr int THREADS = 128 * NS;     // 4 row slices x NS
  static constexpr int DS = D / NS;            // output columns a warp
  static constexpr int LD = D + TB_PAD;        // a row-major tile's stride
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS rows of D bf16 (row r at src + r stride for r < n, zeros past n)
// into dst [ROWS][D + TB_PAD] and, unless dstT is null, transposed into
// dstT [D][ROWS + TB_PAD].  A warp's threads take neighbouring 16-byte
// chunks of a row, or, when transposing, one chunk of neighbouring rows,
// so that their 2-byte stores into dstT fall on neighbouring addresses
// (along a row they would all fall on one bank)
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void tc_rows(bf16* dst, bf16* dstT,
                                        const bf16* __restrict__ src,
                                        size_t stride, int n) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = dstT != nullptr ? e % ROWS : e / CH;
    const int c = (dstT != nullptr ? e / ROWS : e - r * CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      x = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + TB_PAD) + c) = x;
    if (dstT != nullptr) {
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dstT[(c + i) * (ROWS + TB_PAD) + r] = __ushort_as_bfloat16(
            (unsigned short)(w[i >> 1] >> (16 * (i & 1))));
    }
  }
}

// the A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a
// row-major tile with stride ld
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int k0, int g,
                                       int q4) {
  const bf16* p = t + (r0 + g) * ld + k0 + 2 * q4;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// the B fragment of columns n0 .. n0 + 7 and k rows k0 .. k0 + 15, read
// from a tile that holds B transposed (row n, k along the row)
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* t,
                                       int ld, int n0, int k0, int g,
                                       int q4) {
  const bf16* p = t + (n0 + g) * ld + k0 + 2 * q4;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// s = X[r0 .. r0 + 15] Y^T over D: X and Y row-major [.][D + TB_PAD], the
// NT n8 tiles of s Y's rows 0 .. 8 NT - 1
template <int D, int NT>
__device__ __forceinline__ void warp_xyt(float (&s)[NT][4], const bf16* x,
                                         int r0, const bf16* y, int g,
                                         int q4) {
  constexpr int LD = D + TB_PAD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    frag_a(a, x, LD, r0, kk, g, q4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2];
      frag_b(bb, y, LD, 8 * j, kk, g, q4);
      mma_bf16_16816(s[j], a, bb);
    }
  }
}

// acc += bf16(p) Z[:, c0 .. c0 + 8 NO - 1]: p a warp's 16 x 8 NK fragments
// (k = its columns), Z read through its transpose zt [D][ldt]
template <int NK, int NO>
__device__ __forceinline__ void warp_pz(float (&acc)[NO][4],
                                        const float (&p)[NK][4],
                                        const bf16* zt, int ldt, int c0,
                                        int g, int q4) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const uint32_t a[4] = {pack2(p[2 * kk][0], p[2 * kk][1]),
                           pack2(p[2 * kk][2], p[2 * kk][3]),
                           pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t bb[2];
      frag_b(bb, zt, ldt, c0 + 8 * n, 16 * kk, g, q4);
      mma_bf16_16816(acc[n], a, bb);
    }
  }
}

template <int D>
constexpr size_t dq_tc_smem() {
  return (size_t)(2 * TB_Q + 2 * TB_K) * (D + TB_PAD) * 2 +
         (size_t)D * (TB_K + TB_PAD) * 2 + 2 * TB_Q * 4;
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, 1)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const float* __restrict__ lse, const bf16* __restrict__ dO,
             bf16* __restrict__ dq, float* __restrict__ delta, int Sq,
             int Skv, int Hq, int Hkv, int causal, int window,
             int prefix_len, float scale) {
  using T = TcShape<D>;
  constexpr int LD = T::LD, LDT = TB_K + TB_PAD, NO = T::DS / 8;
  constexpr int NT = TB_K / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // TB_Q x LD
  bf16* dos = qs + TB_Q * LD;                      // TB_Q x LD
  bf16* ks = dos + TB_Q * LD;                      // TB_K x LD
  bf16* vs = ks + TB_K * LD;                       // TB_K x LD
  bf16* kts = vs + TB_K * LD;                      // D x LDT
  float* lse_s = reinterpret_cast<float*>(kts + D * LDT);  // log2 domain
  float* dl_s = lse_s + TB_Q;

  // the longest rows first (causal: the last q tile keeps every kv tile)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TB_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = T::DS * (warp >> 2);
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_base = ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
  const int nq = min(TB_Q, Sq - q0);

  tc_rows<D, TB_Q, T::THREADS>(qs, nullptr, q + q_base, q_stride, nq);
  tc_rows<D, TB_Q, T::THREADS>(dos, nullptr, dO + q_base, q_stride, nq);
  __syncthreads();
  // D = rowsum(dO * O) in fp32: a warp a row, lanes over Dh in a fixed
  // order, lane 0's sum of the butterfly
  for (int r = warp; r < TB_Q; r += T::THREADS / 32) {
    float acc = 0.0f;
    if (r < nq) {
      const bf16* orow = o + q_base + (size_t)r * q_stride;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(__bfloat162float(dos[r * LD + d]),
                   __bfloat162float(orow[d]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const size_t row = ((size_t)b * Hq + h) * Sq + q0 + r;
      dl_s[r] = acc;
      lse_s[r] = r < nq ? lse[row] * FB_LOG2E : 0.0f;
      if (r < nq) delta[row] = acc;
    }
  }

  const float sl2 = scale * FB_LOG2E;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int nkt = (Skv + TB_K - 1) / TB_K;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TB_K, nk = min(TB_K, Skv - k0);
    if (!fa_tile_kept(q0, q0 + nq, k0, k0 + nk, causal, window, prefix_len))
      continue;
    __syncthreads();  // the previous tile is consumed; D and lse are set
    const size_t kv_base =
        ((size_t)b * Skv + k0) * kv_stride + (size_t)hk * D;
    tc_rows<D, TB_K, T::THREADS>(ks, kts, k + kv_base, kv_stride, nk);
    tc_rows<D, TB_K, T::THREADS>(vs, nullptr, v + kv_base, kv_stride, nk);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    warp_xyt<D, NT>(s, qs, r0, ks, g, q4);     // S = Q K^T
    warp_xyt<D, NT>(dp, dos, r0, vs, g, q4);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * q4 + (e & 1);
        const float p = fa_kept(q0 + r, k0 + c, Sq, Skv, causal, window,
                                prefix_len)
                            ? exp2f(s[j][e] * sl2 - lse_s[r])
                            : 0.0f;
        s[j][e] = p * (dp[j][e] - dl_s[r]);    // dS
      }
    warp_pz<NT, NO>(acc, s, kts, LDT, c0, g, q4);   // dQ += dS K
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= nq) continue;
    bf16* dst = dq + q_base + (size_t)r * q_stride + c0 + 2 * q4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  return (size_t)(2 * TB_K + 2 * TB_QK) * (D + TB_PAD) * 2 +
         (size_t)2 * D * (TB_QK + TB_PAD) * 2 + 2 * TB_QK * 4;
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, 1)
fa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const bf16* __restrict__ dO,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
               int Skv, int Hq, int Hkv, int causal, int window,
               int prefix_len, float scale) {
  using T = TcShape<D>;
  constexpr int LD = T::LD, LDT = TB_QK + TB_PAD, NO = T::DS / 8;
  constexpr int NQ = TB_QK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // TB_K x LD
  bf16* vs = ks + TB_K * LD;                       // TB_K x LD
  bf16* qs = vs + TB_K * LD;                       // TB_QK x LD
  bf16* dos = qs + TB_QK * LD;                     // TB_QK x LD
  bf16* qts = dos + TB_QK * LD;                    // D x LDT
  bf16* dots = qts + D * LDT;                      // D x LDT
  float* lse_s = reinterpret_cast<float*>(dots + D * LDT);  // log2 domain
  float* dl_s = lse_s + TB_QK;

  const int k0 = blockIdx.x * TB_K, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = T::DS * (warp >> 2);
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t kv_base = ((size_t)b * Skv + k0) * kv_stride + (size_t)hk * D;
  const int nk = min(TB_K, Skv - k0);
  tc_rows<D, TB_K, T::THREADS>(ks, nullptr, k + kv_base, kv_stride, nk);
  tc_rows<D, TB_K, T::THREADS>(vs, nullptr, v + kv_base, kv_stride, nk);

  const float sl2 = scale * FB_LOG2E;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int nqt = (Sq + TB_QK - 1) / TB_QK;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * TB_QK, nq = min(TB_QK, Sq - q0);
    if (!fa_tile_kept(q0, q0 + nq, k0, k0 + nk, causal, window, prefix_len))
      continue;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      const size_t q_base = ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
      __syncthreads();  // the previous tile is consumed (K, V loaded)
      tc_rows<D, TB_QK, T::THREADS>(qs, qts, q + q_base, q_stride, nq);
      tc_rows<D, TB_QK, T::THREADS>(dos, dots, dO + q_base, q_stride, nq);
      if (tid < TB_QK) {
        const size_t row = ((size_t)b * Hq + h) * Sq + q0 + tid;
        lse_s[tid] = tid < nq ? lse[row] * FB_LOG2E : 0.0f;
        dl_s[tid] = tid < nq ? delta[row] : 0.0f;
      }
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
      warp_xyt<D, NQ>(s, ks, r0, qs, g, q4);    // S^T = K Q^T
      warp_xyt<D, NQ>(dp, vs, r0, dos, g, q4);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * q4 + (e & 1);
          const float p = fa_kept(q0 + c, k0 + r, Sq, Skv, causal, window,
                                  prefix_len)
                              ? exp2f(s[j][e] * sl2 - lse_s[c])
                              : 0.0f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[c]);   // dS^T
        }
      warp_pz<NQ, NO>(dva, s, dots, LDT, c0, g, q4);   // dV += P^T dO
      warp_pz<NQ, NO>(dka, dp, qts, LDT, c0, g, q4);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= nk) continue;
    const size_t off = kv_base + (size_t)r * kv_stride + c0 + 2 * q4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack2(dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack2(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// ---- fp32 on CUDA cores -----------------------------------------------------
#define FB_T 32         // q and kv rows a tile (both kernels)
#define FB_THREADS 256
#define FB_PAD 4        // fp32 padding a shared-memory row

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// FB_T rows of D fp32 (row r at src + r stride for r < n, zeros past n)
// into dst [FB_T][D + FB_PAD]
template <int D>
__device__ __forceinline__ void f32_rows(float* dst,
                                         const float* __restrict__ src,
                                         size_t stride, int n) {
  constexpr int V4 = D / 4;
  for (int e = threadIdx.x; e < FB_T * V4; e += FB_THREADS) {
    const int r = e / V4, c = (e - r * V4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n) x = ld4(src + (size_t)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + FB_PAD) + c) = x;
  }
}

// s[i][j] = X[ty + 16 i] . Y[tx + 16 j] over D, in order
template <int D>
__device__ __forceinline__ void f32_xyt(float (&s)[2][2], const float* x,
                                        const float* y, int tx, int ty) {
  constexpr int LD = D + FB_PAD;
  s[0][0] = s[0][1] = s[1][0] = s[1][1] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = ld4(x + ty * LD + d), x1 = ld4(x + (ty + 16) * LD + d);
    const float4 y0 = ld4(y + tx * LD + d), y1 = ld4(y + (tx + 16) * LD + d);
    const float4 xs[2] = {x0, x1}, ys[2] = {y0, y1};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a = s[i][j];
        a = fmaf(xs[i].x, ys[j].x, a);
        a = fmaf(xs[i].y, ys[j].y, a);
        a = fmaf(xs[i].z, ys[j].z, a);
        a = fmaf(xs[i].w, ys[j].w, a);
        s[i][j] = a;
      }
  }
}

// acc[jj] += sum_c w[row][c] Z[c][4 cg + 32 jj ..] over the FB_T columns
// of w ([FB_T][FB_T + 1]) in order, Z [FB_T][D + FB_PAD]
template <int D>
__device__ __forceinline__ void f32_wz(float4 (&acc)[D / 32], const float* w,
                                       int row, const float* z, int cg) {
  constexpr int LD = D + FB_PAD;
  for (int c = 0; c < FB_T; ++c) {
    const float x = w[row * (FB_T + 1) + c];
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj) {
      const float4 zv = ld4(z + c * LD + 4 * cg + 32 * jj);
      acc[jj].x = fmaf(x, zv.x, acc[jj].x);
      acc[jj].y = fmaf(x, zv.y, acc[jj].y);
      acc[jj].z = fmaf(x, zv.z, acc[jj].z);
      acc[jj].w = fmaf(x, zv.w, acc[jj].w);
    }
  }
}

template <int D>
__device__ __forceinline__ void f32_store(float* dst,
                                          const float4 (&acc)[D / 32], int cg,
                                          float mul) {
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj)
    *reinterpret_cast<float4*>(dst + 4 * cg + 32 * jj) =
        make_float4(acc[jj].x * mul, acc[jj].y * mul, acc[jj].z * mul,
                    acc[jj].w * mul);
}

template <int D>
constexpr size_t f32_smem() {
  return (size_t)(4 * FB_T * (D + FB_PAD) + 2 * FB_T * (FB_T + 1) +
                  2 * FB_T) * 4;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ lse, const float* __restrict__ dO,
              float* __restrict__ dq, float* __restrict__ delta, int Sq,
              int Skv, int Hq, int Hkv, int causal, int window,
              int prefix_len, float scale) {
  constexpr int LD = D + FB_PAD;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                       // FB_T x LD
  float* dos = qs + FB_T * LD;
  float* ks = dos + FB_T * LD;
  float* vs = ks + FB_T * LD;
  float* ds = vs + FB_T * LD;            // FB_T x (FB_T + 1)
  float* lse_s = ds + 2 * FB_T * (FB_T + 1);
  float* dl_s = lse_s + FB_T;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_T;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int row = tid >> 3, cg = tid & 7;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_base = ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
  const int nq = min(FB_T, Sq - q0);

  f32_rows<D>(qs, q + q_base, q_stride, nq);
  f32_rows<D>(dos, dO + q_base, q_stride, nq);
  __syncthreads();
  for (int r = warp; r < FB_T; r += FB_THREADS / 32) {
    float acc = 0.0f;
    if (r < nq) {
      const float* orow = o + q_base + (size_t)r * q_stride;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dos[r * LD + d], orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const size_t rw = ((size_t)b * Hq + h) * Sq + q0 + r;
      dl_s[r] = acc;
      lse_s[r] = r < nq ? lse[rw] : 0.0f;
      if (r < nq) delta[rw] = acc;
    }
  }

  float4 acc[D / 32];
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj)
    acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nkt = (Skv + FB_T - 1) / FB_T;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * FB_T, nk = min(FB_T, Skv - k0);
    if (!fa_tile_kept(q0, q0 + nq, k0, k0 + nk, causal, window, prefix_len))
      continue;
    __syncthreads();  // the previous tile is consumed; D and lse are set
    const size_t kv_base =
        ((size_t)b * Skv + k0) * kv_stride + (size_t)hk * D;
    f32_rows<D>(ks, k + kv_base, kv_stride, nk);
    f32_rows<D>(vs, v + kv_base, kv_stride, nk);
    __syncthreads();
    float s[2][2], dp[2][2];
    f32_xyt<D>(s, qs, ks, tx, ty);
    f32_xyt<D>(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = fa_kept(q0 + r, k0 + c, Sq, Skv, causal, window,
                                prefix_len)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.0f;
        ds[r * (FB_T + 1) + c] = p * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();
    f32_wz<D>(acc, ds, row, ks, cg);     // dQ += dS K
  }
  if (row < nq)
    f32_store<D>(dq + q_base + (size_t)row * q_stride, acc, cg, scale);
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ dO, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                int causal, int window, int prefix_len, float scale) {
  constexpr int LD = D + FB_PAD;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                       // FB_T x LD
  float* vs = ks + FB_T * LD;
  float* qs = vs + FB_T * LD;
  float* dos = qs + FB_T * LD;
  float* pt = dos + FB_T * LD;           // P^T, FB_T x (FB_T + 1)
  float* dst = pt + FB_T * (FB_T + 1);   // dS^T
  float* lse_s = dst + FB_T * (FB_T + 1);
  float* dl_s = lse_s + FB_T;

  const int k0 = blockIdx.x * FB_T, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row = tid >> 3, cg = tid & 7;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t kv_base = ((size_t)b * Skv + k0) * kv_stride + (size_t)hk * D;
  const int nk = min(FB_T, Skv - k0);
  f32_rows<D>(ks, k + kv_base, kv_stride, nk);
  f32_rows<D>(vs, v + kv_base, kv_stride, nk);

  float4 dka[D / 32], dva[D / 32];
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj)
    dka[jj] = dva[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nqt = (Sq + FB_T - 1) / FB_T;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * FB_T, nq = min(FB_T, Sq - q0);
    if (!fa_tile_kept(q0, q0 + nq, k0, k0 + nk, causal, window, prefix_len))
      continue;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      const size_t q_base = ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
      __syncthreads();  // the previous tile is consumed (K, V loaded)
      f32_rows<D>(qs, q + q_base, q_stride, nq);
      f32_rows<D>(dos, dO + q_base, q_stride, nq);
      if (tid < FB_T) {
        const size_t rw = ((size_t)b * Hq + h) * Sq + q0 + tid;
        lse_s[tid] = tid < nq ? lse[rw] : 0.0f;
        dl_s[tid] = tid < nq ? delta[rw] : 0.0f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      f32_xyt<D>(s, ks, qs, tx, ty);     // S^T: rows kv, columns q
      f32_xyt<D>(dp, vs, dos, tx, ty);   // dP^T
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = fa_kept(q0 + c, k0 + r, Sq, Skv, causal, window,
                                  prefix_len)
                              ? expf(s[i][j] * scale - lse_s[c])
                              : 0.0f;
          pt[r * (FB_T + 1) + c] = p;
          dst[r * (FB_T + 1) + c] = p * (dp[i][j] - dl_s[c]);
        }
      __syncthreads();
      f32_wz<D>(dva, pt, row, dos, cg);   // dV += P^T dO
      f32_wz<D>(dka, dst, row, qs, cg);   // dK += dS^T Q
    }
  }
  if (row < nk) {
    const size_t off = kv_base + (size_t)row * kv_stride;
    f32_store<D>(dk + off, dka, cg, scale);
    f32_store<D>(dv + off, dva, cg, 1.0f);
  }
}

// ---- launches ---------------------------------------------------------------
template <typename K>
static int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
static int launch_dh(int bf16_in, const void* q, const void* k,
                     const void* v, const void* o, const float* lse,
                     const void* dO, void* dq, void* dk, void* dv,
                     float* delta, int B, int Sq, int Skv, int Hq, int Hkv,
                     int causal, int window, int prefix_len, float scale,
                     cudaStream_t st) {
  int err;
  if (bf16_in) {
    constexpr int TH = TcShape<D>::THREADS;
    if ((err = set_smem(fa_bwd_dq_tc<D>, dq_tc_smem<D>())) != 0) return err;
    if ((err = set_smem(fa_bwd_dkdv_tc<D>, dkdv_tc_smem<D>())) != 0)
      return err;
    fa_bwd_dq_tc<D><<<dim3((Sq + TB_Q - 1) / TB_Q, Hq, B), TH,
                      dq_tc_smem<D>(), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse,
        (const bf16*)dO, (bf16*)dq, delta, Sq, Skv, Hq, Hkv, causal, window,
        prefix_len, scale);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    fa_bwd_dkdv_tc<D><<<dim3((Skv + TB_K - 1) / TB_K, Hkv, B), TH,
                        dkdv_tc_smem<D>(), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, delta,
        (const bf16*)dO, (bf16*)dk, (bf16*)dv, Sq, Skv, Hq, Hkv, causal,
        window, prefix_len, scale);
    return (int)cudaGetLastError();
  }
  if ((err = set_smem(fa_bwd_dq_f32<D>, f32_smem<D>())) != 0) return err;
  if ((err = set_smem(fa_bwd_dkdv_f32<D>, f32_smem<D>())) != 0) return err;
  fa_bwd_dq_f32<D><<<dim3((Sq + FB_T - 1) / FB_T, Hq, B), FB_THREADS,
                     f32_smem<D>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, lse,
      (const float*)dO, (float*)dq, delta, Sq, Skv, Hq, Hkv, causal, window,
      prefix_len, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  fa_bwd_dkdv_f32<D><<<dim3((Skv + FB_T - 1) / FB_T, Hkv, B), FB_THREADS,
                       f32_smem<D>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, lse, delta,
      (const float*)dO, (float*)dk, (float*)dv, Sq, Skv, Hq, Hkv, causal,
      window, prefix_len, scale);
  return (int)cudaGetLastError();
}

// bf16: 1 if q, k, v, o, dO and the gradients are bf16 (the tensor-core
// kernels), 0 if fp32 (the CUDA-core kernels); Dh one of 64, 128, 256; lse
// and delta (B, Hq, Sq) fp32
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Skv, int Hq, int Hkv, int Dh, int bf16,
    int causal, int window, int prefix_len, float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hq < 1 || Hq > 65535 ||
      Hkv < 1 || Hq % Hkv != 0 || window < 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  switch (Dh) {
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, B, Sq,
                           Skv, Hq, Hkv, causal, window, prefix_len, scale,
                           st);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, B, Sq,
                            Skv, Hq, Hkv, causal, window, prefix_len, scale,
                            st);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, B, Sq,
                            Skv, Hq, Hkv, causal, window, prefix_len, scale,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
