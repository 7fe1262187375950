// The RWKV-6 WKV recurrence's backward for Hopper: chunk-parallel like
// its forward (csrc/wkv6.cu), the state's gradient carried over chunks.
//
// Replaces no Pallas kernel: the reference trains through the autodiff of
// its jnp recurrence (repro/kernels/ops.py:33-47 sends wkv6 to
// repro/models/rwkv6.py::wkv6_chunked); this is the VJP of the forward
// that csrc/wkv6.cu computes (kernels/ref.py::wkv6_ref).
//
// Input: r, k, v, w (B, T, H, N) with N = 64 as the forward took them
// (r, k and v one type, fp32 or bf16; w fp32 or bf16); u (H, N) fp32; s0
// (B, H, N, N) fp32; the forward's scratch after its phase B (slot m of
// each (b, h) holds S_in[m + 1], the state at the start of chunk m + 1;
// then each chunk's decay product D[m]); dy (B, T, H, N) fp32; dsT (B, H,
// N, N) fp32 or null (zeros).  With G_t the gradient of the state after
// step t (G_{T-1} = dsT), per step:
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
// Output: dr, dk, dv in r's type, dw in w's, du (H, N) and ds0 (B, H, N, N)
// fp32.
//
// Bound on the H100: ~12 fp32 operations per (b, t, h, i, j) (the state
// rebuilt, dr, dk, dv, dw, G), so the fp32 rate bounds it (B = 1, T =
// 1024, H = 40: 0.030 ms); the function's bytes take 0.019 ms.
//
// What held the first design back (1.17 ms there, 39x the bound): one
// block per (b, h, 8 state rows) walked all T steps twice, forward to
// stage a chunk's 64 states in 128 KB of shared memory, then backward
// against them: a 2048-step chain a block, one 8-warp block an SM, every
// sum over j a 5-shuffle butterfly (20 shuffles a step for 4-6 FMAs a
// lane), and dv's 8 row groups' partials (84 MB) added by a second kernel.
//
// This design cuts time into the forward's 64-step chunks and each chunk
// into sub-chunks of WB_SUB steps, and uses that the recurrences are
// linear.  In chunk k (last step t1), G_t = diag(Q_t) G_out[k] + Gloc_t
// with Q_t = prod_{t < m <= t1} w_m and Gloc the chunk's own reverse
// recurrence from 0 (from dsT in the last chunk); G_out[k - 1] =
// diag(D[k]) G_out[k] + Gloc_start[k].  No quantity is ever divided by a
// decay (a decay may be exactly 0, or 1e-31): every product of decays is
// formed by multiplying, in the direction the recurrence runs.
//   A. per (b, h, chunk), two kernels of 256 threads:
//      rows: four threads a state row i, 16 columns each, every sum over
//      j inside the thread plus two shuffles.  Forward over the chunk
//      from S_in (the forward's state): dr_t exactly, and S at each
//      sub-chunk's start (S_b) kept in scratch.  Backward, sub-chunk by
//      sub-chunk from the last, with G_e = Gloc at the sub-chunk's end:
//      sigma[s] = S_b . dy_s, kappa[s] = G_e . v_s, E = G_e . S_b (row
//      dots), then per step, from the end, with kappa[s] = G_t . v_s and
//      E = G_t . S_b carried by G's own recurrence (kappa[s] <- w_t
//      kappa[s] + r_t (v_s . dy_t), E <- w_t E + r_t sigma[t]):
//        dk_t = kappa[t] + bonus
//        dw_t = Horner over s in [start, t) of w_s, k_s kappa[s] from E
//             = prod_{s<t} w_s E + sum_s (prod_{s<m<t} w_m) k_s kappa[s]
//      which is G_t . S_{t-1} with S_{t-1} = diag(P_t) S_b + sum_{s<t}
//      ... k_s v_s^T written out, so no state of the sub-chunk is kept.
//      G then steps over the sub-chunk at once: G_e' = diag(prod w) G_e +
//      sum_s (prod_{start<=m<s} w_m) r_s dy_s^T.  It writes dr, the local
//      dk and dw, du's per-chunk partial and Gloc_start.
//      cols: four threads a column j of G (16 rows each): dv_t by the
//      step recurrence of Gloc, the sum over i inside the thread.
//      Each block stages its sub-chunks' r, k, v, w and dy with cp.async,
//      double-buffered; v_t . dy_t is taken once a (b, h, t).
//   B. per (b, h, 128 entries of G): the reverse carry over chunks, one
//      float4 a thread, loads issued WB_PF chunks ahead; writes G_out[k]
//      over Gloc_start[k + 1] and ds0 = D[0] G_out[0] + Gloc_start[0].
//   C. per (b, h, chunk < last): the carry terms, with X_t = G_out v_t
//      and Y_t = G_out . S_{t-1} (Y_0 = G_out . S_in, Y_{t+1} = w_t Y_t
//      + k_t X_t): dk_t += Q_t X_t, dv_t += G_out^T (Q_t k_t), dw_t += Q_t
//      Y_t, as two (64 x 64) (64 x 64) products on CUDA cores in fp32 (4 x
//      4 tiles), added to A's fp32 partials in a fixed order and cast;
//      H more blocks add du's partials over (b, chunk) in order.
// When T <= 64 there is one chunk: A starts from dsT and writes every
// output, B does not run and C only sums du.  No atomics: every sum runs
// in a fixed order and the results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define WB_N 64
#define WB_C 64               // steps per chunk (kernels/wkv6.py: CHUNK)
#define WB_SUB 16             // steps per sub-chunk (kernels/wkv6.py: SUB)
#define WB_SUBS (WB_C / WB_SUB)
#define WB_THREADS 256        // A: four threads a row (rows) or column
#define WB_B_THREADS 128      // B: one float4 of G per thread
#define WB_PF 8               // B: chunks loaded ahead
#define WB_C_THREADS 256      // C: a 4 x 4 tile of each product per thread
#define WB_DEVICES 64

static_assert(WB_THREADS == 4 * WB_N, "four threads a row");
static_assert(WB_SUB * WB_SUB == WB_THREADS, "one v . dy entry a thread");
static_assert(WB_C_THREADS == (WB_C / 4) * (WB_N / 4), "phase C tiles");
static_assert(WB_C % WB_SUB == 0 && 4 * WB_SUB <= WB_N,
              "sub-chunks: whole in a chunk, a step's bonus four lanes");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive elements as fp32 (16-byte aligned fp32, 8-byte bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// the sum over a row's (or column's) four adjacent lanes: two shuffles;
// every lane of the four ends with the same bits
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled when !valid (src not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a staged row's length: 64 elements and 16 bytes, so rows start 4 banks
// apart (16-byte copies stay aligned)
template <typename T>
struct Pad {
  static constexpr int value = WB_N + 16 / (int)sizeof(T);
};

// one sub-chunk's operands, row c = step c0 + c of the chunk
template <typename TR, typename TW>
struct __align__(16) Stage {
  TR r[WB_SUB][Pad<TR>::value];
  TR k[WB_SUB][Pad<TR>::value];
  TR v[WB_SUB][Pad<TR>::value];
  TW w[WB_SUB][Pad<TW>::value];
  float dy[WB_SUB][Pad<float>::value];
};

// rows [c0, c0 + WB_SUB) of x's chunk at `base` (rows from `len` on zero)
template <typename T, int P>
__device__ __forceinline__ void stage_rows(T (*dst)[P],
                                           const T* __restrict__ x,
                                           size_t base, size_t tstride,
                                           int c0, int len, int tid) {
  constexpr int per = 16 / (int)sizeof(T), pieces = WB_N / per;
  for (int e = tid; e < WB_SUB * pieces; e += WB_THREADS) {
    const int c = e / pieces, q = e - (e / pieces) * pieces;
    const bool ok = c0 + c < len;
    cp16(&dst[c][q * per],
         ok ? x + base + (size_t)(c0 + c) * tstride + q * per : x, ok);
  }
}

template <typename TR, typename TW>
__device__ __forceinline__ void stage(Stage<TR, TW>& s, const TR* r,
                                      const TR* k, const TR* v, const TW* w,
                                      const float* dy, size_t base,
                                      size_t tstride, int c0, int len,
                                      int tid) {
  stage_rows(s.r, r, base, tstride, c0, len, tid);
  stage_rows(s.k, k, base, tstride, c0, len, tid);
  if (v != nullptr) stage_rows(s.v, v, base, tstride, c0, len, tid);
  stage_rows(s.w, w, base, tstride, c0, len, tid);
  stage_rows(s.dy, dy, base, tstride, c0, len, tid);
  cp_commit();
}

// this thread's 16 of a row (columns 16 m + 4 p + e): float4s at 16 m + 4 p
__device__ __forceinline__ void load16(float (&x)[16], const float* row,
                                       int p) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 a = ld4(row + 16 * m + 4 * p);
    x[4 * m] = a.x, x[4 * m + 1] = a.y, x[4 * m + 2] = a.z,
              x[4 * m + 3] = a.w;
  }
}
__device__ __forceinline__ void store16(float* row, const float (&x)[16],
                                        int p) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    *reinterpret_cast<float4*>(row + 16 * m + 4 * p) =
        make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
}
// sum over this thread's 16 of x[e] y[e], y a staged row, in order
template <typename T>
__device__ __forceinline__ float dot16(const float (&x)[16], const T* y,
                                       int p) {
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 b = ld4(y + 16 * m + 4 * p);
    acc = fmaf(x[4 * m], b.x, acc);
    acc = fmaf(x[4 * m + 1], b.y, acc);
    acc = fmaf(x[4 * m + 2], b.z, acc);
    acc = fmaf(x[4 * m + 3], b.w, acc);
  }
  return acc;
}

template <typename TR, typename TW>
constexpr size_t rows_smem() {
  return 2 * sizeof(Stage<TR, TW>) +
         sizeof(float) * (WB_SUBS * WB_SUB * (WB_SUB + 1) + WB_SUB * WB_N);
}

// -- phase A, rows: dr, the local dk and dw, du's partial, Gloc_start -------
template <typename TR, typename TW>
__global__ void __launch_bounds__(WB_THREADS, sizeof(TR) == 2 ? 3 : 2)
wkv6_bwd_rows_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                     const TR* __restrict__ v, const TW* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     const float* __restrict__ chk,
                     const float* __restrict__ dy,
                     const float* __restrict__ dsT, int T, int H,
                     int n_chunks, TR* __restrict__ dr, TR* __restrict__ dk,
                     TW* __restrict__ dw, float* __restrict__ loc_dk,
                     float* __restrict__ loc_dw, float* __restrict__ sub_s,
                     float* __restrict__ du_part,
                     float* __restrict__ g_start) {
  using St = Stage<TR, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  St* st = reinterpret_cast<St*>(smem);                 // two buffers
  // v_s . dy_c of each sub-chunk, kept from the forward pass for the
  // backward's (its diagonal is v_t . dy_t)
  float(*sA)[WB_SUB][WB_SUB + 1] =
      reinterpret_cast<float(*)[WB_SUB][WB_SUB + 1]>(smem + 2 * sizeof(St));
  // the backward's sigma[c] = S_b . dy_c of each row (the sub-chunk's)
  float(*sSig)[WB_N] = reinterpret_cast<float(*)[WB_N]>(
      &sA[WB_SUBS][0][0]);
  const int bh = blockIdx.x / n_chunks;
  const int ck = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int i = tid >> 2, p = tid & 3;       // row i, columns 16 m + 4 p + e
  const int t0 = ck * WB_C;
  const int len = min(WB_C, T - t0);
  const int nsub = (len + WB_SUB - 1) / WB_SUB;
  const bool last = ck == n_chunks - 1;
  const size_t tstride = (size_t)H * WB_N;
  const size_t base = (((size_t)b * T + t0) * H + h) * WB_N;
  const size_t row = ((size_t)bh * WB_N + i) * WB_N;     // (b, h, i, 0)
  const size_t slot = blockIdx.x;                        // (b, h, chunk)
  const float ui = u[(size_t)h * WB_N + i];
  const float* s_in =
      ck == 0 ? s0 + row
              : chk + (((size_t)bh * n_chunks + ck - 1) * WB_N + i) * WB_N;
  float* sb_row = sub_s + (slot * (WB_SUBS - 1) * WB_N + i) * WB_N;

  stage(st[0], r, k, v, w, dy, base, tstride, 0, len, tid);
  float s[16];
  load16(s, s_in, p);

  // forward: S from S_in, dr_t exactly, S_b of each later sub-chunk kept
  for (int q = 0; q < nsub; ++q) {
    if (q + 1 < nsub) {
      stage(st[(q + 1) & 1], r, k, v, w, dy, base, tstride,
            (q + 1) * WB_SUB, len, tid);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const St& S = st[q & 1];
    const int c0 = q * WB_SUB;
    const int nq = min(WB_SUB, len - c0);
    {
      const int ca = tid / WB_SUB, cb = tid - (tid / WB_SUB) * WB_SUB;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < WB_N; j += 4) {
        const float4 a = ld4(&S.v[ca][j]), d = ld4(&S.dy[cb][j]);
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
        acc = fmaf(a.z, d.z, acc);
        acc = fmaf(a.w, d.w, acc);
      }
      sA[q][ca][cb] = acc;
    }
    if (q > 0) store16(sb_row + (size_t)(q - 1) * WB_N * WB_N, s, p);
    __syncthreads();
    for (int c = 0; c < nq; ++c) {
      const float sdy = quad_sum(dot16(s, &S.dy[c][0], p));
      const float kc = to_f32(S.k[c][i]), wc = to_f32(S.w[c][i]);
      if (p == (c & 3))
        store_as(dr + base + (size_t)(c0 + c) * tstride + i,
                 fmaf(ui * kc, sA[q][c][c], sdy));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 vv = ld4(&S.v[c][16 * m + 4 * p]);
        s[4 * m] = fmaf(wc, s[4 * m], kc * vv.x);
        s[4 * m + 1] = fmaf(wc, s[4 * m + 1], kc * vv.y);
        s[4 * m + 2] = fmaf(wc, s[4 * m + 2], kc * vv.z);
        s[4 * m + 3] = fmaf(wc, s[4 * m + 3], kc * vv.w);
      }
    }
    __syncthreads();
  }

  // backward, sub-chunk by sub-chunk from the last (whose operands are
  // still staged); g = Gloc after the sub-chunk's last step
  float g[16];
  if (last && dsT != nullptr) {
    load16(g, dsT + row, p);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) g[e] = 0.0f;
  }
  float du_acc = 0.0f;
  for (int q = nsub - 1; q >= 0; --q) {
    if (q > 0) {
      stage(st[(q - 1) & 1], r, k, v, w, dy, base, tstride,
            (q - 1) * WB_SUB, len, tid);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const St& S = st[q & 1];
    const int c0 = q * WB_SUB;
    const int nq = min(WB_SUB, len - c0);
    float kap[WB_SUB], e;
    {
      float sb[16];
      load16(sb, q == 0 ? s_in : sb_row + (size_t)(q - 1) * WB_N * WB_N, p);
      e = 0.0f;
#pragma unroll
      for (int x = 0; x < 16; ++x) e = fmaf(g[x], sb[x], e);
#pragma unroll
      for (int c = 0; c < WB_SUB; ++c) {
        const float sg = quad_sum(dot16(sb, &S.dy[c][0], p));
        if (p == 0) sSig[c][i] = sg;
      }
    }
#pragma unroll
    for (int c = 0; c < WB_SUB; ++c) kap[c] = dot16(g, &S.v[c][0], p);
    e = quad_sum(e);
#pragma unroll
    for (int c = 0; c < WB_SUB; ++c) kap[c] = quad_sum(kap[c]);
    __syncwarp();                          // sSig: a row's four lanes
    const size_t obase = base + (size_t)c0 * tstride + i;
#pragma unroll
    for (int c = WB_SUB - 1; c >= 0; --c) {
      if (c < nq) {
        const float rc = to_f32(S.r[c][i]), kc = to_f32(S.k[c][i]);
        const float wc = to_f32(S.w[c][i]);
        const float vdy = sA[q][c][c];
        const float dkc = fmaf(rc * ui, vdy, kap[c]);
        float hw = e;                      // G_t . S_{t-1}
#pragma unroll
        for (int s_ = 0; s_ < c; ++s_)
          hw = fmaf(to_f32(S.w[s_][i]), hw, to_f32(S.k[s_][i]) * kap[s_]);
        du_acc = fmaf(rc * kc, vdy, du_acc);
#pragma unroll
        for (int s_ = 0; s_ < c; ++s_)
          kap[s_] = fmaf(wc, kap[s_], rc * sA[q][s_][c]);
        e = fmaf(wc, e, rc * sSig[c][i]);
        if (p == (c & 3)) {
          const size_t off = obase + (size_t)c * tstride;
          if (last) {
            store_as(dk + off, dkc);
            store_as(dw + off, hw);
          } else {
            loc_dk[off] = dkc;
            loc_dw[off] = hw;
          }
        }
      }
    }
    // G over the whole sub-chunk: diag(prod w) G + sum_s P_s r_s dy_s^T
    float acc[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[x] = 0.0f;
    float pr = 1.0f;
    for (int c = 0; c < nq; ++c) {
      const float coef = pr * to_f32(S.r[c][i]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 d = ld4(&S.dy[c][16 * m + 4 * p]);
        acc[4 * m] = fmaf(coef, d.x, acc[4 * m]);
        acc[4 * m + 1] = fmaf(coef, d.y, acc[4 * m + 1]);
        acc[4 * m + 2] = fmaf(coef, d.z, acc[4 * m + 2]);
        acc[4 * m + 3] = fmaf(coef, d.w, acc[4 * m + 3]);
      }
      pr *= to_f32(S.w[c][i]);
    }
#pragma unroll
    for (int x = 0; x < 16; ++x) g[x] = fmaf(pr, g[x], acc[x]);
    __syncthreads();
  }
  // Gloc_start (ds0 itself when there is one chunk)
  store16(g_start + (slot * WB_N + i) * WB_N, g, p);
  if (p == 0) du_part[slot * WB_N + i] = du_acc;
}

template <typename TR, typename TW>
constexpr size_t cols_smem() {
  return 2 * sizeof(Stage<TR, TW>) + sizeof(float) * (WB_N + WB_SUB);
}

// -- phase A, columns: the local dv by Gloc's step recurrence ---------------
template <typename TR, typename TW>
__global__ void __launch_bounds__(WB_THREADS, 3)
wkv6_bwd_cols_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                     const TW* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ dy,
                     const float* __restrict__ dsT, int T, int H,
                     int n_chunks, TR* __restrict__ dv,
                     float* __restrict__ loc_dv) {
  using St = Stage<TR, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  St* st = reinterpret_cast<St*>(smem);
  float* su = reinterpret_cast<float*>(smem + 2 * sizeof(St));
  float* sbonus = su + WB_N;               // sum_i r_t[i] u[i] k_t[i]
  const int bh = blockIdx.x / n_chunks;
  const int ck = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int j = tid >> 2, p = tid & 3;     // column j, rows 16 m + 4 p + e
  const int t0 = ck * WB_C;
  const int len = min(WB_C, T - t0);
  const int nsub = (len + WB_SUB - 1) / WB_SUB;
  const bool last = ck == n_chunks - 1;
  const size_t tstride = (size_t)H * WB_N;
  const size_t base = (((size_t)b * T + t0) * H + h) * WB_N;

  stage(st[(nsub - 1) & 1], r, k, (const TR*)nullptr, w, dy, base, tstride,
        (nsub - 1) * WB_SUB, len, tid);
  if (tid < WB_N) su[tid] = u[(size_t)h * WB_N + tid];
  float g[16];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      g[4 * m + x] =
          last && dsT != nullptr
              ? dsT[((size_t)bh * WB_N + 16 * m + 4 * p + x) * WB_N + j]
              : 0.0f;

  for (int q = nsub - 1; q >= 0; --q) {
    if (q > 0) {
      stage(st[(q - 1) & 1], r, k, (const TR*)nullptr, w, dy, base, tstride,
            (q - 1) * WB_SUB, len, tid);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const St& S = st[q & 1];
    const int c0 = q * WB_SUB;
    const int nq = min(WB_SUB, len - c0);
    if (tid < 4 * WB_SUB) {                // four lanes a step's bonus
      const int c = tid >> 2;
      float acc = 0.0f;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int n = 16 * p + x;
        acc = fmaf(to_f32(S.r[c][n]) * su[n], to_f32(S.k[c][n]), acc);
      }
      acc = quad_sum(acc);
      if (p == 0) sbonus[c] = acc;
    }
    __syncthreads();
    for (int c = nq - 1; c >= 0; --c) {
      const float dyj = S.dy[c][j];
      const float gk = quad_sum(dot16(g, &S.k[c][0], p));
      if (p == (c & 3)) {
        const size_t off = base + (size_t)(c0 + c) * tstride + j;
        const float val = fmaf(sbonus[c], dyj, gk);
        if (last)
          store_as(dv + off, val);
        else
          loc_dv[off] = val;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 ww = ld4(&S.w[c][16 * m + 4 * p]);
        const float4 rr = ld4(&S.r[c][16 * m + 4 * p]);
        g[4 * m] = fmaf(ww.x, g[4 * m], rr.x * dyj);
        g[4 * m + 1] = fmaf(ww.y, g[4 * m + 1], rr.y * dyj);
        g[4 * m + 2] = fmaf(ww.z, g[4 * m + 2], rr.z * dyj);
        g[4 * m + 3] = fmaf(ww.w, g[4 * m + 3], rr.w * dyj);
      }
    }
    __syncthreads();
  }
}

// -- phase B: G carried over chunks, from the last --------------------------
__global__ void __launch_bounds__(WB_B_THREADS)
wkv6_bwd_carry_kernel(const float* __restrict__ decay, float* g_start,
                      float* __restrict__ ds0, int n_chunks) {
  constexpr int kQuads = WB_N * WB_N / 4;         // float4s in one state
  constexpr int kParts = kQuads / WB_B_THREADS;   // blocks per (b, h)
  const int bh = blockIdx.x / kParts;
  const int e = (blockIdx.x - bh * kParts) * WB_B_THREADS + threadIdx.x;
  const int i = e / (WB_N / 4);                   // the row of this float4
  float4* slots = reinterpret_cast<float4*>(g_start) +
                  (size_t)bh * n_chunks * kQuads + e;
  const float* d = decay + (size_t)bh * n_chunks * WB_N + i;

  // G_out[n - 2] = Gloc_start[n - 1] (the last chunk started from dsT);
  // then, from kk = n - 2 down, G_out[kk - 1] = D[kk] G_out[kk] +
  // Gloc_start[kk], written over Gloc_start[kk]; kk = 0 gives ds0
  float4 carry = slots[(size_t)(n_chunks - 1) * kQuads];
  float4 next[WB_PF];
  float dnext[WB_PF];
#pragma unroll
  for (int q = 0; q < WB_PF; ++q) {
    const int kk = n_chunks - 2 - q;
    if (kk >= 0) {
      next[q] = slots[(size_t)kk * kQuads];
      dnext[q] = d[(size_t)kk * WB_N];
    }
  }
  for (int k0 = n_chunks - 2; k0 >= 0; k0 -= WB_PF) {
#pragma unroll
    for (int q = 0; q < WB_PF; ++q) {
      const int kk = k0 - q;
      if (kk >= 0) {
        const float4 loc = next[q];
        const float dk = dnext[q];
        if (kk - WB_PF >= 0) {
          next[q] = slots[(size_t)(kk - WB_PF) * kQuads];
          dnext[q] = d[(size_t)(kk - WB_PF) * WB_N];
        }
        carry.x = fmaf(dk, carry.x, loc.x);
        carry.y = fmaf(dk, carry.y, loc.y);
        carry.z = fmaf(dk, carry.z, loc.z);
        carry.w = fmaf(dk, carry.w, loc.w);
        if (kk > 0)
          slots[(size_t)kk * kQuads] = carry;
        else
          reinterpret_cast<float4*>(ds0)[(size_t)bh * kQuads + e] = carry;
      }
    }
  }
}

constexpr int kCrossPad = WB_N + 1;
constexpr size_t cross_smem() {
  return sizeof(float) * 4 * WB_C * kCrossPad;
}

// -- phase C: each chunk but the last gains G_out's terms; du's sum --------
template <typename TR, typename TW>
__global__ void __launch_bounds__(WB_C_THREADS, 3)
wkv6_bwd_cross_kernel(const TR* __restrict__ k, const TR* __restrict__ v,
                      const TW* __restrict__ w, const float* __restrict__ s0,
                      const float* __restrict__ chk,
                      const float* __restrict__ g_start,
                      const float* __restrict__ du_part,
                      const float* __restrict__ loc_dk,
                      const float* __restrict__ loc_dv,
                      const float* __restrict__ loc_dw, int B, int T, int H,
                      int n_chunks, TR* __restrict__ dk, TR* __restrict__ dv,
                      TW* __restrict__ dw, float* __restrict__ du) {
  const int tid = threadIdx.x;
  const int per_bh = n_chunks - 1;
  const int n_cross = B * H * per_bh;
  if ((int)blockIdx.x >= n_cross) {        // du: the partials in order
    const int h = blockIdx.x - n_cross;
    if (tid < WB_N) {
      float acc = 0.0f;
      for (int bb = 0; bb < B; ++bb)
        for (int kk = 0; kk < n_chunks; ++kk)
          acc += du_part[(((size_t)bb * H + h) * n_chunks + kk) * WB_N + tid];
      du[(size_t)h * WB_N + tid] = acc;
    }
    return;
  }
  extern __shared__ __align__(16) float sm[];
  float(*sG)[kCrossPad] = reinterpret_cast<float(*)[kCrossPad]>(sm);
  float(*sX)[kCrossPad] = sG + WB_N;       // v_t, then X_t
  float(*sQ)[kCrossPad] = sX + WB_C;       // w_t, then Q_t
  float(*sQK)[kCrossPad] = sQ + WB_C;      // k_t, then Q_t k_t, k_t, Y_t
  // (sG holds G_out, then w_t for the Y scan)
  const int bh = blockIdx.x / per_bh;
  const int ck = blockIdx.x - bh * per_bh;
  const int b = bh / H;
  const int h = bh - b * H;
  const int t0 = ck * WB_C;                // never the last chunk: len = C
  const size_t tstride = (size_t)H * WB_N;
  const size_t base = (((size_t)b * T + t0) * H + h) * WB_N;
  // G_out[ck] sits in Gloc_start[ck + 1]'s slot after phase B
  const float* gout = g_start + ((size_t)bh * n_chunks + ck + 1) * WB_N * WB_N;
  __shared__ float sY0[WB_N];
  {
    // G_out, and Y_0[i] = G_out[i] . S_in[i]: four threads a row
    const int i = tid >> 2, p = tid & 3;
    const float* s_in =
        ck == 0 ? s0 + ((size_t)bh * WB_N + i) * WB_N
                : chk + (((size_t)bh * n_chunks + ck - 1) * WB_N + i) * WB_N;
    float y0 = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int x = 16 * p + 4 * m;
      const float4 g4 = ld4(gout + i * WB_N + x), s4 = ld4(s_in + x);
      sG[i][x] = g4.x, sG[i][x + 1] = g4.y, sG[i][x + 2] = g4.z,
      sG[i][x + 3] = g4.w;
      y0 = fmaf(g4.x, s4.x, y0);
      y0 = fmaf(g4.y, s4.y, y0);
      y0 = fmaf(g4.z, s4.z, y0);
      y0 = fmaf(g4.w, s4.w, y0);
    }
    y0 = quad_sum(y0);
    if (p == 0) sY0[i] = y0;
  }
  for (int e = tid; e < WB_C * WB_N; e += WB_C_THREADS) {
    const int c = e / WB_N, x = e - (e / WB_N) * WB_N;
    const size_t off = base + (size_t)c * tstride + x;
    sX[c][x] = to_f32(v[off]);
    sQ[c][x] = to_f32(w[off]);
    sQK[c][x] = to_f32(k[off]);
  }
  __syncthreads();
  if (tid < WB_N) {                        // Q_t[i], from the chunk's end
    float q = 1.0f;
    for (int c = WB_C - 1; c >= 0; --c) {
      const float wc = sQ[c][tid];
      sQ[c][tid] = q;
      sQK[c][tid] *= q;
      q *= wc;
    }
  }
  __syncthreads();
  // X[c][i] = sum_j v_c[j] G[i][j], then dvc[c][j] = sum_i Q_c[i] k_c[i]
  // G[i][j]; a warp takes 8 tx by 4 ty, so each load hits distinct banks
  const int tx = (tid & 7) + 8 * ((tid >> 5) & 1);
  const int ty = ((tid >> 3) & 3) + 4 * (tid >> 6);
  float ax[4][4], av[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m) ax[a][m] = av[a][m] = 0.0f;
#pragma unroll 4
  for (int x = 0; x < WB_N; ++x) {
    float gi[4], vc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      gi[m] = sG[4 * tx + m][x];           // G[i][j = x]
      vc[m] = sX[4 * ty + m][x];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) ax[a][m] = fmaf(vc[a], gi[m], ax[a][m]);
  }
#pragma unroll 4
  for (int x = 0; x < WB_N; ++x) {
    float gj[4], qk[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      gj[m] = sG[x][4 * tx + m];           // G[i = x][j]
      qk[m] = sQK[4 * ty + m][x];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) av[a][m] = fmaf(qk[a], gj[m], av[a][m]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const size_t off = base + (size_t)(4 * ty + a) * tstride + 4 * tx + m;
      store_as(dv + off, loc_dv[off] + av[a][m]);
    }
  __syncthreads();                         // sG, sX and sQK are read
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m) sX[4 * ty + a][4 * tx + m] = ax[a][m];
  for (int e = tid; e < WB_C * WB_N; e += WB_C_THREADS) {   // w_t, k_t
    const int c = e / WB_N, x = e - (e / WB_N) * WB_N;
    const size_t off = base + (size_t)c * tstride + x;
    sG[c][x] = to_f32(w[off]);
    sQK[c][x] = to_f32(k[off]);
  }
  __syncthreads();
  if (tid < WB_N) {                        // Y_t[i] over k_t's slots
    float y = sY0[tid];
    for (int c = 0; c < WB_C; ++c) {
      const float kc = sQK[c][tid];
      sQK[c][tid] = y;
      y = fmaf(sG[c][tid], y, kc * sX[c][tid]);
    }
  }
  __syncthreads();
  for (int e = tid; e < WB_C * WB_N; e += WB_C_THREADS) {
    const int c = e / WB_N, x = e - (e / WB_N) * WB_N;
    const size_t off = base + (size_t)c * tstride + x;
    const float q = sQ[c][x];
    store_as(dk + off, fmaf(q, sX[c][x], loc_dk[off]));
    store_as(dw + off, fmaf(q, sQK[c][x], loc_dw[off]));
  }
}

// the kernel's dynamic shared memory limit, set once a device (`done`:
// the kernel's own flags)
template <typename K>
static int set_smem(K kernel, size_t bytes, bool (&done)[WB_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < WB_DEVICES && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < WB_DEVICES) done[dev] = true;
  return (int)err;
}

template <typename TR, typename TW>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* chk,
                  const void* dy, const void* dsT, int B, int T, int H,
                  void* dr, void* dk, void* dv, void* dw, void* du,
                  void* ds0, void* scratch, cudaStream_t stream) {
  static bool rows_done[WB_DEVICES], cross_done[WB_DEVICES];
  const int n = T <= WB_C ? 1 : (T + WB_C - 1) / WB_C;
  const size_t bhn = (size_t)B * H * n;
  const size_t elems = (size_t)B * T * H * WB_N;
  // scratch (kernels/wkv6.py: bwd_scratch_parts): S_b, du's partials,
  // then past one chunk Gloc_start / G_out and A's fp32 dk, dv, dw
  float* sub_s = (float*)scratch;
  float* du_part = sub_s + bhn * (WB_SUBS - 1) * WB_N * WB_N;
  float* g_start = n == 1 ? (float*)ds0 : du_part + bhn * WB_N;
  float* loc = n == 1 ? nullptr : g_start + bhn * WB_N * WB_N;
  float* loc_dk = loc;
  float* loc_dv = n == 1 ? nullptr : loc + elems;
  float* loc_dw = n == 1 ? nullptr : loc + 2 * elems;

  int rc = set_smem(wkv6_bwd_rows_kernel<TR, TW>, rows_smem<TR, TW>(),
                    rows_done);
  if (rc != 0) return rc;
  wkv6_bwd_rows_kernel<TR, TW><<<(unsigned)bhn, WB_THREADS,
                                 rows_smem<TR, TW>(), stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w,
      (const float*)u, (const float*)s0, (const float*)chk,
      (const float*)dy, (const float*)dsT, T, H, n, (TR*)dr, (TR*)dk,
      (TW*)dw, loc_dk, loc_dw, sub_s, du_part, g_start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_cols_kernel<TR, TW><<<(unsigned)bhn, WB_THREADS,
                                 cols_smem<TR, TW>(), stream>>>(
      (const TR*)r, (const TR*)k, (const TW*)w, (const float*)u,
      (const float*)dy, (const float*)dsT, T, H, n, (TR*)dv, loc_dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 1) {
    const float* decay = (const float*)chk + bhn * WB_N * WB_N;
    wkv6_bwd_carry_kernel<<<(unsigned)((size_t)B * H *
                                       (WB_N * WB_N / 4 / WB_B_THREADS)),
                            WB_B_THREADS, 0, stream>>>(
        decay, g_start, (float*)ds0, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rc = set_smem(wkv6_bwd_cross_kernel<TR, TW>, cross_smem(), cross_done);
  if (rc != 0) return rc;
  wkv6_bwd_cross_kernel<TR, TW><<<(unsigned)((size_t)B * H * (n - 1) + H),
                                  WB_C_THREADS, cross_smem(), stream>>>(
      (const TR*)k, (const TR*)v, (const TW*)w, (const float*)s0,
      (const float*)chk, g_start, du_part, loc_dk, loc_dv, loc_dw, B, T, H,
      n, (TR*)dk, (TR*)dv, (TW*)dw, (float*)du);
  return (int)cudaGetLastError();
}

// rkv_bf16 / w_bf16: 1 if r, k, v (resp. w) are bf16, 0 if fp32; the
// gradients dr, dk, dv take r's type, dw w's.  chk: the forward's scratch
// when T > 64 (may be null when T <= 64); dsT may be null.  r, k, v, w and
// dy 16-byte aligned.  scratch: the sum of kernels/wkv6.py::
// bwd_scratch_parts(B, T, H), in floats.  T >= 1.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* chk, const void* dy,
                               const void* dsT, int B, int T, int H,
                               int rkv_bf16, int w_bf16, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0,
                               void* scratch, void* stream) {
  const long long n = T <= WB_C ? 1 : (T + WB_C - 1) / WB_C;
  const bool aligned = ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)w | (uintptr_t)dy) % 16 == 0;
  if (B <= 0 || H <= 0 || T <= 0 || (long long)B * H * n > INT_MAX ||
      !aligned || (T > WB_C && chk == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rkv_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        r, k, v, w, u, s0, chk, dy, dsT, B, T, H, dr, dk, dv, dw, du, ds0,
        scratch, st);
  if (rkv_bf16)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, chk, dy, dsT, B,
                                        T, H, dr, dk, dv, dw, du, ds0,
                                        scratch, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(r, k, v, w, u, s0, chk, dy, dsT, B,
                                        T, H, dr, dk, dv, dw, du, ds0,
                                        scratch, st);
  return launch<float, float>(r, k, v, w, u, s0, chk, dy, dsT, B, T, H, dr,
                              dk, dv, dw, du, ds0, scratch, st);
}
