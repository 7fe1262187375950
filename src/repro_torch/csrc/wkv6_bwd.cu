// The RWKV-6 WKV recurrence's backward for Hopper: a reverse sweep over
// time chunks, parallel over (b, h, group of 8 state rows).
//
// Replaces no Pallas kernel: the reference trains through the autodiff of
// its jnp recurrence (repro/kernels/ops.py:33-47 sends wkv6 to
// repro/models/rwkv6.py::wkv6_chunked); this is the VJP of the forward
// that csrc/wkv6.cu computes (kernels/ref.py::wkv6_ref).
//
// Input: r, k, v, w (B, T, H, N) with N = 64 as the forward took them
// (r, k and v one type, fp32 or bf16; w fp32 or bf16); u (H, N) fp32; s0
// (B, H, N, N) fp32; the forward's chunk states (its scratch after phase
// B: slot m of each (b, h) holds the state at the start of chunk m + 1);
// dy (B, T, H, N) fp32; dsT (B, H, N, N) fp32 or null (zeros).  With dS
// the gradient of the state after step t, per step from the last:
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j dS[i][j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i dS[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j dS[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   dS[i][j] <- w_t[i] dS[i][j] + r_t[i] dy_t[j]
// Output: dr, dk, dv in r's type, dw in w's, du (H, N) and ds0 (B, H, N, N)
// fp32.
//
// Bound on the H100: ~12 fp32 operations per (b, t, h, i, j) (the state
// rebuilt, dr, dk, dv, dw, dS), so the fp32 rate bounds it (B = 1, T =
// 1024, H = 40: 0.030 ms); the function's bytes take 0.019 ms.
//
// The hard part is dw, which needs the forward's state and the backward's
// at the same step.  S is never rebuilt backward by dividing by w (a decay
// may be exactly 0, or 1e-31).  The forward already keeps the state at
// each 64-step chunk boundary; each chunk, from the last, is first walked
// forward from its boundary, its 64 states staged in shared memory, then
// walked backward against them.
//
// Rows of S evolve independently (S[i][:] <- w[i] S[i][:] + k[i] v), and
// so do rows of dS, so a block takes WB_ROWS = 8 rows of one (b, h): 320
// blocks at B = 1, H = 40 instead of the 40 that one block per (b, h)
// would give 132 SMs.  Warp q holds row q of the group, lane l columns l
// and l + 32 of S and of dS in registers; a chunk's states take 64 x 8 x
// 64 floats (128 KB) of shared memory, so an SM holds one block.  dr, dk
// and dw are sums over j: a butterfly over the warp's 32 lanes (a fixed
// order; every lane gets the same bits).  dv sums over i, across the row
// groups: each step's dS[i][j] k_t[i] overwrites the state it no longer
// needs, the block sums its 8 rows in order after the chunk, and a second
// kernel (wkv6_bwd_sum_kernel) adds the 8 groups' partials in order, the
// bonus term (summed over all 64 rows there) and du's B partials.  No
// atomics: the results repeat bit for bit.  The public RWKV-LM backward
// (wkv6_cuda.cu) splits the work differently and was not followed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define WB_N 64
#define WB_C 64              // steps per chunk (kernels/wkv6.py: CHUNK)
#define WB_ROWS 8            // state rows a block takes (one per warp)
#define WB_GROUPS (WB_N / WB_ROWS)
#define WB_THREADS (WB_ROWS * 32)
#define WB_SUM_THREADS 256

static_assert(WB_N == 64, "a lane holds columns l and l + 32");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the sum over the warp's 32 lanes, a fixed butterfly: every lane ends
// with the same bits (each pairwise add is commutative)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Stage {
  float v[WB_C][WB_N];     // the chunk's v_t and dy_t, every column
  float dy[WB_C][WB_N];
  float r[WB_C][WB_ROWS];  // r_t, k_t, w_t of the group's rows
  float k[WB_C][WB_ROWS];
  float w[WB_C][WB_ROWS];
  float dr[WB_C][WB_ROWS];  // the chunk's dr, dk, dw, written after it
  float dk[WB_C][WB_ROWS];
  float dw[WB_C][WB_ROWS];
  float vdy[WB_C];          // v_t . dy_t
};
// the chunk's states S_{t-1} [step][row][column], then dS k_t in place
constexpr size_t kSlabFloats = (size_t)WB_C * WB_ROWS * WB_N;
constexpr size_t kSmemBytes = kSlabFloats * 4 + sizeof(Stage);

template <typename TR, typename TW>
__global__ void __launch_bounds__(WB_THREADS, 1)
wkv6_bwd_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                const TR* __restrict__ v, const TW* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ chk, const float* __restrict__ dy,
                const float* __restrict__ dsT, int B, int T, int H,
                int n_chunks, TR* __restrict__ dr, TR* __restrict__ dk,
                TW* __restrict__ dw, float* __restrict__ dv_part,
                float* __restrict__ du_part, float* __restrict__ ds0) {
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;
  Stage& st = *reinterpret_cast<Stage*>(smem + kSlabFloats);
  const int grp = blockIdx.x % WB_GROUPS;
  const int bh = blockIdx.x / WB_GROUPS;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int q = tid / 32;                  // the warp's row in the group
  const int lane = tid % 32;
  const int i = grp * WB_ROWS + q;         // its row of S
  const float ui = u[(size_t)h * WB_N + i];
  const size_t row = ((size_t)bh * WB_N + i) * WB_N;  // (b, h, i, :)

  float ds_a = dsT ? dsT[row + lane] : 0.0f;
  float ds_b = dsT ? dsT[row + lane + 32] : 0.0f;
  float du_acc = 0.0f;
  const size_t tstride = (size_t)H * WB_N;
  const size_t base = ((size_t)b * T * H + h) * WB_N;   // (b, 0, h, 0)

  for (int ck = n_chunks - 1; ck >= 0; --ck) {
    const int t0 = ck * WB_C;
    const int len = min(WB_C, T - t0);
    const float* src =
        ck == 0 ? s0 + row
                : chk + (((size_t)bh * n_chunks + ck - 1) * WB_N + i) * WB_N;
    float s_a = src[lane], s_b = src[lane + 32];
    __syncthreads();   // the previous chunk's stage and slab are consumed
    for (int e = tid; e < WB_C * WB_N; e += WB_THREADS) {
      const int c = e / WB_N, j = e - (e / WB_N) * WB_N;
      const size_t off = base + (size_t)(t0 + c) * tstride + j;
      st.v[c][j] = c < len ? load_f32(v + off) : 0.0f;
      st.dy[c][j] = c < len ? dy[off] : 0.0f;
    }
    for (int e = tid; e < WB_C * WB_ROWS; e += WB_THREADS) {
      const int c = e / WB_ROWS, m = e - (e / WB_ROWS) * WB_ROWS;
      const size_t off =
          base + (size_t)(t0 + c) * tstride + grp * WB_ROWS + m;
      st.r[c][m] = c < len ? load_f32(r + off) : 0.0f;
      st.k[c][m] = c < len ? load_f32(k + off) : 0.0f;
      st.w[c][m] = c < len ? load_f32(w + off) : 0.0f;
    }
    __syncthreads();

    // forward over the chunk from its boundary: stage S_{t-1}, and dr_t
    // while it is at hand
    for (int c = 0; c < len; ++c) {
      float* sl = slab + ((size_t)c * WB_ROWS + q) * WB_N;
      sl[lane] = s_a;
      sl[lane + 32] = s_b;
      const float va = st.v[c][lane], vb = st.v[c][lane + 32];
      const float ya = st.dy[c][lane], yb = st.dy[c][lane + 32];
      const float vdy = warp_sum(fmaf(va, ya, vb * yb));
      const float sdy = warp_sum(fmaf(s_a, ya, s_b * yb));
      const float kc = st.k[c][q], wc = st.w[c][q];
      if (lane == 0) {
        st.dr[c][q] = fmaf(ui * kc, vdy, sdy);
        if (q == 0) st.vdy[c] = vdy;
      }
      s_a = fmaf(wc, s_a, kc * va);
      s_b = fmaf(wc, s_b, kc * vb);
    }
    __syncthreads();   // st.vdy

    // backward over the chunk
    for (int c = len - 1; c >= 0; --c) {
      float* sl = slab + ((size_t)c * WB_ROWS + q) * WB_N;
      const float va = st.v[c][lane], vb = st.v[c][lane + 32];
      const float ya = st.dy[c][lane], yb = st.dy[c][lane + 32];
      const float rc = st.r[c][q], kc = st.k[c][q], wc = st.w[c][q];
      const float vdy = st.vdy[c];
      const float pa = sl[lane], pb = sl[lane + 32];      // S_{t-1}
      const float dkv = warp_sum(fmaf(ds_a, va, ds_b * vb));
      const float dwv = warp_sum(fmaf(ds_a, pa, ds_b * pb));
      sl[lane] = ds_a * kc;                               // dv's part
      sl[lane + 32] = ds_b * kc;
      if (lane == 0) {
        st.dk[c][q] = fmaf(rc * ui, vdy, dkv);
        st.dw[c][q] = dwv;
      }
      du_acc = fmaf(rc * kc, vdy, du_acc);
      ds_a = fmaf(wc, ds_a, rc * ya);
      ds_b = fmaf(wc, ds_b, rc * yb);
    }
    __syncthreads();

    // the chunk's dv partial (the group's 8 rows in order) and its dr, dk,
    // dw
    const size_t pbase =
        ((size_t)(grp * B + b) * T * H + h) * WB_N;       // (g, b, 0, h, 0)
    for (int e = tid; e < len * WB_N; e += WB_THREADS) {
      const int c = e / WB_N, j = e - (e / WB_N) * WB_N;
      const float* col = slab + (size_t)c * WB_ROWS * WB_N + j;
      float acc = col[0];
#pragma unroll
      for (int m = 1; m < WB_ROWS; ++m) acc += col[m * WB_N];
      dv_part[pbase + (size_t)(t0 + c) * tstride + j] = acc;
    }
    for (int e = tid; e < len * WB_ROWS; e += WB_THREADS) {
      const int c = e / WB_ROWS, m = e - (e / WB_ROWS) * WB_ROWS;
      const size_t off =
          base + (size_t)(t0 + c) * tstride + grp * WB_ROWS + m;
      store_as(dr + off, st.dr[c][m]);
      store_as(dk + off, st.dk[c][m]);
      store_as(dw + off, st.dw[c][m]);
    }
  }
  ds0[row + lane] = ds_a;
  ds0[row + lane + 32] = ds_b;
  if (lane == 0) du_part[(size_t)bh * WB_N + i] = du_acc;
}

// dv = the row groups' partials in order + the bonus term, one warp per
// (b, t, h); past those warps, du = the B partials in order, one warp per h
template <typename TR>
__global__ void __launch_bounds__(WB_SUM_THREADS)
wkv6_bwd_sum_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ dv_part,
                    const float* __restrict__ du_part, int B, int T, int H,
                    TR* __restrict__ dv, float* __restrict__ du) {
  const long long wid =
      ((long long)blockIdx.x * WB_SUM_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)B * T * H;
  if (wid < rows) {
    const int h = (int)(wid % H);
    const size_t off = (size_t)wid * WB_N;
    const float* uh = u + (size_t)h * WB_N;
    const float bonus = warp_sum(
        fmaf(load_f32(r + off + lane) * uh[lane], load_f32(k + off + lane),
             load_f32(r + off + lane + 32) * uh[lane + 32] *
                 load_f32(k + off + lane + 32)));
    const size_t gstride = (size_t)rows * WB_N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t e = off + lane + half * 32;
      float acc = dv_part[e];
#pragma unroll
      for (int g = 1; g < WB_GROUPS; ++g) acc += dv_part[g * gstride + e];
      store_as(dv + e, fmaf(bonus, dy[e], acc));
    }
  } else if (wid < rows + H) {
    const int h = (int)(wid - rows);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = lane + half * 32;
      float acc = du_part[(size_t)h * WB_N + n];
      for (int bb = 1; bb < B; ++bb)
        acc += du_part[((size_t)bb * H + h) * WB_N + n];
      du[(size_t)h * WB_N + n] = acc;
    }
  }
}

template <typename TR, typename TW>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* chk,
                  const void* dy, const void* dsT, int B, int T, int H,
                  void* dr, void* dk, void* dv, void* dw, void* du,
                  void* ds0, void* scratch, cudaStream_t stream) {
  const int n_chunks = T <= WB_C ? 1 : (T + WB_C - 1) / WB_C;
  float* dv_part = (float*)scratch;
  float* du_part = dv_part + (size_t)WB_GROUPS * B * T * H * WB_N;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<TR, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<TR, TW><<<B * H * WB_GROUPS, WB_THREADS, kSmemBytes,
                            stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w,
      (const float*)u, (const float*)s0, (const float*)chk,
      (const float*)dy, (const float*)dsT, B, T, H, n_chunks, (TR*)dr,
      (TR*)dk, (TW*)dw, dv_part, du_part, (float*)ds0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)B * T * H + H;
  const long long blocks = (warps * 32 + WB_SUM_THREADS - 1) / WB_SUM_THREADS;
  wkv6_bwd_sum_kernel<TR><<<(unsigned)blocks, WB_SUM_THREADS, 0, stream>>>(
      (const TR*)r, (const TR*)k, (const float*)u, (const float*)dy, dv_part,
      du_part, B, T, H, (TR*)dv, (float*)du);
  return (int)cudaGetLastError();
}

// rkv_bf16 / w_bf16: 1 if r, k, v (resp. w) are bf16, 0 if fp32; the
// gradients dr, dk, dv take r's type, dw w's.  chk: the forward's scratch
// when T > 64 (may be null when T <= 64); dsT may be null.  scratch:
// 8 * B * T * H * 64 + B * H * 64 floats.  T >= 1.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* chk, const void* dy,
                               const void* dsT, int B, int T, int H,
                               int rkv_bf16, int w_bf16, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0,
                               void* scratch, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 ||
      (long long)B * H * WB_GROUPS > INT_MAX ||
      ((long long)B * T * H + H) * 32 / WB_SUM_THREADS + 1 > INT_MAX ||
      (T > WB_C && chk == nullptr) || scratch == nullptr)
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
