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
// and delta (B, Hq, Sq) fp32 (D above, scratch).  No atomics and every
// sum in a fixed order: results repeat bit for bit.  Tiles that the mask
// drops for every pair are skipped (fa_tile_kept).
//
// Bound on the H100: 10 Dh operations per kept (q, kv) pair and q head
// (the products S, dP, dV, dQ, dK) against reading q, k, v, o, dO and lse
// and writing dq, dk and dv once; the design recomputes S and dP in the
// dQ pass (14 Dh).  At gemma-2b's training shape (S = 1024, 8 q heads
// over one kv head of 256) the operations bound it.
//
// bf16 (the *_tc kernels): bf16 operands and fp32 accumulators on the
// tensor cores through wgmma, 64-row tiles.  Every tile sits in shared
// memory as the forward keeps K and V (128-byte swizzled slabs of 64
// columns, hopper_mma.cuh).  The tiles a block walks (K and V in the dQ
// kernel; Q and dO in the dK/dV kernel) come through a 2-stage ring that
// one thread fills by TMA (a tensor map a tensor, an mbarrier a stage);
// the rest by cp.async.  Every product reads its operands where they
// lie: an operand that runs along the other axis (K for dQ += dS K; Q
// and dO for dK += dS^T Q and dV += P^T dO) through the descriptor's
// MN-major mode, so nothing is copied transposed.  P is rounded to bf16
// for P^T dO, as the forward rounds it for P V; dS is rounded to bf16
// for dQ and dK.
//
// Both kernels run their products on NWG warpgroups (2 at Dh 128 and 256,
// else 1): each computes NP = 64 / NWG of the 64 columns of S and dP
// (once a tile), writes its columns of the bf16 operand of the next
// products (dS; P^T and dS^T) into a shared-memory A tile (K-major) and,
// after a barrier, multiplies the whole tile into its Dh / NWG of the
// output's columns (ss, B MN-major): at Dh = 256 64 + 64 accumulators a
// thread in the dK/dV kernel, 64 in the dQ kernel.
// - fa_bwd_dq_tc, one block per 64 (position, q head) rows of one kv
//   head's group (position-major, as the forward's tile; its heads share
//   the K and V tiles), the longest rows first over every (batch, kv
//   head): writes its rows' D, then walks the kept kv tiles in order:
//   S = Q K^T and dP = dO V^T, dS, dQ += dS K.
// - fa_bwd_dkdv_tc, one block per (kv tile, q-tile run, head share) of a
//   (batch, kv head), the plan's order (FaBwd; the longest first): it
//   walks its run's kept q tiles in order and, inside each, its share of
//   the group's q heads in order: S^T = K Q^T and dP^T = V dO^T, P^T and
//   dS^T, dV += P^T dO and dK += dS^T Q.  A block alone on its kv tile
//   writes dk and dv.
// - fa_bwd_sum: where the plan splits a kv tile (MQA: gemma-2b's one kv
//   head would give 16 blocks at a batch of 1), each block writes its
//   fp32 dK and dV partial to a scratch slot and this pass adds a tile's
//   slots in order (runs, then shares) and rounds once.

// fp32 (the *_f32 kernels): CUDA cores, 256 threads, 32 x 32 score tiles
// in shared memory (each thread a 2 x 2 block of S and dP, float4 reads
// along Dh), the output rows of a block 32, each thread Dh / 8 columns of
// one row; all in fp32 (the fp32 checks' tolerance, 1e-5, leaves no room
// for TF32).  Two launches: the dQ kernel (a block per (q tile, q head,
// batch), writing D first), then the dK/dV kernel (a block per (kv tile,
// kv head, batch) carrying the group).
#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper_mma.cuh"

#define FB_LOG2E 1.4426950408889634f
#define FB_NEG_INF (-1e30f)       // the forward's dropped score

typedef __nv_bfloat16 bf16;

// ---- bf16 on the tensor cores ----------------------------------------------
#define TB_ROWS 64                // rows of a q or kv tile (a wgmma's M)
#define TB_SLAB (TB_ROWS * 128)   // bytes of a tile's 64-column slab
#define TB_HEAD_SPLITS 8          // the most splits of a group's q heads

template <int D>
struct TcShape {
  static constexpr int NSL = D / 64;                 // slabs of a tile
  static constexpr uint32_t TILE = NSL * TB_SLAB;    // bytes of a tile
  // warpgroups of a block; each owns WSL slabs of the output's columns
  // (dQ; dK and dV) and NP of the 64 columns of S and dP (dQ: kv; dK/dV:
  // q, of S^T and dP^T)
  static constexpr int NWG = D >= 128 ? 2 : 1;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int WSL = NSL / NWG;
  static constexpr int NP = 64 / NWG;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// 4 bytes global -> shared; zero-filled when !valid (src not read)
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// (ordered before the fence and barrier that publish it: all three are
// volatile asm)
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x));
}

// The ring's barriers: one mbarrier a stage, one arrival a phase (the
// thread that issues the stage's copies, with their bytes)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 64-row tile of head h at row `row` of batch b of a (B, S, H, D) bf16
// tensor, by TMA: one 64 x 64 box a slab, 128-byte swizzled as
// hopper_mma.cuh lays tiles out, rows past S zero-filled; its bytes
// complete on `bar`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row,
                                         int b) {
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + n * TB_SLAB),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(64 * n), "r"(h),
        "r"(row), "r"(b)
        : "memory");
}

// S and dP (S^T and dP^T) over a warpgroup's NP columns: m64n64 or
// m64n32
__device__ __forceinline__ void mma_np(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  wgmma_bf16_ss_n64(d, da, db, accumulate);
}
__device__ __forceinline__ void mma_np(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  wgmma_bf16_ss_n32(d, da, db, accumulate);
}

// TB_ROWS rows of D bf16 into D / 64 swizzled slabs of TB_SLAB bytes; row
// r's source is src_row(r), or zeros when it returns nullptr (the copy
// then reads nothing; `any` stands in as its address)
template <int D, int THREADS, typename F>
__device__ __forceinline__ void tile_load(uint32_t dst, const bf16* any,
                                          F src_row) {
  constexpr int CH = D / 8;                    // 16-byte chunks a row
  for (int e = threadIdx.x; e < TB_ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const bf16* row = src_row(r);
    cp_async16(dst + (c >> 3) * TB_SLAB + swz(r, c & 7),
               row != nullptr ? row + c * 8 : any, row != nullptr);
  }
}

__host__ __device__ __forceinline__ int fb_min(int a, int b) {
  return a < b ? a : b;
}

// A launch's shapes, mask and plan.  The plan (bwd_plan in
// kernels/flash_attention.py, whose helpers mirror these) cuts the dK/dV
// work of kv tile j, its q tiles [0, nqt), into kv_nr runs over the
// causally kept [j, nqt) (the first also takes [0, j)), the same count
// for every tile so that a block finds its work in O(1), and each run's
// q heads into hsplit equal shares; a (batch, kv head)'s blocks are (j,
// run, share) in that order (the longest first).  Where a tile has more
// than one block, each writes an fp32 partial to its slot (its number)
// and fa_bwd_sum adds a tile's slots in order; a short tile's empty runs
// write zeros.  dQ is not split: a block a row tile.
struct FaBwd {
  int B, Sq, Skv, Hq, Hkv, G;
  int nqt, nkt, ntile;            // q tiles, kv tiles, dQ row tiles
  int causal, window, prefix_len;
  int hsplit, kv_nr;
  float scale;
};

// the first tile of run r of nr over a kept range [lo, lo + len) of [0,
// n): 0 for the first run, n past the last
__host__ __device__ __forceinline__ int fa_cut(int lo, int len, int nr,
                                               int r, int n) {
  if (r == 0) return 0;
  if (r == nr) return n;
  return fb_min(n, lo + (r * len + nr - 1) / nr);
}

template <int D>
constexpr size_t dq_tc_smem() {
  // Q and dO, then 2 stages of K and V (64 x D tiles); dS (64 x 64); the
  // rows' lse and D; their offsets in q and in lse; the stages'
  // barriers; 1024 bytes of slack for the swizzle's alignment
  return (size_t)6 * TcShape<D>::TILE + TB_SLAB + 2 * TB_ROWS * 4 +
         2 * TB_ROWS * 8 + 16 + 1024;
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, 1)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ o,
             const float* __restrict__ lse, const bf16* __restrict__ dO,
             bf16* __restrict__ dq, float* __restrict__ delta, const FaBwd f,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v) {
  using T = TcShape<D>;
  constexpr int WSL = T::WSL, NP = T::NP, TH = T::THREADS;
  constexpr uint32_t TILE = T::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t qs = raw + pad, dos = qs + TILE;
  const uint32_t kv0 = dos + TILE;     // stage s: K at kv0 + 2 s TILE, V after
  const uint32_t dss = kv0 + 4 * TILE;
  float* lse_s = reinterpret_cast<float*>(smem_raw + pad + 6 * TILE +
                                          TB_SLAB);  // the log2 domain
  float* dl_s = lse_s + TB_ROWS;
  size_t* row_q = reinterpret_cast<size_t*>(dl_s + TB_ROWS);
  size_t* row_l = row_q + TB_ROWS;
  const uint32_t bars = smem_u32(row_l + TB_ROWS);   // a stage's: bars + 8 s

  const int Sq = f.Sq, Skv = f.Skv, Hq = f.Hq, G = f.G, nkt = f.nkt;
  const int causal = f.causal, window = f.window, prefix_len = f.prefix_len;
  const int rows_total = Sq * G;       // (position, head) pairs
  // this block's row tile, the longest first (causal: the last tile
  // keeps every kv tile), across every (batch, kv head)
  const int nbh = f.B * f.Hkv;
  const int bh = (int)(blockIdx.x % nbh), b = bh / f.Hkv, hk = bh % f.Hkv;
  const int f0 = (f.ntile - 1 - (int)(blockIdx.x / nbh)) * TB_ROWS;
  const int pos_lo = f0 / G, pos_hi = fb_min(Sq - 1, (f0 + TB_ROWS - 1) / G);

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const size_t q_stride = (size_t)Hq * D;
  // each row's offset in q (position r / G, head r % G of the group) and
  // in lse; the ring's barriers
  if (tid < TB_ROWS) {
    const int r = f0 + tid, pos = r / G, h = hk * G + r % G;
    row_q[tid] = ((size_t)b * Sq + pos) * q_stride + (size_t)h * D;
    row_l[tid] = ((size_t)b * Hq + h) * Sq + pos;
  }
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    mbar_init_fence();
  }
  __syncthreads();

  auto next_kept = [&](int kt) {
    while (kt < nkt &&
           !fa_tile_kept(pos_lo, pos_hi + 1, kt * TB_ROWS,
                         fb_min(kt * TB_ROWS + TB_ROWS, Skv), causal, window,
                         prefix_len))
      ++kt;
    return kt;
  };
  // K and V of kv tile kt into a stage, by one thread
  auto load_kv = [&](int kt, int stage) {
    if (tid != 0) return;
    const uint32_t ks = kv0 + 2 * stage * TILE, bar = bars + 8 * stage;
    mbar_expect(bar, 2 * TILE);
    tma_tile<D>(ks, &tm_k, bar, hk, kt * TB_ROWS, b);
    tma_tile<D>(ks + TILE, &tm_v, bar, hk, kt * TB_ROWS, b);
  };

  // Q, dO and the first kept kv tile
  tile_load<D, TH>(qs, q, [&](int r) -> const bf16* {
    return f0 + r < rows_total ? q + row_q[r] : nullptr;
  });
  tile_load<D, TH>(dos, dO, [&](int r) -> const bf16* {
    return f0 + r < rows_total ? dO + row_q[r] : nullptr;
  });
  int kt = next_kept(0);
  if (kt < nkt) load_kv(kt, 0);
  cp_async_commit();

  // D = rowsum(dO * O) in fp32 while the copies fly: a row's 16-byte
  // chunks on CH neighbouring lanes, each 8 products in order, then a
  // butterfly over the CH lanes; every load of the warp's rows issued
  // before the first sum
  {
    constexpr int CH = D / 8, RPP = 32 / CH;   // rows a warp a pass
    constexpr int PASSES = TB_ROWS / (TH / 32) / RPP;
    const int sub = lane / CH, c = lane % CH;
    uint4 xs[PASSES], ys[PASSES];
    float ls[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int rr = ((tid >> 5) * PASSES + i) * RPP + sub;
      xs[i] = ys[i] = make_uint4(0u, 0u, 0u, 0u);
      ls[i] = 0.0f;
      if (f0 + rr < rows_total) {
        const size_t off = row_q[rr] + 8 * c;
        xs[i] = *reinterpret_cast<const uint4*>(dO + off);
        ys[i] = *reinterpret_cast<const uint4*>(o + off);
        if (c == 0) ls[i] = lse[row_l[rr]];
      }
    }
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int rr = ((tid >> 5) * PASSES + i) * RPP + sub;
      const uint32_t xw[4] = {xs[i].x, xs[i].y, xs[i].z, xs[i].w};
      const uint32_t yw[4] = {ys[i].x, ys[i].y, ys[i].z, ys[i].w};
      float acc = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack2(xw[e]), bb = unpack2(yw[e]);
        acc = fmaf(a.x, bb.x, acc);
        acc = fmaf(a.y, bb.y, acc);
      }
#pragma unroll
      for (int off = CH / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (c == 0) {
        dl_s[rr] = acc;
        lse_s[rr] = ls[i] * FB_LOG2E;
        if (f0 + rr < rows_total) delta[row_l[rr]] = acc;
      }
    }
  }

  // this thread's rows of the 64: ra = 16 wi + g4 and rb = ra + 8
  const int ra = wi * 16 + g4, rb = ra + 8;
  const int qpa = (f0 + ra) / G, qpb = (f0 + rb) / G;
  const float sl2 = f.scale * FB_LOG2E;
  float acc[WSL][32];
#pragma unroll
  for (int n = 0; n < WSL; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.0f;

  int stage = 0;
  for (int t = 0; kt < nkt; ++t) {
    const int nxt = next_kept(kt + 1);
    cp_async_wait<0>();        // this thread's copies of Q and dO landed
    mbar_wait(bars + 8 * stage, (t >> 1) & 1);   // tile kt landed
    fence_proxy_async();
    __syncthreads();           // Q and dO everyone's; tile kt-1 consumed
    if (nxt < nkt) load_kv(nxt, stage ^ 1);
    cp_async_commit();

    const uint32_t ks = kv0 + 2 * stage * TILE, vs = ks + TILE;
    const int k0 = kt * TB_ROWS;

    // S = Q K^T and dP = dO V^T over this warpgroup's NP kv columns (two
    // chains of products interleaved)
    float s[NP / 2], dp[NP / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * TB_SLAB + (kk & 3) * 32;
      const uint32_t cols = off + wg * NP * 128;
      mma_np(s, desc_kmajor(qs + off), desc_kmajor(ks + cols), kk > 0);
      mma_np(dp, desc_kmajor(dos + off), desc_kmajor(vs + cols), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P, then dS = P (dP - D) in fp32, into shared memory in bf16 (a
    // K-major A tile: q rows, kv columns along the row); the mask where
    // the tile is not kept whole
    bool whole = f0 + TB_ROWS <= rows_total && k0 + TB_ROWS <= Skv;
    if (causal)
      whole = whole &&
              ((k0 + TB_ROWS - 1 <= pos_lo &&
                (window == 0 || pos_hi - k0 < window)) ||
               (prefix_len > 0 && k0 + TB_ROWS <= prefix_len));
    if (!whole)                // a dropped pair's P is exp2(-1e30) = 0
#pragma unroll
      for (int i = 0; i < NP / 2; ++i)
        if (!fa_kept(i & 2 ? qpb : qpa, k0 + wg * NP + 8 * (i >> 2) +
                                            2 * t4 + (i & 1),
                     Sq, Skv, causal, window, prefix_len))
          s[i] = FB_NEG_INF;
    const float la = lse_s[ra], lb = lse_s[rb];
    const float da = dl_s[ra], db = dl_s[rb];
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj) {
      const int c = wg * NP + 8 * jj + 2 * t4;    // kv columns c, c + 1
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsv[e] = exp2f(s[4 * jj + e] * sl2 - (e < 2 ? la : lb)) *
                 (dp[4 * jj + e] - (e < 2 ? da : db));
      st_shared_u32(dss + swz(ra, c >> 3) + 4 * t4, pack2(dsv[0], dsv[1]));
      st_shared_u32(dss + swz(rb, c >> 3) + 4 * t4, pack2(dsv[2], dsv[3]));
    }
    fence_proxy_async();       // the writes, visible to wgmma
    __syncthreads();           // every warpgroup's columns of dS written

    // dQ += dS K over this warpgroup's slabs
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t sdesc = desc_kmajor(dss + kk * 32);
#pragma unroll
      for (int n = 0; n < WSL; ++n)
        wgmma_bf16_ss_n64_tb(
            acc[n], sdesc,
            desc_mnmajor(ks + (wg * WSL + n) * TB_SLAB + kk * 2048));
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < WSL; ++n) fence_regs(acc[n]);
    kt = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (f0 + r >= rows_total) continue;
    bf16* dst = dq + row_q[r] + wg * WSL * 64 + 2 * t4;
#pragma unroll
    for (int n = 0; n < WSL; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + n * 64 + 8 * j) =
            pack2(acc[n][4 * j + 2 * half] * f.scale,
                  acc[n][4 * j + 2 * half + 1] * f.scale);
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  // K and V, then 2 stages of Q and dO (64 x D tiles); P^T and dS^T (64 x
  // 64); 2 stages of the q rows' lse, then of their D; the stages'
  // barriers; slack
  return (size_t)6 * TcShape<D>::TILE + 2 * TB_SLAB + 4 * TB_ROWS * 4 + 16 +
         1024;
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, 1)
fa_bwd_dkdv_tc(const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ part, const FaBwd f,
               const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v) {
  using T = TcShape<D>;
  constexpr int WSL = T::WSL, NP = T::NP, TH = T::THREADS;
  constexpr uint32_t TILE = T::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t ks = raw + pad, vs = ks + TILE;
  const uint32_t ring = vs + TILE;  // stage s: Q at ring + 2 s TILE, dO after
  const uint32_t pts = ring + 4 * TILE, dsts = pts + TB_SLAB;
  const uint32_t rows_a = dsts + TB_SLAB;   // lse [2][64], then D [2][64]
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + pad + 6 * TILE + 2 * TB_SLAB);
  const uint32_t bars = rows_a + 4 * TB_ROWS * 4;   // a stage's: bars + 8 s

  const int Sq = f.Sq, Skv = f.Skv, Hq = f.Hq, nqt = f.nqt;
  const int causal = f.causal, window = f.window, prefix_len = f.prefix_len;
  const int hpg = f.G / f.hsplit;
  // this block's kv tile j, q-tile run and head share (the plan's order)
  const int nbh = f.B * f.Hkv;
  const int item = (int)(blockIdx.x / nbh), bh = (int)(blockIdx.x % nbh);
  const int b = bh / f.Hkv, hk = bh % f.Hkv;
  const int j = item / (f.kv_nr * f.hsplit);
  const int run = item / f.hsplit % f.kv_nr, split = item % f.hsplit;
  const int left = nqt - j > 0 ? nqt - j : 0;
  const int qa = fa_cut(j, left, f.kv_nr, run, nqt);
  const int qb = fa_cut(j, left, f.kv_nr, run + 1, nqt);
  const int k0 = j * TB_ROWS, nk = fb_min(TB_ROWS, Skv - k0);
  const int h0 = hk * f.G + split * hpg;  // the share's first q head

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const size_t kv_stride = (size_t)f.Hkv * D;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_stride + (size_t)hk * D;

  auto next_q = [&](int qt) {
    while (qt < qb &&
           !fa_tile_kept(qt * TB_ROWS, fb_min(qt * TB_ROWS + TB_ROWS, Sq), k0,
                         k0 + nk, causal, window, prefix_len))
      ++qt;
    return qt;
  };
  // Q and dO of q tile qt, head h0 + gi into stage st by one thread's
  // TMA (with K and V, `extra` bytes, on the first), the rows' lse and D
  // by cp.async
  auto load_unit = [&](int qt, int gi, int st, uint32_t extra) {
    const int q0 = qt * TB_ROWS;
    if (tid == 0) {
      const uint32_t qs = ring + 2 * st * TILE, bar = bars + 8 * st;
      mbar_expect(bar, 2 * TILE + extra);
      if (extra) {
        tma_tile<D>(ks, &tm_k, bar, hk, k0, b);
        tma_tile<D>(vs, &tm_v, bar, hk, k0, b);
      }
      tma_tile<D>(qs, &tm_q, bar, h0 + gi, q0, b);
      tma_tile<D>(qs + TILE, &tm_do, bar, h0 + gi, q0, b);
    }
    if (tid < 2 * TB_ROWS) {
      const int r = tid & (TB_ROWS - 1), which = tid / TB_ROWS;
      const float* src = which ? delta : lse;
      const size_t row = ((size_t)b * Hq + h0 + gi) * Sq + q0 + r;
      cp_async4z(rows_a + ((2 * which + st) * TB_ROWS + r) * 4,
                 q0 + r < Sq ? src + row : src, q0 + r < Sq);
    }
  };

  float dva[WSL][32], dka[WSL][32];
#pragma unroll
  for (int n = 0; n < WSL; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[n][i] = dka[n][i] = 0.0f;

  // the ring's barriers; K, V and the first unit
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    mbar_init_fence();
  }
  __syncthreads();
  int qt = next_q(qa), gi = 0, st = 0;
  if (qt < qb) load_unit(qt, 0, 0, 2 * TILE);
  cp_async_commit();

  const float sl2 = f.scale * FB_LOG2E;
  const int ra = wi * 16 + g4;         // this thread's kv rows ra, ra + 8
  for (int t = 0; qt < qb; ++t) {
    int nq = qt, ngi = gi + 1;         // the next unit
    if (ngi == hpg) {
      ngi = 0;
      nq = next_q(qt + 1);
    }
    cp_async_wait<0>();        // this thread's lse and D of this unit
    mbar_wait(bars + 8 * st, (t >> 1) & 1);     // its tiles landed
    __syncthreads();           // everyone's landed; the last unit consumed
    if (nq < qb) load_unit(nq, ngi, st ^ 1, 0);
    cp_async_commit();

    const uint32_t qs = ring + 2 * st * TILE, dos = qs + TILE;
    const float* ls = rows_s + st * TB_ROWS;
    const float* dl = rows_s + (2 + st) * TB_ROWS;
    const int q0 = qt * TB_ROWS;

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's NP q columns
    // (two chains of products interleaved)
    float s[NP / 2], dp[NP / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * TB_SLAB + (kk & 3) * 32;
      const uint32_t cols = off + wg * NP * 128;
      mma_np(s, desc_kmajor(ks + off), desc_kmajor(qs + cols), kk > 0);
      mma_np(dp, desc_kmajor(vs + off), desc_kmajor(dos + cols), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T = P^T (dP^T - D) in fp32, into shared memory in bf16
    // (K-major A tiles: kv rows, q columns along the row); the mask where
    // the unit is not kept whole
    bool whole = k0 + TB_ROWS <= Skv && q0 + TB_ROWS <= Sq;
    if (causal)
      whole = whole &&
              ((k0 + TB_ROWS - 1 <= q0 &&
                (window == 0 || q0 + TB_ROWS - 1 - k0 < window)) ||
               (prefix_len > 0 && k0 + TB_ROWS <= prefix_len));
    if (!whole)                // a dropped pair's P is exp2(-1e30) = 0
#pragma unroll
      for (int i = 0; i < NP / 2; ++i)
        if (!fa_kept(q0 + wg * NP + 8 * (i >> 2) + 2 * t4 + (i & 1),
                     k0 + ra + (i & 2) * 4, Sq, Skv, causal, window,
                     prefix_len))
          s[i] = FB_NEG_INF;
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj) {
      const int c = wg * NP + 8 * jj + 2 * t4;    // q columns c, c + 1
      const float l0 = ls[c] * FB_LOG2E, l1 = ls[c + 1] * FB_LOG2E;
      const float d0 = dl[c], d1 = dl[c + 1];
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(s[4 * jj + e] * sl2 - ((e & 1) ? l1 : l0));
        dsv[e] = pv[e] * (dp[4 * jj + e] - ((e & 1) ? d1 : d0));
      }
      const uint32_t o0 = swz(ra, c >> 3) + 4 * t4;
      const uint32_t o1 = swz(ra + 8, c >> 3) + 4 * t4;
      st_shared_u32(pts + o0, pack2(pv[0], pv[1]));
      st_shared_u32(pts + o1, pack2(pv[2], pv[3]));
      st_shared_u32(dsts + o0, pack2(dsv[0], dsv[1]));
      st_shared_u32(dsts + o1, pack2(dsv[2], dsv[3]));
    }
    fence_proxy_async();       // the writes, visible to wgmma
    __syncthreads();           // every warpgroup's columns written

    // dV += P^T dO and dK += dS^T Q over this warpgroup's slabs
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t pdesc = desc_kmajor(pts + kk * 32);
      const uint64_t sdesc = desc_kmajor(dsts + kk * 32);
#pragma unroll
      for (int n = 0; n < WSL; ++n) {
        const uint32_t sl = (wg * WSL + n) * TB_SLAB + kk * 2048;
        wgmma_bf16_ss_n64_tb(dva[n], pdesc, desc_mnmajor(dos + sl));
        wgmma_bf16_ss_n64_tb(dka[n], sdesc, desc_mnmajor(qs + sl));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < WSL; ++n) {
      fence_regs(dva[n]);
      fence_regs(dka[n]);
    }
    qt = nq;
    gi = ngi;
    st ^= 1;
  }

  const int c0 = wg * WSL * 64 + 2 * t4;
  if (f.kv_nr * f.hsplit == 1) {   // one slot a tile: dk and dv themselves
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r >= nk) continue;
      const size_t off = kv_off + (size_t)r * kv_stride + c0;
#pragma unroll
      for (int n = 0; n < WSL; ++n)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 4 * jj + 2 * half;
          *reinterpret_cast<uint32_t*>(dk + off + n * 64 + 8 * jj) =
              pack2(dka[n][i] * f.scale, dka[n][i + 1] * f.scale);
          *reinterpret_cast<uint32_t*>(dv + off + n * 64 + 8 * jj) =
              pack2(dva[n][i], dva[n][i + 1]);
        }
    }
    return;
  }
  // the fp32 partials (unscaled) into slot `item` (j, run, split):
  // [nbh][nkt][kv_nr][hsplit][64][D] of dK, then of dV
  const size_t slots = (size_t)f.nkt * f.kv_nr * f.hsplit;
  float* pk = part + ((size_t)bh * slots + item) * TB_ROWS * D;
  float* pv = pk + (size_t)nbh * slots * TB_ROWS * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
#pragma unroll
    for (int n = 0; n < WSL; ++n)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * half;
        const size_t off = (size_t)r * D + c0 + n * 64 + 8 * jj;
        *reinterpret_cast<float2*>(pk + off) =
            make_float2(dka[n][i], dka[n][i + 1]);
        *reinterpret_cast<float2*>(pv + off) =
            make_float2(dva[n][i], dva[n][i + 1]);
      }
  }
}

__device__ __forceinline__ void add4(float4& x, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x.x += a.x;
  x.y += a.y;
  x.z += a.z;
  x.w += a.w;
}

// dk and dv from the partials, a thread 4 columns of one row: a row's
// kv_nr x hsplit slots added in slot order, dK scaled, each rounded once.
// The launch holds the quads under 2^31.
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_sum(const float* __restrict__ part, bf16* __restrict__ dk,
           bf16* __restrict__ dv, const FaBwd f, int n4) {
  constexpr int D4 = D / 4;
  constexpr size_t TILE_F = (size_t)TB_ROWS * D;   // floats a slot
  const int cnt = f.kv_nr * f.hsplit;
  const size_t dv_off = (size_t)f.B * f.Hkv * f.nkt * cnt * TILE_F;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += gridDim.x * blockDim.x) {
    const int c = e % D4 * 4, row = e / D4;   // row: (b, position, kv head)
    const int hk = row % f.Hkv, bp = row / f.Hkv;
    const int p = bp % f.Skv, b = bp / f.Skv, j = p / TB_ROWS;
    const float* src =
        part + (((size_t)b * f.Hkv + hk) * f.nkt + j) * cnt * TILE_F +
        (size_t)(p - j * TB_ROWS) * D + c;
    float4 x = *reinterpret_cast<const float4*>(src);
    float4 y = *reinterpret_cast<const float4*>(src + dv_off);
    for (int s = 1; s < cnt; ++s) {
      add4(x, src + s * TILE_F);
      add4(y, src + dv_off + s * TILE_F);
    }
    *reinterpret_cast<uint2*>(dk + 4 * (size_t)e) =
        make_uint2(pack2(x.x * f.scale, x.y * f.scale),
                   pack2(x.z * f.scale, x.w * f.scale));
    *reinterpret_cast<uint2*>(dv + 4 * (size_t)e) =
        make_uint2(pack2(y.x, y.y), pack2(y.z, y.w));
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
#define FB_DEVICES 64

// the kernel's dynamic shared memory limit, set once a device (`done`:
// the kernel's own flags)
template <typename K>
static int set_smem(K kernel, size_t bytes, bool (&done)[FB_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < FB_DEVICES && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < FB_DEVICES) done[dev] = true;
  return (int)err;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, fetched once through the runtime (the
// library does not link libcuda)
static EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// tma_tile's map of a (B, S, H, D) bf16 tensor: 64 x 64 boxes, 128-byte
// swizzle, zeros past S
static int tile_map(CUtensorMap* m, const void* base, int B, int S, int H,
                    int D) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // the encoder needs the device's context current on this thread
  // (autograd runs the backward on a thread of its own)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, TB_ROWS, 1}, unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The plan's counts (FaBwd) and the fp32 scratch of the dK/dV partials
// (floats): where a kv tile has more than one block, 2 x B x Hkv x nkt x
// kv_nr x hsplit x 64 x Dh.  q_run: the plan's run length.  Returns 0,
// or an error where the plan does not fit the shapes.
static int fa_setup(FaBwd& f, int Dh, int q_run, long* floats) {
  f.G = f.Hq / f.Hkv;
  f.nqt = (f.Sq + TB_ROWS - 1) / TB_ROWS;
  f.nkt = (f.Skv + TB_ROWS - 1) / TB_ROWS;
  const long ntile = ((long)f.Sq * f.G + TB_ROWS - 1) / TB_ROWS;
  if (f.hsplit < 1 || f.hsplit > TB_HEAD_SPLITS || f.G % f.hsplit != 0 ||
      q_run < 1)
    return (int)cudaErrorInvalidValue;
  f.kv_nr = f.nqt > q_run ? (f.nqt + q_run - 1) / q_run : 1;  // kv tile 0's
  const long nbh = (long)f.B * f.Hkv, slots = (long)f.nkt * f.kv_nr * f.hsplit;
  if (slots * nbh > INT_MAX || ntile * nbh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  f.ntile = (int)ntile;
  *floats = slots > f.nkt ? 2 * nbh * slots * TB_ROWS * Dh : 0;
  return 0;
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dO,
                     void* dq, void* dk, void* dv, float* delta, float* part,
                     long part_floats, FaBwd f, int q_run,
                     cudaStream_t st) {
  static bool set_dq[FB_DEVICES], set_dkdv[FB_DEVICES];
  long floats = 0;
  int err = fa_setup(f, D, q_run, &floats);
  if (err != 0) return err;
  const long n4 = floats ? (long)f.B * f.Skv * f.Hkv * (D / 4) : 0;
  if (floats > part_floats || n4 > INT_MAX ||
      (part == nullptr && floats > 0))
    return (int)cudaErrorInvalidValue;
  if ((err = set_smem(fa_bwd_dq_tc<D>, dq_tc_smem<D>(), set_dq)) != 0)
    return err;
  if ((err = set_smem(fa_bwd_dkdv_tc<D>, dkdv_tc_smem<D>(), set_dkdv)) != 0)
    return err;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if ((err = tile_map(&tm_q, q, f.B, f.Sq, f.Hq, D)) != 0 ||
      (err = tile_map(&tm_do, dO, f.B, f.Sq, f.Hq, D)) != 0 ||
      (err = tile_map(&tm_k, k, f.B, f.Skv, f.Hkv, D)) != 0 ||
      (err = tile_map(&tm_v, v, f.B, f.Skv, f.Hkv, D)) != 0)
    return err;
  const unsigned nbh = (unsigned)(f.B * f.Hkv);
  fa_bwd_dq_tc<D><<<f.ntile * nbh, TcShape<D>::THREADS, dq_tc_smem<D>(),
                    st>>>((const bf16*)q, (const bf16*)o, lse,
                          (const bf16*)dO, (bf16*)dq, delta, f, tm_k, tm_v);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  fa_bwd_dkdv_tc<D><<<f.nkt * f.kv_nr * f.hsplit * nbh, TcShape<D>::THREADS,
                      dkdv_tc_smem<D>(), st>>>(lse, delta, (bf16*)dk,
                                               (bf16*)dv, part, f, tm_q,
                                               tm_do, tm_k, tm_v);
  if ((err = (int)cudaGetLastError()) != 0 || n4 == 0) return err;
  const long blocks = (n4 + 255) / 256;
  fa_bwd_sum<D><<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                  st>>>(part, (bf16*)dk, (bf16*)dv, f, (int)n4);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dh(int bf16_in, const void* q, const void* k,
                     const void* v, const void* o, const float* lse,
                     const void* dO, void* dq, void* dk, void* dv,
                     float* delta, float* part, long part_floats,
                     const FaBwd& f, int q_run, cudaStream_t st) {
  if (bf16_in)
    return launch_tc<D>(q, k, v, o, lse, dO, dq, dk, dv, delta, part,
                        part_floats, f, q_run, st);
  static bool set_dq[FB_DEVICES], set_dkdv[FB_DEVICES];
  int err;
  if ((err = set_smem(fa_bwd_dq_f32<D>, f32_smem<D>(), set_dq)) != 0)
    return err;
  if ((err = set_smem(fa_bwd_dkdv_f32<D>, f32_smem<D>(), set_dkdv)) != 0)
    return err;
  fa_bwd_dq_f32<D><<<dim3((f.Sq + FB_T - 1) / FB_T, f.Hq, f.B), FB_THREADS,
                     f32_smem<D>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, lse,
      (const float*)dO, (float*)dq, delta, f.Sq, f.Skv, f.Hq, f.Hkv,
      f.causal, f.window, f.prefix_len, f.scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  fa_bwd_dkdv_f32<D><<<dim3((f.Skv + FB_T - 1) / FB_T, f.Hkv, f.B),
                       FB_THREADS, f32_smem<D>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, lse, delta,
      (const float*)dO, (float*)dk, (float*)dv, f.Sq, f.Skv, f.Hq, f.Hkv,
      f.causal, f.window, f.prefix_len, f.scale);
  return (int)cudaGetLastError();
}

// bf16: 1 if q, k, v, o, dO and the gradients are bf16 (the tensor-core
// kernels), 0 if fp32 (the CUDA-core kernels); Dh one of 64, 128, 256; lse
// and delta (B, Hq, Sq) fp32.  bf16 only: hsplit and q_run, the plan
// (kernels/flash_attention.py::bwd_plan), and part, an fp32 scratch of
// part_floats (at least what fa_setup counts; null where that is 0)
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* delta, void* part, long long part_floats, int B, int Sq, int Skv,
    int Hq, int Hkv, int Dh, int bf16, int causal, int window, int prefix_len,
    int hsplit, int q_run, float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hq < 1 || Hq > 65535 ||
      Hkv < 1 || Hq % Hkv != 0 || window < 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  FaBwd f = {};
  f.B = B;
  f.Sq = Sq;
  f.Skv = Skv;
  f.Hq = Hq;
  f.Hkv = Hkv;
  f.causal = causal;
  f.window = window;
  f.prefix_len = prefix_len;
  f.hsplit = hsplit;
  f.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  float* pt = (float*)part;
  switch (Dh) {
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, pt,
                           (long)part_floats, f, q_run, st);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, pt,
                            (long)part_floats, f, q_run, st);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, l, dO, dq, dk, dv, dl, pt,
                            (long)part_floats, f, q_run, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
