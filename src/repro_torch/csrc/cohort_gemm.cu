// Batch-invariant strided batched GEMM for the cohort's local SGD.
//
//   c[z1, z2, m, n] = sum_{r < R} sum_{k < K}
//                       a[z1, z2, r, m, k] b[z1, z2, r, k, n]
//                     (+ bias[z1, z2, m, n])
//   rowsum[z1, z2, m] = sum_{r < R} sum_{k < K} a[z1, z2, r, m, k]
//                     (optional: a bias gradient, fused into the launch
//                     of its weight gradient)
//
// Every operand is a strided view (element strides, 0 for a broadcast
// axis), so the stacked convolution's weights broadcast over the batch,
// a transpose is a swap of strides, and the batch sum of a weight
// gradient is the R axis.  It replaces no Pallas kernel: the reference
// trains the cohort with XLA's dot products under vmap
// (src/repro/fl/client.py:283-300).  cuBLAS, which the port used before,
// picks its kernel (tiles, split-K, and so the order of the fp32 sums)
// by the batch count, so a client trained alone (the loop engine), in a
// cohort bucket (the batched engine) or in one rank's slice of the
// cohort (the client mesh) came out different in the last bits, and fp32
// SGD carried that to 1e-2 in two rounds (ROADMAP C12).
//
// Contract: the order of every output's sum is set by the product's own
// sizes (R, K, M, N, Z1), never by Z2, the cohort axis; no atomics.
// kernels/cohort_gemm.py::gemm_plan picks the tile, the runs and the k
// chunk from those sizes alone (and gemm_fold from the call's layout), so
// a client's bits do not depend on how many clients share the launch.
// How a tile reaches shared memory (16- or 4-byte copies) changes no bit.
//
// fp32 runs on the tensor cores as 3xTF32 (as probe_phases.cuh's conv2
// and fc1): x = hi + lo with hi = x rounded to TF32 and lo = x - hi, and
// a_hi b_lo + a_lo b_hi + a_hi b_hi a k step, through mma.sync m16n8k8
// (a step's products are 1 to 800 rows tall; no wgmma).  Each chunk of
// a long run is summed on the tensor cores from zero and added to fp32
// registers on CUDA cores (promoted accumulation: the tensor cores
// truncate as they accumulate); a short run (at most 2 chunks of 32)
// sums straight into its registers.  What bounds a step is latency and
// CTA count, not arithmetic (its products are 1.45 GFLOP a client, 8.8
// us at the 3xTF32 peak); the design against it:
//   - the tile (BM x BN, 16..64 x 32..64) follows the product's M and N,
//     4 warps a CTA; where they cover less than the tile's k step, the
//     warps left over share its k steps (warp wk takes every WK-th
//     8-wide step of a chunk).  Where a broadcasts over Z1 with R = 1
//     (the convolutions' weights over the batch), Z1 joins N: one (M, Z1
//     N) product a cohort member, no tile half empty at N = 196;
//   - a cp.async ring (2 stages for short runs, 3 or 6 for long ones):
//     later chunks are in flight while one is on the tensor cores.  Each
//     operand is staged in the orientation of its unit-stride axis,
//     16-byte copies where the wrapper finds every group of 4 aligned,
//     else 4-byte ones (any stride, transpose or broadcast), rows padded
//     so that the fragments' 8-byte reads (k taken in pairs) and the
//     copies hit distinct banks;
//   - a long sum (fc1's forward, the weight gradients' R x K) is cut
//     into `splits` contiguous runs of chunks, one CTA each, the CTAs of
//     a tile one thread-block cluster (up to 16, a non-portable size the
//     H100 schedules, for the weight gradients' 4,000-16,000-long sums on
//     1-13 tiles): each writes its partial tile to
//     its shared memory, and after a cluster barrier each CTA adds its
//     share of the tile's mma tiles over the runs in run order through
//     distributed shared memory (no slab, no second launch);
//   - a bias gradient is the row sums of the weight gradient's a
//     operand: the first n tile's CTAs add each staged row of a, a chunk
//     at a time (a row's threads k in order over their share, then in
//     lane order), and reduce the runs as above;
//   - one CTA's tile with no k split and no runs stores straight from
//     the mma registers.
// Per output the order is: chunks in (r, k) order within a run, the
// warps' k slices in warp order, the runs in run order, then the bias.
//
// fp64 operands (the port's fp64 checks of training on the card) keep a
// plain CUDA-core tile, 64 x 64 x 16 with one FMA a thread an output, its
// long sums cut into runs through a `work` slab that a second kernel
// adds in run order; the fp64 checks are not timed.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

// The launch's operands, filled by kernels/cohort_gemm.py (ctypes).
struct CohortGemm {
  const void* a;
  const void* b;
  const void* bias;           // null: no bias
  void* c;
  void* rowsum;               // null: none; else (Z1 Z2, M), contiguous
  void* work;                 // fp64: (splits, Z1 Z2, M, N) partial sums
  int m, n, k, z1, z2, r;
  int splits;                 // runs of k steps (fp32: the cluster size)
  int f64;                    // 1: every operand is double, else float
  int bm, bn, stages, bk;     // fp32: tile, short (2) or long run, chunk
  int vec;                    // fp32: 16-byte copies of a (1), of b (2)
  int fold;                   // fp32: 1: a broadcasts over Z1 (R = 1), so
                              // Z1 joins N: one (M, Z1 N) product a z2
  long long as[5];            // a's strides: z1, z2, r, m, k
  long long bs[5];            // b's strides: z1, z2, r, k, n
  long long cs[4];            // c's strides: z1, z2, m, n
  long long biass[4];         // bias's strides: z1, z2, m, n
};

#define CG_MAX_GRID_Z 65535

// ---------------------------------------------------------------- fp32

#define TG_BK 32              // the short runs' chunk: 4 k steps of 8
#define TG_THREADS 128
#define TG_MAX_SPLITS 16      // a cluster of up to 16 (non-portable)

template <int BM, int BN, int STAGES, int BK>
struct TileShape {
  // a warp tile's rows: 32, but 16 in a 32-row tile of short runs (so
  // that its 4 warps cover the tile and store from registers)
  static constexpr int WTM = BM == 64 || (BM == 32 && STAGES > 2) ? 32 : 16;
  static constexpr int WM = BM / WTM, WN = BN / 32;
  static constexpr int WK = 4 / (WM * WN);        // warps on one tile
  static constexpr int MT = WTM / 16, NT = 4;     // mma tiles a warp
  // an operand's tile in either orientation: [mn][k] (pitch BK + 8:
  // rows at (8 mn + k) % 32, 8-byte pairs on distinct banks) where its k
  // axis has stride 1, else [k][mn] (pitch mn + 4: the fragments' even k
  // rows at (8 k / 2 + mn) % 32, distinct banks)
  static constexpr int KP = BK + 8;
  static constexpr int A =
      BM * KP > BK * (BM + 4) ? BM * KP : BK * (BM + 4);
  static constexpr int B =
      BN * KP > BK * (BN + 4) ? BN * KP : BK * (BN + 4);
  static constexpr int STAGE = A + B;                            // floats
  static constexpr int RPITCH = BN + 8;            // 8-byte pairs
  static constexpr int RED = WK * BM * RPITCH + BM;
  static constexpr int SMEM =
      4 * (STAGES * STAGE > RED ? STAGES * STAGE : RED);
};

// 4 bytes global -> shared; zero-filled when !valid (src not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// x = hi + lo: hi = x rounded to TF32 (one cvt), lo = x - hi (exact),
// which the tensor cores read as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += A B, tf32, m16n8k8: a[0..3] = A (row g, col t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b[0..1] = B (row t, col g), (t + 4, g);
// d = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), with g = lane /
// 4 and t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (0: nothing read)
__device__ __forceinline__ void cp_async16n(float* dst, const float* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One operand's share of a chunk's tile for this thread: L (BM or BN)
// along mn by 32 along k, read along the axis whose stride is 1 (mn when
// k's is not), in groups of G = 4 elements (16-byte copies, where the
// wrapper found every group 16-byte aligned) or of 1.  Thread t takes
// group u = t % (U / G) along that axis and every (128 G / U)-th line
// across it, so a warp reads consecutive addresses and the thread's
// addresses step by a constant.
template <int L, int BK>
struct OperandLoad {
  const float* base;          // element (mn0 + first mn, first k) at r = 0
  long long s_r, s_k, s_v;    // strides: r, k, across the read axis
  int u, v0, vstep;           // the thread's first element along, across
  int lim_u, lim_v;           // bounds from mn0 (k's is set a chunk)
  int dst0, dstep;            // shared offset of its first element, step
  bool kc, vec;               // [mn][k] (k has stride 1); 16-byte copies

  __device__ void init(const float* p, const long long* st, int mn0,
                       int mn_len, int tid, bool vec_, int fold_n = 0,
                       long long fold_s = 0) {
    // st: z1, z2, r, then this operand's mn and k strides
    kc = st[4] == 1;
    vec = vec_;
    const int ulen = kc ? BK : L, gsz = vec ? 4 : 1;
    const int lanes = ulen / gsz;               // threads along a line
    u = tid % lanes * gsz;
    v0 = tid / lanes;
    vstep = TG_THREADS / lanes;
    s_r = st[2];
    s_k = st[4];
    s_v = kc ? st[3] : st[4];
    const int mn = kc ? v0 : u, k = kc ? u : v0;
    base = p + (long long)(mn0 + mn) * st[3] + (long long)k * st[4];
    if (fold_n > 0) {         // mn = z1 fold_n + n (read along mn: fixed)
      const int zi = (mn0 + mn) / fold_n;
      base = p + zi * fold_s + (long long)(mn0 + mn - zi * fold_n) * st[3] +
             (long long)k * st[4];
    }
    lim_u = kc ? 0 : mn_len - mn0;
    lim_v = kc ? mn_len - mn0 : 0;
    const int pitch = kc ? BK + 8 : L + 4;
    dst0 = v0 * pitch + u;
    dstep = vstep * pitch;
  }

  // chunk (rr, k0) into the tile at `dst`
  __device__ __forceinline__ void load(float* dst, int rr, int k0,
                                       int k_len) const {
    const int ulim = kc ? k_len - k0 : lim_u;  // elements left along u
    const int vlim = kc ? lim_v : k_len - k0;
    const float* src = base + rr * s_r + (long long)k0 * s_k;
    float* d = dst + dst0;
    if (vec) {
      const int n = min(max(ulim - u, 0), 4);
#pragma unroll
      for (int e = 0; e < L * BK / TG_THREADS / 4; ++e) {
        const int bytes = v0 + e * vstep < vlim ? 4 * n : 0;
        cp_async16n(d + e * dstep, bytes ? src + e * vstep * s_v : base,
                    bytes);
      }
    } else {
      const bool u_ok = u < ulim;
#pragma unroll
      for (int e = 0; e < L * BK / TG_THREADS; ++e) {
        const bool ok = u_ok && v0 + e * vstep < vlim;
        cp_async4(d + e * dstep, ok ? src + e * vstep * s_v : base, ok);
      }
    }
  }

  // (mn, k) of the staged tile: its offset
  __device__ __forceinline__ int at(int mn, int k) const {
    return kc ? mn * (BK + 8) + k : k * (L + 4) + mn;
  }

  // the elements (mn, k) and (mn, k + 1) at `p` = this tile + at(mn, k),
  // k even: one 8-byte read where k has stride 1
  __device__ __forceinline__ float2 pair(const float* p) const {
    return kc ? *reinterpret_cast<const float2*>(p)
              : make_float2(p[0], p[L + 4]);
  }
};

// 3 CTAs an SM (168 registers); 2 (no spills) for the smaller tiles'
// long runs, whose products have few tiles (clusters of 8 or 16 runs)
template <int BM, int BN, int STAGES, int BK>
__global__ void __launch_bounds__(TG_THREADS,
                                  BM * BN == 4096 || STAGES == 2 ? 3 : 2)
cohort_gemm_tf32_kernel(const CohortGemm g) {
  using S = TileShape<BM, BN, STAGES, BK>;
  constexpr bool PROMOTE = STAGES > 2;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wk = warp % S::WK, wmn = warp / S::WK;
  const int wm = wmn / S::WN, wn = wmn % S::WN;
  const int splits = g.splits;
  const int rank = (int)(blockIdx.x % splits);    // the cluster's rank
  const int n0 = (int)(blockIdx.x / splits) * BN, m0 = blockIdx.y * BM;
  const bool want_rs = g.rowsum != nullptr && n0 == 0;
  constexpr int RT = TG_THREADS / BM;             // threads a row of a
  const int rs_row = tid / RT, rs_j = tid % RT;   // (their row sums)
  const int nkc = (g.k + BK - 1) / BK;
  const long long steps = (long long)g.r * nkc;     // < 2^31 (the wrapper)
  const int t0 = (int)(steps * rank / splits);
  const int nt = (int)(steps * (rank + 1) / splits) - t0;
  const int nfold = g.fold ? g.z1 : 1;            // Z1 values along N
  const int n_ext = g.n * nfold;
  const int zs = g.fold ? g.z2 : g.z1 * g.z2;
  float* red = sm;                                // after the k loop
  float* rsm = sm + S::WK * BM * S::RPITCH;
  // a's strides as (z1, z2, r, m, k); b's as (z1, z2, r, n, k)
  const long long bst[5] = {g.bs[0], g.bs[1], g.bs[2], g.bs[4], g.bs[3]};

  for (int z = blockIdx.z; z < zs; z += gridDim.z) {
    const int i1 = g.fold ? 0 : z / g.z2, i2 = g.fold ? z : z % g.z2;
    OperandLoad<BM, BK> la;
    OperandLoad<BN, BK> lb;
    la.init((const float*)g.a + i1 * g.as[0] + i2 * g.as[1], g.as, m0, g.m,
            tid, g.vec & 1);
    lb.init((const float*)g.b + i1 * g.bs[0] + i2 * g.bs[1], bst, n0, n_ext,
            tid, g.vec & 2, g.fold ? g.n : 0, g.bs[0]);
    // the run's chunks in order: (r, k0) of the next one to load
    int ld_r = t0 / nkc, ld_k = t0 % nkc * BK;
    auto load_next = [&](int stage) {
      float* as_t = sm + stage * S::STAGE;
      la.load(as_t, ld_r, ld_k, g.k);
      lb.load(as_t + S::A, ld_r, ld_k, g.k);
      ld_k += BK;
      if (ld_k >= g.k) {
        ld_k = 0;
        ++ld_r;
      }
    };
    // this thread's fragment offsets in a staged tile: a's rows of its
    // mma tiles, b's columns, at k = 2 tq.  A k step's 8 k are taken in
    // pairs: the thread's fragment slots t and t + 4 hold k = 2t and 2t +
    // 1 of both operands (the same 8 products, one 8-byte read where k
    // has stride 1)
    int aoff[S::MT], boff[S::NT];
#pragma unroll
    for (int p = 0; p < S::MT; ++p)
      aoff[p] = la.at(wm * S::WTM + p * 16 + gq, 2 * tq);
#pragma unroll
    for (int q = 0; q < S::NT; ++q)
      boff[q] = lb.at(wn * 32 + q * 8 + gq, 2 * tq);
    const int a8 = la.at(8, 0), ak8 = la.at(0, 8), bk8 = lb.at(0, 8);

    float acc[S::MT][S::NT][4];
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    float rs = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nt) load_next(s);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait<STAGES - 2>();      // chunk i landed (this thread's)
      __syncthreads();                  // everyone's; chunk i - 1 consumed
      if (i + STAGES - 1 < nt)
        load_next((i + STAGES - 1) % STAGES);
      cp_async_commit();
      const float* as_t = sm + (i % STAGES) * S::STAGE;
      const float* bs_t = as_t + S::A;
      float chunk[S::MT][S::NT][4];
      float(&part)[S::MT][S::NT][4] = PROMOTE ? chunk : acc;
      if constexpr (PROMOTE) {
#pragma unroll
        for (int p = 0; p < S::MT; ++p)
#pragma unroll
          for (int q = 0; q < S::NT; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[p][q][e] = 0.0f;
      }
      // this warp's k steps of the chunk, each a_hi b_lo + a_lo b_hi +
      // a_hi b_hi; runs of at most 2 chunks (the 2-stage ring) sum
      // straight into acc
#pragma unroll
      for (int j = 0; j < BK / 8 / S::WK; ++j) {
        const int ks = wk + j * S::WK;
        uint32_t ah[S::MT][4], al[S::MT][4], bh[S::NT][2], bl[S::NT][2];
#pragma unroll
        for (int p = 0; p < S::MT; ++p) {
          const float* ap = as_t + aoff[p] + ks * ak8;
          const float2 x0 = la.pair(ap), x1 = la.pair(ap + a8);
          split3(x0.x, ah[p][0], al[p][0]);
          split3(x1.x, ah[p][1], al[p][1]);
          split3(x0.y, ah[p][2], al[p][2]);
          split3(x1.y, ah[p][3], al[p][3]);
        }
#pragma unroll
        for (int q = 0; q < S::NT; ++q) {
          const float2 x = lb.pair(bs_t + boff[q] + ks * bk8);
          split3(x.x, bh[q][0], bl[q][0]);
          split3(x.y, bh[q][1], bl[q][1]);
        }
#pragma unroll
        for (int p = 0; p < S::MT; ++p)
#pragma unroll
          for (int q = 0; q < S::NT; ++q) {
            mma_tf32(part[p][q], ah[p], bl[q]);
            mma_tf32(part[p][q], al[p], bh[q]);
            mma_tf32(part[p][q], ah[p], bh[q]);
          }
      }
      if constexpr (PROMOTE) {
#pragma unroll
        for (int p = 0; p < S::MT; ++p)
#pragma unroll
          for (int q = 0; q < S::NT; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][q][e] += chunk[p][q][e];
      }
      if (want_rs) {                    // the bias gradient: a's rows
        // RT threads a row, each k in order over its BK / RT, then the
        // RT sums in lane order
        float s = 0.0f;
        const float* ar = as_t + la.at(rs_row, rs_j * (BK / RT));
        const int ak = la.at(0, 1);
#pragma unroll
        for (int kk = 0; kk < BK / RT; ++kk) s += ar[kk * ak];
        float t = 0.0f;
#pragma unroll
        for (int j = 0; j < RT; ++j)
          t += __shfl_sync(0xffffffffu, s, (lane & ~(RT - 1)) + j);
        rs += t;
      }
    }
    cp_async_wait<0>();
    float* c = (float*)g.c + i1 * g.cs[0] + i2 * g.cs[1];
    const float* bias =
        g.bias != nullptr
            ? (const float*)g.bias + i1 * g.biass[0] + i2 * g.biass[1]
            : nullptr;
    // column gn of the (Z1 N where folded) outputs: its offsets in c and
    // in bias, or none past the edge; one division a column, not an output
    struct OutCol {
      long long c, b;
      bool ok;
    };
    auto col = [&](int gn) {
      OutCol o;
      o.ok = gn < n_ext;
      int zi = 0;
      if (nfold > 1) {
        zi = gn / g.n;
        gn -= zi * g.n;
      }
      o.c = zi * g.cs[0] + gn * g.cs[3];
      o.b = zi * g.biass[0] + gn * g.biass[3];
      return o;
    };
    // row gm's outputs at a thread's two columns: the bias, then one 8-byte
    // store where the two are adjacent in c, else two
    auto put2 = [&](int gm, const OutCol& o0, const OutCol& o1, float v0,
                    float v1) {
      if (gm >= g.m) return;
      const long long rc = gm * g.cs[2], rb = gm * g.biass[2];
      if (bias != nullptr) {
        if (o0.ok) v0 += bias[rb + o0.b];
        if (o1.ok) v1 += bias[rb + o1.b];
      }
      float* p0 = c + rc + o0.c;
      if (o0.ok && o1.ok && o1.c == o0.c + 1 &&
          (reinterpret_cast<uintptr_t>(p0) & 7) == 0) {
        *reinterpret_cast<float2*>(p0) = make_float2(v0, v1);
        return;
      }
      if (o0.ok) *p0 = v0;
      if (o1.ok) c[rc + o1.c] = v1;
    };
    if (S::WK == 1 && splits == 1) {    // straight from registers
#pragma unroll
      for (int q = 0; q < S::NT; ++q) {
        const int gn = n0 + wn * 32 + q * 8 + 2 * tq;
        const OutCol o0 = col(gn), o1 = col(gn + 1);
#pragma unroll
        for (int p = 0; p < S::MT; ++p) {
          const int gm = m0 + wm * S::WTM + p * 16 + gq;
          put2(gm, o0, o1, acc[p][q][0], acc[p][q][1]);
          put2(gm + 8, o0, o1, acc[p][q][2], acc[p][q][3]);
        }
      }
      if (want_rs && rs_j == 0 && m0 + rs_row < g.m)
        ((float*)g.rowsum)[(long long)z * g.m + m0 + rs_row] = rs;
      __syncthreads();                  // the ring is reused
      continue;
    }
    __syncthreads();                    // the ring is free: partial tiles
#pragma unroll
    for (int p = 0; p < S::MT; ++p)
#pragma unroll
      for (int q = 0; q < S::NT; ++q) {
        float* d = red + (wk * BM + wm * S::WTM + p * 16 + gq) * S::RPITCH +
                   wn * 32 + q * 8 + 2 * tq;
        *reinterpret_cast<float2*>(d) = make_float2(acc[p][q][0], acc[p][q][1]);
        *reinterpret_cast<float2*>(d + 8 * S::RPITCH) =
            make_float2(acc[p][q][2], acc[p][q][3]);
      }
    if (want_rs && rs_j == 0) rsm[rs_row] = rs;
    __syncthreads();
    if (splits > 1) cg::this_cluster().sync();   // every run's tile ready

    // the k slices' warps of the first slice (wk = 0) add, for their mma
    // tiles that fall to this CTA (tile p NT + q to rank (p NT + q) %
    // splits), the runs in run order and each run's k slices in warp
    // order, then the bias
    if (wk == 0) {
#pragma unroll
      for (int q = 0; q < S::NT; ++q) {
        const int gn = n0 + wn * 32 + q * 8 + 2 * tq;
        const OutCol o0 = col(gn), o1 = col(gn + 1);
#pragma unroll
        for (int p = 0; p < S::MT; ++p) {
          if ((p * S::NT + q) % splits != rank) continue;
          const int off = (wm * S::WTM + p * 16 + gq) * S::RPITCH +
                          wn * 32 + q * 8 + 2 * tq;
          float2 v[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
          for (int s = 0; s < splits; ++s) {
            const float* rp =
                s == rank ? red : cg::this_cluster().map_shared_rank(red, s);
#pragma unroll
            for (int w = 0; w < S::WK; ++w)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 x = *reinterpret_cast<const float2*>(
                    rp + off + (w * BM + 8 * h) * S::RPITCH);
                v[h].x += x.x;
                v[h].y += x.y;
              }
          }
          const int gm = m0 + wm * S::WTM + p * 16 + gq;
          put2(gm, o0, o1, v[0].x, v[0].y);
          put2(gm + 8, o0, o1, v[1].x, v[1].y);
        }
      }
    }
    if (want_rs) {
      const int rper = (BM + splits - 1) / splits;
      const int mi = rank * rper + tid;
      if (tid < rper && mi < BM && m0 + mi < g.m) {
        float v = 0.0f;
        for (int s = 0; s < splits; ++s)
          v += (s == rank ? rsm : cg::this_cluster().map_shared_rank(rsm, s))
              [mi];
        ((float*)g.rowsum)[(long long)z * g.m + m0 + mi] = v;
      }
    }
    if (splits > 1) cg::this_cluster().sync();   // remote reads done
    __syncthreads();                             // the ring is reused
  }
}

// the kernel's shared memory: its size, and the most of the SM's
// L1 / shared split (else the driver may pick a split that fits fewer
// CTAs than the registers allow)
template <int BM, int BN, int STAGES, int BK>
static cudaError_t size_tf32() {
  static cudaError_t sized = cudaErrorNotReady;
  if (sized == cudaErrorNotReady) {
    sized = cudaFuncSetAttribute(cohort_gemm_tf32_kernel<BM, BN, STAGES, BK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TileShape<BM, BN, STAGES, BK>::SMEM);
    if (sized == cudaSuccess)
      sized = cudaFuncSetAttribute(
          cohort_gemm_tf32_kernel<BM, BN, STAGES, BK>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (sized == cudaSuccess)
      sized = cudaFuncSetAttribute(
          cohort_gemm_tf32_kernel<BM, BN, STAGES, BK>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return sized;
}

template <int BM, int BN, int STAGES, int BK>
static cudaError_t launch_tf32(const CohortGemm& g, cudaStream_t st) {
  using S = TileShape<BM, BN, STAGES, BK>;
  const cudaError_t sized = size_tf32<BM, BN, STAGES, BK>();
  if (sized != cudaSuccess) return sized;
  const long long zs = g.fold ? g.z2 : (long long)g.z1 * g.z2;
  const long long n_ext = g.fold ? (long long)g.n * g.z1 : g.n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((n_ext + BN - 1) / BN) * g.splits),
                     (unsigned)((g.m + BM - 1) / BM),
                     (unsigned)(zs < CG_MAX_GRID_Z ? zs : CG_MAX_GRID_Z));
  cfg.blockDim = dim3(TG_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, cohort_gemm_tf32_kernel<BM, BN, STAGES, BK>,
                            g);
}

// Short runs (at most 2 chunks of 32): a 2-stage ring.  Long runs: the
// 64 x 64 tile a 3-stage ring (3 CTAs an SM); the smaller tiles, whose
// products have few tiles and are bound by each chunk's latency, a
// 6-stage ring (2 CTAs an SM), and the tiles of at most 32 x 32 chunks
// of 64 (half the barriers a k step).  gemm_plan's `bk` names the chunk.
template <int BM, int BN>
struct LongRun {
  static constexpr int BK = BM * BN <= 1024 ? 64 : 32;
  static constexpr int N = BM * BN == 4096 ? 3 : 6;
};

template <int BM, int BN>
static cudaError_t launch_tf32_ring(const CohortGemm& g, cudaStream_t st) {
  using R = LongRun<BM, BN>;
  if (g.stages <= 2)
    return g.bk == TG_BK ? launch_tf32<BM, BN, 2, TG_BK>(g, st)
                         : cudaErrorInvalidValue;
  return g.bk == R::BK ? launch_tf32<BM, BN, R::N, R::BK>(g, st)
                       : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- fp64

#define CG_BM 64
#define CG_BN 64
#define CG_BK 16
#define CG_THREADS 256

__global__ void __launch_bounds__(CG_THREADS)
cohort_gemm_f64_kernel(const CohortGemm g) {
  using T = double;
  __shared__ T as_t[CG_BK][CG_BM + 1];
  __shared__ T bs_t[CG_BK][CG_BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * CG_BM, n0 = blockIdx.x * CG_BN;
  const bool a_k_unit = g.as[4] == 1;
  const bool b_n_unit = g.bs[4] == 1;
  const int zs = g.z1 * g.z2;
  const int nkt = (g.k + CG_BK - 1) / CG_BK;
  const long long steps = (long long)g.r * nkt;
  for (long long zz = blockIdx.z; zz < (long long)zs * g.splits;
       zz += gridDim.z) {
    const int z = (int)(zz / g.splits), sp = (int)(zz % g.splits);
    const int i1 = z / g.z2, i2 = z % g.z2;
    const T* a = (const T*)g.a + i1 * g.as[0] + i2 * g.as[1];
    const T* b = (const T*)g.b + i1 * g.bs[0] + i2 * g.bs[1];
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    const long long t1 = steps * (sp + 1) / g.splits;
    for (long long t = steps * sp / g.splits; t < t1; ++t) {
      const int rr = (int)(t / nkt), k0 = (int)(t % nkt) * CG_BK;
      const T* ar = a + rr * g.as[2];
      const T* br = b + rr * g.bs[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * CG_THREADS;
        // a's tile, walked along its unit-stride axis
        const int am = a_k_unit ? idx / CG_BK : idx % CG_BM;
        const int ak = a_k_unit ? idx % CG_BK : idx / CG_BM;
        const int gm = m0 + am, gk = k0 + ak;
        as_t[ak][am] = (gm < g.m && gk < g.k)
                           ? ar[gm * g.as[3] + gk * g.as[4]] : T(0);
        const int bn = b_n_unit ? idx % CG_BN : idx / CG_BK;
        const int bk = b_n_unit ? idx / CG_BN : idx % CG_BK;
        const int gn = n0 + bn, gk2 = k0 + bk;
        bs_t[bk][bn] = (gn < g.n && gk2 < g.k)
                           ? br[gk2 * g.bs[3] + gn * g.bs[4]] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CG_BK; ++kk) {
        T av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as_t[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs_t[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fma(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (g.splits > 1) {               // this run's partial sums
      T* w = (T*)g.work + ((long long)sp * zs + z) * g.m * g.n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty + 16 * i;
        if (gm >= g.m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = n0 + tx + 16 * j;
          if (gn < g.n) w[(long long)gm * g.n + gn] = acc[i][j];
        }
      }
      continue;
    }
    T* c = (T*)g.c + i1 * g.cs[0] + i2 * g.cs[1];
    const T* bias = g.bias != nullptr
                        ? (const T*)g.bias + i1 * g.biass[0] + i2 * g.biass[1]
                        : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= g.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn >= g.n) continue;
        T v = acc[i][j];
        if (bias != nullptr) v += bias[gm * g.biass[2] + gn * g.biass[3]];
        c[gm * g.cs[2] + gn * g.cs[3]] = v;
      }
    }
  }
}

// The runs' partial sums added in run order, then the bias: one thread
// an output.
__global__ void __launch_bounds__(CG_THREADS)
cohort_gemm_f64_reduce_kernel(const CohortGemm g) {
  using T = double;
  const long long mn = (long long)g.m * g.n;
  const long long total = (long long)g.z1 * g.z2 * mn;
  for (long long e = blockIdx.x * (long long)CG_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * CG_THREADS) {
    const T* w = (const T*)g.work + e;
    T v = w[0];
    for (int sp = 1; sp < g.splits; ++sp) v += w[sp * total];
    const int z = (int)(e / mn);
    const int gm = (int)(e % mn / g.n), gn = (int)(e % g.n);
    const int i1 = z / g.z2, i2 = z % g.z2;
    if (g.bias != nullptr)
      v += ((const T*)g.bias)[i1 * g.biass[0] + i2 * g.biass[1] +
                              gm * g.biass[2] + gn * g.biass[3]];
    ((T*)g.c)[i1 * g.cs[0] + i2 * g.cs[1] + gm * g.cs[2] + gn * g.cs[3]] = v;
  }
}

static cudaError_t launch_f64(const CohortGemm& g, cudaStream_t st) {
  if (g.rowsum != nullptr || (g.splits > 1 && g.work == nullptr))
    return cudaErrorInvalidValue;
  const long long zs = (long long)g.z1 * g.z2 * g.splits;
  dim3 grid((g.n + CG_BN - 1) / CG_BN, (g.m + CG_BM - 1) / CG_BM,
            (unsigned)(zs < CG_MAX_GRID_Z ? zs : CG_MAX_GRID_Z));
  cohort_gemm_f64_kernel<<<grid, CG_THREADS, 0, st>>>(g);
  if (g.splits > 1) {
    const long long total = zs / g.splits * g.m * g.n;
    const long long blocks = (total + CG_THREADS - 1) / CG_THREADS;
    const unsigned rgrid = (unsigned)(blocks < 65535 * 16 ? blocks
                                                          : 65535 * 16);
    cohort_gemm_f64_reduce_kernel<<<rgrid, CG_THREADS, 0, st>>>(g);
  }
  return cudaGetLastError();
}

extern "C" int cohort_gemm_launch(const CohortGemm* g, void* stream) {
  if (g->m <= 0 || g->n <= 0 || g->k <= 0 || g->r <= 0 || g->z1 <= 0 ||
      g->z2 <= 0 || g->splits <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)g->z1 * g->z2 * g->splits > 0x7fffffffLL ||
      (long long)g->r * ((g->k + TG_BK - 1) / TG_BK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (g->f64) return (int)launch_f64(*g, st);
  if (g->splits > TG_MAX_SPLITS) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (g->bm * 1000 + g->bn) {
    case 64064: e = launch_tf32_ring<64, 64>(*g, st); break;
    case 64032: e = launch_tf32_ring<64, 32>(*g, st); break;
    case 32064: e = launch_tf32_ring<32, 64>(*g, st); break;
    case 32032: e = launch_tf32_ring<32, 32>(*g, st); break;
    case 16064: e = launch_tf32_ring<16, 64>(*g, st); break;
    case 16032: e = launch_tf32_ring<16, 32>(*g, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
