// Batched Mamdani fuzzy evaluation (paper §5.3) for Hopper.
//
// Replaces repro/kernels/fuzzy_eval.py::fuzzy_eval_pallas (pallas_call at
// :125, inference core `mamdani_lanes` at :48).
//
// Bound on the H100: per participant 16 bytes in and 4 bytes out against
// ~430 scalar operations (12 exp, 324 min/max, the COG, Eq. 8), so the
// kernel sits near the ridge of the fp32 non-tensor-core roofline:
// bytes and operations give about the same least time.  On its paths P
// is 30 (the fast profile's unfused prefix) to 4096 (the large fleet on
// the client mesh), where a launch costs more than that work.
// Design: one launch whatever `normalize` is.
// - Eq. 8's column maxima and the evaluation are one kernel.  A small
//   grid (rows x CTAs up to 2^20: P = 4096 over 128 CTAs) has every CTA
//   fold all rows' maxima itself, with no barrier between CTAs.  A
//   larger one is a cooperative launch, its grid no larger than the
//   CTAs the card holds at once: each CTA folds the rows it strides
//   over, writes them to scratch, grid.sync(), and every CTA folds the
//   CTAs' maxima with all its threads.  max is exact in any order, so
//   every CTA reaches the same reciprocals, bit for bit, as the TPU
//   kernel's pre-pass (fuzzy_eval.py:87).
// - The rules come sorted by output level, with each level's first
//   rule (the wrapper packs them once), so a level's maximum is a loop
//   of its own into a register, never a select over 9 levels.  A
//   thread stages the 9 pairwise minima of (SQ, TA) and of (CC, LF) in
//   its own column of shared memory, and a rule is two loads, a min and
//   a max.  min and max are exact in any order and grouping, so this is
//   mamdani_eval's arithmetic (mamdani.cuh: memberships, COG) bit for
//   bit; the mesh check in chip_smoke.py holds these evaluations equal
//   to probe_fuzzy's, which runs mamdani_eval.
// - A participant's rules may be split among `split` warps (1, 2, 4 or
//   8): a warp takes every split-th rule of each level, and the group's
//   first warp folds the others' level maxima through shared memory
//   with fmaxf before the COG.  At small P this shortens a
//   participant's chain of 81 rules, which bounds the kernel's latency;
//   at large P split is 1 and every thread takes a participant.
// - A row comes in one 16-byte load; memberships and level maxima stay
//   in registers.
// - Seeds (the multi-seed sweep on the client mesh, as the reference's
//   vmap over seeds gives fuzzy_eval_pallas a leading axis): x (seeds, P,
//   4) in one launch, blockIdx.y the seed, each seed scaled by its own
//   Eq. 8 maxima (its own rows', or its row of external maxima).  max is
//   exact and a split only regroups the rules' max, so each seed's
//   evaluations are bit-equal to a launch of that seed alone.
// - External maxima (normalize 3; the client mesh's all-reduced ones):
//   x / max(maxima, 1e-9) clipped to [0, 1], a division as the fused
//   kernels' finish divides, so the evaluations are theirs bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mamdani.cuh"

#define FE_THREADS 256
#define FE_WARPS (FE_THREADS / 32)
#define FE_MAX_SPLIT 8
// rows x CTAs up to which each CTA folds all the maxima itself (16 MB
// of L2 reads over the grid) instead of a grid-wide barrier
#define FE_REDUNDANT_READS (1 << 20)

namespace cg = cooperative_groups;

// the 9 minima of variables 0 and 1, then of 2 and 3, by level index
// t_lo + 3 t_hi, one column a thread
#define FE_PAIRS (2 * MAMDANI_LEVELS * MAMDANI_LEVELS)

__global__ void __launch_bounds__(FE_THREADS)
fuzzy_eval_kernel(const float4* __restrict__ x, int p, int normalize,
                  int split, float* __restrict__ partial,
                  const float* __restrict__ colmax,
                  const float* __restrict__ means,
                  const float* __restrict__ sigmas,
                  const float* __restrict__ centers,
                  const int* __restrict__ rules, int n_rules,
                  float* __restrict__ out) {
  __shared__ MamdaniTables tab;
  __shared__ int2 pair_at[MAMDANI_MAX_RULES];   // a rule's two rows below
  __shared__ int level_at[MAMDANI_OUT + 1];     // each level's first rule
  __shared__ float red[4][FE_WARPS];
  // Eq. 8's reciprocal maxima (normalize 1, 2), or the external maxima
  // themselves (normalize 3, which divides)
  __shared__ float inv_max[4];
  // the pairwise minima, then (once the rules are done) the split
  // warps' level maxima
  __shared__ float pairs[FE_PAIRS][FE_THREADS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long seed = blockIdx.y;
  x += seed * p;
  out += seed * p;
  // the memberships' and COG's tables; the rules go to pair_at instead
  mamdani_load(tab, means, sigmas, centers, rules, 0);
  for (int r = threadIdx.x; r < n_rules; r += FE_THREADS) {
    const int code = rules[r];
    pair_at[r] = make_int2(
        ((code & 3) + 3 * ((code >> 2) & 3)) * FE_THREADS,
        (MAMDANI_LEVELS * MAMDANI_LEVELS + ((code >> 4) & 3) +
         3 * ((code >> 6) & 3)) * FE_THREADS);
  }
  if (threadIdx.x <= MAMDANI_OUT)
    level_at[threadIdx.x] = rules[n_rules + threadIdx.x];
  if (normalize == 3) {
    if (threadIdx.x < 4)
      inv_max[threadIdx.x] = fmaxf(colmax[seed * 4 + threadIdx.x], 1e-9f);
  } else if (normalize) {
    // normalize 2: every CTA folds every row's maxima itself (a small
    // grid, where the rows are cheaper to read again than a grid-wide
    // barrier); 1: the rows this CTA strides over, then the CTAs'
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    const int first = normalize == 2 ? 0 : blockIdx.x * FE_THREADS;
    const int stride = normalize == 2 ? FE_THREADS : gridDim.x * FE_THREADS;
    for (int i = first + threadIdx.x; i < p; i += stride) {
      const float4 r = x[i];
      m[0] = fmaxf(m[0], r.x); m[1] = fmaxf(m[1], r.y);
      m[2] = fmaxf(m[2], r.z); m[3] = fmaxf(m[3], r.w);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m[v] = fmaxf(m[v], __shfl_xor_sync(0xffffffffu, m[v], o));
      if (lane == 0) red[v][warp] = m[v];
    }
    __syncthreads();
    float mv = -INFINITY;
    if (threadIdx.x < 4) {
      mv = red[threadIdx.x][0];
      for (int w = 1; w < FE_WARPS; ++w) mv = fmaxf(mv, red[threadIdx.x][w]);
    }
    if (normalize == 1 && gridDim.x > 1) {
      float* mine = partial + seed * gridDim.x * 4;
      if (threadIdx.x < 4) mine[blockIdx.x * 4 + threadIdx.x] = mv;
      cg::this_grid().sync();
      // the seed's CTAs' maxima, column t % 4 in thread t, folded over
      // the lanes of a column and then the warps
      mv = -INFINITY;
      for (int i = threadIdx.x; i < (int)gridDim.x * 4; i += FE_THREADS)
        mv = fmaxf(mv, mine[i]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
      __syncthreads();                // red is read above
      if (lane < 4) red[lane][warp] = mv;
      __syncthreads();
      if (threadIdx.x < 4) {
        mv = red[threadIdx.x][0];
        for (int w = 1; w < FE_WARPS; ++w)
          mv = fmaxf(mv, red[threadIdx.x][w]);
      }
    }
    if (threadIdx.x < 4) inv_max[threadIdx.x] = 1.0f / fmaxf(mv, 1e-9f);
  }
  __syncthreads();
  // a CTA's row groups of 32 participants, `split` warps to a group
  const int groups = FE_WARPS / split;
  const int slice = warp % split;
  const int lead = warp - slice;
  float* col = &pairs[0][threadIdx.x];
  for (int base = blockIdx.x * groups * 32; base < p;
       base += gridDim.x * groups * 32) {
    const int i = base + (warp / split) * 32 + lane;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (i < p) {
      const float4 r = x[i];
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
      if (normalize == 3) {           // external maxima: divide
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = fminf(fmaxf(v[k] / inv_max[k], 0.0f), 1.0f);
      } else if (normalize) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = fminf(fmaxf(v[k] * inv_max[k], 0.0f), 1.0f);
      }
    }
    float mu[MAMDANI_VARS][MAMDANI_LEVELS];
    mamdani_memberships(v, tab, mu);
#pragma unroll
    for (int hi = 0; hi < MAMDANI_LEVELS; ++hi) {
#pragma unroll
      for (int lo = 0; lo < MAMDANI_LEVELS; ++lo) {
        col[(lo + 3 * hi) * FE_THREADS] = fminf(mu[0][lo], mu[1][hi]);
        col[(9 + lo + 3 * hi) * FE_THREADS] = fminf(mu[2][lo], mu[3][hi]);
      }
    }
    // firing strengths are >= 0, so 0 is the identity of a level max
    float beta[MAMDANI_OUT];
#pragma unroll
    for (int j = 0; j < MAMDANI_OUT; ++j) {
      float b = 0.0f;
      for (int r = level_at[j] + slice; r < level_at[j + 1]; r += split) {
        const int2 at = pair_at[r];
        b = fmaxf(b, fminf(col[at.x], col[at.y]));
      }
      beta[j] = b;
    }
    if (split > 1) {
      __syncthreads();                // every warp is done with `pairs`
      float* part = &pairs[0][0];
#pragma unroll
      for (int j = 0; j < MAMDANI_OUT; ++j)
        part[(warp * MAMDANI_OUT + j) * 32 + lane] = beta[j];
      __syncthreads();
      if (slice == 0) {
        for (int s = 1; s < split; ++s) {
#pragma unroll
          for (int j = 0; j < MAMDANI_OUT; ++j)
            beta[j] = fmaxf(beta[j],
                            part[((lead + s) * MAMDANI_OUT + j) * 32 + lane]);
        }
      }
      __syncthreads();                // before the next round's pairs
    }
    if (slice == 0 && i < p) out[i] = mamdani_cog(beta, tab);
  }
}

// CTAs of fuzzy_eval_kernel the card holds at once (the cooperative
// launch's limit), per device, queried once
static int resident_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fuzzy_eval_kernel, FE_THREADS, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// floats of scratch the caller allocates once per device: 4 column
// maxima for each CTA a cooperative launch may have
extern "C" int fuzzy_eval_scratch_floats(void) { return 4 * resident_ctas(); }

// A launch's operands that stay from call to call, in host memory: the
// wrapper fills one per set of Mamdani tensors and stream, so a call
// passes six arguments, not eleven
struct FuzzyOperands {
  const float* means;
  const float* sigmas;
  const float* centers;
  const int* rules;          // by level, then the level starts
  int n_rules;
  float* partial;            // fuzzy_eval_scratch_floats() floats
};

// normalize: 0 none, 1 each seed's own column maxima, 3 the external
// maxima `colmax` (seeds, 4); x (seeds, P, 4), out (seeds, P)
extern "C" int fuzzy_eval_launch(const void* x, int p, int seeds,
                                 int normalize, const void* colmax,
                                 const FuzzyOperands* ops, void* out,
                                 void* stream) {
  int n_rules = ops->n_rules;
  if (p <= 0 || seeds <= 0 || seeds > 65535 || n_rules <= 0 ||
      n_rules > MAMDANI_MAX_RULES || (normalize == 3 && colmax == nullptr) ||
      normalize < 0 || normalize > 3 || normalize == 2)
    return (int)cudaErrorInvalidValue;
  const int resident = resident_ctas();
  if (resident <= 0) return (int)cudaErrorInvalidDevice;
  // split a participant's rules while the card has threads to spare
  int split = 1;
  while (split < FE_MAX_SPLIT && (long long)p * seeds * split * 2 <=
                                     (long long)resident * FE_THREADS)
    split *= 2;
  const int rows_per_cta = 32 * (FE_WARPS / split);
  const int needed = (p + rows_per_cta - 1) / rows_per_cta;
  // a seed's CTAs: all the seeds' together within what the card holds
  // at once (the cooperative launch's limit)
  const int per_seed = resident / seeds > 0 ? resident / seeds : 1;
  int grid = needed < per_seed ? needed : per_seed;
  cudaStream_t st = (cudaStream_t)stream;
  const float4* xv = (const float4*)x;
  float* part = ops->partial;
  const float* mp = ops->means;
  const float* sp = ops->sigmas;
  const float* cp = ops->centers;
  const int* rp = ops->rules;
  const float* cm = (const float*)colmax;
  float* op = (float*)out;
  if (normalize == 1 && grid > 1 &&
      (long long)p * grid <= (long long)FE_REDUNDANT_READS)
    normalize = 2;
  if (normalize == 1 && grid > 1) {
    void* args[] = {(void*)&xv, (void*)&p, (void*)&normalize,
                    (void*)&split, (void*)&part, (void*)&cm, (void*)&mp,
                    (void*)&sp, (void*)&cp, (void*)&rp, (void*)&n_rules,
                    (void*)&op};
    return (int)cudaLaunchCooperativeKernel((const void*)fuzzy_eval_kernel,
                                            dim3(grid, seeds),
                                            dim3(FE_THREADS), args, 0, st);
  }
  fuzzy_eval_kernel<<<dim3(grid, seeds), FE_THREADS, 0, st>>>(
      xv, p, normalize, split, part, cm, mp, sp, cp, rp, n_rules, op);
  return (int)cudaGetLastError();
}
