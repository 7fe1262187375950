// Mamdani inference shared by the standalone fuzzy_eval kernel and the
// finishing block of the fused probe_fuzzy kernel, so the two cannot
// drift apart (the TPU kernels share `mamdani_lanes` the same way:
// repro/kernels/fuzzy_eval.py:48, called from probe_fuzzy.py:135).
//
// Per participant: 4 variables x 3 Gaussian memberships, min over the 4
// antecedents of each rule, max into 9 output levels, centre of gravity
// over the level centers.  The rule table is data (packed by the Python
// wrapper from repro_torch/core/rules.py) and lives in shared memory;
// memberships and level maxima stay in registers (every index into them
// is resolved by unrolled selects, never by a dynamic array index).
#pragma once

#define MAMDANI_VARS 4
#define MAMDANI_LEVELS 3
#define MAMDANI_OUT 9
#define MAMDANI_MAX_RULES 128

// rule r packed as  t0 | t1 << 2 | t2 << 4 | t3 << 6 | level << 8
struct MamdaniTables {
  float means[MAMDANI_VARS * MAMDANI_LEVELS];
  float sigmas[MAMDANI_VARS * MAMDANI_LEVELS];
  float centers[MAMDANI_OUT];
  int rules[MAMDANI_MAX_RULES];
  int n_rules;
};

// All threads of the block call this, then __syncthreads().
__device__ inline void mamdani_load(MamdaniTables& t, const float* means,
                                    const float* sigmas,
                                    const float* centers, const int* rules,
                                    int n_rules) {
  for (int i = threadIdx.x; i < MAMDANI_VARS * MAMDANI_LEVELS;
       i += blockDim.x) {
    t.means[i] = means[i];
    t.sigmas[i] = sigmas[i];
  }
  for (int i = threadIdx.x; i < MAMDANI_OUT; i += blockDim.x)
    t.centers[i] = centers[i];
  for (int i = threadIdx.x; i < n_rules; i += blockDim.x)
    t.rules[i] = rules[i];
  if (threadIdx.x == 0) t.n_rules = n_rules;
}

__device__ inline float mamdani_pick(const float m[MAMDANI_LEVELS], int i) {
  return i == 0 ? m[0] : (i == 1 ? m[1] : m[2]);
}

// x: normalized [SQ, TA, CC, LF] in [0, 1] -> evaluation on the scale of
// the level centers.
__device__ inline float mamdani_eval(const float x[MAMDANI_VARS],
                                     const MamdaniTables& t) {
  float mu[MAMDANI_VARS][MAMDANI_LEVELS];
#pragma unroll
  for (int v = 0; v < MAMDANI_VARS; ++v) {
#pragma unroll
    for (int l = 0; l < MAMDANI_LEVELS; ++l) {
      float d = (x[v] - t.means[v * MAMDANI_LEVELS + l]) /
                t.sigmas[v * MAMDANI_LEVELS + l];
      mu[v][l] = expf(-0.5f * d * d);
    }
  }
  // firing strengths are >= 0, so 0 is the identity of the level max
  float beta[MAMDANI_OUT];
#pragma unroll
  for (int j = 0; j < MAMDANI_OUT; ++j) beta[j] = 0.0f;
  for (int r = 0; r < t.n_rules; ++r) {
    const int code = t.rules[r];
    float f = mamdani_pick(mu[0], code & 3);
    f = fminf(f, mamdani_pick(mu[1], (code >> 2) & 3));
    f = fminf(f, mamdani_pick(mu[2], (code >> 4) & 3));
    f = fminf(f, mamdani_pick(mu[3], (code >> 6) & 3));
    const int lv = code >> 8;
#pragma unroll
    for (int j = 0; j < MAMDANI_OUT; ++j)
      if (j == lv) beta[j] = fmaxf(beta[j], f);
  }
  // centre of gravity, summed in level order without FMA contraction
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int j = 0; j < MAMDANI_OUT; ++j) {
    num = __fadd_rn(num, __fmul_rn(t.centers[j], beta[j]));
    den = __fadd_rn(den, beta[j]);
  }
  return num / fmaxf(den, 1e-9f);
}
