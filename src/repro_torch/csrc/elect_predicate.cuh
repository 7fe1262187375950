// The DCS better-neighbour predicate (paper Alg. 1), shared by the dense
// election (neighbor_elect.cu) and the windowed counts
// (windowed_counts.cu) so the two kernels cannot drift apart.
//
// Candidate j counts against vehicle i iff it is in DSRC range
// (|p_i - p_j| <= comm_range), at or above E_tau, a real vehicle
// (g_j < n_valid: sentinel padding carries g_j >= n_valid), and strictly
// better: a higher evaluation, or an equal one with the lower global id.
// Every compare is fp32 against fp32 thresholds, as the reference's
// jnp / Pallas kernels compare, so the integer counts are bit-equal to
// the plain versions at d == comm_range and on tied evaluations.
#pragma once

#include <math.h>

__device__ __forceinline__ int elect_better(float pi, float ei, int gi,
                                            float pj, float ej, int gj,
                                            float comm_range, float e_tau,
                                            int n_valid) {
  const float d = fabsf(pi - pj);
  const bool ok = (d <= comm_range) && (ej >= e_tau) && (gj < n_valid);
  const bool better = (ej > ei) || ((ej == ei) && (gj < gi));
  return (ok && better) ? 1 : 0;
}
