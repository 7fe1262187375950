// Fused Eq. 7 probe -> Eq. 8 -> Mamdani evaluation for Hopper.
//
// Replaces repro/kernels/probe_fuzzy.py::probe_fuzzy_pallas (pallas_call
// at :254; body `_fused_kernel` :103).  Phases 0-4 (weight split, conv,
// fc1, fc2 + NLL, the per-client loss sums) are probe_phases.cuh, shared
// with the probe alone (probe_loss.cu); this file adds the sixth:
//
//   5. finish: one block a seed: Eq. 7 mean over max(count, 1), the raw
//              features [SQ, TA, CC, LF], Eq. 8 maxima over the seed's own
//              real clients (or external column maxima), feats /
//              max(maxima, 1e-9) clipped to [0, 1] -- a division, as
//              probe_fuzzy.py:134 divides -- and the shared Mamdani device
//              function.
//
// One launch takes n_seeds seeds (the multi-seed sweep's seed-batched
// prefix, as the reference's vmap gives probe_fuzzy_pallas a leading grid
// axis over seeds): every operand but the Mamdani tables is seed-major,
// each phase takes blockIdx.z (the finish blockIdx.x) as the seed, and
// each seed's results are bit-equal to a launch of that seed alone.
//
// Bound: the probe's operations, conv2 and fc1 as 3 TF32 passes on the
// tensor cores (probe_phases.cuh).
#include "probe_phases.cuh"
#include "mamdani.cuh"

#define FIN_THREADS 256

__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const float* __restrict__ sums, const int* __restrict__ counts,
              const float* __restrict__ aux, const float* __restrict__ colmax,
              int n_clients, const float* __restrict__ means,
              const float* __restrict__ sigmas,
              const float* __restrict__ centers,
              const int* __restrict__ rules, int n_rules,
              float* __restrict__ feats, float* __restrict__ evals) {
  const long z = blockIdx.x;                 // the seed: its own maxima
  sums += z * n_clients;
  counts += z * n_clients;
  aux += z * n_clients * 3;
  if (colmax != nullptr) colmax += z * 4;
  feats += z * n_clients * 4;
  evals += z * n_clients;
  __shared__ MamdaniTables tab;
  __shared__ float red[4][FIN_THREADS];
  __shared__ float maxima[4];
  mamdani_load(tab, means, sigmas, centers, rules, n_rules);
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n_clients; i += blockDim.x) {
    const float lf = sums[i] / fmaxf((float)counts[i], 1.0f);   // Eq. 7
    float f[4] = {aux[i * 3 + 0], aux[i * 3 + 1], aux[i * 3 + 2], lf};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      feats[i * 4 + v] = f[v];
      m[v] = fmaxf(m[v], f[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) red[v][threadIdx.x] = m[v];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[v][threadIdx.x] = fmaxf(red[v][threadIdx.x],
                                    red[v][threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 4)                       // Eq. 8 denominators
    maxima[threadIdx.x] = fmaxf(
        colmax != nullptr ? colmax[threadIdx.x] : red[threadIdx.x][0],
        1e-9f);
  __syncthreads();
  for (int i = threadIdx.x; i < n_clients; i += blockDim.x) {
    float x[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      x[v] = fminf(fmaxf(feats[i * 4 + v] / maxima[v], 0.0f), 1.0f);
    evals[i] = mamdani_eval(x, tab);
  }
}

extern "C" int probe_fuzzy_launch(
    int n_seeds, const void* images, const void* labels, const void* seg,
    int s_rows, const void* counts, const void* aux, const void* colmax, int n_clients,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* f1w, const void* f1b, const void* f2w, const void* f2b,
    const void* means, const void* sigmas, const void* centers,
    const void* rules, int n_rules, void* wsplit, void* act, void* hidden,
    void* losses,
    void* span, void* sums, void* feats, void* evals, void* stream) {
  if (s_rows <= 0 || n_clients <= 0 || n_rules <= 0 ||
      n_rules > MAMDANI_MAX_RULES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = probe_phases_run(n_seeds, images, labels, seg, s_rows,
                             n_clients, w1, b1, w2, b2, f1w, f1b, f2w, f2b,
                             wsplit, act, hidden, losses, span, sums, st);
  if (err != 0) return err;
  finish_kernel<<<n_seeds, FIN_THREADS, 0, st>>>(
      (const float*)sums, (const int*)counts, (const float*)aux,
      (const float*)colmax, n_clients, (const float*)means,
      (const float*)sigmas, (const float*)centers, (const int*)rules,
      n_rules, (float*)feats, (float*)evals);
  return (int)cudaGetLastError();
}
