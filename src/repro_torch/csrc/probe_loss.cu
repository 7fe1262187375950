// The packed Eq. 7 probe alone, for Hopper: (N,) per-client mean losses.
//
// Replaces repro/kernels/probe_fuzzy.py::probe_loss_pallas (pallas_call
// at :213; body `_loss_kernel` :140).  The client mesh's sharded prefix
// runs it on each rank's probe region; the all-reduce that merges the
// ranks' loss lanes stays outside the kernel, as the TPU's psum did.
// Phases 0-4 are probe_phases.cuh, shared with the fused kernel
// (probe_fuzzy.cu), so its per-client sums are the fused kernel's bit for
// bit; phase 5 here is the Eq. 7 mean alone, with the fused kernel's
// arithmetic (sum / max(count, 1)), so the two give the same LF bits.
// Phase 4 sums each client's rows in an order set by its rows alone, so
// a client's LF is the same wherever its rows sit in a region.
//
// One launch takes n_seeds seeds (the sweep's seed-batched prefix on the
// client mesh, as the reference's vmap over seeds inside its shard_map
// gives probe_loss_pallas a seed axis): every operand is seed-major, the
// phases take blockIdx.z as the seed and the mean runs over seeds x N
// lanes, each elementwise, so each seed's row is bit-equal to a launch of
// that seed alone.
//
// Bound: the probe's operations, ~24.5 MFLOP per sample against ~3 KB of
// input, conv2 and fc1 as 3 TF32 passes on the tensor cores
// (probe_phases.cuh).
#include "probe_phases.cuh"

__global__ void __launch_bounds__(256)
client_mean_kernel(const float* __restrict__ sums,
                   const int* __restrict__ counts, long lanes,
                   float* __restrict__ lf) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < lanes) lf[i] = sums[i] / fmaxf((float)counts[i], 1.0f);
}

extern "C" int probe_loss_launch(
    int n_seeds, const void* images, const void* labels, const void* seg, int s_rows,
    const void* counts, int n_clients, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* f1w, const void* f1b,
    const void* f2w, const void* f2b, void* wsplit, void* act,
    void* hidden,
    void* losses, void* span, void* sums, void* lf, void* stream) {
  if (s_rows <= 0 || n_clients <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = probe_phases_run(n_seeds, images, labels, seg, s_rows, n_clients, w1, b1,
                             w2, b2, f1w, f1b, f2w, f2b, wsplit, act, hidden,
                             losses, span, sums, st);
  if (err != 0) return err;
  const long lanes = (long)n_seeds * n_clients;
  client_mean_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
      (const float*)sums, (const int*)counts, lanes, (float*)lf);
  return (int)cudaGetLastError();
}
