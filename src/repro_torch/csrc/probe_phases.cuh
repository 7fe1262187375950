// Phases 1-4 of the packed Eq. 7 probe on Hopper, shared by the fused
// probe -> Eq. 8 -> Mamdani kernel (probe_fuzzy.cu) and the probe alone
// (probe_loss.cu), so that the two cannot drift apart.
//
// They replace the probe half of repro/kernels/probe_fuzzy.py (the TPU
// kernels' `_block_losses` :72 and `_accumulate` :95).  The TPU walks a
// sequential grid and carries the per-client loss sums in VMEM scratch
// from one step to the next; CUDA blocks run in no order, so the work is
// split into launches on one stream, each a phase whose output the next
// one reads:
//
//   1. conv:   one block per probe sample.  conv5x5 1->32, ReLU, 2x2 pool
//              into a zero-padded 18x18x32 tile in shared memory, then
//              conv5x5 32->64, ReLU, 2x2 pool.  The 205 KB conv2 weight
//              does not fit beside the activation in one block's
//              shared memory, so it is staged 16 output channels at a
//              time.  The (S, 3136) activation is written in (h, w, c)
//              order: the NHWC flatten, which is the row order of fc1.
//   2. fc1:    a tiled fp32 GEMM (64x64 tiles, k-step 16) with bias and
//              ReLU, (S x 3136) . (3136 x 512); the 6.4 MB weight
//              streams through L2.
//   3. fc2:    one warp per sample: 10 logits, log-sum-exp, NLL.
//   4. sums:   each client's first and last row (integer atomicMin /
//              atomicMax, which give the same result in any order), then
//              one warp per client sums the losses of its rows in an
//              order set by the client's rows alone: lane j takes rows
//              first + j, first + j + 32, ..., then a butterfly.  No
//              float atomics, so results are bit-identical from run to
//              run, and a client's sum does not depend on where its rows
//              sit in the pack: the same rows at another offset (a shard
//              region of the client mesh) give the same bits.  Rows whose
//              seg is n_clients (the overflow lane: padding) reach no
//              client.
//
// Every phase computes a row independently of its position (fc1's tile
// sums over k in one order for every row), so a client's Eq. 7 sum is a
// function of its own rows only.
//
// Bound on the H100: ~24.5 MFLOP per sample (conv1 1.25, conv2 20.1,
// fc1 3.2) against ~3 KB of input per sample, so the probe is bound by
// fp32 operations (no tensor cores: the reference is fp32).  This first
// version is simple CUDA-core code: conv2 keeps a 4-channel x 2x2-pixel
// register tile per thread over a 6x6 input patch, and fc1 a 4x4 tile.
// wgmma/TMA (TF32 or split-precision) are later work.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// the paper's CNN (repro_torch/configs/mnist_cnn.py), fixed at compile time
#define IMG 28
#define KS 5
#define C1 32
#define C2 64
#define P1 14          // after pool 1
#define P2 7           // after pool 2
#define PAD1 (IMG + 4) // conv1 input, zero-padded by 2
#define PAD2 (P1 + 4)  // conv2 input, zero-padded by 2
#define FLAT (P2 * P2 * C2)  // 3136
#define HID 512
#define NCLS 10

#define CONV_THREADS 256
#define CO_CHUNK 16    // conv2 output channels staged per pass

// shared-memory carve-up of the conv kernel, in floats
#define SM_IN1 0
#define SM_W1 (SM_IN1 + PAD1 * PAD1)
#define SM_B1 (SM_W1 + C1 * KS * KS)
#define SM_B2 (SM_B1 + C1)
#define SM_H1 (SM_B2 + C2)
#define SM_W2 (SM_H1 + C1 * PAD2 * PAD2)
#define SM_FLOATS (SM_W2 + CO_CHUNK * C1 * KS * KS)

__global__ void __launch_bounds__(CONV_THREADS)
probe_conv_kernel(const float* __restrict__ images,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ act) {
  extern __shared__ float sm[];
  float* in1 = sm + SM_IN1;
  float* w1s = sm + SM_W1;
  float* b1s = sm + SM_B1;
  float* b2s = sm + SM_B2;
  float* h1 = sm + SM_H1;
  float* w2c = sm + SM_W2;
  const int tid = threadIdx.x;
  const long s = blockIdx.x;
  const float* img = images + s * (IMG * IMG);

  for (int i = tid; i < PAD1 * PAD1; i += blockDim.x) {
    const int y = i / PAD1 - 2, x = i % PAD1 - 2;
    in1[i] = (y >= 0 && y < IMG && x >= 0 && x < IMG) ? img[y * IMG + x]
                                                      : 0.0f;
  }
  for (int i = tid; i < C1 * KS * KS; i += blockDim.x) w1s[i] = w1[i];
  for (int i = tid; i < C1; i += blockDim.x) b1s[i] = b1[i];
  for (int i = tid; i < C2; i += blockDim.x) b2s[i] = b2[i];
  for (int i = tid; i < C1 * PAD2 * PAD2; i += blockDim.x) h1[i] = 0.0f;
  __syncthreads();

  // conv1 + bias + ReLU + pool: max of the 2x2 pre-activations, then
  // bias and ReLU (both monotone, so the order is exact)
  for (int o = tid; o < C1 * P1 * P1; o += blockDim.x) {
    const int c = o / (P1 * P1), q = o % (P1 * P1);
    const int py = q / P1, px = q % P1;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const float w = w1s[c * KS * KS + ky * KS + kx];
        const float* r0 = in1 + (2 * py + ky) * PAD1 + 2 * px + kx;
        a00 += w * r0[0];
        a01 += w * r0[1];
        a10 += w * r0[PAD1];
        a11 += w * r0[PAD1 + 1];
      }
    }
    const float m = fmaxf(fmaxf(a00, a01), fmaxf(a10, a11)) + b1s[c];
    h1[c * PAD2 * PAD2 + (py + 2) * PAD2 + (px + 2)] = fmaxf(m, 0.0f);
  }

  // conv2 + bias + ReLU + pool, CO_CHUNK output channels per pass.
  // Thread t < 196: pooled position q = t % 49, channel quad g = t / 49.
  const int q = tid % (P2 * P2), g = tid / (P2 * P2);
  const int py = q / P2, px = q % P2;
  for (int c0 = 0; c0 < C2; c0 += CO_CHUNK) {
    __syncthreads();   // h1 complete / previous chunk's weights consumed
    const float* wsrc = w2 + (long)c0 * C1 * KS * KS;
    for (int i = tid; i < CO_CHUNK * C1 * KS * KS; i += blockDim.x)
      w2c[i] = wsrc[i];
    __syncthreads();
    if (tid < 4 * P2 * P2) {
      float acc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[c][k] = 0.0f;
      for (int ci = 0; ci < C1; ++ci) {
        float patch[6][6];
        const float* src = h1 + ci * PAD2 * PAD2 + (2 * py) * PAD2 + 2 * px;
#pragma unroll
        for (int dy = 0; dy < 6; ++dy)
#pragma unroll
          for (int dx = 0; dx < 6; ++dx) patch[dy][dx] = src[dy * PAD2 + dx];
        const float* wc = w2c + (g * 4) * C1 * KS * KS + ci * KS * KS;
#pragma unroll
        for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < KS; ++kx) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float w = wc[c * C1 * KS * KS + ky * KS + kx];
              acc[c][0] += w * patch[ky][kx];
              acc[c][1] += w * patch[ky][kx + 1];
              acc[c][2] += w * patch[ky + 1][kx];
              acc[c][3] += w * patch[ky + 1][kx + 1];
            }
          }
        }
      }
      float* dst = act + s * FLAT + q * C2 + c0 + g * 4;   // (h, w, c)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float m = fmaxf(fmaxf(acc[c][0], acc[c][1]),
                              fmaxf(acc[c][2], acc[c][3])) +
                        b2s[c0 + g * 4 + c];
        dst[c] = fmaxf(m, 0.0f);
      }
    }
  }
}

// fc1: hidden[s][o] = relu(sum_k act[s][k] * w[o][k] + b[o]).  Both
// operands are k-contiguous; tiles are stored k-major in shared memory.
#define GM 64
#define GN 64
#define GK 16

__global__ void __launch_bounds__(256)
fc1_kernel(const float* __restrict__ a, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ h, int s_rows) {
  __shared__ float as[GK][GM + 4];
  __shared__ float bs[GK][GN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GM, col0 = blockIdx.x * GN;
  const int lr = tid / 4, lk = (tid % 4) * 4;   // loader: row, k offset
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < FLAT; k0 += GK) {
    const int ar = row0 + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ar < s_rows)
      av = *reinterpret_cast<const float4*>(a + (long)ar * FLAT + k0 + lk);
    const float4 bv = *reinterpret_cast<const float4*>(
        w + (long)(col0 + lr) * FLAT + k0 + lk);
    as[lk + 0][lr] = av.x; as[lk + 1][lr] = av.y;
    as[lk + 2][lr] = av.z; as[lk + 3][lr] = av.w;
    bs[lk + 0][lr] = bv.x; bs[lk + 1][lr] = bv.y;
    bs[lk + 2][lr] = bv.z; bs[lk + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ra[i] * rb[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= s_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      h[(long)r * HID + c] = fmaxf(acc[i][j] + bias[c], 0.0f);
    }
  }
}

// fc2 + log-sum-exp + NLL, one warp per sample
__global__ void __launch_bounds__(256)
fc2_nll_kernel(const float* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ bias, const int* __restrict__ labels,
               float* __restrict__ losses, int s_rows) {
  const int lane = threadIdx.x & 31;
  const long s = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (s >= s_rows) return;
  float part[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) part[c] = 0.0f;
  for (int k = lane; k < HID; k += 32) {
    const float x = h[s * HID + k];
#pragma unroll
    for (int c = 0; c < NCLS; ++c) part[c] += x * w[c * HID + k];
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  if (lane == 0) {
    float zmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      part[c] += bias[c];
      zmax = fmaxf(zmax, part[c]);
    }
    float se = 0.0f, gold = 0.0f;
    const int lb = labels[s];
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      se += expf(part[c] - zmax);
      if (c == lb) gold = part[c];
    }
    losses[s] = zmax + logf(se) - gold;
  }
}

// phase 4a: each client's first and last row; first starts at INT_MAX
// and last at -1 (the launcher's memsets), so a client with no rows
// keeps first > last
__global__ void __launch_bounds__(256)
client_span_kernel(const int* __restrict__ seg, int s_rows, int n_clients,
                   int* __restrict__ first, int* __restrict__ last) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_rows) return;
  const int c = seg[s];
  if (c < 0 || c >= n_clients) return;        // padding: the overflow lane
  atomicMin(first + c, s);
  atomicMax(last + c, s);
}

// phase 4b: per-client loss sums, one warp per client; lane j takes the
// client's rows first + j + 32 i
__global__ void __launch_bounds__(256)
client_sum_kernel(const float* __restrict__ losses,
                  const int* __restrict__ seg, int n_clients,
                  const int* __restrict__ first,
                  const int* __restrict__ last, float* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= n_clients) return;
  const int lo = first[c], hi = last[c];
  float acc = 0.0f;
  for (int s = lo + lane; s <= hi; s += 32)
    if (seg[s] == c) acc += losses[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) sums[c] = acc;
}

// Phases 1-4 on one stream: packed samples in, (N,) per-client loss sums
// out.  Scratch: act (S, 3136), hidden (S, 512), losses (S,), span (2N,)
// int32.  Returns a cudaError_t.
static int probe_phases_run(const void* images, const void* labels,
                            const void* seg, int s_rows, int n_clients,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* f1w, const void* f1b,
                            const void* f2w, const void* f2b, void* act,
                            void* hidden, void* losses, void* span,
                            void* sums, cudaStream_t st) {
  const int conv_smem = SM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      conv_smem);
  if (err != cudaSuccess) return (int)err;

  probe_conv_kernel<<<s_rows, CONV_THREADS, conv_smem, st>>>(
      (const float*)images, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (float*)act);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 g1(HID / GN, (s_rows + GM - 1) / GM);
  fc1_kernel<<<g1, 256, 0, st>>>((const float*)act, (const float*)f1w,
                                 (const float*)f1b, (float*)hidden, s_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fc2_nll_kernel<<<(s_rows + 7) / 8, 256, 0, st>>>(
      (const float*)hidden, (const float*)f2w, (const float*)f2b,
      (const int*)labels, (float*)losses, s_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int* first = (int*)span;
  int* last = first + n_clients;
  if ((err = cudaMemsetAsync(first, 0x7f, n_clients * sizeof(int), st)) !=
      cudaSuccess)
    return (int)err;                          // 0x7f7f7f7f > any row
  if ((err = cudaMemsetAsync(last, 0xff, n_clients * sizeof(int), st)) !=
      cudaSuccess)
    return (int)err;                          // -1
  client_span_kernel<<<(s_rows + 255) / 256, 256, 0, st>>>(
      (const int*)seg, s_rows, n_clients, first, last);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  client_sum_kernel<<<(n_clients + 7) / 8, 256, 0, st>>>(
      (const float*)losses, (const int*)seg, n_clients, first, last,
      (float*)sums);
  return (int)cudaGetLastError();
}
