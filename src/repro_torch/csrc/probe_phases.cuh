// Phases 0-4 of the packed Eq. 7 probe on Hopper, shared by the fused
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
//   0. split:  the conv2 and fc1 weights as TF32 hi and lo parts
//              (hopper_mma.cuh::tf32_split), conv2's reordered to
//              (out, tap, in) so that a 32-wide k chunk is one tap.
//   1. conv:   PROBE_NS (2) samples per block.  conv5x5 1->32, ReLU, 2x2
//              pool on CUDA cores into zero-padded 18x18 tiles, channels
//              last, in shared memory; then conv5x5 32->64 as an implicit
//              GEMM on the tensor cores: M = the block's 196 pre-pool
//              pixels a sample, N = 64, K = 25 taps x 32 channels.  Two
//              warpgroups hold 4 and 3 tiles of 64 rows (16 pooled
//              outputs: a 2x2 window's pixels sit on rows l/4 and l/4 + 8
//              of two lanes 4 apart), gather their A fragments from the
//              tiles straight into registers and split them there; the
//              weight's hi and lo parts stream through a 3-stage ring
//              (cp.async), one tap per stage, once per block.  Epilogue:
//              max of the window's pre-activations (one shuffle), then
//              bias and ReLU, as the TPU kernel pools.  The (S, 3136)
//              activation is written in (h, w, c) order: the NHWC
//              flatten, which is the row order of fc1.
//   2. fc1:    (S x 3136) . (3136 x 512) on the tensor cores, 128 x 128
//              block tiles, k chunks of 32 through a 3-stage ring
//              (cp.async): the activation fp32, split in registers; the
//              weight's hi and lo parts.  Bias and ReLU in the epilogue.
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
// The seed axis.  A multi-seed sweep probes S seeds' packs at once, as
// the reference's vmap over seeds gives its Pallas kernel a leading grid
// axis: every phase takes blockIdx.z as the seed and offsets each operand
// by the seed's stride (the pack's rows, the seed's weights, its scratch
// and its clients); within a seed the blocks, their arithmetic and its
// order are those of a launch of one seed, so each seed's results are
// bit-equal to that launch's.  Seeds share the launches, not data.
//
// Precision.  The reference probe is fp32, and the checks hold the
// kernels to fp32 results (losses within 1e-5 of scale): one TF32 pass
// keeps ~3 decimal digits, too few.  conv2 and fc1 run as 3xTF32: x =
// hi + lo with both parts TF32, and a hi b hi + a hi b lo + a lo b hi
// (the dropped lo lo term and the rounding of lo are ~2^-22 of a
// product).  The tensor cores' fp32 accumulation truncates, and summed
// over conv2's 100 and fc1's 392 k-steps in one accumulator its bias
// broke that tolerance on the card: so each k chunk of 32 (one tap in
// conv2) is summed on the tensor cores from zero, the small products
// first, and added to fp32 sums on CUDA cores (promoted accumulation).
// Every row's result is a function of that row alone: no split-K, no
// float atomics, one k order (tap-major in conv2, 0..3135 in fc1) for
// every row wherever it sits in a tile, so a client's Eq. 7 sum depends
// on its own rows only.
//
// Bound on the H100: ~24.5 MFLOP per sample (conv1 1.25, conv2 20.1,
// fc1 3.2, fc2 0.01) against ~3 KB of input per sample, so the probe is
// bound by operations.  As fp32 on CUDA cores (67 TFLOP/s) that is
// 0.366 us a sample; with conv2 and fc1 as 3 TF32 passes at 495 TFLOP/s
// and conv1 and fc2 on CUDA cores it is 0.160 us a sample, the bound
// this design is measured against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "hopper_mma.cuh"

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
#define K2 (C1 * KS * KS)    // conv2's K: 800

// phase 1: samples per block, 64-row tiles (16 pooled outputs each) and
// the tiles of each of the two warpgroups
#define PROBE_NS 2
#define CONV_TILES ((P2 * P2 * PROBE_NS + 15) / 16)
#define CONV_TPW ((CONV_TILES + 1) / 2)
#define CONV_THREADS 256
#define CPAD 36        // channel stride of a conv2 input pixel (floats)
#define H1_FLOATS (PAD2 * PAD2 * CPAD)
#define CONV_STAGES 3
#define CONV_STAGE_BYTES (2 * C2 * 128)   // hi and lo: 64 rows x 32 fp32

// shared-memory carve-up of the conv kernel, in bytes after the ring
#define CONV_H1 (CONV_STAGES * CONV_STAGE_BYTES)
#define CONV_IMG (CONV_H1 + PROBE_NS * H1_FLOATS * 4)
#define CONV_W1 (CONV_IMG + PROBE_NS * PAD1 * PAD1 * 4)
#define CONV_B1 (CONV_W1 + C1 * KS * KS * 4)
#define CONV_B2 (CONV_B1 + C1 * 4)
#define CONV_SMEM (CONV_B2 + C2 * 4 + 1024)   // + slack for 1024 alignment

// phase 0: w2s (2, 64, 800) with k = tap * 32 + in, then f1s (2, 512,
// 3136); part 0 is hi, part 1 lo; one such block a seed
#define WSPLIT_FLOATS (2 * C2 * K2 + 2 * HID * FLAT)

// a seed's stride in each weight of the CNN (stacked (S, ...) weights)
#define W1_FLOATS (C1 * KS * KS)
#define W2_FLOATS (C2 * K2)
#define F1W_FLOATS ((long)HID * FLAT)
#define F2W_FLOATS (NCLS * HID)

__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w2,
                     const float* __restrict__ f1w,
                     float* __restrict__ wsplit) {
  const long n2 = (long)C2 * K2, n1 = (long)HID * FLAT;
  const long z = blockIdx.z;                     // the seed
  w2 += z * W2_FLOATS;
  f1w += z * F1W_FLOATS;
  wsplit += z * (long)WSPLIT_FLOATS;
  float* w2s = wsplit;
  float* f1s = wsplit + 2 * n2;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n2 + n1;
       i += (long)gridDim.x * blockDim.x) {
    uint32_t hi, lo;
    if (i < n2) {
      const int o = (int)(i / K2), k = (int)(i % K2);
      tf32_split(w2[o * K2 + (k % C1) * KS * KS + k / C1], hi, lo);
      w2s[i] = __uint_as_float(hi);
      w2s[n2 + i] = __uint_as_float(lo);
    } else {
      const long j = i - n2;
      tf32_split(f1w[j], hi, lo);
      f1s[j] = __uint_as_float(hi);
      f1s[n1 + j] = __uint_as_float(lo);
    }
  }
}

__global__ void __launch_bounds__(CONV_THREADS, 1)
probe_conv_kernel(const float* __restrict__ images,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2s, const float* __restrict__ b2,
                  float* __restrict__ act, int s_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (ring - raw);
  float* h1 = (float*)(sm + CONV_H1);
  float* img = (float*)(sm + CONV_IMG);
  float* w1s = (float*)(sm + CONV_W1);
  float* b1s = (float*)(sm + CONV_B1);
  float* b2s = (float*)(sm + CONV_B2);
  const int tid = threadIdx.x;
  const long s0 = (long)blockIdx.x * PROBE_NS;
  const long z = blockIdx.z;                     // the seed
  images += z * s_rows * (IMG * IMG);
  w1 += z * W1_FLOATS;
  b1 += z * C1;
  w2s += z * (long)WSPLIT_FLOATS;
  b2 += z * C2;
  act += z * s_rows * FLAT;

  // one tap of the split conv2 weight: hi and lo, 64 rows x 32 fp32
  auto load_tap = [&](int tap, int stage) {
    for (int e = tid; e < 2 * C2 * 8; e += CONV_THREADS) {
      const int part = e / (C2 * 8), r = (e / 8) % C2, c = e % 8;
      cp_async16(ring + stage * CONV_STAGE_BYTES + part * (C2 * 128) +
                     swz(r, c),
                 w2s + (long)part * C2 * K2 + r * K2 + tap * C1 + c * 4,
                 true);
    }
  };
  load_tap(0, 0);
  cp_async_commit();
  load_tap(1, 1);
  cp_async_commit();

  for (int i = tid; i < PROBE_NS * PAD1 * PAD1; i += CONV_THREADS) {
    const int n = i / (PAD1 * PAD1), p = i % (PAD1 * PAD1);
    const int y = p / PAD1 - 2, x = p % PAD1 - 2;
    img[i] = (s0 + n < s_rows && y >= 0 && y < IMG && x >= 0 && x < IMG)
                 ? images[(s0 + n) * (IMG * IMG) + y * IMG + x]
                 : 0.0f;
  }
  for (int i = tid; i < C1 * KS * KS; i += CONV_THREADS) w1s[i] = w1[i];
  for (int i = tid; i < C1; i += CONV_THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C2; i += CONV_THREADS) b2s[i] = b2[i];
  for (int i = tid; i < PROBE_NS * H1_FLOATS; i += CONV_THREADS) h1[i] = 0.0f;
  __syncthreads();

  // conv1 + bias + ReLU + pool: max of the 2x2 pre-activations, then
  // bias and ReLU (both monotone, so the order is exact); channel
  // fastest across threads
  for (int o = tid; o < PROBE_NS * C1 * P1 * P1; o += CONV_THREADS) {
    const int c = o % C1, q = (o / C1) % (P1 * P1), n = o / (C1 * P1 * P1);
    const int py = q / P1, px = q % P1;
    const float* in1 = img + n * PAD1 * PAD1;
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
    h1[n * H1_FLOATS + ((py + 2) * PAD2 + px + 2) * CPAD + c] =
        fmaxf(m, 0.0f);
  }

  // conv2.  Tile T's row 16 w + g (g = lane / 4 < 8) of warp w is pixel
  // (2 py, 2 px + g % 2) of pooled output P = 16 T + 4 w + g / 2, row
  // 16 w + g + 8 the pixel below it.  rbase: this thread's row-g pixel
  // in h1, plus its channel offset l % 4.
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  int rbase[CONV_TPW];
#pragma unroll
  for (int t = 0; t < CONV_TPW; ++t) {
    int P = 16 * (wg * CONV_TPW + t) + 4 * wi + (g4 >> 1);
    if (P >= P2 * P2 * PROBE_NS) P = 0;          // a padding row
    const int n = P / (P2 * P2), q = P % (P2 * P2);
    const int y = 2 * (q / P2), x = 2 * (q % P2) + (g4 & 1);
    rbase[t] = n * H1_FLOATS + (y * PAD2 + x) * CPAD + t4;
  }
  float acc[CONV_TPW][32];      // fp32 sums over the taps so far
#pragma unroll
  for (int t = 0; t < CONV_TPW; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
  float part[32];                // one tap of one tile, on the tensor cores

  for (int tap = 0; tap < KS * KS; ++tap) {
    cp_async_wait<1>();        // this thread's copies of `tap` landed
    fence_proxy_async();
    __syncthreads();           // everyone's landed; tap - 1 consumed (and
                               // h1 complete, at tap 0)
    if (tap + 2 < KS * KS) load_tap(tap + 2, (tap + 2) % CONV_STAGES);
    cp_async_commit();
    const uint32_t bh = ring + (tap % CONV_STAGES) * CONV_STAGE_BYTES;
    const uint32_t bl = bh + C2 * 128;
    const float* src0 = h1 + ((tap / KS) * PAD2 + tap % KS) * CPAD;
#pragma unroll
    for (int t = 0; t < CONV_TPW; ++t) {
      if (wg * CONV_TPW + t >= CONV_TILES) continue;   // warpgroup-uniform
      // 4 k-steps of 8 channels: the small products first, then hi hi
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* src = src0 + rbase[t] + 8 * s;
        tf32_split(src[0], ah[s][0], al[s][0]);
        tf32_split(src[PAD2 * CPAD], ah[s][1], al[s][1]);
        tf32_split(src[4], ah[s][2], al[s][2]);
        tf32_split(src[PAD2 * CPAD + 4], ah[s][3], al[s][3]);
      }
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_tf32_rs_n64(part, ah[s], desc_kmajor(bl + s * 32), s > 0);
        wgmma_tf32_rs_n64(part, al[s], desc_kmajor(bh + s * 32), 1);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_tf32_rs_n64(part, ah[s], desc_kmajor(bh + s * 32), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] += part[i];
    }
  }

  // epilogue: window max (rows g and g + 8 here, lanes 4 apart), bias,
  // ReLU; the lane of the even g writes the pooled pixel's 64 channels
#pragma unroll
  for (int t = 0; t < CONV_TPW; ++t) {
    const int P = 16 * (wg * CONV_TPW + t) + 4 * wi + (g4 >> 1);
    const long smp = s0 + P / (P2 * P2);
    const bool store = (g4 & 1) == 0 && P < P2 * P2 * PROBE_NS &&
                       smp < s_rows;
    float* dst = act + smp * FLAT + (P % (P2 * P2)) * C2 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v0 = fmaxf(acc[t][4 * j], acc[t][4 * j + 2]);
      float v1 = fmaxf(acc[t][4 * j + 1], acc[t][4 * j + 3]);
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
      const int c = 8 * j + 2 * t4;
      if (store)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(fmaxf(v0 + b2s[c], 0.0f), fmaxf(v1 + b2s[c + 1], 0.0f));
    }
  }
}

// fc1: hidden[s][o] = relu(sum_k act[s][k] * w[o][k] + b[o]), 3xTF32.
// Both operands are k-contiguous; a stage holds a 128 x 32 fp32 tile of
// act and 128 x 32 tiles of the weight's hi and lo parts, swizzled.  Each
// warpgroup owns 64 rows x 128 columns; each k chunk of 32 is summed on
// the tensor cores, then added to the fp32 sums.
#define FC_BM 128
#define FC_BN 128
#define FC_KC 32
#define FC_STAGES 3
#define FC_A_BYTES (FC_BM * 128)
#define FC_B_BYTES (FC_BN * 128)
#define FC_STAGE_BYTES (FC_A_BYTES + 2 * FC_B_BYTES)
#define FC_SMEM (FC_STAGES * FC_STAGE_BYTES + 1024)

__global__ void __launch_bounds__(256, 1)
fc1_kernel(const float* __restrict__ a, const float* __restrict__ f1s,
           const float* __restrict__ bias, float* __restrict__ h,
           int s_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const unsigned char* sm = smem_raw + (ring - raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FC_BN;
  const long m0 = (long)blockIdx.y * FC_BM;
  const long z = blockIdx.z;                     // the seed
  a += z * s_rows * FLAT;
  f1s += z * (long)WSPLIT_FLOATS;
  bias += z * HID;
  h += z * s_rows * HID;

  auto load_chunk = [&](int kc, int stage) {
    const uint32_t st = ring + stage * FC_STAGE_BYTES;
    for (int e = tid; e < FC_BM * 8; e += 256) {
      const int r = e / 8, c = e % 8;
      const bool ok = m0 + r < s_rows;
      cp_async16(st + swz(r, c),
                 ok ? a + (m0 + r) * FLAT + kc * FC_KC + c * 4 : a, ok);
    }
    for (int e = tid; e < 2 * FC_BN * 8; e += 256) {
      const int part = e / (FC_BN * 8), r = (e / 8) % FC_BN, c = e % 8;
      cp_async16(st + FC_A_BYTES + part * FC_B_BYTES + swz(r, c),
                 f1s + (long)part * HID * FLAT + (long)(n0 + r) * FLAT +
                     kc * FC_KC + c * 4,
                 true);
    }
  };
  load_chunk(0, 0);
  cp_async_commit();
  load_chunk(1, 1);
  cp_async_commit();

  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int ra = wg * 64 + wi * 16 + g4;         // and ra + 8
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  constexpr int NKC = FLAT / FC_KC;              // 98
  for (int kc = 0; kc < NKC; ++kc) {
    const int stage = kc % FC_STAGES;
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (kc + 2 < NKC) load_chunk(kc + 2, (kc + 2) % FC_STAGES);
    cp_async_commit();
    const unsigned char* as = sm + stage * FC_STAGE_BYTES;
    const uint32_t bh = ring + stage * FC_STAGE_BYTES + FC_A_BYTES;
    const uint32_t bl = bh + FC_B_BYTES;
    // rows ra, ra + 8 (same r % 8), columns 8 s + t4 and + 4: chunks 2 s
    // and 2 s + 1 of the swizzled rows; 8 rows are 256 floats on
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* pa0 = (const float*)(as + swz(ra, 2 * s)) + t4;
      const float* pa1 = (const float*)(as + swz(ra, 2 * s + 1)) + t4;
      tf32_split(pa0[0], ah[s][0], al[s][0]);
      tf32_split(pa0[8 * 32], ah[s][1], al[s][1]);
      tf32_split(pa1[0], ah[s][2], al[s][2]);
      tf32_split(pa1[8 * 32], ah[s][3], al[s][3]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {          // the small products first
      wgmma_tf32_rs_n128(part, ah[s], desc_kmajor(bl + s * 32), s > 0);
      wgmma_tf32_rs_n128(part, al[s], desc_kmajor(bh + s * 32), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_tf32_rs_n128(part, ah[s], desc_kmajor(bh + s * 32), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long r = m0 + ra + 8 * half;
    if (r >= s_rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(h + r * HID + c) =
          make_float2(fmaxf(acc[4 * j + 2 * half] + bias[c], 0.0f),
                      fmaxf(acc[4 * j + 2 * half + 1] + bias[c + 1], 0.0f));
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
  const long z = blockIdx.z;                     // the seed
  h += z * s_rows * HID;
  w += z * F2W_FLOATS;
  bias += z * NCLS;
  labels += z * s_rows;
  losses += z * s_rows;
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
  const long z = blockIdx.z;                     // the seed
  const int c = seg[z * s_rows + s];
  first += z * n_clients;
  last += z * n_clients;
  if (c < 0 || c >= n_clients) return;        // padding: the overflow lane
  atomicMin(first + c, s);
  atomicMax(last + c, s);
}

// phase 4b: per-client loss sums, one warp per client; lane j takes the
// client's rows first + j + 32 i
__global__ void __launch_bounds__(256)
client_sum_kernel(const float* __restrict__ losses,
                  const int* __restrict__ seg, int s_rows, int n_clients,
                  const int* __restrict__ first,
                  const int* __restrict__ last, float* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= n_clients) return;
  const long z = blockIdx.z;                     // the seed
  losses += z * s_rows;
  seg += z * s_rows;
  const int lo = first[z * n_clients + c], hi = last[z * n_clients + c];
  float acc = 0.0f;
  for (int s = lo + lane; s <= hi; s += 32)
    if (seg[s] == c) acc += losses[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) sums[z * n_clients + c] = acc;
}

// Phases 0-4 on one stream for n_seeds seeds: each seed's packed samples
// in, its (N,) per-client loss sums out.  Operands are seed-major: images
// (n_seeds, S, 28, 28, 1), labels and seg (n_seeds, S), the weights
// (n_seeds, ...).  Scratch, seed-major as well: wsplit (WSPLIT_FLOATS a
// seed), act (S, 3136), hidden (S, 512), losses (S,), span (2N,) int32
// (every seed's first rows, then every seed's last rows), sums (N,).
// Returns a cudaError_t.
static int probe_phases_run(int n_seeds, const void* images,
                            const void* labels, const void* seg, int s_rows,
                            int n_clients,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* f1w, const void* f1b,
                            const void* f2w, const void* f2b, void* wsplit,
                            void* act, void* hidden, void* losses,
                            void* span, void* sums, cudaStream_t st) {
  const long fc_rows = ((long)s_rows + FC_BM - 1) / FC_BM;
  if (fc_rows > 65535 || n_seeds <= 0 || n_seeds > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned ns = (unsigned)n_seeds;
  cudaError_t err = cudaFuncSetAttribute(
      probe_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CONV_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FC_SMEM);
  if (err != cudaSuccess) return (int)err;

  split_weights_kernel<<<dim3(264, 1, ns), 256, 0, st>>>(
      (const float*)w2, (const float*)f1w, (float*)wsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  probe_conv_kernel<<<dim3((s_rows + PROBE_NS - 1) / PROBE_NS, 1, ns),
                      CONV_THREADS, CONV_SMEM, st>>>(
      (const float*)images, (const float*)w1, (const float*)b1,
      (const float*)wsplit, (const float*)b2, (float*)act, s_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fc1_kernel<<<dim3(HID / FC_BN, (unsigned)fc_rows, ns), 256, FC_SMEM,
               st>>>(
      (const float*)act, (const float*)wsplit + 2 * C2 * K2,
      (const float*)f1b, (float*)hidden, s_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fc2_nll_kernel<<<dim3((s_rows + 7) / 8, 1, ns), 256, 0, st>>>(
      (const float*)hidden, (const float*)f2w, (const float*)f2b,
      (const int*)labels, (float*)losses, s_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t span_bytes = (size_t)n_seeds * n_clients * sizeof(int);
  int* first = (int*)span;
  int* last = first + (long)n_seeds * n_clients;
  if ((err = cudaMemsetAsync(first, 0x7f, span_bytes, st)) != cudaSuccess)
    return (int)err;                          // 0x7f7f7f7f > any row
  if ((err = cudaMemsetAsync(last, 0xff, span_bytes, st)) != cudaSuccess)
    return (int)err;                          // -1
  client_span_kernel<<<dim3((s_rows + 255) / 256, 1, ns), 256, 0, st>>>(
      (const int*)seg, s_rows, n_clients, first, last);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  client_sum_kernel<<<dim3((n_clients + 7) / 8, 1, ns), 256, 0, st>>>(
      (const float*)losses, (const int*)seg, s_rows, n_clients, first, last,
      (float*)sums);
  return (int)cudaGetLastError();
}
