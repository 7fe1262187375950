// The Mamba-1 selective scan's backward for Hopper: chunk-parallel over the
// forward's 64-step chunks, the state's gradient carried over chunks
// elementwise.
//
// Replaces no Pallas kernel: the reference trains through the autodiff of
// its jnp scan (repro/models/mamba.py:143 calls _ssm_scan, checkpointed
// per chunk at :54-90); this is the VJP of the forward that
// csrc/selective_scan.cu computes (kernels/ref.py::selective_scan_ref).
//
// Input: x, dt (B, T, Di) and bmat, cmat (B, T, N), all fp32 or all bf16
// as the forward took them; a (Di, N) fp32; h0 (B, Di, N) fp32; the
// forward's saved states hs (B, ceil(T / 64) - 1, Di, N) fp32 (entry m:
// the state after (m + 1) 64 steps); dy (B, T, Di) fp32; dhT (B, Di, N)
// fp32 or null (zeros).  With dt and x converted to fp32 before their
// product, alpha = exp(dt_t a), and g the gradient of h_t, per step from
// the last:
//   g += dy_t C_t;  dC_t = sum_d dy_t h_t;  dB_t = sum_d g (dt_t x_t)
//   dx_t = dt_t sum_n g B_t;  ddt_t = x_t sum_n g B_t + sum_n q a
//   da += q dt_t with q = (alpha g) h_{t-1};  g <- alpha g
// Output: dx, ddt, dB, dC in the inputs' type; da (Di, N) and dh0 (B, Di,
// N) fp32.
//
// Bound on the H100: ~18 fp32 operations per (b, t, d, n) (the states
// rebuilt, 3; the sweep, 15) and one exp, so the fp32 rate bounds it at
// jamba's training microbatch (B = 1, T = 1024, Di = 8192, N = 16: 0.036
// ms; the exps over the SFU 0.032 ms, the bytes 0.031 ms).
//
// What held the first design back (0.80 ms there, 22x the bound): each
// block of 16 channels walked every chunk of its sequence in turn, forward
// to stage the chunk's 65 states in 95 KB of shared memory, then backward:
// a 2048-step chain a block, 8 warps an SM; two butterflies of 3 shuffles
// a step for 2 states' work (the sums over n of ddt and dx); two accurate
// expf per (b, t, d, n); and 67 MB of dB / dC partials, one per 16
// channels, added by a second kernel (0.078 ms alone).
//
// This design uses that the state is diagonal in (d, n): with G_k the
// gradient of the state at the end of chunk k (G_last = dhT), P_k chunk
// k's decay (the product of its alphas) and Gloc_k the gradient at its
// start from its own dy alone, G_{k-1} = P_k G_k + Gloc_k per (b, d, n), so
// the carry between chunks is one multiply-add an element.  Nothing is
// ever divided by a decay, and h_{t-1} is walked forward, never back.
//   A. per (b, chunk, 64 channels): a forward walk over the chunk from the
//      forward's saved state (h0 for the first), staged SB_KA steps at a
//      time: dC's terms dy_t h_t; the states at C's sub-chunk starts, kept
//      in scratch; Gloc = sum_t pr_t dy_t C_t with pr the running product
//      of alpha (the reverse recurrence from zero, summed forward) and P =
//      2^(a' sum_t dt_t), kept for every chunk but the first.  P is one
//      exp of the chunk's summed exponent, not the product of its 64
//      alphas: MUFU.EX2's errors lean one way, and carried over 16 chunks
//      the product's put da 1.09e-5 of scale off the plain version at
//      jamba's microbatch in fp32 on an H100, past the 1e-5 tolerance
//      (this form: 8.5e-6).  It is exactly 0 wherever a step's alpha underflows (every
//      exponent is <= 0, so the sum is below that step's).
//   B. per (b, d, n): G carried over chunks from the last, written over
//      Gloc (one launch, past one chunk).
//   C. per (b, chunk, 64 channels): each sub-chunk of KC steps from the
//      last is walked forward from its start state (A's, or the forward's
//      at the chunk's start), its states h_{t-1} kept in registers, then
//      backward from the chunk's true G: dx, ddt, dB's terms, da's
//      per-(b, chunk) partial, dh0 (first chunk).  Its outputs are final:
//      no carry terms are added later.
//   sum. dB and dC over the 64-channel groups (four lanes an output, each
//      over a run of groups in order, the runs added in a fixed tree); da
//      over (b, chunk) in order.
// Layout: a lane holds S = 4 states of a channel (N pads to NS = 8, 16 or
// 32), L = NS / 4 lanes share a channel, a block holds 64 channels of one
// batch row (64 L threads: 256 at N = 16), so dB and dC leave a block as
// one partial per 64 channels (16.8 MB at the microbatch, against 67 MB).
// C keeps KC x 4 states a thread in registers (KC = 16 steps, 8 at NS =
// 8) and takes alpha again on its way back (its exps are far from the
// SFU's rate), so at N = 16 two C blocks, 16 warps, share an SM at 128
// registers.  Operands are staged through shared memory in fp32 (x, dt and
// dy as [channel][step] rows, B and C as [step][state]), the next stage
// loaded into registers while the current one is walked (C issues it
// halfway back, when half of its states are spent).  exp(dt a) is exp2(dt a') with a' = a log2(e), one
// MUFU.EX2, as in the forward.  The sums over a channel's states (ddt's
// and dx's) are off g's chain: each lane's 4 terms of a step in order, then
// a reduce over the L lanes by halves as the steps arrive (lane distance 1
// after each pair of steps, 2 after four, 4 after eight), which leaves lane
// q with step q's sum.  dB's and dC's sums over d: a lane's 4 terms of a
// step reduced by halves over 4 of the warp's channels (lanes at distance
// 16 and 8), then the block's 16 partials added in order through shared
// memory.  Every sum runs in a fixed order and there are no atomics: the
// results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define SB_S 4                // states a lane
#define SB_CHANNELS 64        // channels a block of A and C
#define SB_PARTS 16           // dB / dC partials a block sums in order
#define SB_C 64               // steps a chunk: the forward's SS_SAVE
#define SB_KA 8               // steps A stages at a time
#define SB_B_THREADS 256      // B: one (b, d, n) a thread
#define SB_PF 8               // B: chunks loaded ahead
#define SB_SUM_THREADS 256
#define SB_SUM_BATCH 8        // sum: partials loaded ahead
#define SB_SUM_SPLIT 4        // sum: lanes a dB / dC output

// the kernels' geometry for NS padded states (8, 16 or 32)
template <int NS>
struct SbGeo {
  static constexpr int L = NS / SB_S;                 // lanes a channel
  static constexpr int THREADS = SB_CHANNELS * L;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int WC = 32 / L;                   // channels a warp
  static constexpr int PW = WC / 4;                   // partials a warp
  static constexpr int KC = NS == 8 ? 8 : 16;         // C's sub-chunk
  static constexpr int SUBS = SB_C / KC;
  static constexpr int OUT_PITCH = SB_CHANNELS + WC;  // dx / ddt staging
  static constexpr int OUT = KC * OUT_PITCH;
  static_assert(L * SB_S == NS && WARPS * PW == SB_PARTS && PW >= 1,
                "NS: 8, 16 or 32");
  static_assert(KC % L == 0 && KC % 4 == 0 && KC % SB_KA == 0,
                "whole lane groups; sub-chunk starts on A's stages");
};

// one buffer of K steps of operands (fp32) and the dB / dC partials
template <int NS, int K>
struct SbStage {
  static constexpr int PITCH = K + 4;             // x, dt, dy: [channel][step]
  static constexpr int ROWS = SB_CHANNELS * PITCH;
  static constexpr int BC = K * NS;               // B, C: [step][state]
  static constexpr int BUF = 3 * ROWS + 2 * BC + SB_PARTS * BC;
  static constexpr int XD = K * SB_CHANNELS / SbGeo<NS>::THREADS;
  static_assert(BC <= SbGeo<NS>::THREADS && XD * SbGeo<NS>::THREADS ==
                K * SB_CHANNELS, "staging split");
  float *x, *dt, *dy, *b, *c, *red;
  __device__ __forceinline__ SbStage(float* smem, int buf) {
    x = smem + (size_t)buf * BUF;
    dt = x + ROWS;
    dy = dt + ROWS;
    b = dy + ROWS;
    c = b + BC;
    red = c + BC;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename TI>
__device__ __forceinline__ TI zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// 2^x, one MUFU.EX2 (outputs below 2^-126 flush to 0), as the forward
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// One halving step of a reduce over lanes at distance `dist`: each lane
// sends the value it gives up and adds the partner's to the one it keeps
// (hi if its lane bit is set, else lo).
__device__ __forceinline__ float halve(float lo, float hi, bool upper,
                                       int dist) {
  const float send = upper ? lo : hi;
  const float keep = upper ? hi : lo;
  return keep + __shfl_xor_sync(0xffffffffu, send, dist);
}

// The sum over a channel's L lanes of a step's terms, by halves as the
// steps of a group of L arrive, from the last (u = L - 1) to the first:
// after each pair the lanes at distance 1 keep the step of their bit 0,
// after two pairs those at distance 2 the pair of their bit 1, after four
// those at distance 4 the four of their bit 2, so lane q ends with step
// q's sum, ((P_q + P_q^1) + (P_q^2 + P_q^3)) + ... with P_l lane l's term.
template <int L>
struct LaneSum {
  float hi[3], sum;
  __device__ __forceinline__ void step(float p, int u, int q) {
    float v = p;
#pragma unroll
    for (int l = 0; (1 << l) < L; ++l) {
      if (u & (1 << l)) {
        hi[l] = v;
        return;
      }
      v = halve(v, hi[l], ((q >> l) & 1) != 0, 1 << l);
    }
    sum = v;
  }
};

// A lane's 4 terms (its states) of a step summed over 4 of its warp's
// channels (lanes at distance 16 and 8) by halves: the lane ends with the
// sum of term (lane >> 3) & 3.
__device__ __forceinline__ float channels_sum(const float (&v)[4], int lane) {
  const bool hi = (lane & 16) != 0;
  const float v0 = halve(v[0], v[2], hi, 16);
  const float v1 = halve(v[1], v[3], hi, 16);
  return halve(v0, v1, (lane & 8) != 0, 8);
}

// Where block (b, chunk, group) sits and what its thread holds and stages:
// channel d = d0 + ch, states n0 .. n0 + 3; it stages steps c0 + (THREADS
// / 64) m of channel d0 + k of x, dt and dy and, if tid < K NS, step cb and
// state nb of B and C (offsets taken once a block; a stage adds rows).
template <int NS, int K>
struct SbPos {
  using G = SbGeo<NS>;
  int b, ck, grp, n_chunks, tid, ch, q, n0, d, len, k, c0, cb;
  int red;        // the lane's slot in a row of dB / dC partials
  bool valid, kin, nin;
  size_t x0, b0;  // element offsets of (t0 + c0, d0 + k), (t0 + cb, nb)
  __device__ __forceinline__ SbPos(int T, int Di, int N, int groups) {
    n_chunks = (T + SB_C - 1) / SB_C;
    int blk = blockIdx.x;
    grp = blk % groups;
    blk /= groups;
    ck = blk % n_chunks;
    b = blk / n_chunks;
    tid = threadIdx.x;
    ch = tid / G::L;
    q = tid - ch * G::L;
    n0 = q * SB_S;
    const int lane = tid & 31;
    red = ((tid / 32) * G::PW + (lane & 7) / G::L) * K * NS + n0 +
          ((lane >> 3) & 3);
    const int d0 = grp * SB_CHANNELS;
    d = d0 + ch;
    valid = d < Di;
    const int t0 = ck * SB_C;
    len = min(SB_C, T - t0);
    c0 = tid / SB_CHANNELS;
    k = tid - c0 * SB_CHANNELS;
    kin = d0 + k < Di;
    cb = tid / NS;
    const int nb = tid - cb * NS;
    nin = tid < K * NS && nb < N;
    x0 = ((size_t)b * T + t0 + c0) * Di + d0 + k;
    b0 = ((size_t)b * T + t0 + cb) * N + nb;
  }
};

// K steps of operands, loaded into registers in their input type while the
// previous ones are walked, then stored to a stage in fp32 (zeros past T,
// past Di and past N).
template <typename TI, int NS, int K>
struct Fetch {
  using St = SbStage<NS, K>;
  static constexpr int ROW_STEP = SbGeo<NS>::THREADS / SB_CHANNELS;
  TI x[St::XD], dt[St::XD], bv, cv;
  float dy[St::XD];

  // steps s0 .. s0 + K - 1 of the chunk, `left` steps of it from s0
  __device__ __forceinline__ void load(const TI* __restrict__ gx,
                                       const TI* __restrict__ gdt,
                                       const float* __restrict__ gdy,
                                       const TI* __restrict__ gb,
                                       const TI* __restrict__ gc,
                                       const SbPos<NS, K>& p, int s0,
                                       int left, int Di, int N) {
    const size_t xo = p.x0 + (size_t)s0 * Di;
#pragma unroll
    for (int m = 0; m < St::XD; ++m) {
      const bool ok = p.kin && p.c0 + ROW_STEP * m < left;
      const size_t off = xo + (size_t)(ROW_STEP * m) * Di;
      x[m] = ok ? gx[off] : zero_of<TI>();
      dt[m] = ok ? gdt[off] : zero_of<TI>();
      dy[m] = ok ? gdy[off] : 0.0f;
    }
    const bool ok = p.nin && p.cb < left;
    const size_t off = p.b0 + (size_t)s0 * N;
    bv = ok ? gb[off] : zero_of<TI>();
    cv = ok ? gc[off] : zero_of<TI>();
  }

  __device__ __forceinline__ void store(const St& st,
                                        const SbPos<NS, K>& p) const {
    const int i = p.k * St::PITCH + p.c0;
#pragma unroll
    for (int m = 0; m < St::XD; ++m) {
      st.x[i + ROW_STEP * m] = to_f32(x[m]);
      st.dt[i + ROW_STEP * m] = to_f32(dt[m]);
      st.dy[i + ROW_STEP * m] = dy[m];
    }
    if (p.tid < St::BC) {
      st.b[p.tid] = to_f32(bv);
      st.c[p.tid] = to_f32(cv);
    }
  }
};

// A stage's dB or dC rows: the block's 16 partials added in order, one
// thread per (step cb, state nb); `out` is the thread's element of the
// rows, `len` the stage's steps.
template <int NS, int K>
__device__ __forceinline__ void flush_rows(const float* red, float* out,
                                           const SbPos<NS, K>& p, int len) {
  constexpr int BC = SbStage<NS, K>::BC;
  if (p.nin && p.cb < len) {
    float acc = red[p.tid];
#pragma unroll
    for (int w = 1; w < SB_PARTS; ++w) acc += red[w * BC + p.tid];
    *out = acc;
  }
}

// ---------------------------------------------------------------------------
// A: the chunk's forward walk (dC's terms, C's sub-chunk starts, P, Gloc)

template <int NS>
__device__ __forceinline__ void walk_a(float (&h)[SB_S], float (&pr)[SB_S],
                                       float (&gl)[SB_S], float& dtsum,
                                       const float (&a2)[SB_S],
                                       const SbStage<NS, SB_KA>& st,
                                       const SbPos<NS, SB_KA>& p) {
  using St = SbStage<NS, SB_KA>;
  const float* xr = st.x + p.ch * St::PITCH;
  const float* dtr = st.dt + p.ch * St::PITCH;
  const float* dyr = st.dy + p.ch * St::PITCH;
#pragma unroll
  for (int c4 = 0; c4 < SB_KA; c4 += 4) {
    float dts[4], xs[4], dys[4];
    ld4(dtr + c4, dts);
    ld4(xr + c4, xs);
    ld4(dyr + c4, dys);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c4 + u;
      const float dtx = dts[u] * xs[u];
      dtsum += dts[u];
      float bv[SB_S], cv[SB_S], v[SB_S];
      ld4(st.b + c * NS + p.n0, bv);
      ld4(st.c + c * NS + p.n0, cv);
#pragma unroll
      for (int s = 0; s < SB_S; ++s) {
        const float al = ex2(dts[u] * a2[s]);
        h[s] = fmaf(al, h[s], dtx * bv[s]);
        pr[s] *= al;
        gl[s] = fmaf(pr[s], dys[u] * cv[s], gl[s]);
        v[s] = dys[u] * h[s];
      }
      st.red[p.red + c * NS] = channels_sum(v, p.tid & 31);
    }
  }
}

template <typename TI, int NS>
__global__ void __launch_bounds__(SbGeo<NS>::THREADS,
                                  1024 / SbGeo<NS>::THREADS)
selective_scan_bwd_chunk_kernel(const TI* __restrict__ x,
                                const TI* __restrict__ dt,
                                const TI* __restrict__ bmat,
                                const TI* __restrict__ cmat,
                                const float* __restrict__ a,
                                const float* __restrict__ h0,
                                const float* __restrict__ hs,
                                const float* __restrict__ dy, int T, int Di,
                                int N, int groups, float* __restrict__ ckpt,
                                float* __restrict__ gloc,
                                float* __restrict__ decay,
                                float* __restrict__ dc_part) {
  using G = SbGeo<NS>;
  using St = SbStage<NS, SB_KA>;
  extern __shared__ __align__(16) float smem[];
  const SbPos<NS, SB_KA> p(T, Di, N, groups);
  const int n0 = p.n0;
  const int stages = (p.len + SB_KA - 1) / SB_KA;
  const size_t state = (size_t)Di * N;
  const size_t dn = (size_t)p.d * N;

  // steps staged as zeros (past T) change nothing here: alpha = 2^0 = 1,
  // and every added term is 0
  float a2[SB_S], h[SB_S], pr[SB_S], gl[SB_S], dtsum = 0.0f;
  const float* src =
      p.ck == 0 ? h0 + p.b * state
                : hs + ((size_t)p.b * (p.n_chunks - 1) + p.ck - 1) * state;
#pragma unroll
  for (int s = 0; s < SB_S; ++s) {
    const bool on = p.valid && n0 + s < N;
    a2[s] = on ? a[dn + n0 + s] * 1.4426950408889634f : 0.0f;
    h[s] = on ? src[dn + n0 + s] : 0.0f;
    pr[s] = 1.0f;
    gl[s] = 0.0f;
  }
  Fetch<TI, NS, SB_KA> f;
  f.load(x, dt, dy, bmat, cmat, p, 0, p.len, Di, N);
  // the thread's element of the dC rows, and C's sub-chunk starts
  float* part = dc_part + ((size_t)p.b * groups + p.grp) * T * N + p.b0 -
                (size_t)p.b * T * N;
  float* kept = ckpt + ((size_t)p.b * p.n_chunks + p.ck) * (G::SUBS - 1) *
                           state + dn + n0 - state;
  for (int j = 0; j < stages; ++j) {
    const St st(smem, j & 1);
    f.store(st, p);
    __syncthreads();   // the stage is full; the previous dC rows complete
    if (j > 0)
      flush_rows<NS, SB_KA>(St(smem, (j - 1) & 1).red,
                            part + (size_t)((j - 1) * SB_KA) * N, p, SB_KA);
    if (j + 1 < stages)
      f.load(x, dt, dy, bmat, cmat, p, (j + 1) * SB_KA,
             p.len - (j + 1) * SB_KA, Di, N);
    if (j > 0 && (j * SB_KA) % G::KC == 0 && p.valid) {
      float* out = kept + (size_t)(j * SB_KA / G::KC) * state;
#pragma unroll
      for (int s = 0; s < SB_S; ++s)
        if (n0 + s < N) out[s] = h[s];
    }
    walk_a<NS>(h, pr, gl, dtsum, a2, st, p);
  }
  __syncthreads();
  flush_rows<NS, SB_KA>(St(smem, (stages - 1) & 1).red,
                        part + (size_t)((stages - 1) * SB_KA) * N, p,
                        p.len - (stages - 1) * SB_KA);
  if (p.ck > 0 && p.valid) {
    const size_t slot =
        ((size_t)p.b * (p.n_chunks - 1) + p.ck - 1) * state + dn;
#pragma unroll
    for (int s = 0; s < SB_S; ++s) {
      if (n0 + s < N) {
        gloc[slot + n0 + s] = gl[s];
        decay[slot + n0 + s] = ex2(a2[s] * dtsum);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B: G over chunks from the last, G_{m} = P_{m+1} G_{m+1} + Gloc_{m+1}
// (slot m holds chunk m + 1's Gloc and P), written over Gloc

__global__ void __launch_bounds__(SB_B_THREADS)
selective_scan_bwd_carry_kernel(const float* __restrict__ dhT,
                                const float* __restrict__ decay,
                                float* __restrict__ gcarry, int B,
                                int n_chunks, long long per) {
  const long long e = (long long)blockIdx.x * SB_B_THREADS + threadIdx.x;
  if (e >= (long long)B * per) return;
  const long long b = e / per, r = e - b * per;
  const int slots = n_chunks - 1;
  const float* pc = decay + (size_t)b * slots * per + r;
  float* gc = gcarry + (size_t)b * slots * per + r;
  float g = dhT ? dhT[e] : 0.0f;
  for (int m0 = slots - 1; m0 >= 0; m0 -= SB_PF) {
    float pv[SB_PF], gv[SB_PF];
#pragma unroll
    for (int u = 0; u < SB_PF; ++u) {
      const int m = m0 - u;
      pv[u] = m >= 0 ? pc[(size_t)m * per] : 0.0f;
      gv[u] = m >= 0 ? gc[(size_t)m * per] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SB_PF; ++u) {
      const int m = m0 - u;
      if (m >= 0) {
        g = fmaf(pv[u], g, gv[u]);
        gc[(size_t)m * per] = g;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C: each sub-chunk walked forward (its states in registers), then backward
// from the chunk's true G; `mid` runs halfway back, when the first half's
// states are spent (it loads the next sub-chunk)

template <int NS, bool kTail, typename Mid>
__device__ __forceinline__ void sweep_c(float (&h)[SB_S], float (&g)[SB_S],
                                        float (&da)[SB_S],
                                        const float (&a2)[SB_S],
                                        const SbStage<NS, SbGeo<NS>::KC>& st,
                                        float* sdx, float* sddt,
                                        const SbPos<NS, SbGeo<NS>::KC>& p,
                                        int ls, Mid&& mid) {
  using G = SbGeo<NS>;
  using St = SbStage<NS, G::KC>;
  constexpr int K = G::KC, L = G::L;
  const float* xr = st.x + p.ch * St::PITCH;
  const float* dtr = st.dt + p.ch * St::PITCH;
  const float* dyr = st.dy + p.ch * St::PITCH;

  // forward: hst[c] = h_{t-1} of each step
  float hst[K][SB_S];
#pragma unroll
  for (int c4 = 0; c4 < K; c4 += 4) {
    float dts[4], xs[4];
    ld4(dtr + c4, dts);
    ld4(xr + c4, xs);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c4 + u;
      const float dtx = dts[u] * xs[u];
      float bv[SB_S];
      ld4(st.b + c * NS + p.n0, bv);
#pragma unroll
      for (int s = 0; s < SB_S; ++s) {
        hst[c][s] = h[s];
        h[s] = fmaf(ex2(dts[u] * a2[s]), h[s], dtx * bv[s]);
      }
    }
  }

  // backward from the last step; the sums over n in groups of L steps
  LaneSum<L> sx, sd;
#pragma unroll
  for (int c4 = K - 4; c4 >= 0; c4 -= 4) {
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int c = c4 + u;
      const bool on = !kTail || c < ls;
      float dts[4], dys[4];
      dts[u] = dtr[c];
      dys[u] = dyr[c];
      const float dtx = dts[u] * xr[c];
      float bv[SB_S], cv[SB_S], v[SB_S];
      ld4(st.b + c * NS + p.n0, bv);
      ld4(st.c + c * NS + p.n0, cv);
      float px = 0.0f, pd = 0.0f;
#pragma unroll
      for (int s = 0; s < SB_S; ++s) {
        const float gs = fmaf(dys[u], cv[s], g[s]);     // the gradient of h_t
        const float gp = gs * ex2(dts[u] * a2[s]);      // ... of h_{t-1}
        const float qv = gp * hst[c][s];
        pd = fmaf(qv, a2[s], pd);
        px = fmaf(gs, bv[s], px);
        v[s] = gs * dtx;
        if (on) {
          da[s] = fmaf(qv, dts[u], da[s]);
          g[s] = gp;
        }
      }
      st.red[p.red + c * NS] = channels_sum(v, p.tid & 31);
      sx.step(px, c % L, p.q);
      sd.step(pd, c % L, p.q);
      if (c % L == 0) {   // the group's sums: lane q has step c + q's
        const int cq = c + p.q;
        if (!kTail || cq < ls) {
          sdx[cq * G::OUT_PITCH + p.ch] = sx.sum * dtr[cq];
          // sum_n q a = ln 2 sum_n q a'
          sddt[cq * G::OUT_PITCH + p.ch] =
              fmaf(sx.sum, xr[cq], sd.sum * 0.6931471805599453f);
        }
      }
      if (c == K / 2) mid();
    }
  }
}

template <typename TI, int NS>
__global__ void __launch_bounds__(SbGeo<NS>::THREADS,
                                  512 / SbGeo<NS>::THREADS)
selective_scan_bwd_sweep_kernel(const TI* __restrict__ x,
                                const TI* __restrict__ dt,
                                const TI* __restrict__ bmat,
                                const TI* __restrict__ cmat,
                                const float* __restrict__ a,
                                const float* __restrict__ h0,
                                const float* __restrict__ hs,
                                const float* __restrict__ dy,
                                const float* __restrict__ dhT, int T, int Di,
                                int N, int groups,
                                const float* __restrict__ ckpt,
                                const float* __restrict__ gcarry,
                                TI* __restrict__ dx, TI* __restrict__ ddt,
                                float* __restrict__ db_part,
                                float* __restrict__ da_part,
                                float* __restrict__ dh0) {
  using G = SbGeo<NS>;
  constexpr int K = G::KC;
  using St = SbStage<NS, K>;
  extern __shared__ __align__(16) float smem[];
  float* sdx_base = smem + 2 * St::BUF;   // [2][K][OUT_PITCH]
  float* sddt_base = sdx_base + 2 * G::OUT;
  const SbPos<NS, K> p(T, Di, N, groups);
  const int n0 = p.n0;
  const int subs = (p.len + K - 1) / K;
  const size_t state = (size_t)Di * N;
  const size_t dn = (size_t)p.d * N;
  const bool last = p.ck == p.n_chunks - 1;

  float a2[SB_S], g[SB_S], da[SB_S], hn[SB_S];
  const float* gsrc =
      last ? dhT + p.b * state
           : gcarry + ((size_t)p.b * (p.n_chunks - 1) + p.ck) * state;
#pragma unroll
  for (int s = 0; s < SB_S; ++s) {
    const bool on = p.valid && n0 + s < N;
    a2[s] = on ? a[dn + n0 + s] * 1.4426950408889634f : 0.0f;
    g[s] = on && (!last || dhT) ? gsrc[dn + n0 + s] : 0.0f;
    da[s] = 0.0f;
  }
  // the state at sub-chunk j's start: the forward's at the chunk's start
  // (h0 for the first chunk), A's inside it
  const float* first =
      (p.ck == 0 ? h0 + p.b * state
                 : hs + ((size_t)p.b * (p.n_chunks - 1) + p.ck - 1) * state) +
      dn + n0;
  const float* kept = ckpt + ((size_t)p.b * p.n_chunks + p.ck) *
                                 (G::SUBS - 1) * state + dn + n0 - state;
  auto fetch_start = [&](int j) {
    const float* src = j > 0 ? kept + (size_t)j * state : first;
#pragma unroll
    for (int s = 0; s < SB_S; ++s)
      hn[s] = p.valid && n0 + s < N ? src[s] : 0.0f;
  };
  // a walked sub-chunk's dB rows, dx and ddt out to device memory
  float* part = db_part + ((size_t)p.b * groups + p.grp) * T * N + p.b0 -
                (size_t)p.b * T * N;
  auto flush = [&](int buf, int j) {
    const int ls = min(K, p.len - j * K);
    flush_rows<NS, K>(St(smem, buf).red, part + (size_t)(j * K) * N, p, ls);
    const float* sdx = sdx_base + buf * G::OUT + p.c0 * G::OUT_PITCH + p.k;
    const float* sddt =
        sddt_base + buf * G::OUT + p.c0 * G::OUT_PITCH + p.k;
    const size_t xo = p.x0 + (size_t)(j * K) * Di;
    constexpr int ROW_STEP = G::THREADS / SB_CHANNELS;
#pragma unroll
    for (int m = 0; m < St::XD; ++m) {
      if (p.kin && p.c0 + ROW_STEP * m < ls) {
        const size_t off = xo + (size_t)(ROW_STEP * m) * Di;
        store_as(dx + off, sdx[ROW_STEP * m * G::OUT_PITCH]);
        store_as(ddt + off, sddt[ROW_STEP * m * G::OUT_PITCH]);
      }
    }
  };

  Fetch<TI, NS, K> f;
  f.load(x, dt, dy, bmat, cmat, p, (subs - 1) * K, p.len - (subs - 1) * K,
         Di, N);
  fetch_start(subs - 1);
  for (int j = subs - 1, it = 0; j >= 0; --j, ++it) {
    const int buf = it & 1;
    const St st(smem, buf);
    f.store(st, p);
    float h[SB_S];
#pragma unroll
    for (int s = 0; s < SB_S; ++s) h[s] = hn[s];
    __syncthreads();   // the stage is full; the previous sub-chunk's
                       // dB rows, dx and ddt complete
    if (it > 0) flush(buf ^ 1, j + 1);
    auto mid = [&]() {
      if (j > 0) {
        f.load(x, dt, dy, bmat, cmat, p, (j - 1) * K, K, Di, N);
        fetch_start(j - 1);
      }
    };
    const int ls = min(K, p.len - j * K);
    float* sdx = sdx_base + buf * G::OUT;
    float* sddt = sddt_base + buf * G::OUT;
    if (ls == K)
      sweep_c<NS, false>(h, g, da, a2, st, sdx, sddt, p, ls, mid);
    else
      sweep_c<NS, true>(h, g, da, a2, st, sdx, sddt, p, ls, mid);
  }
  __syncthreads();
  flush((subs - 1) & 1, 0);
  if (p.valid) {
    const size_t slot = ((size_t)p.b * p.n_chunks + p.ck) * state + dn;
#pragma unroll
    for (int s = 0; s < SB_S; ++s) {
      if (n0 + s < N) {
        da_part[slot + n0 + s] = da[s];
        if (p.ck == 0) dh0[p.b * state + dn + n0 + s] = g[s];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// sum: dB and dC over the 64-channel groups, SB_SUM_SPLIT adjacent lanes an
// output, each over its own run of groups in order, the runs added in a
// fixed tree; past those (from a whole warp on), da over (b, chunk) in
// order, one thread per (d, n)

// the threads of the dB / dC part: whole warps
__host__ __device__ __forceinline__ long long sum_threads(long long outputs) {
  return (outputs * SB_SUM_SPLIT + 31) / 32 * 32;
}

template <typename TI>
__global__ void __launch_bounds__(SB_SUM_THREADS)
selective_scan_bwd_sum_kernel(const float* __restrict__ db_part,
                              const float* __restrict__ dc_part,
                              const float* __restrict__ da_part, int B,
                              int T, int Di, int N, int groups, int slots,
                              TI* __restrict__ dbm, TI* __restrict__ dcm,
                              float* __restrict__ da) {
  const long long idx = (long long)blockIdx.x * SB_SUM_THREADS + threadIdx.x;
  const long long tn = (long long)T * N;
  const long long bc = (long long)B * tn;
  const long long split = sum_threads(bc);
  if (idx < split) {
    const long long o = idx / SB_SUM_SPLIT;
    const int part = (int)(idx - o * SB_SUM_SPLIT);
    const int run = (groups + SB_SUM_SPLIT - 1) / SB_SUM_SPLIT;
    const int k_lo = part * run, k_hi = min(groups, k_lo + run);
    float sb = 0.0f, sc = 0.0f;
    if (o < bc && k_lo < k_hi) {
      const long long b = o / tn, e = o - b * tn;
      const float* pb = db_part + (size_t)b * groups * tn + e;
      const float* pc = dc_part + (size_t)b * groups * tn + e;
      sb = pb[(size_t)k_lo * tn];
      sc = pc[(size_t)k_lo * tn];
      for (int k0 = k_lo + 1; k0 < k_hi; k0 += SB_SUM_BATCH) {
        float vb[SB_SUM_BATCH], vc[SB_SUM_BATCH];
#pragma unroll
        for (int u = 0; u < SB_SUM_BATCH; ++u) {
          const bool on = k0 + u < k_hi;
          vb[u] = on ? pb[(size_t)(k0 + u) * tn] : 0.0f;
          vc[u] = on ? pc[(size_t)(k0 + u) * tn] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < SB_SUM_BATCH; ++u) {
          if (k0 + u < k_hi) {
            sb += vb[u];
            sc += vc[u];
          }
        }
      }
    }
    // (run 0 + run 1) + (run 2 + run 3): every lane of the four ends with
    // the same bits
#pragma unroll
    for (int dist = 1; dist < SB_SUM_SPLIT; dist *= 2) {
      sb += __shfl_xor_sync(0xffffffffu, sb, dist);
      sc += __shfl_xor_sync(0xffffffffu, sc, dist);
    }
    if (part == 0 && o < bc) {
      store_as(dbm + o, sb);
      store_as(dcm + o, sc);
    }
  } else if (idx < split + (long long)Di * N) {
    const long long e = idx - split, per = (long long)Di * N;
    float acc = da_part[e];
    for (int k0 = 1; k0 < slots; k0 += SB_SUM_BATCH) {
      float v[SB_SUM_BATCH];
#pragma unroll
      for (int u = 0; u < SB_SUM_BATCH; ++u)
        v[u] = k0 + u < slots ? da_part[(size_t)(k0 + u) * per + e] : 0.0f;
#pragma unroll
      for (int u = 0; u < SB_SUM_BATCH; ++u)
        if (k0 + u < slots) acc += v[u];
    }
    da[e] = acc;
  }
}

template <typename TI, int NS>
static int launch(const void* x, const void* dt, const void* bmat,
                  const void* cmat, const void* a, const void* h0,
                  const void* hs, const void* dy, const void* dhT, int B,
                  int T, int Di, int N, void* dx, void* ddt, void* dbm,
                  void* dcm, void* da, void* dh0, void* scratch,
                  cudaStream_t stream) {
  using G = SbGeo<NS>;
  const int groups = (Di + SB_CHANNELS - 1) / SB_CHANNELS;
  const int n_chunks = (T + SB_C - 1) / SB_C;
  const size_t state = (size_t)Di * N;
  // the scratch, in kernels/selective_scan.py::bwd_scratch_parts' order
  float* ckpt = (float*)scratch;
  float* gcarry = ckpt + (size_t)B * n_chunks * (G::SUBS - 1) * state;
  float* decay = gcarry + (size_t)B * (n_chunks - 1) * state;
  float* db_part = decay + (size_t)B * (n_chunks - 1) * state;
  float* dc_part = db_part + (size_t)B * groups * T * N;
  float* da_part = dc_part + (size_t)B * groups * T * N;
  const unsigned blocks = (unsigned)B * n_chunks * groups;
  const size_t a_bytes = (size_t)2 * SbStage<NS, SB_KA>::BUF * 4;
  const size_t c_bytes =
      (size_t)(2 * SbStage<NS, G::KC>::BUF + 4 * G::OUT) * 4;

  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_chunk_kernel<TI, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(selective_scan_bwd_sweep_kernel<TI, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c_bytes);
  if (err != cudaSuccess) return (int)err;

  selective_scan_bwd_chunk_kernel<TI, NS>
      <<<blocks, G::THREADS, a_bytes, stream>>>(
          (const TI*)x, (const TI*)dt, (const TI*)bmat, (const TI*)cmat,
          (const float*)a, (const float*)h0, (const float*)hs,
          (const float*)dy, T, Di, N, groups, ckpt, gcarry, decay, dc_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_chunks > 1) {
    const long long n = (long long)B * state;
    selective_scan_bwd_carry_kernel<<<
        (unsigned)((n + SB_B_THREADS - 1) / SB_B_THREADS), SB_B_THREADS, 0,
        stream>>>((const float*)dhT, decay, gcarry, B, n_chunks,
                  (long long)state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  selective_scan_bwd_sweep_kernel<TI, NS>
      <<<blocks, G::THREADS, c_bytes, stream>>>(
          (const TI*)x, (const TI*)dt, (const TI*)bmat, (const TI*)cmat,
          (const float*)a, (const float*)h0, (const float*)hs,
          (const float*)dy, (const float*)dhT, T, Di, N, groups, ckpt,
          gcarry, (TI*)dx, (TI*)ddt, db_part, da_part, (float*)dh0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = sum_threads((long long)B * T * N) + (long long)Di * N;
  selective_scan_bwd_sum_kernel<TI>
      <<<(unsigned)((n + SB_SUM_THREADS - 1) / SB_SUM_THREADS),
         SB_SUM_THREADS, 0, stream>>>(db_part, dc_part, da_part, B, T, Di, N,
                                      groups, B * n_chunks, (TI*)dbm,
                                      (TI*)dcm, (float*)da);
  return (int)cudaGetLastError();
}

template <int NS>
static int dispatch(const void* x, const void* dt, const void* bmat,
                    const void* cmat, const void* a, const void* h0,
                    const void* hs, const void* dy, const void* dhT, int B,
                    int T, int Di, int N, int bf16, void* dx, void* ddt,
                    void* dbm, void* dcm, void* da, void* dh0, void* scratch,
                    cudaStream_t st) {
  if (bf16)
    return launch<__nv_bfloat16, NS>(x, dt, bmat, cmat, a, h0, hs, dy, dhT,
                                     B, T, Di, N, dx, ddt, dbm, dcm, da, dh0,
                                     scratch, st);
  return launch<float, NS>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di,
                           N, dx, ddt, dbm, dcm, da, dh0, scratch, st);
}

// bf16: 1 if x, dt, bmat and cmat are bf16 (and so dx, ddt, dB, dC), 0 if
// fp32.  N must be 1..32.  hs: the forward's saved states when T > 64 (may
// be null when T <= 64); dhT may be null.  scratch: the floats of
// kernels/selective_scan.py::bwd_scratch_parts.  T >= 1.  Device memory is
// read and written by scalar accesses only: no operand needs more than its
// type's alignment.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bmat, const void* cmat,
    const void* a, const void* h0, const void* hs, const void* dy,
    const void* dhT, int B, int T, int Di, int N, int bf16, void* dx,
    void* ddt, void* dbm, void* dcm, void* da, void* dh0, void* scratch,
    void* stream) {
  if (B <= 0 || Di <= 0 || T <= 0 || N <= 0 || N > 32 ||
      (long long)B * ((T + SB_C - 1) / SB_C) *
              ((Di + SB_CHANNELS - 1) / SB_CHANNELS) > INT_MAX ||
      (sum_threads((long long)B * T * N) + (long long)Di * N) /
              SB_SUM_THREADS + 1 > INT_MAX ||
      (long long)B * Di * N / SB_B_THREADS + 1 > INT_MAX ||
      (T > SB_C && hs == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8)
    return dispatch<8>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                       bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
  if (N <= 16)
    return dispatch<16>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                        bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
  return dispatch<32>(x, dt, bmat, cmat, a, h0, hs, dy, dhT, B, T, Di, N,
                      bf16, dx, ddt, dbm, dcm, da, dh0, scratch, st);
}
