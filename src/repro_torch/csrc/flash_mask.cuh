// The mask of flash attention's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu), over the natural positions 0..S-1 of q and kv:
// a (q, kv) pair is kept iff q_pos < Sq and kv_pos < Skv and, when
// causal, kv_pos <= q_pos, narrowed by `window` (q_pos - kv_pos < window)
// and widened by `prefix_len` (kv_pos < prefix_len), as
// repro/kernels/flash_attention.py's `_kernel` masks.
#pragma once

__device__ __forceinline__ bool fa_kept(int qp, int kp, int Sq, int Skv,
                                        int causal, int window,
                                        int prefix_len) {
  bool ok = qp < Sq && kp < Skv;
  if (causal) {
    bool ca = kp <= qp;
    if (window > 0) ca = ca && (qp - kp) < window;
    if (prefix_len > 0) ca = ca || kp < prefix_len;
    ok = ok && ca;
  }
  return ok;
}

// whether fa_kept holds for some pair of q rows [q0, q1) and kv rows
// [k0, k1), both ranges non-empty and inside Sq and Skv: q - kv takes
// every value in [q0 - (k1 - 1), (q1 - 1) - k0]
__device__ __forceinline__ bool fa_tile_kept(int q0, int q1, int k0, int k1,
                                             int causal, int window,
                                             int prefix_len) {
  if (!causal || (prefix_len > 0 && k0 < prefix_len)) return true;
  if ((q1 - 1) - k0 < 0) return false;
  return window == 0 || q0 - (k1 - 1) < window;
}
