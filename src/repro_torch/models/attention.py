"""Attention: GQA / MQA, RoPE, sliding window, prefix-LM, KV-cache decode
(``repro.models.attention``), as plain functions on tensors.

A full sequence (prefill) goes through ``kernels.ops.flash_attention``:
the hand-written kernel for a CUDA tensor, its plain version on the
CPU, as ``repro.kernels.ops.flash_attention(..., impl="pallas")`` would
(the reference's model calls its own jnp chunked version).  A decode
step attends one token over a slot cache in plain ops, as in the
reference.  Cross-attention (the audio family's decoder) attends to the
encoder's K/V through the same ``flash_attention``, unmasked, in
prefill and at every decode step, as the reference's does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (COMPUTE_DTYPE, PARAM_DTYPE, Params,
                                       dense_init, rms_norm, rope)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_attention(g: torch.Generator, cfg, d: int) -> Params:
    """q, k, v and output projections (fp32, ``(out, in)``), drawn from
    ``g`` on its device; ``qk_norm`` adds the two rmsnorm weights."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(g, d, hq * dh),
         "wk": dense_init(g, d, hkv * dh),
         "wv": dense_init(g, d, hkv * dh),
         "wo": dense_init(g, hq * dh, d)}
    if cfg.qk_norm:
        p["qn"] = torch.zeros(dh, dtype=PARAM_DTYPE, device=g.device)
        p["kn"] = torch.zeros(dh, dtype=PARAM_DTYPE, device=g.device)
    return p


def init_cross_attention(g: torch.Generator, cfg, d: int) -> Params:
    return init_attention(g, cfg, d)


# --------------------------------------------------------------------------
# decode attention over a slot cache
# --------------------------------------------------------------------------

def make_kv_cache(batch: int, slots: int, hkv: int, dh: int,
                  dtype=COMPUTE_DTYPE, device=None) -> Params:
    """An empty slot cache: k, v (B, slots, Hkv, Dh), the absolute
    position held in each slot (-1: empty) and the next position."""
    return {
        "k": torch.zeros((batch, slots, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, hkv, dh), dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_attention(q: torch.Tensor, cache: Params, k_new: torch.Tensor,
                     v_new: torch.Tensor, *, window: int = 0,
                     prefix_len: int = 0) -> Tuple[torch.Tensor, Params]:
    """One-token attention.  q, k_new, v_new: (B, 1, H*, Dh).  Writes
    into the ring (slot = idx % slots) of a new cache, leaving the given
    one as it was, and attends over every valid slot: products in fp32,
    p cast to the cache's dtype before p v, as in the reference."""
    b, _, hq, dh = q.shape
    slots, hkv = cache["k"].shape[1], cache["k"].shape[2]
    g = hq // hkv
    idx = cache["idx"]
    slot = (idx % slots).reshape(1).long()

    k = cache["k"].index_copy(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, slot, v_new.to(cache["v"].dtype))
    pos = cache["pos"].index_copy(0, slot, idx.reshape(1))

    qh = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bthd->bhgt", qh, k.float()) * (
        1.0 / math.sqrt(dh))
    ok = (pos >= 0) & (pos <= idx)
    if window:
        ok &= (idx - pos) < window
    if prefix_len:
        ok |= (pos >= 0) & (pos < prefix_len)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(b, 1, hq, dh).to(q.dtype)
    return out, {"k": k, "v": v, "pos": pos, "idx": idx + 1}


# --------------------------------------------------------------------------
# full attention block (qkv -> rope -> attn -> out)
# --------------------------------------------------------------------------

def _project_qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
                 *, use_rope: bool = True):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = F.linear(x, p["wq"].to(dt)).reshape(b, s, hq, dh)
    k = F.linear(x, p["wk"].to(dt)).reshape(b, s, hkv, dh)
    v = F.linear(x, p["wv"].to(dt)).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"])
        k = rms_norm(k, p["kn"])
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_full(cfg, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    use_rope: bool = True, return_kv: bool = False):
    """Self-attention over a full sequence at the natural positions
    (prefill); ``return_kv`` also returns the layer's (k, v)."""
    q, k, v = _project_qkv(cfg, p, x, positions, use_rope=use_rope)
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)
    b, s = out.shape[:2]
    y = F.linear(out.reshape(b, s, -1), p["wo"].to(x.dtype))
    return (y, (k, v)) if return_kv else y


def attn_apply_decode(cfg, p: Params, x: torch.Tensor, cache: Params, *,
                      window: int = 0, prefix_len: int = 0,
                      use_rope: bool = True):
    """Self-attention for one new token against the cache."""
    pos = cache["idx"][None]                      # (1,) current position
    q, k, v = _project_qkv(cfg, p, x, pos, use_rope=use_rope)
    out, cache = decode_attention(q, cache, k, v, window=window,
                                  prefix_len=prefix_len)
    y = F.linear(out.reshape(x.shape[0], 1, -1), p["wo"].to(x.dtype))
    return y, cache


def cross_attn_apply(cfg, p: Params, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, S, D) to precomputed encoder K/V (B,
    S_enc, Hkv, Dh): no rope, no mask (whisper's decoder)."""
    b, s, _ = x.shape
    dt = x.dtype
    q = F.linear(x, p["wq"].to(dt)).reshape(b, s, cfg.num_heads,
                                            cfg.head_dim)
    out = kops.flash_attention(q, enc_k.to(dt), enc_v.to(dt), causal=False)
    return F.linear(out.reshape(b, s, -1), p["wo"].to(dt))


def encoder_kv(cfg, p: Params, enc: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, S_enc, Hkv, Dh) of the encoder states."""
    b, s, _ = enc.shape
    dt = enc.dtype
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    return (F.linear(enc, p["wk"].to(dt)).reshape(shape),
            F.linear(enc, p["wv"].to(dt)).reshape(shape))
