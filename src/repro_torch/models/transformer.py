"""Model assembly (``repro.models.transformer``) for every family of the
reference:

- ssm (RWKV-6), dense (gemma-2b, yi-6b, granite-8b, minicpm-2b) and moe
  (qwen3-moe, phi3.5-moe: every layer's MLP an MoE): decoder layers;
- hybrid (jamba): mamba and attention layers, MoE on every other one;
- audio (whisper): an encoder over precomputed frame embeddings, then
  decoder layers with cross-attention to it;
- vlm (paligemma): the dense decoder over precomputed patch embeddings
  before the tokens, with prefix-LM masking over them at prefill.

Entry points: ``train_loss`` (every family; each layer recomputed in
backward, as the reference's ``remat=True``), ``prefill`` and
``decode_step``.

Parameters are a nested dict: ``embed`` (V, D), ``final_norm``,
``lm_head`` (V, D) unless tied, ``blocks``, a list with one dict per
layer in layer order, and for the audio family ``encoder`` (``layers``,
a list, and ``final_norm``).  The reference stacks layers, or jamba's
groups of ``attn_layer_period`` layers, on a leading axis and scans
over it; the port loops.  The decode cache is ``{"layers": [one entry
per layer]}``: an RWKV state, an attention layer's slot cache
(``attention.make_kv_cache``) or a mamba layer's ``{conv, h}``; the
audio family's adds ``cross_k`` and ``cross_v``, a list of each
decoder layer's encoder K/V (B, S_enc, Hkv, Dh).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, apply_mlp,
                                       apply_norm, chunked_cross_entropy,
                                       dense_init, embed_init, init_mlp,
                                       init_norm, weak_scalar)

MOE_LB_COEF = 0.01
MOE_Z_COEF = 0.001


def _layer_body(cfg: ArchConfig, i: int) -> Tuple[str, bool]:
    """(mixer, is_moe) of decoder layer ``i``: 'rwkv', 'attn' or
    'mamba'; a hybrid layer takes the kind of its place in its group, as
    the reference's group body does, and every layer of the dense, moe
    and vlm families layer 0's MoE flag, as the reference's scan body
    does."""
    if cfg.family == "ssm":
        return "rwkv", False
    if cfg.family == "hybrid":
        j = i % cfg.attn_layer_period
        return cfg.layer_kind(j), cfg.layer_is_moe(j)
    return "attn", cfg.layer_is_moe(0)


# ==========================================================================
# init
# ==========================================================================

def _init_rwkv_layer(g: torch.Generator, cfg: ArchConfig) -> Params:
    return {"n1": init_norm(cfg, cfg.d_model, g.device),
            "n2": init_norm(cfg, cfg.d_model, g.device),
            "rwkv": rwkv.init_rwkv_layer(g, cfg)}


def _init_whisper_enc_layer(g: torch.Generator, cfg: ArchConfig) -> Params:
    return {"n1": init_norm(cfg, cfg.d_model, g.device),
            "n2": init_norm(cfg, cfg.d_model, g.device),
            "attn": attn.init_attention(g, cfg, cfg.d_model),
            "mlp": init_mlp(g, cfg, cfg.d_model, cfg.d_ff)}


def _init_whisper_dec_layer(g: torch.Generator, cfg: ArchConfig) -> Params:
    return {"n1": init_norm(cfg, cfg.d_model, g.device),
            "nc": init_norm(cfg, cfg.d_model, g.device),
            "n2": init_norm(cfg, cfg.d_model, g.device),
            "attn": attn.init_attention(g, cfg, cfg.d_model),
            "xattn": attn.init_cross_attention(g, cfg, cfg.d_model),
            "mlp": init_mlp(g, cfg, cfg.d_model, cfg.d_ff)}


def _init_layer(g: torch.Generator, cfg: ArchConfig, i: int) -> Params:
    """Decoder layer ``i``: norms, its mixer (attention or mamba), then
    its MLP or MoE (whisper's: self-attention, cross-attention, MLP)."""
    mixer, is_moe = _layer_body(cfg, i)
    if mixer == "rwkv":
        return _init_rwkv_layer(g, cfg)
    if cfg.family == "audio":
        return _init_whisper_dec_layer(g, cfg)
    p = {"n1": init_norm(cfg, cfg.d_model, g.device),
         "n2": init_norm(cfg, cfg.d_model, g.device)}
    if mixer == "attn":
        p["attn"] = attn.init_attention(g, cfg, cfg.d_model)
    else:
        p["mamba"] = mam.init_mamba_layer(g, cfg)
    if is_moe:
        p["moe"] = moe_mod.init_moe(g, cfg, cfg.d_model)
    else:
        p["mlp"] = init_mlp(g, cfg, cfg.d_model, cfg.d_ff)
    return p


def init_params(g: torch.Generator, cfg: ArchConfig,
                finish: Optional[Callable[[Params], Params]] = None
                ) -> Params:
    """The full parameter tree (fp32), drawn from ``g`` on its device.
    ``finish`` (default: none) is applied to the top-level dict before
    the first layer is drawn, and to each layer's dict before the next
    one is drawn (``registry.init_serving_params`` casts there); the
    audio family's encoder layers are drawn first."""
    finish = finish or (lambda p: p)
    params: Params = {
        "embed": embed_init(g, cfg.vocab_size, cfg.d_model),
        "final_norm": init_norm(cfg, cfg.d_model, g.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, cfg.vocab_size)
    params = finish(params)
    if cfg.family == "audio":
        params["encoder"] = {
            "layers": [finish(_init_whisper_enc_layer(g, cfg))
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, g.device)}
    params["blocks"] = [finish(_init_layer(g, cfg, i))
                        for i in range(cfg.num_layers)]
    return params


def decode_window(cfg: ArchConfig, context: int) -> int:
    """The sliding window of a decode over ``context`` positions: the
    arch's, once the context exceeds it; 0 (none) otherwise."""
    if cfg.sliding_window and context > cfg.sliding_window:
        return cfg.sliding_window
    return 0


def init_cache(cfg: ArchConfig, batch: int, context: int,
               device=None) -> Params:
    """Decode cache, one entry per layer: a zero RWKV or mamba state
    (``context`` unused), or an empty slot cache of ``context``
    positions, only the window's (a ring) once the context exceeds the
    window; the audio family's adds zero encoder K/V per layer."""
    slots = decode_window(cfg, context) or context
    layers = []
    for i in range(cfg.num_layers):
        mixer = _layer_body(cfg, i)[0]
        if mixer == "rwkv":
            layers.append(rwkv.init_rwkv_state(cfg, batch, device=device))
        elif mixer == "mamba":
            layers.append(mam.init_mamba_state(cfg, batch, device=device))
        else:
            layers.append(attn.make_kv_cache(batch, slots, cfg.num_kv_heads,
                                             cfg.head_dim, device=device))
    if cfg.family != "audio":
        return {"layers": layers}
    shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    zeros = lambda: [torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                     for _ in range(cfg.num_layers)]
    return {"layers": layers, "cross_k": zeros(), "cross_v": zeros()}


# ==========================================================================
# dense layers
# ==========================================================================

def _residual(cfg: ArchConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    return x + y * weak_scalar(cfg.residual_scale, y.dtype)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z}


def _sum_aux(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    return {k: a[k] + b[k] for k in a}


def _ffn(cfg: ArchConfig, lp: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The layer's MLP or MoE -> (y, the MoE's {lb_loss, z_loss}, None
    for an MLP).  Training sums them over the layers (``_sum_aux``, an
    MLP's as zeros); serving uses y alone."""
    h = apply_norm(cfg, lp["n2"], x)
    if "moe" in lp:
        y, aux = moe_mod.apply_moe(cfg, lp["moe"], h)
        return y, {"lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}
    return apply_mlp(cfg, lp["mlp"], h), None


def _dense_layer_full(cfg, lp, x, positions, *, window=0, prefix_len=0):
    """Pre-norm attention then MLP over the full sequence; returns (x,
    the layer's (k, v))."""
    h = apply_norm(cfg, lp["n1"], x)
    y, kv = attn.attn_apply_full(cfg, lp["attn"], h, positions,
                                 window=window, prefix_len=prefix_len,
                                 return_kv=True)
    x = _residual(cfg, x, y)
    return _residual(cfg, x, _ffn(cfg, lp, x)[0]), kv


def _dense_layer_decode(cfg, lp, x, cache, *, window=0, prefix_len=0):
    h = apply_norm(cfg, lp["n1"], x)
    y, cache = attn.attn_apply_decode(cfg, lp["attn"], h, cache,
                                      window=window, prefix_len=prefix_len)
    x = _residual(cfg, x, y)
    return _residual(cfg, x, _ffn(cfg, lp, x)[0]), cache


def _run_dense_stack(cfg, params, x, positions, *, mode, cache=None,
                     window=0, prefix_len=0, context=0):
    """Every layer in order; returns (x, the new cache)."""
    if mode == "decode":
        layers = []
        for lp, c in zip(params["blocks"], cache["layers"]):
            x, c = _dense_layer_decode(cfg, lp, x, c, window=window,
                                       prefix_len=prefix_len)
            layers.append(c)
        return x, {"layers": layers}
    kvs = []
    for lp in params["blocks"]:
        x, kv = _dense_layer_full(cfg, lp, x, positions, window=window,
                                  prefix_len=prefix_len)
        kvs.append(kv)
    return x, _kvs_to_cache(cfg, kvs, positions, context)


def _dense_layer_train(cfg, lp, x, positions, prefix_len):
    """A dense or MoE layer over the full sequence without a cache ->
    (x, lb_loss, z_loss)."""
    h = apply_norm(cfg, lp["n1"], x)
    x = _residual(cfg, x, attn.attn_apply_full(cfg, lp["attn"], h, positions,
                                               prefix_len=prefix_len))
    y, aux = _ffn(cfg, lp, x)
    aux = aux or _zero_aux(x.device)
    return _residual(cfg, x, y), aux["lb_loss"], aux["z_loss"]


def _recomputed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations
    recomputed in backward, as ``jax.checkpoint`` does in the reference's
    scan bodies."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _run_dense_stack_train(cfg, params, x, positions, prefix_len):
    """Every layer in order, each recomputed in backward; returns (x,
    the aux losses summed over the layers in order)."""
    aux = _zero_aux(x.device)
    for lp in params["blocks"]:
        x, lb, z = _recomputed(_dense_layer_train, cfg, lp, x, positions,
                               prefix_len)
        aux = _sum_aux(aux, {"lb_loss": lb, "z_loss": z})
    return x, aux


def _mamba_layer_train(cfg, lp, x):
    """A hybrid mamba layer over the full sequence from a zero state ->
    (x, lb_loss, z_loss)."""
    x, _, aux = _mamba_layer(cfg, lp, x, None)
    aux = aux or _zero_aux(x.device)
    return x, aux["lb_loss"], aux["z_loss"]


def _run_hybrid_stack_train(cfg, params, x, positions):
    """Every layer in order, each by the kind of its place in its group
    and recomputed in backward (the reference recomputes a group of
    ``attn_layer_period`` layers at once: the same numbers); returns (x,
    the aux losses summed over the layers in order)."""
    aux = _zero_aux(x.device)
    for i, lp in enumerate(params["blocks"]):
        if _layer_body(cfg, i)[0] == "mamba":
            x, lb, z = _recomputed(_mamba_layer_train, cfg, lp, x)
        else:
            x, lb, z = _recomputed(_dense_layer_train, cfg, lp, x,
                                   positions, 0)
        aux = _sum_aux(aux, {"lb_loss": lb, "z_loss": z})
    return x, aux


def _mamba_layer(cfg, lp, x, state):
    """Pre-norm mamba then MLP or MoE; returns (x, the mamba state, the
    MoE's aux losses or None)."""
    y, state = mam.mamba_apply(cfg, lp["mamba"], apply_norm(cfg, lp["n1"], x),
                               state)
    x = _residual(cfg, x, y)
    y, aux = _ffn(cfg, lp, x)
    return _residual(cfg, x, y), state, aux


def _run_hybrid_stack(cfg, params, x, positions, *, mode, cache=None,
                      window=0, context=0):
    """Every layer in order, each by the kind of its place in its group;
    returns (x, the new cache): attention layers' slot caches, mamba
    layers' states."""
    layers, attn_at, kvs = [], [], []
    for i, lp in enumerate(params["blocks"]):
        c = cache["layers"][i] if mode == "decode" else None
        if _layer_body(cfg, i)[0] == "mamba":
            x, c, _ = _mamba_layer(cfg, lp, x, c)
        elif mode == "decode":
            x, c = _dense_layer_decode(cfg, lp, x, c, window=window)
        else:
            x, kv = _dense_layer_full(cfg, lp, x, positions, window=window)
            attn_at.append(i)
            kvs.append(kv)
        layers.append(c)
    if kvs:
        for i, c in zip(attn_at, _kvs_to_cache(cfg, kvs, positions,
                                              context)["layers"]):
            layers[i] = c
    return x, {"layers": layers}


def _kvs_to_cache(cfg, kvs: List[Tuple[torch.Tensor, torch.Tensor]],
                  positions: torch.Tensor, context: int = 0) -> Params:
    """Turn the prefill's per-layer (B, S, Hkv, Dh) K/V into slot caches.

    ``context`` is the total number of positions the cache must serve
    (prompt + decode headroom); without it, the first decode step would
    ring-wrap onto slot 0 and drop the first prompt token.  A
    sliding-window arch whose context exceeds the window keeps the last
    ``window`` positions in ring order (slot = pos % window): a roll of
    the tail, padded with empty slots when the prompt is shorter."""
    s = positions.shape[0]
    slots, keep, shift = max(s, context), s, 0
    if cfg.sliding_window and slots > cfg.sliding_window:
        slots = cfg.sliding_window
        keep = min(slots, s)
        shift = (s - keep) % slots
    pad = slots - keep
    pos = torch.cat([positions[s - keep:].to(torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32,
                                device=positions.device)])
    layers = []
    for k, v in kvs:
        zeros = k.new_zeros((k.shape[0], pad) + k.shape[2:],
                            dtype=COMPUTE_DTYPE)
        k, v = (torch.cat([t[:, s - keep:].to(COMPUTE_DTYPE), zeros], dim=1)
                for t in (k, v))
        layers.append({"k": torch.roll(k, shift, dims=1),
                       "v": torch.roll(v, shift, dims=1),
                       "pos": torch.roll(pos, shift),
                       "idx": torch.full((), s, dtype=torch.int32,
                                         device=pos.device)})
    return {"layers": layers}


# ==========================================================================
# forward passes
# ==========================================================================

def _run_rwkv_stack(cfg, params, x, *, mode, cache=None):
    """Every block in order; returns (x, per-layer states)."""
    states = []
    for i, lp in enumerate(params["blocks"]):
        st = cache["layers"][i] if mode == "decode" else None
        x, st = rwkv.rwkv_layer_apply(
            cfg, lp["rwkv"], {"n1": lp["n1"]["w"], "n2": lp["n2"]["w"]},
            x, st)
        states.append(st)
    return x, {"layers": states}


def _run_rwkv_stack_train(cfg, params, x):
    """Every block in order from a zero state, each recomputed in
    backward -> x."""
    for lp in params["blocks"]:
        x = _recomputed(rwkv.rwkv_layer_apply, cfg, lp["rwkv"],
                        {"n1": lp["n1"]["w"], "n2": lp["n2"]["w"]}, x,
                        None)[0]
    return x


def _sinusoidal(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) fp32 sinusoidal positions: sines, then cosines."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_layer(cfg, lp, x, pos):
    x = x + attn.attn_apply_full(cfg, lp["attn"],
                                 apply_norm(cfg, lp["n1"], x), pos,
                                 causal=False, use_rope=False)
    return x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["n2"], x))


def run_encoder(cfg: ArchConfig, params: Params, frames: torch.Tensor,
                train: bool = False) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, S_enc,
    D): sinusoidal positions, then pre-norm bidirectional attention (no
    rope) and MLP a layer; ``train`` recomputes each layer in
    backward."""
    x = frames.to(COMPUTE_DTYPE)
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    enc = params["encoder"]
    for lp in enc["layers"]:
        x = (_recomputed(_encoder_layer, cfg, lp, x, pos) if train
             else _encoder_layer(cfg, lp, x, pos))
    return apply_norm(cfg, enc["final_norm"], x)


def _whisper_layer_train(cfg, lp, x, positions, enc):
    """A decoder layer over the full sequence without a cache: causal
    self-attention, cross-attention to K/V computed here from ``enc``
    (so the cross-attention's gradient reaches the encoder), MLP."""
    x = x + attn.attn_apply_full(cfg, lp["attn"],
                                 apply_norm(cfg, lp["n1"], x), positions)
    xk, xv = attn.encoder_kv(cfg, lp["xattn"], enc)
    x = x + attn.cross_attn_apply(cfg, lp["xattn"],
                                  apply_norm(cfg, lp["nc"], x), xk, xv)
    return x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["n2"], x))


def _run_whisper_decoder(cfg, params, x, positions, *, mode, enc=None,
                         cache=None, window=0, context=0):
    """Every decoder layer in order: self-attention, cross-attention to
    the encoder (its K/V computed from ``enc`` at prefill, read from the
    cache in decode), MLP.  Returns (x, the new cache)."""
    layers, kvs, cross_k, cross_v = [], [], [], []
    for i, lp in enumerate(params["blocks"]):
        h = apply_norm(cfg, lp["n1"], x)
        if mode == "decode":
            a, c = attn.attn_apply_decode(cfg, lp["attn"], h,
                                          cache["layers"][i], window=window)
            layers.append(c)
            xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        else:
            a, kv = attn.attn_apply_full(cfg, lp["attn"], h, positions,
                                         window=window, return_kv=True)
            kvs.append(kv)
            xk, xv = attn.encoder_kv(cfg, lp["xattn"], enc)
            cross_k.append(xk.to(COMPUTE_DTYPE))
            cross_v.append(xv.to(COMPUTE_DTYPE))
        x = x + a
        x = x + attn.cross_attn_apply(cfg, lp["xattn"],
                                      apply_norm(cfg, lp["nc"], x), xk, xv)
        x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["n2"], x))
    if mode == "decode":
        return x, dict(cache, layers=layers)
    cache = _kvs_to_cache(cfg, kvs, positions, context)
    return x, dict(cache, cross_k=cross_k, cross_v=cross_v)


def _embed(cfg: ArchConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(COMPUTE_DTYPE)
    if cfg.scale_embed:
        x = x * weak_scalar(math.sqrt(cfg.d_model), x.dtype)
    return x


def forward(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, mode: str,
            cache: Optional[Params] = None, window: int = 0,
            context: int = 0) -> Tuple[torch.Tensor, Params]:
    """mode: 'train' | 'prefill' | 'decode'.  Returns (hidden (B, S, D),
    the new cache), and in train mode (hidden, {lb_loss, z_loss} summed
    over the layers): no cache, each layer recomputed in backward.
    ``window`` masks a sliding window; ``context`` sizes a prefill's
    cache (both unused by the recurrent family and in train mode).  A
    prefill or train batch holds ``tokens`` and, for the audio family,
    ``frames`` (B, S_enc, D), for the vlm family ``prefix`` (B, P, D),
    whose P positions come before the tokens' and attend
    bidirectionally."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    x = _embed(cfg, params, batch["tokens"])
    prefix_len = 0
    if cfg.family == "vlm" and mode != "decode":
        x = torch.cat([batch["prefix"].to(COMPUTE_DTYPE), x], dim=1)
        prefix_len = cfg.num_prefix_tokens
    positions = torch.arange(x.shape[1], device=x.device)
    if mode == "train":
        aux = _zero_aux(x.device)
        if cfg.family == "ssm":
            x = _run_rwkv_stack_train(cfg, params, x)
        elif cfg.family == "hybrid":
            x, aux = _run_hybrid_stack_train(cfg, params, x, positions)
        elif cfg.family == "audio":
            enc = run_encoder(cfg, params, batch["frames"], train=True)
            for lp in params["blocks"]:
                x = _recomputed(_whisper_layer_train, cfg, lp, x, positions,
                                enc)
        else:
            x, aux = _run_dense_stack_train(cfg, params, x, positions,
                                            prefix_len)
        return apply_norm(cfg, params["final_norm"], x), aux
    kw = dict(mode=mode, cache=cache, window=window, context=context)
    if cfg.family == "ssm":
        x, cache = _run_rwkv_stack(cfg, params, x, mode=mode, cache=cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid_stack(cfg, params, x, positions, **kw)
    elif cfg.family == "audio":
        enc = (run_encoder(cfg, params, batch["frames"])
               if mode == "prefill" else None)
        x, cache = _run_whisper_decoder(cfg, params, x, positions, enc=enc,
                                        **kw)
    else:
        x, cache = _run_dense_stack(cfg, params, x, positions,
                                    prefix_len=prefix_len, **kw)
    return apply_norm(cfg, params["final_norm"], x), cache


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a bf16 product with the (V, D) head: ``lm_head``,
    or the tied embedding."""
    head = params.get("lm_head", params["embed"])
    return F.linear(x, head.to(x.dtype)).float()


def train_loss(cfg: ArchConfig, params: Params,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over the batch (``tokens``, ``targets``, ``mask``;
    ``prefix`` for the vlm family), the prefix positions dropped, through
    ``chunked_cross_entropy`` with the head or the tied embedding; the
    MoE's aux losses added with the reference's coefficients.  Returns
    (loss, {ce, loss, tokens, lb_loss, z_loss}), fp32 scalars."""
    x, aux = forward(cfg, params, batch, mode="train")
    if cfg.family == "vlm":
        x = x[:, cfg.num_prefix_tokens:]
    tot, cnt = chunked_cross_entropy(x, params["embed"], batch["targets"],
                                     batch["mask"].float(),
                                     head=params.get("lm_head"),
                                     softcap=cfg.logit_softcap)
    ce = tot / torch.clamp_min(cnt, 1.0)
    loss = ce
    if cfg.is_moe:
        loss = (loss + MOE_LB_COEF * aux["lb_loss"]
                + MOE_Z_COEF * aux["z_loss"])
    metrics = {"ce": ce, "loss": loss, "tokens": cnt,
               "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}
    return loss, metrics


def prefill(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], context: int = 0,
            window: int = 0) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt; return last-position logits (B, 1, V) fp32
    and the decode cache.  ``context`` sizes the cache for prompt +
    decode headroom; ``window`` masks the prompt pass with a sliding
    window."""
    x, cache = forward(cfg, params, batch, mode="prefill", context=context,
                       window=window)
    return _logits(params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor,
                window: int = 0) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V), updated
    cache."""
    x, cache = forward(cfg, params, {"tokens": tokens}, mode="decode",
                       cache=cache, window=window)
    return _logits(params, x), cache
