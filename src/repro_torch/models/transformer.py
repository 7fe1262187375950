"""Model assembly (``repro.models.transformer``), for the families the
port serves: the attention-free ``ssm`` family (RWKV-6).

Parameters are a nested dict: ``embed`` (V, D), ``final_norm``,
``lm_head`` (V, D) unless tied, and ``blocks``, a list with one dict
per layer (the reference stacks layers on a leading axis and scans
over it; the port loops).  The decode cache is ``{"layers": [state per
layer]}``.  Any other family raises ``NotImplementedError`` (ROADMAP
A13).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, apply_norm,
                                       dense_init, embed_init, init_norm)


def _require_ssm(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port serves the ssm family (rwkv6); the others come with "
            f"ROADMAP A13")


# ==========================================================================
# init
# ==========================================================================

def _init_rwkv_layer(g: torch.Generator, cfg: ArchConfig) -> Params:
    return {"n1": init_norm(cfg, cfg.d_model, g.device),
            "n2": init_norm(cfg, cfg.d_model, g.device),
            "rwkv": rwkv.init_rwkv_layer(g, cfg)}


def init_params(g: torch.Generator, cfg: ArchConfig) -> Params:
    """The full parameter tree (fp32), drawn from ``g`` on its device."""
    _require_ssm(cfg)
    params: Params = {
        "embed": embed_init(g, cfg.vocab_size, cfg.d_model),
        "final_norm": init_norm(cfg, cfg.d_model, g.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, cfg.vocab_size)
    params["blocks"] = [_init_rwkv_layer(g, cfg)
                        for _ in range(cfg.num_layers)]
    return params


def init_cache(cfg: ArchConfig, batch: int, context: int,
               device=None) -> Params:
    """Decode cache: one zero state per layer (``context`` is unused by
    a recurrent model; it is the reference's interface)."""
    _require_ssm(cfg)
    return {"layers": [rwkv.init_rwkv_state(cfg, batch, device=device)
                       for _ in range(cfg.num_layers)]}


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
    return x, states


def forward(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, mode: str,
            cache: Optional[Params] = None
            ) -> Tuple[torch.Tensor, Params]:
    """mode: 'prefill' | 'decode'.  Returns (hidden (B, S, D), the new
    cache)."""
    _require_ssm(cfg)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    x = params["embed"][batch["tokens"]].to(COMPUTE_DTYPE)
    x, states = _run_rwkv_stack(cfg, params, x, mode=mode, cache=cache)
    return apply_norm(cfg, params["final_norm"], x), {"layers": states}


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a bf16 product with the (V, D) head: ``lm_head``,
    or the tied embedding."""
    head = params.get("lm_head", params["embed"])
    return F.linear(x, head.to(x.dtype)).float()


def prefill(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt; return last-position logits (B, 1, V) fp32
    and the decode cache."""
    x, cache = forward(cfg, params, batch, mode="prefill")
    return _logits(params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V), updated
    cache."""
    x, cache = forward(cfg, params, {"tokens": tokens}, mode="decode",
                       cache=cache)
    return _logits(params, x), cache
