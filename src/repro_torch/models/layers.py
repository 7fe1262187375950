"""Shared neural-net primitives on tensors (``repro.models.layers``).

Parameters are plain nested dicts of tensors.  Every ``*_init`` returns
fp32 parameters drawn from an explicit ``torch.Generator`` on the
generator's device; the apply paths cast to the compute dtype (bf16)
and keep normalisation in fp32.  Dense weights are stored ``(out,
in)``, as ``torch.nn.functional.linear`` takes them (the reference
stores ``(in, out)``; ``convert.py`` transposes).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Params = Dict[str, object]

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(g: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, ``(d_out, d_in)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_out, d_in), dtype=PARAM_DTYPE, device=g.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=g)
    return w.mul_(scale)


def embed_init(g: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=g, dtype=PARAM_DTYPE,
                       device=g.device).mul_(0.02)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32; ``weight`` is stored minus one."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def init_norm(cfg, d: int, device=None) -> Params:
    if cfg.norm == "layernorm":
        return {"w": torch.ones(d, dtype=PARAM_DTYPE, device=device),
                "b": torch.zeros(d, dtype=PARAM_DTYPE, device=device)}
    # rmsnorm stores (weight - 1)
    return {"w": torch.zeros(d, dtype=PARAM_DTYPE, device=device)}


def apply_norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])
