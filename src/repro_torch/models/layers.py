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
import torch.nn.functional as F
import torch.utils.checkpoint

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


def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX casts a weakly typed Python
    float to the array's dtype before it multiplies (torch multiplies a
    bf16 tensor by the fp32 value instead, which rounds some products
    the other way)."""
    return torch.tensor(c, dtype=dtype).item()


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings.  x: (..., S, H, Dh); positions: (..., S).  The
    rotation is fp32 (a bf16 x promotes), cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


# --------------------------------------------------------------------------
# MLP (gated and plain)
# --------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` (``x * sigmoid(x)``) step by step in x's dtype, as
    XLA computes it: bit-equal in bf16, where ``F.silu`` rounds once."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def init_mlp(g: torch.Generator, cfg, d: int, d_ff: int) -> Params:
    p = {"wi": dense_init(g, d, d_ff)}
    if cfg.hidden_act in ("silu", "geglu"):
        p["wg"] = dense_init(g, d, d_ff)
    p["wo"] = dense_init(g, d_ff, d)
    return p


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.linear(x, p["wi"].to(dt))
    if cfg.hidden_act == "silu":
        h = silu(h) * F.linear(x, p["wg"].to(dt))
    elif cfg.hidden_act == "geglu":
        h = F.gelu(h, approximate="tanh") * F.linear(x, p["wg"].to(dt))
    elif cfg.hidden_act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.hidden_act == "relu_sq":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(cfg.hidden_act)
    return F.linear(h, p["wo"].to(dt))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _chunk_nll(xc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor, softcap: float):
    """One chunk's (sum of masked NLL, sum of mask): fp32 logits of the
    chunk's product with ``w`` cast to x's dtype, soft-capped."""
    logits = F.linear(xc, w.to(xc.dtype)).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_cross_entropy(x: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          head: Optional[torch.Tensor] = None,
                          softcap: float = 0.0, chunk: int = 512):
    """Cross-entropy without the whole (B, S, V) logits.

    x: (B, S, D) final hidden states; ``head`` (V, D), or the tied
    ``embed`` (V, D) (both ``(out, in)``, as the port stores them).  The
    sequence is cut into the largest number of equal chunks not above
    ``S // chunk``, as the reference's scan does; each chunk's logits
    exist only while its sums are taken, in backward too (each chunk
    runs under ``torch.utils.checkpoint``, which recomputes its logits
    for its gradient).  Returns (sum of NLL over the mask, sum of the
    mask), each added up chunk by chunk in order from 0."""
    b, s, d = x.shape
    w = head if head is not None else embed
    n_chunks = max(1, s // chunk)
    while s % n_chunks:                                   # largest divisor
        n_chunks -= 1
    c = s // n_chunks
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], w, labels[:, sl], mask[:, sl].float(), softcap)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            t, n = torch.utils.checkpoint.checkpoint(
                _chunk_nll, *args, use_reentrant=False)
        else:
            t, n = _chunk_nll(*args)
        tot, cnt = tot + t, cnt + n
    return tot, cnt
