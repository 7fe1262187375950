"""Mamba-1 selective-state-space block, used by jamba's mamba layers
(``repro.models.mamba``), as plain functions on tensors.

A prefill's scan over the sequence goes through
``kernels.ops.selective_scan``: the hand-written kernel for a CUDA
tensor, its plain version on the CPU (the reference's model scans in jnp,
with the same arithmetic: dt and x cast to fp32 before their product).
A decode step (S == 1 with a state) is plain ops, as in the reference,
which multiplies ``delta * xc`` in the compute dtype there.  Every
weight is cast to the compute dtype where the reference casts it, so
parameters kept in bf16 (``registry.serving_params``) give the same
numbers as fp32 ones; ``A_log`` stays fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import PARAM_DTYPE, Params, dense_init, silu


def dt_rank(cfg) -> int:
    return -(-cfg.d_model // 16)          # ceil(d_model / 16)


def init_mamba_layer(g: torch.Generator, cfg) -> Params:
    """One mamba mixer's parameters (fp32, dense weights ``(out, in)``,
    ``conv_w`` (width, Di)), drawn from ``g`` on its device."""
    d, dev = cfg.d_model, g.device
    di, n, rk = cfg.ssm_expand * d, cfg.ssm_state_dim, dt_rank(cfg)
    cw = cfg.ssm_conv_width
    a = torch.arange(1, n + 1, dtype=PARAM_DTYPE, device=dev).repeat(di, 1)
    return {
        "in_proj": dense_init(g, d, 2 * di),
        "conv_w": torch.randn((cw, di), generator=g, dtype=PARAM_DTYPE,
                              device=dev).div_(math.sqrt(cw)),
        "conv_b": torch.zeros(di, dtype=PARAM_DTYPE, device=dev),
        "x_proj": dense_init(g, di, rk + 2 * n),
        "dt_proj": dense_init(g, rk, di),
        "dt_bias": torch.full((di,), -4.6, dtype=PARAM_DTYPE,
                              device=dev),           # softplus^-1(0.01)
        "A_log": torch.log(a),
        "D": torch.ones(di, dtype=PARAM_DTYPE, device=dev),
        "out_proj": dense_init(g, di, d),
    }


def init_mamba_state(cfg, batch: int, device=None) -> Params:
    """A zero state: the conv's last ``width - 1`` inputs and the scan
    state h, both fp32."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di),
                            dtype=torch.float32, device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state_dim),
                         dtype=torch.float32, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) step by step in x's
    dtype, as XLA computes it; ``F.softplus`` rounds bf16 otherwise and
    turns to the identity above 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``hist`` (B, S + width - 1, Di) with
    taps ``w`` (width, Di), both in the compute dtype -> (B, S, Di): the
    taps summed in fp32 and rounded once, as XLA:CPU's bf16
    ``conv_general_dilated`` (prefill) and ``einsum`` (decode) round."""
    cw = w.shape[0]
    s = hist.shape[1] - cw + 1
    acc = hist[:, :s].float() * w[0].float()
    for k in range(1, cw):
        acc = acc + hist[:, k:k + s].float() * w[k].float()
    return acc.to(hist.dtype)


def mamba_apply(cfg, p: Params, x: torch.Tensor, state: Optional[Params]
                ) -> Tuple[torch.Tensor, Params]:
    """x (B, S, D).  S == 1 with a state is a decode step; otherwise a
    prefill from ``state`` (zeros when None).  Returns (y (B, S, D),
    the new state {conv, h})."""
    b, s, _ = x.shape
    di, n, rk = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim, dt_rank(cfg)
    cw = cfg.ssm_conv_width
    dt_ = x.dtype
    xi, z = F.linear(x, p["in_proj"].to(dt_)).chunk(2, dim=-1)

    decode = s == 1 and state is not None
    first = (torch.zeros((b, cw - 1, di), dtype=dt_, device=x.device)
             if state is None else state["conv"].to(dt_))
    hist = torch.cat([first, xi], dim=1)               # (B, S+cw-1, Di)
    xc = causal_conv(hist, p["conv_w"].to(dt_)) + p["conv_b"].to(dt_)
    new_conv = hist[:, -(cw - 1):].float()
    xc = silu(xc)

    dbc = F.linear(xc, p["x_proj"].to(dt_))            # (B, S, rk+2N)
    dt_r, bmat, cmat = torch.split(dbc, [rk, n, n], dim=-1)
    delta = softplus(F.linear(dt_r, p["dt_proj"].to(dt_))
                     + p["dt_bias"].to(dt_))           # (B, S, Di)
    a = -torch.exp(p["A_log"].float())                 # (Di, N)

    h0 = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
          if state is None else state["h"])
    if decode:
        da = torch.exp(delta[:, 0, :, None].float() * a)
        h = da * h0 + (delta[:, 0] * xc[:, 0]).float()[..., None] \
            * bmat[:, 0].float()[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float())[:, None]
        y, h_t = y.to(dt_), h
    else:
        y, h_t = kops.selective_scan(xc, delta, bmat.contiguous(),
                                     cmat.contiguous(), a, h0)
    y = y + xc * p["D"].to(dt_)
    out = F.linear(y * silu(z), p["out_proj"].to(dt_))
    return out, {"conv": new_conv, "h": h_t}
