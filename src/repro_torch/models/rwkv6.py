"""RWKV-6 (Finch) block: data-dependent decay WKV recurrence + channel mix
(``repro.models.rwkv6``), as plain functions on tensors.

The recurrence over a sequence goes through ``kernels.ops.wkv6``: the
hand-written kernel for a CUDA tensor, its plain version on the CPU.
A decode step (T == 1) is ``wkv6_step`` in plain ops, as in the
reference.  Dtypes follow the reference: r, k, v and g in the compute
dtype (bf16), the decay ``w`` and the bonus ``u`` in fp32, the state
``S`` in fp32.  Every weight is cast to the compute dtype where the
reference casts it, so parameters kept in bf16 (``registry.
serving_params``) give the same numbers as fp32 ones.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import PARAM_DTYPE, Params, dense_init, rms_norm


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_rwkv_layer(g: torch.Generator, cfg) -> Params:
    """One block's time-mix and channel-mix parameters (fp32, dense
    weights ``(out, in)``), drawn from ``g`` on its device."""
    d, r, dev = cfg.d_model, cfg.rwkv_decay_lora, g.device

    def uniform(*shape):
        return torch.rand(shape, generator=g, dtype=PARAM_DTYPE, device=dev)

    return {
        # time-mix
        "mu": uniform(5, d),                          # lerp r, k, v, g, w
        "wr": dense_init(g, d, d),
        "wk": dense_init(g, d, d),
        "wv": dense_init(g, d, d),
        "wg": dense_init(g, d, d),
        "wo": dense_init(g, d, d),
        "w0": torch.full((d,), -6.0, dtype=PARAM_DTYPE, device=dev),
        "wA": dense_init(g, d, r, scale=0.01),
        "wB": dense_init(g, r, d, scale=0.01),
        "u": torch.randn(d, generator=g, dtype=PARAM_DTYPE,
                         device=dev).mul_(0.1),        # bonus
        "ln_x": torch.zeros(d, dtype=PARAM_DTYPE, device=dev),
        # channel-mix
        "mu_c": uniform(2, d),
        "ck": dense_init(g, d, cfg.d_ff),
        "cv": dense_init(g, cfg.d_ff, d),
    }


def init_rwkv_state(cfg, batch: int, device=None) -> Params:
    """A zero state: the last inputs of the time and channel mix and
    the WKV state, all fp32 (a prefill's cache holds the inputs in the
    compute dtype)."""
    d, n = cfg.d_model, cfg.rwkv_head_size
    h = d // n
    return {
        "x_tm": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "x_cm": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "S": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
    }


def wkv6_step(r, k, v, w, u, s):
    """Single decode step.  r..w: (B, H, N); s: (B, H, N, N)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r, s + u[..., :, None] * kv)
    s = w[..., :, None] * s + kv
    return y, s


# --------------------------------------------------------------------------
# block apply
# --------------------------------------------------------------------------

def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), the
    double exponential in fp32."""
    dt = xw.dtype
    lora = F.linear(torch.tanh(F.linear(xw, p["wA"].to(dt))),
                    p["wB"].to(dt))
    return torch.exp(-torch.exp(p["w0"].float() + lora.float()))


def _heads(x: torch.Tensor, h: int, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (h, n))


def _shifted(x: torch.Tensor, state: Optional[Params],
             key: str) -> torch.Tensor:
    """The previous token's input at every position: the state's for the
    first (zeros without a state), x's own after that."""
    b, s, d = x.shape
    if s == 1 and state is not None:
        return state[key][:, None, :].to(x.dtype)
    first = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
             if state is None else state[key][:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix_apply(cfg, p: Params, x: torch.Tensor,
                   state: Optional[Params]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D).  ``state`` None => prefill from zeros."""
    b, s, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    dt = x.dtype
    x_prev = _shifted(x, state, "x_tm")

    mu = p["mu"].to(dt)
    xr, xk, xv, xg, xw = (x_prev + mu[i] * (x - x_prev) for i in range(5))
    r = _heads(F.linear(xr, p["wr"].to(dt)), h, n)
    k = _heads(F.linear(xk, p["wk"].to(dt)), h, n)
    v = _heads(F.linear(xv, p["wv"].to(dt)), h, n)
    g = F.silu(F.linear(xg, p["wg"].to(dt)))
    w = _heads(_decay(p, xw), h, n)
    u = _heads(p["u"].float(), h, n)

    s0 = (torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
          if state is None else state["S"])
    if s == 1:
        y, s_t = wkv6_step(r[:, 0].float(), k[:, 0].float(),
                           v[:, 0].float(), w[:, 0], u, s0)
        y = y[:, None].to(dt)
    else:
        y, s_t = kops.wkv6(r, k, v, w, u, s0)
    y = rms_norm(y.reshape(b, s, d), p["ln_x"])     # stand-in for groupnorm
    out = F.linear(y * g, p["wo"].to(dt))
    return out, {"x_tm": x[:, -1, :], "S": s_t}


def channel_mix_apply(cfg, p: Params, x: torch.Tensor,
                      state: Optional[Params]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    dt = x.dtype
    x_prev = _shifted(x, state, "x_cm")
    mu = p["mu_c"].to(dt)
    xk = x_prev + mu[0] * (x - x_prev)
    xr = x_prev + mu[1] * (x - x_prev)
    kk = torch.square(torch.relu(F.linear(xk, p["ck"].to(dt))))
    out = torch.sigmoid(xr) * F.linear(kk, p["cv"].to(dt))
    return out, {"x_cm": x[:, -1, :]}


def rwkv_layer_apply(cfg, p: Params, norms: Params, x: torch.Tensor,
                     state: Optional[Params]
                     ) -> Tuple[torch.Tensor, Params]:
    """Pre-norm residual block: time-mix then channel-mix.  ``norms``
    holds the two rmsnorm weights ``n1`` and ``n2``."""
    h1, st_tm = time_mix_apply(cfg, p, rms_norm(x, norms["n1"]), state)
    x = x + h1
    h2, st_cm = channel_mix_apply(cfg, p, rms_norm(x, norms["n2"]), state)
    x = x + h2
    return x, {**st_tm, **st_cm}
