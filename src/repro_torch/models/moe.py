"""Mixture-of-Experts layer: top-k routing, capacity dispatch, aux
losses (``repro.models.moe``), as plain functions on tensors.

The reference's dense dispatch: each assignment's position within its
expert comes from a stable sort (token-major, k-minor), assignments past
the capacity drop, the kept ones fill a per-expert (E, C, D) buffer, the
experts run as batched products, and each token sums its k weighted
outputs.  The expert products are jnp in the reference, outside any
Pallas kernel, and plain ``torch`` products here.  The reference's
expert-parallel ``shard_map`` path comes with the sharded axis (ROADMAP
A11b).

Layouts: ``router`` is ``(E, D)`` (``(out, in)``, as every dense
weight of the port); the expert stacks ``wi``, ``wg`` (E, D, F) and
``wo`` (E, F, D) keep the reference's ``(in, out)`` per expert, which
``torch.bmm`` takes as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PARAM_DTYPE, Params, dense_init, silu


def _expert_stack(g: torch.Generator, e: int, d_in: int,
                  d_out: int) -> torch.Tensor:
    """``e`` truncated-normal fan-in matrices ``(e, d_in, d_out)``."""
    w = torch.empty((e, d_in, d_out), dtype=PARAM_DTYPE, device=g.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=g)
    return w.mul_(1.0 / math.sqrt(d_in))


def init_moe(g: torch.Generator, cfg, d: int) -> Params:
    e, ff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    return {"router": dense_init(g, d, e, scale=0.02),
            "wi": _expert_stack(g, e, d, ff),
            "wg": _expert_stack(g, e, d, ff),
            "wo": _expert_stack(g, e, ff, d)}


def _positions_in_expert(flat_e: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, in the order of
    ``flat_e`` (a stable sort), int32."""
    tk = flat_e.shape[0]
    perm = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts          # exclusive cumsum
    pos_sorted = torch.arange(tk, device=flat_e.device) - starts[flat_e[perm]]
    pos = torch.empty_like(pos_sorted)
    pos[perm] = pos_sorted
    return pos.to(torch.int32)


def moe_capacity(cfg, tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.experts_per_token * tokens
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)                     # round up to 8


def apply_moe(cfg, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x (B, S, D) -> (B, S, D), aux {lb_loss, z_loss, expert_load}: the
    dense dispatch (the port has no mesh)."""
    return _apply_moe_dense(cfg, p, x)


def _apply_moe_dense(cfg, p: Params, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, t)
    xt = x.reshape(t, d)
    dt = x.dtype

    logits = F.linear(xt, p["router"].to(dt)).float()          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the larger first, the lower index first on ties
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[:, :k], sel[:, :k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    flat_e = sel.reshape(-1)                                   # (T*k,)
    pos = _positions_in_expert(flat_e, e)
    kept = pos < cap
    keep = kept.to(dt)
    pos_c = torch.clamp_max(pos, cap - 1).long()
    tok = torch.arange(t * k, device=x.device) // k

    # dispatch: each kept assignment owns its (expert, position) slot;
    # the dropped ones write into a spare row, which is cut off
    slot = torch.where(kept, flat_e * cap + pos_c, e * cap)
    buf = xt.new_zeros((e * cap + 1, d))
    buf[slot] = xt[tok]
    buf = buf[:e * cap].view(e, cap, d)

    h = torch.bmm(buf, p["wi"].to(dt))
    h = silu(h) * torch.bmm(buf, p["wg"].to(dt))
    y_e = torch.bmm(h, p["wo"].to(dt))                          # (E, C, D)

    # combine: each token's k outputs, summed in k order
    gathered = (y_e[flat_e, pos_c] * keep[:, None]
                * w.reshape(-1)[:, None].to(dt)).view(t, k, d)
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]

    # aux losses (Switch-style load balance + router z-loss)
    me = probs.mean(0)                                          # (E,)
    assign = torch.bincount(flat_e, minlength=e).float() / (t * k)
    lb = e * torch.sum(me * assign)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"lb_loss": lb, "z_loss": z, "expert_load": assign}
    return y.reshape(b, s, d), aux


def _apply_moe_ep(cfg, p: Params, x: torch.Tensor, mesh=None):
    """The reference's expert-parallel ``shard_map`` program."""
    raise NotImplementedError(
        "expert-parallel MoE (shard_map over a 'model' mesh axis) comes "
        "with the sharded axis over torch.distributed, ROADMAP A11b")
