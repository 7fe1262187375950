"""Optimizers and LR schedules (``repro.train.optim``): AdamW with
decoupled weight decay under linear-warmup cosine, MiniCPM's WSD
(warmup-stable-decay, arXiv:2404.06395 §4) or a constant schedule; and
plain SGD, the paper's local update rule (Eq. 1).

Parameters, gradients and optimizer moments are trees of dicts and
lists with tensor leaves, walked in the reference's leaf order (a
dict's keys sorted, a list in order).  ``adamw_update`` follows the
reference's order of operations in fp32 (clip by the global norm, the
moments, bias correction, decay) but updates the parameters and the
moments in place and returns them: the reference builds new trees, and
at gemma-2b's 2.5 B parameters a second copy of the parameters and the
moments would not fit beside the first on one 80 GB card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch

Params = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | constant
    wsd_decay_frac: float = 0.1       # last 10% of steps decay (WSD)
    min_lr_frac: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a scalar tensor) as an
    fp32 scalar, by the reference's fp32 operations."""
    step = _f32(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        frac = torch.clamp(
            (step - decay_start)
            / max(cfg.total_steps - decay_start, 1.0), 0.0, 1.0)
        # exponential-style anneal to min_lr_frac
        decayed = cfg.lr * torch.pow(_f32(cfg.min_lr_frac), frac)
        return warm * torch.where(step < decay_start, _f32(cfg.lr), decayed)
    # cosine
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1.0), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos))


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensor leaves in the reference's order."""
    return [t for t, _ in _walk(tree, False)]


def _walk(tree: Params, stacked: bool) -> Iterator[Tuple[torch.Tensor, int]]:
    """(leaf, the leaf's ndim in the reference's layout) in the
    reference's order.  The reference stacks a list of layers on a
    leading axis, so a leaf inside a list counts one more dimension."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _walk(tree[key], stacked)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _walk(item, True)
    elif torch.is_tensor(tree):
        yield tree, tree.ndim + int(stacked)
    elif tree is not None:
        raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def tree_unflatten(tree: Params, leaves) -> Params:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its tensors."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node, key=str)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(tree)


def tree_map(fn, tree: Params) -> Params:
    """``fn`` over every tensor leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def adamw_init(params: Params) -> Dict[str, Any]:
    """Zero first and second moments of the parameters' shapes and
    dtypes, and step 0 (an int32 scalar)."""
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over the leaves, in order, of each leaf's sum of
    squares in fp32, on the leaves' device."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Params, state: Dict[str, Any],
                 params: Params) -> Tuple[Params, Dict[str, Any], Dict]:
    """One AdamW step: the step count, its learning rate, the gradients
    clipped to ``grad_clip`` by their global norm, the moments, their
    bias correction, and decay on the leaves that are matrices in the
    reference's layout (ndim >= 2 there: a per-layer norm weight or
    bias of the port's ``blocks`` is a row of a stacked (L, D) leaf in
    the reference, which decays it).  The gradients are scaled, and the
    parameters and moments updated, in place.  Returns ``(params,
    state, {"lr", "grad_norm"})``."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.betas

    gnorm = _global_norm(grads)
    scale = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                             1.0)
             if cfg.grad_clip > 0 else _f32(1.0, gnorm.device))
    dev = gnorm.device
    bc1 = (1 - torch.pow(_f32(b1), step.float())).to(dev)
    bc2 = (1 - torch.pow(_f32(b2), step.float())).to(dev)
    lr_d = lr.to(dev)

    for (p, ndim), g, m, v in zip(_walk(params, False), tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
        g.mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if ndim >= 2:                      # decay matrices only
            u.add_(cfg.weight_decay * p)
        p.sub_(lr_d * u)
    return params, dict(state, step=step), {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------
# plain SGD: the paper's local update rule (Eq. 1)
# --------------------------------------------------------------------------

def sgd_update(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               lr: float) -> Dict[str, torch.Tensor]:
    return {k: p - lr * grads[k] for k, p in params.items()}
