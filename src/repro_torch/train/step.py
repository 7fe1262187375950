"""Training step factory (``repro.train.step``): gradient accumulation
over microbatches, then one AdamW update.

``make_train_step(cfg, shape, opt)`` returns ``train_step(params,
opt_state, batch)``: the batch's rows are split into
``shape.grad_accum`` microbatches in order (activation memory /
grad_accum), each microbatch's loss is differentiated, the fp32
gradients are summed microbatch by microbatch and divided by their
count, and one ``adamw_update`` follows, which updates ``params`` and
``opt_state`` in place (``train/optim.py``).  The reference scans the
microbatches under ``jit``; the port loops.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import (OptConfig, adamw_update, tree_leaves,
                                     tree_unflatten)


def _split_micro(batch: Dict[str, torch.Tensor],
                 ga: int) -> List[Dict[str, torch.Tensor]]:
    """(GB, ...) -> ga microbatches of GB / ga rows each, in order."""
    rows = next(iter(batch.values())).shape[0]
    if rows % ga:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{ga} microbatches")
    mb = rows // ga
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(ga)]


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt: OptConfig) -> Callable:
    ga = max(1, shape.grad_accum)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        acc, loss_sum, ms = None, None, []
        try:
            for p in leaves:
                p.requires_grad_(True)
            for mb in _split_micro(batch, ga):
                loss, metrics = tfm.train_loss(cfg, params, mb)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g.float()
                         for p, g in zip(leaves, grads)]
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                del grads
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                ms.append({k: v.detach() for k, v in metrics.items()})
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if ga > 1:
            for a in acc:
                a.div_(ga)
        params, opt_state, opt_metrics = adamw_update(
            opt, tree_unflatten(params, acc), opt_state, params)
        metrics = {k: torch.stack([m[k] for m in ms]).mean()
                   for k in ms[0]}
        metrics.update(opt_metrics)
        metrics["loss"] = loss_sum / ga
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = tfm.train_loss(cfg, params, batch)
        return metrics

    return eval_step
