"""Participant-side logic: Eq. 7 loss probe + Eq. 1 local SGD training.

- ``dataset_loss_packed``: Eq. 7 over a flat concatenation of every
  client's probe samples (the unfused prefix's probe);
- ``local_train_batch``: Eq. 1 local SGD for a whole cohort at once —
  every leaf carries a leading client axis, the convolutions run as one
  grouped convolution, and one backward pass over the sum of the
  clients' losses gives each client its own gradient.  The per-epoch
  sample permutations are an input (``perms``), so the port and the
  reference can train on the same batches;
- ``evaluate_accuracy``: test-set accuracy of the global model.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.cnn import (cnn_forward, cnn_forward_stacked,
                                    cnn_sample_losses, sample_nll)
from repro_torch.train.optim import sgd_update

Params = Dict[str, torch.Tensor]

# packed probe samples per forward pass; the unfused prefix's probe pack
# pads each client to a whole number of these
PROBE_BATCH = 128


@torch.no_grad()
def dataset_loss_packed(params: Params, images: torch.Tensor,
                        labels: torch.Tensor, seg: torch.Tensor,
                        counts: torch.Tensor, n_clients: int,
                        batch: int = PROBE_BATCH) -> torch.Tensor:
    """Eq. 7 for a cohort in forward passes of ``batch`` packed samples:
    per-sample losses reduced per client with a segment one-hot matvec
    (no float atomics).  images (S, 28, 28, 1); seg (S,) client id per
    sample (``n_clients`` for padding rows); counts (C,).  Returns (C,)
    mean losses."""
    lanes = torch.arange(n_clients + 1, device=images.device)
    tot = torch.zeros(n_clients + 1, device=images.device)
    for s in range(0, images.shape[0], batch):
        losses = cnn_sample_losses(params, images[s:s + batch],
                                   labels[s:s + batch])
        onehot = (seg[s:s + batch, None] == lanes[None, :]).float()
        tot = tot + losses @ onehot
    return tot[:n_clients] / torch.clamp(counts.float(), min=1.0)


def _sample_nll(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked mean NLL over the last axis (one value per leading row)."""
    nll = sample_nll(logits, labels) * mask
    return nll.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def local_train_batch(params: Params, images: torch.Tensor,
                      labels: torch.Tensor, n_valid: torch.Tensor,
                      perms: torch.Tensor, *, epochs: int, batch_size: int,
                      steps_per_epoch: int,
                      lr: float = 0.05) -> Tuple[Params, torch.Tensor]:
    """Eq. 1 local SGD for a cohort of C clients from the shared global
    ``params``.  images (C, cap, 28, 28, 1), labels (C, cap), n_valid
    (C,), perms (epochs, C, cap) int64 sample orders.  Returns (stacked
    params with a leading client axis, (C,) mean last-epoch losses)."""
    c, cap = images.shape[:2]
    batch_size = min(batch_size, cap)
    steps_per_epoch = max(1, steps_per_epoch)
    p = {k: v.detach()[None].expand(c, *v.shape).clone()
         for k, v in params.items()}
    rows = torch.arange(c, device=images.device)[:, None]
    last = torch.zeros(c, device=images.device)
    for e in range(epochs):
        perm = perms[e].to(images.device)
        ep_images, ep_labels = images[rows, perm], labels[rows, perm]
        ep_mask = (perm < n_valid[:, None]).float()
        losses = []
        for i in range(steps_per_epoch):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            loss = _sample_nll(cnn_forward_stacked(leaves, ep_images[:, sl]),
                               ep_labels[:, sl], ep_mask[:, sl])
            g = torch.autograd.grad(loss.sum(), list(leaves.values()))
            with torch.no_grad():
                p = sgd_update(p, dict(zip(leaves, g)), lr)
            losses.append(loss.detach())
        last = torch.stack(losses).mean(dim=0)
    return p, last


@torch.no_grad()
def evaluate_accuracy(params: Params, images: torch.Tensor,
                      labels: torch.Tensor, batch: int = 1024) -> float:
    correct = torch.zeros((), dtype=torch.int64, device=images.device)
    for s in range(0, images.shape[0], batch):
        pred = cnn_forward(params, images[s:s + batch]).argmax(-1)
        correct += (pred == labels[s:s + batch]).sum()
    return float(correct) / float(images.shape[0])
