"""Participant-side logic: Eq. 7 loss probe + Eq. 1 local SGD training.

- ``dataset_loss_packed``: Eq. 7 over a flat concatenation of every
  client's probe samples (the unfused prefix's probe);
- ``local_train_batch``: Eq. 1 local SGD for a whole cohort at once —
  every leaf carries a leading client axis, the convolutions run as one
  grouped convolution, and one backward pass over the sum of the
  clients' losses gives each client its own gradient.  The per-epoch
  sample permutations are an input (``perms``), so the port and the
  reference can train on the same batches.  ``prox_mu > 0`` adds
  FedProx's proximal gradient mu * (w - w_g) to every step;
- ``local_train``: one client's Eq. 1 loop (the loop engine's), a
  cohort of one;
- ``evaluate_accuracy_async``: the test set's correct count of the
  global model, left on the device so a round driver reads it only
  after enqueuing the next round's prefix.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.fl.aggregation import prox_grad
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
                      steps_per_epoch: int, lr: float = 0.05,
                      prox_mu: float = 0.0) -> Tuple[Params, torch.Tensor]:
    """Eq. 1 local SGD for a cohort of C clients from the shared global
    ``params``.  images (C, cap, 28, 28, 1), labels (C, cap), n_valid
    (C,), perms (epochs, C, cap) int64 sample orders.  ``prox_mu > 0``
    adds ``prox_grad(w, w_g, prox_mu)`` to each step's gradient, w_g the
    global params broadcast over the cohort; at 0 the term is skipped,
    not added as zeros.  Returns (stacked params with a leading client
    axis, (C,) mean last-epoch losses)."""
    c, cap = images.shape[:2]
    batch_size = min(batch_size, cap)
    steps_per_epoch = max(1, steps_per_epoch)
    p = {k: v.detach()[None].expand(c, *v.shape).clone()
         for k, v in params.items()}
    global_stacked = {k: v.detach()[None] for k, v in params.items()}
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
            g = dict(zip(leaves, torch.autograd.grad(
                loss.sum(), list(leaves.values()))))
            with torch.no_grad():
                if prox_mu > 0.0:
                    pg = prox_grad(p, global_stacked, prox_mu)
                    g = {k: g[k] + pg[k] for k in g}
                p = sgd_update(p, g, lr)
            losses.append(loss.detach())
        last = torch.stack(losses).mean(dim=0)
    return p, last


def local_train(params: Params, images: torch.Tensor, labels: torch.Tensor,
                n_valid: torch.Tensor, perms: torch.Tensor, *, epochs: int,
                batch_size: int, steps_per_epoch: int, lr: float = 0.05,
                prox_mu: float = 0.0) -> Tuple[Params, torch.Tensor]:
    """One client's Eq. 1 local SGD (the loop engine's call): images
    (cap, 28, 28, 1), labels (cap,), n_valid a scalar, perms (epochs,
    cap), trained as a cohort of one.  Returns (params, mean last-epoch
    loss)."""
    p, loss = local_train_batch(
        params, images[None], labels[None], n_valid.reshape(1),
        perms[:, None], epochs=epochs, batch_size=batch_size,
        steps_per_epoch=steps_per_epoch, lr=lr, prox_mu=prox_mu)
    return {k: v[0] for k, v in p.items()}, loss[0]


@torch.no_grad()
def evaluate_accuracy_async(params: Params, images: torch.Tensor,
                            labels: torch.Tensor, batch: int = 1024
                            ) -> Tuple[torch.Tensor, int]:
    """Enqueue the test-set accuracy without waiting for it: ``(correct
    count, a device int64, n_samples)``."""
    correct = torch.zeros((), dtype=torch.int64, device=images.device)
    for s in range(0, images.shape[0], batch):
        pred = cnn_forward(params, images[s:s + batch]).argmax(-1)
        correct += (pred == labels[s:s + batch]).sum()
    return correct, images.shape[0]
