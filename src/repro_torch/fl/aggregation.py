"""Model aggregation (paper Eq. 2) and FedProx's proximal gradient.

FedAvg: w_g = sum_i (|D_i|/|D|) w_i over the models that arrived before
the deadline.  FedProx (cited as [17]) adds mu/2 * ||w - w_g||^2 to the
local objective, which the local trainer takes as the gradient term
``prox_grad``.  ``fedavg`` averages a list of models (the loop engine);
``fedavg_masked`` a leading client axis (the batched engine).  With a
``mesh`` (``launch/mesh.py``), the leading client axis holds only this
rank's share of the cohort, and the sums finish with an all-reduce over
the ranks, so the average lands on every rank without the ranks' model
stacks ever being gathered.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import ClientMesh, psum

Params = Dict[str, torch.Tensor]


def _psum_flat(mesh: ClientMesh, parts: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``parts`` summed over the ranks, in one
    all-reduce of their concatenation."""
    flat = psum(mesh, torch.cat([v.reshape(-1) for v in parts.values()]))
    out, at = {}, 0
    for key, v in parts.items():
        out[key] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


def fedavg(models: Sequence[Params], weights: Sequence[float]) -> Params:
    """Eq. 2 over a list of models: the sample-quantity-weighted
    average, each leaf summed in fp32 in list order."""
    first = models[0]
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=next(iter(first.values())).device)
    w = w / torch.clamp(w.sum(), min=1e-9)
    return {k: torch.tensordot(w, torch.stack([m[k] for m in models])
                               .float(), dims=1).to(leaf.dtype)
            for k, leaf in first.items()}


def prox_grad(params: Params, global_params: Params, mu: float) -> Params:
    """FedProx's proximal gradient: mu * (w - w_g), leaf by leaf (a
    leading client axis on ``params`` broadcasts against w_g's)."""
    return {k: mu * (p - global_params[k]) for k, p in params.items()}


def fedavg_masked(stacked_models: Params, weights: torch.Tensor,
                  mesh: Optional[ClientMesh] = None) -> Params:
    """FedAvg over a leading client axis with (possibly zero) weights
    (C,): padding rows at weight zero drop out.  With ``mesh``, the
    weight total and then the weighted model sum each finish with an
    all-reduce over the ranks."""
    tot = weights.sum()
    if mesh is not None:
        tot = psum(mesh, tot)
    w = weights / torch.clamp(tot, min=1e-9)
    parts = {k: torch.tensordot(w, leaf.float(), dims=1)
             for k, leaf in stacked_models.items()}
    if mesh is not None:
        parts = _psum_flat(mesh, parts)
    return {k: parts[k].to(leaf.dtype) for k, leaf in stacked_models.items()}


def fedavg_sums(stacked_models: Params, weights: torch.Tensor,
                mesh: Optional[ClientMesh] = None
                ) -> Tuple[Params, torch.Tensor]:
    """The unnormalized half of Eq. 2: ``(sum_i w_i * model_i, sum_i
    w_i)``, all-reduced over the ranks with ``mesh``.  The grouped
    trainer adds these across capacity groups and divides once, so a
    round of several groups is still one weighted average."""
    parts = {k: torch.tensordot(weights, leaf.float(), dims=1)
             for k, leaf in stacked_models.items()}
    parts["__total__"] = weights.sum().reshape(1)
    if mesh is not None:
        parts = _psum_flat(mesh, parts)
    tot = parts.pop("__total__")[0]
    return parts, tot
