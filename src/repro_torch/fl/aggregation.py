"""Model aggregation (paper Eq. 2) and FedProx's proximal gradient.

FedAvg: w_g = sum_i (|D_i|/|D|) w_i over the models that arrived before
the deadline.  FedProx (cited as [17]) adds mu/2 * ||w - w_g||^2 to the
local objective, which the local trainer takes as the gradient term
``prox_grad``.  ``fedavg`` averages a list of models (the loop engine);
``fedavg_masked`` a leading client axis (the batched engine).  With a
``mesh`` (``launch/mesh.py``), the leading client axis holds only this
rank's share of the cohort, and the sums finish with an all-reduce over
the ranks, so the average lands on every rank without the ranks' model
stacks ever being gathered.  The weighted sums accumulate in fp64, so
the average does not depend on how the cohort is split.
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
    """Eq. 2 over a list of models (the loop engine): ``fedavg_masked``
    of their stack, in list order."""
    first = models[0]
    dev = next(iter(first.values())).device
    return fedavg_masked({k: torch.stack([m[k] for m in models])
                          for k in first},
                         torch.as_tensor(weights, dtype=torch.float32,
                                         device=dev))


def prox_grad(params: Params, global_params: Params, mu: float) -> Params:
    """FedProx's proximal gradient: mu * (w - w_g), leaf by leaf (a
    leading client axis on ``params`` broadcasts against w_g's)."""
    return {k: mu * (p - global_params[k]) for k, p in params.items()}


def fedavg_masked(stacked_models: Params, weights: torch.Tensor,
                  mesh: Optional[ClientMesh] = None) -> Params:
    """FedAvg over a leading client axis with (possibly zero) weights
    (C,): padding rows at weight zero drop out.  With ``mesh``, the
    sums finish with an all-reduce over the ranks.  ``fedavg_finish``
    of ``fedavg_sums``."""
    return fedavg_finish(*fedavg_sums(stacked_models, weights, mesh),
                         stacked_models)


def fedavg_sums(stacked_models: Params, weights: torch.Tensor,
                mesh: Optional[ClientMesh] = None
                ) -> Tuple[Params, torch.Tensor]:
    """The unnormalized half of Eq. 2: ``(sum_i w_i * model_i, sum_i
    w_i)``, all-reduced over the ranks with ``mesh``.  The grouped
    trainer adds these across capacity groups and divides once, so a
    round of several groups is still one weighted average.

    The sums accumulate in fp64, where each product of an fp32 weight
    and an fp32 parameter is exact: the fp32 average then comes out the
    same however the cohort is split (into capacity groups, padded
    buckets, list order or the ranks' slices), up to an fp64 rounding
    that meets an fp32 rounding boundary.  In fp32 those orders left
    ulps that the next round's SGD grew into other test predictions."""
    w = weights.double()
    parts = {k: torch.tensordot(w, leaf.double(), dims=1)
             for k, leaf in stacked_models.items()}
    parts["__total__"] = w.sum().reshape(1)
    if mesh is not None:
        parts = _psum_flat(mesh, parts)
    tot = parts.pop("__total__")[0]
    return parts, tot


def fedavg_finish(num: Params, den: torch.Tensor, like: Params) -> Params:
    """Eq. 2 from ``fedavg_sums``' (num, den): num / den (den clamped
    to 1e-9), in ``like``'s dtypes."""
    inv = 1.0 / torch.clamp(den, min=1e-9)
    return {k: (num[k] * inv).to(like[k].dtype) for k in num}
