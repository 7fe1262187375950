"""Model aggregation (paper Eq. 2).

FedAvg: w_g = sum_i (|D_i|/|D|) w_i over the models that arrived before
the deadline.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def fedavg_masked(stacked_models: Params, weights: torch.Tensor) -> Params:
    """FedAvg over a leading client axis with (possibly zero) weights
    (C,) — padding rows at weight zero drop out."""
    w = weights / torch.clamp(weights.sum(), min=1e-9)
    return {k: torch.tensordot(w, leaf.float(), dims=1).to(leaf.dtype)
            for k, leaf in stacked_models.items()}

