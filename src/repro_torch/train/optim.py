"""Plain SGD — the paper's local update rule (Eq. 1)."""
from __future__ import annotations

from typing import Dict

import torch


def sgd_update(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               lr: float) -> Dict[str, torch.Tensor]:
    return {k: p - lr * grads[k] for k, p in params.items()}
