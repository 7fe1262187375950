"""Carry CNN parameters between the JAX reference's pytree and the port.

The reference stores ``{"conv1": {"w": HWIO, "b"}, ..., "fc1": {"w":
(in, out), "b"}, ...}``; the port stores a flat dict in PyTorch's layout
(conv OIHW, dense ``(out, in)``).  The fc1 ``in`` axis keeps the NHWC
flatten order on both sides — ``cnn_forward`` permutes its activation to
NHWC before flattening, so no row of fc1 is permuted here.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

CONV = ("conv1", "conv2")
DENSE = ("fc1", "fc2")


def params_from_jax(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """Nested numpy (or array-like) reference params -> port params."""
    out = {}
    for name in CONV + DENSE:
        w = np.asarray(tree[name]["w"])
        w = w.transpose(3, 2, 0, 1) if name in CONV else w.T
        out[name + ".w"] = torch.tensor(np.ascontiguousarray(w),
                                        device=device)
        out[name + ".b"] = torch.tensor(np.asarray(tree[name]["b"]),
                                        device=device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict:
    """Port params -> the reference's nested numpy layout."""
    out = {}
    for name in CONV + DENSE:
        w = params[name + ".w"].detach().cpu().numpy()
        w = w.transpose(2, 3, 1, 0) if name in CONV else w.T
        out[name] = {"w": np.ascontiguousarray(w),
                     "b": params[name + ".b"].detach().cpu().numpy()}
    return out
