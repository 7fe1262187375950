"""Carry parameters between the JAX reference's pytrees and the port.

For the CNN the reference stores ``{"conv1": {"w": HWIO, "b"}, ...,
"fc1": {"w": (in, out), "b"}, ...}``; the port stores a flat dict in
PyTorch's layout (conv OIHW, dense ``(out, in)``).  The fc1 ``in`` axis
keeps the NHWC flatten order on both sides — ``cnn_forward`` permutes
its activation to NHWC before flattening, so no row of fc1 is permuted
here.  For the LM zoo see ``rwkv_params_from_jax`` and
``dense_params_from_jax``.
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


# dense weights of the LM blocks: (in, out) in the reference, (out, in)
# here, by block group
RWKV_DENSE = ("wr", "wk", "wv", "wg", "wo", "wA", "wB", "ck", "cv")
_LM_DENSE = {"rwkv": RWKV_DENSE, "attn": ("wq", "wk", "wv", "wo"),
             "mlp": ("wi", "wg", "wo")}


def _lm_params_from_jax(tree: Mapping, device=None) -> Dict:
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    blocks = tree["blocks"]
    out = {"embed": t(tree["embed"]),
           "final_norm": {k: t(v) for k, v in tree["final_norm"].items()},
           "blocks": []}
    if "lm_head" in tree:
        out["lm_head"] = t(np.asarray(tree["lm_head"]).T)
    for i in range(np.asarray(blocks["n1"]["w"]).shape[0]):
        out["blocks"].append({
            group: {k: t(np.asarray(v)[i].T if k in _LM_DENSE.get(group, ())
                         else np.asarray(v)[i]) for k, v in leaves.items()}
            for group, leaves in blocks.items()})
    return out


def rwkv_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's ssm-family parameter tree (numpy or array-like
    leaves; ``blocks`` stacked on a leading layer axis) -> the port's
    (``blocks`` a list of per-layer dicts, dense weights and the head
    ``(out, in)``).  Norm weights are copied as stored (weight - 1)."""
    return _lm_params_from_jax(tree, device)


def dense_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's dense-family parameter tree (``blocks`` stacked
    on a leading layer axis, each with ``n1``, ``n2``, ``attn`` and
    ``mlp``) -> the port's per-layer list, the attention and MLP weights
    and the head ``(out, in)``.  Norm weights (and qk norms) are copied
    as stored (weight - 1)."""
    return _lm_params_from_jax(tree, device)
