"""Carry parameters between the JAX reference's pytrees and the port.

For the CNN the reference stores ``{"conv1": {"w": HWIO, "b"}, ...,
"fc1": {"w": (in, out), "b"}, ...}``; the port stores a flat dict in
PyTorch's layout (conv OIHW, dense ``(out, in)``).  The fc1 ``in`` axis
keeps the NHWC flatten order on both sides — ``cnn_forward`` permutes
its activation to NHWC before flattening, so no row of fc1 is permuted
here.  For the LM zoo see ``rwkv_params_from_jax``,
``dense_params_from_jax`` (also the moe and vlm families),
``hybrid_params_from_jax`` and ``audio_params_from_jax``; for the
optimizer state of LM training ``adamw_state_from_jax``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

CONV = ("conv1", "conv2")
DENSE = ("fc1", "fc2")


def params_from_jax(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """Nested numpy (or array-like) reference params -> port params.
    Leading axes (a stack of models, as the event server's pool keeps)
    carry through: only the trailing weight axes are permuted."""
    out = {}
    for name in CONV + DENSE:
        w = np.asarray(tree[name]["w"])
        lead = tuple(range(w.ndim - (4 if name in CONV else 2)))
        k = len(lead)
        w = w.transpose(*lead, *((k + 3, k + 2, k, k + 1) if name in CONV
                                 else (k + 1, k)))
        out[name + ".w"] = torch.tensor(np.ascontiguousarray(w),
                                        device=device)
        out[name + ".b"] = torch.tensor(np.asarray(tree[name]["b"]),
                                        device=device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict:
    """Port params -> the reference's nested numpy layout (leading axes
    carry through, as in ``params_from_jax``)."""
    out = {}
    for name in CONV + DENSE:
        w = params[name + ".w"].detach().cpu().numpy()
        lead = tuple(range(w.ndim - (4 if name in CONV else 2)))
        k = len(lead)
        w = w.transpose(*lead, *((k + 2, k + 3, k + 1, k) if name in CONV
                                 else (k + 1, k)))
        out[name] = {"w": np.ascontiguousarray(w),
                     "b": params[name + ".b"].detach().cpu().numpy()}
    return out


# dense weights of the LM blocks: (in, out) in the reference, (out, in)
# here, by block group (the MoE's expert stacks keep (E, in, out))
RWKV_DENSE = ("wr", "wk", "wv", "wg", "wo", "wA", "wB", "ck", "cv")
_LM_DENSE = {"rwkv": RWKV_DENSE, "attn": ("wq", "wk", "wv", "wo"),
             "xattn": ("wq", "wk", "wv", "wo"),
             "mlp": ("wi", "wg", "wo"),
             "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj"),
             "moe": ("router",)}


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _block_from_jax(blocks: Mapping, i: int, device=None) -> Dict:
    """Entry ``i`` of a stacked block tree, dense weights transposed."""
    return {group: {k: _t(np.asarray(v)[i].T if k in _LM_DENSE.get(group, ())
                          else np.asarray(v)[i], device)
                    for k, v in leaves.items()}
            for group, leaves in blocks.items()}


def _stack_from_jax(stacked: Mapping, device=None) -> list:
    """One block dict per entry of a layer-stacked block tree."""
    return [_block_from_jax(stacked, i, device)
            for i in range(np.asarray(stacked["n1"]["w"]).shape[0])]


def _lm_params_from_jax(tree: Mapping, device=None, blocks=None) -> Dict:
    """The embedding, head and final norm, and ``blocks`` (default: one
    per entry of the reference's layer-stacked ``blocks``)."""
    out = {"embed": _t(tree["embed"], device),
           "final_norm": {k: _t(v, device)
                          for k, v in tree["final_norm"].items()}}
    if "lm_head" in tree:
        out["lm_head"] = _t(np.asarray(tree["lm_head"]).T, device)
    out["blocks"] = (_stack_from_jax(tree["blocks"], device)
                     if blocks is None else blocks)
    return out


def rwkv_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's ssm-family parameter tree (numpy or array-like
    leaves; ``blocks`` stacked on a leading layer axis) -> the port's
    (``blocks`` a list of per-layer dicts, dense weights and the head
    ``(out, in)``).  Norm weights are copied as stored (weight - 1)."""
    return _lm_params_from_jax(tree, device)


def dense_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's dense-, moe- or vlm-family parameter tree
    (``blocks`` stacked on a leading layer axis, each with ``n1``,
    ``n2``, ``attn`` and ``mlp`` or ``moe``) -> the port's per-layer
    list, the attention and MLP weights, the router and the head ``(out,
    in)``, the expert stacks as stored (E, in, out).  Norm weights (and
    qk norms) are copied as stored (weight - 1)."""
    return _lm_params_from_jax(tree, device)


def hybrid_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's hybrid-family parameter tree (``blocks`` a tuple
    of ``attn_layer_period`` layer dicts, each stacked on a leading group
    axis) -> the port's per-layer list in layer order (layer ``g *
    period + i`` is entry ``i`` of group ``g``), dense weights and the
    head ``(out, in)``, the router ``(E, D)``, the expert stacks as
    stored (E, in, out).  Norm weights are copied as stored (weight -
    1); ``A_log`` and ``conv_w`` (width, Di) as stored."""
    period = tree["blocks"]
    groups = np.asarray(period[0]["n1"]["w"]).shape[0]
    blocks = [_block_from_jax(period[i], g, device)
              for g in range(groups) for i in range(len(period))]
    return _lm_params_from_jax(tree, device, blocks)


def audio_params_from_jax(tree: Mapping, device=None) -> Dict:
    """The reference's audio-family parameter tree (``encoder``:
    ``layers`` stacked, each with ``n1``, ``n2``, ``attn`` and ``mlp``,
    and ``final_norm``; ``blocks`` stacked, each adding ``nc`` and the
    cross-attention ``xattn``) -> the port's per-layer lists, dense
    weights and the head ``(out, in)``.  Layernorm weights and biases
    are copied as stored."""
    out = _lm_params_from_jax(tree, device)
    enc = tree["encoder"]
    out["encoder"] = {"layers": _stack_from_jax(enc["layers"], device),
                      "final_norm": {k: _t(v, device) for k, v in
                                     enc["final_norm"].items()}}
    return out


def adamw_state_from_jax(state: Mapping, device=None) -> Dict:
    """The reference's AdamW state ``{m, v, step}`` of a dense-, moe- or
    vlm-family model -> the port's: ``m`` and ``v`` mapped as
    ``dense_params_from_jax`` maps the parameters, ``step`` an int32
    scalar."""
    return {"m": dense_params_from_jax(state["m"], device),
            "v": dense_params_from_jax(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}
