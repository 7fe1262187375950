"""Model registry (``repro.models.registry``): init / prefill /
decode_step / cache for an ``ArchConfig``, plus ``serving_params`` and
``init_serving_params``."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE, Params

# the weights the forward casts to the compute dtype at every use: the
# embedding and head (gathered/projected in bf16) and, per block, the
# dense matrices (and RWKV's lerp coefficients, mamba's conv, biases and
# skip D), by the block's groups.  Norm weights (n1, n2, final_norm, qk
# norms), w0, u and A_log are read in fp32 and stay fp32.
_CAST_TOP = ("embed", "lm_head")
_CAST_IN_BLOCK = {
    "rwkv": ("mu", "wr", "wk", "wv", "wg", "wo", "wA", "wB", "mu_c", "ck",
             "cv"),
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("wi", "wg", "wo"),
    "mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "D", "out_proj"),
    "moe": ("router", "wi", "wg", "wo"),
}


def init_params(g: torch.Generator, cfg: ArchConfig) -> Params:
    return tfm.init_params(g, cfg)


def prefill_fn(cfg: ArchConfig) -> Callable:
    return functools.partial(tfm.prefill, cfg)


def decode_fn(cfg: ArchConfig, context: int) -> Callable:
    return functools.partial(tfm.decode_step, cfg,
                             window=tfm.decode_window(cfg, context))


def init_cache(cfg: ArchConfig, batch: int, context: int, device=None):
    return tfm.init_cache(cfg, batch, context, device=device)


def _cast(tree: Params) -> Params:
    """Cast, in place, the top-level dict's or one layer's weights that
    the forward casts to bf16 at each use."""
    for key in _CAST_TOP:
        if key in tree:
            tree[key] = tree[key].to(COMPUTE_DTYPE)
    for group, keys in _CAST_IN_BLOCK.items():
        p = tree.get(group, {})
        for key in keys:
            if key in p:
                p[key] = p[key].to(COMPUTE_DTYPE)
    return tree


def serving_params(params: Params) -> Params:
    """Cast, in place and once, every weight that the forward casts to
    bf16 at each use; the forward's numbers do not change, and the
    weights take half the memory and half the bytes per decode step.
    Each fp32 tensor is dropped as soon as its copy exists."""
    _cast(params)
    for lp in params["blocks"]:
        _cast(lp)
    return params


def init_serving_params(g: torch.Generator, cfg: ArchConfig) -> Params:
    """``serving_params(init_params(g, cfg))``, bit for bit, but each
    layer is cast before the next is drawn: the fp32 tree never exists
    whole, and the peak is the bf16 weights plus one layer in fp32."""
    return tfm.init_params(g, cfg, finish=_cast)
