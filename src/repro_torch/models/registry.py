"""Model registry (``repro.models.registry``): init / prefill /
decode_step / cache for an ``ArchConfig``, plus ``serving_params``."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE, Params

# the weights the forward casts to the compute dtype at every use: the
# embedding and head (gathered/projected in bf16) and, per block, the
# dense matrices (and RWKV's lerp coefficients), by the block's groups.
# Norm weights (n1, n2, final_norm, qk norms), w0 and u are read in fp32
# and stay fp32.
_CAST_IN_BLOCK = {
    "rwkv": ("mu", "wr", "wk", "wv", "wg", "wo", "wA", "wB", "mu_c", "ck",
             "cv"),
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("wi", "wg", "wo"),
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


def serving_params(params: Params) -> Params:
    """Cast, in place and once, every weight that the forward casts to
    bf16 at each use; the forward's numbers do not change, and the
    weights take half the memory and half the bytes per decode step.
    Each fp32 tensor is dropped as soon as its copy exists."""
    for key in ("embed", "lm_head"):
        if key in params:
            params[key] = params[key].to(COMPUTE_DTYPE)
    for lp in params["blocks"]:
        for group, keys in _CAST_IN_BLOCK.items():
            p = lp.get(group, {})
            for key in keys:
                if key in p:
                    p[key] = p[key].to(COMPUTE_DTYPE)
    return params
