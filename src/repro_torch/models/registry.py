"""Model registry (``repro.models.registry``): init / train_loss /
prefill / decode_step / cache for an ``ArchConfig``, a concrete batch
for each, plus ``serving_params`` and ``init_serving_params``."""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE, Params

# the weights the forward casts to the compute dtype at every use: the
# embedding and head (gathered/projected in bf16) and, per block (and per
# encoder layer), the dense matrices (and RWKV's lerp coefficients,
# mamba's conv, biases and skip D, the MoE's router and expert stacks),
# by the block's groups.  Norm weights (n1, nc, n2, final_norm, qk norms,
# layernorm biases), w0, u and A_log are read in fp32 and stay fp32.
_CAST_TOP = ("embed", "lm_head")
_CAST_IN_BLOCK = {
    "rwkv": ("mu", "wr", "wk", "wv", "wg", "wo", "wA", "wB", "mu_c", "ck",
             "cv"),
    "attn": ("wq", "wk", "wv", "wo"),
    "xattn": ("wq", "wk", "wv", "wo"),
    "mlp": ("wi", "wg", "wo"),
    "mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "D", "out_proj"),
    "moe": ("router", "wi", "wg", "wo"),
}


def init_params(g: torch.Generator, cfg: ArchConfig) -> Params:
    return tfm.init_params(g, cfg)


def train_loss_fn(cfg: ArchConfig) -> Callable:
    return functools.partial(tfm.train_loss, cfg)


def prefill_fn(cfg: ArchConfig) -> Callable:
    return functools.partial(tfm.prefill, cfg)


def decode_fn(cfg: ArchConfig, context: int) -> Callable:
    return functools.partial(tfm.decode_step, cfg,
                             window=tfm.decode_window(cfg, context))


def init_cache(cfg: ArchConfig, batch: int, context: int, device=None):
    return tfm.init_cache(cfg, batch, context, device=device)


def stub_inputs(cfg: ArchConfig, batch: int,
                g: torch.Generator) -> Params:
    """The embeddings that stand in for a modality frontend, drawn from
    ``g`` on its device in the compute dtype, as the reference's stubs
    are random: the audio family's ``frames`` (B, encoder_seq, D), the
    vlm family's ``prefix`` (B, num_prefix_tokens, D); none for the
    other families."""
    stubs = {"audio": ("frames", cfg.encoder_seq),
             "vlm": ("prefix", cfg.num_prefix_tokens)}
    if cfg.family not in stubs:
        return {}
    key, n = stubs[cfg.family]
    return {key: torch.randn((batch, n, cfg.d_model), generator=g,
                             device=g.device).to(COMPUTE_DTYPE)}


def make_concrete_batch(cfg: ArchConfig, shape: ShapeConfig,
                        g: torch.Generator, kind: str
                        ) -> Dict[str, torch.Tensor]:
    """A random batch of ``shape`` drawn from ``g`` on its device, in the
    reference's key order: the vlm family's ``prefix`` (B,
    num_prefix_tokens, D) or the audio family's ``frames`` (B,
    encoder_seq, D) in the compute dtype, then ``tokens`` and, for
    ``kind == "train"``, ``targets`` (int64 in [0, vocab)) and ``mask``
    (ones, fp32); a vlm batch holds ``seq_len - num_prefix_tokens``
    tokens."""
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        s -= cfg.num_prefix_tokens
    batch.update(stub_inputs(cfg, b, g))
    keys = ("tokens", "targets") if kind == "train" else ("tokens",)
    for key in keys:
        batch[key] = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                   device=g.device)
    if kind == "train":
        batch["mask"] = torch.ones((b, s), dtype=torch.float32,
                                   device=g.device)
    return batch


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
    encoder = params.get("encoder", {"layers": []})["layers"]
    for lp in encoder + params["blocks"]:
        _cast(lp)
    return params


def init_serving_params(g: torch.Generator, cfg: ArchConfig) -> Params:
    """``serving_params(init_params(g, cfg))``, bit for bit, but each
    layer is cast before the next is drawn: the fp32 tree never exists
    whole, and the peak is the bf16 weights plus one layer in fp32."""
    return tfm.init_params(g, cfg, finish=_cast)
