"""Architecture and input-shape configuration dataclasses.

A copy of ``repro.configs.base``: each architecture the port serves has
a module in this package defining ``CONFIG: ArchConfig`` with the
published hyperparameters (source in ``citation``); ``get_arch``
resolves the ``--arch`` CLI ids to them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """A single transformer/SSM/hybrid architecture: the decoder
    backbone.  For the audio and vlm families the modality frontend is
    a stub, and ``encoder_seq`` / ``num_prefix_tokens`` give the
    precomputed embeddings the backbone consumes."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free (rwkv)
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str

    # --- layer flavour -----------------------------------------------------
    hidden_act: str = "silu"         # silu | geglu | gelu | relu_sq
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba) / RWKV ------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64        # rank of the data-dependent decay LoRA

    # --- hybrid (jamba) ----------------------------------------------------
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # --- encoder-decoder (whisper backbone) --------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0

    # --- VLM (paligemma) ---------------------------------------------------
    num_prefix_tokens: int = 0

    # --- long-context decode strategy --------------------------------------
    sliding_window: int = 0

    # --- attention flavour --------------------------------------------------
    qk_norm: bool = False
    scale_embed: bool = False        # gemma-style sqrt(d_model) embed scaling

    # --- training ----------------------------------------------------------
    residual_scale: float = 1.0
    lr_schedule: str = "cosine"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'mamba' body for decoder layer i (hybrid interleave)."""
        if self.family != "hybrid" or self.attn_layer_period == 0:
            return "mamba" if self.name.startswith("rwkv") else "attn"
        return ("attn" if i % self.attn_layer_period == self.attn_layer_offset
                else "mamba")

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    grad_accum: int = 1              # train only: microbatch count


def scaled_down(cfg: ArchConfig, *, layers: int = 2, d_model: int = 256,
                experts: int = 4) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests (the
    reference's ``scaled_down``, field for field)."""
    heads = 0 if cfg.num_heads == 0 else max(2, min(cfg.num_heads, 4))
    kv = 0 if cfg.num_kv_heads == 0 else max(1, min(cfg.num_kv_heads, heads))
    if heads and cfg.num_heads and cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    head_dim = max(16, d_model // max(heads, 1)) if heads else 0
    if cfg.head_dim > cfg.d_model // max(cfg.num_heads, 1):
        head_dim = 2 * d_model // max(heads, 1)
    upd = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=d_model * 4,
        vocab_size=512,
        rwkv_decay_lora=16,
        encoder_layers=min(cfg.encoder_layers, layers),
        encoder_seq=min(cfg.encoder_seq, 64),
        num_prefix_tokens=min(cfg.num_prefix_tokens, 16),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.is_moe:
        upd.update(num_experts=min(experts, cfg.num_experts),
                   experts_per_token=min(cfg.experts_per_token, 2),
                   moe_d_ff=d_model * 2)
    if cfg.family == "hybrid":
        upd.update(attn_layer_period=2, attn_layer_offset=0)
    return dataclasses.replace(cfg, **upd)
