"""jamba-v0.1-52b — AI21 Jamba: Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] "Jamba: A Hybrid Transformer-Mamba Language Model".
32L (4 Jamba blocks x 8 layers; 1 attention layer per 8, offset 4 in the
released model), d_model=4096, 32 heads, GQA kv=8, d_ff=14336, vocab=65536,
MoE with 16 experts top-2 on every other layer (offset 1).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    hidden_act="silu",
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    tie_embeddings=False,
    citation="arXiv:2403.19887",
)
