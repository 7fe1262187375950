"""phi3.5-moe-42b-a6.6b — Microsoft Phi-3.5-MoE, 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct].  32L, d_model=4096, 32 heads, GQA kv=8,
per-expert d_ff=6400, vocab=32064, MoE on every layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    hidden_act="silu",
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    moe_layer_period=1,
    tie_embeddings=False,
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)
