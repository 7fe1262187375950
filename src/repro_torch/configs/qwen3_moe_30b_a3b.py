"""qwen3-moe-30b-a3b — Qwen3 fine-grained MoE: 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B].  48L, d_model=2048, 32 heads (head_dim=128), GQA
kv=4, per-expert d_ff=768, vocab=151936, MoE on every layer, QK-norm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    hidden_act="silu",
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_layer_period=1,
    tie_embeddings=False,
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    qk_norm=True,
    citation="hf:Qwen/Qwen3-30B-A3B",
)
