"""yi-6b — 01.AI Yi, llama-arch dense decoder with aggressive GQA.

[arXiv:2403.04652] "Yi: Open Foundation Models by 01.AI".  32L,
d_model=4096, 32 heads, GQA kv=4, d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    hidden_act="silu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    citation="arXiv:2403.04652",
)
