"""gemma-2b — Google Gemma 2B: GeGLU, oversized head_dim=256, MQA.

[arXiv:2403.08295] "Gemma: Open Models Based on Gemini Research and
Technology".  18L, d_model=2048, 8 heads, MQA kv=1, head_dim=256,
d_ff=16384 (GeGLU), vocab=256000, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    hidden_act="geglu",
    tie_embeddings=True,
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    scale_embed=True,
    citation="arXiv:2403.08295",
)
