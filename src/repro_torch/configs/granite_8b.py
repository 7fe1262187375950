"""granite-8b — IBM Granite Code 8B, llama-arch dense decoder.

[arXiv:2405.04324] "Granite Code Models".  36L, d_model=4096, 32 heads,
GQA kv=8, d_ff=14336, vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    hidden_act="silu",
    tie_embeddings=True,          # granite-8b-code ties embeddings
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    citation="arXiv:2405.04324",
)
