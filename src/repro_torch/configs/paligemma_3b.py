"""paligemma-3b — SigLIP + Gemma VLM (vision tower STUB).

[arXiv:2407.07726] "PaliGemma: A versatile 3B VLM for transfer".  Language
backbone = gemma-2b: 18L, d_model=2048, 8 heads, MQA kv=1, head_dim=256,
GeGLU d_ff=16384, vocab=257216 (extended with <locNNNN>/<segNNN>).
``input_specs`` feeds 256 precomputed SigLIP patch embeddings per image;
prefix-LM masking over the image+prompt prefix.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    hidden_act="geglu",
    num_prefix_tokens=256,
    tie_embeddings=True,
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    scale_embed=True,
    citation="arXiv:2407.07726",
)
