"""minicpm-2b — MiniCPM, llama-like with WSD schedule + depth-scaled residuals.

[arXiv:2404.06395] "MiniCPM: Unveiling the Potential of Small Language Models
with Scalable Training Strategies".  40L, d_model=2304, 36 heads, kv=36
(MHA), d_ff=5760, vocab=122753, residual scaling 1.4/sqrt(40), WSD LR.
"""
import math

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    hidden_act="silu",
    tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40),
    lr_schedule="wsd",
    sliding_window=8192,          # long_500k sub-quadratic variant (ours)
    citation="arXiv:2404.06395",
)
