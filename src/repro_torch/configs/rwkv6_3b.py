"""rwkv6-3b — Finch, attention-free RNN with data-dependent decay.

[arXiv:2404.05892] "Eagle and Finch: RWKV with Matrix-Valued States and
Dynamic Recurrence".  32L, d_model=2560, d_ff=8960, vocab=65536,
head_size=64 (=> 40 WKV heads).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=8960,
    vocab_size=65536,
    hidden_act="relu_sq",         # rwkv channel-mix uses relu^2
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    tie_embeddings=False,
    citation="arXiv:2404.05892",
)
