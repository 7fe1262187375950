"""whisper-medium — encoder-decoder speech backbone (conv/mel frontend STUB).

[arXiv:2212.04356] "Robust Speech Recognition via Large-Scale Weak
Supervision".  24L decoder (+24L encoder), d_model=1024, 16 heads (MHA:
kv=16), d_ff=4096, vocab=51865.  ``input_specs`` feeds precomputed frame
embeddings (B, 1500, d_model) — the mel+conv frontend is the one allowed stub.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    hidden_act="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    tie_embeddings=True,
    sliding_window=8192,          # backbone-generalised long decode (ours)
    citation="arXiv:2212.04356",
)
