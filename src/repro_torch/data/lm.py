"""Synthetic token pipeline for LM training (``repro.data.lm``), a numpy
copy that gives the reference's arrays for the same seed.

A deterministic Zipf-distributed token stream with a first-order Markov
structure (so there is learnable signal), chunked into (batch, seq)
next-token-prediction batches; the audio family's batches add
``frames`` (B, encoder_seq, D) and the vlm family's ``prefix`` (B,
num_prefix_tokens, D), fp32 normal draws from the same generator, the
vlm tokens then cut to ``seq - num_prefix_tokens``.  The reference's
``shard_batch`` places a batch on a JAX mesh; the port has no sharded
batch axis (ROADMAP A14).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0,
                 zipf_a: float = 1.2, markov_weight: float = 0.5):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        self.markov_weight = markov_weight
        # a cheap deterministic successor table: tok -> preferred next
        self.succ = (np.arange(vocab_size) * 2654435761 % vocab_size)

    def stream(self, n: int) -> np.ndarray:
        base = self.rng.choice(self.vocab, size=n, p=self.p)
        take_succ = self.rng.random(n) < self.markov_weight
        out = base.copy()
        out[1:] = np.where(take_succ[1:], self.succ[out[:-1]], base[1:])
        return out.astype(np.int32)

    def batches(self, batch: int, seq: int,
                cfg: Optional[ArchConfig] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            toks = self.stream(batch * (seq + 1)).reshape(batch, seq + 1)
            b: Dict[str, np.ndarray] = {
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
                "mask": np.ones((batch, seq), np.float32),
            }
            if cfg is not None and cfg.family == "audio":
                b["frames"] = self.rng.normal(
                    size=(batch, cfg.encoder_seq, cfg.d_model)).astype(
                        np.float32)
            if cfg is not None and cfg.family == "vlm":
                p = cfg.num_prefix_tokens
                b["prefix"] = self.rng.normal(
                    size=(batch, p, cfg.d_model)).astype(np.float32)
                b["tokens"] = b["tokens"][:, : seq - p]
                b["targets"] = b["targets"][:, : seq - p]
                b["mask"] = b["mask"][:, : seq - p]
            yield b
