"""Serving engine (``repro.serve.engine``): batched prefill, then a
greedy or temperature-sampled decode loop (a Python loop where the
reference scans)."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm


def make_serve_step(cfg: ArchConfig, context: int) -> Callable:
    """serve_step(params, cache, tokens (B, 1)) -> (logits, cache), with
    the sliding window that ``context`` calls for."""
    window = tfm.decode_window(cfg, context)

    def serve_step(params, cache, tokens):
        return tfm.decode_step(cfg, params, cache, tokens, window=window)

    return serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
             max_new_tokens: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill the prompt, then decode ``max_new_tokens`` steps greedily
    (or sampling at ``temperature`` from ``generator``, whose draws are
    not the reference's).  Returns (tokens (B, max_new_tokens), info):
    the first token comes from the prefill's logits, as in the
    reference, whose loop also runs one more decode step than it keeps
    (the cache in ``info`` has seen it).  The cache is sized for
    ``prompt + max_new_tokens`` positions; as in the reference, the
    prompt pass runs without a sliding window and only decode uses it.
    ``info`` holds the cache, the prompt length (for the vlm family the
    prefix's positions too, as the reference counts them) and the
    prefill and decode seconds (host clock, the device synchronised at
    both ends)."""
    tokens = batch["tokens"]
    device = tokens.device
    prompt_len = tokens.shape[1]
    if cfg.family == "vlm":
        prompt_len += cfg.num_prefix_tokens
    context = prompt_len + max_new_tokens
    step = make_serve_step(cfg, context)

    def sample(lg):
        if temperature <= 0.0:
            return torch.argmax(lg[:, -1], dim=-1)
        probs = torch.softmax(lg[:, -1] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(cfg, params, batch, context=context)
    tok = sample(logits)
    _sync(device)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(max_new_tokens):
        logits, cache = step(params, cache, tok[:, None])
        tok = sample(logits)
        out.append(tok)
    toks = torch.stack(out, dim=1)[:, :max_new_tokens].to(torch.int32)
    _sync(device)
    t2 = time.perf_counter()
    return toks, {"cache": cache, "prompt_len": prompt_len,
                  "prefill_s": t1 - t0, "decode_s": t2 - t1}
