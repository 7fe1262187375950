"""Serving CLI: batched prefill + decode, on the card unless
``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --batch 4 --prompt-len 64 --max-new 32
  python -m repro_torch.launch.serve --arch whisper-medium
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced --device cpu
  python -m repro_torch.launch.serve --reduced --device cpu

``--arch`` takes the reference's ten ids: rwkv6-3b, granite-8b,
whisper-medium, yi-6b, phi3.5-moe-42b-a6.6b, paligemma-3b, gemma-2b
(the default, as the reference's), minicpm-2b, jamba-v0.1-52b and
qwen3-moe-30b-a3b.  Two do not fit one 80 GB card at full depth in
bf16: jamba-v0.1-52b (32 layers, ~103 GB) and phi3.5-moe-42b-a6.6b (32
layers, ~84 GB); ``serve(cfg)`` serves a config with fewer layers, and
the CLI raises the card's out-of-memory error for them.  Weights are
random, drawn from ``--seed`` on the device, each layer cast to bf16
where the forward computes in bf16 before the next is drawn
(``registry.init_serving_params``); so are whisper's frame embeddings
(B, 1500, D) and paligemma's patch embeddings (B, 256, D), the stubs of
their frontends, as the reference draws them.  The last line is a JSON
object with the prefill and decode seconds, tokens per second and, on
the card, the peak device memory.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, get_arch, scaled_down
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import generate


def _numel(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel()
    return sum(map(_numel,
                   tree.values() if isinstance(tree, dict) else tree))


def serve(cfg, *, batch: int = 4, prompt_len: int = 64, max_new: int = 32,
          temperature: float = 0.0, seed: int = 0, device=None) -> dict:
    """Serve ``cfg`` once: random weights from ``seed`` (cast to bf16 as
    they are drawn, ``registry.init_serving_params``), ``batch`` random
    prompts of ``prompt_len`` tokens (after the vlm family's
    ``num_prefix_tokens`` random patch embeddings; beside the audio
    family's ``encoder_seq`` random frame embeddings), ``max_new`` new
    tokens each.  Prints the run and, last, its stats as JSON, and
    returns them."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = registry.init_serving_params(g, cfg)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (batch, prompt_len), generator=g,
                                       device=dev)}
    prompts.update(registry.stub_inputs(cfg, batch, g))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    toks, info = generate(cfg, params, prompts, max_new,
                          temperature=temperature, generator=g)
    dt = info["prefill_s"] + info["decode_s"]
    n_tok = batch * max_new
    print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print(f"[serve] first sequence: {toks[0][:16].tolist()}")
    stats = {"device": str(dev), "arch": cfg.name,
             "layers": cfg.num_layers, "d_model": cfg.d_model,
             "params": _numel(params), "batch": batch,
             "prompt_len": prompt_len, "max_new": max_new,
             "prefill_s": info["prefill_s"], "decode_s": info["decode_s"],
             "decode_tok_s": n_tok / info["decode_s"]}
    if dev.type == "cuda":
        stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(stats), flush=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the scaled-down variant (2 layers, d_model 256)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = scaled_down(cfg)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
          max_new=args.max_new, temperature=args.temperature,
          seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
