"""Serving CLI: batched prefill + decode, on the card unless
``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --batch 4 --prompt-len 64 --max-new 32
  python -m repro_torch.launch.serve --arch rwkv6-3b
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced --device cpu
  python -m repro_torch.launch.serve --reduced --device cpu

``--arch`` defaults to gemma-2b, as the reference's does; the port also
serves rwkv6-3b and jamba-v0.1-52b (whose 32 layers, ~103 GB in bf16,
do not fit one 80 GB card: ``serve(cfg)`` serves fewer layer groups).
Weights are random, drawn from ``--seed`` on the device, each layer
cast to bf16 where the forward computes in bf16 before the next is
drawn (``registry.init_serving_params``).  The last line is a JSON
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
    prompts of ``prompt_len`` tokens, ``max_new`` new tokens each.
    Prints the run and, last, its stats as JSON, and returns them."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = registry.init_serving_params(g, cfg)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (batch, prompt_len), generator=g,
                                       device=dev)}
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
    # no `choices`: an arch the port does not serve yet reaches get_arch,
    # which names the ROADMAP item that brings it
    ap.add_argument("--arch", default="gemma-2b",
                    help=f"one of {', '.join(ARCH_IDS)}")
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
