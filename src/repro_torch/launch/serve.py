"""Serving CLI: batched prefill + decode, on the card unless
``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --batch 4 --prompt-len 64 --max-new 32
  python -m repro_torch.launch.serve --arch rwkv6-3b
  python -m repro_torch.launch.serve --reduced --device cpu

``--arch`` defaults to gemma-2b, as the reference's does; the port also
serves rwkv6-3b.  Weights are random, drawn from ``--seed`` on the
device; after init they are cast once to bf16 where the forward
computes in bf16 (``registry.serving_params``).  The last line is a
JSON object with the prefill and decode seconds, tokens per second
and, on the card, the peak device memory.
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

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = scaled_down(cfg)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = registry.serving_params(registry.init_params(g, cfg))
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=g, device=dev)}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    toks, info = generate(cfg, params, batch, args.max_new,
                          temperature=args.temperature, generator=g)
    dt = info["prefill_s"] + info["decode_s"]
    n_tok = args.batch * args.max_new
    print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print(f"[serve] first sequence: {toks[0][:16].tolist()}")
    stats = {"device": str(dev), "arch": cfg.name,
             "layers": cfg.num_layers, "d_model": cfg.d_model,
             "params": _numel(params), "batch": args.batch,
             "prompt_len": args.prompt_len, "max_new": args.max_new,
             "prefill_s": info["prefill_s"], "decode_s": info["decode_s"],
             "decode_tok_s": n_tok / info["decode_s"]}
    if dev.type == "cuda":
        stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
