"""Training CLI (``repro.launch.train``): a model of any arch id on the
synthetic LM stream, on the card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.train --arch gemma-2b --steps 4 --batch 2 \\
      --seq 1024 --grad-accum 2
  python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu \\
      --steps 3

The flags, defaults and log lines are the reference's.  Parameters are
fp32, drawn from a ``torch.Generator`` seeded by ``--seed`` on the
device; compute is bf16, each layer recomputed in backward, attention,
the WKV recurrence and the selective scan through their kernels and
hand-written backwards (``kernels/ops.py``).  After the reference's
lines the last line is a JSON object with each step's seconds (host
clock, the step's work synchronised), the losses, the kernels' launches
and, on the card, the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import ARCH_IDS, get_arch, scaled_down
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.lm import SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import build
from repro_torch.models import registry
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optim import OptConfig, adamw_init, tree_leaves
from repro_torch.train.step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the family")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = scaled_down(cfg, layers=args.layers, d_model=args.d_model)
    shape = ShapeConfig("cli", args.seq, args.batch, "train",
                        grad_accum=args.grad_accum)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5),
                        schedule=cfg.lr_schedule)

    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = registry.init_params(g, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'full'})", flush=True)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, shape, opt_cfg)

    data = SyntheticLM(cfg.vocab_size, seed=args.seed)
    it = data.batches(args.batch, args.seq, cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()

    t0 = time.time()
    step_s, losses = [], []
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v).to(dev, torch.long if v.dtype.kind
                                          == "i" else torch.float32)
                 for k, v in next(it).items()}
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - ts)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"ce {m['ce']:.4f} lr {m['lr']:.2e} "
                  f"gnorm {m['grad_norm']:.2f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state, step=args.steps,
                        extra={"arch": cfg.name})
        print(f"[train] checkpoint -> {args.ckpt}", flush=True)
    stats = {"device": str(dev), "arch": cfg.name,
             "layers": cfg.num_layers, "d_model": cfg.d_model,
             "params": n_params, "batch": args.batch, "seq": args.seq,
             "grad_accum": args.grad_accum, "step_s": step_s,
             "loss": losses,
             "launches": {k: v for k, v in build.LAUNCHES.items() if v}}
    if dev.type == "cuda":
        stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
