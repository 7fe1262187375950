"""The paper's experiment driver on PyTorch: federated simulation over
the IoV model, on the card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.fl_sim --scheme dcs --rounds 3
  python -m repro_torch.launch.fl_sim --scheme all --rounds 2
  python -m repro_torch.launch.fl_sim --compat-aligned-pack --device cpu
  python -m repro_torch.launch.fl_sim --elect windowed --elect-window 2 \
      --distribution extreme

``--compat-aligned-pack`` runs the unfused prefix (plain probe + the
standalone Mamdani kernel) over the batch-aligned probe pack.
``--elect``/``--elect-window`` pick the DCS election (auto: windowed
from 512 vehicles on); ``--distribution extreme`` crowds each half of
the fleet into 150 m at one end of the road.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import ELECT_MODES, RunConfig

SCHEMES = ("dcs", "ccs-fuzzy", "random")


def fast_config(scheme: str, **kw) -> FLSimConfig:
    """The reference's fast profile (``repro.launch.fl_sim``): Table-3
    structure with smaller local datasets."""
    part = PartitionConfig(big_quantity=kw.pop("big_quantity", 300),
                           small_quantity=45,
                           classes_per_client=kw.pop("classes_per_client", 9))
    return FLSimConfig(scheme=scheme, partition=part,
                       samples_per_class=kw.pop("samples_per_class", 600),
                       local_epochs=kw.pop("local_epochs", 1),
                       n_rounds=kw.pop("n_rounds", 10), **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", choices=SCHEMES + ("all",), default="dcs")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--classes-per-client", type=int, default=9)
    ap.add_argument("--distribution", choices=("uniform", "extreme"),
                    default="uniform")
    ap.add_argument("--elect", choices=ELECT_MODES, default="auto",
                    help="DCS election: auto (windowed for fleets of "
                         "512 or more), gather (dense O(N^2)), windowed "
                         "(O(N*W) sorted window; overflow rounds re-run "
                         "through gather)")
    ap.add_argument("--elect-window", type=int, default=0,
                    help="windowed election: sorted neighbours per side "
                         "(0 = auto-size from fleet density)")
    ap.add_argument("--compat-aligned-pack", action="store_true",
                    help="aligned probe pack + unfused prefix")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    run = RunConfig(fused_probe=not args.compat_aligned_pack,
                    elect=args.elect, elect_window=args.elect_window)
    for scheme in (SCHEMES if args.scheme == "all" else (args.scheme,)):
        cfg = fast_config(scheme, n_rounds=args.rounds,
                          classes_per_client=args.classes_per_client,
                          seed=args.seed)
        cfg.mobility = MobilityConfig(distribution=args.distribution,
                                      seed=args.seed)
        sim = FLSimulation(cfg, run=run, device=args.device)
        t0 = time.perf_counter()
        rows = sim.run(args.rounds)
        dt = time.perf_counter() - t0
        for row in rows:
            print(json.dumps(row), flush=True)
        accs = [r["accuracy"] for r in rows]
        nsel = sum(r["n_selected"] for r in rows) / len(rows)
        print(f"[fl_sim] {scheme} on {sim.device}: final acc "
              f"{accs[-1]:.3f} (best {max(accs):.3f}), avg selected "
              f"{nsel:.2f}, {dt:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
