"""The paper's experiment driver on PyTorch: federated simulation over
the IoV model, on the card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.fl_sim --scheme dcs --rounds 3
  python -m repro_torch.launch.fl_sim --scheme all --rounds 2
  python -m repro_torch.launch.fl_sim --paper-profile --scheme all \
      --rounds 2 --out results.json
  python -m repro_torch.launch.fl_sim --compat-aligned-pack --device cpu
  python -m repro_torch.launch.fl_sim --elect windowed --elect-window 2 \
      --distribution extreme
  python -m repro_torch.launch.fl_sim --mesh clients=2 --device cpu
  python -m repro_torch.launch.fl_sim --scheme all --rounds 3 \
      --churn-rate 0.2 --staleness weighted --staleness-lambda 0.5
  python -m repro_torch.launch.fl_sim --rounds 4 --checkpoint-dir ck \
      --resume

``--paper-profile`` runs Table 3's profile (``paper_config``: 30 local
epochs, a 20 s deadline, the 4500-sample clients) for ``--rounds``
rounds; ``--out PATH`` writes ``{scheme: rows}`` as JSON, atomically.
``--compat-aligned-pack`` runs the unfused prefix (plain probe + the
standalone Mamdani kernel) over the batch-aligned probe pack.
``--elect``/``--elect-window`` pick the DCS election (auto: windowed
from 512 vehicles on); ``--distribution extreme`` crowds each half of
the fleet into 150 m at one end of the road.  ``--mesh clients=K``
spawns K ranks of the client mesh (``launch/mesh.py``): each owns
``ceil(N / K)`` clients and the round's few global steps are
collectives; rank 0 prints the mesh banner and the rows, then the
launcher prints each rank's kernel launches and host-staged
collectives (``--out`` writes rank 0's rows).  On one device the CLI
prints the rows, then the kernel launches of the scheme's rounds.
Rounds run round-ahead (``--no-overlap-rounds``: serially; the rows are
the same).  ``--churn-rate``, ``--staleness weighted``
(``--staleness-lambda``) or ``--agg-cadence`` run the event-driven
server (``fl/async_server.py``), announced by one line.
``--checkpoint-dir DIR`` snapshots each scheme's rounds under
``DIR/<scheme>`` (every ``--checkpoint-every`` rounds) and ``--resume``
continues each scheme from its newest good snapshot: the rows of a run
killed at any round and resumed are the uninterrupted run's; only the
resumed rounds are printed and timed.  Every scheme
ends with its prefix and round seconds (host clock: a round from the
previous row to its own, its prefix to the end of its host crossing,
which round-ahead is the part of the prefix the round still waits for)
and a summary line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.fl import pipeline
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation, run_resumable
from repro_torch.fl.runconfig import RunConfig, add_run_arguments
from repro_torch.ioutil import write_atomic_json
from repro_torch.kernels import build
from repro_torch.launch.mesh import (ClientMesh, describe, mesh_clients,
                                     spawn_ranks)

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


def paper_config(scheme: str, **kw) -> FLSimConfig:
    """The paper's Table 3 profile: 30 local epochs, 50 rounds, a 20 s
    deadline, the default partition (12 clients of 4500 samples, 18 of
    45) over 6600 samples a class."""
    return FLSimConfig(scheme=scheme, local_epochs=30, n_rounds=50,
                       deadline_s=20.0, **kw)


def sim_rank(mesh: ClientMesh, cfg: FLSimConfig, run: RunConfig,
             n_rounds: int, *,
             fields: Optional[Dict[int, pipeline.RoundFields]] = None,
             params: Optional[Dict[str, np.ndarray]] = None,
             print_rows: bool = False) -> Dict[str, object]:
    """One rank of the client mesh: ``n_rounds`` rounds of ``cfg``, from
    ``params`` and on the injected ``fields`` where given
    (``drive_rounds`` says what comes back).  Rank 0 prints the mesh
    banner and each row when ``print_rows``."""
    if print_rows and mesh.rank == 0:
        print(f"[fl_sim] {describe(mesh.size, mesh.device.type)}",
              flush=True)
    sim = FLSimulation(cfg, run=run, mesh=mesh,
                       fields=fields.__getitem__ if fields else None)
    if params is not None:
        sim.params = {k: torch.as_tensor(v, device=sim.device)
                      for k, v in params.items()}
    return drive_rounds(sim, n_rounds,
                        print_rows=print_rows and mesh.rank == 0)


def drive_rounds(sim: FLSimulation, n_rounds: int, *,
                 print_rows: bool = False) -> Dict[str, object]:
    """``n_rounds`` rounds of ``sim.driver()`` on the run config's
    schedule, checkpoints and resume (``rounds.run_resumable``), the
    launch counts reset just before.

    Returns the rows (a resumed run's earlier rows first); per round r
    run here this rank's shard of the prefix
    (``pos{r}``, ``feats{r}``, ``evals{r}``), the round's global
    ``mask{r}`` and ``overflow{r}`` (the windowed election's flag); the
    prefix and round wall times (host clock: the round from the previous
    row, or a synchronised start, to its own row, which reads the
    accuracy; the prefix to the end of the round's host crossing); the
    final params (``param.<name>``); the kernel launches and, on a mesh,
    the host-staged collectives of the rounds."""
    out: Dict[str, object] = {}
    prefix_s, round_s = [], []
    marks = {}

    @contextlib.contextmanager
    def fenced(r):
        marks[r] = time.perf_counter()       # the host crossing is done
        yield

    def on_row(r, host, row):
        now = time.perf_counter()
        prefix_s.append(marks[r] - marks["start"])
        round_s.append(now - marks["start"])
        marks["start"] = now
        for key in ("pos", "feats", "evals"):
            out[f"{key}{r}"] = host[key]
        out[f"mask{r}"] = sim.last_mask
        out[f"overflow{r}"] = int(host["elect_overflow"])
        if print_rows:
            print(json.dumps(row), flush=True)

    build.reset_launches()
    synchronize(sim.device)
    marks["start"] = time.perf_counter()
    rows = run_resumable(sim.driver(), sim, n_rounds, stretch=fenced,
                         on_row=on_row)
    out.update(rows=rows, prefix_s=prefix_s, round_s=round_s,
               launches=dict(build.LAUNCHES), device=str(sim.device),
               staged=dict(sim.mesh.staged) if sim.mesh else {})
    out.update({f"param.{k}": v.cpu().numpy() for k, v in sim.params.items()})
    return out


def _seconds(values) -> str:
    return "[" + ", ".join(f"{v:.4f}" for v in values) + "]"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", choices=SCHEMES + ("all",), default="dcs")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--fast", action="store_true", default=True,
                    help="no-op, as in the reference: the fast profile is "
                         "the default without --paper-profile")
    ap.add_argument("--paper-profile", action="store_true",
                    help="Table 3's profile (paper_config); "
                         "--classes-per-client does not apply")
    ap.add_argument("--classes-per-client", type=int, default=9)
    ap.add_argument("--distribution", choices=("uniform", "extreme"),
                    default="uniform")
    add_run_arguments(ap)
    ap.add_argument("--elect-capacity", type=int, default=None,
                    help="ring-halo election on the mesh: bucket slots "
                         "per (rank, road segment) (0 = auto)")
    ap.add_argument("--multihost", type=int, default=0,
                    help="processes over several hosts (not ported: "
                         "raises)")
    ap.add_argument("--jit-cache-dir", default=None, metavar="DIR",
                    help="the reference's persistent jit cache (not "
                         "ported: raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--out", default=None,
                    help="write {scheme: rows} to this JSON file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    run = RunConfig.from_args(args)
    k = mesh_clients(run.mesh)
    if run.server == "event":
        print(f"[fl_sim] event-driven server: churn={run.churn_rate} "
              f"staleness={run.staleness} lam={run.staleness_lambda} "
              f"cadence={run.agg_cadence_s or 'round period'}", flush=True)
    results = {}
    for scheme in (SCHEMES if args.scheme == "all" else (args.scheme,)):
        if args.paper_profile:
            cfg = paper_config(scheme, seed=args.seed)
        else:
            cfg = fast_config(scheme, n_rounds=args.rounds,
                              classes_per_client=args.classes_per_client,
                              seed=args.seed)
        cfg.mobility = MobilityConfig(distribution=args.distribution,
                                      seed=args.seed)
        srun = run
        if run.checkpoint_dir:
            # one snapshot directory a scheme, so --scheme all runs never
            # overwrite each other's round state (as the reference's)
            srun = dataclasses.replace(run, checkpoint_dir=os.path.join(
                run.checkpoint_dir, scheme))
        t0 = time.perf_counter()
        if k > 1:
            ranks = spawn_ranks(
                sim_rank, k, args.device,
                args=(cfg, srun, args.rounds),
                kwargs=dict(print_rows=True))
            res, where = ranks[0], f"{k} ranks"
            for r, rank in enumerate(ranks):
                print(f"[fl_sim] rank {r} on {rank['device']}: launches "
                      f"{json.dumps(rank['launches'])}, host-staged "
                      f"collectives {json.dumps(rank['staged'])}",
                      flush=True)
        else:
            sim = FLSimulation(cfg, run=srun, device=args.device)
            res = drive_rounds(sim, args.rounds, print_rows=True)
            where = str(sim.device)
            print(f"[fl_sim] launches {json.dumps(res['launches'])}",
                  flush=True)
        dt = time.perf_counter() - t0
        rows = res["rows"]
        start = len(rows) - len(res["round_s"])
        if start:
            print(f"[fl_sim] {scheme} resumed from {srun.checkpoint_dir} "
                  f"at round {start}", flush=True)
        print(f"[fl_sim] {scheme} seconds a round (host clock, "
              f"{'round-ahead' if run.overlap_rounds else 'serial'}): "
              f"prefix {_seconds(res['prefix_s'])}, round "
              f"{_seconds(res['round_s'])}", flush=True)
        accs = [r["accuracy"] for r in rows]
        nsel = sum(r["n_selected"] for r in rows) / len(rows)
        print(f"[fl_sim] {scheme} on {where}: final acc "
              f"{accs[-1]:.3f} (best {max(accs):.3f}), avg selected "
              f"{nsel:.2f}, {dt:.1f}s", flush=True)
        results[scheme] = rows
    if args.out:
        write_atomic_json(args.out, results, indent=1)
        print(f"[fl_sim] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
