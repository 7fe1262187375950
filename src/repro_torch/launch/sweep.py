"""Multi-seed sweep over (scheme x classes-per-client x distribution) on
PyTorch: the paper's Figs. 6-8 evaluation grid with error bars, on the
card unless ``--device cpu`` is given.

  python -m repro_torch.launch.sweep --fast --seeds 4 --rounds 2
  python -m repro_torch.launch.sweep --fast --seeds 3 \\
      --classes 9,6,2 --distributions uniform,extreme --out grid.csv
  python -m repro_torch.launch.sweep --paper-profile --seeds 1 --rounds 1
  python -m repro_torch.launch.sweep --seeds 2 --rounds 1 --device cpu
  python -m repro_torch.launch.sweep --fast --seeds 2 --rounds 2 \
      --churn-rates 0,0.2 --staleness-lambdas 0,0.5 --agg-cadences 0,90
  python -m repro_torch.launch.sweep --seeds 1 --rounds 1 --schemes dcs \
      --device cpu --mesh clients=4 --multihost 2

Each **cell** is a whole (scheme, classes_per_client, distribution,
seed) simulation; the seeds of one (scheme, classes, distribution) are
a **group**.  The seeds of a group share one ``StageConfig``, so their
selection prefixes run as one ``pipeline.selection_prefix_seeds`` per
round: the fused probe and the dense election launch once for every
seed of the group, as the reference's vmap over seeds dispatches one
program.  Training, FedAvg and the accuracy run per seed, through each
seed's driver (``_dispatch_training``, ``_round_row``), which also
resolves a seed's windowed-election overflow on its own.  Rounds run
round-ahead (``RunConfig.overlap_rounds``, the default): the group's
prefix for round r+1 is enqueued after round r's training and
accuracy and before round r's rows read anything back;
``--no-overlap-rounds`` runs them serially.  ``--no-vmap`` (or seeds
whose statics do not stack) runs each seed's prefix alone.  The CSV is
the same byte for byte either way.  ``--workers N`` spreads the groups
over N spawned processes, which share the one card.

The async flags add a **scenario** axis: every (churn rate x staleness
lambda x aggregation cadence) combination (``scenario_runs``) runs the
cell grid through the event-driven server (``fl/async_server.py``),
with the streaming columns (active fleet, stale fraction, effective
cohort, rounds-behind histogram); the all-defaults scenario is the
synchronous barrier, bit-equal to a sweep without async flags.

Output: ONE tidy CSV, one row per (cell, scenario, round), with the
reference's header and float formats (``CSV_COLUMNS``, ``_FMT``), so a
CSV of either package parses with the other's ``parse_csv_rows``; rows
are sorted and formatted deterministically, and two runs of the same
sweep write the same bytes.  The per-seed metrics carry across-seed
mean and sample-std columns, constant within a (round, scheme,
classes, distribution, scenario) group.

Preemption safety, as the reference's: each group snapshots every
seed's driver state after each seed-batched round (``--checkpoint-every``)
under its own directory of ``--checkpoint-dir`` (default ``OUT.ckpt``),
and the partial CSV is rewritten atomically after every finished group,
whose snapshots are then cleared.  ``--resume`` skips the groups whose
rows the partial CSV already holds, restarts an unfinished group from
its newest good snapshot, and writes the uninterrupted run's CSV byte
for byte.

``--mesh clients=K`` runs the grid on K ranks of the client mesh
(``launch/mesh.py``), as the reference's sweep runs inside its client
mesh: each rank holds its shard of every seed's fleet and its region of
every seed's probe pack, a group's round makes one
``pipeline.selection_prefix_seeds_sharded`` (one ``probe_loss`` and one
``fuzzy_eval`` launch for all its seeds), the ranks train their slices
of each seed's cohort, and rank 0 alone writes the CSV and the group
snapshots.  With ``--workers N`` each worker process runs its groups on
K ranks of its own.  ``--multihost P`` spreads the K ranks over P
launcher processes (``launch/multihost.py``; not with ``--workers``):
the parent builds the kernels once and re-executes this module P times,
process 0 alone prints, and the CSV is the single-host mesh's byte for
byte.

The knob the port does not have yet, ``--jit-cache-dir``, raises
``NotImplementedError`` naming its ROADMAP item (A14) before any work is
done.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.fl import pipeline
from repro_torch.fl.client import evaluate_accuracy_async
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import (FLSimConfig, FLSimulation,
                                   checkpoint_round, resume_rows)
from repro_torch.fl.runconfig import RunConfig, add_run_arguments
from repro_torch.ioutil import write_atomic
from repro_torch.kernels import build
from repro_torch.launch import faults
from repro_torch.launch.mesh import (ClientMesh, describe, mesh_clients,
                                     spawn_ranks)
from repro_torch.launch.multihost import (add_multihost_arguments,
                                          multihost_from_args, should_spawn,
                                          spawn_multihost)
from repro_torch.train.checkpoint import RoundCheckpointer

SCHEMES = ("dcs", "ccs-fuzzy", "random")

# one row per (cell, scenario, round): cell identity + the async
# scenario coordinates + per-seed metrics + the across-seed aggregates
# (constant within a seed group).  agg_cadence_s reports 0 for "round
# period" (RunConfig's None) so the column stays numeric.
CSV_COLUMNS = (
    "round", "scheme", "seed", "classes_per_client", "distribution",
    "churn_rate", "staleness_lambda", "agg_cadence_s",
    "accuracy", "n_selected", "n_aggregated", "n_straggler",
    "n_active", "stale_frac", "n_effective", "rounds_behind_hist",
    "mean_eval_selected", "state_bytes", "upload_bytes", "state_time_s",
    "comm_time_s",
    "accuracy_mean", "accuracy_std", "n_selected_mean", "n_selected_std",
    "n_straggler_mean", "n_straggler_std",
)

_FMT = {"accuracy": "{:.6f}", "mean_eval_selected": "{:.4f}",
        "churn_rate": "{:.3f}", "staleness_lambda": "{:.4g}",
        "agg_cadence_s": "{:.6g}",
        "stale_frac": "{:.4f}", "n_effective": "{:.4f}",
        "state_bytes": "{:.6g}", "upload_bytes": "{:.6g}",
        "state_time_s": "{:.6g}", "comm_time_s": "{:.6g}",
        "accuracy_mean": "{:.6f}", "accuracy_std": "{:.6f}",
        "n_selected_mean": "{:.4f}", "n_selected_std": "{:.4f}",
        "n_straggler_mean": "{:.4f}", "n_straggler_std": "{:.4f}"}

# the key that identifies one seed group in the tidy output: a cell
# plus its async scenario coordinates
_GROUP_KEY = ("round", "scheme", "classes_per_client", "distribution",
              "churn_rate", "staleness_lambda", "agg_cadence_s")

# sweep cell group: every seed of one (scheme, classes, distribution)
Group = Tuple[str, int, str]


def fast_cell_config(scheme: str, classes_per_client: int,
                     distribution: str, seed: int) -> FLSimConfig:
    """The reference's CPU-budget profile per cell: fewer classes a
    client concentrate per-class demand under the no-dup partition rule,
    so the source pool grows with non-iid-ness."""
    part = PartitionConfig(big_quantity=300, small_quantity=45,
                           classes_per_client=classes_per_client, seed=seed)
    return FLSimConfig(
        scheme=scheme, partition=part, local_epochs=1,
        samples_per_class=600 + (9 - classes_per_client) * 80,
        mobility=MobilityConfig(distribution=distribution, seed=seed),
        seed=seed)


def paper_cell_config(scheme: str, classes_per_client: int,
                      distribution: str, seed: int) -> FLSimConfig:
    """The reference's Table 3 profile per cell."""
    part = PartitionConfig(classes_per_client=classes_per_client, seed=seed)
    return FLSimConfig(
        scheme=scheme, partition=part, local_epochs=30, deadline_s=20.0,
        mobility=MobilityConfig(distribution=distribution, seed=seed),
        seed=seed)


ConfigFn = Callable[[str, int, str, int], FLSimConfig]
# seed -> (round -> RoundFields): injected draws (the parity tests feed
# the reference's); None draws from each simulation's generators
FieldsFn = Callable[[int], Callable[[int], pipeline.RoundFields]]


def run_seed_group(scheme: str, classes_per_client: int, distribution: str,
                   seeds: Sequence[int], rounds: int,
                   cfg_fn: ConfigFn = fast_cell_config,
                   vmap_prefix: bool = True,
                   run: Optional[RunConfig] = None, *, device=None,
                   fields_fn: Optional[FieldsFn] = None,
                   prefix_s: Optional[List[float]] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 1,
                   resume: bool = False,
                   mesh: Optional[ClientMesh] = None) -> List[Dict]:
    """Run every seed of one cell group for ``rounds`` rounds.

    With more than one seed and statics that stack (the seeds share a
    ``StageConfig`` and the probe pack's shape), each round's selection
    prefixes run as ONE ``pipeline.selection_prefix_seeds``; otherwise,
    or with ``vmap_prefix=False``, each seed's prefix runs alone.  Each
    seed's driver (the simulation, or its ``EventDrivenServer`` under
    ``run.server == "event"``) then trains and closes the round.
    Round-ahead (``run.overlap_rounds``) it enqueues round r+1's
    prefix, on params stacked from round r's FedAvg outputs, before
    round r's rows read the accuracies, as ``rounds.run_schedule`` does
    for one seed.  The rows are the same either way.  ``prefix_s``,
    when given, receives each round's wait for its prefix (host clock,
    from the round's start to the end of its seeds' host crossings).

    With ``checkpoint_dir`` the group snapshots every
    ``checkpoint_every`` rounds, after the round's rows: every seed's
    driver state in one ``RoundCheckpointer`` entry (``{"seeds":
    [...]}``) with the rows so far; ``resume`` restores the newest good
    snapshot and runs only the rounds after it, bit-identically.

    On a rank of the client mesh (``mesh``, the run config's ``--mesh
    clients=K``) every seed's simulation is built on the rank, the
    group's prefix is ``pipeline.selection_prefix_seeds_sharded``, and
    only rank 0 writes the snapshots; every rank returns the rows."""
    run = (run if run is not None else RunConfig()).resolved()
    sims = [FLSimulation(cfg_fn(scheme, classes_per_client, distribution,
                                seed), run=run, device=device,
                         fields=fields_fn(seed) if fields_fn else None,
                         mesh=mesh)
            for seed in seeds]
    if not sims:
        return []
    drivers = [sim.driver() for sim in sims]
    ckpt = (RoundCheckpointer(checkpoint_dir, every=checkpoint_every)
            if checkpoint_dir else None)

    def restore(state: Dict, extra: Dict) -> None:
        for drv, st in zip(drivers, state["seeds"]):
            drv.restore_state(st, extra)

    rows, start = resume_rows(restore, ckpt, resume)
    cfg0 = sims[0].stage_cfg
    stacked = None
    if (vmap_prefix and len(sims) > 1
            and all(s.stage_cfg == cfg0 for s in sims)):
        try:
            stacked = pipeline.stack_statics([s.statics for s in sims])
        except ValueError:
            stacked = None

    def dispatch(r: int, fields: List[pipeline.RoundFields]) -> List[Dict]:
        """Enqueue round ``r``'s prefixes: one state dict a seed."""
        if stacked is None:
            return [sim.selection_state(r, f) for sim, f in zip(sims, fields)]
        # a fresh stack of the seeds' current (post-FedAvg) params
        params = {k: torch.stack([s.params[k] for s in sims])
                  for k in sims[0].params}
        if sims[0].mesh is not None:
            outs = pipeline.selection_prefix_seeds_sharded(
                stacked, params, r, pipeline.stack_fields(fields),
                cfg=cfg0, mesh=sims[0].mesh)
        else:
            outs = pipeline.selection_prefix_seeds(
                stacked, params, r, pipeline.stack_fields(fields),
                cfg=cfg0)
        return [{k: v[i] for k, v in outs.items()} for i in range(len(sims))]

    def meta(seed: int, row: Dict) -> Dict:
        return {"scheme": scheme, "seed": seed,
                "classes_per_client": classes_per_client,
                "distribution": distribution,
                "churn_rate": run.churn_rate,
                "staleness_lambda": run.staleness_lambda,
                "agg_cadence_s": (run.agg_cadence_s
                                  if run.agg_cadence_s is not None
                                  else 0.0),
                **row}

    synchronize(sims[0].device)
    t0 = time.perf_counter()
    fields = states = None
    for r in range(start, rounds):
        if states is None:                   # serial, or the first round
            fields = [sim.round_fields(r) for sim in sims]
            states = dispatch(r, fields)
        nxt = ([sim.round_fields(r + 1) for sim in sims]
               if run.overlap_rounds and r + 1 < rounds else None)
        hosts = [sim.resolve_elect_overflow(r, sim._host(st), f)
                 for sim, st, f in zip(sims, states, fields)]
        if prefix_s is not None:
            prefix_s.append(time.perf_counter() - t0)
        pend = []
        for sim, drv, host, f in zip(sims, drivers, hosts, fields):
            drv._dispatch_training(r, host, f)
            pend.append(evaluate_accuracy_async(
                sim.params, sim.test_images, sim.test_labels, batch=256))
        states = dispatch(r + 1, nxt) if nxt is not None else None
        for seed, drv, host, (acc, n_test) in zip(seeds, drivers, hosts,
                                                  pend):
            rows.append(meta(seed, drv._round_row(r, host, acc, n_test)))
        checkpoint_round(lambda: {"seeds": [drv.capture_state()
                                            for drv in drivers]},
                         ckpt, r, rows, lead=mesh is None or mesh.rank == 0)
        fields = nxt
        t0 = time.perf_counter()
    return rows


def aggregate_rows(rows: List[Dict]) -> List[Dict]:
    """Attach across-seed mean/std columns to every per-seed row (tidy:
    the aggregate is repeated within its (round, scheme, classes,
    distribution, scenario) group)."""
    groups: Dict[Tuple, List[Dict]] = {}
    for row in rows:
        key = tuple(row.get(k) for k in _GROUP_KEY)
        groups.setdefault(key, []).append(row)
    out = []
    for row in rows:
        grp = groups[tuple(row.get(k) for k in _GROUP_KEY)]
        agg = {}
        for metric in ("accuracy", "n_selected", "n_straggler"):
            vals = np.asarray([g[metric] for g in grp], np.float64)
            agg[f"{metric}_mean"] = float(vals.mean())
            # sample std (ddof=1), as the reference's error bars
            agg[f"{metric}_std"] = float(vals.std(ddof=1)) \
                if len(vals) > 1 else 0.0
        out.append({**row, **agg})
    return out


def rows_to_csv(rows: List[Dict]) -> str:
    """Deterministic tidy CSV: fixed column order, fixed float formats,
    rows sorted by (scheme, classes, distribution, scenario, seed,
    round)."""
    buf = io.StringIO()
    buf.write(",".join(CSV_COLUMNS) + "\n")
    for row in sorted(rows, key=lambda r: (
            r["scheme"], r["classes_per_client"], r["distribution"],
            r["churn_rate"], r["staleness_lambda"], r["agg_cadence_s"],
            r["seed"], r["round"])):
        cells = []
        for col in CSV_COLUMNS:
            v = row[col]
            cells.append(_FMT[col].format(v) if col in _FMT else str(v))
        buf.write(",".join(cells) + "\n")
    return buf.getvalue()


_INT_COLS = {"round", "seed", "classes_per_client", "n_selected",
             "n_aggregated", "n_straggler", "n_active"}
_STR_COLS = {"scheme", "distribution", "rounds_behind_hist"}


def parse_csv_rows(text: str) -> Optional[List[Dict]]:
    """Parse a ``rows_to_csv`` artifact (of either package) back into
    typed rows; ``None`` when the header is not this schema.  Malformed
    lines (a torn tail) are dropped with a warning.  Every float column
    re-formats idempotently under ``_FMT``, so parsed rows re-emit byte
    for byte."""
    lines = text.splitlines()
    if not lines or lines[0] != ",".join(CSV_COLUMNS):
        return None
    rows: List[Dict] = []
    dropped = 0
    for ln in lines[1:]:
        if not ln:
            continue
        cells = ln.split(",")
        if len(cells) != len(CSV_COLUMNS):
            dropped += 1
            continue
        try:
            row: Dict = {}
            for col, cell in zip(CSV_COLUMNS, cells):
                if col in _STR_COLS:
                    row[col] = cell
                elif col in _INT_COLS:
                    row[col] = int(cell)
                else:
                    row[col] = float(cell)
        except ValueError:
            dropped += 1
            continue
        rows.append(row)
    if dropped:
        warnings.warn(f"dropped {dropped} unparsable row(s) from the "
                      f"partial sweep CSV (torn tail); their groups "
                      f"will rerun", RuntimeWarning)
    return rows


def _scenario_key(run: RunConfig) -> Tuple[str, str, str]:
    """The scenario coordinates as their formatted CSV strings, so job
    and CSV keys match without float parse/format wobble."""
    return (_FMT["churn_rate"].format(run.churn_rate),
            _FMT["staleness_lambda"].format(run.staleness_lambda),
            _FMT["agg_cadence_s"].format(run.agg_cadence_s
                                         if run.agg_cadence_s is not None
                                         else 0.0))


def _job_key(scheme: str, classes: int, dist: str,
             run: RunConfig) -> Tuple:
    return (scheme, int(classes), dist) + _scenario_key(run)


def _row_job_key(row: Dict) -> Tuple:
    return (row["scheme"], int(row["classes_per_client"]),
            row["distribution"],
            _FMT["churn_rate"].format(row["churn_rate"]),
            _FMT["staleness_lambda"].format(row["staleness_lambda"]),
            _FMT["agg_cadence_s"].format(row["agg_cadence_s"]))


def _group_ckpt_dir(checkpoint_dir: str, scheme: str, classes: int,
                    dist: str, run: RunConfig) -> str:
    """A (cell, scenario) group's snapshot subdirectory, the reference's
    name: the same in the killed run and its resume."""
    slug = "_".join(str(p) for p in
                    _job_key(scheme, classes, dist, run)).replace(".", "p")
    return os.path.join(checkpoint_dir, slug)


def completed_job_rows(parsed: Optional[List[Dict]],
                       jobs: Sequence[Tuple[Group, RunConfig]],
                       seeds: Sequence[int],
                       rounds: int) -> Dict[Tuple, List[Dict]]:
    """Map each fully completed job (every (seed, round) row present in
    a partial CSV) to its parsed rows: a resumed sweep skips those
    groups and passes their rows through verbatim."""
    if not parsed:
        return {}
    by_job: Dict[Tuple, List[Dict]] = {}
    for row in parsed:
        by_job.setdefault(_row_job_key(row), []).append(row)
    want = {(int(s), r) for s in seeds for r in range(rounds)}
    out: Dict[Tuple, List[Dict]] = {}
    for (group, run) in jobs:
        key = _job_key(*group, run)
        got = [row for row in by_job.get(key, [])
               if (row["seed"], row["round"]) in want]
        if {(row["seed"], row["round"]) for row in got} >= want:
            out[key] = got
    return out


def _group_rank(mesh: ClientMesh, args: Tuple) -> Dict:
    """One rank of a worker's client mesh: the group's rows (as JSON)
    and prefix seconds."""
    rows, prefix_s = _run_group_worker(args, mesh)
    return {"rows": rows, "prefix_s": prefix_s}


def _run_group_worker(args: Tuple, mesh: Optional[ClientMesh] = None
                      ) -> Tuple[List[Dict], List[float]]:
    """Top-level (picklable) worker: one cell group, in a spawned
    process on the same device, with its snapshot directory; on ``mesh``
    as one of its ranks.  A worker of a mesh run (``--workers N`` with
    ``--mesh clients=K``) spawns K ranks of its own and returns rank
    0's rows, as each of the reference's workers builds its own client
    mesh."""
    (scheme, classes, dist, seeds, rounds, cfg_fn, vmap_prefix, run,
     device, fields_fn, ckpt_dir, ckpt_every, resume) = args
    k = mesh_clients(run.mesh)
    if mesh is None and k > 1:
        first = spawn_ranks(_group_rank, k, device, args=(args,))[0]
        return first["rows"], first["prefix_s"]
    prefix_s: List[float] = []
    rows = run_seed_group(scheme, classes, dist, seeds, rounds,
                          cfg_fn=cfg_fn, vmap_prefix=vmap_prefix, run=run,
                          device=device, fields_fn=fields_fn,
                          prefix_s=prefix_s, checkpoint_dir=ckpt_dir,
                          checkpoint_every=ckpt_every, resume=resume,
                          mesh=mesh)
    return rows, prefix_s


def sweep(schemes: Sequence[str], classes_list: Sequence[int],
          distributions: Sequence[str], seeds: Sequence[int], rounds: int,
          cfg_fn: ConfigFn = fast_cell_config, vmap_prefix: bool = True,
          workers: int = 1, runs: Optional[Sequence[RunConfig]] = None,
          log: Optional[Callable[[str], None]] = None,
          out_path: Optional[str] = None, *, device=None,
          fields_fn: Optional[FieldsFn] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
          resume: bool = False,
          mesh: Optional[ClientMesh] = None) -> List[Dict]:
    """Run the whole grid and return aggregated tidy rows.

    ``runs`` is the scenario axis (default: the single synchronous
    scenario); every run is resolved, so an unported knob raises before
    any work.  ``workers > 1`` fans the groups out over spawned
    processes sharing ``device`` (``cfg_fn`` and ``fields_fn`` cross by
    reference, so they must be module-level functions).

    Preemption safety, as the reference's: with ``checkpoint_dir`` each
    group snapshots every ``checkpoint_every`` rounds under its own
    subdirectory (``_group_ckpt_dir``); with ``out_path`` the partial
    CSV is rewritten atomically after every finished group, whose
    snapshots are then cleared, and ``group-done`` fires.  ``resume``
    reads ``out_path`` back: completed groups are skipped (their rows
    pass through verbatim; ``_FMT`` parses and formats idempotently),
    unfinished ones restart from their snapshots, and the final CSV is
    the uninterrupted run's byte for byte.

    On a rank of the client mesh (``mesh``; every rank runs this with
    the same arguments) the groups run on the mesh and only rank 0
    logs, writes the partial CSV and clears snapshots; ``workers > 1``
    does not apply there (each worker of a mesh run spawns its own
    ranks, ``_run_group_worker``)."""
    lead = mesh is None or mesh.rank == 0
    log = (log or (lambda s: None)) if lead else (lambda s: None)
    runs = tuple(r.resolved() for r in runs) if runs else (
        RunConfig().resolved(),)
    jobs: List[Tuple[Group, RunConfig]] = [
        ((s, c, d), run) for run in runs for s in schemes
        for c in classes_list for d in distributions]

    done: Dict[Tuple, List[Dict]] = {}
    if resume and out_path and os.path.exists(out_path):
        with open(out_path) as f:
            parsed = parse_csv_rows(f.read())
        if parsed is None:
            warnings.warn(f"{out_path} is not a sweep CSV of this schema: "
                          f"ignoring it and rerunning the full grid",
                          RuntimeWarning)
        else:
            done = completed_job_rows(parsed, jobs, seeds, rounds)
    done_rows = [row for got in done.values() for row in got]

    def group_dir(job: Tuple[Group, RunConfig]) -> Optional[str]:
        (s, c, d), run = job
        return (_group_ckpt_dir(checkpoint_dir, s, c, d, run)
                if checkpoint_dir else None)

    todo = [(i, job) for i, job in enumerate(jobs)
            if _job_key(*job[0], job[1]) not in done]
    for key in done:
        log(f"[sweep] resume: skipping completed group "
            f"{'/'.join(str(p) for p in key)}")
    # a completed group's snapshots are stale: drop them, so a later
    # corruption there can never shadow the CSV's finished rows
    for job in jobs:
        if _job_key(*job[0], job[1]) in done and group_dir(job) and lead:
            RoundCheckpointer(group_dir(job)).clear()
    work = [(*job[0], tuple(seeds), rounds, cfg_fn, vmap_prefix, job[1],
             None if device is None else str(device), fields_fn,
             group_dir(job), checkpoint_every, resume) for _, job in todo]
    rows: List[Dict] = []

    def finish_group(index: int, job: Tuple, got: List[Dict],
                     prefix_s: List[float], seconds: Optional[float]
                     ) -> None:
        """The group's rows become durable (the partial CSV, atomically),
        its now redundant snapshots go, then ``group-done`` fires.  A
        kill anywhere here resumes cleanly: before the CSV lands, the
        group reruns from its snapshots."""
        (s, c, d), run = job
        rows.extend(got)
        if out_path and lead:
            write_atomic(out_path,
                         rows_to_csv(aggregate_rows(rows) + done_rows))
        if group_dir(job) and lead:
            RoundCheckpointer(group_dir(job)).clear()
        faults.fire("group-done", index=index)
        accs = [r["accuracy"] for r in got if r["round"] == rounds - 1]
        log(f"[sweep] {s} classes={c} {d} churn={run.churn_rate} "
            f"lam={run.staleness_lambda} cadence={run.agg_cadence_s or 0}: "
            f"final acc {np.mean(accs):.3f} +/- {np.std(accs):.3f} "
            f"({len(seeds)} seeds; prefix s a round "
            f"[{', '.join(f'{t:.4f}' for t in prefix_s)}]"
            + (f", {seconds:.1f}s)" if seconds is not None else ")"))

    if workers > 1 and mesh is None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=mp.get_context("spawn")) as pool:
            for (i, job), (got, prefix_s) in zip(
                    todo, pool.map(_run_group_worker, work)):
                finish_group(i, job, got, prefix_s, None)
        return aggregate_rows(rows) + done_rows
    for (i, job), args in zip(todo, work):
        t0 = time.time()
        got, prefix_s = _run_group_worker(args, mesh)
        finish_group(i, job, got, prefix_s, time.time() - t0)
    return aggregate_rows(rows) + done_rows


def scenario_runs(base: RunConfig, churn_rates: Sequence[float],
                  staleness_lambdas: Sequence[float],
                  agg_cadences: Sequence[float]) -> List[RunConfig]:
    """The async scenario axis: every (churn x lambda x cadence) combo
    as a resolved ``RunConfig`` derived from ``base``, as the
    reference's.  A lambda of 0 keeps the "drop" policy and a cadence of
    0 means the round period; any other scenario runs the event-driven
    server."""
    out = []
    for churn in churn_rates:
        for lam in staleness_lambdas:
            for cad in agg_cadences:
                out.append(dataclasses.replace(
                    base, churn_rate=churn,
                    staleness="weighted" if lam > 0 else base.staleness,
                    staleness_lambda=lam,
                    agg_cadence_s=cad if cad > 0 else None).resolved())
    return out


def _float_list(text: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schemes", default="all",
                    help="comma list or 'all' (dcs,ccs-fuzzy,random)")
    ap.add_argument("--classes", default="9",
                    help="comma list of classes-per-client (Fig. 8: 9,6,2)")
    ap.add_argument("--distributions", default="uniform",
                    help="comma list (Fig. 7: uniform,extreme)")
    ap.add_argument("--seeds", type=int, default=2,
                    help="number of seeds per cell (0..N-1)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--fast", action="store_true",
                    help="CPU-budget profile (the default)")
    ap.add_argument("--paper-profile", action="store_true",
                    help="Table 3 profile")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker processes for cell groups (1 = in-process;"
                         " they share the one device)")
    ap.add_argument("--no-vmap", action="store_true",
                    help="run each seed's selection prefix alone")
    add_run_arguments(ap)
    ap.add_argument("--churn-rates", type=_float_list, default=None,
                    help="comma list of coverage-window churn rates "
                         "(scenario axis; e.g. 0,0.3)")
    ap.add_argument("--staleness-lambdas", type=_float_list, default=None,
                    help="comma list of staleness decay lambdas (scenario "
                         "axis; 0 = hard-deadline drop)")
    ap.add_argument("--agg-cadences", type=_float_list, default=None,
                    help="comma list of aggregation cadences in simulated "
                         "seconds (scenario axis; 0 = the round period)")
    add_multihost_arguments(ap)
    ap.add_argument("--jit-cache-dir", default=None, metavar="DIR",
                    help="the reference's persistent jit cache (not "
                         "ported: raises)")
    ap.add_argument("--out", default="sweep.csv")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    # snapshots default to a directory beside the output, set before
    # RunConfig.from_args so that --resume validates, as the reference's
    if args.checkpoint_dir is None:
        args.checkpoint_dir = args.out + ".ckpt"
    if args.fast and args.paper_profile:
        ap.error("--fast and --paper-profile are mutually exclusive")
    if args.multihost > 1 and args.workers > 1:
        ap.error("--multihost and --workers are mutually exclusive (a "
                 "multi-process mesh is already one placement domain)")
    if args.seeds < 1:
        ap.error("--seeds must be >= 1")
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    schemes = SCHEMES if args.schemes == "all" \
        else tuple(args.schemes.split(","))
    for s in schemes:
        if s not in SCHEMES:
            ap.error(f"unknown scheme {s!r} (known: {SCHEMES})")
    classes_list = tuple(int(c) for c in args.classes.split(","))
    distributions = tuple(args.distributions.split(","))
    cfg_fn = paper_cell_config if args.paper_profile else fast_cell_config

    full_run = RunConfig.from_args(args)
    # the grid drives the rounds itself: the group snapshots are the
    # sweep's own (run_seed_group), not each simulation's
    base_run = dataclasses.replace(full_run, checkpoint_dir=None,
                                   checkpoint_every=1, resume=False)
    if (args.churn_rates is None and args.staleness_lambdas is None
            and args.agg_cadences is None):
        runs = [base_run]
    else:
        runs = scenario_runs(base_run,
                             args.churn_rates or (base_run.churn_rate,),
                             args.staleness_lambdas
                             or (base_run.staleness_lambda,),
                             args.agg_cadences
                             or (base_run.agg_cadence_s or 0.0,))
    device = resolve_device(args.device)
    k = mesh_clients(base_run.mesh)
    if should_spawn(args):
        # the parent of a --multihost P launch: build the kernels once,
        # then re-execute this module P times and wait
        if device.type == "cuda":
            build.build_all()
        return spawn_multihost("repro_torch.launch.sweep",
                               sys.argv[1:] if argv is None else list(argv),
                               args.multihost)
    multihost = multihost_from_args(args)
    lead = multihost is None or multihost[2] == 0

    t0 = time.time()
    build.reset_launches()
    kw = dict(seeds=range(args.seeds), rounds=args.rounds, cfg_fn=cfg_fn,
              vmap_prefix=not args.no_vmap, workers=args.workers, runs=runs,
              out_path=args.out, device=device,
              checkpoint_dir=full_run.checkpoint_dir,
              checkpoint_every=full_run.checkpoint_every,
              resume=full_run.resume)
    if k > 1 and lead:
        print(f"[sweep] client mesh: {{'clients': {k}}} over {k} ranks"
              + (f" / {multihost[1]} processes" if multihost else ""),
              flush=True)
    if k > 1 and args.workers <= 1:
        ranks = spawn_ranks(_sweep_rank, k, device,
                            args=(schemes, classes_list, distributions),
                            kwargs=kw, multihost=multihost)
        if not lead:
            return 0
        n_rows = int(ranks[0]["n_rows"])
    else:
        rows = sweep(schemes, classes_list, distributions,
                     log=lambda s: print(s, flush=True), **kw)
        write_atomic(args.out, rows_to_csv(rows))
        n_rows = len(rows)
    print(f"[sweep] wrote {n_rows} rows "
          f"({len(schemes)}x{len(classes_list)}x{len(distributions)} "
          f"cells x {len(runs)} scenarios x {args.seeds} seeds x "
          f"{args.rounds} rounds) to {args.out} on {device} in "
          f"{time.time() - t0:.0f}s", flush=True)
    if k > 1 and args.workers <= 1:
        for r, rank in enumerate(ranks):
            print(f"[sweep] rank {r} on {rank['device']}: launches "
                  f"{json.dumps(rank['launches'])}, host-staged "
                  f"collectives {json.dumps(rank['staged'])}", flush=True)
    elif device.type == "cuda" and args.workers <= 1:
        print(f"[sweep] launches {json.dumps(dict(build.LAUNCHES))}",
              flush=True)
    return 0


def _sweep_rank(mesh: ClientMesh, schemes, classes_list, distributions,
                **kw) -> Dict:
    """One rank of ``--mesh clients=K``: the whole grid on the mesh;
    rank 0 prints the placement and the log and writes the CSV.  Returns
    the row count, this rank's device, kernel launches and host-staged
    collectives."""
    if mesh.rank == 0:
        print(f"[sweep] {describe(mesh)}", flush=True)
    rows = sweep(schemes, classes_list, distributions,
                 log=lambda s: print(s, flush=True), mesh=mesh, **kw)
    if mesh.rank == 0:
        write_atomic(kw["out_path"], rows_to_csv(rows))
    return {"n_rows": len(rows), "device": str(mesh.device),
            "launches": dict(build.LAUNCHES), "staged": dict(mesh.staged)}


if __name__ == "__main__":
    raise SystemExit(main())
