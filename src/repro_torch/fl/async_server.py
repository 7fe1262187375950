"""The event-driven streaming FL server (the reference's
``fl/async_server.py``), on PyTorch.

The synchronous driver (``fl/rounds.py``) aggregates at a round
barrier: a selected client lands inside the Eq. 6 deadline or is
discarded.  ``EventDrivenServer`` generalizes it:

- **churn**: the prefix gates evaluation and selection on the RSU's
  coverage window (``mobility.coverage_active``) and reports each
  client's presence at its own upload instant; a vehicle that leaves
  coverage before its upload completes loses the update;
- **staleness**: with ``staleness="weighted"`` stragglers still train
  and their update lands at a later aggregation tick, its FedAvg weight
  scaled by ``timing.staleness_weight``, ``1 / (1 + lambda * delay)``;
- **cadence**: the server aggregates every ``agg_cadence_s`` simulated
  seconds (default: the round period) instead of at the barrier.

Tick algebra (host integers; ``P`` the round period ``deadline_s``,
``T`` the cadence)::

    round r spans      [r*P, (r+1)*P)
    update lands at    tick k = max(ceil(t_done / T), 1)
    tick k fires in    round ceil(k*T / P) - 1
    delay_rounds       = firing round - source round   (>= 0)

A tick's aggregation is one FedAvg (``fedavg_masked``) over the stacks
landing there, in enqueue order, then, in weighted mode, an **anchor**
row: the current global model at the discounted mass ``sum_i w_i (1 -
s_i)``.  A fresh tick is plain FedAvg; drop mode never adds the anchor.

With no churn, "drop" and the cadence at the round period every
surviving update lands at tick r + 1, which fires in round r: the
server is the round barrier, detected up front, and delegates training
and rows to ``FLSimulation`` verbatim, so its rows are the sync
driver's bit for bit.

On the client mesh (``FLSimulation(mesh=)``) the pool holds the
reference's sharded form: for each landing tick of a round the ranks
train that tick's cohort (each rank its slice,
``pipeline.train_groups_sharded``) with the tick's staleness factor
folded into the cohort weights (``weight_scale``), and the pool keeps
the all-reduced partial sums ``(num, den)`` and the tick's anchor mass,
tracked on the host from the clients' |D_i|.  A tick adds its partials,
then ``anchor * params`` and the anchor mass, and finishes Eq. 2 with
``pipeline.aggregate_sharded``.  Every rank holds the same pool.

``capture_state`` / ``restore_state`` carry the wrapped simulation's
state, the pending landing-tick pool and the open per-round stats in the
reference's layout, so updates enqueued rounds before a kill land at the
same tick with the same weights after the resume.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.device import to_device
from repro_torch.fl import pipeline
from repro_torch.fl.aggregation import fedavg_masked
from repro_torch.fl.rounds import FLSimulation, close_round, run_resumable
from repro_torch.fl.timing import staleness_weight

# rounds-behind histogram bins: delays 0, 1, 2, 3+ (aggregated updates)
HIST_BINS = 4

# the pool entries' scalar fields and their types (the snapshot's
# coercion, as the reference's)
_ENTRY_SCALARS = {"src": int, "n": int, "delay": int,
                  "anchor": float, "scale": float}


class EventDrivenServer:
    """Streaming aggregation over one ``FLSimulation``, behind the
    simulation's driver surface (``_dispatch_training``, ``_round_row``,
    ``finish_round``, ``run``), so ``rounds.run_schedule`` and the sweep
    drive it unchanged; the prefix stays the simulation's."""

    def __init__(self, sim: FLSimulation):
        self.sim = sim
        self.run_cfg = sim.run_cfg
        self.period = float(sim.stage_cfg.timing.deadline_s)
        self.cadence = float(self.run_cfg.agg_cadence_s
                             if self.run_cfg.agg_cadence_s is not None
                             else self.period)
        self.weighted = self.run_cfg.staleness == "weighted"
        # the degenerate server is the round barrier: delegate verbatim
        self.sync_equivalent = (self.run_cfg.churn_rate == 0.0
                                and not self.weighted
                                and self.cadence == self.period)
        if not self.sync_equivalent and self.run_cfg.engine != "batched":
            raise ValueError(
                "the event-driven pool path trains through the batched "
                f"engine; engine={self.run_cfg.engine!r} only supports "
                "the sync-equivalent configuration")
        # landing tick -> pending entries, in enqueue order
        self._pending: Dict[int, List[Dict]] = {}
        self._stats: Dict[int, Dict] = {}

    # -- tick algebra ---------------------------------------------------
    def _tick_round(self, k: int) -> int:
        """The round in which tick ``k`` fires (k*T falls inside it)."""
        return int(math.ceil(k * self.cadence / self.period)) - 1

    def _due_ticks(self, rnd: int) -> List[int]:
        """Pending ticks firing by the end of round ``rnd``, in order."""
        k_max = int(math.floor((rnd + 1) * self.period / self.cadence))
        return sorted(k for k in self._pending if k <= k_max)

    # -- training dispatch ----------------------------------------------
    def _dispatch_training(self, rnd: int, host: Dict,
                           fields: pipeline.RoundFields) -> None:
        """Enqueue round ``rnd``'s local training into landing-tick
        pools, then fire every tick due by the round's end.  Training
        starts from the global model broadcast at the round's start, so
        the enqueue comes first."""
        if self.sync_equivalent:
            self.sim._dispatch_training(rnd, host, fields)
            return
        self._stats[rnd] = {"n_agg": 0, "n_stale": 0, "eff": 0.0,
                            "hist": [0] * HIST_BINS}
        self._enqueue_round(rnd, host, fields)
        self._process_due_ticks(rnd)

    def landing_ticks(self, t_done: np.ndarray) -> np.ndarray:
        """Each client's landing tick from its upload instants (fp32 from
        the prefix, divided in fp64 on the host, as the reference's)."""
        t = np.asarray(t_done, np.float64)
        return np.maximum(np.ceil(t / self.cadence).astype(np.int64), 1)

    def _enqueue_round(self, rnd: int, host: Dict,
                       fields: pipeline.RoundFields) -> None:
        sim = self.sim
        mask = np.asarray(host["mask"])
        sim._record_participation(mask)
        survivors = np.asarray(host["survivors"]).astype(bool)
        alive = np.asarray(host["alive_at_done"]).astype(bool)
        # weighted mode trains every selected client (stragglers land
        # late, discounted); drop mode the Eq. 6 survivors.  Either way
        # a client out of coverage at its upload instant is lost.
        train_mask = ((mask > 0) if self.weighted else survivors) & alive
        if not train_mask.any():
            return
        land = self.landing_ticks(host["t_done"])
        lam = self.run_cfg.staleness_lambda
        perms = lambda i: fields.perms[i]
        if sim.mesh is not None:
            # one all-reduced partial (num, den) per landing tick, the
            # tick's staleness factor folded into the cohort weights, the
            # anchor mass tracked here from the same |D_i|
            for k in np.unique(land[train_mask]):
                bucket = train_mask & (land == k)
                delay = max(0, self._tick_round(int(k)) - rnd)
                s = staleness_weight(lam, delay) if self.weighted else 1.0
                trained = pipeline.train_groups_sharded(
                    sim.params, sim.device_groups(), sim._group_steps,
                    bucket, perms, sim.mesh, weight_scale=float(s),
                    **sim._train_args())
                if trained is None:
                    continue
                num, den = trained
                w_data = float(sim.n_valid[bucket].sum())
                self._pending.setdefault(int(k), []).append({
                    "src": rnd, "num": num, "den": den,
                    "anchor": float(w_data * (1.0 - s)),
                    "n": int(bucket.sum()), "delay": delay,
                    "scale": float(s)})
            return
        entries = pipeline.train_groups(
            sim.params, sim.device_groups(), sim._group_steps, train_mask,
            perms, return_entries=True, **sim._train_args())
        merged, w, row_ids = entries
        land_rows = land[row_ids]            # padding rows keep weight 0
        for k in np.unique(land_rows[w > 0]):
            delay = max(0, self._tick_round(int(k)) - rnd)
            s = staleness_weight(lam, delay) if self.weighted else 1.0
            wk = np.where(land_rows == k, w, 0.0).astype(np.float32)
            live = float(wk.sum())
            self._pending.setdefault(int(k), []).append({
                "src": rnd, "merged": merged,
                "w": (wk * np.float32(s) if s != 1.0 else wk),
                "anchor": float(live * (1.0 - s)),
                "n": int((wk > 0).sum()), "delay": delay,
                "scale": float(s)})

    def _process_due_ticks(self, rnd: int) -> None:
        """Fire every tick due by the end of round ``rnd``, in tick
        order, each its own FedAvg over the updates landing there.  An
        empty or zero-weight tick leaves the global model untouched.  On
        the mesh a tick sums its entries' partials, adds the anchor row's
        (``anchor * params``, ``anchor``) and finishes Eq. 2."""
        sim = self.sim
        stats = self._stats[rnd]
        for k in self._due_ticks(rnd):
            items = self._pending.pop(k)
            anchor = sum(it["anchor"] for it in items)
            if sim.mesh is not None:
                num, den = items[0]["num"], items[0]["den"]
                for it in items[1:]:
                    num = {key: num[key] + it["num"][key] for key in num}
                    den = den + it["den"]
                if anchor > 0.0:             # the discounted mass
                    a = float(np.float32(anchor))
                    num = {key: num[key] + a * sim.params[key].to(
                        num[key].dtype) for key in num}
                    den = den + a
                sim.params = pipeline.aggregate_sharded(sim.params,
                                                        (num, den))
                self._count(stats, items)
                continue
            w = np.concatenate([it["w"] for it in items])
            if float(w.sum()) + anchor <= 0.0:
                continue                     # zero-weight tick: no-op
            merged = items[0]["merged"] if len(items) == 1 else {
                key: torch.cat([it["merged"][key] for it in items])
                for key in items[0]["merged"]}
            if anchor > 0.0:                 # the discounted mass, last
                merged = {key: torch.cat([m, sim.params[key][None]])
                          for key, m in merged.items()}
                w = np.append(w, np.float32(anchor))
            sim.params = fedavg_masked(
                merged, to_device(torch.from_numpy(w), sim.device))
            self._count(stats, items)

    @staticmethod
    def _count(stats: Dict, items: List[Dict]) -> None:
        """A fired tick's updates into its round's stats."""
        for it in items:
            stats["n_agg"] += it["n"]
            if it["delay"] >= 1:
                stats["n_stale"] += it["n"]
            stats["eff"] += it["n"] * it["scale"]
            stats["hist"][min(it["delay"], HIST_BINS - 1)] += it["n"]

    # -- preemption safety ----------------------------------------------
    def capture_state(self) -> Dict:
        """The simulation's state plus the server's own: the pending
        landing-tick pool (each entry's ``merged`` stacks, or on the mesh
        its partial sums ``num``, on the host in the reference's layout;
        ``den`` in its own dtype, float64 as ``fedavg_sums`` keeps it, so
        a resumed tick divides as the uninterrupted one; ``w`` float32;
        the scalars coerced) and the open per-round stat accumulators."""
        to_host = lambda t: t.detach().cpu().numpy()
        pending = {str(k): [_coerce_entry(it, params_to_numpy, to_host)
                            for it in items]
                   for k, items in self._pending.items()}
        return {"sim": self.sim.capture_state(), "pending": pending,
                "stats": _coerce_stats(self._stats)}

    def restore_state(self, state: Dict,
                      extra: Optional[Dict] = None) -> None:
        """Restore a ``capture_state`` snapshot (the pool's stacks or
        partial sums onto the simulation's device)."""
        self.sim.restore_state(state["sim"], extra)
        dev = self.sim.device
        onto = lambda m: params_from_jax(m, device=dev)
        den = lambda v: torch.tensor(np.asarray(v), device=dev)
        self._pending = {int(k): [_coerce_entry(it, onto, den)
                                  for it in items]
                         for k, items in state["pending"].items()}
        self._stats = {int(r): s
                       for r, s in _coerce_stats(state["stats"]).items()}

    # -- rows and drivers -----------------------------------------------
    def _round_row(self, rnd: int, host: Dict, acc_count: torch.Tensor,
                   n_test: int) -> Dict[str, object]:
        row = self.sim._round_row(rnd, host, acc_count, n_test)
        if self.sync_equivalent:
            return row
        st = self._stats.pop(rnd)
        row["n_aggregated"] = st["n_agg"]
        row["stale_frac"] = (st["n_stale"] / st["n_agg"]
                             if st["n_agg"] else 0.0)
        row["n_effective"] = st["eff"]
        row["rounds_behind_hist"] = "/".join(str(h) for h in st["hist"])
        return row

    def finish_round(self, rnd: int, state: Dict[str, torch.Tensor],
                     fields: pipeline.RoundFields) -> Dict[str, object]:
        """Complete round ``rnd`` from a prefix's outputs
        (``rounds.close_round``)."""
        return close_round(self, self.sim, rnd, state, fields)

    def run(self, n_rounds: Optional[int] = None,
            overlap: Optional[bool] = None, *, checkpointer=None,
            resume: Optional[bool] = None) -> List[Dict[str, object]]:
        """Drive ``n_rounds`` rounds on the sync driver's schedule
        (``rounds.run_schedule``, round-ahead unless ``overlap`` or the
        run config says otherwise) with the tick pools behind
        ``_dispatch_training``; checkpoints and resume as
        ``FLSimulation.run``, the pool in every snapshot."""
        return run_resumable(self, self.sim,
                             n_rounds or self.sim.cfg.n_rounds,
                             overlap=overlap, checkpointer=checkpointer,
                             resume=resume)


def _coerce_entry(entry: Dict, params, den) -> Dict:
    """A pool entry with its model stacks or partial sums (``merged``,
    ``num``) passed through ``params`` and its weight total ``den``
    through ``den`` (to the host's layout or back onto the device),
    ``w`` float32 and the scalars coerced."""
    return {name: (params(v) if name in ("merged", "num")
                   else den(v) if name == "den"
                   else np.asarray(v, np.float32) if name == "w"
                   else _ENTRY_SCALARS[name](v))
            for name, v in entry.items()}


def _coerce_stats(stats: Dict) -> Dict[str, Dict]:
    """The open per-round stats with string keys and Python scalars."""
    return {str(r): {"n_agg": int(s["n_agg"]), "n_stale": int(s["n_stale"]),
                     "eff": float(s["eff"]),
                     "hist": [int(h) for h in s["hist"]]}
            for r, s in stats.items()}
