"""The federated round engine (paper Alg. 1 + §6 simulator).

``FLSimulation`` couples the synthetic non-iid partition, freeway
mobility, the Reno throughput predictor, the Eq. 6 timing model, the
fuzzy evaluator and one of the three selection schemes.  Each round:
the selection prefix (probe -> evaluate -> select -> deadline) runs on
the device (``fl/pipeline.py``); the survivors cross to the host once,
at the cohort gather; then one of two engines trains and aggregates:

- ``engine="batched"`` (default): each capacity group's cohort trains
  with one batched local-SGD call, and masked FedAvg folds the groups;
- ``engine="loop"``: each survivor trains alone (``client.local_train``)
  at its group's cap and steps, on the same permutations, and the list
  ``fedavg`` averages them, in client order (the reference's loop).

An empty round is a no-op broadcast in both.  The test accuracy and
the row close the round; the row carries the reference's columns,
the synchronous server's async columns and the §4.2 communication
accounting (``_comm_accounting``, ``core/overhead.py``).  A round whose
windowed election overflowed re-runs its prefix through the dense
election on the same draws before the gather.

``run_schedule`` drives the rounds, serially or round-ahead (the
default, ``RunConfig.overlap_rounds``, as in the reference): the prefix
is pure in ``(statics, params, rnd, fields)`` and training only
enqueues, so round r+1's prefix is enqueued right after round r's
training and accuracy, before round r's row reads anything back.  The
one fence a round is the prefix's host crossing (``_host``); from there
to the next prefix's enqueue nothing waits for the card (round r+1's
draws are made on the host before round r's fence, the cohort stacks
live on the device, small host arrays cross through pinned memory), so
the host's row building and enqueuing overlap the card's training.
Both schedules run the same ops in the same order: their rows are
bit-equal.  ``RunConfig(server="event")`` (any churn, weighted
staleness or cadence) swaps the event-driven server
(``fl/async_server.py``) in behind the same surface
(``_dispatch_training``, ``_round_row``, ``finish_round``).

Built on a rank of the client mesh (``mesh=``, ``launch/mesh.py``), the
simulation runs the round's client axis over the K ranks, as the
reference's does under ``--mesh clients=K``: the rank keeps its own
region of the probe pack on its device, runs the sharded prefix
(``pipeline.selection_prefix_sharded``), gathers the round's (N,) mask
and survivors once, trains its slice of each capacity group's cohort
and closes FedAvg with an all-reduce (``train_groups_sharded``); the
loop engine trains every survivor on every rank, as the reference's
does on its mesh.  Every rank ends the round with the same global model
and row.

Randomness comes from ``torch.Generator``s seeded from
``FLSimConfig.seed`` and the round, or from an injected ``fields(rnd) ->
RoundFields`` (the parity tests feed the reference's draws through it).

Preemption safety, as the reference's: with a ``RoundCheckpointer``
(``train/checkpoint.py``; ``RunConfig.checkpoint_dir``) ``run_schedule``
snapshots the driver's ``capture_state`` after a round's row every
``checkpoint_every`` rounds, and ``resume_rows`` restores the newest good
snapshot, so a run killed at any round and resumed in a fresh process
gives the uninterrupted run's rows, masks, participation and params bit
for bit.  A round's draws are a function of (seed, round) and its prefix
is pure in the params, so nothing else needs saving: the round-ahead
prefix a kill threw away is enqueued again from the restored params.
The snapshot is taken after the row, outside the stretch from training
dispatch to the next prefix's enqueue: copying the params to the host
waits for the enqueued prefix, which the next round's fence waits for
anyway.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field, replace
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.mnist_cnn import CONFIG as CNN_CFG
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.fuzzy import FuzzyEvaluatorConfig, default_level_centers
from repro_torch.core.overhead import (IoVParams, accumulated_time_s,
                                       model_upload_bytes,
                                       state_maintenance_bytes)
from repro_torch.data.synthetic import make_dataset, train_test_split
from repro_torch.device import fp32_strict, resolve_device, to_device
from repro_torch.fl import pipeline
from repro_torch.fl.aggregation import fedavg
from repro_torch.fl.client import (PROBE_BATCH, evaluate_accuracy_async,
                                   local_train)
from repro_torch.fl.mobility import FreewayMobility, MobilityConfig
from repro_torch.fl.network import (NetworkConfig, draw_round_fields,
                                    pinned_channel_shadow)
from repro_torch.fl.partition import (PartitionConfig, partition,
                                      shard_client_range, stack_clients,
                                      steps_per_epoch)
from repro_torch.fl.runconfig import RunConfig
from repro_torch.fl.schemes import get_scheme
from repro_torch.launch import faults
from repro_torch.launch.mesh import ClientMesh, all_gather, mesh_clients
from repro_torch.models.cnn import init_cnn
from repro_torch.train.checkpoint import RoundCheckpointer

# a standalone run's draws: round r's generator is seeded with
# (seed * ROUND_SEED_STRIDE + r) mod 2^63 (``FLSimulation.round_fields``)
ROUND_SEED_STRIDE = 1_000_003


def build_round_checkpointer(run_cfg: RunConfig, checkpointer=None):
    """The drivers' checkpoint seam, as the reference's: an explicit
    ``RoundCheckpointer`` wins; otherwise one is built from the run
    config's ``checkpoint_dir`` / ``checkpoint_every``; ``None`` runs
    without snapshots."""
    if checkpointer is not None:
        return checkpointer
    if run_cfg.checkpoint_dir:
        return RoundCheckpointer(run_cfg.checkpoint_dir,
                                 every=run_cfg.checkpoint_every)
    return None


def resume_rows(restore: Callable[[Dict, Dict], None], ckpt,
                resume: bool) -> Tuple[List[Dict], int]:
    """Restore from the newest good snapshot through ``restore(state,
    extra)`` (a driver's ``restore_state``; the sweep restores each seed
    of a group) -> ``(rows so far, start round)``.

    Corrupt snapshots were already skipped, with a warning, inside
    ``latest_good``; no snapshot at all means a fresh start, so resume is
    safe to pass unconditionally."""
    if not resume or ckpt is None:
        return [], 0
    got = ckpt.latest_good()
    if got is None:
        return [], 0
    rnd, state, extra = got
    restore(state, extra)
    return [dict(r) for r in extra.get("rows", [])], rnd + 1


def checkpoint_round(capture: Callable[[], Dict], ckpt, rnd: int, rows, *,
                     lead: bool = True) -> None:
    """Snapshot ``capture()`` (a driver's ``capture_state``; the sweep
    captures every seed of a group) with the rows so far when round
    ``rnd`` is due (the lead rank only), then announce the
    fault-injection events."""
    if ckpt is not None and lead and ckpt.due(rnd):
        ckpt.save_round(rnd, capture(),
                        extra={"rows": rows, "next_round": rnd + 1})
        faults.fire("checkpoint-saved", round=rnd)
    faults.fire("round-done", round=rnd)


@dataclass
class FLSimConfig:
    scheme: str = "dcs"                  # dcs | ccs-fuzzy | random
    n_rounds: int = 20
    n_clients_central: int = 5           # CCS/random pick (Table 3)
    comm_range_m: float = 200.0
    top_m: int = 2                       # per 200 m area (Table 3)
    e_tau: float = 30.0
    local_epochs: int = 2
    batch_size: int = 20
    lr: float = 0.05
    prox_mu: float = 0.0                 # >0 enables FedProx
    deadline_s: float = 60.0
    model_bytes: float = 5.2e6
    state_bytes: float = 100.0           # §4.2 state message (CFL)
    eval_bytes: float = 30.0             # §4.2 evaluation message
    state_interval_s: float = 1.0        # §4.2 state-update interval tau
    slowdown_range: tuple = (1.0, 4.0)   # C_i heterogeneity
    probe_samples: int = 256             # Eq. 7 subsample
    samples_per_class: int = 6600
    uniform_capacity: bool = False       # True: one max-cap group
    seed: int = 0
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    mobility: MobilityConfig = field(default_factory=MobilityConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)


class FLSimulation:
    def __init__(self, cfg: FLSimConfig, run: Optional[RunConfig] = None,
                 *, device=None,
                 fields: Optional[Callable[[int],
                                           pipeline.RoundFields]] = None,
                 mesh: Optional[ClientMesh] = None):
        get_scheme(cfg.scheme)               # unknown schemes raise here
        self.cfg = cfg
        self.n = cfg.partition.n_clients
        self.run_cfg = (run or RunConfig()).resolved()
        k = mesh_clients(self.run_cfg.mesh)
        if (mesh.size if mesh is not None else 1) != k:
            raise ValueError(
                f"RunConfig.mesh={self.run_cfg.mesh!r} wants {k} rank(s); "
                f"got a mesh of {mesh.size if mesh else 'none'}: build the "
                f"simulation on each rank of launch.mesh.spawn_ranks")
        # a mesh of one rank is the single-device path, as in the
        # reference (a client axis needs more than one shard)
        self.mesh = mesh if k > 1 else None
        self.n_shards = pipeline.mesh_client_shards(self.mesh)
        self.shard = self.mesh.rank if self.mesh is not None else 0
        self.device = resolve_device(mesh.device if self.mesh is not None
                                     else device)
        fp32_strict()
        self._fields = fields
        rng = np.random.default_rng(cfg.seed)
        images, labels = make_dataset(cfg.samples_per_class, seed=cfg.seed)
        (tr_i, tr_l), (te_i, te_l) = train_test_split(images, labels,
                                                      seed=cfg.seed)
        self.test_images = torch.as_tensor(te_i, device=self.device)
        self.test_labels = torch.as_tensor(te_l, device=self.device)

        parts = partition(tr_i, tr_l, cfg.partition)
        self.groups = stack_clients(parts, batch_size=cfg.batch_size,
                                    uniform=cfg.uniform_capacity)
        self.cap = max(g.cap for g in self.groups)
        self._group_steps = [steps_per_epoch(g.cap, cfg.batch_size)
                             for g in self.groups]
        self.n_valid = np.zeros(self.n, np.int32)
        self._client_cap = np.zeros(self.n, np.int64)
        self._slot = np.zeros((self.n, 2), np.int64)
        for gi, g in enumerate(self.groups):
            self.n_valid[g.client_ids] = g.n_valid
            self._client_cap[g.client_ids] = g.cap
            self._slot[g.client_ids, 0] = gi
            self._slot[g.client_ids, 1] = np.arange(g.size)
        self._build_packed_probe()

        self.slowdown = rng.uniform(*cfg.slowdown_range, self.n)
        # quality proxy for the 'extreme' placement: big data + fast compute
        quality = (self.n_valid / self.n_valid.max()
                   + 1.0 / self.slowdown)
        self.mobility = FreewayMobility(
            cfg.mobility, quality_rank=np.argsort(-quality))
        self.fuzzy_cfg = FuzzyEvaluatorConfig(e_tau=cfg.e_tau)
        self.params = init_cnn(torch.Generator().manual_seed(cfg.seed),
                               CNN_CFG, self.device)
        self._channel_shadow = pinned_channel_shadow(self.n)
        self.last_mask: Optional[np.ndarray] = None
        # lifetime selection counts (the event server's and the sync
        # dispatch's one bookkeeping point, _record_participation)
        self.participation = np.zeros(self.n, np.int64)
        self.statics = self._build_statics()
        self.stage_cfg = self.run_cfg.to_stage_config(cfg, n_clients=self.n)
        self._dev_groups: Optional[Tuple] = None
        self.device_groups()                 # uploaded once, here

    def _build_statics(self) -> pipeline.RoundStatics:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        return pipeline.RoundStatics(
            x0=f32(self.mobility.x0), speeds=f32(self.mobility.speeds),
            jitter_phase=f32(self.mobility._jitter_phase),
            slowdown=f32(self.slowdown), n_valid=f32(self.n_valid),
            probe_images=self._probe_images,
            probe_labels=self._probe_labels, probe_seg=self._probe_seg,
            probe_counts=self._probe_counts,
            means=f32(self.fuzzy_cfg.means),
            sigmas=f32(self.fuzzy_cfg.sigmas),
            level_centers=default_level_centers(self.device))

    def device_groups(self) -> Tuple:
        """``self.groups`` with their stacks on the run's device
        (``pipeline.device_groups``), uploaded once per ``groups``
        object: assigning other groups uploads those."""
        if self._dev_groups is None or self._dev_groups[0] is not self.groups:
            self._dev_groups = (self.groups, pipeline.device_groups(
                self.groups, self.device))
        return self._dev_groups[1]

    def _probe_take(self) -> np.ndarray:
        """Probe samples per client: its first ``probe_samples`` valid."""
        probe = min(self.cfg.probe_samples, self.cap)
        return np.minimum(self.n_valid, probe).astype(np.int64)

    def probe_region(self, n_shards: int, shard: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Shard ``shard``'s region of the probe pack for a mesh of
        ``n_shards``: ``(images, labels, seg)`` on the run's device, the
        probe samples of the shard's clients in client order.
        ``fused_probe`` packs tight; otherwise each client is padded to
        whole probe batches with sentinel rows (seg == N, the overflow
        lane), as the reference's aligned pack.  Every region is padded
        with sentinel rows to the longest region's length, which the
        counts alone give: region d is rows ``[d * length, (d + 1) *
        length)`` of the reference's pack under an ``n_shards``-way
        mesh, and the whole pack for one shard."""
        take = self._probe_take()
        batch = PROBE_BATCH
        align = 1 if self.run_cfg.fused_probe else batch
        aligned = take + (-take) % align
        length = max(batch, max(
            int(aligned[list(shard_client_range(self.n, n_shards, d))]
                .sum()) for d in range(n_shards)))
        im_shape = self.groups[0].images.shape[2:]
        ims, lbs, segs = [], [], []
        for i in shard_client_range(self.n, n_shards, shard):
            gi, li = self._slot[i]
            g, t = self.groups[gi], int(take[i])
            pad = (-t) % align
            ims += [g.images[li, :t], np.zeros((pad,) + im_shape, np.float32)]
            lbs += [g.labels[li, :t], np.zeros(pad, np.int32)]
            segs += [np.full(t, i), np.full(pad, self.n)]
        pad = length - sum(len(s) for s in segs)
        ims.append(np.zeros((pad,) + im_shape, np.float32))
        lbs.append(np.zeros(pad, np.int32))
        segs.append(np.full(pad, self.n))
        dev = self.device
        return (torch.as_tensor(np.concatenate(ims), device=dev),
                torch.as_tensor(np.concatenate(lbs).astype(np.int32),
                                device=dev),
                torch.as_tensor(np.concatenate(segs).astype(np.int32),
                                device=dev))

    def _build_packed_probe(self) -> None:
        """This rank's region of the probe pack (the whole pack without
        a mesh), kept on its device, and every client's probe count."""
        (self._probe_images, self._probe_labels,
         self._probe_seg) = self.probe_region(self.n_shards, self.shard)
        self._probe_counts = torch.as_tensor(
            self._probe_take().astype(np.int32), device=self.device)

    # -- randomness ------------------------------------------------------
    def round_fields(self, rnd: int) -> pipeline.RoundFields:
        """Round ``rnd``'s random draws: injected, or from a generator
        seeded by (seed, rnd) so any round can be re-run alone."""
        if self._fields is not None:
            return self._fields(rnd)
        cfg = self.cfg
        gen = torch.Generator().manual_seed(
            (cfg.seed * ROUND_SEED_STRIDE + rnd) % (2 ** 63))
        loss_u, upload_shadow = draw_round_fields(self.n, gen)
        k = min(cfg.n_clients_central, self.n)
        random_idx = torch.randperm(self.n, generator=gen)[:k]
        perms = [torch.stack([torch.randperm(int(c), generator=gen)
                              for _ in range(cfg.local_epochs)])
                 for c in self._client_cap]
        return pipeline.RoundFields(self._channel_shadow, loss_u,
                                    upload_shadow, random_idx, perms)

    # -- one round ---------------------------------------------------------
    def selection_state(self, rnd: int,
                        fields: Optional[pipeline.RoundFields] = None,
                        elect: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
        """The selection prefix for round ``rnd`` (outputs on device).
        ``elect`` overrides the stage config's election for this call:
        the overflow fallback re-runs a round with ``elect="gather"``."""
        fields = fields if fields is not None else self.round_fields(rnd)
        cfg = self.stage_cfg
        if elect is not None and elect != cfg.elect:
            cfg = replace(cfg, elect=elect)
        if self.mesh is not None:
            return pipeline.selection_prefix_sharded(
                self.statics, self.params, rnd, fields, cfg=cfg,
                mesh=self.mesh)
        return pipeline.selection_prefix(self.statics, self.params, rnd,
                                         fields, cfg=cfg)

    def _host(self, state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The prefix's outputs on the host.  On a mesh, the round's mask
        and survivors first cross the ranks in one all-gather: the cohort
        gather and the row need the whole fleet's; under the event server
        (``server="event"``) so do each client's presence at its upload
        instant and, in a second all-gather, the instant itself (the
        pool's landing ticks)."""
        host = {k: v.cpu().numpy() for k, v in state.items()}
        if self.mesh is not None:
            event = self.run_cfg.server == "event"
            cols = [state["mask"], state["survivors"].to(torch.int32)]
            if event:
                cols.append(state["alive_at_done"].to(torch.int32))
            got = all_gather(self.mesh, torch.stack(cols, 1))
            got = got[:self.n].cpu().numpy()
            host["mask"], host["survivors"] = got[:, 0], got[:, 1] > 0
            if event:
                host["alive_at_done"] = got[:, 2] > 0
                host["t_done"] = all_gather(
                    self.mesh, state["t_done"])[:self.n].cpu().numpy()
        return host

    def resolve_elect_overflow(self, rnd: int, host: Dict[str, np.ndarray],
                               fields: pipeline.RoundFields
                               ) -> Dict[str, np.ndarray]:
        """The windowed election's escape hatch: when round ``rnd``'s
        prefix raised ``elect_overflow`` (the window could not hold every
        dense comparison), re-run the prefix with the dense election on
        the same ``fields`` and use that state instead (its
        ``elect_overflow`` keeps the windowed prefix's flag).  The prefix
        is pure in ``(params, rnd, fields)``, so the masks are exactly
        the dense election's."""
        if int(host["elect_overflow"]) == 0:
            return host
        rerun = self._host(self.selection_state(rnd, fields, elect="gather"))
        rerun["elect_overflow"] = host["elect_overflow"]
        return rerun

    def run_round(self, rnd: int) -> Dict[str, object]:
        fields = self.round_fields(rnd)
        return self.finish_round(rnd, self.selection_state(rnd, fields),
                                 fields)

    def finish_round(self, rnd: int, state: Dict[str, torch.Tensor],
                     fields: pipeline.RoundFields) -> Dict[str, object]:
        """Steps 5 + 7 and the row from a prefix's outputs (which may
        come from the sweep's seed-batched prefix): the outputs, the
        windowed election's overflow flag among them, cross to the host
        here, once, for the cohort gather (twice on an overflow round,
        whose dense re-run crosses too)."""
        return close_round(self, self, rnd, state, fields)

    def _dispatch_training(self, rnd: int, host: Dict[str, np.ndarray],
                           fields: pipeline.RoundFields) -> None:
        """Steps 5 + 7 from the round's host-side prefix outputs: the
        cohort gather, local SGD and FedAvg, enqueued; ``self.params``
        is then the card's pending result."""
        self._record_participation(host["mask"])
        perms = lambda i: fields.perms[i]
        if self.run_cfg.engine == "loop":
            self._train_loop(host["survivors"], perms)
        else:
            self._train_batched(host["survivors"], perms)

    def _record_participation(self, mask: np.ndarray) -> None:
        """Keep the round's selection mask and count each selected
        client's participation (the sync dispatch's and the event
        server's one bookkeeping point)."""
        self.last_mask = np.asarray(mask)
        self.participation[self.last_mask > 0] += 1

    # -- preemption safety -----------------------------------------------
    def _draw_identity(self) -> Optional[Dict[str, int]]:
        """What fixes this run's draws: the seed and the per-round
        seeding rule of ``round_fields``; ``None`` for injected draws."""
        if self._fields is not None:
            return None
        return {"seed": int(self.cfg.seed),
                "round_seed_stride": ROUND_SEED_STRIDE}

    def capture_state(self) -> Dict:
        """The complete mutable round state as host arrays, in the
        reference's layout: params (nested HWIO / ``(in, out)`` numpy,
        ``convert.params_to_numpy``), the participation counters (int64),
        the last selection mask (float32, zeros before round 0) and the
        mobility field (float64); and, in place of the reference's JAX
        keys, the draw identity (``draws``).  Everything else a round
        reads is rebuilt from ``FLSimConfig`` at construction.  The
        identity and the mobility field are constants of the config,
        kept so that ``restore_state`` can verify the snapshot's
        configuration instead of trusting the caller."""
        return {
            "params": params_to_numpy(self.params),
            "draws": self._draw_identity(),
            "participation": np.array(self.participation, np.int64),
            "last_mask": (np.asarray(self.last_mask, np.float32)
                          if self.last_mask is not None
                          else np.zeros(self.n, np.float32)),
            "mobility": {
                "x0": np.asarray(self.mobility.x0, np.float64),
                "speeds": np.asarray(self.mobility.speeds, np.float64),
                "jitter_phase": np.asarray(self.mobility._jitter_phase,
                                           np.float64)},
        }

    def restore_state(self, state: Dict,
                      extra: Optional[Dict] = None) -> None:
        """Restore a ``capture_state`` snapshot (params onto this run's
        device).  Raises ``ValueError`` when the snapshot came from
        another configuration: another fleet size, other draws (another
        seed, or a snapshot of injected draws or of the reference's JAX
        keys, unless this simulation's draws are injected too: then the
        caller vouches for them) or another mobility field.

        ``overflow@resume`` (``launch/faults.py``) forces the windowed
        election's overflow in every later round, so each takes the
        dense re-run (the masks stay exact): it clamps the ring halo's
        bucket capacity to 1, as the reference's does, and the sorted
        window to 1, which one device's windowed election reads (the
        capacity binds only on the mesh)."""
        part = np.asarray(state["participation"])
        if part.shape != (self.n,):
            raise ValueError(
                f"checkpoint is for a {part.shape[0]}-client fleet; this "
                f"simulation has {self.n} clients")
        if (self._fields is None
                and state.get("draws") != self._draw_identity()):
            raise ValueError(
                f"checkpoint PRNG base {state.get('draws')!r} does not "
                f"match this simulation's {self._draw_identity()!r} "
                f"(another seed, or a snapshot of injected or JAX draws)")
        mob = state["mobility"]
        for name, cur in (("x0", self.mobility.x0),
                          ("speeds", self.mobility.speeds),
                          ("jitter_phase", self.mobility._jitter_phase)):
            if not np.array_equal(np.asarray(mob[name], np.float64),
                                  np.asarray(cur, np.float64)):
                raise ValueError(
                    f"checkpoint mobility field {name!r} does not match "
                    f"this simulation's configuration")
        self.params = params_from_jax(state["params"], device=self.device)
        self.participation = part.astype(np.int64)
        self.last_mask = np.asarray(state["last_mask"]).astype(np.int32)
        if faults.active("overflow", "resume"):
            self.stage_cfg = replace(self.stage_cfg, elect_capacity=1,
                                     elect_window=1)

    def _train_args(self) -> Dict[str, float]:
        cfg = self.cfg
        return dict(epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                    lr=cfg.lr, prox_mu=cfg.prox_mu)

    def _train_batched(self, survivors: np.ndarray,
                       perms: Callable[[int], torch.Tensor]) -> None:
        """One ``local_train_batch`` per capacity group over its surviving
        cohort, the groups folded into one masked FedAvg (on the mesh:
        each rank's slice, the sums all-reduced).  An empty round or
        group cohort is skipped."""
        if self.mesh is not None:
            trained = pipeline.train_groups_sharded(
                self.params, self.device_groups(), self._group_steps,
                survivors, perms, self.mesh, **self._train_args())
            self.params = pipeline.aggregate_sharded(self.params, trained)
        else:
            trained = pipeline.train_groups(
                self.params, self.device_groups(), self._group_steps,
                survivors, perms, **self._train_args())
            self.params = pipeline.aggregate(self.params, trained)

    def _train_loop(self, survivors: np.ndarray,
                    perms: Callable[[int], torch.Tensor]) -> None:
        """The reference's loop engine: each survivor, in client order,
        trains alone at its own group's cap and steps per epoch, on the
        permutations the batched engine reads; the list ``fedavg``
        averages the models.  An empty round is a no-op broadcast."""
        dev = self.device
        models, weights = [], []
        for i in np.where(survivors)[0]:
            gi, li = self._slot[i]
            g = self.device_groups()[gi]
            p_i, _ = local_train(
                self.params, g.images[li], g.labels[li],
                to_device(torch.as_tensor(g.n_valid[li]), dev),
                to_device(torch.as_tensor(perms(int(i))), dev),
                steps_per_epoch=self._group_steps[gi], **self._train_args())
            models.append(p_i)
            weights.append(float(self.n_valid[i]))
        if models:                                  # Eq. 2
            self.params = fedavg(models, weights)

    def _comm_accounting(self, n_selected: int) -> Dict[str, float]:
        """The round's §4.2 communication (bytes and time, Fig. 9) through
        ``core/overhead.py``, as the reference's: the scheme's
        ``overhead_key`` picks the accumulated-time model, ``"cfl"``
        schemes keep classical full state, the others exchange
        evaluations (cloud or DSRC).  Host float arithmetic in the
        reference's order, so the columns equal its bit for bit."""
        cfg = self.cfg
        key = get_scheme(cfg.scheme).overhead_key
        state_bytes = (cfg.state_bytes if key == "cfl" else cfg.eval_bytes)
        p = IoVParams(n_participants=self.n, clients_per_round=n_selected,
                      round_period_s=cfg.deadline_s,
                      model_bytes=cfg.model_bytes,
                      state_bytes_cfl=cfg.state_bytes,
                      state_bytes_ccs_fuzzy=cfg.eval_bytes,
                      eval_bytes_dcs=cfg.eval_bytes,
                      uplink_bps_best=cfg.network.best_rate_bps,
                      uplink_bps_worst=cfg.network.worst_rate_bps)
        comm_t = accumulated_time_s(key, cfg.state_interval_s, p)
        upload_t = accumulated_time_s("model-only", cfg.state_interval_s, p)
        return {"state_bytes": state_maintenance_bytes(
                    self.n, state_bytes, cfg.deadline_s,
                    cfg.state_interval_s),
                "upload_bytes": model_upload_bytes(n_selected,
                                                   cfg.model_bytes),
                "state_time_s": comm_t - upload_t,
                "comm_time_s": comm_t}

    def _round_row(self, rnd: int, host: Dict[str, np.ndarray],
                   acc_count: torch.Tensor, n_test: int
                   ) -> Dict[str, object]:
        """The round's row in the reference's key order, Python scalars
        only (``json.dumps`` takes it); reading the accuracy count here
        is the round's second and last wait for the card.  The async
        columns hold the synchronous server's values (every aggregated
        update on time; the active fleet from the prefix, all of it
        without churn); the event server overrides them."""
        n_selected = int(host["n_selected"])
        n_agg = int(host["survivors"].sum())
        row = {"round": rnd,
               "accuracy": float(acc_count) / float(n_test),
               "n_selected": n_selected,
               "n_aggregated": n_agg,
               "n_straggler": int(host["n_straggler"]),
               "n_active": int(host.get("n_active", self.n)),
               "stale_frac": 0.0,
               "n_effective": float(n_agg),
               "rounds_behind_hist": f"{n_agg}/0/0/0",
               "mean_eval_selected": float(host["mean_eval_selected"])}
        row.update(self._comm_accounting(n_selected))
        return row

    def driver(self):
        """The round driver of this run: the simulation itself (the round
        barrier) or, under ``RunConfig(server="event")``, a new
        ``EventDrivenServer`` wrapping it."""
        if self.run_cfg.server == "event":
            from repro_torch.fl.async_server import EventDrivenServer
            return EventDrivenServer(self)
        return self

    def run(self, n_rounds: Optional[int] = None,
            overlap: Optional[bool] = None, *, checkpointer=None,
            resume: Optional[bool] = None) -> List[Dict[str, object]]:
        """Drive ``n_rounds`` rounds through ``driver()``, round-ahead
        unless ``overlap`` (default: ``RunConfig.overlap_rounds``) is
        False; the rows are the same either way.  With a
        ``checkpointer`` (or the run config's ``checkpoint_dir``) the
        round state is snapshotted every ``checkpoint_every`` rounds;
        ``resume`` (default: the run config's) first restores the newest
        good snapshot and runs the rounds after it."""
        return run_resumable(self.driver(), self,
                             n_rounds or self.cfg.n_rounds, overlap=overlap,
                             checkpointer=checkpointer, resume=resume)


def close_round(driver, sim: FLSimulation, rnd: int,
                state: Dict[str, torch.Tensor],
                fields: pipeline.RoundFields) -> Dict[str, object]:
    """Round ``rnd`` of ``driver`` (``sim`` or an ``EventDrivenServer``
    over it) from a prefix's outputs: the host crossing, the training
    dispatch, the accuracy, the row."""
    host = sim.resolve_elect_overflow(rnd, sim._host(state), fields)
    driver._dispatch_training(rnd, host, fields)
    acc, n_test = evaluate_accuracy_async(
        sim.params, sim.test_images, sim.test_labels, batch=256)
    return driver._round_row(rnd, host, acc, n_test)


def run_resumable(driver, sim: FLSimulation, n_rounds: int, *,
                  overlap: Optional[bool] = None, checkpointer=None,
                  resume: Optional[bool] = None,
                  **schedule_kw) -> List[Dict[str, object]]:
    """``run_schedule`` behind the run config's checkpoint knobs: the
    checkpointer (``build_round_checkpointer``), the resume
    (``resume_rows``; default ``RunConfig.resume``) and the schedule
    (default ``RunConfig.overlap_rounds``)."""
    run_cfg = sim.run_cfg
    ckpt = build_round_checkpointer(run_cfg, checkpointer)
    rows, start = resume_rows(driver.restore_state, ckpt,
                              run_cfg.resume if resume is None else resume)
    return run_schedule(driver, sim, n_rounds,
                        overlap=(run_cfg.overlap_rounds if overlap is None
                                 else overlap),
                        checkpointer=ckpt, start=start, rows=rows,
                        **schedule_kw)


def run_schedule(driver, sim: FLSimulation, n_rounds: int, *, overlap: bool,
                 stretch: Optional[Callable[[int], ContextManager]] = None,
                 on_row: Optional[Callable[[int, Dict, Dict], None]] = None,
                 checkpointer: Optional[RoundCheckpointer] = None,
                 start: int = 0, rows: Optional[List[Dict]] = None
                 ) -> List[Dict[str, object]]:
    """Rounds ``start .. n_rounds - 1`` of ``driver`` (``sim`` itself or
    an ``EventDrivenServer`` over it), serial or round-ahead, appended
    to ``rows`` (a resumed run's rows so far).

    A round: its prefix's outputs cross to the host (the fence, with
    the overflow re-run), the driver enqueues training and the accuracy
    is enqueued; round-ahead, round r+1's prefix is enqueued next, on
    the draws made before the fence, and only then does round r's row
    read the accuracy.  Serially, round r+1's draws and prefix come
    after the row.  ``stretch(r)``, when given, is a context entered
    from round r's training dispatch through the next prefix's enqueue
    (``chip_smoke.py`` runs it under ``torch.cuda.set_sync_debug_mode``);
    ``on_row(r, host, row)`` sees each round's host-side prefix outputs
    and row.  After each row, ``checkpoint_round`` snapshots the
    driver's state when ``checkpointer`` says the round is due (on the
    mesh, rank 0 writes) and fires the round's fault events."""
    stretch = stretch or (lambda r: contextlib.nullcontext())
    rows = [] if rows is None else rows
    lead = sim.mesh is None or sim.mesh.rank == 0
    fields = state = None
    for r in range(start, n_rounds):
        if state is None:                    # serial, or the first round
            fields = sim.round_fields(r)
            state = sim.selection_state(r, fields)
        # round-ahead: draw round r+1 on the host while the card works
        nxt = sim.round_fields(r + 1) if overlap and r + 1 < n_rounds \
            else None
        host = sim.resolve_elect_overflow(r, sim._host(state), fields)
        with stretch(r):
            driver._dispatch_training(r, host, fields)
            acc, n_test = evaluate_accuracy_async(
                sim.params, sim.test_images, sim.test_labels, batch=256)
            state = (sim.selection_state(r + 1, nxt) if nxt is not None
                     else None)
        row = driver._round_row(r, host, acc, n_test)
        rows.append(row)
        if on_row is not None:
            on_row(r, host, row)
        checkpoint_round(driver.capture_state, checkpointer, r, rows,
                         lead=lead)
        fields = nxt
    return rows
