"""The federated round engine (paper Alg. 1 + §6 simulator).

``FLSimulation`` couples the synthetic non-iid partition, freeway
mobility, the Reno throughput predictor, the Eq. 6 timing model, the
fuzzy evaluator and one of the three selection schemes.  Each round:
the selection prefix (probe -> evaluate -> select -> deadline) runs on
the device (``fl/pipeline.py``); the survivors cross to the host once,
at the cohort gather; each capacity group's cohort trains with one
batched local-SGD call; masked FedAvg and the test accuracy close it.
A round whose windowed election overflowed re-runs its prefix through
the dense election on the same draws before the gather.

The batched engine and the serial driver are ported.  Randomness comes
from ``torch.Generator``s seeded from ``FLSimConfig.seed``, or from an
injected ``fields(rnd) -> RoundFields`` (the parity tests feed the
reference's draws through it).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.mnist_cnn import CONFIG as CNN_CFG
from repro_torch.core.fuzzy import FuzzyEvaluatorConfig, default_level_centers
from repro_torch.data.synthetic import make_dataset, train_test_split
from repro_torch.device import fp32_strict, resolve_device
from repro_torch.fl import pipeline
from repro_torch.fl.client import PROBE_BATCH, evaluate_accuracy
from repro_torch.fl.mobility import FreewayMobility, MobilityConfig
from repro_torch.fl.network import (NetworkConfig, draw_round_fields,
                                    pinned_channel_shadow)
from repro_torch.fl.partition import (PartitionConfig, partition,
                                      stack_clients, steps_per_epoch)
from repro_torch.fl.runconfig import RunConfig
from repro_torch.fl.schemes import get_scheme
from repro_torch.models.cnn import init_cnn


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
    deadline_s: float = 60.0
    model_bytes: float = 5.2e6
    slowdown_range: tuple = (1.0, 4.0)   # C_i heterogeneity
    probe_samples: int = 256             # Eq. 7 subsample
    samples_per_class: int = 6600
    seed: int = 0
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    mobility: MobilityConfig = field(default_factory=MobilityConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)


class FLSimulation:
    def __init__(self, cfg: FLSimConfig, run: Optional[RunConfig] = None,
                 *, device=None,
                 fields: Optional[Callable[[int],
                                           pipeline.RoundFields]] = None):
        get_scheme(cfg.scheme)               # unknown schemes raise here
        self.cfg = cfg
        self.n = cfg.partition.n_clients
        self.run_cfg = (run or RunConfig()).resolved()
        self.device = resolve_device(device)
        fp32_strict()
        self._fields = fields
        rng = np.random.default_rng(cfg.seed)
        images, labels = make_dataset(cfg.samples_per_class, seed=cfg.seed)
        (tr_i, tr_l), (te_i, te_l) = train_test_split(images, labels,
                                                      seed=cfg.seed)
        self.test_images = torch.as_tensor(te_i, device=self.device)
        self.test_labels = torch.as_tensor(te_l, device=self.device)

        parts = partition(tr_i, tr_l, cfg.partition)
        self.groups = stack_clients(parts, batch_size=cfg.batch_size)
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
        self.statics = self._build_statics()
        self.stage_cfg = self.run_cfg.to_stage_config(cfg, n_clients=self.n)

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

    def _build_packed_probe(self) -> None:
        """Pack every client's first ``probe_samples`` valid samples into
        one flat tensor.  ``fused_probe`` packs tight; otherwise each
        client is padded to whole probe batches with sentinel rows (seg
        == N, the overflow lane), as the reference's aligned pack."""
        probe = min(self.cfg.probe_samples, self.cap)
        take = np.minimum(self.n_valid, probe).astype(np.int64)
        batch = PROBE_BATCH
        align = 1 if self.run_cfg.fused_probe else batch
        im_shape = self.groups[0].images.shape[2:]
        ims, lbs, segs = [], [], []
        for i in range(self.n):
            gi, li = self._slot[i]
            g, t = self.groups[gi], int(take[i])
            pad = (-t) % align
            ims += [g.images[li, :t], np.zeros((pad,) + im_shape, np.float32)]
            lbs += [g.labels[li, :t], np.zeros(pad, np.int32)]
            segs += [np.full(t, i), np.full(pad, self.n)]
        used = sum(len(s) for s in segs)
        pad = max(batch, used) - used
        ims.append(np.zeros((pad,) + im_shape, np.float32))
        lbs.append(np.zeros(pad, np.int32))
        segs.append(np.full(pad, self.n))
        dev = self.device
        self._probe_images = torch.as_tensor(np.concatenate(ims), device=dev)
        self._probe_labels = torch.as_tensor(
            np.concatenate(lbs).astype(np.int32), device=dev)
        self._probe_seg = torch.as_tensor(
            np.concatenate(segs).astype(np.int32), device=dev)
        self._probe_counts = torch.as_tensor(take.astype(np.int32),
                                             device=dev)

    # -- randomness ------------------------------------------------------
    def round_fields(self, rnd: int) -> pipeline.RoundFields:
        """Round ``rnd``'s random draws: injected, or from a generator
        seeded by (seed, rnd) so any round can be re-run alone."""
        if self._fields is not None:
            return self._fields(rnd)
        cfg = self.cfg
        gen = torch.Generator().manual_seed(
            (cfg.seed * 1_000_003 + rnd) % (2 ** 63))
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
        return pipeline.selection_prefix(self.statics, self.params, rnd,
                                         fields, cfg=cfg)

    def resolve_elect_overflow(self, rnd: int, host: Dict[str, np.ndarray],
                               fields: pipeline.RoundFields
                               ) -> Dict[str, np.ndarray]:
        """The windowed election's escape hatch: when round ``rnd``'s
        prefix raised ``elect_overflow`` (the window could not hold every
        dense comparison), re-run the prefix with the dense election on
        the same ``fields`` and use that state instead.  The prefix is
        pure in ``(params, rnd, fields)``, so the masks are exactly the
        dense election's."""
        if int(host["elect_overflow"]) == 0:
            return host
        state = self.selection_state(rnd, fields, elect="gather")
        return {k: v.cpu().numpy() for k, v in state.items()}

    def run_round(self, rnd: int) -> Dict[str, float]:
        fields = self.round_fields(rnd)
        return self.finish_round(rnd, self.selection_state(rnd, fields),
                                 fields)

    def finish_round(self, rnd: int, state: Dict[str, torch.Tensor],
                     fields: pipeline.RoundFields) -> Dict[str, float]:
        """Steps 5 + 7 and the row: the prefix's outputs, the windowed
        election's overflow flag among them, cross to the host here,
        once, for the cohort gather (twice on an overflow round, whose
        dense re-run crosses too)."""
        host = self.resolve_elect_overflow(
            rnd, {k: v.cpu().numpy() for k, v in state.items()}, fields)
        survivors = host["survivors"]
        self.last_mask = host["mask"]
        cfg = self.cfg
        trained = pipeline.train_groups(
            self.params, self.groups, self._group_steps, survivors,
            lambda i: fields.perms[i], epochs=cfg.local_epochs,
            batch_size=cfg.batch_size, lr=cfg.lr)
        self.params = pipeline.aggregate(self.params, trained)
        acc = evaluate_accuracy(self.params, self.test_images,
                                self.test_labels, batch=256)
        return {"round": rnd, "accuracy": acc,
                "n_selected": int(host["n_selected"]),
                "n_aggregated": int(survivors.sum()),
                "n_straggler": int(host["n_straggler"]),
                "n_active": self.n,
                "mean_eval_selected": float(host["mean_eval_selected"])}

    def run(self, n_rounds: Optional[int] = None) -> List[Dict[str, float]]:
        """Drive ``n_rounds`` rounds serially."""
        return [self.run_round(r)
                for r in range(n_rounds or self.cfg.n_rounds)]
