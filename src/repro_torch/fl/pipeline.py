"""Staged round pipeline (paper Alg. 1 steps 1-7 as data flow).

    positions(statics, cfg, t)                      -> (N,) road positions
    features(statics, cfg, params, t, fields)       -> (pos, raw (N, 4))
    evaluate(statics, feats_raw)                    -> (N,) fuzzy evals
    select(cfg, pos, evals, fields)                 -> (N,) int32 mask
    deadline_filter(statics, cfg, pos, mask, shadow) -> (survivors, n_straggler)
    train_groups(...) / aggregate(...)              -> new global params

``selection_prefix`` runs probe -> evaluate -> select -> deadline with
every output left on the device: nothing crosses to the host between
stages.  The survivors cross once, at the cohort gather in
``train_groups``.  On a CUDA device the prefix runs the hand-written
kernels (``kernels/ops.py``): the fused probe -> Eq. 8 -> Mamdani kernel
(``fused_probe=True``) or the standalone Mamdani kernel behind the
plain-PyTorch probe (``fused_probe=False``), and for ``dcs`` the dense
election (``elect="gather"``) or the windowed counts
(``elect="windowed"``), whose ``elect_overflow`` flag sends the round
back through the dense election (``FLSimulation.finish_round``).

Every random draw of a round enters as a ``RoundFields`` tensor, so a
round is deterministic in ``(statics, params, rnd, fields)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rules import build_rule_table
from repro_torch.core.selection import selection_stats
from repro_torch.fl.aggregation import fedavg_masked
from repro_torch.fl.client import dataset_loss_packed, local_train_batch
from repro_torch.fl.mobility import positions as mobility_positions
from repro_torch.fl.network import (NetworkConfig,
                                    predicted_throughput_from_fields,
                                    upload_time_s_from_shadow)
from repro_torch.fl.partition import ClientGroup
from repro_torch.fl.schemes import get_scheme
from repro_torch.fl.timing import (TimingConfig, completes_before_deadline,
                                   training_time_s)
from repro_torch.kernels import ops as kops

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RoundStatics:
    """Tensors that never change across rounds, on the run's device."""
    x0: torch.Tensor              # (N,) freeway mobility constants
    speeds: torch.Tensor          # (N,)
    jitter_phase: torch.Tensor    # (N,)
    slowdown: torch.Tensor        # (N,) C_i >= 1
    n_valid: torch.Tensor         # (N,) float32 |D_i|
    probe_images: torch.Tensor    # (S, 28, 28, 1) packed Eq. 7 probe
    probe_labels: torch.Tensor    # (S,) int32
    probe_seg: torch.Tensor       # (S,) int32 client id (N = padding)
    probe_counts: torch.Tensor    # (N,) int32 samples per client
    means: torch.Tensor           # (4, 3) fuzzy membership parameters
    sigmas: torch.Tensor          # (4, 3)
    level_centers: torch.Tensor   # (9,)


@dataclasses.dataclass(frozen=True)
class RoundFields:
    """One round's random draws.  ``perms[i]`` is client i's (epochs,
    cap) sample orders for local SGD."""
    channel_shadow: torch.Tensor  # (N,) pinned predictor shadow
    loss_u: torch.Tensor          # (64, N) Reno loss uniforms
    upload_shadow: torch.Tensor   # (N,) upload-time shadow
    random_idx: torch.Tensor      # (k,) the uniform scheme's draw
    perms: Optional[Sequence[torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Scalar configuration of the prefix."""
    scheme: str                   # dcs | ccs-fuzzy | random
    n_clients: int
    comm_range_m: float
    top_m: int
    e_tau: float
    n_clients_central: int
    model_bytes: float
    road_length_m: float
    speed_jitter: float
    timing: TimingConfig
    network: NetworkConfig
    # the fused probe -> Eq. 8 -> Mamdani kernel (with the tight probe
    # pack); False runs the plain probe and the standalone Mamdani kernel
    fused_probe: bool
    # DCS election: "gather" (the dense O(N^2) election) or "windowed"
    # (the O(N * W) position-sorted window, flagged on overflow);
    # RunConfig resolves "auto"
    elect: str
    elect_window: int             # sorted neighbours per side (0 = auto)


@functools.lru_cache(maxsize=None)
def _rules() -> Tuple[np.ndarray, np.ndarray]:
    """The 81-rule base as host constants."""
    return build_rule_table()


def positions(st: RoundStatics, cfg: StageConfig,
              t_s: torch.Tensor) -> torch.Tensor:
    """Mobility stage: wrapped freeway positions at time ``t_s``."""
    return mobility_positions(st.x0, st.speeds, st.jitter_phase, t_s,
                              road_length_m=cfg.road_length_m,
                              speed_jitter=cfg.speed_jitter)


def aux_features(st: RoundStatics, cfg: StageConfig, pos: torch.Tensor,
                 fields: RoundFields) -> torch.Tensor:
    """Raw [SQ=|D_i|, TA=predicted bps, CC=1/C_i] columns (N, 3)."""
    ta = predicted_throughput_from_fields(
        cfg.network, pos, fields.channel_shadow.to(pos.device),
        fields.loss_u.to(pos.device))
    return torch.stack([st.n_valid, ta, 1.0 / st.slowdown], dim=1).float()


def features(st: RoundStatics, cfg: StageConfig, params: Params,
             t_s: torch.Tensor, fields: RoundFields
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe stage (Alg. 1 steps 1-2): ``(pos, raw feats (N, 4))`` with
    columns [SQ, TA, CC, LF]; Eq. 8 happens in ``evaluate``."""
    pos = positions(st, cfg, t_s)
    lf = dataset_loss_packed(params, st.probe_images, st.probe_labels,
                             st.probe_seg, st.probe_counts,
                             n_clients=cfg.n_clients)
    return pos, torch.cat([aux_features(st, cfg, pos, fields),
                           lf[:, None]], dim=1)


def evaluate(st: RoundStatics, feats_raw: torch.Tensor) -> torch.Tensor:
    """Fuzzy evaluation stage (paper §5): raw (N, 4) -> (N,) on [0, 100],
    Eq. 8 inside the kernel (``normalize=True``)."""
    table, levels = _rules()
    return kops.fuzzy_eval(feats_raw, st.means, st.sigmas, table, levels,
                           st.level_centers, normalize=True)


def select(cfg: StageConfig, pos: torch.Tensor, evals: torch.Tensor,
           fields: RoundFields) -> torch.Tensor:
    """Selection stage (Alg. 1 step 4) through the scheme registry."""
    return get_scheme(cfg.scheme).select(cfg, pos, evals, fields)


def deadline_filter(st: RoundStatics, cfg: StageConfig, pos: torch.Tensor,
                    mask: torch.Tensor, upload_shadow: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 6 straggler stage: ``(survivors (N,) bool, n_straggler)``."""
    train_t = training_time_s(cfg.timing, st.slowdown, st.n_valid)
    upload_t = upload_time_s_from_shadow(cfg.network, pos, cfg.model_bytes,
                                         upload_shadow.to(pos.device))
    ok = completes_before_deadline(cfg.timing, train_t, upload_t)
    selected = mask > 0
    return selected & ok, (selected & ~ok).sum()


def selection_prefix(st: RoundStatics, params: Params, rnd: int,
                     fields: RoundFields, *,
                     cfg: StageConfig) -> Dict[str, torch.Tensor]:
    """Probe -> evaluate -> select -> deadline for round ``rnd``; every
    output stays on the statics' device."""
    dev = st.x0.device
    t_s = torch.tensor(float(rnd), dtype=torch.float32,
                       device=dev) * cfg.timing.deadline_s
    with torch.no_grad():
        if cfg.fused_probe:
            pos = positions(st, cfg, t_s)
            table, levels = _rules()
            feats, evals = kops.probe_fuzzy(
                params, st.probe_images, st.probe_labels, st.probe_seg,
                st.probe_counts, aux_features(st, cfg, pos, fields),
                st.means, st.sigmas, table, levels, st.level_centers,
                n_clients=cfg.n_clients)
        else:
            pos, feats = features(st, cfg, params, t_s, fields)
            evals = evaluate(st, feats)
        windowed = get_scheme(cfg.scheme).select_windowed
        if cfg.elect == "windowed" and windowed is not None:
            mask, elect_overflow = windowed(cfg, pos, evals, fields)
        else:
            mask = select(cfg, pos, evals, fields)
            elect_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        survivors, n_straggler = deadline_filter(st, cfg, pos, mask,
                                                 fields.upload_shadow)
        stats = selection_stats(mask, evals)
    return {"pos": pos, "feats": feats, "evals": evals, "mask": mask,
            "survivors": survivors, "n_straggler": n_straggler,
            "n_selected": stats["n_selected"],
            "n_survivor": survivors.sum(),
            "mean_eval_selected": stats["mean_eval_selected"],
            "elect_overflow": elect_overflow}


def cohort_bucket(k: int) -> int:
    """Cohort tensor size for k survivors: next multiple of 2, min 2 (the
    reference's fixed-shape buckets; padding rows train at weight 0)."""
    return max(2, k + (k % 2))


def train_groups(params: Params, groups: Sequence[ClientGroup],
                 group_steps: Sequence[int], survivors: np.ndarray,
                 perms: Callable[[int], torch.Tensor], *, epochs: int,
                 batch_size: int, lr: float
                 ) -> Optional[Tuple[Params, torch.Tensor]]:
    """Local-training stage (Eq. 1): one ``local_train_batch`` per
    capacity group over that group's surviving cohort.

    ``survivors`` is the round's host-side mask (the one crossing);
    ``perms(i)`` gives client i's (epochs, cap) sample orders.  Returns
    ``(stacked models, weights)`` with padding duplicates at weight
    zero, or ``None`` for an empty round."""
    if not survivors.any():
        return None
    dev = next(iter(params.values())).device
    stacks, weights = [], []
    for gi, g in enumerate(groups):
        cohort = np.where(survivors[g.client_ids])[0]       # group-local
        k = len(cohort)
        if k == 0:
            continue                         # empty cohort: skip group
        idx = np.concatenate([cohort,
                              np.full(cohort_bucket(k) - k, cohort[0])])
        ids = g.client_ids[idx]
        stacked, _ = local_train_batch(
            params, torch.as_tensor(g.images[idx], device=dev),
            torch.as_tensor(g.labels[idx], device=dev),
            torch.as_tensor(g.n_valid[idx], device=dev),
            torch.stack([torch.as_tensor(perms(int(i))) for i in ids], 1),
            epochs=epochs, batch_size=batch_size,
            steps_per_epoch=group_steps[gi], lr=lr)
        w = g.n_valid[idx].astype(np.float32)
        w[k:] = 0.0                          # padding duplicates drop out
        stacks.append(stacked)
        weights.append(w)
    merged = {k: torch.cat([s[k] for s in stacks]) for k in stacks[0]}
    return merged, torch.as_tensor(np.concatenate(weights), device=dev)


def aggregate(params: Params,
              trained: Optional[Tuple[Params, torch.Tensor]]) -> Params:
    """FedAvg stage (Eq. 2); an empty round returns the global model."""
    if trained is None:
        return params
    return fedavg_masked(*trained)
