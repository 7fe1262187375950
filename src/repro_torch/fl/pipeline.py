"""Staged round pipeline (paper Alg. 1 steps 1-7 as data flow).

    positions(statics, cfg, t)                      -> (N,) road positions
    aux_features(statics, cfg, pos, fields)         -> raw (N, 3) SQ, TA, CC
    evaluate(statics, feats_raw)                    -> (N,) fuzzy evals
    select(cfg, pos, evals, fields)                 -> (N,) int32 mask
    deadline_filter(statics, cfg, pos, mask, shadow) -> (survivors, n_straggler)
    train_groups(...) / aggregate(...)              -> new global params

``selection_prefix`` runs probe -> evaluate -> select -> deadline with
every output left on the device: nothing crosses to the host between
stages, and nothing in it waits for the card (its draws are staged
through pinned memory), so a round driver can enqueue round r+1's
prefix while round r still trains.  The survivors cross once, at the
cohort gather in ``train_groups``, which gathers each cohort on the
device from stacks uploaded once (``device_groups``).  With
``churn_rate > 0`` (the event-driven server) departed clients'
evaluations are 0 before the election and their mask bits after it,
and the prefix also reports each client's upload-completion instant
``t_done`` and presence ``alive_at_done`` there; at 0 the prefix runs
exactly the churn-free ops.  On a CUDA device the prefix runs the
hand-written kernels (``kernels/ops.py``): the fused probe -> Eq. 8 ->
Mamdani kernel (``fused_probe=True``) or the standalone Mamdani kernel behind the
plain-PyTorch probe (``fused_probe=False``), and for ``dcs`` the dense
election (``elect="gather"``) or the windowed counts
(``elect="windowed"``), whose ``elect_overflow`` flag sends the round
back through the dense election (``FLSimulation.finish_round``).

Every random draw of a round enters as a ``RoundFields`` tensor, so a
round is deterministic in ``(statics, params, rnd, fields)``.

``selection_prefix_seeds`` runs the prefix for S seeds at once, as the
reference's ``vmap`` over seeds does (the multi-seed sweep,
``launch/sweep.py``): ``stack_statics`` and ``stack_fields`` give the
statics and draws a leading seed axis, the elementwise stages run once
on (S, N) tensors, and the fused probe and the dense election launch
once for all seeds.  ``selection_prefix`` is its one-seed case, so each
seed's outputs are those of ``selection_prefix`` on that seed alone.

The ``*_sharded`` stages are one rank's body on the client mesh
(``launch/mesh.py``): the rank owns ``shard_n = ceil(N / K)`` clients,
padded with invalid dummies to a multiple of K, and only a few steps are
global, each an explicit collective:

- the Eq. 7 losses: each rank probes its own region of the probe pack
  (``probe_loss``) and an all-reduce sums the (N,) lanes; a client's
  rows live in one region only, so the others add exact zeros;
- the Eq. 8 column maxima: an all-reduce with max (exact);
- the election: the ring-halo election or the hierarchical top-k
  (``select_sharded``), or the gather seam: all-gather the (N,) evals
  and positions and run ``select`` on every rank;
- the counts of the round and the FedAvg sums: all-reduces.

Every rank draws the round's global ``RoundFields`` and slices its own
clients, so K ranks see the draws of one device.
``selection_prefix_seeds_sharded`` is the sweep's form (S seeds' fleets
sharded over the same ranks: one ``probe_loss`` and one ``fuzzy_eval``
launch, one all-reduce of the (S, N) losses and one of the (S, 4)
maxima), and ``selection_prefix_sharded`` its one-seed case; with
``churn_rate > 0`` they gate evaluation and selection and report
``t_done`` / ``alive_at_done`` as the single-device prefix does.
``train_groups_sharded(weight_scale=)`` folds the event server's
staleness factor into a landing tick's cohort weights.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rules import build_rule_table
from repro_torch.core.selection import selection_stats
from repro_torch.device import to_device
from repro_torch.fl.aggregation import (fedavg_finish, fedavg_masked,
                                        fedavg_sums)
from repro_torch.fl.client import dataset_loss_packed, local_train_batch
from repro_torch.fl.mobility import coverage_active
from repro_torch.fl.mobility import positions as mobility_positions
from repro_torch.fl.network import (NetworkConfig,
                                    predicted_throughput_from_fields,
                                    upload_time_s_from_shadow)
from repro_torch.fl.partition import ClientGroup
from repro_torch.fl.schemes import ShardCtx, get_scheme
from repro_torch.fl.timing import (TimingConfig, completes_before_deadline,
                                   training_time_s)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import ClientMesh, all_gather, pmax, psum

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
    elect_capacity: int           # rank -> segment bucket slots (0 = auto)
    # coverage-window churn (the event-driven server): clients past
    # (1 - rate) * road_length are departed; 0.0 runs the churn-free ops
    churn_rate: float = 0.0


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
    return torch.stack([st.n_valid, ta, 1.0 / st.slowdown], dim=-1).float()


def evaluate(st: RoundStatics, feats_raw: torch.Tensor) -> torch.Tensor:
    """Fuzzy evaluation stage (paper §5): raw (N, 4) -> (N,) on [0, 100],
    Eq. 8 inside the kernel (``normalize=True``); (seeds, N, 4) ->
    (seeds, N) in one launch, Eq. 8 over each seed's own clients."""
    table, levels = _rules()
    return kops.fuzzy_eval(feats_raw, st.means, st.sigmas, table, levels,
                           st.level_centers, normalize=True)


def select(cfg: StageConfig, pos: torch.Tensor, evals: torch.Tensor,
           fields: RoundFields) -> torch.Tensor:
    """Selection stage (Alg. 1 step 4) through the scheme registry:
    (..., N) -> int32 mask (..., N), leading axes (seeds) broadcast."""
    return get_scheme(cfg.scheme).select(cfg, pos, evals, fields)


def completion_time_s(st: RoundStatics, cfg: StageConfig, pos: torch.Tensor,
                      upload_shadow: torch.Tensor,
                      t_s: torch.Tensor) -> torch.Tensor:
    """Each client's absolute upload-completion instant (..., N): ``t_s
    + train_t + upload_t`` in fp32, in the reference's order, from the
    shadow ``deadline_filter`` reads, so ``t_done <= t_s + deadline``
    exactly when the client survives Eq. 6."""
    train_t = training_time_s(cfg.timing, st.slowdown, st.n_valid)
    upload_t = upload_time_s_from_shadow(cfg.network, pos, cfg.model_bytes,
                                         upload_shadow.to(pos.device))
    return t_s + train_t + upload_t


def deadline_filter(st: RoundStatics, cfg: StageConfig, pos: torch.Tensor,
                    mask: torch.Tensor, upload_shadow: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 6 straggler stage: ``(survivors (..., N) bool, n_straggler
    (...))``; leading axes (seeds) broadcast."""
    train_t = training_time_s(cfg.timing, st.slowdown, st.n_valid)
    upload_t = upload_time_s_from_shadow(cfg.network, pos, cfg.model_bytes,
                                         upload_shadow.to(pos.device))
    ok = completes_before_deadline(cfg.timing, train_t, upload_t)
    selected = mask > 0
    return selected & ok, (selected & ~ok).sum(dim=-1)


# the fuzzy membership parameters: one set for every seed of a group
# (they follow the StageConfig's e_tau), kept unstacked
_SHARED_STATICS = ("means", "sigmas", "level_centers")


def stack_statics(statics: Sequence[RoundStatics]) -> RoundStatics:
    """Per-seed statics as one ``RoundStatics`` with a leading seed axis
    on every tensor but the fuzzy membership parameters, which stay the
    first seed's.  Raises ``ValueError`` when the seeds' shapes (the
    probe pack's rows among them) or membership parameters differ: the
    sweep then runs those seeds one by one."""
    first = statics[0]
    for other in statics[1:]:
        for f in dataclasses.fields(RoundStatics):
            a, b = getattr(first, f.name), getattr(other, f.name)
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"seeds differ in {f.name}: "
                                 f"{tuple(a.shape)} vs {tuple(b.shape)}")
            if f.name in _SHARED_STATICS and not torch.equal(a, b):
                raise ValueError(f"seeds differ in {f.name}")
    return RoundStatics(**{
        f.name: (getattr(first, f.name) if f.name in _SHARED_STATICS
                 else torch.stack([getattr(st, f.name) for st in statics]))
        for f in dataclasses.fields(RoundStatics)})


_PREFIX_FIELDS = ("channel_shadow", "loss_u", "upload_shadow", "random_idx")


def stack_fields(fields: Sequence[RoundFields]) -> RoundFields:
    """The seeds' draws of one round stacked for the prefix; ``perms``
    stay with each seed's ``RoundFields``, which its training reads."""
    return RoundFields(*(torch.stack([getattr(f, name) for f in fields])
                         for name in _PREFIX_FIELDS))


def seed_fields(fields: RoundFields, i: int) -> RoundFields:
    """Seed ``i``'s draws out of ``stack_fields``' result."""
    return RoundFields(*(getattr(fields, name)[i]
                         for name in _PREFIX_FIELDS))


def selection_prefix_seeds(st: RoundStatics, params: Params, rnd: int,
                           fields: RoundFields, *,
                           cfg: StageConfig) -> Dict[str, torch.Tensor]:
    """Probe -> evaluate -> select -> deadline for S seeds of one
    ``StageConfig`` at once: ``st`` from ``stack_statics``, ``params``
    stacked (S, ...) weights, ``fields`` from ``stack_fields``.  Returns
    the prefix's outputs with a leading seed axis, the event server's
    ``t_done``, ``alive_at_done`` and ``n_active`` among them; seed i's
    slice is bit-equal to ``selection_prefix`` on seed i's statics,
    params and draws.

    Mobility, the Reno predictor, the aux features, the scheme's
    ``select`` and the Eq. 6 deadline run once on (S, N) tensors; the
    fused probe (or the unfused probe's Mamdani kernel) and the dense
    election launch once for all seeds.  Per seed: the unfused probe,
    the windowed election (each seed raises its own overflow flag) and
    the mean-evaluation statistic (a float sum, kept in one seed's
    order).
    The reference's ``selection_prefix_seeds_donated`` lets XLA reuse
    the stacked params' buffer; PyTorch frees it when the caller drops
    it, so it has no counterpart here."""
    dev = st.x0.device
    n_seeds = st.x0.shape[0]
    # a fill, not an upload: nothing here waits for the card
    t_s = torch.full((), float(rnd), dtype=torch.float32,
                     device=dev) * cfg.timing.deadline_s
    fields = RoundFields(*(to_device(getattr(fields, name), dev)
                           for name in _PREFIX_FIELDS))
    table, levels = _rules()
    churn = cfg.churn_rate > 0.0
    with torch.no_grad():
        pos = positions(st, cfg, t_s)
        aux = aux_features(st, cfg, pos, fields)
        if cfg.fused_probe:
            feats, evals = kops.probe_fuzzy(
                params, st.probe_images, st.probe_labels, st.probe_seg,
                st.probe_counts, aux, st.means, st.sigmas, table, levels,
                st.level_centers, n_clients=cfg.n_clients)
        else:
            feats = []
            for i in range(n_seeds):
                # copies: a seed's slice of a stacked bias can start off
                # a 16-byte boundary, and cuBLAS picks kernels by it
                lf = dataset_loss_packed(
                    {k: v[i].clone() for k, v in params.items()},
                    st.probe_images[i], st.probe_labels[i],
                    st.probe_seg[i], st.probe_counts[i],
                    n_clients=cfg.n_clients)
                feats.append(torch.cat([aux[i], lf[:, None]], dim=1))
            feats = torch.stack(feats)
            evals = evaluate(st, feats)       # one launch, Eq. 8 a seed
        if churn:                  # departed clients report no evaluation
            active = coverage_active(pos, road_length_m=cfg.road_length_m,
                                     churn_rate=cfg.churn_rate)
            evals = torch.where(active, evals, torch.zeros_like(evals))
        scheme = get_scheme(cfg.scheme)
        if cfg.elect == "windowed" and scheme.select_windowed is not None:
            mask, elect_overflow = (torch.stack(t) for t in zip(*(
                scheme.select_windowed(cfg, pos[i], evals[i],
                                       seed_fields(fields, i))
                for i in range(n_seeds))))
        else:
            mask = select(cfg, pos, evals, fields)
            elect_overflow = torch.zeros(n_seeds, dtype=torch.int32,
                                         device=dev)
        if churn:                  # ... and are never selected
            mask = torch.where(active, mask, torch.zeros_like(mask))
        survivors, n_straggler = deadline_filter(st, cfg, pos, mask,
                                                 fields.upload_shadow)
        # the event server's inputs: each client's upload instant, and
        # whether it is still covered then (else its update is lost)
        t_done = completion_time_s(st, cfg, pos, fields.upload_shadow, t_s)
        if churn:
            alive_at_done = coverage_active(
                positions(st, cfg, t_done), road_length_m=cfg.road_length_m,
                churn_rate=cfg.churn_rate)
            n_active = active.sum(dim=-1)
        else:
            alive_at_done = torch.ones_like(survivors)
            n_active = torch.full((n_seeds,), cfg.n_clients,
                                  dtype=torch.int64, device=dev)
        stats = [selection_stats(mask[i], evals[i]) for i in range(n_seeds)]
    return {"pos": pos, "feats": feats, "evals": evals, "mask": mask,
            "survivors": survivors, "n_straggler": n_straggler,
            "t_done": t_done, "alive_at_done": alive_at_done,
            "n_active": n_active,
            "n_selected": torch.stack([x["n_selected"] for x in stats]),
            "n_survivor": survivors.sum(dim=-1),
            "mean_eval_selected": torch.stack(
                [x["mean_eval_selected"] for x in stats]),
            "elect_overflow": elect_overflow}


def selection_prefix(st: RoundStatics, params: Params, rnd: int,
                     fields: RoundFields, *,
                     cfg: StageConfig) -> Dict[str, torch.Tensor]:
    """Probe -> evaluate -> select -> deadline for round ``rnd``; every
    output stays on the statics' device.  ``selection_prefix_seeds`` of
    one seed: the statics, params and draws enter as views with a seed
    axis of 1, and the outputs leave without it."""
    one = RoundStatics(**{
        f.name: getattr(st, f.name) if f.name in _SHARED_STATICS
        else getattr(st, f.name).unsqueeze(0)
        for f in dataclasses.fields(RoundStatics)})
    out = selection_prefix_seeds(
        one, {k: v.unsqueeze(0) for k, v in params.items()}, rnd,
        RoundFields(*(getattr(fields, name).unsqueeze(0)
                      for name in _PREFIX_FIELDS)), cfg=cfg)
    return {k: v[0] for k, v in out.items()}


def cohort_bucket(k: int) -> int:
    """Cohort tensor size for k survivors: next multiple of 2, min 2 (the
    reference's fixed-shape buckets; padding rows train at weight 0)."""
    return max(2, k + (k % 2))


def device_groups(groups: Sequence[ClientGroup],
                  device) -> Tuple[ClientGroup, ...]:
    """The capacity groups with their image and label stacks on
    ``device``, uploaded once (shared with the numpy arrays on the CPU),
    so a round's cohort gather is an index on the device, not an upload
    of the cohort.  ``client_ids`` and ``n_valid`` stay host arrays."""
    dev = torch.device(device)
    return tuple(dataclasses.replace(
        g, images=torch.as_tensor(g.images, device=dev),
        labels=torch.as_tensor(g.labels, device=dev)) for g in groups)


def _cohort(g: ClientGroup, idx: np.ndarray,
            perms: Callable[[int], torch.Tensor], dev: torch.device
            ) -> Tuple[torch.Tensor, ...]:
    """One group's cohort rows ``idx`` for ``local_train_batch``:
    images, labels, n_valid and the (epochs, C, cap) permutations on
    ``dev``, gathered there from ``device_groups``' stacks; the small
    host arrays cross through pinned memory, so nothing waits."""
    rows = to_device(torch.from_numpy(idx), dev)
    return (g.images.index_select(0, rows), g.labels.index_select(0, rows),
            to_device(torch.from_numpy(g.n_valid[idx]), dev),
            to_device(torch.stack([torch.as_tensor(perms(int(i)))
                                   for i in g.client_ids[idx]], 1), dev))


def train_groups(params: Params, groups: Sequence[ClientGroup],
                 group_steps: Sequence[int], survivors: np.ndarray,
                 perms: Callable[[int], torch.Tensor], *, epochs: int,
                 batch_size: int, lr: float, prox_mu: float = 0.0,
                 return_entries: bool = False) -> Optional[Tuple]:
    """Local-training stage (Eq. 1): one ``local_train_batch`` per
    capacity group over that group's surviving cohort.

    ``groups`` come from ``device_groups``; ``survivors`` is the round's
    host-side mask (the one crossing); ``perms(i)`` gives client i's
    (epochs, cap) sample orders.  Returns ``(stacked models, weights)``
    with padding duplicates at weight zero, or ``None`` for an empty
    round.  ``return_entries=True`` (the event server's pool) returns
    ``(stacked models, weights (np), client ids (np))`` instead: each
    row's global client id, padding rows repeating the cohort head's.
    Only enqueues work: nothing here waits for the card."""
    if not survivors.any():
        return None
    dev = next(iter(params.values())).device
    stacks, weights, row_ids = [], [], []
    for gi, g in enumerate(groups):
        cohort = np.where(survivors[g.client_ids])[0]       # group-local
        k = len(cohort)
        if k == 0:
            continue                         # empty cohort: skip group
        idx = np.concatenate([cohort,
                              np.full(cohort_bucket(k) - k, cohort[0])])
        stacked, _ = local_train_batch(
            params, *_cohort(g, idx, perms, dev), epochs=epochs,
            batch_size=batch_size, steps_per_epoch=group_steps[gi], lr=lr,
            prox_mu=prox_mu)
        w = g.n_valid[idx].astype(np.float32)
        w[k:] = 0.0                          # padding duplicates drop out
        stacks.append(stacked)
        weights.append(w)
        row_ids.append(g.client_ids[idx])
    merged = {k: torch.cat([s[k] for s in stacks]) for k in stacks[0]}
    if return_entries:
        return merged, np.concatenate(weights), np.concatenate(row_ids)
    return merged, to_device(torch.from_numpy(np.concatenate(weights)), dev)


def aggregate(params: Params,
              trained: Optional[Tuple[Params, torch.Tensor]]) -> Params:
    """FedAvg stage (Eq. 2); an empty round returns the global model."""
    if trained is None:
        return params
    return fedavg_masked(*trained)


# -- the client mesh: one rank's body ---------------------------------------

def mesh_client_shards(mesh: Optional[ClientMesh]) -> int:
    """The client-axis partition factor of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh.size


def pad_to_shards(n: int, shards: int) -> int:
    """Client count padded up to a multiple of the shards (masked dummy
    clients, never a silent replicate)."""
    return -(-n // shards) * shards


def _gather_clients(mesh: ClientMesh, x: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """The ranks' (S, shard_n) shards as the global (S, N), in one
    all-gather (``jax.lax.all_gather(..., tiled=True)`` on the client
    axis)."""
    return all_gather(mesh, x.t().contiguous()).t()[:, :n].contiguous()


def selection_prefix_seeds_sharded(st: RoundStatics, params: Params,
                                   rnd: int, fields: RoundFields, *,
                                   cfg: StageConfig, mesh: ClientMesh
                                   ) -> Dict[str, torch.Tensor]:
    """``selection_prefix_seeds`` on one rank of the client mesh: S
    seeds' prefixes, every seed's client axis sharded over the same
    ranks (the reference's ``selection_prefix_seeds_sharded``).

    ``st`` holds the S seeds' global (S, N) statics and this rank's
    region of each seed's probe pack (``stack_statics`` of the seeds'
    ``FLSimulation``s built on the rank), ``params`` the stacked (S,
    ...) weights, ``fields`` the seeds' global draws (``stack_fields``).
    A round makes one ``probe_loss`` launch, one all-reduce of the (S,
    N) loss lanes, one all-reduce with max of the (S, 4) Eq. 8 maxima,
    one ``fuzzy_eval`` launch, then the election: through the gather
    seam (the (S, N) evals and positions all-gathered, ``select`` on
    every rank, the dense election one launch for all seeds) or, under
    ``elect="windowed"``, the scheme's sharded form per seed.  Returns
    the rank's (S, shard_n) shards of ``pos``, ``feats``, ``evals``,
    ``mask``, ``survivors``, ``t_done`` and ``alive_at_done`` (padding
    slots last) and the all-reduced (S,) ``n_selected``,
    ``n_straggler``, ``n_survivor``, ``n_active``,
    ``mean_eval_selected`` and ``elect_overflow``; each seed's outputs
    are those of ``selection_prefix_sharded`` on that seed alone.

    With ``churn_rate > 0`` (the event-driven server) departed clients
    report no evaluation and are never selected, and ``t_done`` /
    ``alive_at_done`` give each client's upload instant and its
    presence then; at 0 the prefix runs exactly the churn-free ops."""
    k, i = mesh.size, mesh.rank
    n = cfg.n_clients
    shard_n = pad_to_shards(n, k) // k
    dev = st.x0.device
    n_seeds = st.x0.shape[0]
    gid = i * shard_n + torch.arange(shard_n, device=dev)
    valid = gid < n                          # False on dummy pad clients
    ctx = ShardCtx(mesh=mesh, n=n, n_shards=k, shard_n=shard_n,
                   pad=k * shard_n - n, gid=gid, valid=valid)
    mine = ctx.mine
    churn = cfg.churn_rate > 0.0

    t_s = torch.tensor(float(rnd), dtype=torch.float32,
                       device=dev) * cfg.timing.deadline_s
    fields = RoundFields(*(to_device(getattr(fields, name), dev)
                           for name in _PREFIX_FIELDS))
    slowdown, n_valid = mine(st.slowdown, 1.0), mine(st.n_valid)
    x0, speeds, phase = mine(st.x0), mine(st.speeds), mine(st.jitter_phase)
    with torch.no_grad():
        pos = mobility_positions(x0, speeds, phase, t_s,
                                 road_length_m=cfg.road_length_m,
                                 speed_jitter=cfg.speed_jitter)
        ta = predicted_throughput_from_fields(
            cfg.network, pos, mine(fields.channel_shadow),
            mine(fields.loss_u))
        # Eq. 7 over this rank's regions, every seed in one launch; the
        # all-reduce adds exact zeros from the ranks that do not own a
        # client
        if cfg.fused_probe:
            lf_part = kops.probe_loss(params, st.probe_images,
                                      st.probe_labels, st.probe_seg,
                                      st.probe_counts, n_clients=n)
        else:
            lf_part = torch.stack([dataset_loss_packed(
                {key: v[s].clone() for key, v in params.items()},
                st.probe_images[s], st.probe_labels[s], st.probe_seg[s],
                st.probe_counts[s], n_clients=n) for s in range(n_seeds)])
        lf = mine(psum(mesh, lf_part))
        feats = torch.stack([n_valid, ta, 1.0 / slowdown, lf],
                            dim=-1).float()

        # Eq. 8 against each seed's fleet maxima, all-reduced with max
        col_max = pmax(mesh, torch.where(
            valid[:, None], feats, torch.full_like(feats, -math.inf)
        ).max(dim=-2).values)
        table, levels = _rules()
        evals = kops.fuzzy_eval(feats, st.means, st.sigmas, table, levels,
                                st.level_centers, normalize=True,
                                col_maxima=col_max)
        evals = torch.where(valid, evals, torch.zeros_like(evals))
        if churn:                  # departed clients report no evaluation
            active = coverage_active(pos, road_length_m=cfg.road_length_m,
                                     churn_rate=cfg.churn_rate)
            evals = torch.where(active, evals, torch.zeros_like(evals))

        # selection: the scheme's sharded form under elect="windowed",
        # else the gather seam (also the fallback of an overflowed round)
        scheme = get_scheme(cfg.scheme)
        sharded = None
        if cfg.elect == "windowed" and scheme.select_sharded is not None:
            sharded = [scheme.select_sharded(cfg, ctx, pos[s], evals[s],
                                             seed_fields(fields, s))
                       for s in range(n_seeds)]
            if any(res is None for res in sharded):
                sharded = None
        if sharded is not None:
            mask = torch.stack([m for m, _ in sharded])
            mask = torch.where(valid, mask, torch.zeros_like(mask))
            if churn:
                mask = torch.where(active, mask, torch.zeros_like(mask))
            elect_overflow = pmax(mesh, torch.stack(
                [o for _, o in sharded]).to(torch.int32))
            n_sel = psum(mesh, mask.sum(dim=-1))
            ev_sel = psum(mesh, torch.stack([(evals[s] * mask[s]).sum()
                                             for s in range(n_seeds)]))
            mean_ev_sel = torch.where(
                n_sel > 0, ev_sel / torch.clamp(n_sel, min=1),
                torch.zeros((), device=dev))
        else:
            ev_g = _gather_clients(mesh, evals, n)
            pos_g = _gather_clients(mesh, pos, n)
            mask_g = select(cfg, pos_g, ev_g, fields)
            if churn:
                act_g = _gather_clients(mesh, active.to(torch.int32), n) > 0
                mask_g = torch.where(act_g, mask_g, torch.zeros_like(mask_g))
            mask = mine(mask_g)
            elect_overflow = torch.zeros(n_seeds, dtype=torch.int32,
                                         device=dev)
            stats = [selection_stats(mask_g[s], ev_g[s])
                     for s in range(n_seeds)]
            n_sel = torch.stack([x["n_selected"] for x in stats])
            mean_ev_sel = torch.stack([x["mean_eval_selected"]
                                       for x in stats])

        # Eq. 6 deadline, on this rank's clients
        train_t = training_time_s(cfg.timing, slowdown, n_valid)
        upload_t = upload_time_s_from_shadow(
            cfg.network, pos, cfg.model_bytes, mine(fields.upload_shadow))
        ok = completes_before_deadline(cfg.timing, train_t, upload_t)
        selected = mask > 0
        survivors = selected & ok & valid
        n_straggler, n_survivor = psum(mesh, torch.stack([
            (selected & ~ok & valid).sum(dim=-1), survivors.sum(dim=-1)]))
        # the event server's inputs, on this rank's clients
        t_done = t_s + train_t + upload_t
        if churn:
            alive_at_done = coverage_active(
                mobility_positions(x0, speeds, phase, t_done,
                                   road_length_m=cfg.road_length_m,
                                   speed_jitter=cfg.speed_jitter),
                road_length_m=cfg.road_length_m, churn_rate=cfg.churn_rate)
            n_active = psum(mesh, (active & valid).sum(dim=-1))
        else:
            alive_at_done = torch.ones_like(survivors)
            n_active = torch.full((n_seeds,), n, dtype=torch.int64,
                                  device=dev)
    return {"pos": pos, "feats": feats, "evals": evals, "mask": mask,
            "survivors": survivors, "n_straggler": n_straggler,
            "t_done": t_done, "alive_at_done": alive_at_done,
            "n_active": n_active, "n_selected": n_sel,
            "n_survivor": n_survivor, "mean_eval_selected": mean_ev_sel,
            "elect_overflow": elect_overflow}


def selection_prefix_sharded(st: RoundStatics, params: Params, rnd: int,
                             fields: RoundFields, *, cfg: StageConfig,
                             mesh: ClientMesh) -> Dict[str, torch.Tensor]:
    """``selection_prefix`` on one rank of the client mesh:
    ``selection_prefix_seeds_sharded`` of one seed.

    ``st`` holds the global (N,) statics and this rank's probe region
    (``FLSimulation`` builds it on a rank); ``fields`` the round's
    global draws.  Returns the rank's (shard_n,) shard of ``pos``,
    ``feats``, ``evals``, ``mask``, ``survivors``, ``t_done`` and
    ``alive_at_done`` (padding slots last), and the all-reduced
    ``n_selected``, ``n_straggler``, ``n_survivor``, ``n_active``,
    ``mean_eval_selected`` and ``elect_overflow``.  With the same draws
    the masks are ``selection_prefix``'s."""
    one = RoundStatics(**{
        f.name: getattr(st, f.name) if f.name in _SHARED_STATICS
        else getattr(st, f.name).unsqueeze(0)
        for f in dataclasses.fields(RoundStatics)})
    out = selection_prefix_seeds_sharded(
        one, {key: v.unsqueeze(0) for key, v in params.items()}, rnd,
        RoundFields(*(getattr(fields, name).unsqueeze(0)
                      for name in _PREFIX_FIELDS)), cfg=cfg, mesh=mesh)
    return {key: v[0] for key, v in out.items()}


def cohort_bucket_sharded(k: int, shards: int) -> int:
    """``cohort_bucket`` rounded up to a multiple of the shards, so every
    rank trains an equal slice of a group's cohort (padding duplicates
    at weight zero, as in the unsharded bucket)."""
    return pad_to_shards(cohort_bucket(k), shards)


def train_group_cohort_sharded(params: Params, group: ClientGroup,
                               steps_per_epoch: int, idx: np.ndarray,
                               weights: np.ndarray,
                               perms: Callable[[int], torch.Tensor],
                               mesh: ClientMesh, *, epochs: int,
                               batch_size: int, lr: float,
                               prox_mu: float = 0.0
                               ) -> Tuple[Params, torch.Tensor]:
    """One capacity group's cohort ``idx`` (group-local rows, a multiple
    of the shards long; ``group`` from ``device_groups``) on the mesh:
    this rank trains its equal slice and the weighted model sum finishes
    with an all-reduce (``fedavg_sums``).  Returns ``(sum_i w_i model_i, sum_i w_i)``."""
    per = len(idx) // mesh.size
    part = slice(mesh.rank * per, (mesh.rank + 1) * per)
    dev = next(iter(params.values())).device
    stacked, _ = local_train_batch(
        params, *_cohort(group, idx[part], perms, dev), epochs=epochs,
        batch_size=batch_size, steps_per_epoch=steps_per_epoch, lr=lr,
        prox_mu=prox_mu)
    return fedavg_sums(stacked,
                       to_device(torch.from_numpy(weights[part]), dev), mesh)


def train_groups_sharded(params: Params, groups: Sequence[ClientGroup],
                         group_steps: Sequence[int], survivors: np.ndarray,
                         perms: Callable[[int], torch.Tensor],
                         mesh: ClientMesh, *, epochs: int, batch_size: int,
                         lr: float, prox_mu: float = 0.0,
                         weight_scale: float = 1.0
                         ) -> Optional[Tuple[Params, torch.Tensor]]:
    """``train_groups`` on the client mesh: per capacity group, each rank
    trains its slice of the surviving cohort; the Eq. 2 numerator and
    denominator add across ranks (all-reduce in ``fedavg_sums``) and
    across groups.  ``survivors`` is the round's global (N,) mask, the
    same on every rank.  Returns ``(sum_i w_i model_i, sum_i w_i)``, or
    None for an empty round.

    ``weight_scale`` multiplies every cohort weight (in fp32): the
    event-driven server's staleness factor for one landing tick, whose
    updates share one delay.  At 1.0 the weights are untouched."""
    if not survivors.any():
        return None
    num_tot, den_tot = None, None
    for gi, g in enumerate(groups):
        cohort = np.where(survivors[g.client_ids])[0]       # group-local
        k = len(cohort)
        if k == 0:
            continue                         # empty cohort: skip group
        bucket = cohort_bucket_sharded(k, mesh.size)
        idx = np.concatenate([cohort, np.full(bucket - k, cohort[0])])
        w = g.n_valid[idx].astype(np.float32)
        if weight_scale != 1.0:
            w *= np.float32(weight_scale)
        w[k:] = 0.0                          # padding duplicates drop out
        num, den = train_group_cohort_sharded(
            params, g, group_steps[gi], idx, w, perms, mesh, epochs=epochs,
            batch_size=batch_size, lr=lr, prox_mu=prox_mu)
        if num_tot is None:
            num_tot, den_tot = num, den
        else:
            num_tot = {key: num_tot[key] + num[key] for key in num}
            den_tot = den_tot + den
    return num_tot, den_tot


def aggregate_sharded(params: Params,
                      trained: Optional[Tuple[Params, torch.Tensor]]
                      ) -> Params:
    """Finish Eq. 2 from the sharded trainer's all-reduced sums; an empty
    round returns the global model unchanged."""
    if trained is None:
        return params
    return fedavg_finish(*trained, params)
