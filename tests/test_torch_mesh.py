"""The port's client mesh (``--mesh clients=K``) against the reference.

The reference's own sharded path cannot run on the installed JAX
(ROADMAP C1), so every parity test holds the port's K ranks against the
reference's single-device results, which the reference pins equal to its
sharded ones.  The ranks are spawned gloo processes on the CPU
(``launch/mesh.py::spawn_ranks``: one intra-op thread each, a ``file://``
store under ``tmp_path``, a deadline after which every rank is killed and
the test fails with the rank's traceback); they run the port's plain
versions and import neither JAX nor the reference.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import elect as ref_elect
from repro.core.fuzzy import FuzzyEvaluator
from repro.core.rules import build_rule_table as ref_rules
from repro.configs.mnist_cnn import CONFIG as REF_CNN
from repro.fl import network as ref_net
from repro.fl import pipeline as ref_pipeline
from repro.fl.mobility import MobilityConfig as RefMobility
from repro.fl.partition import PartitionConfig as RefPartition
from repro.fl.partition import shard_client_range as ref_shard_range
from repro.fl.rounds import FLSimConfig as RefSimConfig
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro.kernels.probe_fuzzy import probe_loss_pallas
from repro.launch.fl_sim import fast_config as ref_fast_config
from repro.launch.mesh import parse_mesh_spec as ref_parse_mesh
from repro.models.cnn import init_cnn as ref_init_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import elect
from repro_torch.core.rules import build_rule_table
from repro_torch.fl import pipeline
from repro_torch.fl.aggregation import fedavg_masked
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig, shard_client_range
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.kernels import ops
from repro_torch.launch import fl_sim
from repro_torch.launch.mesh import (mesh_clients, parse_mesh_spec,
                                     rank_calls, spawn_ranks)
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 240.0


def _spawn(tmp_path, fn, k, args, kwargs=None):
    return spawn_ranks(fn, k, "cpu", args=args, kwargs=kwargs, threads=1,
                       timeout=SPAWN_TIMEOUT, workdir=tmp_path)


# -- 1. host logic ----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_shard_ranges_buckets_and_capacity_match_reference(k):
    for n in (0, 1, 7, 30, 31, 512, 4096):
        for d in range(k):
            assert (list(shard_client_range(n, k, d))
                    == list(ref_shard_range(n, k, d)))
        assert pipeline.pad_to_shards(n, k) == ref_pipeline.pad_to_shards(
            n, k)
        assert elect.auto_capacity(max(n, 1), k) == \
            ref_elect.auto_capacity(max(n, 1), k)
    for c in range(1, 41):
        assert (pipeline.cohort_bucket_sharded(c, k)
                == ref_pipeline.cohort_bucket_sharded(c, k))
    for comm, road in ((200.0, 1000.0), (200.0, 4096.0), (250.0, 1000.0),
                       (0.5, 3.0), (1000.0, 1000.0)):
        assert (elect.ring_hops(comm, road, k)
                == ref_elect.ring_hops(comm, road, k))
    for bad in (-1, k):
        with pytest.raises(ValueError):
            shard_client_range(30, k, bad)
        with pytest.raises(ValueError):
            ref_shard_range(30, k, bad)


def test_shard_range_refuses_zero_shards_as_reference():
    for fn in (shard_client_range, ref_shard_range):
        with pytest.raises(ValueError, match="n_shards"):
            fn(30, 0, 0)


@pytest.mark.parametrize("spec", [
    "clients=4", "clients=1", " clients = 8", "clients=4,model=2",
    "clients=+3", "clients=-1", "clients", "=4", "clients=x", "clients=",
    "clients=4,"])
def test_parse_mesh_spec_matches_reference(spec):
    try:
        want = ref_parse_mesh(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_mesh_spec(spec)
        return
    assert parse_mesh_spec(spec) == want


def test_mesh_spec_refuses_other_axes_and_empty_meshes():
    assert mesh_clients(None) == 1 and mesh_clients("clients=4") == 4
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh_clients("clients=4,model=2")
    with pytest.raises(ValueError, match="at least 1"):
        mesh_clients("clients=0")


# -- 2. the probe regions -----------------------------------------------------

def _cfgs(n=10, seed=0, **kw):
    """The reference's 10-client parity profile (tests/test_probe_fuzzy.py)
    in both packages, for a fleet of ``n``."""
    kw = dict(dict(scheme="dcs", n_rounds=2, local_epochs=1,
                   samples_per_class=260, probe_samples=64, seed=seed), **kw)
    part = dict(n_clients=n, big_clients=3, big_quantity=120,
                small_quantity=40, classes_per_client=9, seed=seed)
    mob = dict(n_vehicles=n, seed=seed)
    return (RefSimConfig(partition=RefPartition(**part),
                         mobility=RefMobility(**mob), **kw),
            FLSimConfig(partition=PartitionConfig(**part),
                        mobility=MobilityConfig(**mob), **kw))


@pytest.mark.parametrize("fused", [True, False])
def test_probe_regions_are_the_references(fused):
    """Rank d's region under K = 1, 2, 4 is rows [d * L, (d + 1) * L) of
    the reference's pack built for K shards: images, labels and seg
    bit-equal."""
    rcfg, cfg = _cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(fused_probe=fused,
                                               overlap_rounds=False))
    port = FLSimulation(cfg, run=RunConfig(fused_probe=fused), device="cpu")
    for k in (1, 2, 4):
        ref.n_shards = k
        ref._build_packed_probe()
        want = [np.asarray(a) for a in (ref._probe_images,
                                        ref._probe_labels, ref._probe_seg)]
        length = want[0].shape[0] // k
        for d in range(k):
            for g, w in zip(port.probe_region(k, d), want):
                np.testing.assert_array_equal(
                    g.numpy(), w[d * length:(d + 1) * length],
                    err_msg=f"K={k} rank {d}")


# -- 3. the kernels' plain versions ----------------------------------------

def _probe_fixture(counts, seed):
    rng = np.random.default_rng(seed)
    n = len(counts)
    seg = np.repeat(np.arange(n), counts).astype(np.int32)
    seg[::7] = n                                  # overflow-lane rows
    s = seg.shape[0]
    return dict(
        params=jax.device_get(ref_init_cnn(jax.random.PRNGKey(seed),
                                           REF_CNN)),
        images=rng.normal(size=(s, 28, 28, 1)).astype(np.float32),
        labels=rng.integers(0, 10, s).astype(np.int32), seg=seg,
        counts=np.bincount(seg, minlength=n + 1)[:n].astype(np.int32), n=n)


@pytest.mark.parametrize("counts,seed", [((24, 7, 40, 13, 1, 30), 0),
                                         ((5, 0, 66, 3), 1)])
def test_probe_loss_plain_matches_reference(counts, seed):
    """(N,) Eq. 7 means to 1e-5 relative against ``probe_loss_pallas``
    (interpret mode) and the reference's oracle: fp32 convolutions summed
    in another order by oneDNN and XLA.  A client with no row gets 0."""
    fx = _probe_fixture(counts, seed)
    j = lambda a: jnp.asarray(fx[a])
    want_pallas = probe_loss_pallas(fx["params"], j("images"), j("labels"),
                                    j("seg"), j("counts"),
                                    n_clients=fx["n"], interpret=True)
    want_oracle = ref_kref.probe_loss_ref(fx["params"], j("images"),
                                          j("labels"), j("seg"),
                                          j("counts"), fx["n"])
    t = lambda a: torch.tensor(fx[a])
    got = ops.probe_loss(params_from_jax(fx["params"]), t("images"),
                         t("labels"), t("seg"), t("counts"),
                         n_clients=fx["n"])
    assert got.shape == (fx["n"],) and got.dtype == torch.float32
    for want in (want_pallas, want_oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert (got.numpy()[np.asarray(counts) == 0] == 0).all()


def test_fuzzy_eval_col_maxima_matches_reference():
    """External Eq. 8 maxima: evaluations to 1e-4 on [0, 100] against the
    reference's ``fuzzy_eval(..., col_maxima=...)`` (the Pallas kernel
    multiplies by a reciprocal where the plain version divides); with the
    batch's own maxima, bit-equal to ``normalize=True``."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(0, 1, (200, 4))
         * np.array([4500, 3e6, 1.0, 2.5])).astype(np.float32)
    ev = FuzzyEvaluator()
    mam = [np.asarray(a, np.float32) for a in (ev.cfg.means, ev.cfg.sigmas,
                                               ev.level_centers)]
    table, levels = ref_rules()
    t = [torch.tensor(a) for a in mam]
    for cm in (x.max(axis=0) * 1.3, x.max(axis=0) * 0.7):
        for impl in ("pallas", "jnp"):
            want = ref_ops.fuzzy_eval(
                jnp.asarray(x), *(jnp.asarray(a) for a in mam[:2]), table,
                levels, jnp.asarray(mam[2]), impl=impl, normalize=True,
                col_maxima=jnp.asarray(cm.astype(np.float32)))
            got = ops.fuzzy_eval(torch.tensor(x), t[0], t[1],
                                 *build_rule_table(), t[2], normalize=True,
                                 col_maxima=torch.tensor(cm, dtype=torch
                                                         .float32))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4)
    own = ops.fuzzy_eval(torch.tensor(x), t[0], t[1], *build_rule_table(),
                         t[2], normalize=True,
                         col_maxima=torch.tensor(x.max(axis=0)))
    same = ops.fuzzy_eval(torch.tensor(x), t[0], t[1], *build_rule_table(),
                          t[2], normalize=True)
    assert torch.equal(own, same)


# -- 4. the sharded elections ----------------------------------------------

COMM, E_TAU = 200.0, 30.0


def _fleet(n, seed, kind):
    """Positions on a road of n metres (1 vehicle a metre) with exactly
    tied evaluations: uniform; ``bucket``: the first quarter of the
    client ids crowded into the first 150 m (one source rank overflows
    its bucket slots for segment 0); ``strip``: a crowd of 120 vehicles
    of every rank within 150 m below the first segment boundary."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, n, n).astype(np.float32)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    ev[5:60] = 50.0                                  # ties
    ev[60:70] = E_TAU                                # at the threshold
    if kind == "bucket":
        pos[: n // 4] = rng.uniform(0, 150, n // 4)
    elif kind == "strip":
        crowd = rng.choice(n, 120, replace=False)
        pos[crowd] = rng.uniform(n / 4 - 150, n / 4, 120)
    return pos, ev


def _shards(k, *arrays):
    """Each rank's (shard_n,) slices of the global vectors, padded with
    invalid slots, plus the global ids and validity."""
    n = arrays[0].shape[0]
    shard_n = -(-n // k)
    gid = np.arange(k * shard_n, dtype=np.int32)
    cols = [np.pad(a, (0, k * shard_n - n)) for a in arrays]
    cols += [gid, gid < n]
    return shard_n, [[c[r * shard_n:(r + 1) * shard_n] for c in cols]
                     for r in range(k)]


def _halo_call(k, pos, ev, window, capacity=0):
    n = pos.shape[0]
    shard_n, per = _shards(k, pos, ev)
    return (elect.ring_halo_elect, per, dict(
        n=n, n_shards=k, shard_n=shard_n, comm_range=COMM, top_m=2,
        e_tau=E_TAU, road_length=float(n), window=window,
        capacity=capacity or elect.auto_capacity(shard_n, k)))


def _topk_call(k, ev, k_top):
    shard_n, per = _shards(k, ev)
    per = [[r[0], r[1], r[2]] for r in per]          # evals, gid, valid
    return (elect.sharded_topk_mask, per,
            dict(n=ev.shape[0], shard_n=shard_n, k_top=k_top))


ELECT_CASES = [  # (name, fleet size, kind, window, capacity; 0 = auto,
                 #  -1 = every slot of the rank)
    ("uniform", 1024, "uniform", 616, 0),
    ("uniform-narrow", 2048, "uniform", 300, 0),
    ("bucket", 1024, "bucket", 616, 160),
    ("bucket-roomy", 1024, "bucket", 616, -1),
    ("strip", 512, "strip", 16, 0),
    ("strip-wide", 512, "strip", 512, 0),
]
TOPK_CASES = [(512, 5), (1000, 37)]
TIE = 99.5


def _tied_evals(n, k_top):
    """Evaluations below ``TIE`` but for 2 * k_top ids spread over every
    rank, tied at ``TIE``: the top-k is decided by the tie-break alone."""
    ev = np.random.default_rng(k_top).uniform(0, 99, n).astype(np.float32)
    ev[np.linspace(0, n - 1, 2 * k_top).astype(int)] = TIE
    return ev


@pytest.fixture(scope="module")
def elections(tmp_path_factory):
    """Every election case on K = 2 and 4 gloo ranks, one spawn per K."""
    out = {}
    for k in (2, 4):
        calls, want = [], []
        for name, n, kind, window, cap in ELECT_CASES:
            pos, ev = _fleet(n, 11, kind)
            cap = -(-n // k) if cap < 0 else cap     # roomy: every slot
            calls.append(_halo_call(k, pos, ev, window, cap))
            want.append((name, pos, ev))
        for n, k_top in TOPK_CASES:
            ev = _tied_evals(n, k_top)
            calls.append(_topk_call(k, ev, k_top))
            want.append((f"topk{k_top}", None, ev))
        res = _spawn(tmp_path_factory.mktemp(f"elect{k}"), rank_calls, k,
                     (calls,))
        for j, (name, pos, ev) in enumerate(want):
            n = ev.shape[0]
            mask = np.concatenate([r[f"c{j}_out0"] for r in res])[:n]
            flags = [int(r[f"c{j}_out1"]) for r in res] \
                if pos is not None else None
            out[k, name] = (pos, ev, mask, flags)
    return out


def _dense(pos, ev):
    return np.asarray(ref_kref.neighbor_elect_ref(
        jnp.asarray(pos), jnp.asarray(ev), comm_range=COMM, top_m=2,
        e_tau=E_TAU))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name,flagged", [
    ("uniform", False), ("uniform-narrow", False), ("bucket", True),
    ("bucket-roomy", False), ("strip", True), ("strip-wide", False)])
def test_ring_halo_election_matches_dense_reference(elections, k, name,
                                                    flagged):
    """Wherever the all-reduced flag is 0 the masks equal the reference's
    dense election bit for bit, tied evaluations included.  A crowd of
    one rank's clients in one segment overflows the bucket slots (and
    fits with every slot), a crowd at a segment edge overflows a 16-wide
    strip (and fits a wide one)."""
    pos, ev, mask, flags = elections[k, name]
    assert max(flags) == int(flagged), flags
    if not flagged:
        np.testing.assert_array_equal(mask, _dense(pos, ev))
        assert mask.sum() > 0


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n,k_top", TOPK_CASES)
def test_sharded_topk_matches_reference_topk(elections, k, n, k_top):
    """The hierarchical top-k equals ``lax.top_k`` of the whole (N,)
    vector, ties to the lower index included."""
    _, ev, mask, _ = elections[k, f"topk{k_top}"]
    _, idx = jax.lax.top_k(jnp.asarray(ev), k_top)
    want = np.zeros(n, np.int32)
    want[np.asarray(idx)] = 1
    np.testing.assert_array_equal(mask, want)
    tied = np.flatnonzero(ev == TIE)
    np.testing.assert_array_equal(np.flatnonzero(mask), tied[:k_top])


# -- 5, 6. the sharded prefix, trainer and FedAvg ----------------------------

def reference_fields(sim, rnd, perms=True):
    """Round ``rnd``'s draws exactly as the reference makes them inside
    its prefix and trainer (as in tests/test_torch_round.py); without
    ``perms``, seeded numpy permutations stand in for the training
    draws."""
    n, cfg = sim.n, sim.cfg
    k_sel = jax.random.fold_in(sim.key, rnd)
    k_pred, k_upload = jax.random.split(jax.random.fold_in(sim.net_key, rnd))
    caps = [sim.groups[sim._slot[i, 0]].cap for i in range(n)]
    if perms:
        keys = sim._round_keys(rnd)
        plist = []
        for i in range(n):
            ek = jax.random.split(keys[i], cfg.local_epochs)
            plist.append(torch.tensor(np.stack(
                [np.asarray(jax.random.permutation(ek[e], caps[i]))
                 for e in range(cfg.local_epochs)])).long())
    else:
        rng = np.random.default_rng(rnd)
        plist = [torch.tensor(np.stack([rng.permutation(c) for _ in range(
            cfg.local_epochs)])) for c in caps]
    k = min(cfg.n_clients_central, n)
    t = lambda a: torch.tensor(np.asarray(a))
    return pipeline.RoundFields(
        channel_shadow=t(ref_net.pinned_channel_shadow(n)),
        loss_u=t(ref_net.cwnd_loss_fields(k_pred, n)),
        upload_shadow=t(jax.random.normal(k_upload, (n,))),
        random_idx=t(jax.random.choice(k_sel, n, (k,), replace=False)),
        perms=plist)


def _eval_margin(evals, e_tau):
    e = np.sort(np.asarray(evals, np.float64))
    gaps = np.diff(e)
    return float(min(np.abs(e - e_tau).min(),
                     gaps.min() if gaps.size else np.inf))


def _fast_cfgs():
    """The CLI's fast profile (30 vehicles) in both packages."""
    return (ref_fast_config("dcs", n_rounds=1),
            fl_sim.fast_config("dcs", n_rounds=1))


def _fleet512_cfgs():
    """512 vehicles on the 1 km road, 8 probe samples each: auto elects
    windowed, and K = 4 segments of 250 m give one halo hop."""
    return _cfgs(n=512, probe_samples=8, samples_per_class=2600)


def params_to_flat(ref_params):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(ref_params)).items()}


def _ref_prefix(ref, scheme):
    cfg = dataclasses.replace(ref.stage_cfg, scheme=scheme)
    return jax.device_get(ref_pipeline.selection_prefix(
        ref.statics, ref.params, jnp.int32(0), ref.key, ref.net_key,
        cfg=cfg))


@pytest.fixture(scope="module")
def fast_mesh(tmp_path_factory):
    """The fast profile's round 0 on 2 ranks (the gather seam), from the
    reference's params on its draws; the reference's single-device
    prefix and round, and the port's single-device ones."""
    rcfg, cfg = _fast_cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
    fields = reference_fields(ref, 0)
    want = _ref_prefix(ref, "dcs")
    res = _spawn(tmp_path_factory.mktemp("fast"), fl_sim.sim_rank, 2,
                 (cfg, RunConfig(mesh="clients=2"), 1),
                 dict(fields={0: fields}, params=params_to_flat(ref.params)))
    got = {key: np.concatenate([r[f"{key}0"] for r in res])[:ref.n]
           for key in ("pos", "feats", "evals")}
    got["mask"] = res[0]["mask0"]
    single = FLSimulation(cfg, run=RunConfig(), device="cpu",
                          fields=lambda r: fields)
    single.params = params_from_jax(jax.device_get(ref.params))
    single_row = single.run_round(0)
    ref_row = ref.run_round(0)
    return dict(ref=ref, res=res, single=single, single_row=single_row,
                ref_row=ref_row, prefix=dict(
                    want=want, got=got, fields=fields, stage=single.stage_cfg,
                    flags=[r["overflow0"] for r in res],
                    masks=[r["mask0"] for r in res]))


SCHEMES = ("dcs", "ccs-fuzzy", "random")


@pytest.fixture(scope="module")
def fleet512_mesh(tmp_path_factory):
    """512 vehicles' round-0 prefix of each scheme on 4 ranks, from the
    reference's params on its draws.  ``elect="auto"`` is windowed from
    512 vehicles on, so DCS runs the ring-halo election, ccs-fuzzy the
    hierarchical top-k and random its draw sliced per rank.  Each rank
    holds its region of the probe pack, as ``FLSimulation`` on a rank
    builds it."""
    rcfg, cfg = _fleet512_cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
    fields = reference_fields(ref, 0, perms=False)
    port = FLSimulation(cfg, run=RunConfig(), device="cpu")
    params = params_from_jax(jax.device_get(ref.params))
    per = [[dataclasses.replace(port.statics, **dict(zip(
        ("probe_images", "probe_labels", "probe_seg"),
        port.probe_region(4, d)))), params, 0, fields] for d in range(4)]
    stages = {sc: dataclasses.replace(port.stage_cfg, scheme=sc)
              for sc in SCHEMES}
    res = _spawn(tmp_path_factory.mktemp("f512"), rank_calls, 4, ([
        (pipeline.selection_prefix_sharded, per, dict(cfg=stages[sc]))
        for sc in SCHEMES],))
    out = {}
    for i, sc in enumerate(SCHEMES):
        got = {key: np.concatenate([r[f"c{i}_{key}"] for r in res])[:ref.n]
               for key in ("pos", "feats", "evals", "mask")}
        out[sc] = dict(want=_ref_prefix(ref, sc), got=got, fields=fields,
                       stage=stages[sc],
                       flags=[int(r[f"c{i}_elect_overflow"]) for r in res],
                       masks=[got["mask"]])
    return out


PREFIX_CASES = ["fast-dcs"] + [f"512-{sc}" for sc in SCHEMES]


def _prefix_case(request, case):
    if case == "fast-dcs":
        return request.getfixturevalue("fast_mesh")["prefix"]
    return request.getfixturevalue("fleet512_mesh")[case[len("512-"):]]


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_sharded_prefix_matches_reference_single_device(request, case):
    """The ranks' shards, concatenated: positions to 1e-3, features to
    1e-4 relative, evaluations to 1e-3 on [0, 100] (the single-device
    parity test's tolerances); the masks equal the reference's, or the
    smallest eval margin is reported (ROADMAP C3); no rank flags
    overflow."""
    m = _prefix_case(request, case)
    got, want = m["got"], m["want"]
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["feats"], want["feats"], rtol=1e-4)
    np.testing.assert_allclose(got["evals"], want["evals"], rtol=0,
                               atol=1e-3)
    assert max(m["flags"]) == 0, m["flags"]
    margin = _eval_margin(want["evals"], m["stage"].e_tau)
    for mask in m["masks"]:
        np.testing.assert_array_equal(
            mask, want["mask"],
            err_msg=f"masks differ; smallest eval margin {margin}")
    assert want["mask"].sum() > 0


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_sharded_masks_are_the_single_device_election(request, case):
    """Fed the evaluations and positions the ranks computed, the port's
    single-device election gives the ranks' mask bit for bit (the gather
    seam at K = 2; the ring halo, the hierarchical top-k and the sliced
    draw at K = 4)."""
    m = _prefix_case(request, case)
    stage = dataclasses.replace(m["stage"], elect="gather")
    mask = pipeline.select(stage, torch.tensor(m["got"]["pos"]),
                           torch.tensor(m["got"]["evals"]), m["fields"])
    np.testing.assert_array_equal(m["got"]["mask"], mask.numpy())


def test_fleet512_runs_the_sharded_elections(fleet512_mesh):
    cfg = fleet512_mesh["dcs"]["stage"]
    assert cfg.elect == "windowed"
    assert 2 * elect.ring_hops(cfg.comm_range_m, cfg.road_length_m, 4) \
        + 1 <= 4


def test_sharded_round_trains_as_single_device(fast_mesh):
    """Round 0's FedAvg on 2 ranks (each trains its slice of every
    group's cohort, the sums all-reduced) against the port's
    single-device ``train_groups`` + ``aggregate`` and the reference's
    round, on the reference's permutations: params within 1e-5 (the
    weighted sums add in another order); the rows' counts equal."""
    res, single = fast_mesh["res"], fast_mesh["single"]
    mine = {k[len("param."):]: v for k, v in res[0].items()
            if k.startswith("param.")}
    for r in res[1:]:
        for key, v in mine.items():
            np.testing.assert_array_equal(r[f"param.{key}"], v)
    theirs = jax.device_get(fast_mesh["ref"].params)
    ported = params_to_numpy({k: torch.tensor(v) for k, v in mine.items()})
    single_np = params_to_numpy(single.params)
    for name in ported:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(ported[name][leaf],
                                       single_np[name][leaf], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(ported[name][leaf],
                                       np.asarray(theirs[name][leaf]),
                                       rtol=0, atol=1e-5)
    row = res[0]["rows"][0]
    for want in (fast_mesh["single_row"], fast_mesh["ref_row"]):
        for key in ("n_selected", "n_aggregated", "n_straggler"):
            assert row[key] == want[key], (key, row, want)


def test_fedavg_masked_over_ranks_matches_one_rank(tmp_path):
    """``fedavg_masked(..., mesh)`` over 2 ranks, each holding half of the
    stacked models, equals the unsharded average to 1e-6."""
    rng = np.random.default_rng(4)
    stacked = {"a": rng.normal(size=(6, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(6,)).astype(np.float32)}
    w = np.array([3, 0, 1, 2, 5, 0], np.float32)
    per = [[{k: torch.tensor(v[r * 3:(r + 1) * 3])
             for k, v in stacked.items()}, w[r * 3:(r + 1) * 3]]
           for r in range(2)]
    res = _spawn(tmp_path, rank_calls, 2, ([(fedavg_masked, per, {})],))
    want = fedavg_masked({k: torch.tensor(v) for k, v in stacked.items()},
                         torch.tensor(w))
    for r in res:
        for key in ("a", "b"):
            np.testing.assert_allclose(r[f"c0_{key}"], want[key].numpy(),
                                       rtol=0, atol=1e-6)


# -- 7. the CLI ----------------------------------------------------------------

def _cli(*extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_sim", "--scheme",
         "dcs", "--rounds", "1", "--device", "cpu", *extra],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_cli_mesh_matches_single_device_cli():
    """``--mesh clients=2`` on the CPU: its banner names gloo, and its
    row has the single-device CLI's counts; ``mean_eval_selected`` within
    1e-5 relative and accuracy within 1e-4 (on the CPU the plain probe
    sums each client's losses through a one-hot product whose order
    depends on the pack, so the last bits of LF may move)."""
    mesh_out = _cli("--mesh", "clients=2")
    single_out = _cli()
    assert "backend gloo" in mesh_out and "2 ranks on the CPU" in mesh_out
    rows = [[json.loads(line) for line in out.splitlines()
             if line.startswith("{")] for out in (mesh_out, single_out)]
    assert len(rows[0]) == len(rows[1]) == 1
    got, want = rows[0][0], rows[1][0]
    for key in ("round", "n_selected", "n_aggregated", "n_straggler",
                "n_active"):
        assert got[key] == want[key], (key, got, want)
    assert got["mean_eval_selected"] == pytest.approx(
        want["mean_eval_selected"], rel=1e-5)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-4
    assert mesh_out.count("[fl_sim] rank ") == 2


@pytest.mark.parametrize("argv,err,match", [
    (["--mesh", "clients=3", "--multihost", "2"], ValueError,
     "must divide evenly over --multihost 2 processes"),
    (["--mesh", "clients=2,model=2"], ValueError, "unknown mesh axes"),
    (["--mesh", "clients"], ValueError, "axis=N"),
])
def test_cli_refuses_multihost_and_unknown_axes(argv, err, match):
    with pytest.raises(err, match=match):
        fl_sim.main(["--device", "cpu", "--rounds", "1", *argv])


def test_sim_refuses_a_mesh_spec_without_ranks():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="spawn_ranks"):
        FLSimulation(cfg, run=RunConfig(mesh="clients=2"), device="cpu")


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """A rank that raises kills the others and surfaces its traceback; no
    worker is taken down."""
    with pytest.raises(RuntimeError, match="(?s)rank 0 .*TypeError"):
        _spawn(tmp_path, rank_calls, 2, ([(elect.ring_halo_elect,
                                           [[], []], {})],))
