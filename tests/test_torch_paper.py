"""The paper's experiment in the port against the JAX reference: the §4.2
communication accounting (``core/overhead.py``, the rows' comm columns),
the rows' schema, FedProx, the loop engine, ``uniform_capacity``,
``paper_config`` / ``--paper-profile`` and ``--out``.

Host float arithmetic (the overhead models, the comm columns) is held
with ``==``; trained parameters to the tolerance written at each test.
The round-level cases reuse ``test_torch_round.py``'s harness: both
packages from the same parameters, the port fed the reference's draws.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ioutil as ref_ioutil
from repro.core import overhead as ref_oh
from repro.fl import client as ref_client
from repro.fl.rounds import FLSimConfig as RefSimConfig
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.launch import fl_sim as ref_fl_sim
from repro_torch import ioutil
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import overhead as oh
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl import client
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.fl.schemes import get_scheme
from repro_torch.launch import fl_sim
from repro_torch.launch.mesh import spawn_ranks
from test_torch_round import (_cfgs, _check_round, _pair, _ref_init,
                              reference_fields)
from torch_threads import torch_intra_op_threads  # noqa: F401

SCHEMES = ("dcs", "ccs-fuzzy", "random")
ROW_KEYS = ("round", "accuracy", "n_selected", "n_aggregated",
            "n_straggler", "n_active", "stale_frac", "n_effective",
            "rounds_behind_hist", "mean_eval_selected", "state_bytes",
            "upload_bytes", "state_time_s", "comm_time_s")
ASYNC_COMM = ("stale_frac", "n_effective", "rounds_behind_hist",
              "state_bytes", "upload_bytes", "state_time_s", "comm_time_s")
INTERVALS = np.array([0.05, 0.1, 0.5, 1.0, 2.5, 7.0, 15.0, 52.0, 100.0])


# -- core/overhead.py: every function, == the reference's -----------------

def test_overhead_defaults_match_reference():
    assert oh.DUPLEX_FACTOR == ref_oh.DUPLEX_FACTOR
    for mine, theirs in ((oh.GBoardParams, ref_oh.GBoardParams),
                         (oh.IoVParams, ref_oh.IoVParams)):
        assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("n,state_bytes,period", [
    (1_500_000, 100.0, 72.0), (30, 30.0, 20.0), (4096, 100.0, 60.0),
    (3_090_000, 30.0, 20.0)])
def test_state_and_crossing_match_reference(n, state_bytes, period):
    for tau in INTERVALS:
        assert (oh.state_maintenance_bytes(n, state_bytes, period, tau)
                == ref_oh.state_maintenance_bytes(n, state_bytes, period,
                                                  tau))
        assert (oh.state_maintenance_bytes(n, state_bytes, period, tau,
                                           duplex=1.0)
                == ref_oh.state_maintenance_bytes(n, state_bytes, period,
                                                  tau, duplex=1.0))
    for clients in (0, 1, 5, 300, 1000):
        assert (oh.model_upload_bytes(clients, 5.2e6)
                == ref_oh.model_upload_bytes(clients, 5.2e6))
    for clients in (1, 5, 300):
        assert (oh.crossing_interval_s(n, state_bytes, period, clients,
                                       1.4e6)
                == ref_oh.crossing_interval_s(n, state_bytes, period,
                                              clients, 1.4e6))


def test_fig2_and_fig9_curves_match_reference():
    for p, rp in ((oh.GBoardParams(), ref_oh.GBoardParams()),
                  (oh.GBoardParams(n_participants=30, clients_per_round=6),
                   ref_oh.GBoardParams(n_participants=30,
                                       clients_per_round=6))):
        got, want = oh.fig2_curves(INTERVALS, p), ref_oh.fig2_curves(
            INTERVALS, rp)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = oh.fig9_curves(INTERVALS), ref_oh.fig9_curves(INTERVALS)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("key", ["ccs", "ccs-fuzzy", "cfl", "dcs",
                                 "model-only"])
def test_accumulated_time_matches_reference(key):
    for kw in ({}, dict(n_participants=30, clients_per_round=6,
                        round_period_s=20.0),
               dict(n_participants=4096, clients_per_round=0,
                    uplink_bps_best=1.0e6, latency_cloud_s=0.3)):
        p, rp = oh.IoVParams(**kw), ref_oh.IoVParams(**kw)
        for tau in INTERVALS:
            assert (oh.accumulated_time_s(key, float(tau), p)
                    == ref_oh.accumulated_time_s(key, float(tau), rp))


def test_accumulated_time_refuses_unknown_keys_as_reference():
    for fn in (oh.accumulated_time_s, ref_oh.accumulated_time_s):
        with pytest.raises(ValueError):
            fn("fedavg", 1.0)


# -- the rows' comm columns and schema ----------------------------------------

def _ref_row_keys():
    """The reference's row keys in order, from its own ``_round_row`` on a
    stand-in simulation (no dataset, no round)."""
    sim = types.SimpleNamespace(n=30, cfg=RefSimConfig())
    sim._comm_accounting = lambda k: RefSimulation._comm_accounting(sim, k)
    host = {"n_selected": 5, "survivors": np.ones(30, bool),
            "n_straggler": 0, "mean_eval_selected": 50.0}
    return tuple(RefSimulation._round_row(sim, 0, host, 7, 10))


def test_row_keys_are_the_references():
    assert _ref_row_keys() == ROW_KEYS


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n,deadline_s,interval_s", [
    (30, 60.0, 1.0), (30, 20.0, 0.5), (4096, 20.0, 5.0), (10, 7.5, 0.1)])
def test_comm_accounting_matches_reference(scheme, n, deadline_s,
                                           interval_s):
    """``_comm_accounting`` against the reference's, with ``==``, over
    every cohort size of the fleet: same fields, same order of
    operations, Python floats."""
    kw = dict(scheme=scheme, deadline_s=deadline_s,
              state_interval_s=interval_s, state_bytes=120.0,
              eval_bytes=25.0)
    mine = types.SimpleNamespace(n=n, cfg=FLSimConfig(**kw))
    theirs = types.SimpleNamespace(n=n, cfg=RefSimConfig(**kw))
    assert get_scheme(scheme).overhead_key == {
        "dcs": "dcs", "ccs-fuzzy": "ccs-fuzzy", "random": "cfl"}[scheme]
    for k in range(0, n + 1, max(1, n // 16)):
        got = FLSimulation._comm_accounting(mine, k)
        want = RefSimulation._comm_accounting(theirs, k)
        assert got == want
        assert [type(v) for v in got.values()] == [float] * 4


_SCHEME_PAIRS = {}


def _scheme_pair(scheme):
    """``test_torch_round.py``'s fused pair for ``dcs``; the same
    construction for the other schemes."""
    if scheme == "dcs":
        return _pair(True)
    if scheme not in _SCHEME_PAIRS:
        rcfg, cfg = _cfgs(scheme=scheme)
        ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
        port = FLSimulation(cfg, device="cpu",
                            fields=lambda r: reference_fields(ref, r))
        _SCHEME_PAIRS[scheme] = (ref, port)
    return _SCHEME_PAIRS[scheme]


def _reset(ref, port):
    ref.params = jax.tree.map(jnp.asarray, _ref_init(0))
    port.params = params_from_jax(_ref_init(0))


def _check_row(want, got):
    """The row's keys in the reference's order, its async and comm
    columns equal (``==``) and of the reference's Python types, and the
    whole row serialisable."""
    assert tuple(got) == tuple(want) == ROW_KEYS
    for k in ASYNC_COMM:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ROW_KEYS:
        assert type(got[k]) is type(want[k]), k
    json.dumps(got)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_round_rows_match_reference(scheme):
    """Two rounds per scheme on the reference's draws (``_check_round``),
    then the row's schema and its async and comm columns."""
    ref, port = _scheme_pair(scheme)
    _reset(ref, port)
    for rnd in (0, 1):
        _check_row(*_check_round(ref, port, rnd))


# -- FedProx -----------------------------------------------------------------

def _cohort(seed=5, c=3, cap=40, epochs=2):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(c, cap, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (c, cap)).astype(np.int32)
    n_valid = np.array([40, 23, 7], np.int32)[:c]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i)
                    )(jnp.arange(c))
    ek = jax.vmap(lambda k: jax.random.split(k, epochs))(keys)
    perms = torch.tensor(np.stack([
        np.stack([np.asarray(jax.random.permutation(ek[i, e], cap))
                  for i in range(c)]) for e in range(epochs)])).long()
    return images, labels, n_valid, keys, perms


def test_local_train_batch_prox_matches_reference():
    """FedProx at mu = 0.01: two epochs from shared params on the
    reference's permutations, params within 1e-4 relative and 1e-5
    absolute (``test_local_train_batch_matches_reference``'s tolerance:
    fp32 gradients summed in another order)."""
    images, labels, n_valid, keys, perms = _cohort()
    ref_params = _ref_init(2)
    kw = dict(epochs=2, batch_size=20, steps_per_epoch=2, lr=0.05,
              prox_mu=0.01)
    want, want_loss = ref_client.local_train_batch(
        ref_params, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(n_valid), keys, **kw)
    got, loss = client.local_train_batch(
        params_from_jax(ref_params), torch.tensor(images),
        torch.tensor(labels), torch.tensor(n_valid), perms, **kw)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4)
    want = jax.device_get(want)
    for i in range(len(n_valid)):
        mine = params_to_numpy({k: v[i] for k, v in got.items()})
        for name in mine:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    mine[name][leaf], want[name][leaf][i], rtol=1e-4,
                    atol=1e-5, err_msg=f"client {i} {name}.{leaf}")


def test_prox_mu_zero_is_the_plain_path_bit_for_bit():
    images, labels, n_valid, _, perms = _cohort()
    params = params_from_jax(_ref_init(2))
    args = (params, torch.tensor(images), torch.tensor(labels),
            torch.tensor(n_valid), perms)
    kw = dict(epochs=2, batch_size=20, steps_per_epoch=2, lr=0.05)
    plain, plain_loss = client.local_train_batch(*args, **kw)
    zero, zero_loss = client.local_train_batch(*args, prox_mu=0.0, **kw)
    prox, _ = client.local_train_batch(*args, prox_mu=0.01, **kw)
    assert torch.equal(plain_loss, zero_loss)
    for k in plain:
        assert torch.equal(plain[k], zero[k]), k
    assert any(not torch.equal(plain[k], prox[k]) for k in plain)


def test_fedprox_pulls_towards_global():
    """With a large prox_mu the local update stays nearer the global
    model than with mu = 0 (the reference's test, on the port's
    ``local_train``); the port's FedProx client against the reference's
    ``local_train`` on its permutations, within 1e-4 relative and 1e-5
    absolute."""
    images, labels = make_dataset(20, seed=5)
    images, labels = images[:100], labels[:100]
    g_ref = _ref_init(0)
    g = params_from_jax(g_ref)
    key = jax.random.PRNGKey(1)
    perms = torch.tensor(np.stack([
        np.asarray(jax.random.permutation(k, 100))
        for k in jax.random.split(key, 2)])).long()
    kw = dict(epochs=2, batch_size=20, steps_per_epoch=5, lr=0.1)
    args = (torch.tensor(images), torch.tensor(labels), torch.tensor(100))

    def dist(a):
        return float(sum(((a[k] - g[k]) ** 2).sum() for k in g))

    p_plain, _ = client.local_train(g, *args, perms, **kw)
    p_prox, _ = client.local_train(g, *args, perms, prox_mu=10.0, **kw)
    assert dist(p_prox) < dist(p_plain)
    want, _ = ref_client.local_train(
        g_ref, jnp.asarray(images), jnp.asarray(labels), jnp.int32(100),
        key, prox_mu=10.0, **kw)
    mine, want = params_to_numpy(p_prox), jax.device_get(want)
    for name in mine:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(mine[name][leaf], want[name][leaf],
                                       rtol=1e-4, atol=1e-5)


def test_fedprox_round_matches_reference():
    """A whole FedProx round (prox_mu = 0.01) on the reference's draws:
    ``_check_round``'s tolerances and the row's columns."""
    rcfg, cfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, prox_mu=0.01)
    cfg = dataclasses.replace(cfg, prox_mu=0.01)
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
    port = FLSimulation(cfg, device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    _reset(ref, port)
    _check_row(*_check_round(ref, port, 0))
    mine, theirs = params_to_numpy(port.params), jax.device_get(ref.params)
    for name in mine:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(mine[name][leaf],
                                       np.asarray(theirs[name][leaf]),
                                       rtol=0, atol=1e-5)


# -- the loop engine ---------------------------------------------------------

ENGINE_ROUNDS = 3


def _engine_cfg(scheme, **kw):
    """The reference's engine-parity profile (tests/test_engine_parity.py):
    10 clients in a 120- and a 40-sample capacity group."""
    kw.setdefault("partition", PartitionConfig(
        n_clients=10, big_clients=3, big_quantity=120, small_quantity=40,
        classes_per_client=9))
    kw.setdefault("mobility", MobilityConfig(n_vehicles=10, seed=0))
    return FLSimConfig(scheme=scheme, n_rounds=ENGINE_ROUNDS, local_epochs=1,
                       samples_per_class=260, probe_samples=64, seed=0, **kw)


def _max_gap(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def test_loop_engine_resolves_and_unknown_engines_raise():
    assert RunConfig(engine="loop").resolved().engine == "loop"
    with pytest.raises(ValueError, match="engine"):
        FLSimulation(_engine_cfg("dcs"), run=RunConfig(engine="other"),
                     device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_loop_engine_matches_batched(scheme):
    """Three rounds in both engines on the port's own draws: masks and
    integer columns equal, accuracy within 1e-5, the global params within
    1e-6 after every round (the list FedAvg sums in client order, the
    masked one in group order; one ulp at the CPU)."""
    sims = {e: FLSimulation(_engine_cfg(scheme), run=RunConfig(engine=e),
                            device="cpu") for e in ("loop", "batched")}
    for rnd in range(ENGINE_ROUNDS):
        loop, batched = (sims[e].run_round(rnd) for e in ("loop", "batched"))
        np.testing.assert_array_equal(sims["loop"].last_mask,
                                      sims["batched"].last_mask)
        for k in ("round", "n_selected", "n_aggregated", "n_straggler",
                  "n_active", "rounds_behind_hist"):
            assert loop[k] == batched[k], (rnd, k)
        for k in ASYNC_COMM:
            assert loop[k] == batched[k], (rnd, k)
        assert abs(loop["accuracy"] - batched["accuracy"]) <= 1e-5
        assert _max_gap(sims["loop"].params, sims["batched"].params) <= 1e-6


def test_loop_engine_matches_reference_loop():
    """The port's loop engine against the reference's loop engine on the
    reference's draws, two rounds (``_check_round``)."""
    rcfg, cfg = _cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(engine="loop",
                                               overlap_rounds=False))
    port = FLSimulation(cfg, run=RunConfig(engine="loop"), device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    _reset(ref, port)
    for rnd in (0, 1):
        _check_row(*_check_round(ref, port, rnd))


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_empty_round_is_noop_broadcast(engine):
    """Nobody clears E_tau: the global model stays bit for bit, and the
    row's columns are the reference's empty row's."""
    sim = FLSimulation(_engine_cfg("dcs", e_tau=1e9),
                       run=RunConfig(engine=engine), device="cpu")
    before = {k: v.clone() for k, v in sim.params.items()}
    row = sim.run_round(0)
    assert (row["n_selected"], row["n_aggregated"]) == (0, 0)
    assert row["mean_eval_selected"] == 0.0
    assert row["rounds_behind_hist"] == "0/0/0/0"
    for k in before:
        assert torch.equal(before[k], sim.params[k]), k
    theirs = types.SimpleNamespace(n=sim.n, cfg=RefSimConfig(
        scheme="dcs", e_tau=1e9))
    assert ({k: row[k] for k in ASYNC_COMM[3:]}
            == RefSimulation._comm_accounting(theirs, 0))


def test_partial_group_cohort_parity():
    """A cohort confined to the 40-sample group trains the same in both
    engines (the batched engine skips the other group's empty cohort):
    params within 1e-6."""
    sims = {e: FLSimulation(_engine_cfg("dcs"), run=RunConfig(engine=e),
                            device="cpu") for e in ("loop", "batched")}
    survivors = np.zeros(10, bool)
    survivors[[4, 7]] = True
    assert {g.cap for g in sims["loop"].groups
            if survivors[g.client_ids].any()} == {40}
    fields = sims["loop"].round_fields(0)
    perms = lambda i: fields.perms[i]
    sims["loop"]._train_loop(survivors, perms)
    sims["batched"]._train_batched(survivors, perms)
    assert _max_gap(sims["loop"].params, sims["batched"].params) <= 1e-6


def test_loop_engine_on_the_mesh_trains_every_survivor_on_every_rank(
        tmp_path):
    """``engine="loop"`` on 2 gloo ranks of the client mesh, as the
    reference's on its mesh: the sharded prefix, then every rank trains
    every survivor.  The ranks' rows and params are equal; masks, integer
    and comm columns equal one device's loop round, params within 1e-6
    and accuracy within 1e-5 of it."""
    cfg = _engine_cfg("dcs")
    ranks = spawn_ranks(fl_sim.sim_rank, 2, "cpu", args=(
        cfg, RunConfig(engine="loop", mesh="clients=2"), 1), threads=1,
        timeout=240.0, workdir=tmp_path)
    one = FLSimulation(cfg, run=RunConfig(engine="loop"), device="cpu")
    want = one.run_round(0)
    (r0, r1), names = ranks, [k for k in ranks[0] if k.startswith("param.")]
    assert r0["rows"] == r1["rows"]
    assert all(np.array_equal(r0[k], r1[k]) for k in names)
    got = r0["rows"][0]
    assert got["n_aggregated"] > 0
    np.testing.assert_array_equal(r0["mask0"], one.last_mask)
    for k in ("n_selected", "n_aggregated", "n_straggler", "n_active",
              *ASYNC_COMM):
        assert got[k] == want[k], k
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-5
    for k in names:
        np.testing.assert_allclose(r0[k], one.params[k[6:]].numpy(),
                                   rtol=0, atol=1e-6)


# -- uniform_capacity ---------------------------------------------------------

def test_uniform_capacity_matches_reference():
    """``uniform_capacity=True``: one group at the largest cap, the
    reference's group, and a round whose row matches the reference's
    on its draws."""
    rcfg, cfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, uniform_capacity=True)
    cfg = dataclasses.replace(cfg, uniform_capacity=True)
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
    port = FLSimulation(cfg, device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    assert len(port.groups) == 1
    (g,), (rg,) = port.groups, ref.groups
    assert (g.cap, g.size) == (port.cap, port.n) == (rg.cap, rg.size)
    np.testing.assert_array_equal(g.client_ids, rg.client_ids)
    np.testing.assert_array_equal(g.n_valid, rg.n_valid)
    np.testing.assert_array_equal(g.images, np.asarray(rg.images))
    _reset(ref, port)
    _check_row(*_check_round(ref, port, 0))


# -- paper_config, --paper-profile, --out -------------------------------------

DEPRECATED = {"engine", "fused_probe", "overlap_rounds"}


def _same_config(mine, theirs):
    """Every field of the port's ``FLSimConfig`` equals the reference's
    (nested configs field by field); the reference has only its
    deprecated execution aliases beside them."""
    got, want = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert set(want) - set(got) == DEPRECATED
    assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_paper_config_matches_reference(scheme):
    _same_config(fl_sim.paper_config(scheme),
                 ref_fl_sim.paper_config(scheme))
    _same_config(fl_sim.paper_config(scheme, seed=3),
                 ref_fl_sim.paper_config(scheme, seed=3))


def _configs_of(monkeypatch, argv):
    """The ``(FLSimConfig, RunConfig)`` pairs both CLIs build for
    ``argv``, with the simulation stubbed out (no dataset, no round)."""
    seen = {"port": [], "ref": []}

    class Stub:
        device = "cpu"

        def __init__(self, cfg, run, **kw):
            seen[self.who].append((cfg, run))

        def run(self, n):
            return [{"accuracy": 0.0, "n_selected": 0}] * n

    def drive(sim, n, **kw):
        return {"rows": sim.run(n), "launches": {}, "prefix_s": [0.0] * n,
                "round_s": [0.0] * n}

    monkeypatch.setattr(fl_sim, "FLSimulation",
                        type("PortStub", (Stub,), {"who": "port"}))
    monkeypatch.setattr(fl_sim, "drive_rounds", drive)
    import repro.fl.rounds
    monkeypatch.setattr(repro.fl.rounds, "FLSimulation",
                        type("RefStub", (Stub,), {"who": "ref"}))
    assert fl_sim.main(argv + ["--device", "cpu"]) == 0
    assert ref_fl_sim.main(argv + ["--jit-cache-dir", "none"]) == 0
    return seen["port"], seen["ref"]


@pytest.mark.parametrize("flags", [
    [], ["--fused-probe"], ["--compat-aligned-pack"],
    ["--fused-probe", "--compat-aligned-pack"]])
@pytest.mark.parametrize("paper", [True, False])
def test_paper_profile_flags_match_reference(monkeypatch, paper, flags):
    """``--paper-profile`` drops ``--classes-per-client`` and keeps the
    config's 50 rounds, as the reference's CLI does; without it both
    take them.  Mobility is replaced after the config is built.
    ``--fused-probe`` changes nothing; ``--compat-aligned-pack`` turns
    the fused probe off, with or without it."""
    argv = ["--scheme", "all", "--rounds", "2", "--classes-per-client",
            "3", "--distribution", "extreme", "--seed", "4", *flags]
    mine, theirs = _configs_of(monkeypatch,
                               argv + (["--paper-profile"] if paper else []))
    assert len(mine) == len(theirs) == 3
    for (m, m_run), (t, t_run) in zip(mine, theirs):
        _same_config(m, t)
        assert m.partition.classes_per_client == (9 if paper else 3)
        assert m.n_rounds == (50 if paper else 2)
        assert (m.mobility.distribution, m.mobility.seed) == ("extreme", 4)
        assert (m_run.fused_probe == t_run.fused_probe
                == ("--compat-aligned-pack" not in flags))


def test_cli_out_writes_the_rows(tmp_path):
    """``--out`` at the fast profile: ``{"dcs": [row]}`` with the
    reference's keys in order, written atomically (no ``*.tmp-*`` file
    left), and the same bytes ``repro.ioutil`` writes for the object."""
    out = tmp_path / "fl.json"
    assert fl_sim.main(["--scheme", "dcs", "--device", "cpu", "--rounds",
                        "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert list(got) == ["dcs"] and len(got["dcs"]) == 1
    assert tuple(got["dcs"][0]) == _ref_row_keys()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fl.json"]
    ref_ioutil.write_atomic_json(tmp_path / "ref.json", got, indent=1)
    assert out.read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_write_atomic_keeps_the_old_file_on_failure(tmp_path):
    path = tmp_path / "x.json"
    ioutil.write_atomic_json(path, {"a": 1})
    with pytest.raises(TypeError):
        ioutil.write_atomic(path, 12345)            # neither str nor bytes
    assert json.loads(path.read_text()) == {"a": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["x.json"]
    ioutil.write_atomic(tmp_path / "sub" / "y.bin", b"\x00\x01", sync=False)
    assert (tmp_path / "sub" / "y.bin").read_bytes() == b"\x00\x01"
