"""The port's event-driven server and round-ahead schedule against the
JAX reference's, on the CPU.

Sizes are ``tests/test_async.py``'s: 10 clients, 1 local epoch, 3
rounds.  Both packages start from the same weights and the port is fed
the reference's draws (``test_torch_round.reference_fields``).
Tolerances: integer columns, histograms, masks and landing ticks
equal; accuracy within 0.01 (four of the 390 test images) and the mean
evaluation within 1e-3, as ``test_torch_round._check_round``;
``n_effective`` within 1e-9 (host floats of the same counts); params
within ``test_local_train_batch_matches_reference``'s rtol 1e-4, atol
1e-5; prefix floats within the prefix tests' tolerances.  Port against
port (the schedules, batching, the degenerate server), rows and params
are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import pipeline as ref_pipeline
from repro.fl.async_server import EventDrivenServer as RefEventDrivenServer
from repro.fl.mobility import coverage_active as ref_coverage_active
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.fl.timing import staleness_weight as ref_staleness_weight
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import pipeline
from repro_torch.fl.async_server import EventDrivenServer
from repro_torch.fl.mobility import coverage_active
from repro_torch.fl.rounds import FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.fl.timing import staleness_weight
from repro_torch.launch import sweep
from test_torch_round import N, _cfgs, _eval_margin, reference_fields
from test_torch_sweep import _tiny
from torch_threads import torch_intra_op_threads  # noqa: F401

ROUNDS = 3
PERIOD = 60.0                          # FLSimConfig.deadline_s
# the three server configurations: the degenerate one (the round
# barrier), churn + weighted staleness + a cadence of 1.5 periods, and
# drop + a cadence of 2 periods
SERVERS = {
    "sync-equivalent": dict(server="event"),
    "churn weighted": dict(churn_rate=0.2, staleness="weighted",
                           staleness_lambda=0.5, agg_cadence_s=1.5 * PERIOD),
    "drop cadence": dict(agg_cadence_s=2.0 * PERIOD),
}
INT_KEYS = ("round", "n_selected", "n_aggregated", "n_straggler",
            "n_active", "stale_frac", "rounds_behind_hist", "state_bytes",
            "upload_bytes", "state_time_s", "comm_time_s")

_RUNS = {}


def _pair(name, fresh_fields=False):
    """The reference's simulation under ``SERVERS[name]`` and the port's
    (CPU) from its weights, fed its draws."""
    rcfg, cfg = _cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(**SERVERS[name]))
    port = FLSimulation(cfg, run=RunConfig(**SERVERS[name]), device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    port.params = params_from_jax(jax.device_get(ref.params))
    return ref, port


def _runs(name):
    """``ROUNDS`` rounds of the event server in both packages, once a
    module, in lockstep: each round starts the port from the reference's
    global params (carried across rounds, fp32 SGD grows the one-round
    1e-7 gap to ~5e-4, as ``test_two_rounds_match_reference`` notes;
    the pending stacks stay each package's own).  Returns ``(ref rows,
    port rows, ref params, port params, ref sim)``."""
    if name not in _RUNS:
        ref, port = _pair(name)
        ref_srv, srv = RefEventDrivenServer(ref), EventDrivenServer(port)
        want, got = [], []
        for r in range(ROUNDS):
            port.params = params_from_jax(jax.device_get(ref.params))
            want.append(ref_srv.finish_round(r, ref.selection_state(r)))
            f = port.round_fields(r)
            got.append(srv.finish_round(r, port.selection_state(r, f), f))
        _RUNS[name] = (want, got, jax.device_get(ref.params), port.params,
                       ref)
    return _RUNS[name]


def _params_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("churn", [0.0, 0.2, 1.0])
def test_coverage_active_is_the_references(churn):
    pos = np.random.default_rng(3).uniform(0, 1000, 257).astype(np.float32)
    pos[:4] = [0.0, 799.99994, 800.0, 999.99994]
    want = np.asarray(ref_coverage_active(jnp.asarray(pos),
                                          road_length_m=1000.0,
                                          churn_rate=churn))
    got = coverage_active(torch.tensor(pos), road_length_m=1000.0,
                          churn_rate=churn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_staleness_weight_is_the_references():
    """``==`` on a grid of lambda and delay, scalars and an array (not
    strict monotonicity: 1e-9 * d rounds to nothing, ROADMAP C2)."""
    delays = np.arange(31)
    for lam in (0.0, 1e-9, 0.5, 1.0, 10.0):
        np.testing.assert_array_equal(staleness_weight(lam, delays),
                                      ref_staleness_weight(lam, delays))
        for d in range(31):
            assert staleness_weight(lam, d) == ref_staleness_weight(lam, d)
        assert staleness_weight(lam, 0) == 1.0


@pytest.mark.parametrize("lam,delay", [(-0.5, 1), (1.0, -1),
                                       (1.0, np.array([0, -2]))])
def test_staleness_weight_raises_as_the_reference(lam, delay):
    for fn in (staleness_weight, ref_staleness_weight):
        with pytest.raises(ValueError):
            fn(lam, delay)


def test_churn_prefix_matches_reference():
    """The prefix at churn 0.2 against the reference's ``_prefix`` on its
    weights and draws, rounds 0 and 3: masks, ``alive_at_done`` and
    ``n_active`` equal; evals to 1e-3 and ``t_done`` to 1e-4 relative;
    the landing ticks at 1.5 periods equal, with the smallest distance of
    ``t_done / T`` to an integer printed (as C3's margin)."""
    ref = _runs("churn weighted")[-1]
    port = FLSimulation(_cfgs()[1],
                        run=RunConfig(**SERVERS["churn weighted"]),
                        device="cpu")
    port.params = params_from_jax(jax.device_get(ref.params))
    assert port.stage_cfg.churn_rate == 0.2
    cadence = SERVERS["churn weighted"]["agg_cadence_s"]
    for rnd in (0, 3):
        want = jax.device_get(ref_pipeline.selection_prefix(
            ref.statics, ref.params, jnp.int32(rnd), ref.key, ref.net_key,
            cfg=ref.stage_cfg))
        got = port.selection_state(rnd, reference_fields(ref, rnd))
        margin = _eval_margin(want["evals"], port.stage_cfg.e_tau)
        q = np.asarray(want["t_done"], np.float64) / cadence
        tick_margin = float(np.abs(q - np.round(q)).min())
        print(f"[churn round {rnd}] smallest eval margin {margin:.3g}, "
              f"t_done / T from an integer {tick_margin:.3g}, active "
              f"{int(want['n_active'])}")
        np.testing.assert_allclose(got["evals"].numpy(), want["evals"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["t_done"].numpy(), want["t_done"],
                                   rtol=1e-4)
        for key in ("mask", "survivors", "alive_at_done"):
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=key)
        assert int(got["n_active"]) == int(want["n_active"]) < N
        srv = EventDrivenServer(port)
        np.testing.assert_array_equal(
            srv.landing_ticks(got["t_done"].numpy()),
            np.maximum(np.ceil(q).astype(np.int64), 1))


def test_churn_zero_runs_the_churn_free_prefix(monkeypatch):
    """At churn 0 the churn ops never run (a Python ``if``); every client
    is active and present at its upload, and ``t_done <= t_s +
    deadline`` exactly for the selected survivors.  At churn 0.2 the
    same draws give the same positions and features, and departed
    clients' evals are +0.0."""
    _, cfg = _cfgs()
    sim = FLSimulation(cfg, device="cpu")
    fields = sim.round_fields(0)

    def refuse(*a, **k):
        raise AssertionError("coverage_active ran at churn 0")
    with monkeypatch.context() as mp:
        mp.setattr(pipeline, "coverage_active", refuse)
        free = sim.selection_state(0, fields)
    assert bool(free["alive_at_done"].all()) and int(free["n_active"]) == N
    in_time = free["t_done"] <= PERIOD                    # t_s = 0
    assert torch.equal(free["survivors"], (free["mask"] > 0) & in_time)
    churn = pipeline.selection_prefix(
        sim.statics, sim.params, 0, fields,
        cfg=dataclasses.replace(sim.stage_cfg, churn_rate=0.2))
    active = coverage_active(free["pos"], road_length_m=1000.0,
                             churn_rate=0.2)
    assert torch.equal(churn["pos"], free["pos"])
    assert torch.equal(churn["feats"], free["feats"])
    assert torch.equal(churn["evals"], torch.where(active, free["evals"],
                                                   torch.zeros(())))
    assert int(churn["n_active"]) == int(active.sum())
    assert not bool((churn["mask"] > 0)[~active].any())


def _check_rows(want, got, label):
    for a, b in zip(want, got):
        assert list(b) == list(a)
        for key in INT_KEYS:
            assert b[key] == a[key], (label, key, a, b)
        assert abs(b["n_effective"] - a["n_effective"]) <= 1e-9
        assert abs(b["accuracy"] - a["accuracy"]) <= 0.01
        assert abs(b["mean_eval_selected"] - a["mean_eval_selected"]) <= 1e-3


@pytest.mark.parametrize("name", list(SERVERS))
def test_event_server_matches_reference(name):
    """``ROUNDS`` rounds of the event server in both packages (``_runs``):
    integer columns, stale fraction and histograms equal (some round
    stale in the weighted case), ``n_effective`` within 1e-9, accuracy
    within 0.01, the mean evaluation within 1e-3, the final params within
    rtol 1e-4 / atol 1e-5."""
    want, got, ref_params, params, _ = _runs(name)
    _check_rows(want, got, name)
    if name == "churn weighted":
        assert any(r["stale_frac"] > 0 for r in got)
        assert any(r["n_active"] < N for r in got)
    mine = params_to_numpy(params)
    for layer in mine:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                mine[layer][leaf], np.asarray(ref_params[layer][leaf]),
                rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("name", ["sync-equivalent", "churn weighted"])
def test_round_ahead_rows_are_the_serial_rows(name):
    """The port's round-ahead rows and params equal its serial ones bit
    for bit, for the round barrier and the event server; the degenerate
    event server's equal the sync driver's."""
    _, cfg = _cfgs()
    runs = {"round-ahead": dict(SERVERS[name]),
            "serial": dict(SERVERS[name], overlap_rounds=False)}
    if name == "sync-equivalent":
        runs.update(sync_serial=dict(overlap_rounds=False))
    out = {}
    for label, kw in runs.items():
        sim = FLSimulation(cfg, run=RunConfig(**kw), device="cpu")
        out[label] = (sim.run(ROUNDS), sim.params)
        assert sim.run_cfg.overlap_rounds == (label == "round-ahead")
    rows, params = out.pop("round-ahead")
    for label, (r, p) in out.items():
        assert r == rows, label
        assert _params_equal(p, params), label
    if name == "sync-equivalent":
        assert EventDrivenServer(FLSimulation(
            cfg, run=RunConfig(**SERVERS[name]), device="cpu")
        ).sync_equivalent
    else:
        assert any(r["stale_frac"] > 0 for r in rows)


def test_round_ahead_rows_match_the_references():
    """Two rounds of both packages' round-ahead drivers (the reference's
    default) from the same weights on the reference's draws:
    ``_check_rows``' tolerances (two rounds: the carried fp32 gap stays
    ~1e-7)."""
    ref, port = _pair("sync-equivalent")
    ref.run_cfg = dataclasses.replace(ref.run_cfg, server="sync")
    port.run_cfg = dataclasses.replace(port.run_cfg, server="sync")
    assert ref.run_cfg.overlap_rounds and port.run_cfg.overlap_rounds
    _check_rows(ref.run(2), port.run(2), "round-ahead")


def _weighted_sim(**kw):
    _, cfg = _cfgs(scheme="ccs-fuzzy")
    return FLSimulation(dataclasses.replace(cfg, **kw),
                        run=RunConfig(staleness="weighted",
                                      staleness_lambda=1.0), device="cpu")


def test_all_departed_round_is_a_noop():
    """churn 1.0 empties the coverage window: nobody is active or
    selected (the central scheme's top-k included), and the global model
    is bit-unchanged."""
    _, cfg = _cfgs(scheme="ccs-fuzzy")
    sim = FLSimulation(cfg, run=RunConfig(churn_rate=1.0), device="cpu")
    before = {k: v.clone() for k, v in sim.params.items()}
    for row in sim.run(2):
        assert row["n_active"] == row["n_selected"] == 0
        assert row["n_aggregated"] == 0
    assert _params_equal(sim.params, before)


def test_stragglers_wait_for_a_cadence_tick():
    """A deadline below every selected client's completion: weighted mode
    trains them all, round 0 aggregates nothing (params bit-unchanged),
    and a later round folds them in, stale and discounted."""
    probe = _weighted_sim()
    host = probe._host(probe.selection_state(0))
    sel = host["mask"] > 0
    assert sel.any()
    dur = np.asarray(host["t_done"], np.float64)[sel]       # t_s = 0
    period = 0.9 * float(dur.min())
    sim = _weighted_sim(deadline_s=period)
    srv = EventDrivenServer(sim)
    before = {k: v.clone() for k, v in sim.params.items()}
    f0 = sim.round_fields(0)
    row0 = srv.finish_round(0, sim.selection_state(0, f0), f0)
    assert row0["n_selected"] > 0
    assert row0["n_straggler"] == row0["n_selected"]
    assert row0["n_aggregated"] == 0
    assert _params_equal(sim.params, before)
    for r in range(1, int(np.ceil(dur.max() / period)) + 2):
        f = sim.round_fields(r)
        row = srv.finish_round(r, sim.selection_state(r, f), f)
        if row["n_aggregated"] > 0 and row["stale_frac"] > 0.0:
            break                            # a straggler has landed
    else:
        raise AssertionError("no straggler landed at a cadence tick")
    assert row["n_effective"] < row["n_aggregated"]


def test_departing_mid_training_drops_the_update():
    """A client out of coverage at its upload instant loses the update:
    with every ``alive_at_done`` False nothing is enqueued and the model
    is bit-unchanged."""
    _, cfg = _cfgs(scheme="ccs-fuzzy")
    sim = FLSimulation(cfg, run=RunConfig(churn_rate=0.2,
                                          staleness="weighted",
                                          staleness_lambda=0.5),
                       device="cpu")
    srv = EventDrivenServer(sim)
    fields = sim.round_fields(0)
    host = sim._host(sim.selection_state(0, fields))
    assert (host["mask"] > 0).any()
    host["alive_at_done"] = np.zeros(N, bool)
    before = {k: v.clone() for k, v in sim.params.items()}
    srv._dispatch_training(0, host, fields)
    assert not srv._pending and srv._stats[0]["n_agg"] == 0
    assert _params_equal(sim.params, before)


def test_sweep_group_under_churn():
    """``run_seed_group`` with 2 seeds at churn 0.2 (weighted, lambda
    0.5): the seed-batched prefix, ``--no-vmap`` and the serial schedule
    give the same rows."""
    run = RunConfig(churn_rate=0.2, staleness="weighted",
                    staleness_lambda=0.5)

    def group(vmap=True, **kw):
        return sweep.run_seed_group(
            "dcs", 9, "uniform", (0, 1), 2, cfg_fn=_tiny, vmap_prefix=vmap,
            run=dataclasses.replace(run, **kw), device="cpu")
    batched = group()
    assert any(r["n_active"] < 10 for r in batched)
    assert batched == group(vmap=False)
    assert batched == group(overlap_rounds=False)
