"""Preemption-safe resume in the port (``tests/test_resume.py`` and
``tests/test_faults.py`` of the reference, on the port's drivers).

A run killed after round r and resumed in a fresh simulation must give
the uninterrupted run's rows, params, last mask and participation
counters with ``==``: the serial and round-ahead schedules, the
event-driven server under churn, weighted staleness and a cadence
faster than the round period (its pending pool crosses the kill), the
sweep's seed groups and its CSV (byte for byte, completed groups
skipped) and ``overflow@resume``.  The kills in real processes (a
``SIGKILL`` in a subprocess, the 2-rank client mesh) are in
``tests/test_torch_resume_procs.py``, the format and the resume from the
reference's snapshots in ``tests/test_torch_checkpoint.py``.

This file imports neither JAX nor the reference: the subprocesses and
the mesh's spawned ranks import it.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.kernels import ops
from repro_torch.launch import faults, sweep
from repro_torch.train.checkpoint import RoundCheckpointer, load_state
from torch_threads import torch_intra_op_threads  # noqa: F401

N = 10
EVENT_RUN = RunConfig(server="event", churn_rate=0.3, staleness="weighted",
                      staleness_lambda=1.0, agg_cadence_s=20.0)


def _cfg(seed=0, n=N, scheme="dcs"):
    """The reference's 10-client resume profile (``tests/test_resume.py``,
    ``tests/test_torch_round.py``)."""
    return FLSimConfig(
        scheme=scheme, n_rounds=4, local_epochs=1, samples_per_class=260,
        probe_samples=64, seed=seed,
        partition=PartitionConfig(n_clients=n, big_clients=3,
                                  big_quantity=120, small_quantity=40,
                                  classes_per_client=9, seed=seed),
        mobility=MobilityConfig(n_vehicles=n, seed=seed))


@pytest.fixture(autouse=True)
def _no_fault_plan(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)


def _assert_same_state(a: FLSimulation, b: FLSimulation):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    np.testing.assert_array_equal(a.last_mask, b.last_mask)
    np.testing.assert_array_equal(a.participation, b.participation)


@pytest.mark.parametrize("run,overlap", [
    (None, False), (None, True), (EVENT_RUN, None)],
    ids=["serial", "round-ahead", "event"])
def test_kill_and_resume_is_the_uninterrupted_run(tmp_path, run, overlap):
    """4 rounds against 2, a fresh simulation, then the resume to 4:
    rows, params, last mask and participation ``==``.  The event
    server's snapshot holds a pending landing tick, which must land
    after the resume as it would have."""
    full = FLSimulation(_cfg(), run=run, device="cpu")
    rows_full = full.run(4, overlap=overlap)
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    FLSimulation(_cfg(), run=run, device="cpu").run(
        2, overlap=overlap, checkpointer=ck)
    if run is not None:
        state, _ = load_state(ck.path_for(1))
        assert state["pending"], "the kill point holds no pending update"
    res = FLSimulation(_cfg(), run=run, device="cpu")
    rows_res = res.run(4, overlap=overlap, checkpointer=ck, resume=True)
    assert rows_res == rows_full
    _assert_same_state(full, res)


def test_runconfig_cadence_on_disk_and_idempotent_resume(tmp_path):
    """``checkpoint_every=2`` over 4 rounds leaves rounds 1 and 3; a
    resume after the last round runs nothing and returns the rows."""
    d = str(tmp_path / "ck")
    rows = FLSimulation(_cfg(), run=RunConfig(checkpoint_dir=d,
                                              checkpoint_every=2),
                        device="cpu").run(4)
    assert RoundCheckpointer(d).rounds_on_disk() == [1, 3]
    again = FLSimulation(_cfg(), run=RunConfig(
        checkpoint_dir=d, checkpoint_every=2, resume=True),
        device="cpu").run(4)
    assert again == rows


def test_restore_refuses_another_seed_or_fleet():
    state = FLSimulation(_cfg(seed=0), device="cpu").capture_state()
    with pytest.raises(ValueError, match="PRNG base"):
        FLSimulation(_cfg(seed=1), device="cpu").restore_state(state)
    with pytest.raises(ValueError, match="fleet"):
        FLSimulation(_cfg(n=12), device="cpu").restore_state(state)


def test_overflow_switch_takes_the_dense_rerun(tmp_path, monkeypatch):
    """``overflow@resume`` forces every round after the resume through
    the windowed election's overflow and the dense re-run (never taken
    without it at this fleet's auto window), and the rows stay the
    uninterrupted run's; a restore without the switch keeps the
    stage config."""
    run = RunConfig(elect="windowed")
    dense = []
    count = ops.neighbor_elect
    monkeypatch.setattr(ops, "neighbor_elect",
                        lambda *a, **k: dense.append(1) or count(*a, **k))
    full = FLSimulation(_cfg(), run=run, device="cpu")
    rows_full = full.run(3)
    assert dense == []
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    plain = FLSimulation(_cfg(), run=run, device="cpu")
    stage = plain.stage_cfg
    plain.run(1, checkpointer=ck)
    plain.run(1, checkpointer=ck, resume=True)
    assert plain.stage_cfg == stage
    monkeypatch.setenv(faults.ENV_VAR, "overflow@resume")
    res = FLSimulation(_cfg(), run=run, device="cpu")
    rows_res = res.run(3, checkpointer=ck, resume=True)
    assert (res.stage_cfg.elect_capacity, res.stage_cfg.elect_window) == (
        1, 1)
    assert len(dense) == 2
    assert [r["round"] for r in rows_res] == [0, 1, 2]
    assert rows_res == rows_full
    _assert_same_state(full, res)


def _tiny(scheme, classes, dist, seed):
    """``tests/test_sweep.py::_tiny`` in the port."""
    return FLSimConfig(
        scheme=scheme, local_epochs=1, samples_per_class=260,
        probe_samples=64, seed=seed,
        partition=PartitionConfig(n_clients=N, big_clients=3,
                                  big_quantity=120, small_quantity=40,
                                  classes_per_client=classes, seed=seed),
        mobility=MobilityConfig(n_vehicles=N, distribution=dist,
                                seed=seed))


def test_sweep_resume_skips_finished_groups_byte_equal(tmp_path):
    """A grid of two groups (``dcs``, ``random``) x 2 seeds x 2 rounds:
    with the ``dcs`` group's rows in the partial CSV and the ``random``
    group killed after its round-0 snapshot, ``--resume`` skips the
    first (the reference's log line), restarts the second from its
    snapshot and writes the uninterrupted CSV byte for byte; the seed
    group's resumed rows ``==`` its uninterrupted ones; no snapshot is
    left behind."""
    grid = dict(schemes=("dcs", "random"), classes_list=(9,),
                distributions=("uniform",), seeds=(0, 1), rounds=2,
                cfg_fn=_tiny, device="cpu")
    want = sweep.rows_to_csv(sweep.sweep(**grid))
    group = [r for r in sweep.parse_csv_rows(want) if r["scheme"] == "random"]
    out = tmp_path / "sweep.csv"
    out.write_text(sweep.rows_to_csv(
        [r for r in sweep.parse_csv_rows(want) if r["scheme"] == "dcs"]))
    ck = tmp_path / "ck"
    gdir = sweep._group_ckpt_dir(str(ck), "random", 9, "uniform",
                                 RunConfig().resolved())
    sweep.run_seed_group("random", 9, "uniform", (0, 1), 1, cfg_fn=_tiny,
                         device="cpu", checkpoint_dir=gdir)
    assert RoundCheckpointer(gdir).rounds_on_disk() == [0]
    resumed = sweep.run_seed_group("random", 9, "uniform", (0, 1), 2,
                                   cfg_fn=_tiny, device="cpu",
                                   checkpoint_dir=gdir, resume=True)
    assert sweep.parse_csv_rows(sweep.rows_to_csv(
        sweep.aggregate_rows(resumed))) == group
    RoundCheckpointer(gdir).clear()
    sweep.run_seed_group("random", 9, "uniform", (0, 1), 1, cfg_fn=_tiny,
                         device="cpu", checkpoint_dir=gdir)
    logs = []
    rows = sweep.sweep(**grid, out_path=str(out), checkpoint_dir=str(ck),
                       resume=True, log=logs.append)
    assert sweep.rows_to_csv(rows) == want
    assert out.read_text() == want
    assert any("resume: skipping completed group dcs/9/uniform" in m
               for m in logs)
    assert not os.path.exists(gdir)


def _digest(params) -> str:
    """A sha256 of the params' bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].cpu().numpy().tobytes())
    return h.hexdigest()
