"""Kills in real processes: a ``SIGKILL`` at a snapshot in a subprocess
(``tests/test_faults.py`` of the reference) and the 2-rank client mesh
(``tests/test_resume.py``'s forced mesh, on gloo ranks), each resumed
in fresh processes.

The mesh's resumed run is ``==`` its own uninterrupted run and is held
against the port's single-device resume (counts and masks equal, the
rest within the mesh tests' tolerances).  This file imports neither JAX
nor the reference: the subprocesses and the mesh's spawned ranks import
it.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.fl.rounds import FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.launch import faults
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.checkpoint import RoundCheckpointer
from test_torch_resume import _cfg, _digest
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


_SIM_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[3])
from test_torch_resume import _cfg, _digest
from repro_torch.fl.rounds import FLSimulation
from repro_torch.fl.runconfig import RunConfig
torch.set_num_threads(int(sys.argv[4]))
sim = FLSimulation(_cfg(), run=RunConfig(checkpoint_dir=sys.argv[1],
                                         resume=sys.argv[2] == "1"),
                   device="cpu")
rows = sim.run(3)
print(json.dumps({"rows": rows, "params": _digest(sim.params)}))
"""


def _child(ckdir, resume, plan=None):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    env.pop(faults.ENV_VAR, None)
    if plan:
        env[faults.ENV_VAR] = plan
    return subprocess.run(
        [sys.executable, "-c", _SIM_CHILD, str(ckdir), "1" if resume else "0",
         str(Path(__file__).parent), str(torch.get_num_threads())],
        capture_output=True, text=True, env=env, timeout=300)


def test_sigkill_at_a_snapshot_then_resume_in_a_fresh_process(tmp_path):
    """SIGKILL the process the instant round 1's snapshot commits; a
    fresh process resumes, and its rows and a digest of its params are
    the uninterrupted run's.  The children run with this process's
    intra-op threads: the CPU convolutions sum in an order that depends
    on them."""
    sim = FLSimulation(_cfg(), device="cpu")
    want = {"rows": sim.run(3), "params": _digest(sim.params)}
    killed = _child(tmp_path / "ck", False,
                    plan="sigkill@checkpoint-saved:round=1")
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-4000:]
    assert "injecting sigkill at checkpoint-saved (round=1)" in killed.stderr
    assert RoundCheckpointer(str(tmp_path / "ck")).rounds_on_disk() == [0, 1]
    resumed = _child(tmp_path / "ck", True)
    assert resumed.returncode == 0, resumed.stderr[-4000:]
    assert json.loads(resumed.stdout.strip().splitlines()[-1]) == json.loads(
        json.dumps(want))


def mesh_resume_rank(mesh, cfg, ckdir, rounds, kill_after):
    """One rank: ``rounds`` rounds uninterrupted; ``kill_after`` rounds
    with snapshots (rank 0 writes them); then a fresh simulation resumes
    to ``rounds``.  Rows, params, masks and counters of both runs."""
    out = {}
    runs = (("full", RunConfig(mesh="clients=2"), rounds),
            ("part", RunConfig(mesh="clients=2", checkpoint_dir=ckdir),
             kill_after),
            ("res", RunConfig(mesh="clients=2", checkpoint_dir=ckdir,
                              resume=True), rounds))
    for label, run, n in runs:
        sim = FLSimulation(cfg, run=run, mesh=mesh)
        out[f"{label}.rows"] = sim.run(n)
        out.update({f"{label}.param.{k}": v for k, v in sim.params.items()})
        out[f"{label}.mask"] = sim.last_mask
        out[f"{label}.participation"] = sim.participation
        dist.barrier()                   # rank 0's snapshots are written
    return out


def test_mesh_resume_is_its_uninterrupted_run_and_one_devices(tmp_path):
    """2 gloo ranks: the resumed mesh run ``==`` the uninterrupted mesh
    run on every rank; against the port's single-device resume from the
    same round, the masks, counters and integer columns are equal and
    the params within 1e-5 (the FedAvg sums add in another order, as
    ``tests/test_torch_mesh.py`` holds round 0), the mean evaluation
    within 1e-5 relative and the accuracy within 0.01."""
    ck = str(tmp_path / "mesh_ck")
    res = spawn_ranks(mesh_resume_rank, 2, "cpu",
                      args=(_cfg(), ck, 3, 2), threads=1, timeout=240,
                      workdir=tmp_path)
    for r in res:
        assert r["res.rows"] == r["full.rows"] == res[0]["full.rows"]
        for key in ("mask", "participation"):
            np.testing.assert_array_equal(r[f"res.{key}"], r[f"full.{key}"])
        for key in [k for k in r if k.startswith("full.param.")]:
            np.testing.assert_array_equal(r["res" + key[4:]], r[key])
    one_ck = RoundCheckpointer(str(tmp_path / "one_ck"))
    FLSimulation(_cfg(), device="cpu").run(2, checkpointer=one_ck)
    one = FLSimulation(_cfg(), device="cpu")
    rows = one.run(3, checkpointer=one_ck, resume=True)
    np.testing.assert_array_equal(res[0]["res.mask"], one.last_mask)
    np.testing.assert_array_equal(res[0]["res.participation"],
                                  one.participation)
    for k, v in one.params.items():
        np.testing.assert_allclose(res[0][f"res.param.{k}"], v.numpy(),
                                   rtol=0, atol=1e-5)
    for got, want in zip(res[0]["res.rows"], rows):
        for key in ("round", "n_selected", "n_aggregated", "n_straggler",
                    "n_active"):
            assert got[key] == want[key], (key, got, want)
        assert got["mean_eval_selected"] == pytest.approx(
            want["mean_eval_selected"], rel=1e-5)
        assert abs(got["accuracy"] - want["accuracy"]) <= 0.01
