"""The port's multi-host launch (``launch/multihost.py``, ``--multihost
P`` on ``fl_sim`` and ``sweep``, ``launch/mesh.py``'s world of K ranks
over P processes) on the CPU.

As the reference's ``tests/test_multihost.py`` (whose own run cannot
form its mesh on the installed JAX, ROADMAP C1), each case is held
against the same work on a single-host mesh: a psum and the 10-client
windowed prefix over 2 hosts x 2 ranks against 4 ranks of one host;
``fl_sim --out`` and the sweep's CSV under ``--multihost 2`` byte-equal
to the single-host mesh's, process 0 alone printing and writing.  Then
the port's copies of the reference's launcher tests
(``tests/test_faults.py``): a dead peer reaped and named, death by a
signal as 128 + S, a clean launch, the launch timeout's 124, the
``mh-child-start`` fault event (through a stand-in module and through
``fl_sim``), ``retry_with_backoff``; and a rank that cannot join raising
with its rank and coordinator.  The runs import neither JAX nor the
reference.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch import faults, fl_sim
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.multihost import (free_port, retry_with_backoff,
                                          spawn_multihost)
from torch_multihost_ranks import SPAWN_TIMEOUT, WORLD, world_rank
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
LAUNCH_TIMEOUT = 300


def _env(**extra):
    """The launches' environment: the port and this directory importable,
    no fault plan unless given."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(TESTS)]), **extra)
    if faults.ENV_VAR not in extra:
        env.pop(faults.ENV_VAR, None)
    return env


def _start(module, *argv, **env):
    return subprocess.Popen([sys.executable, "-m", module, *argv],
                            cwd=REPO, env=_env(**env), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc):
    out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, err[-4000:]
    return out


# -- the world over 2 hosts against one host ------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``world_rank``'s results over 2 hosts x 2 ranks (a ``--multihost
    2`` launch of ``torch_multihost_ranks``, in the background) and on 4
    ranks of this host."""
    out = tmp_path_factory.mktemp("world") / "multi.json"
    multi = _start("torch_multihost_ranks", str(out), "--multihost", "2")
    single = spawn_ranks(world_rank, WORLD, "cpu", args=(2,), threads=1,
                         timeout=SPAWN_TIMEOUT)
    _finish(multi)
    return json.loads(out.read_text()), single


def test_psum_and_ring_over_two_hosts(worlds):
    multi, single = worlds
    assert len(multi) == WORLD
    for r, res in enumerate(multi):
        assert res["psum"] == [float(sum(range(1, WORLD + 1)))] * 3
        assert res["left"] == (r - 1) % WORLD
        assert (res["hosts"], res["backend"]) == (2, "gloo")
    assert [r["hosts"] for r in single] == [1] * WORLD


def test_windowed_prefix_masks_over_two_hosts_are_one_hosts(worlds):
    """The reference test's 10-client config, 2 rounds of the windowed
    prefix: every rank's masks over 2 hosts x 2 ranks equal the 4 ranks
    of one host's, and so do each rank's collective bytes by kind."""
    multi, single = worlds
    for m, s in zip(multi, single):
        assert len(m["masks"]) == 2 and len(m["masks"][0]) == 10
        assert m["masks"] == s["masks"]
        assert m["collective_bytes"] == s["collective_bytes"]
    assert all(m["masks"] == multi[0]["masks"] for m in multi)


# -- the CLIs ----------------------------------------------------------------

FL_SIM_ARGV = ["--device", "cpu", "--scheme", "dcs", "--mesh", "clients=4",
               "--rounds", "1", "--elect", "windowed"]
SWEEP_ARGV = ["--device", "cpu", "--mesh", "clients=4", "--seeds", "1",
              "--rounds", "1", "--schemes", "dcs"]


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """``fl_sim --out`` and the sweep's CSV with and without
    ``--multihost 2``, the four launches two at a time."""
    tmp = tmp_path_factory.mktemp("clis")
    runs = {}
    for name, module, argv, out in (
            ("fl_sim", "repro_torch.launch.fl_sim", FL_SIM_ARGV, "--out"),
            ("sweep", "repro_torch.launch.sweep", SWEEP_ARGV, "--out")):
        procs = {mh: _start(module, *argv, out, str(tmp / f"{name}{mh}"),
                            *(["--multihost", "2"] if mh else []))
                 for mh in (0, 1)}
        runs[name] = {mh: (_finish(p), (tmp / f"{name}{mh}").read_bytes())
                      for mh, p in procs.items()}
    return runs


def test_fl_sim_multihost_out_is_the_single_host_meshs(clis):
    (single_out, single), (multi_out, multi) = clis["fl_sim"][0], \
        clis["fl_sim"][1]
    assert multi == single
    assert len(json.loads(multi)["dcs"]) == 1
    assert "2 processes" in multi_out and "2 processes" not in single_out
    assert "backend gloo" in multi_out
    assert multi_out.count("[fl_sim] rank ") == WORLD
    assert multi_out.count("[fl_sim] wrote ") == 1
    rows = [line for line in multi_out.splitlines() if line.startswith("{")]
    assert rows == [line for line in single_out.splitlines()
                    if line.startswith("{")]


def test_sweep_multihost_csv_is_the_single_host_meshs(clis):
    (single_out, single), (multi_out, multi) = clis["sweep"][0], \
        clis["sweep"][1]
    assert multi == single
    assert ("[sweep] client mesh: {'clients': 4} over 4 ranks / 2 "
            "processes") in multi_out
    assert multi_out.count("[sweep] rank ") == WORLD
    assert multi_out.count("[sweep] wrote ") == 1


@pytest.mark.parametrize("pid", [0, 1])
def test_only_the_lead_host_prints_and_writes(pid, tmp_path, monkeypatch,
                                              capsys):
    """A ``--multihost`` child's launcher, its ranks stubbed: process 0
    prints the rank lines and writes ``--out``, process 1 neither."""
    def spawn(fn, k, device, *, args, kwargs, multihost):
        assert multihost == ("127.0.0.1:1", 2, pid) and k == 4
        return [{"rows": [{"accuracy": 0.5, "n_selected": 1}],
                 "prefix_s": [0.0], "round_s": [0.0], "launches": {},
                 "device": "cpu", "staged": {}}] * k
    monkeypatch.setattr(fl_sim, "spawn_ranks", spawn)
    out = tmp_path / "out.json"
    assert fl_sim.main(FL_SIM_ARGV + [
        "--out", str(out), "--multihost", "2", "--_mh-coord", "127.0.0.1:1",
        "--_mh-procs", "2", "--_mh-proc-id", str(pid)]) == 0
    text = capsys.readouterr().out
    assert out.exists() == (pid == 0)
    assert text.count("[fl_sim] rank ") == (WORLD if pid == 0 else 0)
    if pid == 1:
        assert text == ""


# -- containment: the reference's launcher tests ---------------------------

_FAKE_MH = """\
import os
import signal
import sys
import time

rank = int(sys.argv[sys.argv.index("--_mh-proc-id") + 1])
mode = sys.argv[1]
if mode == "faultfire":
    # the hook spawn_ranks fires before this host's ranks join the group
    from repro_torch.launch.faults import fire
    fire("mh-child-start", rank=rank)
if mode == "exit3" and rank == 1:
    sys.exit(3)
if mode == "kill9" and rank == 1:
    os.kill(os.getpid(), signal.SIGKILL)
if mode == "clean":
    sys.exit(0)
time.sleep(120)       # survivors block "in a collective" until reaped
"""


@pytest.fixture()
def fake_mh_module(tmp_path, monkeypatch):
    (tmp_path / "chaos_fake_mh_torch.py").write_text(_FAKE_MH)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(REPO / "src")]))
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    return "chaos_fake_mh_torch"


def test_spawn_reaps_survivors_when_peer_exits(fake_mh_module, capsys):
    """Process 1 exits 3 while its peers sleep: the parent names it,
    reaps the sleepers at once (not after their 120 s) and reports 3."""
    t0 = time.monotonic()
    rc = spawn_multihost(fake_mh_module, ["exit3"], 3)
    assert rc == 3
    assert time.monotonic() - t0 < 60
    assert "rank 1/3 died with exit code 3" in capsys.readouterr().err


def test_spawn_normalizes_signal_death(fake_mh_module, capsys):
    """A SIGKILLed process reports 137 (128 + 9): a negative wait status
    never passes for success through max()."""
    assert spawn_multihost(fake_mh_module, ["kill9"], 2) == 137
    assert "died with signal 9" in capsys.readouterr().err


def test_spawn_all_clean_is_success(fake_mh_module):
    assert spawn_multihost(fake_mh_module, ["clean"], 2) == 0


def test_spawn_timeout_reaps_everyone(fake_mh_module, capsys):
    t0 = time.monotonic()
    rc = spawn_multihost(fake_mh_module, ["hang"], 2, timeout=3)
    assert rc == 124 and time.monotonic() - t0 < 60
    assert "exceeded" in capsys.readouterr().err


def test_mh_child_start_fault_kills_one_rank(fake_mh_module, monkeypatch):
    """The plan reaches the children; process 1 fires ``mh-child-start``
    and dies with 5; the launch fails fast instead of hanging."""
    monkeypatch.setenv(faults.ENV_VAR, "exit=5@mh-child-start:rank=1")
    assert spawn_multihost(fake_mh_module, ["faultfire"], 2) == 5


def test_fl_sim_host_killed_at_start_ends_the_launch():
    """``exit=5@mh-child-start:rank=1`` through ``fl_sim --multihost 2``:
    host 1 dies before its rank joins, the parent reaps host 0 (whose
    rank waits at the rendezvous; its SIGTERM unwinds ``spawn_ranks``,
    which kills the rank) and the launch exits 5, naming host 1."""
    t0 = time.monotonic()
    proc = _start("repro_torch.launch.fl_sim", "--device", "cpu", "--mesh",
                  "clients=2", "--multihost", "2", "--rounds", "1",
                  **{faults.ENV_VAR: "exit=5@mh-child-start:rank=1"})
    _, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 5, err[-4000:]
    assert "rank 1/2 died with exit code 5" in err
    assert time.monotonic() - t0 < 120


def test_retry_with_backoff_recovers_and_reports():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("coordinator not up")
        return "joined"

    assert retry_with_backoff(flaky, attempts=4,
                              base_delay_s=0.01) == "joined"
    assert len(calls) == 3

    def doomed():
        raise OSError("nope")

    with pytest.raises(RuntimeError,
                       match=r"dist init failed after 2 attempts"):
        retry_with_backoff(doomed, attempts=2, base_delay_s=0.01,
                           desc="dist init")


def test_a_rank_that_cannot_join_names_itself_and_the_coordinator(
        tmp_path, monkeypatch):
    """Host 1 of 2 alone: its rank finds no coordinator, gives up after
    its attempts and raises naming its rank and the coordinator; nothing
    falls back to another backend or to one process; the SIGTERM handler
    that ``spawn_ranks`` installs for the launch is put back."""
    monkeypatch.setenv("REPRO_DIST_TIMEOUT_S", "2")
    monkeypatch.setenv("REPRO_DIST_INIT_ATTEMPTS", "1")
    coord = f"127.0.0.1:{free_port()}"
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match=(
            rf"rank [23]/4 via tcp://{coord}")):
        spawn_ranks(world_rank, WORLD, "cpu", args=(1,), threads=1,
                    timeout=120, workdir=tmp_path,
                    multihost=(coord, 2, 1))
    assert signal.getsignal(signal.SIGTERM) is before
