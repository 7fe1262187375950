"""The port's CLIs take the reference's command lines.

Each command line is parsed by the reference's parser and the port's
(``argparse`` stopped right after ``parse_args``), and every option
both parsers know must come out with the same value.  Then the port's
CLI runs it (the simulation stubbed: no dataset, no round): the
schedule and event-server flags land in the ``RunConfig`` the
reference's ``RunConfig.from_args`` builds from the same command line,
the checkpoint flags land there too (the snapshots in a directory a
scheme, as the reference's), and every knob the port has not ported
raises ``NotImplementedError`` naming its ROADMAP item before any work
is done.  ``launch/serve.py --arch`` takes each of the reference's ten
ids and serves its scaled-down variant on the CPU.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import os

import pytest

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.launch import fl_sim as ref_fl_sim
from repro.launch import serve as ref_serve
from repro.launch import sweep as ref_sweep
from repro_torch.configs import ARCH_IDS
from repro_torch.fl.runconfig import RunConfig
from repro_torch.launch import fl_sim, serve, sweep
from torch_threads import torch_intra_op_threads  # noqa: F401

# options one parser has and the other has not: the reference's hidden
# --multihost child flags; the port's device and ring-halo capacity
REF_ONLY = {"_mh_coord", "_mh_procs", "_mh_proc_id"}
PORT_ONLY = {"device", "elect_capacity"}


class _Parsed(Exception):
    pass


def _parsed(main, argv):
    """The namespace ``main``'s parser gives ``argv``, as a dict."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        seen.append(parse(self, args, namespace))
        raise _Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed):
            main(argv)
    return vars(seen[0])


def _runs(monkeypatch, argv):
    """Run the port's CLI on ``argv`` with the simulation (and, with
    ``--mesh clients=K``, the ranks) stubbed: the ``RunConfig`` it
    built."""
    runs = []

    class Stub:
        device = "cpu"

        def __init__(self, cfg, run, **kw):
            runs.append(run)

    def drive(sim, n, **kw):
        rows = [{"accuracy": 0.0, "n_selected": 0}] * n
        return {"rows": rows, "launches": {}, "prefix_s": [0.0] * n,
                "round_s": [0.0] * n}

    def spawn(fn, k, device, *, args, kwargs):
        runs.append(args[1])
        return [dict(drive(None, args[2]), device="cpu", staged={})
                for _ in range(k)]

    monkeypatch.setattr(fl_sim, "FLSimulation", Stub)
    monkeypatch.setattr(fl_sim, "drive_rounds", drive)
    monkeypatch.setattr(fl_sim, "spawn_ranks", spawn)
    assert fl_sim.main(argv + ["--device", "cpu"]) == 0
    return runs


# (flags, ROADMAP item it raises naming, or None: a no-op that runs)
FL_SIM_CASES = [
    (["--fast"], None),
    (["--no-overlap-rounds"], None),
    (["--fast", "--no-overlap-rounds", "--elect", "windowed",
      "--elect-window", "4"], None),
    (["--checkpoint-dir", "ckpt"], None),
    (["--checkpoint-every", "5"], None),
    (["--resume", "--checkpoint-dir", "ckpt"], None),
    (["--jit-cache-dir", "none"], "A14"),
    (["--multihost", "2"], "A11b"),
    (["--mesh", "clients=2", "--churn-rate", "0.2"], None),
]


@pytest.mark.parametrize("flags,item", FL_SIM_CASES,
                         ids=[" ".join(f) for f, _ in FL_SIM_CASES])
def test_fl_sim_takes_the_references_command_line(monkeypatch, flags, item):
    argv = ["--scheme", "dcs", "--rounds", "1", *flags]
    theirs = _parsed(ref_fl_sim.main, argv)
    mine = _parsed(fl_sim.main, argv)
    assert set(theirs) - set(mine) == REF_ONLY
    assert set(mine) - set(theirs) == PORT_ONLY
    for dest in set(theirs) & set(mine):
        assert mine[dest] == theirs[dest], dest
    if item is None:
        # the RunConfig the reference's fl_sim builds from the same
        # command line, its snapshots in a directory a scheme
        want = RefRunConfig.from_args(argparse.Namespace(**theirs))
        if want.checkpoint_dir:
            want = dataclasses.replace(want, checkpoint_dir=os.path.join(
                want.checkpoint_dir, "dcs"))
        (run,) = _runs(monkeypatch, argv)
        got, exp = shared_fields(run, want)
        assert got == exp
        assert (run.multihost, run.elect_capacity) == (0, 0)
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            fl_sim.main(argv + ["--device", "cpu"])


ASYNC_CASES = [
    ["--overlap-rounds"],
    ["--server", "event"],
    ["--churn-rate", "0.3"],
    ["--staleness", "weighted"],
    ["--staleness-lambda", "1"],
    ["--agg-cadence", "20"],
]


def shared_fields(port_obj, ref_obj, skip=()):
    """The dataclass fields both objects have (less ``skip``), as two
    dicts: the port's values and the reference's."""
    names = ({f.name for f in dataclasses.fields(port_obj)}
             & {f.name for f in dataclasses.fields(ref_obj)}) - set(skip)
    return ({n: getattr(port_obj, n) for n in names},
            {n: getattr(ref_obj, n) for n in names})


@pytest.mark.parametrize("flags", ASYNC_CASES,
                         ids=[" ".join(f) for f in ASYNC_CASES])
def test_fl_sim_takes_the_async_and_overlap_flags(monkeypatch, flags):
    """The round-ahead and event-server flags parse as the reference's,
    and the port's CLI runs with the ``RunConfig`` (server promotion
    included) and ``StageConfig`` the reference builds from the same
    command line."""
    argv = ["--scheme", "dcs", "--rounds", "1", *flags]
    theirs = _parsed(ref_fl_sim.main, argv)
    mine = _parsed(fl_sim.main, argv)
    for dest in set(theirs) & set(mine):
        assert mine[dest] == theirs[dest], dest
    want = RefRunConfig.from_args(argparse.Namespace(**theirs))
    (run,) = _runs(monkeypatch, argv)
    got, exp = shared_fields(run, want)
    assert got == exp
    assert run.server == ("sync" if flags in (["--overlap-rounds"],
                                              ["--staleness-lambda", "1"])
                          else "event")
    got, exp = shared_fields(
        run.to_stage_config(fl_sim.fast_config("dcs"), n_clients=30),
        want.to_stage_config(ref_fl_sim.fast_config("dcs"), n_clients=30),
        skip=("timing", "network"))
    assert got == exp


SWEEP_CASES = [
    [],
    ["--fast", "--seeds", "4", "--rounds", "2", "--schemes", "all"],
    ["--paper-profile", "--seeds", "2", "--rounds", "1", "--no-vmap"],
    ["--classes", "9,6,2", "--distributions", "uniform,extreme",
     "--workers", "2", "--out", "grid.csv"],
    ["--schemes", "dcs", "--compat-aligned-pack", "--elect", "windowed",
     "--elect-window", "8"],
    ["--churn-rates", "0,0.3", "--staleness-lambdas", "0,1",
     "--agg-cadences", "0,30", "--server", "event"],
    ["--mesh", "clients=4", "--multihost", "2", "--overlap-rounds",
     "--resume", "--checkpoint-dir", "ckpt", "--checkpoint-every", "3",
     "--jit-cache-dir", "none"],
]


@pytest.mark.parametrize("argv", SWEEP_CASES,
                         ids=[" ".join(a) or "defaults" for a in SWEEP_CASES])
def test_sweep_takes_the_references_command_line(argv):
    """The sweep's parser against the reference's: every shared ``dest``
    equal (the port adds ``--device``; the reference's hidden
    ``--multihost`` child flags stay its own)."""
    theirs = _parsed(ref_sweep.main, argv)
    mine = _parsed(sweep.main, argv)
    assert set(theirs) - set(mine) == REF_ONLY
    assert set(mine) - set(theirs) == {"device"}
    for dest in set(theirs) & set(mine):
        assert mine[dest] == theirs[dest], dest


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_serve_takes_every_arch_of_the_reference(arch):
    """The port's ``serve`` flags equal the reference's for every id,
    and the scaled-down arch serves on the CPU to its JSON line."""
    argv = ["--arch", arch, "--batch", "2", "--max-new", "3"]
    theirs = _parsed(ref_serve.main, argv)
    mine = _parsed(serve.main, argv)
    assert set(mine) - set(theirs) == {"device"}
    assert all(mine[k] == v for k, v in theirs.items())
    assert ARCH_IDS == REF_ARCH_IDS
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(argv + ["--reduced", "--prompt-len", "8",
                                  "--device", "cpu"]) == 0
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    assert stats["arch"] == arch and stats["device"] == "cpu"
    assert (stats["batch"], stats["prompt_len"], stats["max_new"],
            stats["layers"]) == (2, 8, 3, 2)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
