"""The port's checkpoint format (``train/checkpoint.py``) and fault plans
(``launch/faults.py``) against the reference's, and a resume from the
reference's own snapshot.

The format is the reference's v2: the same state saved by both packages
gives the same skeleton and the same array bytes; each package's
``load_state`` reads the other's snapshot with equal structure, dtypes
and leaves (``bfloat16`` compared as bytes: the port decodes it without
``ml_dtypes``, into a torch tensor).  Corruption raises
``CheckpointCorruptError``; ``RoundCheckpointer`` skips a corrupt
snapshot with a ``CheckpointCorruptWarning``.  The fault plans parse,
match and act as the reference's.  Resuming from the reference's
round-1 snapshot on the reference's draws, the port's round 2 is held
as ``tests/test_torch_round.py::_check_round`` holds a round, and its
params within 1e-5 of the reference's uninterrupted run.
"""
import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.launch import faults as ref_faults
from repro.train import checkpoint as ref_ckpt
from repro_torch.convert import params_to_numpy
from repro_torch.fl.rounds import FLSimulation, run_schedule
from repro_torch.launch import faults
from repro_torch.train import checkpoint as ckpt
from test_torch_round import _cfgs, reference_fields
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _state(seed):
    """A state with every leaf kind of the reference's snapshots: numpy
    arrays of its dtypes (uint32 as its PRNG keys), a 0-d scalar, an
    empty array, Python bool / int / float, ``None``, nested containers;
    and the port's torch leaves, fp32 and bf16."""
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(4, 3)).astype(np.float32)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i32": rng.integers(-5, 5, (5,), dtype=np.int32),
        "i64": rng.integers(0, 2 ** 40, (2, 2), dtype=np.int64),
        "u32": rng.integers(0, 2 ** 32, (2,), dtype=np.uint32),
        "mask": rng.random(4) > 0.5,
        "zero_d": np.float32(rng.normal()),
        "empty": np.zeros((0, 3), np.float32),
        "py": [True, int(rng.integers(100)), float(rng.normal()), None],
        "tuple": (np.int64(seed), {"nested": np.arange(3, dtype=np.int64)}),
        "tensor": torch.from_numpy(rng.normal(size=(2, 2)).astype(
            np.float32)),
        "bf16": torch.from_numpy(bf).bfloat16(),
    }


def _as_reference(state):
    """The same state as the reference holds it: numpy leaves, bf16 an
    ``ml_dtypes`` array of the same bytes."""
    out = dict(state)
    out["tensor"] = state["tensor"].numpy()
    out["bf16"] = state["bf16"].view(torch.int16).numpy().view(
        ml_dtypes.bfloat16)
    return out


def _bytes(leaf):
    """A leaf's dtype name, shape and raw bytes, whichever package
    decoded it."""
    if torch.is_tensor(leaf):
        assert leaf.dtype == torch.bfloat16
        return ("bfloat16", tuple(leaf.shape),
                leaf.view(torch.int16).numpy().tobytes())
    arr = np.asarray(leaf)
    return (str(arr.dtype), arr.shape, arr.tobytes())


def _assert_same(got, want):
    """Equal structure (dicts come back in key order, as from the
    reference), container types, Python scalar types and leaf bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif want is None or isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want
    else:
        assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_round_trip_is_bit_identical(tmp_path, seed):
    state = _state(seed)
    ckpt.save_state(str(tmp_path), state, extra={"rows": [{"a": 0.1}]})
    got, extra = ckpt.load_state(str(tmp_path))
    _assert_same(got, {**state, "tensor": state["tensor"].numpy()})
    assert got["bf16"].dtype == torch.bfloat16
    assert extra == {"rows": [{"a": 0.1}]}


@pytest.mark.parametrize("seed", [0, 1])
def test_both_packages_write_the_same_snapshot(tmp_path, seed):
    """The port's and the reference's ``save_state`` of one state: the
    same manifest skeleton and the same array entries, byte for byte."""
    ckpt.save_state(str(tmp_path / "port"), _state(seed))
    ref_ckpt.save_state(str(tmp_path / "ref"), _as_reference(_state(seed)))
    mans = [json.loads((tmp_path / d / "manifest.json").read_text())
            for d in ("port", "ref")]
    assert mans[0]["skeleton"] == mans[1]["skeleton"]
    assert mans[0]["format_version"] == mans[1]["format_version"] == 2
    arrays = [np.load(tmp_path / d / "arrays.npz") for d in ("port", "ref")]
    assert arrays[0].files == arrays[1].files
    for k in arrays[0].files:
        assert arrays[0][k].tobytes() == arrays[1][k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 1])
def test_each_package_loads_the_others_snapshot(tmp_path, seed):
    """A reference snapshot read by the port, a port snapshot read by
    the reference: equal structure, dtypes and leaves."""
    state = _state(seed)
    ref_ckpt.save_state(str(tmp_path / "ref"), _as_reference(state))
    ckpt.save_state(str(tmp_path / "port"), state)
    mine, _ = ckpt.load_state(str(tmp_path / "ref"))
    _assert_same(mine, {**state, "tensor": state["tensor"].numpy()})
    theirs, _ = ref_ckpt.load_state(str(tmp_path / "port"))
    assert theirs["bf16"].dtype == ml_dtypes.bfloat16
    _assert_same({**theirs, "bf16": torch.from_numpy(
        theirs["bf16"].view(np.int16)).view(torch.bfloat16)},
        {**state, "tensor": state["tensor"].numpy()})


def _corrupt(path: Path, how: str) -> None:
    if how == "flipped byte":
        faults.flip_byte(str(path / "arrays.npz"), 64)
    elif how == "truncated arrays":
        faults.truncate_file(str(path / "arrays.npz"), 100)
    elif how == "truncated manifest":
        faults.truncate_file(str(path / "manifest.json"), 20)
    elif how == "missing manifest":
        os.unlink(path / "manifest.json")
    else:
        man = json.loads((path / "manifest.json").read_text())
        man["format_version"] = 1
        (path / "manifest.json").write_text(json.dumps(man))


@pytest.mark.parametrize("how", ["flipped byte", "truncated arrays",
                                 "truncated manifest", "missing manifest",
                                 "format version"])
def test_a_corrupt_snapshot_is_refused(tmp_path, how):
    ckpt.save_state(str(tmp_path), _state(0))
    assert ckpt.is_valid_checkpoint(str(tmp_path))
    _corrupt(tmp_path, how)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_state(str(tmp_path))
    with pytest.raises(ref_ckpt.CheckpointCorruptError):
        ref_ckpt.load_state(str(tmp_path))
    assert not ckpt.is_valid_checkpoint(str(tmp_path))


def test_round_checkpointer_cadence_keep_and_corrupt_skip(tmp_path):
    """``due`` every 2 rounds; ``keep=2`` prunes the oldest; a corrupt
    newest snapshot is skipped with a warning (the reference's
    checkpointer reads the port's directory the same way); with every
    snapshot corrupt, ``latest_good`` is ``None``."""
    ck = ckpt.RoundCheckpointer(str(tmp_path), every=2, keep=2)
    assert [r for r in range(6) if ck.due(r)] == [1, 3, 5]
    for r in (1, 3, 5):
        ck.save_round(r, {"r": np.int64(r)}, extra={"next_round": r + 1})
    assert ck.rounds_on_disk() == [3, 5]
    (tmp_path / "round_000007").mkdir()           # a kill before any file
    faults.flip_byte(os.path.join(ck.path_for(5), "arrays.npz"), 50)
    for checkpointer, warning in (
            (ck, ckpt.CheckpointCorruptWarning),
            (ref_ckpt.RoundCheckpointer(str(tmp_path)),
             ref_ckpt.CheckpointCorruptWarning)):
        with pytest.warns(warning) as caught:
            rnd, state, extra = checkpointer.latest_good()
        assert len(caught) == 2
        assert (rnd, int(state["r"]), extra) == (3, 3, {"next_round": 4})
    faults.flip_byte(os.path.join(ck.path_for(3), "arrays.npz"), 50)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ckpt.CheckpointCorruptWarning)
        assert ck.latest_good() is None
    with pytest.raises(ValueError, match="every"):
        ckpt.RoundCheckpointer(str(tmp_path), every=0)
    ck.clear()
    assert not tmp_path.exists()


PLANS = ["sigkill@checkpoint-saved:round=2;exit=7@mh-child-start:rank=1;"
         "overflow@resume", "", "  ;  ", "exit@group-done:index=0",
         "sigkill@round-done:round=1, extra = x"]
CONTEXTS = [("checkpoint-saved", {"round": 2}), ("round-done", {"round": 1}),
            ("round-done", {"round": 1, "extra": "x"}),
            ("group-done", {"index": 0}), ("resume", {}),
            ("round-done", {})]


def _fields(d):
    return (d.action, d.event, d.params, d.code)


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plans_parse_and_match_as_the_reference(plan):
    mine, theirs = faults.parse_plan(plan), ref_faults.parse_plan(plan)
    assert [_fields(d) for d in mine] == [_fields(d) for d in theirs]
    for event, ctx in CONTEXTS:
        assert ([d.matches(event, ctx) for d in mine]
                == [d.matches(event, ctx) for d in theirs])


@pytest.mark.parametrize("plan,match", [
    ("sigkill-no-event", "bad fault directive"),
    ("sigkill@round-done:novalue", "bad fault parameter")])
def test_malformed_plans_raise_as_the_reference(plan, match):
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match=match):
            mod.parse_plan(plan)


def test_active_switch_and_unmatched_fire(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.fire("round-done", round=0)
    assert not faults.active("overflow", "resume")
    monkeypatch.setenv(faults.ENV_VAR, "overflow@resume")
    for mod in (faults, ref_faults):
        assert mod.active("overflow", "resume")
        assert not mod.active("overflow", "round-done")
    faults.fire("round-done", round=0)    # a switch, not an action


_FIRE = ("from repro_torch.launch.faults import fire\n"
         "fire('round-done', round=2)\n"
         "print('SURVIVED')\n")


@pytest.mark.parametrize("plan,rc", [
    ("sigkill@round-done:round=2", -9), ("exit=7@round-done:round=2", 7),
    ("exit@round-done", 3), ("sigkill@round-done:round=3", 0)])
def test_terminal_actions_in_a_subprocess(plan, rc):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           faults.ENV_VAR: plan}
    out = subprocess.run([sys.executable, "-c", _FIRE], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == rc, out.stderr
    assert ("SURVIVED" in out.stdout) == (rc == 0)
    if rc:
        assert "injecting" in out.stderr


@pytest.mark.parametrize("argv", [["truncate", "F", "10"],
                                  ["flipbyte", "F", "5"]])
def test_faults_cli_corrupts_as_the_references(tmp_path, argv):
    payload = bytes(range(64))
    paths = []
    for mod, name in ((faults, "mine"), (ref_faults, "theirs")):
        path = tmp_path / name
        path.write_bytes(payload)
        assert mod.main([str(path) if a == "F" else a for a in argv]) == 0
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes() != payload


def test_faults_cli_check_and_usage(capsys):
    assert faults.main(["check", "sigkill@round-done:round=1"]) == 0
    assert "FaultDirective(action='sigkill'" in capsys.readouterr().out
    assert faults.main([]) == 2 == ref_faults.main([])
    assert faults.main(["explode"]) == 2


def test_resume_from_the_references_snapshot(tmp_path):
    """The reference runs rounds 0-2 with its ``RoundCheckpointer``.  A
    port simulation on the reference's draws restores the reference's
    round-1 snapshot (JAX keys and all: its draws are injected) and runs
    round 2: the integer columns and the mask equal, accuracy within
    0.01, the mean evaluation within 1e-3, the params within 1e-5 of the
    reference's after round 2.  A standalone port run refuses the
    snapshot: it would go on with other draws."""
    rcfg, cfg = _cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False))
    ref_ck = ref_ckpt.RoundCheckpointer(str(tmp_path))
    want = ref.run(3, checkpointer=ref_ck)
    state, extra = ckpt.load_state(ref_ck.path_for(1))
    assert "key" in state and extra["next_round"] == 2
    with pytest.raises(ValueError, match="PRNG base"):
        FLSimulation(cfg, device="cpu").restore_state(state, extra)
    port = FLSimulation(cfg, device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    port.restore_state(state, extra)
    rows = run_schedule(port, port, 3, overlap=False, start=2,
                        rows=[dict(r) for r in extra["rows"]])
    assert rows[:2] == want[:2]
    got, exp = rows[2], want[2]
    for key in ("round", "n_selected", "n_aggregated", "n_straggler",
                "n_active"):
        assert got[key] == exp[key], (key, got, exp)
    np.testing.assert_array_equal(port.last_mask, np.asarray(ref.last_mask))
    assert abs(got["accuracy"] - exp["accuracy"]) <= 0.01
    assert abs(got["mean_eval_selected"] - exp["mean_eval_selected"]) <= 1e-3
    np.testing.assert_array_equal(port.participation,
                                  np.asarray(ref.participation))
    mine, theirs = params_to_numpy(port.params), jax.device_get(ref.params)
    for name in mine:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(mine[name][leaf],
                                       np.asarray(theirs[name][leaf]),
                                       rtol=0, atol=1e-5)
    shutil.rmtree(tmp_path)
