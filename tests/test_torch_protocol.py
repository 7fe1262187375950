"""The paper's three selection protocols (``core/protocol.py``) on the
port's client mesh against the reference's ``core/protocol.py`` on a
forced multi-device CPU mesh.

The reference's own tests see one device and never run the collective
path; here it runs once for the module, in a subprocess with
``--xla_force_host_platform_device_count=4`` (the protocols pass no
``check_rep``, so ROADMAP C1 does not stop them), at K = 2 and 4: every
case's mask and ``launch/hlo_cost.py``'s collective output bytes of one
device, and the server's evaluations of each state gather.  The port
runs every case on K spawned gloo ranks of the CPU, once for each K.
The inputs are drawn with numpy and shared.

Held: the DCS exchange and the fuzzy gather bit-equal to the
reference's masks, among them the two conditions of the reference that
part from the dense election (ROADMAP C16: at K = 2 the one neighbour
is heard from both sides and counted twice; a window shorter than the
vehicles in range misses some); the state gather's evaluations within
the plain Mamdani's 1e-4, its mask equal wherever the gap at the
n-th place exceeds that (the gap printed, C3); each rank's collective
bytes equal to the reference's HLO bytes of a device.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import protocol
from repro_torch.core.fuzzy import FuzzyEvaluator
from repro_torch.core.selection import ccs_fuzzy_select
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import ClientMesh, spawn_ranks
from torch_multihost_ranks import SPAWN_TIMEOUT, protocol_rank
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
KS = (2, 4)
TOP_M, E_TAU, N_CLIENTS = 2, 30.0, 5
EVAL_TOL = 1e-4          # the plain Mamdani against the reference's


def _cases(k: int):
    """The protocol cases at K = k: n = 16 k vehicles sorted along a
    1000 m road (seed 0's fleets show the reference's double count at
    K = 2 and its window miss at K = 4, ROADMAP C16)."""
    n = 16 * k
    rng = np.random.default_rng(0)
    pos = np.sort(rng.uniform(0, 1000, n)).astype(np.float32)
    evals = rng.uniform(0, 100, n).astype(np.float32)
    tied = rng.choice(np.array([20, 30, 30, 50, 50, 80], np.float32), n)
    local = min(150.0, 0.9 * 1000 / k)        # the reference test's range
    crossing = 1.25 * 1000 / k                # past the next block's end
    dcs = dict(kind="dcs", pos=pos, top_m=TOP_M, e_tau=E_TAU)
    cases = [
        dict(dcs, name="dcs local w0", evals=evals, comm_range=local,
             window=0),
        dict(dcs, name="dcs local w4", evals=evals, comm_range=local,
             window=4),
        dict(dcs, name="dcs local w8", evals=evals, comm_range=local,
             window=8),
        dict(dcs, name="dcs crossing w0", evals=evals, comm_range=crossing,
             window=0),
        dict(dcs, name="dcs ties w0", evals=tied, comm_range=local,
             window=0),
        dict(dcs, name="dcs ties w4", evals=tied, comm_range=local,
             window=4),
        dict(kind="fuzzy", name="fuzzy", evals=evals, n_clients=N_CLIENTS),
        dict(kind="fuzzy", name="fuzzy ties", evals=tied,
             n_clients=N_CLIENTS),
    ]
    for sd in (8, 25):
        cases.append(dict(kind="state", name=f"state sd{sd}",
                          states=rng.uniform(0, 1, (n, sd)).astype(
                              np.float32), n_clients=N_CLIENTS))
    return cases


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.fuzzy import FuzzyEvaluator
from repro.core.protocol import (make_ccs_fuzzy_gather,
                                 make_ccs_state_gather,
                                 make_dcs_neighbor_exchange)
from repro.kernels import ref as kref
from repro.launch import hlo_cost

out = {}
for k, path in json.loads(sys.argv[1]).items():
    mesh = Mesh(np.asarray(jax.devices()[:int(k)]), ("data",))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P("data")))
    z = np.load(path, allow_pickle=True)
    for c in z["cases"]:
        if c["kind"] == "dcs":
            fn = make_dcs_neighbor_exchange(
                mesh, comm_range=c["comm_range"], top_m=c["top_m"],
                e_tau=c["e_tau"], window=c["window"])
            args = (put(c["pos"]), put(c["evals"]))
            dense = kref.neighbor_elect_ref(
                jnp.asarray(c["pos"]), jnp.asarray(c["evals"]),
                comm_range=c["comm_range"], top_m=c["top_m"],
                e_tau=c["e_tau"])
        elif c["kind"] == "fuzzy":
            fn = make_ccs_fuzzy_gather(mesh, c["n_clients"])
            args = (put(c["evals"]),)
        else:
            fn = make_ccs_state_gather(mesh, FuzzyEvaluator(),
                                       c["n_clients"], c["states"].shape[1])
            args = (put(c["states"]),)
        jf = jax.jit(fn)
        res = {"mask": np.asarray(jf(*args)).tolist(),
               "bytes": hlo_cost.analyze(
                   jf.lower(*args).compile().as_text()).collective_bytes}
        if c["kind"] == "dcs":
            res["dense"] = np.asarray(dense).tolist()
        if c["kind"] == "state":
            res["evals"] = np.asarray(FuzzyEvaluator().evaluate(
                jnp.asarray(c["states"][:, :4]))).tolist()
        out[f"{k}/{c['name']}"] = res
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's results (one subprocess, 4 forced CPU devices)
    and the port's (one spawn of K gloo ranks for each K), by
    ``"K/case"``."""
    tmp = tmp_path_factory.mktemp("protocol")
    paths = {}
    for k in KS:
        paths[k] = str(tmp / f"cases{k}.npz")
        np.savez(paths[k], cases=np.asarray(_cases(k), dtype=object),
                 allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(paths)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        for k in KS:
            ranks = spawn_ranks(protocol_rank, k, "cpu", args=(_cases(k),),
                                threads=1, timeout=SPAWN_TIMEOUT,
                                workdir=tmp)
            for c in _cases(k):
                port[f"{k}/{c['name']}"] = dict(
                    mask=np.concatenate([r[f"{c['name']}.mask"]
                                         for r in ranks]),
                    bytes=[r[f"{c['name']}.bytes"] for r in ranks])
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, stderr[-4000:]
    line = next(x for x in stdout.splitlines() if x.startswith("REF"))
    return json.loads(line[3:]), port


def _ids():
    return [f"{k}/{c['name']}" for k in KS for c in _cases(k)]


def _case(key):
    k, name = key.split("/")
    return int(k), next(c for c in _cases(int(k)) if c["name"] == name)


@pytest.mark.parametrize("key", _ids())
def test_collective_bytes_are_the_references_hlo_bytes(results, key):
    """Each rank's output bytes, summed over the collective kinds, equal
    the reference's compiled HLO's for one device; the DCS exchange's are
    6 W x 4 (3 W x 4 at K = 2 with the whole block as the window), the
    fuzzy gather's N x 4, the state gather's N x state_dim x 4."""
    ref, port = results
    k, c = _case(key)
    n = 16 * k
    want = ref[key]["bytes"]
    for r, got in enumerate(port[key]["bytes"]):
        assert sum(got.values()) == want, (r, got, want)
    kind = {"dcs": "ring_shift", "fuzzy": "all_gather",
            "state": "all_gather"}[c["kind"]]
    assert all(b[kind] == want for b in port[key]["bytes"])
    if c["kind"] == "dcs":
        w = c["window"] or n // k
        sends = 3 if (k == 2 and w >= n // k) else 6
        assert want == sends * w * 4
    elif c["kind"] == "fuzzy":
        assert want == n * 4
    else:
        assert want == n * c["states"].shape[1] * 4


def test_the_references_byte_table(results):
    """The reference's bytes a device at 16 vehicles a shard: state
    gather (state_dim 8), fuzzy gather and DCS exchange (window 8)."""
    ref, _ = results
    got = [[ref[f"{k}/{name}"]["bytes"] for name in
            ("state sd8", "fuzzy", "dcs local w8")] for k in KS]
    assert got == [[1024, 128, 192], [2048, 256, 192]]


@pytest.mark.parametrize("key", [i for i in _ids() if "/state" not in i])
def test_dcs_and_fuzzy_masks_are_the_references(results, key):
    ref, port = results
    np.testing.assert_array_equal(port[key]["mask"],
                                  np.asarray(ref[key]["mask"]))


@pytest.mark.parametrize("key", ["2/dcs local w0", "4/dcs local w4"])
def test_the_references_conditions_part_from_the_dense_election(results,
                                                                key):
    """ROADMAP C16: at K = 2 with the whole block as the window the one
    neighbour counts twice; a window of 4 misses a vehicle in range.  The
    port's masks are the reference's there too (the test above), and
    differ from the dense election as the reference's do."""
    ref, port = results
    dense = np.asarray(ref[key]["dense"])
    assert (port[key]["mask"] != dense).sum() >= 1
    k, c = _case(key)
    np.testing.assert_array_equal(
        kref.neighbor_elect_ref(torch.tensor(c["pos"]),
                                torch.tensor(c["evals"]),
                                comm_range=c["comm_range"], top_m=TOP_M,
                                e_tau=E_TAU).numpy(), dense)


@pytest.mark.parametrize("key", [i for i in _ids() if "/state" in i])
def test_state_gather_evaluates_as_the_reference(results, key):
    """The server's evaluations within 1e-4 on [0, 100]; the mask equal
    to the reference's wherever the gap between the n-th and the
    (n+1)-th evaluation exceeds that (fp32 rounding could reorder a
    closer pair, ROADMAP C3), and always equal to the port's own top-n
    of the port's evaluations."""
    ref, port = results
    k, c = _case(key)
    want = np.asarray(ref[key]["evals"], np.float32)
    got = FuzzyEvaluator().evaluate(torch.tensor(c["states"][:, :4]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EVAL_TOL)
    top = np.sort(want)[::-1]
    margin = float(top[N_CLIENTS - 1] - top[N_CLIENTS])
    print(f"[{key}] gap at the {N_CLIENTS}th place {margin:.3g}")
    mine = np.zeros(len(want), np.int32)
    mine[np.argsort(-got.numpy(), kind="stable")[:N_CLIENTS]] = 1
    np.testing.assert_array_equal(port[key]["mask"], mine)
    if margin > EVAL_TOL:
        np.testing.assert_array_equal(port[key]["mask"],
                                      np.asarray(ref[key]["mask"]))


def test_top_k_ties_break_to_the_lower_index():
    """The gathers' server top-n (``core/selection.py::ccs_fuzzy_select``)
    keeps ``jax.lax.top_k``'s order among equal values: the lower index
    first, by a stable sort."""
    evals = torch.tensor([5.0, 9.0, 5.0, 9.0, 5.0, 1.0])
    assert ccs_fuzzy_select(evals, 3).tolist() == [1, 1, 0, 1, 0, 0]
    assert ccs_fuzzy_select(evals, 4).tolist() == [1, 1, 1, 1, 0, 0]


def test_one_rank_is_the_local_election():
    """K = 1: no neighbours, no collective; the local election is the
    dense one, and no bytes are counted."""
    mesh = ClientMesh(0, 1, torch.device("cpu"), "gloo")
    c = _cases(2)[0]
    got = protocol.make_dcs_neighbor_exchange(
        mesh, comm_range=c["comm_range"], top_m=TOP_M, e_tau=E_TAU)(
        torch.tensor(c["pos"]), torch.tensor(c["evals"]))
    want = kref.neighbor_elect_ref(torch.tensor(c["pos"]),
                                   torch.tensor(c["evals"]),
                                   comm_range=c["comm_range"], top_m=TOP_M,
                                   e_tau=E_TAU)
    assert torch.equal(got, want)
    assert sum(mesh.collective_bytes.values()) == 0


def test_participants_must_split_over_the_ranks():
    mesh = ClientMesh(1, 4, torch.device("cpu"), "gloo")
    assert protocol.shard(torch.arange(8), mesh).tolist() == [2, 3]
    with pytest.raises(ValueError, match="N % K != 0"):
        protocol.shard(torch.arange(10), mesh)
