"""Rank functions of ``test_torch_protocol.py`` and
``test_torch_multihost.py`` (the ranks that ``launch/mesh.py::spawn_ranks``
spawns import this module by name), and one host of a ``--multihost``
launch of them::

    python -m torch_multihost_ranks OUT.json [--rounds R] --multihost 2

re-executes itself as 2 processes (``launch/multihost.py``), which run
``world_rank`` on 4 CPU ranks (one intra-op thread each); process 0
writes every rank's results to ``OUT.json``.  It imports neither JAX
nor the reference.
"""
import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.fuzzy import FuzzyEvaluator
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.launch import mesh as client_mesh
from repro_torch.launch.multihost import (add_multihost_arguments,
                                          multihost_from_args, should_spawn,
                                          spawn_multihost)

WORLD = 4
SPAWN_TIMEOUT = 240.0


def protocol_rank(mesh, cases):
    """Each case (a dict: ``name``, ``kind`` of "dcs", "fuzzy" or
    "state", the global inputs and the protocol's options) on this
    rank: its block of the mask (``NAME.mask``) and each collective
    kind's output bytes (``NAME.bytes``)."""
    out = {}
    for c in cases:
        before = dict(mesh.collective_bytes)
        if c["kind"] == "dcs":
            fn = protocol.make_dcs_neighbor_exchange(
                mesh, comm_range=c["comm_range"], top_m=c["top_m"],
                e_tau=c["e_tau"], window=c["window"])
            mask = fn(protocol.shard(torch.tensor(c["pos"]), mesh),
                      protocol.shard(torch.tensor(c["evals"]), mesh))
        elif c["kind"] == "fuzzy":
            fn = protocol.make_ccs_fuzzy_gather(mesh, c["n_clients"])
            mask = fn(protocol.shard(torch.tensor(c["evals"]), mesh))
        else:
            states = torch.tensor(c["states"])
            fn = protocol.make_ccs_state_gather(
                mesh, FuzzyEvaluator(), c["n_clients"], states.shape[1])
            mask = fn(protocol.shard(states, mesh))
        out[f"{c['name']}.mask"] = mask.numpy()
        out[f"{c['name']}.bytes"] = {
            k: mesh.collective_bytes[k] - before[k] for k in before}
    return out


def small_config(n: int = 10) -> FLSimConfig:
    """The reference's 10-client multi-process parity config
    (``tests/test_multihost.py``)."""
    return FLSimConfig(
        scheme="dcs", n_rounds=2, local_epochs=1, samples_per_class=260,
        probe_samples=64, seed=0,
        partition=PartitionConfig(n_clients=n, big_clients=3,
                                  big_quantity=120, small_quantity=40,
                                  classes_per_client=9, seed=0),
        mobility=MobilityConfig(n_vehicles=n, seed=0))


def world_rank(mesh, rounds: int):
    """A psum and a ring shift over the world, then ``rounds`` selection
    prefixes of ``small_config`` under the windowed election (an
    overflowed round re-run dense, as the driver does): JSON values
    only, so that every rank's come back across hosts."""
    total = client_mesh.psum(mesh, torch.full((3,), float(mesh.rank + 1)))
    left = client_mesh.ring_shift(
        mesh, torch.tensor([mesh.rank], dtype=torch.int32), 1)
    sim = FLSimulation(small_config(), run=RunConfig(
        elect="windowed", mesh=f"clients={mesh.size}",
        multihost=mesh.hosts), mesh=mesh)
    masks = []
    for r in range(rounds):
        fields = sim.round_fields(r)
        host = sim.resolve_elect_overflow(
            r, sim._host(sim.selection_state(r, fields)), fields)
        masks.append(np.asarray(host["mask"]).tolist())
    return {"psum": total.tolist(), "left": int(left[0]), "masks": masks,
            "hosts": mesh.hosts, "backend": mesh.backend,
            "collective_bytes": dict(mesh.collective_bytes)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--rounds", type=int, default=2)
    add_multihost_arguments(ap)
    args = ap.parse_args(argv)
    if should_spawn(args):
        return spawn_multihost("torch_multihost_ranks",
                               sys.argv[1:] if argv is None else argv,
                               args.multihost)
    multihost = multihost_from_args(args)
    ranks = client_mesh.spawn_ranks(
        world_rank, WORLD, "cpu", args=(args.rounds,), threads=1,
        timeout=SPAWN_TIMEOUT, multihost=multihost)
    if multihost is None or multihost[2] == 0:
        with open(args.out, "w") as f:
            json.dump(ranks, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
