"""Rank targets for ``tests/test_torch_mesh_pool.py``: importable by the
spawned gloo ranks without JAX or the reference (they see only the
port and what the test hands them: configs, draws, weights)."""
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch.fl import pipeline
from repro_torch.fl.rounds import FLSimulation
from repro_torch.launch.mesh import ClientMesh


def rank_jobs(mesh: ClientMesh, jobs: Sequence) -> Dict:
    """Run ``jobs`` (``(name, fn, args, kwargs)``) in order on this
    rank, each ``fn(mesh, *args, **kwargs)`` -> a dict, with a barrier
    between them (a job may read what rank 0 wrote in the one before);
    the results come back keyed ``name/key``."""
    out = {}
    for name, fn, args, kwargs in jobs:
        res = fn(mesh, *args, **kwargs)
        out.update({f"{name}/{key}": v for key, v in res.items()})
        dist.barrier()
    return out


def prefix_seeds_rank(mesh: ClientMesh, cfgs, run, fields, params,
                      rnd: int) -> Dict:
    """Round ``rnd``'s ``selection_prefix_seeds_sharded`` for one
    simulation a seed (``cfgs``), built on this rank, on the injected
    draws ``fields[i][rnd]`` and weights ``params[i]``: the rank's
    shards and the all-reduced counts."""
    sims = [FLSimulation(c, run=run, mesh=mesh,
                         fields=f.__getitem__) for c, f in zip(cfgs, fields)]
    st = pipeline.stack_statics([s.statics for s in sims])
    stacked = {k: torch.stack([torch.as_tensor(p[k]) for p in params])
               for k in params[0]}
    out = pipeline.selection_prefix_seeds_sharded(
        st, stacked, rnd, pipeline.stack_fields([s.round_fields(rnd)
                                                 for s in sims]),
        cfg=sims[0].stage_cfg, mesh=mesh)
    return {key: v.cpu().numpy() for key, v in out.items()}


def lookup_fields(table: Dict, seed: int):
    """A sweep ``fields_fn``: the injected draws of ``seed``."""
    return table[seed].__getitem__


def tiny_cell(scheme: str, classes: int, dist: str, seed: int):
    """``tests/test_torch_sweep.py::_tiny``: the reference's 10-client
    sweep profile (``tests/test_sweep.py``)."""
    from repro_torch.fl.mobility import MobilityConfig
    from repro_torch.fl.partition import PartitionConfig
    from repro_torch.fl.rounds import FLSimConfig
    return FLSimConfig(
        scheme=scheme, local_epochs=1, samples_per_class=260,
        probe_samples=64, seed=seed,
        partition=PartitionConfig(n_clients=10, big_clients=3,
                                  big_quantity=120, small_quantity=40,
                                  classes_per_client=classes, seed=seed),
        mobility=MobilityConfig(n_vehicles=10, distribution=dist,
                                seed=seed))
