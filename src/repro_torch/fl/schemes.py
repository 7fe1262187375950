"""Client-selection scheme registry (paper Alg. 1 step 4, pluggable).

A scheme is a name bound to a selection function ``(cfg: StageConfig,
pos (..., N), evals (..., N), fields: RoundFields) -> (..., N) int32
mask``: a leading axis is the sweep's seeds (``fields`` then stacked
alike), each seed's mask equal to a call on that seed alone.
``fields`` carries the round's random draws (``random_idx`` for the
uniform scheme).  ``overhead_key`` names the scheme's §4.2
accumulated-time model in ``core/overhead.py`` (``"cfl"``: classical
full state to the cloud; ``"ccs-fuzzy"``: evaluations to the cloud;
``"dcs"``: evaluations to neighbours over DSRC).

``select_windowed(cfg, pos, evals, fields) -> (mask, overflow)`` is a
scheme's optional O(N * W) position-sorted form (``core/elect.py``);
``overflow`` non-zero means the window could not hold every comparison
of ``select`` and the round driver re-runs the round through
``select``.  Only ``dcs`` has one.

``select_sharded(cfg, ctx, pos, evals, fields) -> (mask, overflow) or
None`` is a scheme's form on one rank of the client mesh: ``ctx`` is the
rank's ``ShardCtx``, ``pos``/``evals`` its (shard_n,) shard, the mask
its shard of the round's.  None sends the sharded prefix to the gather
seam (every rank gathers the (N,) vectors and runs ``select``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import elect as celect
from repro_torch.core.selection import (ccs_fuzzy_select, ccs_random_select,
                                        dcs_select, dcs_select_windowed)
from repro_torch.launch.mesh import ClientMesh

SelectFn = Callable[[Any, torch.Tensor, torch.Tensor, Any], torch.Tensor]
WindowedFn = Callable[[Any, torch.Tensor, torch.Tensor, Any],
                      Tuple[torch.Tensor, torch.Tensor]]
ShardedFn = Callable[..., Optional[Tuple[torch.Tensor, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """One rank's context for ``select_sharded``: ``gid``/``valid`` are
    the rank's (shard_n,) global client ids and real-client mask
    (padding slots are invalid); ``pad`` is the global padding
    ``n_shards * shard_n - n``."""
    mesh: ClientMesh
    n: int
    n_shards: int
    shard_n: int
    pad: int
    gid: torch.Tensor
    valid: torch.Tensor

    def mine(self, full: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """This rank's clients of a global (..., N) tensor; padding
        slots hold ``fill``."""
        lo = self.mesh.rank * self.shard_n
        full = torch.nn.functional.pad(full.to(self.gid.device),
                                       (0, self.pad), value=fill)
        return full[..., lo:lo + self.shard_n]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One registered selection scheme."""
    name: str
    select: SelectFn
    overhead_key: str             # core/overhead.py accumulated-time key
    select_windowed: Optional[WindowedFn] = None
    select_sharded: Optional[ShardedFn] = None


_REGISTRY: Dict[str, Scheme] = {}


def register_scheme(name: str, fn: SelectFn, *,
                    overhead_key: str = "ccs-fuzzy",
                    select_windowed: Optional[WindowedFn] = None,
                    select_sharded: Optional[ShardedFn] = None) -> Scheme:
    """Register ``fn`` as selection scheme ``name``; re-registering an
    existing name raises."""
    if not name or not isinstance(name, str):
        raise ValueError(f"scheme name must be a non-empty str: {name!r}")
    if name in _REGISTRY:
        raise ValueError(f"scheme {name!r} is already registered")
    scheme = Scheme(name=name, select=fn, overhead_key=overhead_key,
                    select_windowed=select_windowed,
                    select_sharded=select_sharded)
    _REGISTRY[name] = scheme
    return scheme


def get_scheme(name: str) -> Scheme:
    """Look up a registered scheme; unknown names raise with the list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown selection scheme {name!r} "
            f"(registered: {', '.join(scheme_names())})") from None


def scheme_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def elect_window(cfg) -> int:
    """The config's sorted-neighbour window (0 = auto-sized)."""
    return cfg.elect_window or celect.auto_window(
        cfg.n_clients, cfg.comm_range_m, cfg.road_length_m)


def elect_capacity(cfg, shard_n: int, n_shards: int) -> int:
    """The config's per-(rank -> segment) bucket capacity (0 = auto)."""
    return cfg.elect_capacity or celect.auto_capacity(shard_n, n_shards)


def _dcs(cfg, pos, evals, fields):
    return dcs_select(pos, evals, comm_range=cfg.comm_range_m,
                      top_m=cfg.top_m, e_tau=cfg.e_tau)


def _dcs_windowed(cfg, pos, evals, fields):
    return dcs_select_windowed(pos, evals, comm_range=cfg.comm_range_m,
                               top_m=cfg.top_m, e_tau=cfg.e_tau,
                               window=elect_window(cfg))


def _dcs_sharded(cfg, ctx, pos, evals, fields):
    k = ctx.n_shards
    if k < 2:
        return None
    hops = celect.ring_hops(cfg.comm_range_m, cfg.road_length_m, k)
    if 2 * hops + 1 > k:
        return None                # the halo ring would lap itself
    return celect.ring_halo_elect(
        pos, evals, ctx.gid, ctx.valid, mesh=ctx.mesh, n=ctx.n,
        n_shards=k, shard_n=ctx.shard_n, comm_range=cfg.comm_range_m,
        top_m=cfg.top_m, e_tau=cfg.e_tau, road_length=cfg.road_length_m,
        window=elect_window(cfg),
        capacity=elect_capacity(cfg, ctx.shard_n, k))


def _ccs_fuzzy(cfg, pos, evals, fields):
    return ccs_fuzzy_select(evals, cfg.n_clients_central)


def _ccs_fuzzy_sharded(cfg, ctx, pos, evals, fields):
    if ctx.n_shards < 2:
        return None
    mask = celect.sharded_topk_mask(
        evals, ctx.gid, ctx.valid, mesh=ctx.mesh, n=ctx.n,
        shard_n=ctx.shard_n, k_top=min(cfg.n_clients_central, ctx.n))
    return mask, torch.zeros((), dtype=torch.int32, device=evals.device)


def _ccs_random(cfg, pos, evals, fields):
    return ccs_random_select(fields.random_idx.to(evals.device),
                             cfg.n_clients)


def _ccs_random_sharded(cfg, ctx, pos, evals, fields):
    # the draw is an input: every rank builds the whole mask (N bits, no
    # collective) and keeps its slice
    mask = ctx.mine(_ccs_random(cfg, pos, evals, fields))
    return mask, torch.zeros((), dtype=torch.int32, device=evals.device)


register_scheme("dcs", _dcs, overhead_key="dcs",
                select_windowed=_dcs_windowed, select_sharded=_dcs_sharded)
register_scheme("ccs-fuzzy", _ccs_fuzzy, overhead_key="ccs-fuzzy",
                select_sharded=_ccs_fuzzy_sharded)
register_scheme("random", _ccs_random, overhead_key="cfl",
                select_sharded=_ccs_random_sharded)
