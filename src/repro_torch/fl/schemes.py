"""Client-selection scheme registry (paper Alg. 1 step 4, pluggable).

A scheme is a name bound to a selection function ``(cfg: StageConfig,
pos (N,), evals (N,), fields: RoundFields) -> (N,) int32 mask``.
``fields`` carries the round's random draws (``random_idx`` for the
uniform scheme).  The §4.2 communication-accounting key of
``repro.fl.schemes`` comes with the accounting (ROADMAP A12).

``select_windowed(cfg, pos, evals, fields) -> (mask, overflow)`` is a
scheme's optional O(N * W) position-sorted form (``core/elect.py``);
``overflow`` non-zero means the window could not hold every comparison
of ``select`` and the round driver re-runs the round through
``select``.  Only ``dcs`` has one.  The sharded forms
(``select_sharded``) of ``repro.fl.schemes`` come with the client mesh
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.elect import auto_window
from repro_torch.core.selection import (ccs_fuzzy_select, ccs_random_select,
                                        dcs_select, dcs_select_windowed)

SelectFn = Callable[[Any, torch.Tensor, torch.Tensor, Any], torch.Tensor]
WindowedFn = Callable[[Any, torch.Tensor, torch.Tensor, Any],
                      Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One registered selection scheme."""
    name: str
    select: SelectFn
    select_windowed: Optional[WindowedFn] = None


_REGISTRY: Dict[str, Scheme] = {}


def register_scheme(name: str, fn: SelectFn, *,
                    select_windowed: Optional[WindowedFn] = None) -> Scheme:
    """Register ``fn`` as selection scheme ``name``; re-registering an
    existing name raises."""
    if not name or not isinstance(name, str):
        raise ValueError(f"scheme name must be a non-empty str: {name!r}")
    if name in _REGISTRY:
        raise ValueError(f"scheme {name!r} is already registered")
    scheme = Scheme(name=name, select=fn, select_windowed=select_windowed)
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
    return cfg.elect_window or auto_window(cfg.n_clients, cfg.comm_range_m,
                                           cfg.road_length_m)


def _dcs(cfg, pos, evals, fields):
    return dcs_select(pos, evals, comm_range=cfg.comm_range_m,
                      top_m=cfg.top_m, e_tau=cfg.e_tau)


def _dcs_windowed(cfg, pos, evals, fields):
    return dcs_select_windowed(pos, evals, comm_range=cfg.comm_range_m,
                               top_m=cfg.top_m, e_tau=cfg.e_tau,
                               window=elect_window(cfg))


def _ccs_fuzzy(cfg, pos, evals, fields):
    return ccs_fuzzy_select(evals, cfg.n_clients_central)


def _ccs_random(cfg, pos, evals, fields):
    return ccs_random_select(fields.random_idx.to(evals.device),
                             cfg.n_clients)


register_scheme("dcs", _dcs, select_windowed=_dcs_windowed)
register_scheme("ccs-fuzzy", _ccs_fuzzy)
register_scheme("random", _ccs_random)
