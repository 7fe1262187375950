"""Client-selection schemes (paper §4.1/Fig. 1).

- ``dcs_select``        — the paper's contribution: each vehicle
  broadcasts its evaluation to DSRC neighbours (within ``comm_range``)
  iff it clears ``E_tau`` and elects itself iff it is in the top-m of
  its neighbourhood table (Alg. 1).
- ``dcs_select_windowed`` — the same election over a position-sorted
  window, with an overflow flag (``core/elect.py``).
- ``ccs_fuzzy_select``  — server-side global top-n on evaluations.
- ``ccs_random_select`` — server-side uniform pick; the draw itself is
  an input (``idx``), so the port and the reference can share it.

The multi-seed sweep selects S seeds at once: every scheme here takes
leading axes, each seed's mask its own (``dcs_select`` elects (S, N)
fleets in one kernel launch).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kops


def dcs_select(pos: torch.Tensor, evals: torch.Tensor, *,
               comm_range: float = 200.0, top_m: int = 2,
               e_tau: float = 30.0) -> torch.Tensor:
    """Distributed election -> int32 mask (..., N), 1 = self-elected;
    each leading index (a seed) is a fleet of its own."""
    return kops.neighbor_elect(pos, evals, comm_range=comm_range,
                               top_m=top_m, e_tau=e_tau)


def dcs_select_windowed(pos: torch.Tensor, evals: torch.Tensor, *,
                        comm_range: float = 200.0, top_m: int = 2,
                        e_tau: float = 30.0, window: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed distributed election: O(N * window) over a position-
    sorted sweep.  Returns ``(mask (N,) int32, overflow () int32)``; the
    mask equals ``dcs_select``'s whenever ``overflow == 0``, and the
    caller falls back to the dense election otherwise."""
    return kops.neighbor_elect_windowed(pos, evals, comm_range=comm_range,
                                        top_m=top_m, e_tau=e_tau,
                                        window=window)


def ccs_fuzzy_select(evals: torch.Tensor, n_clients: int) -> torch.Tensor:
    """Server-side top-n over the last axis -> int32 mask (..., N), each
    leading slice (a seed) its own.  Ties keep the lower index (as
    ``jax.lax.top_k`` does): a stable sort on ``-eval``, never
    ``torch.topk``, whose order among ties is unspecified."""
    n = evals.shape[-1]
    idx = torch.sort(-evals, dim=-1, stable=True).indices[
        ..., :min(n_clients, n)]
    mask = torch.zeros(evals.shape, dtype=torch.int32, device=evals.device)
    return mask.scatter_(-1, idx, 1)


def ccs_random_select(idx: torch.Tensor, n_participants: int
                      ) -> torch.Tensor:
    """Uniform server-side selection of the drawn indices ``idx`` (..., k)
    -> int32 mask (..., N)."""
    mask = torch.zeros(idx.shape[:-1] + (n_participants,),
                       dtype=torch.int32, device=idx.device)
    return mask.scatter_(-1, idx.long(), 1)


def selection_stats(mask: torch.Tensor, evals: torch.Tensor) -> dict:
    n_sel = mask.sum()
    return {
        "n_selected": n_sel,
        "mean_eval_selected": torch.where(
            n_sel > 0, (evals * mask).sum() / torch.clamp(n_sel, min=1),
            torch.zeros((), device=evals.device)),
    }
