"""Dispatch over the selection path's kernels by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a
CUDA tensor goes to the hand-written kernel, or the call raises.  There
is no environment switch and no fallback: a kernel that fails to build
or launch raises, and never hands its work to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _rules_on(t: torch.Tensor, rule_table, rule_levels):
    return (torch.as_tensor(np.asarray(rule_table), device=t.device),
            torch.as_tensor(np.asarray(rule_levels), device=t.device))


def fuzzy_eval(x: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
               rule_table: np.ndarray, rule_levels: np.ndarray,
               level_centers: torch.Tensor,
               normalize: bool = False) -> torch.Tensor:
    """Mamdani evaluation (P, 4) -> (P,); ``normalize=True`` takes raw
    columns and applies Eq. 8 first."""
    if _on_cuda(x):
        from repro_torch.kernels.fuzzy_eval import fuzzy_eval_cuda
        return fuzzy_eval_cuda(x, means, sigmas, rule_table, rule_levels,
                               level_centers, normalize=normalize)
    return ref.fuzzy_eval_ref(x, means, sigmas,
                              *_rules_on(x, rule_table, rule_levels),
                              level_centers, normalize=normalize)


def probe_fuzzy(params, images, labels, seg, counts, aux, means, sigmas,
                rule_table: np.ndarray, rule_levels: np.ndarray,
                level_centers, *, n_clients: int,
                col_maxima: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused selection fast path: packed Eq. 7 probe samples ->
    ``(feats (N, 4) raw, evals (N,))``."""
    if _on_cuda(images):
        from repro_torch.kernels.probe_fuzzy import probe_fuzzy_cuda
        return probe_fuzzy_cuda(params, images, labels, seg, counts, aux,
                                means, sigmas, rule_table, rule_levels,
                                level_centers, n_clients=n_clients,
                                col_maxima=col_maxima)
    return ref.probe_fuzzy_ref(params, images, labels, seg, counts, aux,
                               means, sigmas,
                               *_rules_on(images, rule_table, rule_levels),
                               level_centers, n_clients=n_clients,
                               col_maxima=col_maxima)


def neighbor_elect(pos: torch.Tensor, evals: torch.Tensor, *,
                   comm_range: float, top_m: int,
                   e_tau: float) -> torch.Tensor:
    """Dense DCS election -> int32 mask (N,)."""
    if _on_cuda(pos):
        from repro_torch.kernels.neighbor_elect import neighbor_elect_cuda
        return neighbor_elect_cuda(pos, evals, comm_range=comm_range,
                                   top_m=top_m, e_tau=e_tau)
    return ref.neighbor_elect_ref(pos, evals, comm_range=comm_range,
                                  top_m=top_m, e_tau=e_tau)


def windowed_counts(sp: torch.Tensor, se: torch.Tensor, sg: torch.Tensor,
                    *, comm_range: float, e_tau: float, n_valid: int,
                    window: int, block: int) -> torch.Tensor:
    """Windowed better-neighbour counts over position-sorted (M,) arrays
    padded to a multiple of ``block`` -> (M,) int32."""
    kw = dict(comm_range=comm_range, e_tau=e_tau, n_valid=n_valid,
              window=window, block=block)
    if _on_cuda(sp):
        from repro_torch.kernels.windowed_counts import windowed_counts_cuda
        return windowed_counts_cuda(sp, se, sg, **kw)
    return ref.windowed_counts_ref(sp, se, sg, **kw)


def neighbor_elect_windowed(pos: torch.Tensor, evals: torch.Tensor, *,
                            comm_range: float, top_m: int, e_tau: float,
                            window: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(N * W) windowed DCS election -> ``(mask (N,) int32, overflow ()
    int32)``; ``overflow == 0`` certifies the mask equal to
    ``neighbor_elect``'s.  The counting sweep goes through
    ``windowed_counts``."""
    from repro_torch.core.elect import windowed_elect
    return windowed_elect(pos, evals, comm_range=comm_range, top_m=top_m,
                          e_tau=e_tau, window=window)
