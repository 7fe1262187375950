"""Plain PyTorch versions of the selection path's kernels.

Direct transcriptions of ``repro.kernels.ref`` — the yardstick the CUDA
kernels are held against on the card, and what ``kernels/ops.py`` runs
for a tensor on the CPU.  Sums over clients go through a one-hot matmul
(never float atomics), so every result here is run-to-run deterministic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.fl.client import dataset_loss_packed

NUM_OUT = 9


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an fp32 scalar on ``like``'s device: comparisons
    against it happen in fp32, as JAX's weakly typed floats do."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fuzzy_eval_ref(x: torch.Tensor, means: torch.Tensor,
                   sigmas: torch.Tensor, rule_table: torch.Tensor,
                   rule_levels: torch.Tensor, level_centers: torch.Tensor,
                   normalize: bool = False) -> torch.Tensor:
    """Mamdani inference: x (P, 4) in [0, 1] -> evaluations (P,).

    Gaussian memberships (4 variables x 3 levels), min-conjunction over
    the 81 rules, max-aggregation per output level, COG over the level
    centers.  ``normalize=True`` takes raw columns and applies Eq. 8
    (x / column max, clipped to [0, 1]) first."""
    if normalize:                                            # Eq. 8
        maxima = torch.clamp(x.max(dim=0).values, min=1e-9)
        x = torch.clamp(x / maxima, 0.0, 1.0)
    d = (x[..., :, None] - means) / sigmas
    mu = torch.exp(-0.5 * d * d)                             # (P, V, 3)
    table = rule_table.to(x.device).long()                   # (R, V)
    levels = rule_levels.to(x.device).long()                 # (R,)
    v = torch.arange(table.shape[1], device=x.device)
    firing = mu[:, v[None, :], table].min(dim=-1).values     # (P, R)
    beta = torch.stack([firing[:, levels == j].max(dim=1).values
                        for j in range(NUM_OUT)], dim=1)     # (P, 9)
    num = (beta * level_centers).sum(-1)
    den = torch.clamp(beta.sum(-1), min=1e-9)
    return num / den


def probe_loss_ref(params, images: torch.Tensor, labels: torch.Tensor,
                   seg: torch.Tensor, counts: torch.Tensor, n_clients: int,
                   chunk: int = 4096) -> torch.Tensor:
    """Eq. 7 over a packed sample tensor -> (N,) mean losses: the
    unfused prefix's probe (``fl/client.py::dataset_loss_packed``) in
    forward passes of ``chunk`` samples, which bounds memory and does
    not change the arithmetic per sample."""
    return dataset_loss_packed(params, images, labels, seg, counts,
                               n_clients, batch=chunk)


def probe_fuzzy_ref(params, images, labels, seg, counts, aux, means,
                    sigmas, rule_table, rule_levels, level_centers,
                    n_clients: int,
                    col_maxima: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection hot path in one transcription: Eq. 7 probe -> raw
    features [SQ, TA, CC, LF] -> Eq. 8 (in-batch maxima or external
    ``col_maxima`` (4,)) -> Mamdani.  Returns ``(feats (N, 4), evals)``."""
    lf = probe_loss_ref(params, images, labels, seg, counts, n_clients)
    feats = torch.cat([aux.float(), lf[:, None]], dim=1)
    if col_maxima is None:
        return feats, fuzzy_eval_ref(feats, means, sigmas, rule_table,
                                     rule_levels, level_centers,
                                     normalize=True)
    x = torch.clamp(feats / torch.clamp(col_maxima, min=1e-9), 0.0, 1.0)
    return feats, fuzzy_eval_ref(x, means, sigmas, rule_table, rule_levels,
                                 level_centers)


def neighbor_elect_ref(pos: torch.Tensor, evals: torch.Tensor, *,
                       comm_range: float, top_m: int, e_tau: float,
                       rows: int = 4096) -> torch.Tensor:
    """Dense DCS election (paper Alg. 1): vehicle i is selected iff
    eval_i >= E_tau and fewer than ``top_m`` in-range vehicles at or
    above E_tau are strictly better (lower index wins ties).  All
    comparisons in fp32.  Returns int32 (N,) 0/1; ``rows`` bounds the
    memory of one block of the (N, N) comparison."""
    n = pos.shape[0]
    cr, et = _f32(comm_range, pos), _f32(e_tau, pos)
    idx = torch.arange(n, device=pos.device)
    cand = evals[None, :] >= et
    out = []
    for s in range(0, n, rows):
        pi, ei, ii = pos[s:s + rows, None], evals[s:s + rows, None], \
            idx[s:s + rows, None]
        valid = (torch.abs(pi - pos[None, :]) <= cr) & cand
        better = (evals[None, :] > ei) | ((evals[None, :] == ei)
                                          & (idx[None, :] < ii))
        out.append((valid & better).sum(dim=1))
    n_better = torch.cat(out)
    return ((evals >= et) & (n_better < top_m)).to(torch.int32)


def windowed_counts_ref(sp: torch.Tensor, se: torch.Tensor,
                        sg: torch.Tensor, *, comm_range: float,
                        e_tau: float, n_valid: int, window: int,
                        block: int) -> torch.Tensor:
    """Better-neighbour counts over position-sorted (M,) arrays padded to
    a multiple of ``block`` (sentinels pos 1e18 / ev -1e18 / id >=
    ``n_valid``) -> (M,) int32.

    The candidate set is the Pallas kernel's, block-granular: row block
    ``ib`` visits candidate blocks ``[ib - hops, ib + hops]`` clipped to
    the array, ``hops = ceil(window / block)``, each once.  It is wider
    than ``window`` ranks; the two agree wherever ``window_coverage``
    certifies the window."""
    m = sp.shape[0]
    nb = m // block
    hops = min(-(-int(window) // block), max(nb - 1, 0))
    cr, et = _f32(comm_range, sp), _f32(e_tau, sp)
    p, e, g = (t.reshape(nb, block) for t in (sp, se, sg))
    ib = torch.arange(nb, device=sp.device)
    counts = torch.zeros(nb, block, dtype=torch.int32, device=sp.device)
    for off in range(-hops, hops + 1):
        tgt = ib + off
        inb = ((tgt >= 0) & (tgt < nb))[:, None, None]
        tc = tgt.clamp(0, nb - 1)
        pj, ej, gj = p[tc][:, None, :], e[tc][:, None, :], g[tc][:, None, :]
        pi, ei, gi = p[:, :, None], e[:, :, None], g[:, :, None]
        ok = (torch.abs(pi - pj) <= cr) & (ej >= et) & (gj < n_valid)
        better = (ej > ei) | ((ej == ei) & (gj < gi))
        counts += (ok & better & inb).sum(dim=2, dtype=torch.int32)
    return counts.reshape(m)


def windowed_elect_ref(pos: torch.Tensor, evals: torch.Tensor, *,
                       comm_range: float, top_m: int, e_tau: float,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle of the windowed election's contract (tests only):
    ``(mask, overflow)`` with the dense election's mask, and ``overflow``
    1 iff some vehicle has a valid in-range neighbour more than
    ``window`` position-sorted ranks away.  A windowed election must give
    this mask wherever its own flag is 0, and flag wherever this one
    flags."""
    n = pos.shape[0]
    mask = neighbor_elect_ref(pos, evals, comm_range=comm_range,
                              top_m=top_m, e_tau=e_tau)
    order = torch.argsort(pos, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=pos.device)
    rank[order] = torch.arange(n, device=pos.device)
    validc = ((torch.abs(pos[:, None] - pos[None, :])
               <= _f32(comm_range, pos))
              & (evals[None, :] >= _f32(e_tau, pos)))
    far = torch.abs(rank[:, None] - rank[None, :]) > window
    return mask, (validc & far).any().to(torch.int32)
