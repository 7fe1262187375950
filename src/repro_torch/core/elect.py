"""Windowed DCS neighbour election on one device.

Alg. 1 only compares a vehicle against neighbours within
``comm_range``.  Sorted by road position, those neighbours form a
contiguous run of ranks (distance is linear ``|x_i - x_j|``), so a
window of ``W`` sorted neighbours per side covers every comparison that
can matter, and the cost drops from O(N^2) to O(N * W).

The result is exact or flagged: the counts apply the dense election's
predicate to the same fp32 values, and whenever the window could have
missed a comparison the dense election makes, ``overflow`` is raised
instead.  The round driver then re-runs the round through the dense
election, so a windowed mask is only ever used where it equals the
dense one.  Mirrors the single-device part of ``repro.core.elect``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

# far-away / below-threshold sentinels for padded slots (the dense
# kernel's padding convention)
SENT_POS = 1e18
SENT_EV = -1e18


def auto_window(n: int, comm_range: float, road_length: float) -> int:
    """Default sorted-neighbour window: 3x the expected one-side
    in-range population (uniform density) plus slack, clamped to the
    fleet.  Generous on purpose: an undersized window only costs a dense
    fallback, an oversized one only compares more zeros."""
    density = n / max(road_length, 1e-9)
    w = int(3.0 * comm_range * density) + 16
    return max(16, min(n, w))


def window_coverage(sp: torch.Tensor, se: torch.Tensor, sg: torch.Tensor,
                    *, comm_range: float, e_tau: float, n_valid: int,
                    window: int, need: torch.Tensor) -> torch.Tensor:
    """True iff every ``need`` entry's valid in-range neighbours all lie
    within ``window`` sorted slots, i.e. the windowed counts equal the
    dense ones.  The range bound widens by a position-scaled float
    margin, so boundary rounding can only over-flag (a spurious dense
    fallback), never under-flag (a wrong mask).

    As in the reference, the right-hand ``count_in`` clips an empty
    interval onto the last slot, so a last vehicle at or above ``e_tau``
    always flags when ``window < m - 1``; kept for flag parity with the
    reference (ROADMAP C5)."""
    m = sp.shape[0]
    dev = sp.device
    if window >= m - 1:
        return torch.ones((), dtype=torch.bool, device=dev)
    real = sg < n_valid
    span = torch.where(real, sp.abs(), torch.zeros((), device=dev)).max()
    cr = comm_range + 1e-5 * torch.clamp(span, min=1.0) + 1e-8    # fp32
    valid = real & (se >= torch.tensor(e_tau, dtype=torch.float32,
                                       device=dev))
    cum = torch.cumsum(valid.to(torch.int32), 0)

    def count_in(a, b):                       # valid entries in [a, b]
        a = a.clamp(0, m - 1)
        c = cum[b.clamp(0, m - 1)] - torch.where(
            a > 0, cum[(a - 1).clamp(min=0)], torch.zeros_like(cum[0]))
        return torch.where(b >= a, c, torch.zeros_like(c))

    idx = torch.arange(m, device=dev)
    lo = torch.searchsorted(sp, sp - cr, right=False)
    hi = torch.searchsorted(sp, sp + cr, right=True) - 1
    beyond = count_in(lo, idx - window - 1) + count_in(idx + window + 1, hi)
    return ~((beyond > 0) & need).any()


def sorted_window_counts(sp: torch.Tensor, se: torch.Tensor,
                         sg: torch.Tensor, *, comm_range: float,
                         e_tau: float, n_valid: int, window: int,
                         need: Optional[torch.Tensor] = None,
                         block: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Better-neighbour counts on a position-sorted candidate array.

    ``sp``/``se``/``sg``: (M,) sorted positions / evals / global ids.
    Pads to a multiple of the block with sentinels and counts through
    ``kernels/ops.py::windowed_counts``.  Returns ``(counts (M,) int32,
    covered () bool)``; ``covered`` certifies that the window saw every
    comparison the dense election makes for the ``need`` entries
    (default: every real entry), and then the counts equal the dense
    ones."""
    m = sp.shape[0]
    w = min(int(window), m)
    b = min(block, max(32, m))
    pad = -(-m // b) * b - m
    dev = sp.device
    spp = torch.cat([sp, torch.full((pad,), SENT_POS, device=dev)])
    sep = torch.cat([se, torch.full((pad,), SENT_EV, device=dev)])
    sgp = torch.cat([sg, torch.full((pad,), n_valid, dtype=torch.int32,
                                    device=dev)])
    counts = kops.windowed_counts(spp, sep, sgp, comm_range=comm_range,
                                  e_tau=e_tau, n_valid=n_valid, window=w,
                                  block=b)[:m]
    if need is None:
        need = sg < n_valid
    covered = window_coverage(sp, se, sg, comm_range=comm_range,
                              e_tau=e_tau, n_valid=n_valid, window=w,
                              need=need)
    return counts, covered


def windowed_elect(pos: torch.Tensor, evals: torch.Tensor, *,
                   comm_range: float, top_m: int, e_tau: float,
                   window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device windowed election: ``(mask (N,) int32, overflow ()
    int32)``.  ``overflow == 0`` certifies the mask equal to the dense
    election's; the caller falls back to the dense election otherwise."""
    n = pos.shape[0]
    order = torch.argsort(pos, stable=True)   # ties keep id order
    sp, se = pos[order], evals[order]
    sg = order.to(torch.int32)                # global id = the tie-break
    counts, covered = sorted_window_counts(
        sp, se, sg, comm_range=comm_range, e_tau=e_tau, n_valid=n,
        window=window, need=torch.ones(n, dtype=torch.bool,
                                       device=pos.device))
    et = torch.tensor(e_tau, dtype=torch.float32, device=pos.device)
    sel = ((se >= et) & (counts < top_m)).to(torch.int32)
    mask = torch.empty(n, dtype=torch.int32, device=pos.device)
    mask[order] = sel
    return mask, (~covered).to(torch.int32)
