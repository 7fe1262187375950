"""Windowed DCS neighbour election, on one device and over the client
mesh.

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
dense one.

Three layers share the core, as in ``repro.core.elect``:

- ``windowed_elect``: one device: sort, windowed counts, scatter back;
- ``ring_halo_elect``: one rank of the client mesh: re-bucket clients
  into road-segment ranks with one tiled all-to-all, exchange boundary
  halo strips with the ``h`` adjacent ranks over a ring, elect on own
  plus halo candidates, route each bit back with the inverse
  all-to-all;
- ``sharded_topk_mask``: the CCS quota as a hierarchical top-k (local
  top-k, gather K*k candidates, global top-k), exact with ties.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (ClientMesh, all_gather, all_to_all,
                                    ring_shift)

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
    valid = real & (se >= _f32(e_tau, se))
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
    et = _f32(e_tau, pos)
    sel = ((se >= et) & (counts < top_m)).to(torch.int32)
    mask = torch.empty(n, dtype=torch.int32, device=pos.device)
    mask[order] = sel
    return mask, (~covered).to(torch.int32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as an fp32 scalar: arithmetic with it rounds in
    fp32, as JAX's weakly typed floats do.  A fill on the device, not an
    upload, so it does not wait for the card."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def auto_capacity(shard_n: int, n_shards: int) -> int:
    """Per-(source rank -> road segment) bucket capacity: 2x the uniform
    expectation plus slack.  Clustered fleets can exceed it; that raises
    the overflow flag, never a wrong mask."""
    return min(shard_n, 2 * (-(-shard_n // n_shards)) + 16)


def ring_hops(comm_range: float, road_length: float, n_shards: int) -> int:
    """Adjacent-segment hops whose span covers ``comm_range``."""
    segw = road_length / n_shards
    return max(1, int(math.ceil(comm_range / segw)))


def _pack(*parts: torch.Tensor) -> torch.Tensor:
    """fp32 and int32 tensors of one shape stacked as fp32 bits, so that
    one collective carries them (ids are reinterpreted, not converted)."""
    return torch.stack([p if p.dtype == torch.float32
                        else p.view(torch.float32) for p in parts])


def ring_halo_elect(pos: torch.Tensor, evals: torch.Tensor,
                    gid: torch.Tensor, valid: torch.Tensor, *,
                    mesh: ClientMesh, n: int, n_shards: int, shard_n: int,
                    comm_range: float, top_m: int, e_tau: float,
                    road_length: float, window: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windowed DCS election on one rank of the client mesh, which
    owns road segment ``mesh.rank``:

    1. route every local client to its segment's rank with one tiled
       all-to-all of fixed ``(K, capacity)`` buffers (slot overflow ->
       flag);
    2. sort the received bucket by position; pull ``h`` boundary halo
       strips of width ``window`` from each ring neighbour (strip
       overflow -> flag; strips that would wrap the road end are empty,
       since road distance is linear);
    3. merge own and halo candidates, windowed counts (coverage
       shortfall -> flag), elect;
    4. the inverse all-to-all routes each client's bit back to its
       owner's slot.

    Returns ``(mask (shard_n,) int32, overflow () int32)``, the flag this
    rank's own; callers all-reduce it with max.  A zero flag on every
    rank certifies the masks equal to the dense election's.  Thresholds
    round in fp32 as the reference's do, so a vehicle on a segment edge
    lands in the same bucket."""
    k = n_shards
    segw = road_length / k
    h = ring_hops(comm_range, road_length, k)
    cap = capacity
    w = min(int(window), k * cap)
    i = mesh.rank
    dev = pos.device
    # float-safety margin for the segment-boundary thresholds: widening
    # only adds candidates (masked later by the exact distance compare)
    margin = 1e-4 * road_length + 1e-6

    # -- 1. bucket clients by road segment, fixed (K, cap) send slots --
    seg = torch.clamp(torch.floor(pos * _f32(k / road_length, pos)),
                      0, k - 1).to(torch.int32)
    seg = torch.where(valid, seg, k)                     # dummies drop
    order = torch.argsort(seg, stable=True)
    sseg = seg[order]
    starts = torch.searchsorted(
        sseg, torch.arange(k, dtype=torch.int32, device=dev))
    rank = (torch.arange(shard_n, device=dev)
            - starts[sseg.clamp(0, k - 1).long()])
    kept = (sseg < k) & (rank < cap)
    send_ovf = ((sseg < k) & (rank >= cap)).any()
    row = torch.where(kept, sseg.long(), k)              # row k: dropped
    col = rank.clamp(0, cap - 1)

    def scatter(x: torch.Tensor, fill) -> torch.Tensor:
        buf = torch.full((k + 1, cap), fill, dtype=x.dtype, device=dev)
        buf[row, col] = x[order]
        return buf[:k]

    sent = _pack(scatter(pos.float(), SENT_POS),
                 scatter(evals.float(), SENT_EV),
                 scatter(gid.to(torch.int32), n)).transpose(0, 1)
    recv = all_to_all(mesh, sent.contiguous())           # (K, 3, cap)

    # -- 2. sort my segment's bucket, exchange halo strips -------------
    s = k * cap
    fpos, fev = recv[:, 0].reshape(s), recv[:, 1].reshape(s)
    fgid = recv[:, 2].reshape(s).view(torch.int32)
    border = torch.argsort(fpos, stable=True)
    sp, se, sg = fpos[border], fev[border], fgid[border]
    n_real = torch.searchsorted(sp, _f32(SENT_POS / 2.0, sp).reshape(1))[0]
    lanes = torch.arange(w, device=dev)
    empty = (torch.full((w,), SENT_POS, device=dev),
             torch.full((w,), SENT_EV, device=dev),
             torch.full((w,), n, dtype=torch.int32, device=dev))

    def pick(j: torch.Tensor, ok: torch.Tensor):
        return tuple(torch.where(ok, z[j], e) for z, e in zip((sp, se, sg),
                                                              empty))

    def suffix_strip(thr: torch.Tensor):
        """My clients with pos >= thr (capped at ``w``, overflow-flagged)."""
        start = torch.searchsorted(sp, thr.reshape(1))[0]
        cnt = torch.clamp(n_real - start, min=0)
        base = torch.clamp(torch.clamp(start, max=s - w), 0, s - w)
        j = base + lanes
        return pick(j, (j >= start) & (j < n_real)), cnt > w

    def prefix_strip(thr: torch.Tensor):
        """My clients with pos <= thr (capped at ``w``, overflow-flagged)."""
        end = torch.clamp(torch.searchsorted(sp, thr.reshape(1),
                                             right=True)[0], max=n_real)
        return pick(lanes, lanes < end), end > w

    def edge(j: int, sign: float) -> torch.Tensor:
        """j * segw + sign * comm_range + sign * margin, each step in
        fp32."""
        t = _f32(j, sp) * _f32(segw, sp)
        return (t + sign * _f32(comm_range, sp)) + sign * _f32(margin, sp)

    strips = []
    strip_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for d in range(1, h + 1):
        # strip for rank i+d: my suffix within comm_range of its left
        # edge; a wrapped receiver (linear road) gets nothing
        rj = i + d
        thr = _f32(SENT_POS, sp) if rj >= k else edge(rj, -1.0)
        part, so = suffix_strip(thr)
        strip_ovf |= so
        strips.append(ring_shift(mesh, _pack(*part), d))
        # strip for rank i-d: my prefix within comm_range of its right
        # edge
        lj = i - d
        thr = _f32(-SENT_POS, sp) if lj < 0 else edge(lj + 1, 1.0)
        part, so = prefix_strip(thr)
        strip_ovf |= so
        strips.append(ring_shift(mesh, _pack(*part), -d))

    # -- 3. merge own + halo candidates, windowed election -------------
    mpos = torch.cat([sp] + [st[0] for st in strips])
    mev = torch.cat([se] + [st[1] for st in strips])
    mgid = torch.cat([sg] + [st[2].contiguous().view(torch.int32)
                             for st in strips])
    tag = torch.cat([torch.arange(s, device=dev),
                     torch.full((2 * h * w,), s, device=dev)])
    morder = torch.argsort(mpos, stable=True)
    msp, mse, msg, mtag = (mpos[morder], mev[morder], mgid[morder],
                           tag[morder])
    counts, covered = sorted_window_counts(
        msp, mse, msg, comm_range=comm_range, e_tau=e_tau, n_valid=n,
        window=w, need=(mtag < s) & (msg < n))
    sel = ((mse >= _f32(e_tau, mse)) & (counts < top_m)
           & (msg < n)).to(torch.int32)

    # -- 4. scatter back: merged -> bucket slots -> inverse a2a --------
    sel_sorted = torch.zeros(s + 1, dtype=torch.int32, device=dev)
    sel_sorted[mtag] = sel                    # halo entries: spare slot s
    sel_bucket = torch.zeros(s, dtype=torch.int32, device=dev)
    sel_bucket[border] = sel_sorted[:s]
    back = all_to_all(mesh, sel_bucket.reshape(k, cap))  # an involution
    got = torch.where(row < k, back[row.clamp(max=k - 1), col], 0)
    mask = torch.zeros(shard_n, dtype=torch.int32, device=dev)
    mask[order] = got.to(torch.int32)
    ovf = (send_ovf | strip_ovf | ~covered).to(torch.int32)
    return mask, ovf


def sharded_topk_mask(evals: torch.Tensor, gid: torch.Tensor,
                      valid: torch.Tensor, *, mesh: ClientMesh, n: int,
                      shard_n: int, k_top: int) -> torch.Tensor:
    """Hierarchical global top-k on one rank of the client mesh: local
    top-k, one all-gather of the K*k (value, id) candidates, global
    top-k over the flattened list.

    Exact against the top-k of the gathered (N,) vector, ties included:
    a top-k keeps the lower index among equal values (a stable sort on
    the descending values), each rank's candidates keep ascending local
    order among ties, and the rank-major flat layout makes flat order
    gid order among any tied value."""
    kloc = min(k_top, shard_n)
    ev_m = torch.where(valid, evals, _f32(-math.inf, evals))
    li = torch.sort(-ev_m, stable=True).indices[:kloc]
    cand = all_gather(mesh, _pack(ev_m[li], gid[li].to(torch.int32))[None])
    cv = cand[:, 0].reshape(-1)
    cg = cand[:, 1].contiguous().view(torch.int32).reshape(-1)
    winners = cg[torch.sort(-cv, stable=True).indices[:k_top]]
    mask = (gid[:, None] == winners[None, :]).any(dim=1)
    return (mask & valid).to(torch.int32)
