"""Selection protocols as client-mesh collectives (the reference's
``repro.core.protocol``, there ``shard_map`` bodies).

The paper's communication claim, restated as what each rank of the
client mesh (``launch/mesh.py``) sends.  The participants are split over
the K ranks as contiguous road segments (``shard``: rank r holds
participants ``r * N / K ... (r + 1) * N / K - 1``), and each protocol is
a function of one rank's block, in decreasing communication cost:

- ``ccs_state_gather``: classical CFL.  Every participant's full state
  vector reaches the (replicated) server: one all-gather of (N,
  state_dim) floats, O(N * state_dim) bytes a rank.
- ``ccs_fuzzy_gather``: CFL-fuzzy [16].  Each participant evaluates
  itself, so only the scalar evaluations travel: one all-gather of (N,)
  floats, O(N) bytes a rank.
- ``dcs_neighbor_exchange``: the paper's scheme.  Each rank sends its
  boundary ``window`` (positions, evaluations, indices) to its two
  road-adjacent ranks only, six ring shifts of W values (three at K = 2
  when the window is the whole block: both sides are the one
  neighbour's block), and elects locally: O(W) bytes a rank,
  independent of N (the Eq. 5 elimination).

``ClientMesh.collective_bytes`` counts each rank's output bytes by kind,
the reference's HLO convention (``launch/hlo_cost.py``).  The
reference's semantics are kept exactly: the server's top-k breaks ties
to the lower index (a stable sort, never ``torch.topk``); ``window=0``
sends the whole block; the ring wraps (rank 0 hears rank K-1); at K = 2
the one neighbour is heard from both sides and its vehicles count twice
in ``n_better``; K = 1 is the local election.  Indices travel as int32,
the reference's 4 bytes (it sends them as float32, exact below 2^24).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.fuzzy import FuzzyEvaluator
from repro_torch.core.selection import ccs_fuzzy_select
from repro_torch.kernels.ref import _f32
from repro_torch.launch.mesh import ClientMesh, all_gather, ring_shift


def shard(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """Rank ``mesh.rank``'s contiguous block of a global (N, ...) array,
    as the reference's ``PartitionSpec(axis)`` splits it; N % K != 0
    raises."""
    n, k = x.shape[0], mesh.size
    if n % k:
        raise ValueError(f"{n} participants do not split over {k} ranks "
                         f"(N % K != 0)")
    blk = n // k
    return x[mesh.rank * blk:(mesh.rank + 1) * blk]


def _elect_block(pos_i, ev_i, idx_i, pos_all, ev_all, idx_all, *,
                 comm_range: float, top_m: int, e_tau: float):
    """The election of a block of vehicles against a candidate window,
    every comparison in fp32."""
    cr, et = _f32(comm_range, pos_i), _f32(e_tau, pos_i)
    d = torch.abs(pos_i[:, None] - pos_all[None, :])
    valid = (d <= cr) & (ev_all[None, :] >= et)
    better = (ev_all[None, :] > ev_i[:, None]) | (
        (ev_all[None, :] == ev_i[:, None])
        & (idx_all[None, :] < idx_i[:, None]))
    n_better = (valid & better).sum(dim=1)
    return ((ev_i >= et) & (n_better < top_m)).to(torch.int32)


def make_ccs_state_gather(mesh: ClientMesh, evaluator: FuzzyEvaluator,
                          n_clients: int, state_dim: int) -> Callable:
    """states (N / K, state_dim), this rank's block -> this rank's block
    of the selection mask (int32).  The server (a replicated
    computation) receives every participant's raw state, evaluates its
    first four columns (SQ, TA, CC, LF, normalized), sorts and selects:
    the CFL scheme of Fig. 1a."""
    def body(states: torch.Tensor) -> torch.Tensor:
        if states.dim() != 2 or states.shape[1] != state_dim:
            raise ValueError(f"states: want (block, {state_dim}), got "
                             f"{tuple(states.shape)}")
        full = all_gather(mesh, states)
        evals = evaluator.evaluate(full[:, :4].contiguous())
        return shard(ccs_fuzzy_select(evals, n_clients), mesh)
    return body


def make_ccs_fuzzy_gather(mesh: ClientMesh, n_clients: int) -> Callable:
    """evals (N / K,), evaluated on the rank -> this rank's block of the
    mask (int32).  Only the scalar evaluations travel: Fig. 1b."""
    def body(evals: torch.Tensor) -> torch.Tensor:
        return shard(ccs_fuzzy_select(all_gather(mesh, evals), n_clients),
                     mesh)
    return body


def make_dcs_neighbor_exchange(mesh: ClientMesh, *,
                               comm_range: float = 200.0, top_m: int = 2,
                               e_tau: float = 30.0,
                               window: int = 0) -> Callable:
    """(pos, evals) (N / K,) each, this rank's block of the road -> this
    rank's block of the mask (int32).  The rank sends only its boundary
    ``window`` (0: the whole block) to the rank on its left and the one
    on its right: O(window) bytes, independent of N."""
    k = mesh.size

    def body(pos: torch.Tensor, evals: torch.Tensor) -> torch.Tensor:
        blk = pos.shape[0]
        w = window or blk
        idx = mesh.rank * blk + torch.arange(blk, dtype=torch.int32,
                                             device=pos.device)
        kw = dict(comm_range=comm_range, top_m=top_m, e_tau=e_tau)
        if k == 1:                         # no neighbours: local election
            return _elect_block(pos, evals, idx, pos, evals, idx, **kw)
        # my right edge -> the right neighbour's left window, and back
        from_left = [ring_shift(mesh, z[-w:], 1) for z in (pos, evals, idx)]
        if k == 2 and w >= blk:
            # the one neighbour's whole block, heard from both sides: the
            # same bytes, sent once (so does the reference's compiled
            # program), and counted twice in n_better all the same
            from_right = from_left
        else:
            from_right = [ring_shift(mesh, z[:w], -1)
                          for z in (pos, evals, idx)]
        cand = [torch.cat([a, z, b]) for a, z, b in
                zip(from_left, (pos, evals, idx), from_right)]
        return _elect_block(pos, evals, idx, *cand, **kw)
    return body
