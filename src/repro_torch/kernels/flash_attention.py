"""Flash attention on the card (replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``) and its
backward, which replaces no Pallas kernel (the reference trains through
the autodiff of its jnp attention).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``: bf16 on
the tensor cores (P rounded to bf16 for P V, as the reference's jnp
attention does), fp32 on CUDA cores; with ``return_lse`` it also returns
each row's log-sum-exp, which ``flash_attention_bwd_cuda``
(``csrc/flash_attention_bwd.cu``) recomputes P from.  Their plain
versions are ``kernels/ref.py::flash_attention_ref``,
``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``, which
compute in fp32; all return the inputs' dtype, as
``flash_attention_pallas`` does.  ``bwd_plan`` splits the bf16
backward's dK/dV work over a group's q heads and long q ranges, from the
shapes alone.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128, 256)      # the instantiations in both sources
_TYPES = (torch.float32, torch.bfloat16)

# the bf16 backward (TB_* in csrc/flash_attention_bwd.cu): rows of a q and
# a kv tile; the most shares of a group's q heads; the H100's SMs, which
# the dK/dV blocks aim to fill, and how many of them an SM holds by Dh
# (at 64 its registers, 181 a thread; at 128 and 256 its shared memory,
# 114 and 210 KB a block)
BWD_TILE, BWD_HEAD_SPLITS, BWD_SMS = 64, 8, 132
BWD_RESIDENT = {64: 2, 128: 1, 256: 1}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _runs(length: int, run: int) -> int:
    """Runs of about ``run`` tiles over ``length`` kept tiles, one where
    they fit one run."""
    return _ceil(length, run) if length > run else 1


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, sq: int, skv: int, hq: int, hkv: int,
             dh: int) -> Tuple[int, int]:
    """The bf16 backward's split of its dK/dV work: ``(head_splits,
    q_run)``, from the shapes alone (so the order of every sum, and so
    the bits, do not depend on the values).

    A block takes one kv tile of one (batch, kv head), one run of its q
    tiles and one of ``head_splits`` equal shares of the group's q
    heads.  ``head_splits`` is the smallest divisor of the group (at most
    ``BWD_HEAD_SPLITS``) that brings the blocks to what the SMs hold, else
    the largest; where that is still short, the q tiles that a causal
    mask keeps for kv tile 0 are cut into runs of about ``q_run`` tiles
    (the causal units of work an SM would take), else ``q_run`` is every
    q tile.  Every kv tile gets as many runs as tile 0 (``bwd_runs``).
    Where a tile has more than one block, each block's fp32 partial goes
    to a scratch that a third pass adds in order (``bwd_sizes``).  The dQ
    kernel is not split (a block a tile of 64 (position, q head) rows)."""
    g, nqt, nkt = hq // hkv, _ceil(sq, BWD_TILE), _ceil(skv, BWD_TILE)
    target = BWD_SMS * BWD_RESIDENT.get(dh, 1)
    base = b * hkv * nkt
    divs = [d for d in range(1, min(g, BWD_HEAD_SPLITS) + 1) if g % d == 0]
    splits = next((d for d in divs if base * d >= target), divs[-1])
    q_run = nqt
    if base * splits < target:
        units = b * hkv * g * sum(nqt - j for j in range(min(nkt, nqt)))
        q_run = max(1, units // (target * (g // splits)))
    return splits, q_run


@functools.lru_cache(maxsize=None)
def bwd_runs(plan: Tuple[int, int], sq: int,
             skv: int) -> Tuple[Tuple[int, ...], ...]:
    """The plan's runs as cut points (``fa_cut``): for each kv tile j,
    run r of its dK/dV blocks takes q tiles [cuts[r], cuts[r + 1]), as
    many runs as kv tile 0's, over the causally kept [j, nqt), the first
    also taking [0, j).  A short tile's runs may be empty."""
    nqt, nkt = _ceil(sq, BWD_TILE), _ceil(skv, BWD_TILE)
    nr = _runs(nqt, plan[1])
    return tuple(
        tuple([0] + [min(nqt, j + _ceil(r * max(0, nqt - j), nr))
                     for r in range(1, nr)] + [nqt])
        for j in range(nkt))


@functools.lru_cache(maxsize=None)
def bwd_sizes(plan: Tuple[int, int], b: int, sq: int, skv: int, hq: int,
              hkv: int, dh: int) -> Tuple[int, int, int]:
    """``(dq_blocks, dkdv_blocks, scratch)``: each kernel's blocks and the
    fp32 scratch (floats) of the dK/dV partials, as the launch counts
    them (``fa_setup``): where a kv tile has more than one block (a run
    and a share of the heads), 2 x B x Hkv x (its blocks) x 64 x Dh."""
    runs = bwd_runs(plan, sq, skv)
    blocks = len(runs) * (len(runs[0]) - 1) * plan[0]
    nbh = b * hkv
    scratch = 2 * nbh * blocks * BWD_TILE * dh if blocks > len(runs) else 0
    return (nbh * _ceil(sq * (hq // hkv), BWD_TILE), nbh * blocks, scratch)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           prefix_len: int, what: str) -> None:
    """The kernels' contract: q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv,
    Dh), one type (fp32 or bf16), on CUDA, contiguous and 16-byte
    aligned, Hq a multiple of Hkv and Dh one of ``HEAD_DIMS``."""
    if q.dtype not in _TYPES:
        raise ValueError(f"{what}: q must be fp32 or bf16, got {q.dtype}")
    build.require(q, "q", (None,) * 4, q.dtype)
    b, _, hq, dh = q.shape
    build.require(k, "k", (b, None, None, dh), q.dtype)
    build.require(v, "v", tuple(k.shape), q.dtype)
    skv, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {dh} is not built; the kernel "
                         f"takes {HEAD_DIMS}")
    if hkv == 0 or hq % hkv or skv == 0:
        raise ValueError(f"{what}: {hq} q heads over {hkv} kv heads, {skv} "
                         f"kv positions")
    if window < 0 or prefix_len < 0:
        raise ValueError(f"{what}: window and prefix_len must be >= 0")
    if any(t.data_ptr() % 16 for t in (q, k, v)):      # float4 / cp.async
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, return_lse: bool = False):
    """q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), one type (fp32 or
    bf16), on CUDA and contiguous, Hq a multiple of Hkv and Dh one of
    ``HEAD_DIMS`` -> (B, Sq, Hq, Dh) in q's type; with ``return_lse``
    ``(out, lse)``, lse (B, Hq, Sq) fp32 (the same ``out`` bit for bit)."""
    _check(q, k, v, window, prefix_len, "flash_attention")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        lib = build.load("flash_attention")
        build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, sq, skv, hq, hkv, dh,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            int(prefix_len), 1.0 / math.sqrt(dh), build.stream_ptr(q)),
            "flash_attention")
        build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             prefix_len: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention_cuda``'s output
    ``o`` under the cotangent ``do``, from the forward's ``lse``: q, k,
    v as the forward takes them, o and do of q's shape and type, lse
    (B, Hq, Sq) fp32 -> dq, dk, dv in the inputs' type (fp32
    accumulators, rounded once)."""
    _check(q, k, v, window, prefix_len, "flash_attention_bwd")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    build.require(o, "o", tuple(q.shape), q.dtype)
    build.require(do, "do", tuple(q.shape), q.dtype)
    build.require(lse, "lse", (b, hq, sq), torch.float32)
    if any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("flash_attention_bwd: operands must be 16-byte "
                         "aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    plan, scratch = (1, 1), 0
    if bf16:
        plan = bwd_plan(b, sq, skv, hq, hkv, dh)
        scratch = bwd_sizes(plan, b, sq, skv, hq, hkv, dh)[2]
    part = (torch.empty(scratch, dtype=torch.float32, device=q.device)
            if scratch else None)      # the dK/dV blocks' partials
    lib = build.load("flash_attention_bwd")
    build.check(lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, scratch, b, sq, skv,
        hq, hkv, dh, int(bf16), int(causal), int(window), int(prefix_len),
        *plan, 1.0 / math.sqrt(dh), build.stream_ptr(q)),
        "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
