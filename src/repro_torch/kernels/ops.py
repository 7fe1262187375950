"""Dispatch over the hand-written kernels by the tensor's device.

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
               level_centers: torch.Tensor, normalize: bool = False,
               col_maxima: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mamdani evaluation (P, 4) -> (P,); ``normalize=True`` takes raw
    columns and applies Eq. 8 first.

    ``col_maxima`` (4,), with ``normalize=True``, gives the Eq. 8 maxima
    instead of the batch's own: the client mesh's sharded prefix passes
    the all-reduced global maxima, so each rank normalizes against the
    whole fleet.  The scaling divides and then clips, as the fused
    kernel's finish does, so with the same maxima the evaluations are
    the fused kernel's bit for bit.  x (seeds, P, 4), with col_maxima
    (seeds, 4), evaluates S seeds at once, each on its own maxima ->
    (seeds, P)."""
    if not normalize:
        col_maxima = None
    if _on_cuda(x):
        from repro_torch.kernels.fuzzy_eval import fuzzy_eval_cuda
        return fuzzy_eval_cuda(x, means, sigmas, rule_table, rule_levels,
                               level_centers, normalize=normalize,
                               col_maxima=col_maxima)
    return ref.fuzzy_eval_ref(x, means, sigmas,
                              *_rules_on(x, rule_table, rule_levels),
                              level_centers, normalize=normalize,
                              col_maxima=col_maxima)


def probe_fuzzy(params, images, labels, seg, counts, aux, means, sigmas,
                rule_table: np.ndarray, rule_levels: np.ndarray,
                level_centers, *, n_clients: int,
                col_maxima: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused selection fast path: packed Eq. 7 probe samples ->
    ``(feats (N, 4) raw, evals (N,))``.  Stacked (seeds, ...) weights and
    packs run all seeds in one launch, Eq. 8 per seed."""
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


def probe_loss(params, images, labels, seg, counts, *,
               n_clients: int) -> torch.Tensor:
    """The fused fast path's probe half alone: packed Eq. 7 probe
    samples -> (N,) per-client mean losses.  The client mesh runs it on
    each rank's probe region; the all-reduce that merges the ranks'
    loss lanes stays outside the kernel.  Stacked (seeds, ...) weights
    and packs run all seeds in one launch -> (seeds, N)."""
    if _on_cuda(images):
        from repro_torch.kernels.probe_loss import probe_loss_cuda
        return probe_loss_cuda(params, images, labels, seg, counts,
                               n_clients=n_clients)
    return ref.probe_loss_ref(params, images, labels, seg, counts,
                              n_clients)


def cohort_gemm(a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor] = None, rowsum: bool = False):
    """``sum_r a[:, :, r] @ b[:, :, r] (+ bias)`` over strided (Z1, Z2,
    R, M, K) and (Z1, Z2, R, K, N) views -> (Z1, Z2, M, N), and with
    ``rowsum`` also a's sums over (r, k) -> ``(c, (Z1, Z2, M))`` (a
    weight gradient and its bias gradient); each output's sum runs in an
    order set by the product's own sizes, whatever Z2, the cohort axis,
    is (the cohort's local SGD, ROADMAP C12, C14)."""
    if _on_cuda(a):
        from repro_torch.kernels.cohort_gemm import cohort_gemm_cuda
        return cohort_gemm_cuda(a, b, bias, rowsum)
    return ref.cohort_gemm_ref(a, b, bias, rowsum)


def neighbor_elect(pos: torch.Tensor, evals: torch.Tensor, *,
                   comm_range: float, top_m: int,
                   e_tau: float) -> torch.Tensor:
    """Dense DCS election -> int32 mask (..., N); each leading index (a
    seed) is a fleet of its own, all elected in one launch."""
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


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _recurrence(op: str) -> tuple:
    """``op``'s (forward that keeps its states, backward) on the card and
    their plain versions."""
    if op == "wkv6":
        from repro_torch.kernels import wkv6 as cu
        return (cu.wkv6_fwd_cuda, cu.wkv6_bwd_cuda, ref.wkv6_ref,
                ref.wkv6_bwd_ref)
    from repro_torch.kernels import selective_scan as cu
    return (cu.selective_scan_fwd_cuda, cu.selective_scan_bwd_cuda,
            ref.selective_scan_ref, ref.selective_scan_bwd_ref)


class _Recurrence(torch.autograd.Function):
    """A recurrence (``op``: ``wkv6`` or ``selective_scan``) with its
    hand-written backward: the forward keeps its operands and, on the
    card, the states its kernel saved at chunk boundaries; the backward
    runs the CUDA backward on the card (its plain version on the CPU).
    Returns y and the final state in fp32; an unused output's gradient
    counts as zeros.  No fallback: on the card a failure of either
    kernel raises."""

    @staticmethod
    def forward(ctx, op, *xs):
        ctx.set_materialize_grads(False)
        ctx.op = op
        fwd_cuda, _, fwd_ref, _ = _recurrence(op)
        if _on_cuda(xs[0]):
            y, last, states = fwd_cuda(*xs)
        else:
            (y, last), states = fwd_ref(*xs), None
        ctx.save_for_backward(*xs, states)
        return y, last

    @staticmethod
    def backward(ctx, dy, dlast):
        *xs, states = ctx.saved_tensors
        _, bwd_cuda, _, bwd_ref = _recurrence(ctx.op)
        dy = (torch.zeros(xs[0].shape, dtype=torch.float32,
                          device=xs[0].device)
              if dy is None else dy.float().contiguous())
        dlast = None if dlast is None else dlast.float().contiguous()
        if _on_cuda(xs[0]):
            return (None, *bwd_cuda(*xs, states, dy, dlast))
        return (None, *bwd_ref(*xs, dy, dlast))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence over a sequence: r, k, v, w (B, T, H, N),
    u (H, N), s0 (B, H, N, N) fp32 -> ``(y (B, T, H, N) in r's dtype,
    sT (B, H, N, N) fp32)``.  Where grad is required of an input, the
    call is differentiable through the hand-written backward
    (``_Recurrence``); otherwise (serving, under ``no_grad``) it is the
    forward alone."""
    if _needs_grad(r, k, v, w, u, s0):
        y, s_t = _Recurrence.apply(
            "wkv6", *(t.contiguous() for t in (r, k, v, w, u, s0)))
    elif _on_cuda(r):
        from repro_torch.kernels.wkv6 import wkv6_cuda
        y, s_t = wkv6_cuda(r, k, v, w, u, s0)
    else:
        y, s_t = ref.wkv6_ref(r, k, v, w, u, s0)
    return y.to(r.dtype), s_t


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan over a sequence: x, dt (B, T, Di),
    bmat, cmat (B, T, N), a (Di, N) fp32, h0 (B, Di, N) fp32 -> ``(y
    (B, T, Di) in x's dtype, hT (B, Di, N) fp32)``.  Where grad is
    required of an input, the call is differentiable through the
    hand-written backward (``_Recurrence``); otherwise (serving,
    under ``no_grad``) it is the forward alone."""
    if _needs_grad(x, dt, bmat, cmat, a, h0):
        y, h_t = _Recurrence.apply(
            "selective_scan",
            *(t.contiguous() for t in (x, dt, bmat, cmat, a, h0)))
    elif _on_cuda(x):
        from repro_torch.kernels.selective_scan import selective_scan_cuda
        y, h_t = selective_scan_cuda(x, dt, bmat, cmat, a, h0)
    else:
        y, h_t = ref.selective_scan_ref(x, dt, bmat, cmat, a, h0)
    return y.to(x.dtype), h_t


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward saves
    q, k, v, the output and each row's log-sum-exp; the backward runs
    ``flash_attention_bwd_cuda`` on the card (its plain version,
    ``ref.flash_attention_bwd_ref``, on the CPU).  No fallback: on the
    card a failure of either kernel raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        kw = dict(causal=causal, window=window, prefix_len=prefix_len)
        if _on_cuda(q):
            from repro_torch.kernels.flash_attention import \
                flash_attention_cuda
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:
            out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if _on_cuda(q):
            from repro_torch.kernels.flash_attention import \
                flash_attention_bwd_cuda
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, do, **ctx.kw)
        else:
            grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                **ctx.kw)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """Online-softmax attention over the natural positions: q (B, Sq,
    Hq, Dh), k and v (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh) in q's dtype;
    GQA by ``Hq // Hkv``, ``window`` and ``prefix_len`` only when
    causal.  Where grad is required of q, k or v, the call is
    differentiable through the hand-written backward (``_FlashAttention``);
    otherwise (serving, under ``no_grad``) it is the forward alone."""
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window,
                                     prefix_len)
    if _on_cuda(q):
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        return flash_attention_cuda(q, k, v, **kw)
    return ref.flash_attention_ref(q, k, v, **kw)
