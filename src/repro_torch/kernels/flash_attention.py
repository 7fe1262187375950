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
``flash_attention_pallas`` does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128, 256)      # the instantiations in both sources
_TYPES = (torch.float32, torch.bfloat16)


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
    lib = build.load("flash_attention_bwd")
    build.check(lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, sq, skv, hq, hkv, dh,
        int(q.dtype == torch.bfloat16), int(causal), int(window),
        int(prefix_len), 1.0 / math.sqrt(dh), build.stream_ptr(q)),
        "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
