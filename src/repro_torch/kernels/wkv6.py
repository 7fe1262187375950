"""The RWKV-6 WKV recurrence on the card (replaces
``repro/kernels/wkv6.py::wkv6_pallas``) and its backward, which replaces
no Pallas kernel (the reference trains through the autodiff of its jnp
recurrence).

``wkv6_cuda`` launches ``csrc/wkv6.cu``; its plain version is
``kernels/ref.py::wkv6_ref``.  Both return ``y`` and the final state in
fp32, as ``wkv6_pallas`` does; ``ops.wkv6`` casts ``y`` to ``r``'s
dtype, as the reference's default path does.  ``wkv6_fwd_cuda`` is the
same launch that also returns its scratch, which holds the state at each
chunk boundary; ``wkv6_bwd_cuda`` (``csrc/wkv6_bwd.cu``) rebuilds each
chunk's states from it.  Its plain version is
``kernels/ref.py::wkv6_bwd_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_SIZE = 64            # WKV_N in csrc/wkv6.cu: one thread per column
CHUNK = 64                # WKV_C in csrc/wkv6.cu: steps per time chunk
ROWS = 8                  # WB_ROWS in csrc/wkv6_bwd.cu: state rows a block
_TYPES = (torch.float32, torch.bfloat16)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, T, H, 64) fp32 or bf16 (one type), w (B, T, H, 64)
    fp32 or bf16, u (H, 64) fp32, s0 (B, H, 64, 64) fp32, all on CUDA
    and contiguous -> ``(y (B, T, H, 64) fp32, sT (B, H, 64, 64)
    fp32)``."""
    return wkv6_fwd_cuda(r, k, v, w, u, s0)[:2]


def wkv6_fwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``wkv6_cuda``'s launch -> ``(y, sT, scratch)``: slot ``m`` of the
    scratch of each (b, h) holds the state at the start of chunk ``m +
    1`` (empty within one chunk), for ``wkv6_bwd_cuda``."""
    if r.dim() != 4 or r.shape[-1] != HEAD_SIZE or r.dtype not in _TYPES:
        raise ValueError(f"wkv6: r must be (B, T, H, {HEAD_SIZE}) fp32 or "
                         f"bf16, got {tuple(r.shape)} {r.dtype}")
    if w.dtype not in _TYPES:
        raise ValueError(f"wkv6: w must be fp32 or bf16, got {w.dtype}")
    b, t, h, n = r.shape
    build.require(r, "r", (b, t, h, n), r.dtype)
    build.require(k, "k", (b, t, h, n), r.dtype)
    build.require(v, "v", (b, t, h, n), r.dtype)
    build.require(w, "w", (b, t, h, n), w.dtype)
    build.require(u, "u", (h, n), torch.float32)
    build.require(s0, "s0", (b, h, n, n), torch.float32)
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    if b == 0 or h == 0:
        return y, s0.clone(), y.new_empty(0)
    s_t = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    # past one chunk: each chunk's end state and decay product (phases A-C)
    chunks = -(-t // CHUNK) if t > CHUNK else 0
    scratch = torch.empty(b * h * chunks * (n * n + n), dtype=torch.float32,
                          device=r.device)
    lib = build.load("wkv6")
    build.check(lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), b, t, h,
        int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        y.data_ptr(), s_t.data_ptr(), scratch.data_ptr(),
        build.stream_ptr(r)), "wkv6")
    build.LAUNCHES["wkv6"] += 1
    return y, s_t, scratch


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  states: torch.Tensor, dy: torch.Tensor,
                  dsT: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``wkv6_cuda``'s ``(y, sT)`` under ``dy`` (B, T,
    H, 64) fp32 and ``dsT`` (B, H, 64, 64) fp32 or None (zeros), from the
    forward's operands and its ``states`` (``wkv6_fwd_cuda``'s scratch)
    -> ``(dr, dk, dv, dw, du (H, 64), ds0)``: dr,
    dk and dv in r's dtype, dw in w's, du and ds0 fp32."""
    b, t, h, n = r.shape
    if n != HEAD_SIZE or r.dtype not in _TYPES or w.dtype not in _TYPES:
        raise ValueError(f"wkv6_bwd: r must be (B, T, H, {HEAD_SIZE}) fp32 "
                         f"or bf16, got {tuple(r.shape)} {r.dtype}")
    for name, x, dtype in (("r", r, r.dtype), ("k", k, r.dtype),
                           ("v", v, r.dtype), ("w", w, w.dtype),
                           ("dy", dy, torch.float32)):
        build.require(x, name, (b, t, h, n), dtype)
    build.require(u, "u", (h, n), torch.float32)
    build.require(s0, "s0", (b, h, n, n), torch.float32)
    if dsT is not None:
        build.require(dsT, "dsT", (b, h, n, n), torch.float32)
    chunks = -(-t // CHUNK) if t > CHUNK else 0
    build.require(states, "states", (b * h * chunks * (n * n + n),),
                  torch.float32)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    ds0 = (dsT.clone() if dsT is not None else torch.zeros_like(s0))
    if b == 0 or h == 0 or t == 0:
        return dr, dk, dv, dw, du, ds0
    scratch = torch.empty(HEAD_SIZE // ROWS * b * t * h * n + b * h * n,
                          dtype=torch.float32, device=r.device)
    lib = build.load("wkv6_bwd")
    build.check(lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), states.data_ptr() if chunks else None,
        dy.data_ptr(), dsT.data_ptr() if dsT is not None else None, b, t, h,
        int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), scratch.data_ptr(),
        build.stream_ptr(r)), "wkv6_bwd")
    build.LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
