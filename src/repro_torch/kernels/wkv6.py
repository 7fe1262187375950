"""The RWKV-6 WKV recurrence on the card (replaces
``repro/kernels/wkv6.py::wkv6_pallas``) and its backward, which replaces
no Pallas kernel (the reference trains through the autodiff of its jnp
recurrence).

``wkv6_cuda`` launches ``csrc/wkv6.cu``; its plain version is
``kernels/ref.py::wkv6_ref``.  Both return ``y`` and the final state in
fp32, as ``wkv6_pallas`` does; ``ops.wkv6`` casts ``y`` to ``r``'s
dtype, as the reference's default path does.  ``wkv6_fwd_cuda`` is the
same launch that also returns its scratch, which holds the state at each
chunk boundary and each chunk's decay product.

``wkv6_bwd_cuda`` (``csrc/wkv6_bwd.cu``) is the VJP, chunk-parallel like
the forward; its plain version is ``kernels/ref.py::wkv6_bwd_ref``.  Its
bound is the fp32 rate (~12 operations per state entry a step: 0.030 ms
at rwkv6-3b's training microbatch, B = 1, T = 1024, H = 40).  The first
design walked every chunk of a (b, h) in turn, staging 64 states per 8
rows in 128 KB of shared memory (one block an SM, 5-shuffle sums, 1.17
ms).  This one runs each 64-step chunk's local sweeps in parallel (four
threads a state row or column, sums inside the thread; in each SUB-step
sub-chunk the states enter dw only through row dots with its first
state, so no per-step state is kept), carries the state's gradient over
chunks with the forward's decay products, and adds each chunk's carry
terms as two 64 x 64 products (0.34 ms on an H100).
``bwd_scratch_parts`` gives its scratch from the shapes alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_SIZE = 64            # WKV_N in csrc/wkv6.cu: one thread per column
CHUNK = 64                # WKV_C in csrc/wkv6.cu: steps per time chunk
SUB = 16                  # WB_SUB in csrc/wkv6_bwd.cu: steps a sub-chunk
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


def bwd_scratch_parts(b: int, t: int, h: int) -> Dict[str, int]:
    """``wkv6_bwd_cuda``'s scratch, fp32 elements by part in the order
    ``csrc/wkv6_bwd.cu`` lays them out: each sub-chunk's starting state
    but the first of each chunk (rows kernel, written and read back by
    the same thread), du's per-chunk partials, and, past one chunk, each
    chunk's Gloc_start (G_out after phase B) and phase A's fp32 dk, dv,
    dw for phase C to finish."""
    n, chunks = HEAD_SIZE, max(1, -(-t // CHUNK))
    many = chunks > 1
    return {"sub_states": b * h * chunks * (CHUNK // SUB - 1) * n * n,
            "du_partials": b * h * chunks * n,
            "g_start": b * h * chunks * n * n if many else 0,
            "local_dk_dv_dw": 3 * b * t * h * n if many else 0}


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
    slots = -(-t // CHUNK) if t > CHUNK else 0    # the forward's scratch
    build.require(states, "states", (b * h * slots * (n * n + n),),
                  torch.float32)
    if any(x.data_ptr() % 16 for x in (r, k, v, w, dy)):    # cp.async
        raise ValueError("wkv6_bwd: operands must be 16-byte aligned")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    if b == 0 or h == 0 or t == 0:
        return (dr, dk, dv, dw, s0.new_zeros((h, n)),
                dsT.clone() if dsT is not None else torch.zeros_like(s0))
    du = torch.empty((h, n), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    scratch = torch.empty(sum(bwd_scratch_parts(b, t, h).values()),
                          dtype=torch.float32, device=r.device)
    lib = build.load("wkv6_bwd")
    build.check(lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), states.data_ptr() if slots else None,
        dy.data_ptr(), dsT.data_ptr() if dsT is not None else None, b, t, h,
        int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), scratch.data_ptr(),
        build.stream_ptr(r)), "wkv6_bwd")
    build.LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
