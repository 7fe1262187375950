"""The RWKV-6 WKV recurrence on the card (replaces
``repro/kernels/wkv6.py::wkv6_pallas``).

``wkv6_cuda`` launches ``csrc/wkv6.cu``; its plain version is
``kernels/ref.py::wkv6_ref``.  Both return ``y`` and the final state in
fp32, as ``wkv6_pallas`` does; ``ops.wkv6`` casts ``y`` to ``r``'s
dtype, as the reference's default path does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

HEAD_SIZE = 64            # WKV_N in csrc/wkv6.cu: one thread per column
CHUNK = 64                # WKV_C in csrc/wkv6.cu: steps per time chunk
_TYPES = (torch.float32, torch.bfloat16)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, T, H, 64) fp32 or bf16 (one type), w (B, T, H, 64)
    fp32 or bf16, u (H, 64) fp32, s0 (B, H, 64, 64) fp32, all on CUDA
    and contiguous -> ``(y (B, T, H, 64) fp32, sT (B, H, 64, 64)
    fp32)``."""
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
        return y, s0.clone()
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
    return y, s_t
