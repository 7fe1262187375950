"""The Mamba-1 selective scan on the card (replaces
``repro/kernels/selective_scan.py::selective_scan_pallas``).

``selective_scan_cuda`` launches ``csrc/selective_scan.cu``; its plain
version is ``kernels/ref.py::selective_scan_ref``.  Both return ``y``
and the final state in fp32, as ``selective_scan_pallas`` does;
``ops.selective_scan`` casts ``y`` to ``x``'s dtype, as the reference's
model scan does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 32          # the largest N csrc/selective_scan.cu is built for
_TYPES = (torch.float32, torch.bfloat16)


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor,
                        a: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, T, Di) and bmat, cmat (B, T, N), all fp32 or all bf16,
    a (Di, N) fp32, h0 (B, Di, N) fp32, all on CUDA and contiguous, N <= ``MAX_STATE`` -> ``(y (B, T, Di) fp32,
    hT (B, Di, N) fp32)``."""
    if x.dim() != 3 or x.dtype not in _TYPES:
        raise ValueError(f"selective_scan: x must be (B, T, Di) fp32 or "
                         f"bf16, got {tuple(x.shape)} {x.dtype}")
    b, t, di = x.shape
    n = bmat.shape[-1] if bmat.dim() == 3 else -1
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"selective_scan: state dim N = {n} is not built; "
                         f"the kernel takes 1 <= N <= {MAX_STATE}")
    build.require(x, "x", (b, t, di), x.dtype)
    build.require(dt, "dt", (b, t, di), x.dtype)
    build.require(bmat, "bmat", (b, t, n), x.dtype)
    build.require(cmat, "cmat", (b, t, n), x.dtype)
    build.require(a, "a", (di, n), torch.float32)
    build.require(h0, "h0", (b, di, n), torch.float32)
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    if b == 0 or di == 0:
        return y, h0.clone()
    h_t = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    lib = build.load("selective_scan")
    build.check(lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), h0.data_ptr(), b, t, di, n,
        int(x.dtype == torch.bfloat16), y.data_ptr(), h_t.data_ptr(), build.stream_ptr(x)), "selective_scan")
    build.LAUNCHES["selective_scan"] += 1
    return y, h_t
