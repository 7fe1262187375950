"""Windowed better-neighbour counts on the card (replaces
``repro/kernels/neighbor_elect.py::windowed_counts_pallas``).

``windowed_counts_cuda`` launches ``csrc/windowed_counts.cu``; its plain
version is ``kernels/ref.py::windowed_counts_ref``.  Both visit the
Pallas kernel's block-granular candidate set, so the int32 counts are
bit-equal: ``comm_range`` and ``e_tau`` cross to the kernel as fp32, as
JAX compares its weakly typed Python floats in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_BLOCK = 1024          # WC_MAX_BLOCK in csrc/windowed_counts.cu


def windowed_counts_cuda(sp: torch.Tensor, se: torch.Tensor,
                         sg: torch.Tensor, *, comm_range: float,
                         e_tau: float, n_valid: int, window: int,
                         block: int) -> torch.Tensor:
    """sp, se (M,) fp32, sg (M,) int32 on CUDA, position-sorted and
    sentinel-padded to a multiple of ``block`` -> counts (M,) int32."""
    build.require(sp, "sp", (None,), torch.float32)
    m = sp.shape[0]
    build.require(se, "se", (m,), torch.float32)
    build.require(sg, "sg", (m,), torch.int32)
    if not 0 < block <= MAX_BLOCK or m % block != 0 or window < 0:
        raise ValueError(f"windowed_counts: need 0 < block <= {MAX_BLOCK}, "
                         f"M % block == 0 and window >= 0 (M={m}, "
                         f"block={block}, window={window})")
    out = torch.empty(m, dtype=torch.int32, device=sp.device)
    if m == 0:
        return out
    lib = build.load("windowed_counts")
    build.check(lib.windowed_counts_launch(
        sp.data_ptr(), se.data_ptr(), sg.data_ptr(), m, int(block),
        int(window), float(comm_range), float(e_tau), int(n_valid),
        out.data_ptr(), build.stream_ptr(sp)), "windowed_counts")
    build.LAUNCHES["windowed_counts"] += 1
    return out
