"""Dense DCS neighbour election on the card (replaces
``repro/kernels/neighbor_elect.py::neighbor_elect_pallas``).

``neighbor_elect_cuda`` launches ``csrc/neighbor_elect.cu``; its plain
version is ``kernels/ref.py::neighbor_elect_ref``.  The result is an
integer mask, bit-equal to the plain version: ``comm_range`` and
``e_tau`` cross to the kernel as fp32, as JAX compares its weakly typed
Python floats in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def neighbor_elect_cuda(pos: torch.Tensor, evals: torch.Tensor, *,
                        comm_range: float, top_m: int,
                        e_tau: float) -> torch.Tensor:
    """pos, evals (N,) fp32 on CUDA -> selected (N,) int32."""
    build.require(pos, "pos", (None,), torch.float32)
    build.require(evals, "evals", (pos.shape[0],), torch.float32)
    n = pos.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=pos.device)
    if n == 0:
        return out
    lib = build.load("neighbor_elect")
    build.check(lib.neighbor_elect_launch(
        pos.data_ptr(), evals.data_ptr(), n, float(comm_range),
        float(e_tau), int(top_m), out.data_ptr(), build.stream_ptr(pos)),
        "neighbor_elect")
    build.LAUNCHES["neighbor_elect"] += 1
    return out
