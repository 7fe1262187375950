"""The cohort's batch-invariant batched GEMM on the card (``csrc/
cohort_gemm.cu``).

``cohort_gemm_cuda(a, b, bias)`` computes ``sum_r a[:, :, r] @ b[:, :,
r] (+ bias)`` for a (Z1, Z2, R, M, K) and b (Z1, Z2, R, K, N), strided
fp32 (or fp64) views (a broadcast axis has stride 0), into a new
contiguous (Z1, Z2, M, N); each output's sum runs in an order set by
the product's own sizes and never by Z2, the cohort axis, so a client's
result does not depend on how many clients share the launch (ROADMAP
C12).  Its plain version is ``kernels/ref.py::cohort_gemm_ref``
(``torch.matmul`` and a sum over R); ``kernels/ops.py`` picks between
them by the tensor's device.  ``models/cnn.py``'s stacked convolution
and stacked linear layers run their forward and backward products
through it on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build


class _CohortGemm(ctypes.Structure):
    """``CohortGemm`` in ``csrc/cohort_gemm.cu``."""
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("c", ctypes.c_void_p),
                ("work", ctypes.c_void_p),
                ("m", ctypes.c_int), ("n", ctypes.c_int),
                ("k", ctypes.c_int), ("z1", ctypes.c_int),
                ("z2", ctypes.c_int), ("r", ctypes.c_int),
                ("splits", ctypes.c_int), ("f64", ctypes.c_int),
                ("as_", ctypes.c_longlong * 5),
                ("bs", ctypes.c_longlong * 5),
                ("cs", ctypes.c_longlong * 4),
                ("biass", ctypes.c_longlong * 4)]


# the kernel's tile (CG_BM, CG_BN, CG_BK in csrc/cohort_gemm.cu)
TILE_M, TILE_N, TILE_K = 64, 64, 16
# a client's CTAs the split aims at, and the fewest k steps in a run
SPLIT_CTAS, SPLIT_MIN_STEPS = 64, 4


def gemm_splits(r: int, k: int, m: int, n: int, z1: int) -> int:
    """How many runs the kernel cuts the R x ceil(K / 16) k steps of each
    output's sum into: enough that one cohort member's tiles (Z1 x the
    M x N tiles) come to ``SPLIT_CTAS`` CTAs, with at least
    ``SPLIT_MIN_STEPS`` steps a run.  A function of the product's own
    sizes and never of Z2, the cohort axis, so the order of every sum,
    and so a client's bits, do not depend on how many clients share the
    launch.  1: the sum goes straight to the output."""
    steps = r * -(-k // TILE_K)
    tiles = z1 * -(-m // TILE_M) * -(-n // TILE_N)
    return max(1, min(-(-SPLIT_CTAS // tiles), steps // SPLIT_MIN_STEPS))


def check_gemm_operands(a: torch.Tensor, b: torch.Tensor,
                        bias: Optional[torch.Tensor]) -> tuple:
    """The contract: a (Z1, Z2, R, M, K) and b (Z1, Z2, R, K, N) views of
    one dtype, fp32 or fp64, bias (Z1, Z2, M, N) or None.  Returns the
    output's shape."""
    if a.dim() != 5 or b.dim() != 5:
        raise ValueError(f"cohort_gemm: a and b must be 5-d views, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    z1, z2, r, m, k = a.shape
    if tuple(b.shape[:4]) != (z1, z2, r, k):
        raise ValueError(f"cohort_gemm: b {tuple(b.shape)} does not match "
                         f"a {tuple(a.shape)}")
    out = (z1, z2, m, b.shape[4])
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cohort_gemm: a must be fp32 or fp64, got "
                         f"{a.dtype}")
    for name, t in (("b", b), ("bias", bias)):
        if t is not None and t.dtype != a.dtype:
            raise ValueError(f"cohort_gemm: {name} is {t.dtype}, a is "
                             f"{a.dtype}")
    if bias is not None and tuple(bias.shape) != out:
        raise ValueError(f"cohort_gemm: bias {tuple(bias.shape)} is not "
                         f"the output's {out}")
    return out


def cohort_gemm_cuda(a: torch.Tensor, b: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of ``csrc/cohort_gemm.cu``: views in, a new contiguous
    (Z1, Z2, M, N) tensor of their dtype out."""
    shape = check_gemm_operands(a, b, bias)
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is not None and t.device != a.device:
            raise ValueError(f"cohort_gemm: {name} on {t.device}, a on "
                             f"{a.device}")
    if a.device.type != "cuda":
        raise ValueError(f"cohort_gemm_cuda: expected CUDA tensors, got "
                         f"{a.device}")
    c = torch.empty(shape, dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if a.shape[2] == 0 or a.shape[4] == 0:
        return c.copy_(bias) if bias is not None else c.zero_()
    z1, z2, r, m, k = a.shape
    splits = gemm_splits(r, k, m, shape[3], z1)
    work = (torch.empty((splits, z1 * z2, m, shape[3]), dtype=a.dtype,
                        device=a.device) if splits > 1 else None)
    g = _CohortGemm(a.data_ptr(), b.data_ptr(),
                    bias.data_ptr() if bias is not None else None,
                    c.data_ptr(),
                    work.data_ptr() if work is not None else None,
                    m, shape[3], k, z1, z2, r, splits,
                    int(a.dtype == torch.float64))
    g.as_[:] = a.stride()
    g.bs[:] = b.stride()
    g.cs[:] = c.stride()
    if bias is not None:
        g.biass[:] = bias.stride()
    lib = build.load("cohort_gemm")
    build.check(lib.cohort_gemm_launch(ctypes.addressof(g),
                                       build.stream_ptr(a)), "cohort_gemm")
    build.LAUNCHES["cohort_gemm"] += 1
    return c
