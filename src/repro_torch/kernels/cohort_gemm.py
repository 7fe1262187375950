"""The cohort's batch-invariant batched GEMM on the card (``csrc/
cohort_gemm.cu``).

``cohort_gemm_cuda(a, b, bias, rowsum)`` computes ``sum_r a[:, :, r] @
b[:, :, r] (+ bias)`` for a (Z1, Z2, R, M, K) and b (Z1, Z2, R, K, N),
strided fp32 (or fp64) views (a broadcast axis has stride 0), into a new
contiguous (Z1, Z2, M, N), and with ``rowsum=True`` also a's sums over
(r, k), (Z1, Z2, M): a weight gradient and its bias gradient in one
launch.  Each output's sum runs in an order set by the product's own
sizes (``gemm_plan``) and never by Z2, the cohort axis, so a client's
result does not depend on how many clients share the launch (ROADMAP
C12).  fp32 runs as 3xTF32 on the tensor cores.  Its plain version is
``kernels/ref.py::cohort_gemm_ref``; ``kernels/ops.py`` picks between
them by the tensor's device.  ``models/cnn.py``'s stacked convolution
and stacked linear layers run their forward and backward products
through it on the card.
"""
from __future__ import annotations

import functools
import struct
from typing import Optional

import torch

from repro_torch.kernels import build


# ``CohortGemm`` in ``csrc/cohort_gemm.cu``, packed for one launch: the
# six pointers a, b, bias, c, rowsum, work (0: none); m, n, k, z1, z2,
# r, splits, f64, bm, bn, stages, bk, vec, fold; the strides of a (z1,
# z2, r, m, k), b (z1, z2, r, k, n), c and bias (z1, z2, m, n)
_RECORD = struct.Struct("<6Q14i18q")


# fp32 (TG_* in csrc/cohort_gemm.cu): a chunk of k; the most runs (a
# cluster of 16, 8 where the sum is at most 8 runs of 16 chunks: a
# portable cluster); a client's CTAs the runs aim at; the fewest chunks a
# run
TILE_K, MAX_SPLITS, PORTABLE_SPLITS, LONG_RUN = 32, 16, 8, 16
SPLIT_CTAS, SPLIT_MIN_STEPS = 256, 4
# fp64 (CG_*): the CUDA-core tile
F64_TILE_M, F64_TILE_N, F64_TILE_K = 64, 64, 16
F64_SPLIT_CTAS = 64


@functools.lru_cache(maxsize=None)
def gemm_plan(r: int, k: int, m: int, n: int, z1: int,
              fold: bool = False) -> tuple:
    """The fp32 kernel's tile, runs, ring and chunk for a product: ``(bm,
    bn, splits, stages, bk)``.  ``fold``: Z1 joins N (``gemm_fold``), so
    the tiles cover one (M, Z1 N) product.  The tile's rows are 16, 32 or
    64 as M needs, its columns 32 where N fits, else 64.  Counted in
    32-wide k chunks, the R x ceil(K / 32) chunks of each output's sum
    are cut into ``splits`` runs (a cluster of CTAs), enough that one
    cohort member's tiles (Z1 x the M x N tiles) come to ``SPLIT_CTAS``
    CTAs, with at least ``SPLIT_MIN_STEPS`` chunks a run and at most
    ``PORTABLE_SPLITS`` runs, or ``MAX_SPLITS`` where that many would
    each be longer than ``LONG_RUN`` chunks (the weight gradients' long
    sums on few tiles).  A run of at most 2 such chunks is short
    (``stages`` 2: a 2-stage ring of 32-wide chunks, more CTAs an SM);
    a longer one (``stages`` 4) takes the kernel's deeper ring, and in
    tiles of at most 32 x 32 64-wide chunks (``bk``), which the kernel
    then cuts into the runs.  A function of the product's own sizes and
    never of Z2, the cohort axis, so the order of every sum, and so a
    client's bits, do not depend on how many clients share the launch."""
    if fold:
        n, z1 = z1 * n, 1
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    bn = 32 if n <= 32 else 64
    steps = r * -(-k // TILE_K)
    tiles = z1 * -(-m // bm) * -(-n // bn)
    cap = (MAX_SPLITS if steps > PORTABLE_SPLITS * LONG_RUN
           else PORTABLE_SPLITS)
    splits = max(1, min(cap, -(-SPLIT_CTAS // tiles),
                        steps // SPLIT_MIN_STEPS))
    if -(-steps // splits) <= 2:
        return bm, bn, splits, 2, TILE_K
    return bm, bn, splits, 4, 2 * TILE_K if bm * bn <= 1024 else TILE_K


def gemm_splits_f64(r: int, k: int, m: int, n: int, z1: int) -> int:
    """The fp64 kernel's runs of its 16-wide k steps: enough that one
    cohort member's 64 x 64 tiles come to ``F64_SPLIT_CTAS`` CTAs, at
    least ``SPLIT_MIN_STEPS`` steps a run; like ``gemm_plan``, never a
    function of Z2.  1: the sum goes straight to the output."""
    steps = r * -(-k // F64_TILE_K)
    tiles = z1 * -(-m // F64_TILE_M) * -(-n // F64_TILE_N)
    return max(1, min(-(-F64_SPLIT_CTAS // tiles), steps // SPLIT_MIN_STEPS))


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


def gemm_fold(a: torch.Tensor, b: torch.Tensor, rowsum: bool) -> bool:
    """Whether Z1 joins N: a broadcast over Z1 (the convolutions' weights
    over the batch) with R = 1 and b read along n, no row sums.  A
    property of the call's layout, the same for any Z2."""
    return (a.shape[0] > 1 and a.shape[2] == 1 and a.stride(0) == 0
            and b.stride(3) != 1 and not rowsum)


def _vec(t: torch.Tensor, unit: int) -> bool:
    """Whether the fp32 kernel may copy ``t`` 16 bytes at a time along
    axis ``unit``: that axis has stride 1, every other axis of more than
    one element a stride of a multiple of 4, and the data starts 16-byte
    aligned.  It changes how a tile reaches shared memory, not what it
    holds."""
    st, sh = t.stride(), t.shape
    if st[unit] != 1 or t.data_ptr() % 16:
        return False
    return not any(st[d] % 4 and sh[d] > 1 for d in range(5) if d != unit)


def _launch(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            c: torch.Tensor, rs: Optional[torch.Tensor]) -> None:
    """One ``cohort_gemm_launch`` into ``c`` (and ``rs``)."""
    z1, z2, r, m, k = a.shape
    n = c.shape[3]
    f64 = a.dtype == torch.float64
    work = None
    vec = fold = 0
    if f64:
        bm = bn = stages = bk = 0
        splits = gemm_splits_f64(r, k, m, n, z1)
        if splits > 1:
            work = torch.empty((splits, z1 * z2, m, n), dtype=a.dtype,
                               device=a.device)
    else:
        fold = int(gemm_fold(a, b, rs is not None))
        bm, bn, splits, stages, bk = gemm_plan(r, k, m, n, z1, bool(fold))
        # the kernel reads a along k where k has stride 1, else along m;
        # b along k where k has stride 1, else along n
        vec = (int(_vec(a, 4 if a.stride(4) == 1 else 3))
               | 2 * int(_vec(b, 3 if b.stride(3) == 1 else 4)
                         and (not fold or n % 4 == 0)))
    record = _RECORD.pack(
        a.data_ptr(), b.data_ptr(), bias.data_ptr() if bias is not None
        else 0, c.data_ptr(), rs.data_ptr() if rs is not None else 0,
        work.data_ptr() if work is not None else 0,
        m, n, k, z1, z2, r, splits, int(f64), bm, bn, stages, bk, vec, fold,
        *a.stride(), *b.stride(), *c.stride(),
        *(bias.stride() if bias is not None else (0,) * 4))
    build.check(build.load("cohort_gemm").cohort_gemm_launch(
        record, build.stream_ptr(a)), "cohort_gemm")


def cohort_gemm_cuda(a: torch.Tensor, b: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     rowsum: bool = False):
    """One call of ``csrc/cohort_gemm.cu``: views in, a new contiguous
    (Z1, Z2, M, N) tensor of their dtype out, and with ``rowsum`` also
    a's sums over (r, k) as a new (Z1, Z2, M): ``(c, rowsum)``.  fp64's
    row sums take a second launch (a product with a broadcast one)."""
    shape = check_gemm_operands(a, b, bias)
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is not None and t.device != a.device:
            raise ValueError(f"cohort_gemm: {name} on {t.device}, a on "
                             f"{a.device}")
    if a.device.type != "cuda":
        raise ValueError(f"cohort_gemm_cuda: expected CUDA tensors, got "
                         f"{a.device}")
    c = torch.empty(shape, dtype=a.dtype, device=a.device)
    rs = (torch.empty(shape[:3], dtype=a.dtype, device=a.device)
          if rowsum else None)
    if c.numel() == 0:
        return (c, rs) if rowsum else c
    if a.shape[2] == 0 or a.shape[4] == 0:
        c.copy_(bias) if bias is not None else c.zero_()
        return (c, rs.zero_()) if rowsum else c
    if rowsum and a.dtype == torch.float64:
        _launch(a, b, bias, c, None)
        ones = a.new_ones(()).expand(*a.shape[:3], a.shape[4], 1)
        _launch(a, ones, None, rs[..., None], None)
    else:
        _launch(a, b, bias, c, rs)
    build.LAUNCHES["cohort_gemm"] += 1
    return (c, rs) if rowsum else c
