"""Batched Mamdani fuzzy evaluation on the card (replaces
``repro/kernels/fuzzy_eval.py::fuzzy_eval_pallas``).

``fuzzy_eval_cuda`` launches ``csrc/fuzzy_eval.cu`` once a call, Eq. 8
(or the scaling by external maxima) included, for one set of rows or
for S seeds' sets at once; its plain version is
``kernels/ref.py::fuzzy_eval_ref``.
``kernels/ops.py`` picks between them by the tensor's device.

The host path is kept short, since at the paths' sizes (P = 30 to 4096)
it costs more than the kernel.  The rule base is packed once per (rule
table, levels, device), found by the arrays' identity, so a call does
not hash their bytes; the Mamdani tensors (means, sigmas, level
centers) are checked once per set, and their pointers, the packed rules
and the cooperative launch's scratch (one per device and stream) sit in
one host block, so a launch passes six arguments.  The rule arrays are
read as constants, as the reference's jnp tables are: one changed in
place after its first call keeps its first packing; the Mamdani
tensors' values are read at each launch, their storage at the first.  The
standalone kernel reads the rules sorted by output level, followed by
each level's first rule and the count (``NUM_OUT + 1`` starts); the
fused probe kernels read them in the table's order.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

NUM_OUT = 9                  # MAMDANI_OUT in csrc/mamdani.cuh

# packed rule bases, keyed by (id(table), id(levels), device): (table,
# levels, codes in table order, codes by level + level starts); each
# entry holds its arrays, so neither id is reused while the entry lives
_PACKED: Dict[tuple, tuple] = {}
_PACKED_MAX = 16
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# a launch's constant operands, keyed by the ids of (means, sigmas,
# level_centers, table, levels), the device and the stream -> (those
# five, the rules by level, the FuzzyOperands block pointing at them)
_OPERANDS: Dict[tuple, tuple] = {}


class _FuzzyOperands(ctypes.Structure):
    """``FuzzyOperands`` in ``csrc/fuzzy_eval.cu``."""
    _fields_ = [("means", ctypes.c_void_p), ("sigmas", ctypes.c_void_p),
                ("centers", ctypes.c_void_p), ("rules", ctypes.c_void_p),
                ("n_rules", ctypes.c_int), ("partial", ctypes.c_void_p)]


def _pack(rule_table: np.ndarray, rule_levels: np.ndarray,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    table = np.ascontiguousarray(rule_table, np.int64)
    levels = np.ascontiguousarray(rule_levels, np.int64)
    if table.ndim != 2 or table.shape[1] != 4 or table.min() < 0 \
            or table.max() > 2 or levels.shape != (table.shape[0],) \
            or levels.min() < 0 or levels.max() >= NUM_OUT:
        raise ValueError(f"rule table must be (R, 4) in {{0, 1, 2}} with "
                         f"(R,) levels in [0, {NUM_OUT})")
    code = (table[:, 0] | table[:, 1] << 2 | table[:, 2] << 4
            | table[:, 3] << 6 | levels << 8).astype(np.int32)
    order = np.argsort(levels, kind="stable")
    starts = np.searchsorted(levels[order], np.arange(NUM_OUT + 1))
    by_level = np.concatenate([code[order], starts.astype(np.int32)])
    return (torch.tensor(code, device=device),
            torch.tensor(by_level, device=device))


def _packing(rule_table: np.ndarray, rule_levels: np.ndarray,
             device: torch.device) -> tuple:
    key = (id(rule_table), id(rule_levels), device)
    hit = _PACKED.get(key)
    if hit is not None and hit[0] is rule_table and hit[1] is rule_levels:
        return hit
    if len(_PACKED) >= _PACKED_MAX:
        _PACKED.pop(next(iter(_PACKED)))
    hit = _PACKED[key] = (rule_table, rule_levels,
                          *_pack(rule_table, rule_levels, device))
    return hit


def packed_rules(rule_table: np.ndarray, rule_levels: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """The rule base as the fused kernels read it: one int32 per rule,
    ``t0 | t1 << 2 | t2 << 4 | t3 << 6 | level << 8`` (``mamdani.cuh``),
    in the table's order, packed once per (rule table, levels,
    device)."""
    return _packing(rule_table, rule_levels, device)[2]


def rules_by_level(rule_table: np.ndarray, rule_levels: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """The same codes as ``packed_rules`` sorted (stably) by level, then
    the ``NUM_OUT + 1`` starts of each level's run: (R + 10,) int32,
    ``fuzzy_eval.cu``'s operand."""
    return _packing(rule_table, rule_levels, device)[3]


def mamdani_operands(means, sigmas, level_centers, rule_table,
                     rule_levels, device):
    """Check the membership/level tensors and pack the rules."""
    build.require(means, "means", (4, 3), torch.float32)
    build.require(sigmas, "sigmas", (4, 3), torch.float32)
    build.require(level_centers, "level_centers", (9,), torch.float32)
    return packed_rules(rule_table, rule_levels, device)


def _scratch(lib, device: torch.device, stream: int) -> torch.Tensor:
    """The column maxima of a cooperative launch's CTAs: one buffer per
    device and stream, so launches in stream order may share it."""
    key = (device, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = torch.empty(lib.fuzzy_eval_scratch_floats(),
                          dtype=torch.float32, device=device)
        _SCRATCH[key] = buf
    return buf


def _operands(lib, means, sigmas, level_centers, rule_table, rule_levels,
              device, stream: int) -> int:
    """The address of the launch's ``FuzzyOperands``, the operands
    checked and the rules packed on their first call."""
    key = (id(means), id(sigmas), id(level_centers), id(rule_table),
           id(rule_levels), device, stream)
    hit = _OPERANDS.get(key)
    if hit is None or any(a is not b for a, b in zip(
            hit, (means, sigmas, level_centers, rule_table, rule_levels))):
        mamdani_operands(means, sigmas, level_centers, rule_table,
                         rule_levels, device)
        rules = rules_by_level(rule_table, rule_levels, device)
        block = _FuzzyOperands(
            means.data_ptr(), sigmas.data_ptr(), level_centers.data_ptr(),
            rules.data_ptr(), rules.shape[0] - NUM_OUT - 1,
            _scratch(lib, device, stream).data_ptr())
        if len(_OPERANDS) >= _PACKED_MAX:
            _OPERANDS.pop(next(iter(_OPERANDS)))
        hit = _OPERANDS[key] = (means, sigmas, level_centers, rule_table,
                                rule_levels, rules, block)
    return ctypes.addressof(hit[6])


def fuzzy_eval_cuda(x: torch.Tensor, means: torch.Tensor,
                    sigmas: torch.Tensor, rule_table: np.ndarray,
                    rule_levels: np.ndarray, level_centers: torch.Tensor,
                    normalize: bool = False,
                    col_maxima: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """x (P, 4) fp32 on CUDA -> evaluations (P,).  ``normalize=True``
    applies Eq. 8 (column maxima, reciprocal multiply) in the same
    launch; ``col_maxima`` (4,) scales by those maxima instead (x /
    max(maxima, 1e-9), clipped to [0, 1], as the fused kernels divide).

    x (seeds, P, 4) evaluates every seed in one launch, each scaled by
    its own maxima (its rows', or its row of ``col_maxima`` (seeds,
    4)), -> (seeds, P), each seed bit-equal to a launch of it alone."""
    lead = tuple(x.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"x: at most one leading (seed) axis, got "
                         f"{tuple(x.shape)}")
    build.require(x, "x", lead + (None, 4), torch.float32)
    if col_maxima is not None:
        build.require(col_maxima, "col_maxima", lead + (4,), torch.float32)
    dev = x.device
    lib = build.load("fuzzy_eval")
    stream = build.stream_ptr(x)
    block = _operands(lib, means, sigmas, level_centers, rule_table,
                      rule_levels, dev, stream)
    seeds, p = (lead or (1,))[0], x.shape[-2]
    out = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    if p == 0 or seeds == 0:
        return out
    mode = 3 if col_maxima is not None else int(normalize)
    build.check(lib.fuzzy_eval_launch(
        x.data_ptr(), p, seeds, mode,
        col_maxima.data_ptr() if col_maxima is not None else None, block,
        out.data_ptr(), stream), "fuzzy_eval")
    build.LAUNCHES["fuzzy_eval"] += 1
    return out
