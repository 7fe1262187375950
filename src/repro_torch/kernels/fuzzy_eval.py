"""Batched Mamdani fuzzy evaluation on the card (replaces
``repro/kernels/fuzzy_eval.py::fuzzy_eval_pallas``).

``fuzzy_eval_cuda`` launches ``csrc/fuzzy_eval.cu``; its plain version
is ``kernels/ref.py::fuzzy_eval_ref``.  ``kernels/ops.py`` picks between
them by the tensor's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _packed(table_bytes: bytes, levels_bytes: bytes, n_rules: int,
            device: torch.device) -> torch.Tensor:
    table = np.frombuffer(table_bytes, np.int64).reshape(n_rules, 4)
    levels = np.frombuffer(levels_bytes, np.int64)
    code = (table[:, 0] | table[:, 1] << 2 | table[:, 2] << 4
            | table[:, 3] << 6 | levels << 8).astype(np.int32)
    return torch.tensor(code, device=device)


def packed_rules(rule_table: np.ndarray, rule_levels: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """The rule base as the kernels read it: one int32 per rule,
    ``t0 | t1 << 2 | t2 << 4 | t3 << 6 | level << 8`` (``mamdani.cuh``),
    cached per device."""
    table = np.ascontiguousarray(rule_table, np.int64)
    levels = np.ascontiguousarray(rule_levels, np.int64)
    if table.ndim != 2 or table.shape[1] != 4 or table.min() < 0 \
            or table.max() > 2 or levels.shape != (table.shape[0],):
        raise ValueError("rule table must be (R, 4) in {0, 1, 2} with "
                         "(R,) levels")
    return _packed(table.tobytes(), levels.tobytes(), table.shape[0],
                   device)


def mamdani_operands(means, sigmas, level_centers, rule_table,
                     rule_levels, device):
    """Check the membership/level tensors and pack the rules."""
    build.require(means, "means", (4, 3), torch.float32)
    build.require(sigmas, "sigmas", (4, 3), torch.float32)
    build.require(level_centers, "level_centers", (9,), torch.float32)
    return packed_rules(rule_table, rule_levels, device)


def fuzzy_eval_cuda(x: torch.Tensor, means: torch.Tensor,
                    sigmas: torch.Tensor, rule_table: np.ndarray,
                    rule_levels: np.ndarray, level_centers: torch.Tensor,
                    normalize: bool = False) -> torch.Tensor:
    """x (P, 4) fp32 on CUDA -> evaluations (P,).  ``normalize=True``
    applies Eq. 8 (column maxima pre-pass, reciprocal multiply)."""
    build.require(x, "x", (None, 4), torch.float32)
    rules = mamdani_operands(means, sigmas, level_centers, rule_table,
                             rule_levels, x.device)
    p = x.shape[0]
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    if p == 0:
        return out
    lib = build.load("fuzzy_eval")
    scratch = torch.empty(lib.fuzzy_eval_scratch_floats(p) if normalize
                          else 4, dtype=torch.float32, device=x.device)
    build.check(lib.fuzzy_eval_launch(
        x.data_ptr(), p, int(normalize), scratch.data_ptr(),
        means.data_ptr(), sigmas.data_ptr(), level_centers.data_ptr(),
        rules.data_ptr(), rules.shape[0], out.data_ptr(),
        build.stream_ptr(x)), "fuzzy_eval")
    build.LAUNCHES["fuzzy_eval"] += 1
    return out
