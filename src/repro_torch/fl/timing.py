"""Training-time model and straggler handling (paper §5.2, Eq. 6).

Eq. 6 is implemented in its dimensionally consistent reading

    T_i = E * C_i * |D_i| * B_exe / B_size                    [seconds]

where C_i >= 1 is the slowdown of vehicle i relative to the reference
machine that measured B_exe (see ``repro.fl.timing`` for the derivation).
Works on numpy arrays and on tensors alike.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TimingConfig:
    epochs: int = 30
    batch_size: int = 20
    b_exe_s: float = 0.06          # measured on the paper's i5 reference
    deadline_s: float = 20.0


def training_time_s(cfg: TimingConfig, slowdown, n_samples):
    """T_i = E * C_i * |D_i| * B_exe / B_size  (vectorized)."""
    return (cfg.epochs * slowdown * n_samples * cfg.b_exe_s
            / cfg.batch_size)


def completes_before_deadline(cfg: TimingConfig, train_s, upload_s):
    """Straggler mask: local models arriving after the deadline are
    discarded (paper §6.1)."""
    return (train_s + upload_s) <= cfg.deadline_s
