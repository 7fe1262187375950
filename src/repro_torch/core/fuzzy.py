"""The multi-objective fuzzy evaluator (paper §5).

Mamdani inference over four normalized inputs — SQ, TA, CC, LF — with
3 Gaussian membership functions per variable (Fig. 4), the 81-rule base
of ``core.rules``, max-aggregation into the 9 output levels L0..L8 and
centre-of-gravity defuzzification (Eq. 9) over singleton level centers on
the paper's [0, 100] output scale.

The evaluator is local: each participant evaluates its own state.
``FuzzyEvaluator.evaluate`` is batched (P, 4) all the same, as the
simulation evaluates every participant at once, through
``kernels/ops.py::fuzzy_eval``: the hand-written kernel
(``kernels/fuzzy_eval.py``) on a CUDA tensor, the plain version
(``kernels/ref.py``) on a CPU one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.rules import NUM_OUT, build_rule_table
from repro_torch.kernels import ops as kops


def default_level_centers(device=None) -> torch.Tensor:
    """L0..L8 singleton centers on the paper's [0,100] evaluation scale."""
    return torch.linspace(0.0, 100.0, NUM_OUT, dtype=torch.float32,
                          device=device)


@dataclass
class FuzzyEvaluatorConfig:
    # Gaussian membership (means/sigmas per variable x level); Fig. 4 puts
    # the three functions at low/mid/high of the normalized [0,1] range
    means: np.ndarray = field(default_factory=lambda: np.tile(
        np.array([0.15, 0.5, 0.85], np.float32), (4, 1)))
    sigmas: np.ndarray = field(default_factory=lambda: np.full(
        (4, 3), 0.18, np.float32))
    e_tau: float = 30.0          # broadcast threshold E_tau (Alg. 1)


class FuzzyEvaluator:
    """Batched Mamdani evaluator (the reference's ``FuzzyEvaluator``)."""

    def __init__(self, cfg: Optional[FuzzyEvaluatorConfig] = None):
        self.cfg = cfg or FuzzyEvaluatorConfig()
        self.rule_table, self.rule_levels = build_rule_table()
        self.level_centers = default_level_centers()

    # -- normalization (Eq. 8) --------------------------------------------
    @staticmethod
    def normalize(values: torch.Tensor, maxima: torch.Tensor) -> torch.Tensor:
        """value / max(variable): each column scaled to [0, 1]."""
        return torch.clamp(values / torch.clamp(maxima, min=1e-9), 0.0, 1.0)

    # -- calibration from history (§5.3: bounds from historical records) --
    def calibrate(self, history) -> None:
        """history: (num_obs, 4) of normalized past observations.  Centres
        the three membership functions of each variable on its 10th, 50th
        and 90th percentiles, with a spread of a quarter of the 10-90
        range (at least 0.05): the paper's "bound of each linguistic is
        defined through historical records"."""
        pct = np.percentile(np.asarray(history), [10, 50, 90], axis=0).T
        self.cfg.means = pct.astype(np.float32)
        spread = np.maximum((pct[:, 2] - pct[:, 0]) / 4.0, 0.05)
        self.cfg.sigmas = np.tile(spread[:, None], (1, 3)).astype(np.float32)

    def _operands(self, x: torch.Tensor):
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=x.device)
        return (f32(self.cfg.means), f32(self.cfg.sigmas), self.rule_table,
                self.rule_levels, self.level_centers.to(x.device))

    # -- inference ----------------------------------------------------------
    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """x: (P, 4) normalized [SQ, TA, CC, LF] -> evaluations (P,) on
        [0, 100]."""
        return kops.fuzzy_eval(x, *self._operands(x))

    def evaluate_raw(self, x_raw: torch.Tensor) -> torch.Tensor:
        """x_raw: (P, 4) raw feature columns; Eq. 8's per-column
        max-scaling runs inside the kernel (``normalize=True``)."""
        return kops.fuzzy_eval(x_raw, *self._operands(x_raw),
                               normalize=True)

    def level_of(self, evaluation: torch.Tensor) -> torch.Tensor:
        """The nearest output level L0..L8 of a defuzzified value."""
        return torch.argmin(torch.abs(
            evaluation[..., None] - self.level_centers.to(evaluation.device)),
            dim=-1)
