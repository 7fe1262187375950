"""The multi-objective fuzzy evaluator's parameters (paper §5).

Mamdani inference over four normalized inputs — SQ, TA, CC, LF — with
3 Gaussian membership functions per variable (Fig. 4), the 81-rule base
of ``core.rules``, max-aggregation into the 9 output levels L0..L8 and
centre-of-gravity defuzzification (Eq. 9) over singleton level centers on
the paper's [0, 100] output scale.  The inference itself lives in
``kernels/fuzzy_eval.py`` (CUDA) and ``kernels/ref.py`` (plain).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.rules import NUM_OUT


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
