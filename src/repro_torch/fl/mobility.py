"""Freeway mobility model (paper §6.1: 30 vehicles, 1000 m straight road,
freeway model).

``FreewayMobility`` is host numpy, bit-equal to ``repro.fl.mobility``;
``positions`` is its tensor twin for the selection prefix, and
``coverage_active`` the event-driven server's churn mask over it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# period parameter of the per-vehicle speed-jitter sinusoid: speed varies
# as jitter * sin(t / _JITTER_PERIOD_S + phase)
_JITTER_PERIOD_S = 7.0


@dataclass(frozen=True)
class MobilityConfig:
    n_vehicles: int = 30
    road_length_m: float = 1000.0
    v_min_mps: float = 20.0          # ~72 km/h
    v_max_mps: float = 33.0          # ~120 km/h
    speed_jitter: float = 1.0
    distribution: str = "uniform"    # uniform | extreme
    cluster_span_m: float = 150.0    # extreme: span of each crowd
    seed: int = 0


class FreewayMobility:
    def __init__(self, cfg: MobilityConfig,
                 quality_rank: Optional[np.ndarray] = None):
        """``quality_rank``: permutation of vehicles, best first — used by
        the 'extreme' distribution to crowd good vehicles together."""
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed + 31)
        n = cfg.n_vehicles
        self.speeds = rng.uniform(cfg.v_min_mps, cfg.v_max_mps, n)
        if cfg.distribution == "uniform":
            self.x0 = rng.uniform(0, cfg.road_length_m, n)
        elif cfg.distribution == "extreme":
            rank = (quality_rank if quality_rank is not None
                    else np.arange(n))
            half = n // 2
            x0 = np.empty(n)
            # best half crowded at one end, worst half at the other
            x0[rank[:half]] = rng.uniform(0, cfg.cluster_span_m, half)
            x0[rank[half:]] = rng.uniform(
                cfg.road_length_m - cfg.cluster_span_m,
                cfg.road_length_m, n - half)
            self.x0 = x0
        else:
            raise ValueError(cfg.distribution)
        jr = np.random.default_rng(cfg.seed + 37)
        self._jitter_phase = jr.uniform(0, 2 * np.pi, n)

    def displacement_m(self, t_s: float) -> np.ndarray:
        """Unwrapped displacement since t=0: the exact integral of the
        instantaneous speed ``speeds + jitter * sin(t/T + phase)``."""
        amp, period = self.cfg.speed_jitter, _JITTER_PERIOD_S
        jitter_disp = amp * period * (
            np.cos(self._jitter_phase)
            - np.cos(t_s / period + self._jitter_phase))
        return self.speeds * t_s + jitter_disp

    def positions(self, t_s: float) -> np.ndarray:
        x = self.x0 + self.displacement_m(t_s)
        return np.mod(x, self.cfg.road_length_m)


def floor_mod(x: torch.Tensor, period: float) -> torch.Tensor:
    """``x mod period`` with the sign of ``period`` — fmod plus the sign
    fix, the same two exact steps as ``jnp.mod``."""
    r = torch.fmod(x, period)
    return torch.where((r != 0) & ((r < 0) != (period < 0)), r + period, r)


def positions(x0: torch.Tensor, speeds: torch.Tensor,
              jitter_phase: torch.Tensor, t_s: torch.Tensor, *,
              road_length_m: float, speed_jitter: float) -> torch.Tensor:
    """Tensor twin of ``FreewayMobility.positions`` over the model's
    constant (N,) arrays; ``t_s`` broadcasts, so a per-client tensor of
    completion instants gives each vehicle's position at its own."""
    jitter_disp = speed_jitter * _JITTER_PERIOD_S * (
        torch.cos(jitter_phase)
        - torch.cos(t_s / _JITTER_PERIOD_S + jitter_phase))
    return floor_mod(x0 + speeds * t_s + jitter_disp, road_length_m)


def coverage_active(pos: torch.Tensor, *, road_length_m: float,
                    churn_rate: float) -> torch.Tensor:
    """Mobility-driven churn mask: the RSU covers ``[0, (1 - churn_rate)
    * L)`` of the wrapped road, and a vehicle in the uncovered tail has
    departed (it neither probes nor is selected, and an upload that
    completes there is lost).  ``churn_rate=0`` is full coverage, 1 an
    empty fleet; the bound is compared in fp32, as the reference's
    weakly typed float is."""
    return pos < (1.0 - churn_rate) * road_length_m
