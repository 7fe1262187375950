"""Cellular throughput model + TCP-Reno CWND-based throughput predictor
(paper §5.1, §6.1), over explicit random fields.

Only the ``*_from_fields`` forms of ``repro.fl.network`` are ported: each
random draw of the round (the pinned channel shadow, the (64, N) Reno
loss uniforms, the upload shadow) enters as a tensor, so the port and
the reference can be fed the same numbers.  Everything here is
elementwise in the client axis and runs on the fields' device; leading
axes (the sweep's seeds) broadcast through, each seed's values those of
its own (N,) call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NetworkConfig:
    road_length_m: float = 1000.0
    n_bs: int = 3
    best_rate_bps: float = 10.4e6
    worst_rate_bps: float = 0.24e6
    shadowing_sigma_db: float = 2.0
    packet_bytes: int = 1500
    rtt_s: float = 0.05                # vehicle<->BS loop for Reno dynamics
    cwnd_history: int = 16
    seed: int = 0


# Reno is simulated for this many RTTs before the CWND window is read
CWND_STEPS = 64

# the predictor evaluates the channel at a pinned shadowing realization,
# drawn once from this seed
_PINNED_CHANNEL_SEED = 0


def pinned_channel_shadow(n: int, device=None) -> torch.Tensor:
    """The predictor's pinned standard-normal shadow over ``n`` clients
    (standalone runs; parity tests inject the reference's field)."""
    g = torch.Generator().manual_seed(_PINNED_CHANNEL_SEED)
    return torch.randn(n, generator=g).to(device)


def draw_round_fields(n: int, gen: torch.Generator,
                      steps: int = CWND_STEPS):
    """One round's network draws from ``gen``: ``(loss_u (steps, n)
    uniforms, upload_shadow (n,) normals)`` on the CPU."""
    return (torch.rand(steps, n, generator=gen),
            torch.randn(n, generator=gen))


def true_rate_bps_from_shadow(cfg: NetworkConfig, pos: torch.Tensor,
                              shadow: torch.Tensor) -> torch.Tensor:
    """Achievable rate at ``pos`` given a raw standard-normal shadow."""
    bs_pos = (torch.arange(cfg.n_bs, dtype=torch.float32, device=pos.device)
              + 0.5) * (cfg.road_length_m / cfg.n_bs)
    d = torch.abs(pos[..., None] - bs_pos).min(dim=-1).values
    d_max = cfg.road_length_m / cfg.n_bs / 2.0
    frac = torch.clamp(1.0 - d / d_max, 0.0, 1.0)          # 1 under BS
    log_rate = (np.log10(cfg.worst_rate_bps)
                + frac * (np.log10(cfg.best_rate_bps)
                          - np.log10(cfg.worst_rate_bps)))
    return torch.pow(10.0, log_rate
                     + shadow * (cfg.shadowing_sigma_db / 10.0))


def _loss_prob(cfg: NetworkConfig, rate_bps: torch.Tensor) -> torch.Tensor:
    frac = (torch.log10(rate_bps) - np.log10(cfg.worst_rate_bps)) / (
        np.log10(cfg.best_rate_bps) - np.log10(cfg.worst_rate_bps))
    return torch.clamp(0.08 * (1.0 - frac) + 0.002, 0.002, 0.2)


def cwnd_history_from_fields(cfg: NetworkConfig, pos: torch.Tensor,
                             shadow: torch.Tensor,
                             loss_u: torch.Tensor) -> torch.Tensor:
    """Reno AIMD over precomputed fields -> (..., N, cwnd_history)
    windows.  ``loss_u``: (..., steps, N) uniform loss draws."""
    rate = true_rate_bps_from_shadow(cfg, pos, shadow)
    p_loss = _loss_prob(cfg, rate)
    cap = torch.clamp(rate * cfg.rtt_s / (8.0 * cfg.packet_bytes), min=1.0)
    cwnd = torch.ones_like(pos)
    steps = loss_u.shape[-2]
    hist = []
    for t in range(steps):
        loss = loss_u[..., t, :] < p_loss
        cwnd = torch.where(loss, torch.clamp(cwnd / 2.0, min=1.0),
                           cwnd + 1.0)
        cwnd = torch.minimum(cwnd, cap)                    # rate-limited
        if t >= steps - cfg.cwnd_history:
            hist.append(cwnd)
    return torch.stack(hist, dim=-1)


def predicted_throughput_from_fields(cfg: NetworkConfig, pos: torch.Tensor,
                                     shadow: torch.Tensor,
                                     loss_u: torch.Tensor) -> torch.Tensor:
    """CWND-average predictor (paper §5.1) in bps-equivalent units."""
    h = cwnd_history_from_fields(cfg, pos, shadow, loss_u)
    return h.mean(dim=-1) * 8.0 * cfg.packet_bytes / cfg.rtt_s


def upload_time_s_from_shadow(cfg: NetworkConfig, pos: torch.Tensor,
                              payload_bytes: float, shadow: torch.Tensor,
                              latency_s: float = 0.2) -> torch.Tensor:
    return (payload_bytes * 8.0 / true_rate_bps_from_shadow(cfg, pos, shadow)
            + latency_s)
