"""How a simulation executes (vs ``FLSimConfig``: what it simulates).

The fields mirror ``repro.fl.runconfig.RunConfig``.  The knobs this
slice of the port does not implement raise ``NotImplementedError``
naming the ROADMAP item that brings them; none is silently ignored.
``overlap_rounds`` defaults to False here: the reference pins its
round-ahead rows bit-identical to the serial ones, so rows do not move.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import mesh_clients

ENGINES = ("batched", "loop")
ELECT_MODES = ("auto", "gather", "windowed")

# fleets at or above this size get the windowed election under "auto"
AUTO_WINDOWED_MIN_CLIENTS = 512


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # batched: one local_train_batch per capacity group; loop: one
    # local_train per survivor and the list FedAvg (the reference path).
    # On the client mesh the loop engine trains every survivor on every
    # rank, as the reference's does on its mesh
    engine: str = "batched"
    fused_probe: bool = True             # fused probe->evaluate kernel
    overlap_rounds: bool = False         # round-ahead scheduler (unported)
    # "clients=K": K ranks of the client mesh (launch/mesh.py) on one
    # host; multihost > 0 (processes over several hosts) is unported
    mesh: Optional[str] = None
    multihost: int = 0
    server: str = "sync"                 # sync | event (event: unported)
    churn_rate: float = 0.0
    staleness: str = "drop"
    staleness_lambda: float = 0.0
    agg_cadence_s: Optional[float] = None
    # DCS election: auto (windowed at N >= AUTO_WINDOWED_MIN_CLIENTS,
    # else gather), gather (dense O(N^2)), windowed (O(N * W) sorted
    # window; an overflow round re-runs through gather, so masks are
    # the dense election's either way)
    elect: str = "auto"
    elect_window: int = 0                # sorted window per side (0 = auto)
    # ring-halo election on the mesh: rank -> segment slots (0 = auto)
    elect_capacity: int = 0
    checkpoint_dir: Optional[str] = None
    resume: bool = False

    def resolved(self) -> "RunConfig":
        """Validate; every unported knob raises here, before any work is
        done."""
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}: "
                             f"{self.engine!r}")
        if self.multihost:
            raise _unported("--multihost (torchrun over several hosts, "
                            "launch/multihost.py, faults.py)", "A11 (rest)")
        mesh_clients(self.mesh)              # a bad spec raises here
        if (self.server != "sync" or self.churn_rate != 0.0
                or self.staleness != "drop" or self.staleness_lambda != 0.0
                or self.agg_cadence_s is not None):
            raise _unported("the event-driven server (server='event', "
                            "churn, staleness, cadence)", "A9")
        if self.checkpoint_dir is not None or self.resume:
            raise _unported("checkpoint_dir / resume", "A10")
        if self.overlap_rounds:
            raise _unported("overlap_rounds=True", "A7")
        if self.elect not in ELECT_MODES:
            raise ValueError(f"elect must be one of {ELECT_MODES}: "
                             f"{self.elect!r}")
        if self.elect_window < 0:
            raise ValueError(f"elect_window must be >= 0: "
                             f"{self.elect_window}")
        if self.elect_capacity < 0:
            raise ValueError(f"elect_capacity must be >= 0: "
                             f"{self.elect_capacity}")
        return self

    def to_stage_config(self, cfg, *, n_clients: int):
        """The prefix's ``StageConfig`` from one ``FLSimConfig``."""
        from repro_torch.fl.pipeline import StageConfig
        from repro_torch.fl.timing import TimingConfig
        elect = self.elect
        if elect == "auto":
            elect = ("windowed" if n_clients >= AUTO_WINDOWED_MIN_CLIENTS
                     else "gather")
        return StageConfig(
            scheme=cfg.scheme, n_clients=n_clients,
            comm_range_m=cfg.comm_range_m, top_m=cfg.top_m,
            e_tau=cfg.e_tau, n_clients_central=cfg.n_clients_central,
            model_bytes=cfg.model_bytes,
            road_length_m=cfg.mobility.road_length_m,
            speed_jitter=cfg.mobility.speed_jitter,
            timing=TimingConfig(cfg.local_epochs, cfg.batch_size,
                                deadline_s=cfg.deadline_s),
            network=cfg.network, fused_probe=self.fused_probe,
            elect=elect, elect_window=self.elect_window,
            elect_capacity=self.elect_capacity)
