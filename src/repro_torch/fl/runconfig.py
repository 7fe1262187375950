"""How a simulation executes (vs ``FLSimConfig``: what it simulates).

The fields mirror ``repro.fl.runconfig.RunConfig``, and
``add_run_arguments`` / ``RunConfig.from_args`` its CLI flags, with the
reference's defaults and ``dest`` names, so a command line parses the
same way in both packages.  ``resolved`` validates and promotes as the
reference's does: any churn, weighted staleness or cadence runs the
event-driven server (``fl/async_server.py``).  ``overlap_rounds``
defaults to True, the round-ahead schedule (``rounds.run_schedule``),
whose rows are the serial schedule's bit for bit.  ``checkpoint_dir``
snapshots the round state every ``checkpoint_every`` rounds
(``train/checkpoint.py``) and ``resume`` restores the latest good
snapshot first (``rounds.resume_rows``): a resumed run's rows, masks and
params are the uninterrupted run's bit for bit.  ``multihost`` P > 1
spreads the ``mesh``'s K ranks over P launcher processes
(``launch/multihost.py``); it needs ``mesh="clients=K"`` with K % P ==
0, as the reference's, and P = 1 runs as without it.  The knob the port
does not implement yet, the persistent compilation cache, raises
``NotImplementedError`` naming its ROADMAP item (A14); none is silently
ignored.

Async axis (any non-default value promotes ``server`` to "event"):

- ``churn_rate``: the fraction of the road outside RSU coverage; a
  client past ``(1 - rate) * road_length`` is departed for the round,
  and one that leaves coverage before its upload completes loses it;
- ``staleness``: "drop" keeps the Eq. 6 hard deadline; "weighted"
  trains stragglers too and scales their FedAvg weight by ``1 / (1 +
  staleness_lambda * delay_rounds)``;
- ``agg_cadence_s``: aggregate every ``T`` simulated seconds instead of
  at the round barrier (None: the round period).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import check_multihost, mesh_clients

ENGINES = ("batched", "loop")
ELECT_MODES = ("auto", "gather", "windowed")
SERVERS = ("sync", "event")
STALENESS_MODES = ("drop", "weighted")

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
    overlap_rounds: bool = True          # round-ahead scheduler
    # "clients=K": K ranks of the client mesh (launch/mesh.py); with
    # multihost P > 1 they span P launcher processes, K / P each
    mesh: Optional[str] = None
    multihost: int = 0
    server: str = "sync"                 # sync | event
    churn_rate: float = 0.0              # 0 = full coverage, no churn
    staleness: str = "drop"              # drop | weighted
    staleness_lambda: float = 0.0        # weighted: 1/(1 + lambda * delay)
    agg_cadence_s: Optional[float] = None  # None = round period
    # DCS election: auto (windowed at N >= AUTO_WINDOWED_MIN_CLIENTS,
    # else gather), gather (dense O(N^2)), windowed (O(N * W) sorted
    # window; an overflow round re-runs through gather, so masks are
    # the dense election's either way)
    elect: str = "auto"
    elect_window: int = 0                # sorted window per side (0 = auto)
    # ring-halo election on the mesh: rank -> segment slots (0 = auto)
    elect_capacity: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = False

    def resolved(self) -> "RunConfig":
        """Validate and promote, as the reference's: any churn, weighted
        staleness or cadence promotes ``server`` to "event".  A bad
        knob raises here, before any work is done."""
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}: "
                             f"{self.engine!r}")
        if self.server not in SERVERS:
            raise ValueError(f"server must be one of {SERVERS}: "
                             f"{self.server!r}")
        if self.staleness not in STALENESS_MODES:
            raise ValueError(f"staleness must be one of {STALENESS_MODES}: "
                             f"{self.staleness!r}")
        if not 0.0 <= self.churn_rate <= 1.0:
            raise ValueError(f"churn_rate must be in [0, 1]: "
                             f"{self.churn_rate}")
        if self.staleness_lambda < 0.0:
            raise ValueError(f"staleness_lambda must be >= 0: "
                             f"{self.staleness_lambda}")
        if self.agg_cadence_s is not None and self.agg_cadence_s <= 0.0:
            raise ValueError(f"agg_cadence_s must be > 0: "
                             f"{self.agg_cadence_s}")
        mesh_clients(self.mesh)              # a bad spec raises here
        if self.multihost > 1:
            check_multihost(self.mesh, self.multihost)
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1: "
                             f"{self.checkpoint_every}")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        if self.elect not in ELECT_MODES:
            raise ValueError(f"elect must be one of {ELECT_MODES}: "
                             f"{self.elect!r}")
        if self.elect_window < 0:
            raise ValueError(f"elect_window must be >= 0: "
                             f"{self.elect_window}")
        if self.elect_capacity < 0:
            raise ValueError(f"elect_capacity must be >= 0: "
                             f"{self.elect_capacity}")
        server = self.server
        if (self.churn_rate > 0.0 or self.staleness == "weighted"
                or self.agg_cadence_s is not None):
            server = "event"
        if server == "event" and self.staleness == "weighted" \
                and self.engine != "batched":
            raise ValueError("staleness='weighted' trains stragglers "
                             "through the batched engine; engine="
                             f"{self.engine!r} is not supported")
        if server != self.server:
            return dataclasses.replace(self, server=server)
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
            elect_capacity=self.elect_capacity, churn_rate=self.churn_rate)

    @classmethod
    def from_args(cls, args, base: Optional["RunConfig"] = None
                  ) -> "RunConfig":
        """Build from an argparse namespace (``add_run_arguments``), as
        the reference's: absent attributes keep the ``base`` (default)
        values, ``--compat-aligned-pack`` wins over ``--fused-probe``,
        ``--no-overlap-rounds`` over ``--overlap-rounds``, and an
        ``--agg-cadence`` of 0 is the round period.  Resolved, so a bad
        knob raises here; so does ``--jit-cache-dir`` (unported), which
        the reference keeps beside its ``RunConfig``."""
        if getattr(args, "jit_cache_dir", None) is not None:
            raise _unported("--jit-cache-dir (the persistent compilation "
                            "cache)", "A14")
        run = base or cls()
        kw = {}
        fused = run.fused_probe or bool(getattr(args, "fused_probe", False))
        if getattr(args, "compat_aligned_pack", False):
            fused = False
        kw["fused_probe"] = fused
        overlap = run.overlap_rounds or bool(getattr(args, "overlap_rounds",
                                                     False))
        if getattr(args, "no_overlap_rounds", False):
            overlap = False
        kw["overlap_rounds"] = overlap
        for attr, field in (("engine", "engine"), ("mesh", "mesh"),
                            ("multihost", "multihost"),
                            ("server", "server"),
                            ("staleness", "staleness"),
                            ("churn_rate", "churn_rate"),
                            ("staleness_lambda", "staleness_lambda"),
                            ("agg_cadence", "agg_cadence_s"),
                            ("elect", "elect"),
                            ("elect_window", "elect_window"),
                            ("elect_capacity", "elect_capacity"),
                            ("checkpoint_dir", "checkpoint_dir"),
                            ("checkpoint_every", "checkpoint_every")):
            v = getattr(args, attr, None)
            if v is not None:
                kw[field] = v
        if getattr(args, "resume", False):
            kw["resume"] = True
        if kw.get("agg_cadence_s") == 0.0:       # CLI "0" = round period
            kw["agg_cadence_s"] = None
        return dataclasses.replace(run, **kw).resolved()


def add_run_arguments(ap) -> None:
    """Install the reference's ``RunConfig`` flags on an argparse parser
    (consumed by ``RunConfig.from_args``): the same names, defaults and
    ``dest``s as ``repro.fl.runconfig.add_run_arguments``."""
    ap.add_argument("--mesh", default=None, metavar="clients=K",
                    help="partition the in-round client axis over K ranks "
                         "of torch.distributed on this host (gloo when "
                         "ranks share a card or run on the CPU)")
    ap.add_argument("--fused-probe", action="store_true",
                    help="no-op: the fused probe is the default")
    ap.add_argument("--compat-aligned-pack", action="store_true",
                    help="aligned probe pack + unfused prefix")
    ap.add_argument("--overlap-rounds", action="store_true",
                    help="no-op: the round-ahead scheduler is the default")
    ap.add_argument("--no-overlap-rounds", action="store_true",
                    help="serial round dispatch (disable the round-ahead "
                         "scheduler; the rows are the same)")
    ap.add_argument("--server", choices=SERVERS, default=None,
                    help="sync round barrier (default) or the event-driven "
                         "server")
    ap.add_argument("--churn-rate", type=float, default=None,
                    help="coverage-window churn rate in [0, 1] (implies "
                         "--server event)")
    ap.add_argument("--staleness", choices=STALENESS_MODES, default=None,
                    help="straggler policy: drop (Eq. 6 hard deadline) or "
                         "weighted (1 / (1 + lambda * delay_rounds))")
    ap.add_argument("--staleness-lambda", type=float, default=None,
                    help="staleness decay lambda for --staleness weighted")
    ap.add_argument("--agg-cadence", type=float, default=None,
                    help="aggregation cadence in simulated seconds (0 = the "
                         "round period; implies --server event)")
    ap.add_argument("--elect", choices=ELECT_MODES, default=None,
                    help="DCS election: auto (windowed for fleets of 512 or "
                         "more), gather (dense O(N^2)), windowed (O(N*W) "
                         "sorted window; overflow rounds re-run through "
                         "gather)")
    ap.add_argument("--elect-window", type=int, default=None,
                    help="windowed election: sorted neighbours per side "
                         "(0 = auto-size from fleet density)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write atomic, checksummed per-round state "
                         "snapshots here (preemption safety)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="snapshot cadence in rounds (default 1)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest good checkpoint from "
                         "--checkpoint-dir before running (bit-identical "
                         "continuation)")
