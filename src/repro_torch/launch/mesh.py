"""The client mesh: K ranks under ``torch.distributed``, on one host or
spread over the P processes of a ``--multihost P`` launch.

The counterpart of ``repro.launch.mesh`` (``parse_mesh_spec``,
``client_mesh_context``) and of the client-axis helpers of
``repro.sharding.api``.  There the K shards of the client axis are K
devices of a jax runtime inside a ``shard_map``; here they are K
processes, each running one shard's body (``fl/pipeline.py``'s
``*_sharded`` stages, ``core/protocol.py``), and the collectives of the
body are plain functions on tensors:

=====================  ===========================================
the reference          here
=====================  ===========================================
``psum`` / ``pmax``    ``psum`` / ``pmax`` (``all_reduce``)
``all_gather(tiled)``  ``all_gather`` (``all_gather`` + ``cat``)
``all_to_all(tiled)``  ``all_to_all`` (``all_to_all_single``)
``ppermute`` by d      ``ring_shift(x, d)`` (``batch_isend_irecv``)
=====================  ===========================================

``ClientMesh.collective_bytes`` counts each collective's output bytes on
this rank by kind (``all_gather``, ``ring_shift``, ``all_reduce``,
``all_to_all``), on every backend: the convention of the reference's
``launch/hlo_cost.py``, which sums the output bytes of the collectives in
the compiled HLO of one device.

Ranks, devices and backends: a host's rank j runs on ``cuda:(j %
device_count)``, or on the CPU when asked.  Before the group forms,
every rank publishes its (hostname, card UUID) through the rendezvous
store, and the whole world takes the same backend: NCCL when every rank
has a card of its own, gloo on the CPU and whenever two ranks share a
card (NCCL puts no two ranks of one communicator on one card).  This is
placement, decided once before the group forms; nothing retries with
another backend after a failure.  Gloo takes CUDA tensors only for
broadcast and all-reduce, so with gloo and CUDA tensors every collective
here copies its operand to host memory and the result back, on purpose,
and counts the copies in ``ClientMesh.staged``.  Only the collectives'
payloads cross; the probe, the election and the training stay on the
card.  Nothing swaps NCCL for gloo, or the card for the CPU, on its own.

``spawn_ranks`` starts a host's ranks with the spawn start method (CUDA
cannot fork), joins them under a deadline, kills every rank when one
fails or the deadline passes, and raises with the failed rank's
traceback.  On one host the rendezvous is a ``file://`` store in a
private directory.  In a ``--multihost P`` child (``launch/multihost.py``)
host p starts global ranks ``p * K / P ... (p + 1) * K / P - 1`` and the
rendezvous is a TCP store at the launch's coordinator, hosted by global
rank 0; joining runs under ``retry_with_backoff`` with
``REPRO_DIST_TIMEOUT_S`` (default 60) seconds an attempt and
``REPRO_DIST_INIT_ATTEMPTS`` (default 3) attempts, and a rank that
cannot join raises naming itself and the coordinator.  There one
``all_gather_object`` at the end of every rank's function brings each
rank's JSON results to every host, so the lead host reports all K.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

CLIENT_AXIS = "clients"


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"clients=8"`` (comma-separable) -> ``{"clients": 8}``."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        name = name.strip()
        if not name or not val:
            raise ValueError(f"bad mesh axis {part!r} (want axis=N)")
        try:
            out[name] = int(val)
        except ValueError:
            raise ValueError(f"bad mesh extent {val!r} for axis {name!r}")
    return out


def mesh_clients(spec: Optional[str]) -> int:
    """The client-axis extent K of a ``--mesh`` spec: 1 for none; an
    axis other than ``clients``, or K < 1, raises."""
    if not spec:
        return 1
    axes = parse_mesh_spec(spec)
    unknown = sorted(set(axes) - {CLIENT_AXIS})
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown} (the FL launchers "
                         f"only partition {CLIENT_AXIS!r})")
    k = axes.get(CLIENT_AXIS, 1)
    if k < 1:
        raise ValueError(f"--mesh {CLIENT_AXIS}={k}: need at least 1")
    return k


def check_multihost(spec: Optional[str], procs: int) -> int:
    """The client-axis extent K of a ``--multihost P`` launch (P > 1):
    the reference's checks, ``--mesh clients=K`` given and K % P == 0."""
    if not spec:
        raise ValueError("--multihost needs --mesh clients=K (the "
                         "client axis is what spans the processes)")
    k = mesh_clients(spec)
    if procs < 1 or k % procs != 0:
        raise ValueError(f"--mesh clients={k} must divide evenly over "
                         f"--multihost {procs} processes")
    return k


def rank_devices(n: int, device=None) -> List[torch.device]:
    """The devices of a host's ``n`` ranks asked to run on ``device``
    (the card unless ``cpu``): rank j on ``cuda:(j % device_count)``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", j % cards) for j in range(n)]


def world_backend(places: Sequence[Sequence[str]]) -> str:
    """The backend for the world whose ranks sit at ``places`` (each
    rank's ``(hostname, card id)``, the card id "cpu" on the CPU): NCCL
    when every rank has a card and no two share one, gloo otherwise."""
    cards = [tuple(p) for p in places]
    if any(card == "cpu" for _, card in cards):
        return "gloo"
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def _card_id(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev).uuid)


COLLECTIVE_KINDS = ("all_gather", "ring_shift", "all_reduce", "all_to_all")


@dataclasses.dataclass
class ClientMesh:
    """One rank's view of the client mesh (the default process group).
    ``hosts`` is the launcher processes the ranks span (``--multihost
    P``), ``cards`` the distinct cards the world's ranks run on (0 on the
    CPU) and ``card_names`` their device names.  ``collective_bytes``
    counts each collective's output bytes on this rank by kind;
    ``staged`` counts the collectives whose operands went through host
    memory, and their bytes each way."""
    rank: int
    size: int
    device: torch.device
    backend: str
    hosts: int = 1
    cards: int = 0
    card_names: Tuple[str, ...] = ()
    staged: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))

    @property
    def host_staged(self) -> bool:
        """Gloo with tensors on a card: collectives cross host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def describe(mesh: ClientMesh) -> str:
    """The mesh banner: ranks, cards, backend, whether collectives cross
    host memory, and the processes the ranks span."""
    where = (f"{mesh.cards} card(s) ({', '.join(mesh.card_names)})"
             if mesh.cards else "the CPU")
    staged = ", collectives staged through host memory" \
        if mesh.host_staged else ""
    hosts = f" / {mesh.hosts} processes" if mesh.hosts > 1 else ""
    return (f"client mesh {CLIENT_AXIS}={mesh.size}: {mesh.size} ranks on "
            f"{where}, backend {mesh.backend}{staged}{hosts}")


def _collective(mesh: ClientMesh, x: torch.Tensor, kind: str,
                op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``op`` on a contiguous copy of ``x``, through host memory when the
    mesh stages its collectives; its output bytes count under
    ``kind``."""
    if not mesh.host_staged:
        out = op(x.detach().clone().contiguous())
    else:
        host = x.detach().to("cpu").contiguous()
        out = op(host)
        mesh.staged["collectives"] += 1
        mesh.staged["bytes"] += (host.numel() * host.element_size()
                                 + out.numel() * out.element_size())
    mesh.collective_bytes[kind] += out.numel() * out.element_size()
    return out.to(mesh.device)


def psum(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``jax.lax.psum``)."""
    def op(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t
    return _collective(mesh, x, "all_reduce", op)


def pmax(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """Max over the ranks (``jax.lax.pmax``): exact in any order."""
    def op(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t
    return _collective(mesh, x, "all_reduce", op)


def all_gather(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated in rank order along axis 0
    (``jax.lax.all_gather(..., tiled=True)``)."""
    def op(t):
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
    return _collective(mesh, x, "all_gather", op)


def all_to_all(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all over axis 0 (``jax.lax.all_to_all(..., tiled=
    True)``): x's rows split into K equal blocks, block j goes to rank
    j, and the output's block j is rank j's block for this rank."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all: axis 0 of {tuple(x.shape)} does not "
                         f"split over {mesh.size} ranks")

    def op(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out
    return _collective(mesh, x, "all_to_all", op)


def ring_shift(mesh: ClientMesh, x: torch.Tensor, d: int) -> torch.Tensor:
    """Rank r sends ``x`` to rank (r + d) mod K and returns what rank
    (r - d) mod K sent (``jax.lax.ppermute`` with pairs (src, src + d))."""
    k = mesh.size

    def op(t):
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, (mesh.rank + d) % k),
            dist.P2POp(dist.irecv, out, (mesh.rank - d) % k)])
        for req in reqs:
            req.wait()
        return out
    return _collective(mesh, x, "ring_shift", op)


# -- spawning the ranks -----------------------------------------------------

def rank_calls(mesh: ClientMesh,
               calls: Sequence[Tuple[Callable, Sequence[Sequence],
                                     Dict[str, Any]]]
               ) -> Dict[str, np.ndarray]:
    """A rank target for sharded functions of the port: for each call
    ``(fn, per_rank, kwargs)``, ``fn(*per_rank[rank], mesh=mesh,
    **kwargs)`` with the rank's numpy arguments as tensors on its
    device.  Call i's result (a tensor, a tuple or a dict of them) comes
    back as ``c{i}_out{j}`` or ``c{i}_{key}``."""
    out = {}
    for i, (fn, per_rank, kwargs) in enumerate(calls):
        args = [torch.as_tensor(a, device=mesh.device)
                if isinstance(a, np.ndarray) else a
                for a in per_rank[mesh.rank]]
        res = fn(*args, mesh=mesh, **kwargs)
        if torch.is_tensor(res):
            res = (res,)
        items = (res.items() if isinstance(res, dict)
                 else ((f"out{j}", r) for j, r in enumerate(res)))
        out.update({f"c{i}_{key}": r.cpu().numpy() for key, r in items})
    return out


def _split(result: Optional[Dict[str, Any]]
           ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A rank's result as (arrays, the JSON rest)."""
    arrays, rest = {}, {}
    for key, val in (result or {}).items():
        if torch.is_tensor(val):
            arrays[key] = val.detach().cpu().numpy()
        elif isinstance(val, np.ndarray):
            arrays[key] = val
        else:
            rest[key] = val
    return arrays, rest


def _save(result: Optional[Dict[str, Any]], path: Path,
          world: Optional[List[Dict[str, Any]]] = None) -> None:
    """A rank's result: arrays and tensors into ``path`` (.npz), the rest
    as JSON under the key ``__json__``, and ``world`` (every rank's JSON
    rest, on a multi-host mesh) under ``__world__``."""
    arrays, rest = _split(result)
    arrays["__json__"] = np.asarray(json.dumps(rest))
    if world is not None:
        arrays["__world__"] = np.asarray(json.dumps(world))
    np.savez(path, **arrays)


def _load(path: Path) -> Tuple[Dict[str, Any], Optional[List[Dict]]]:
    with np.load(path) as z:
        out = {key: z[key] for key in z.files
               if key not in ("__json__", "__world__")}
        out.update(json.loads(str(z["__json__"])))
        world = (json.loads(str(z["__world__"])) if "__world__" in z.files
                 else None)
    return out, world


def _env_number(name: str, default: str) -> int:
    return int(float(os.environ.get(name, default)))


def _join(rank: int, world: int, dev: torch.device,
          rendezvous: Tuple[str, str]) -> Tuple[Any, List[List[str]]]:
    """Connect to the rendezvous store (``("file", path)`` on one host,
    ``("tcp", "host:port")`` across hosts, hosted by rank 0), publish
    this rank's place and read every rank's: ``(store, places)``, each
    place ``[hostname, card id, device]``.  Runs under
    ``retry_with_backoff``; the last error names this rank and the
    coordinator."""
    from repro_torch.launch.multihost import retry_with_backoff
    kind, where = rendezvous
    timeout = timedelta(seconds=_env_number("REPRO_DIST_TIMEOUT_S", "60"))
    store = []

    def connect():
        if not store:
            if kind == "file":
                store.append(dist.FileStore(where, world))
            else:
                host, port = where.rsplit(":", 1)
                store.append(dist.TCPStore(
                    host, int(port), world, is_master=rank == 0,
                    timeout=timeout, wait_for_workers=False))
            store[0].set_timeout(timeout)
        st = store[0]
        st.set(f"placement/{rank}", json.dumps(
            [socket.gethostname(), _card_id(dev), str(dev)]))
        return [json.loads(st.get(f"placement/{r}")) for r in range(world)]

    places = retry_with_backoff(
        connect, attempts=_env_number("REPRO_DIST_INIT_ATTEMPTS", "3"),
        desc=(f"torch.distributed init (rank {rank}/{world} via "
              f"{kind}://{where})"))
    return store[0], places


def _rank_main(rank: int, k: int, hosts: int, device: str,
               rendezvous: Tuple[str, str], workdir: str, timeout: float,
               threads: Optional[int], fn: Callable, args: Sequence,
               kwargs: Dict[str, Any]) -> None:
    """One rank: join the group on the backend the world's places give,
    run ``fn(mesh, *args, **kwargs)`` and save its result; on a
    multi-host mesh, all-gather every rank's JSON results first.  On
    failure write the traceback beside it and exit non-zero."""
    work = Path(workdir)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store, places = _join(rank, k, dev, rendezvous)
        backend = world_backend([p[:2] for p in places])
        dist.init_process_group(backend, store=store, world_size=k,
                                rank=rank,
                                timeout=timedelta(seconds=timeout))
        cards = {tuple(p[:2]) for p in places if p[1] != "cpu"}
        mesh = ClientMesh(rank, k, dev, backend, hosts=hosts,
                          cards=len(cards), card_names=tuple(sorted(
                              {p[2] for p in places if p[1] != "cpu"})))
        world = None
        try:
            result = fn(mesh, *args, **kwargs)
            if hosts > 1:
                world = [None] * k
                dist.all_gather_object(world, _split(result)[1])
        finally:
            dist.destroy_process_group()
        _save(result, work / f"rank{rank}.npz", world)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def spawn_ranks(fn: Callable, k: int, device=None, *, args: Sequence = (),
                kwargs: Optional[Dict[str, Any]] = None,
                timeout: float = 900.0, threads: Optional[int] = None,
                workdir=None,
                multihost: Optional[Tuple[str, int, int]] = None
                ) -> List[Dict[str, Any]]:
    """Run ``fn(mesh, *args, **kwargs)`` on K ranks and return each
    rank's result (a dict of arrays and JSON values), in rank order.

    ``fn`` and its arguments are pickled into the children, so ``fn`` must be
    importable; the children import neither the caller's module (unless
    ``fn`` lives there) nor anything else of it.  The kernels are built
    here, before the ranks start, so the ranks load the cached build.
    If a rank fails, or ``timeout`` seconds pass, every rank of this host
    is killed and the call raises with the tracebacks of the ranks that
    failed.  ``threads`` sets each rank's intra-op threads (CPU ranks
    default to the cores split K ways).

    ``multihost=(coordinator, P, p)``, in a ``--multihost P`` child,
    starts this host's K / P ranks, global ranks ``p * K / P`` on, after
    firing the ``mh-child-start`` fault event (``launch/faults.py``);
    while they run, a SIGTERM (the launch's parent reaping this host)
    unwinds through here and kills them too.  Every rank's JSON results
    come back, the arrays only for this host's ranks."""
    if multihost is None:
        return _run_ranks(fn, k, 1, 0, device, args, kwargs, timeout,
                          threads, workdir, None)
    coord, hosts, pid = multihost
    n = check_multihost(f"{CLIENT_AXIS}={k}", hosts) // hosts
    from repro_torch.launch import faults
    faults.fire("mh-child-start", rank=pid)
    main = threading.current_thread() is threading.main_thread()
    before = signal.signal(signal.SIGTERM, _terminated) if main else None
    try:
        return _run_ranks(fn, k, hosts, pid * n, device, args, kwargs,
                          timeout, threads, workdir, coord)
    finally:
        if main:
            signal.signal(signal.SIGTERM, before)


def _run_ranks(fn, k: int, hosts: int, first: int, device, args, kwargs,
               timeout: float, threads: Optional[int], workdir,
               coord: Optional[str]) -> List[Dict[str, Any]]:
    """Ranks ``first ... first + K / hosts - 1`` of a world of K: start,
    watch, kill on failure, and collect (``spawn_ranks``)."""
    n = k // hosts
    devices = rank_devices(n, device)
    if devices[0].type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    elif threads is None:
        threads = max(1, (os.cpu_count() or 1) // k)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="client_mesh_",
                                     dir=workdir) as tmp:
        rendezvous = (("tcp", coord) if coord is not None
                      else ("file", str(Path(tmp) / "store")))
        procs = [ctx.Process(target=_rank_main, args=(
            first + j, k, hosts, str(devices[j]), rendezvous, tmp, timeout,
            threads, fn, tuple(args), dict(kwargs or {})))
            for j in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break                 # the others may wait on it
                if time.monotonic() > deadline:
                    break
                for p in procs:
                    p.join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        work = Path(tmp)
        failed = [first + j for j, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = "\n".join(
                f"--- rank {r} (exit {procs[r - first].exitcode})\n" + (
                    (work / f"rank{r}.err").read_text()
                    if (work / f"rank{r}.err").exists()
                    else "killed: no traceback (another rank failed or "
                         f"the {timeout:.0f} s deadline passed)\n")
                for r in failed)
            raise RuntimeError(f"{len(failed)} of {n} mesh ranks failed:\n"
                               f"{errs}")
        loaded = [_load(work / f"rank{first + j}.npz") for j in range(n)]
    if hosts == 1:
        return [res for res, _ in loaded]
    world = loaded[0][1]
    return [loaded[r - first][0] if first <= r < first + n else world[r]
            for r in range(k)]
