"""The client mesh on one host: K ranks under ``torch.distributed``.

The counterpart of ``repro.launch.mesh`` (``parse_mesh_spec``, the
single-host branch of ``client_mesh_context``) and of the client-axis
helpers of ``repro.sharding.api``.  There the K shards of the client
axis are K devices of one jax process inside a ``shard_map``; here they
are K processes, each running one shard's body (``fl/pipeline.py``'s
``*_sharded`` stages), and the collectives of the body are plain
functions on tensors:

=====================  ===========================================
the reference          here
=====================  ===========================================
``psum`` / ``pmax``    ``psum`` / ``pmax`` (``all_reduce``)
``all_gather(tiled)``  ``all_gather`` (``all_gather`` + ``cat``)
``all_to_all(tiled)``  ``all_to_all`` (``all_to_all_single``)
``ppermute`` by d      ``ring_shift(x, d)`` (``batch_isend_irecv``)
=====================  ===========================================

Ranks, devices and backends (``placement``): rank r runs on
``cuda:(r % device_count)``, or on the CPU when asked.  The backend is
NCCL when every rank has a card of its own, and gloo on the CPU and when
ranks share a card (NCCL puts no two ranks of one communicator on one
card).  Gloo takes CUDA tensors only for broadcast and all-reduce, so
with gloo and CUDA tensors every collective here copies its operand to
host memory and the result back, on purpose, and counts the copies in
``ClientMesh.staged``.  Only the collectives' payloads cross; the probe,
the election and the training stay on the card.  Nothing swaps NCCL for
gloo, or the card for the CPU, on its own.

``spawn_ranks`` starts the K ranks with the spawn start method (CUDA
cannot fork), joins them under a deadline, kills every rank when one
fails or the deadline passes, and raises with the failed rank's
traceback.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
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


def placement(k: int, device=None) -> Tuple[List[torch.device], str]:
    """Each rank's device and the backend for K ranks asked to run on
    ``device`` (the card unless ``cpu``): NCCL when each rank has a card
    of its own, gloo otherwise."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * k, "gloo"
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", r % cards) for r in range(k)]
    return devices, "nccl" if cards >= k else "gloo"


def describe(k: int, device=None) -> str:
    """The mesh banner: ranks, cards, backend, and whether collectives
    cross host memory."""
    devices, backend = placement(k, device)
    cards = sorted({str(d) for d in devices})
    where = (f"{len(cards)} card(s) ({', '.join(cards)})"
             if devices[0].type == "cuda" else "the CPU")
    staged = (", collectives staged through host memory"
              if backend == "gloo" and devices[0].type == "cuda" else "")
    return (f"client mesh {CLIENT_AXIS}={k}: {k} ranks on {where}, "
            f"backend {backend}{staged}")


@dataclasses.dataclass
class ClientMesh:
    """One rank's view of the client mesh (the default process group);
    ``staged`` counts the collectives whose operands went through host
    memory, and their bytes each way."""
    rank: int
    size: int
    device: torch.device
    backend: str
    staged: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})

    @property
    def host_staged(self) -> bool:
        """Gloo with tensors on a card: collectives cross host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _collective(mesh: ClientMesh, x: torch.Tensor,
                op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``op`` on a contiguous copy of ``x``, through host memory when the
    mesh stages its collectives."""
    if not mesh.host_staged:
        return op(x.detach().clone().contiguous())
    host = x.detach().to("cpu").contiguous()
    out = op(host)
    mesh.staged["collectives"] += 1
    mesh.staged["bytes"] += (host.numel() * host.element_size()
                             + out.numel() * out.element_size())
    return out.to(mesh.device)


def psum(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``jax.lax.psum``)."""
    def op(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t
    return _collective(mesh, x, op)


def pmax(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """Max over the ranks (``jax.lax.pmax``): exact in any order."""
    def op(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t
    return _collective(mesh, x, op)


def all_gather(mesh: ClientMesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated in rank order along axis 0
    (``jax.lax.all_gather(..., tiled=True)``)."""
    def op(t):
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
    return _collective(mesh, x, op)


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
    return _collective(mesh, x, op)


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
    return _collective(mesh, x, op)


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


def _save(result: Optional[Dict[str, Any]], path: Path) -> None:
    """A rank's result: arrays and tensors into ``path`` (.npz), the rest
    as JSON under the key ``__json__``."""
    arrays, rest = {}, {}
    for key, val in (result or {}).items():
        if torch.is_tensor(val):
            arrays[key] = val.detach().cpu().numpy()
        elif isinstance(val, np.ndarray):
            arrays[key] = val
        else:
            rest[key] = val
    arrays["__json__"] = np.asarray(json.dumps(rest))
    np.savez(path, **arrays)


def _load(path: Path) -> Dict[str, Any]:
    with np.load(path) as z:
        out = {key: z[key] for key in z.files if key != "__json__"}
        out.update(json.loads(str(z["__json__"])))
    return out


def _rank_main(rank: int, k: int, device: str, backend: str, workdir: str,
               timeout: float, threads: Optional[int], fn: Callable,
               args: Sequence, kwargs: Dict[str, Any]) -> None:
    """One rank: join the group, run ``fn(mesh, *args, **kwargs)``, save
    its result; on failure write the traceback beside it and exit
    non-zero."""
    work = Path(workdir)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{work / 'store'}",
            world_size=k, rank=rank, timeout=timedelta(seconds=timeout))
        try:
            result = fn(ClientMesh(rank, k, dev, backend), *args, **kwargs)
        finally:
            dist.destroy_process_group()
        _save(result, work / f"rank{rank}.npz")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, k: int, device=None, *, args: Sequence = (),
                kwargs: Optional[Dict[str, Any]] = None,
                timeout: float = 900.0, threads: Optional[int] = None,
                workdir=None) -> List[Dict[str, Any]]:
    """Run ``fn(mesh, *args, **kwargs)`` on K ranks and return each
    rank's result (a dict of arrays and JSON values), in rank order.

    ``fn`` and its arguments are pickled into the children, so ``fn`` must be
    importable; the children import neither the caller's module (unless
    ``fn`` lives there) nor anything else of it.  The kernels are built
    here, before the ranks start, so the ranks load the cached build.
    The rendezvous is a ``file://`` store in ``workdir`` (a temporary
    directory by default).  If a rank fails, or ``timeout`` seconds
    pass, every rank is killed and the call raises with the tracebacks
    of the ranks that failed.  ``threads`` sets each rank's intra-op
    threads (CPU ranks default to the cores split K ways)."""
    devices, backend = placement(k, device)
    if devices[0].type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    elif threads is None:
        threads = max(1, (os.cpu_count() or 1) // k)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="client_mesh_",
                                     dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            r, k, str(devices[r]), backend, tmp, timeout, threads, fn,
            tuple(args), dict(kwargs or {}))) for r in range(k)]
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
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = "\n".join(
                f"--- rank {r} (exit {procs[r].exitcode})\n" + (
                    (work / f"rank{r}.err").read_text()
                    if (work / f"rank{r}.err").exists()
                    else "killed: no traceback (another rank failed or "
                         f"the {timeout:.0f} s deadline passed)\n")
                for r in failed)
            raise RuntimeError(f"{len(failed)} of {k} mesh ranks failed:\n"
                               f"{errs}")
        return [_load(work / f"rank{r}.npz") for r in range(k)]
