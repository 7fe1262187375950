"""Multi-process launch plumbing: ``--multihost P`` (the reference's
``repro.launch.multihost``; argparse and subprocess only, so a launcher
parses its flags before anything else is imported).

``--multihost P`` runs a launcher as P cooperating processes, the
"hosts" of the client mesh.  On one machine this emulates a multi-host
fleet: the parent picks a free coordinator port and re-executes its own
``python -m <module> <argv>`` P times with the hidden
``--_mh-coord/--_mh-procs/--_mh-proc-id`` flags appended.  A child sees
``--_mh-proc-id`` and, instead of re-spawning, starts its K / P ranks of
the ``clients=K`` mesh (``launch/mesh.py::spawn_ranks``), which join one
world of K at the coordinator.  Output-writing call sites gate on the
lead host (process 0) and on global rank 0.
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple


def retry_with_backoff(fn: Callable, *, attempts: int = 3,
                       base_delay_s: float = 1.0,
                       desc: str = "operation"):
    """Call ``fn()`` with bounded retries and exponential backoff (1x,
    2x, 4x ... ``base_delay_s``).  The final failure re-raises the last
    error wrapped with ``desc`` and the attempt count, so an init that
    keeps failing (a peer that never comes up) says what was retried
    instead of ending in a bare timeout."""
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:          # noqa: BLE001 (re-raised below)
            last = e
            if attempt + 1 < attempts:
                delay = base_delay_s * (2 ** attempt)
                print(f"[multihost] {desc} failed "
                      f"(attempt {attempt + 1}/{attempts}): {e}; "
                      f"retrying in {delay:.0f}s", file=sys.stderr,
                      flush=True)
                time.sleep(delay)
    raise RuntimeError(
        f"{desc} failed after {attempts} attempts: {last}") from last


def add_multihost_arguments(ap) -> None:
    """Install ``--multihost`` plus the hidden child-process flags."""
    ap.add_argument("--multihost", type=int, default=0, metavar="P",
                    help="run as P cooperating processes (on one machine: "
                         "spawned local processes); the mesh's clients=K "
                         "axis spans all of them (K %% P == 0)")
    ap.add_argument("--_mh-coord", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--_mh-procs", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--_mh-proc-id", type=int, default=None,
                    help=argparse.SUPPRESS)


def multihost_from_args(args) -> Optional[Tuple[str, int, int]]:
    """The child process's ``(coordinator, num_processes, process_id)``,
    or None outside a spawned child."""
    pid = getattr(args, "_mh_proc_id", None)
    if pid is None:
        return None
    return (args._mh_coord, int(args._mh_procs), int(pid))


def should_spawn(args) -> bool:
    """True in the parent process of a ``--multihost P`` launch (P > 1
    and not already a spawned child)."""
    return (getattr(args, "multihost", 0) or 0) > 1 \
        and getattr(args, "_mh_proc_id", None) is None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reap(procs: Sequence[subprocess.Popen],
          grace_s: float = 5.0) -> None:
    """Terminate (then kill) every still-running child."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def spawn_multihost(module: str, argv: Sequence[str], nprocs: int,
                    *, timeout: Optional[float] = None,
                    poll_s: float = 0.2) -> int:
    """Re-launch ``python -m module argv`` as ``nprocs`` coordinated
    child processes and wait.  Child 0 streams to the parent's stdout
    and stderr (it owns every output write); the others keep stderr, so
    a crash shows, and drop stdout.  Returns the largest exit code.

    The parent polls the whole fleet instead of joining one child after
    another: when a child dies with a nonzero status the survivors are
    reaped at once (a dead peer would leave the rest blocked in a
    collective) and the error names the dead child.  ``timeout`` bounds
    the whole launch the same way (exit code 124, as timeout(1))."""
    coord = f"127.0.0.1:{free_port()}"
    procs: List[subprocess.Popen] = []
    for pid in range(nprocs):
        cmd = [sys.executable, "-m", module, *argv,
               "--_mh-coord", coord, "--_mh-procs", str(nprocs),
               "--_mh-proc-id", str(pid)]
        procs.append(subprocess.Popen(
            cmd, stdout=None if pid == 0 else subprocess.DEVNULL))
    deadline = (time.monotonic() + timeout) if timeout else None

    def norm(c: int) -> int:
        # the shell's convention: death by signal S reports 128 + S, so
        # a SIGKILLed child never passes for a success through max()
        return c if c >= 0 else 128 - c

    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return max(norm(c) for c in codes)
            dead = [(rank, c) for rank, c in enumerate(codes)
                    if c is not None and c != 0]
            if dead:
                rank, code = dead[0]
                what = (f"signal {-code}" if code < 0
                        else f"exit code {code}")
                print(f"[multihost] rank {rank}/{nprocs} died with "
                      f"{what}; reaping the surviving processes",
                      file=sys.stderr, flush=True)
                _reap(procs)
                # the children that died on their own: the survivors
                # just terminated would mask the cause with their 143s
                return max(norm(c) for _, c in dead)
            if deadline is not None and time.monotonic() > deadline:
                print(f"[multihost] launch exceeded {timeout:.0f}s; "
                      f"reaping all {nprocs} processes",
                      file=sys.stderr, flush=True)
                _reap(procs)
                return 124
            time.sleep(poll_s)
    finally:
        _reap(procs)
