"""Deterministic fault injection: replayable failure schedules for the
preemption tests and ``chip_smoke.py`` (the reference's
``repro.launch.faults``, the same grammar).

A fault *plan* is a semicolon-separated list of directives in the
``REPRO_FAULTS`` environment variable (or passed explicitly to
``parse_plan``)::

    REPRO_FAULTS="sigkill@checkpoint-saved:round=2;overflow@resume"

Each directive is ``ACTION@EVENT[:k=v,...]``.  Instrumented code calls
``fire(event, **context)`` at well-known points; when a directive's
event matches and every ``k=v`` parameter matches the fired context
(string-compared), its action executes:

- ``sigkill``: ``os.kill(os.getpid(), SIGKILL)``, the hard death a
  preempted job or an OOM-killed sweep sees.  No cleanup, no
  ``atexit``, no flushing: exactly what the atomic writes and the
  checkpoint recovery must survive.
- ``exit[=code]``: ``os._exit(code)`` (default 3), an abrupt death with
  an exit code.

Non-terminal behaviour switches use ``active(action, event, **ctx)``
instead: ``overflow@resume`` makes a restored ``FLSimulation`` force
the windowed election's overflow, so every round after the resume takes
the dense re-run (``fl/rounds.py::FLSimulation.restore_state``).

Events (grep for ``faults.fire``):

=====================  =====================================  ==========
event                  fired by                               params
=====================  =====================================  ==========
``round-done``         the round drivers (``run_schedule``,   ``round``
                       the sweep's seed group), every round
``checkpoint-saved``   the same, after a round's snapshot     ``round``
``group-done``         the sweep, after each (cell, scenario) ``index``
                       group's rows reach the CSV
``resume``             ``restore_state``, via ``active``      --
=====================  =====================================  ==========

The reference's ``mh-child-start`` belongs to its multi-host launcher,
which the port does not have yet (ROADMAP A11b).

Nothing here imports torch: the plan is re-read from the environment on
every ``fire``/``active``, so subprocesses inherit schedules without any
setup, and ``main()`` exposes the file-corruption helpers (``truncate``,
``flipbyte``) to shell steps::

    python -m repro_torch.launch.faults flipbyte FILE OFFSET
"""
from __future__ import annotations

import os
import signal
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ENV_VAR = "REPRO_FAULTS"

_TERMINAL_ACTIONS = ("sigkill", "exit")


@dataclass(frozen=True)
class FaultDirective:
    action: str            # "sigkill" | "exit" | a behaviour switch name
    event: str             # event name matched against fire()/active()
    params: Tuple[Tuple[str, str], ...] = ()   # ((key, value), ...)
    code: int = 3          # exit code for action == "exit"

    def matches(self, event: str, ctx: Dict[str, object]) -> bool:
        if event != self.event:
            return False
        return all(k in ctx and str(ctx[k]) == v for k, v in self.params)


def parse_plan(spec: Optional[str] = None) -> List[FaultDirective]:
    """Parse a fault plan string (default: ``$REPRO_FAULTS``)."""
    if spec is None:
        spec = os.environ.get(ENV_VAR, "")
    out: List[FaultDirective] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if "@" not in raw:
            raise ValueError(
                f"bad fault directive {raw!r}: want ACTION@EVENT[:k=v,...]")
        action, rest = raw.split("@", 1)
        action = action.strip()
        code = 3
        if action.startswith("exit="):
            code = int(action[5:])
            action = "exit"
        event, _, params_s = rest.partition(":")
        params: List[Tuple[str, str]] = []
        if params_s:
            for kv in params_s.split(","):
                if "=" not in kv:
                    raise ValueError(
                        f"bad fault parameter {kv!r} in {raw!r}")
                k, v = kv.split("=", 1)
                params.append((k.strip(), v.strip()))
        out.append(FaultDirective(action=action, event=event.strip(),
                                  params=tuple(params), code=code))
    return out


def fire(event: str, **ctx: object) -> None:
    """Announce an instrumentation point; execute any matching terminal
    directive (sigkill / exit).  A no-op when no plan is set."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return
    for d in parse_plan(spec):
        if d.action not in _TERMINAL_ACTIONS or not d.matches(event, ctx):
            continue
        sys.stderr.write(
            f"[repro_torch.faults] injecting {d.action} at {event} "
            f"({', '.join(f'{k}={v}' for k, v in ctx.items())})\n")
        sys.stderr.flush()
        if d.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        os._exit(d.code)


def active(action: str, event: str, **ctx: object) -> bool:
    """True when a non-terminal behaviour switch (e.g. ``overflow``)
    matches this event — the caller implements the behaviour."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return False
    return any(d.action == action and d.matches(event, ctx)
               for d in parse_plan(spec))


# -- file corruption helpers (torn-artifact injection) ------------------

def truncate_file(path: str, keep_bytes: int) -> None:
    """Truncate ``path`` to its first ``keep_bytes`` bytes — a torn
    write as left by a crash on a non-atomic writer."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def flip_byte(path: str, offset: int) -> None:
    """XOR the byte at ``offset`` with 0xFF — silent media corruption
    that only a checksum catches."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if len(b) != 1:
            raise ValueError(f"{path}: offset {offset} out of range")
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def main(argv: Optional[List[str]] = None) -> int:
    """CLI for shell steps::

        python -m repro_torch.launch.faults truncate FILE KEEP_BYTES
        python -m repro_torch.launch.faults flipbyte FILE OFFSET
        python -m repro_torch.launch.faults check 'PLAN'   # parse-validate
    """
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(main.__doc__)
        return 2
    cmd = args[0]
    if cmd == "truncate":
        truncate_file(args[1], int(args[2]))
        return 0
    if cmd == "flipbyte":
        flip_byte(args[1], int(args[2]))
        return 0
    if cmd == "check":
        for d in parse_plan(args[1] if len(args) > 1 else None):
            print(d)
        return 0
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
