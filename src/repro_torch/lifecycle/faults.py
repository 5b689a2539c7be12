"""Deterministic fault injection for the durable write plane (the port's
own copy of ``repro/lifecycle/faults.py``). The installed schedule is a
global of *this* module: a schedule installed in the JAX package's
``faults`` never fires here, and the other way round.

Crash-safety claims are only as good as the crashes they were tested
against, so the write path (wal.py / persist.py / mutable.py) is seeded
with *named injection points* — ``fault_point("wal.append.pre_fsync",
path=...)`` calls at the exact instants a real crash would bite:

    wal.append.pre_write            before the frame hits the file
    wal.append.pre_fsync            frame written, not yet fsync'd
    persist.shard.mid_write         between two shard files of a save
    persist.manifest.pre_write      shards written, manifest not yet
    persist.swap.between_renames    old checkpoint swapped aside, new one
                                    not yet promoted (the crash window the
                                    persist.py docstring documents)
    persist.swap.post_promote       new checkpoint promoted, swapped-aside
                                    old copy not yet reaped
    compact.mid_pack                COMPACT record logged, re-pack not done

The streaming front-end (serving/frontend.py) adds serve-loop points so
overload behavior is deterministically testable:

    frontend.dispatch.slow_executor before a formed batch executes
                                    (``delay:<ms>`` = a stalled device)
    frontend.queue.overflow         an over-capacity submit was just shed
                                    (fires *after* the typed rejection,
                                    so a ``raise`` can never hang it)
    frontend.clock.skew             every frontend clock read
                                    (``skew:<ms>`` jumps one reading)

With no schedule installed a point is one global load + ``None`` check —
nothing on the hot path pays for testability. Tests install a seeded
:class:`FaultSchedule` that fires a chosen *action* on the nth hit of a
point: ``raise`` (an exception unwinds the writer), ``exit`` (hard
``os._exit`` — the in-process stand-in for SIGKILL), a torn-write
corruption of the file the point is touching (``truncate`` / ``bitflip``
/ ``zero``, then raise), or one of the parametric serve-loop actions:
``delay:<ms>`` (sleep that long at the point, then return normally — a
slow executor, not a crash) and ``skew:<ms>`` (return the offset as the
point's payload; the call site applies it to its clock reading).
Corruption offsets come from the schedule's own seeded rng, so a failing
case replays exactly.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

import numpy as np

#: actions that damage the file at the injection point before raising
CORRUPT_ACTIONS = ("truncate", "bitflip", "zero")
#: parametric actions, spelled ``name:<ms>`` — these do not raise
PARAM_ACTIONS = ("delay", "skew")
ACTIONS = ("raise", "exit") + CORRUPT_ACTIONS


def _parse_action(action: str) -> tuple[str, float | None]:
    """Split ``"delay:50"`` into ``("delay", 50.0)``; plain actions
    come back with a ``None`` argument."""
    base, sep, arg = action.partition(":")
    if not sep:
        return action, None
    try:
        return base, float(arg)
    except ValueError:
        return action, None


class FaultInjected(RuntimeError):
    """Raised by a firing injection point (stands in for the crash)."""

    def __init__(self, point: str, action: str):
        super().__init__(f"injected fault at {point!r} (action={action})")
        self.point = point
        self.action = action


def _corrupt(path: str, action: str, rng: np.random.Generator) -> None:
    """Damage the tail of ``path`` the way a torn write would."""
    size = os.path.getsize(path)
    if size == 0:
        return
    if action == "truncate":
        cut = int(rng.integers(1, min(64, size) + 1))
        os.truncate(path, size - cut)
    elif action == "bitflip":
        off = size - 1 - int(rng.integers(min(256, size)))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ (1 << int(rng.integers(8)))]))
    elif action == "zero":
        n = int(rng.integers(1, min(128, size) + 1))
        with open(path, "r+b") as f:
            f.seek(size - n)
            f.write(b"\x00" * n)
    else:                                    # pragma: no cover
        raise ValueError(f"unknown corrupt action {action!r}")


class FaultSchedule:
    """A deterministic plan of which injection points fire, and how.

    ``plan`` is a list of ``(point, nth, action)``: fire ``action`` on the
    ``nth`` (1-based) time ``point`` is hit, once. Hit counts for every
    point are kept (``hits``) so tests can assert coverage; fired entries
    are recorded in ``fired``.
    """

    def __init__(self, plan: list[tuple[str, int, str]], seed: int = 0):
        for point, nth, action in plan:
            base, arg = _parse_action(action)
            if base in PARAM_ACTIONS:
                if arg is None or arg < 0:
                    raise ValueError(
                        f"parametric action {action!r} needs a "
                        f"non-negative ms argument, e.g. '{base}:50'")
            elif action not in ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r}; choose from "
                    f"{ACTIONS + PARAM_ACTIONS}")
            if nth < 1:
                raise ValueError(f"nth is 1-based, got {nth}")
        self.plan = list(plan)
        self.hits: dict[str, int] = {}
        self.fired: list[tuple[str, str]] = []
        self._done: set[int] = set()
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def on_point(self, point: str, path: str | None) -> float | None:
        with self._lock:
            n = self.hits.get(point, 0) + 1
            self.hits[point] = n
            to_fire = None
            for i, (p, nth, action) in enumerate(self.plan):
                if i not in self._done and p == point and nth == n:
                    self._done.add(i)
                    to_fire = action
                    break
        if to_fire is not None:
            return self._fire(point, to_fire, path)
        return None

    def _fire(self, point: str, action: str,
              path: str | None) -> float | None:
        self.fired.append((point, action))
        base, arg = _parse_action(action)
        if base == "delay":                  # a stall, not a crash
            time.sleep(arg / 1e3)
            return None
        if base == "skew":                   # payload for the call site
            return arg
        if action == "exit":
            os._exit(17)                     # hard death: no finally blocks
        if action in CORRUPT_ACTIONS:
            if path is None:
                raise ValueError(
                    f"point {point!r} carries no file path; corrupt "
                    f"actions need one")
            _corrupt(path, action, self._rng)
        raise FaultInjected(point, action)


_ACTIVE: FaultSchedule | None = None


def fault_point(name: str, path: str | None = None) -> float | None:
    """A named crash site. No-op unless a schedule is installed.
    Returns the firing action's payload (``skew:<ms>`` actions) or
    None; crash-style actions raise instead of returning."""
    schedule = _ACTIVE
    if schedule is not None:
        return schedule.on_point(name, path)
    return None


@contextmanager
def install(schedule: FaultSchedule):
    """Install ``schedule`` for the duration of the with-block."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultSchedule is already installed")
    _ACTIVE = schedule
    try:
        yield schedule
    finally:
        _ACTIVE = None
