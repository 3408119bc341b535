"""Structured logging, crash/warning/happy messages, and the routine path.

TPU-native re-design of the reference's crash module and call-stack tracker
(src/UPSY/basic/crash_mod.f90, call_stack_and_comp_time_tracking.f90):
instead of a hand-maintained routine_path string and MPI_ABORT, we use Python
context managers feeding a per-routine wall-time registry (the resource
tracker), and exceptions carrying the current routine path.
"""

from __future__ import annotations

import sys
import time
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field


_COLOURS = {
    "red": "\033[91m",
    "green": "\033[92m",
    "yellow": "\033[93m",
    "blue": "\033[94m",
    "end": "\033[0m",
}


def colour_string(s: str, colour: str) -> str:
    if not sys.stdout.isatty():
        return s
    return _COLOURS.get(colour, "") + s + _COLOURS["end"]


class CrashError(RuntimeError):
    """Raised by crash(); carries the routine path for diagnostics."""


@dataclass
class _RoutineEntry:
    tcomp: float = 0.0   # accumulated wall time exclusive of children
    ncalls: int = 0


@dataclass
class ResourceTracker:
    """Per-unique-routine-path wall-time accounting.

    Equivalent of the reference's DO_RESOURCE_TRACKING machinery: each tracked
    routine accumulates exclusive wall time under its full path, dumped as a
    dict for the resource-tracking output file.
    """

    entries: dict = field(default_factory=dict)
    _stack: list = field(default_factory=list)   # (name, t_enter, t_child)

    def reset(self):
        self.entries.clear()

    def path(self) -> str:
        return "/".join(name for name, _, _ in self._stack) or "<root>"

    def enter(self, name: str):
        self._stack.append((name, time.perf_counter(), 0.0))

    def exit(self, name: str):
        top_name, t_enter, t_child = self._stack.pop()
        assert top_name == name, f"routine stack corrupt: {top_name} != {name}"
        dt = time.perf_counter() - t_enter
        key = "/".join([n for n, _, _ in self._stack] + [name])
        e = self.entries.setdefault(key, _RoutineEntry())
        e.tcomp += dt - t_child
        e.ncalls += 1
        if self._stack:
            pn, pt, pc = self._stack[-1]
            self._stack[-1] = (pn, pt, pc + dt)

    def report(self, top_n: int = 30) -> str:
        rows = sorted(self.entries.items(), key=lambda kv: -kv[1].tcomp)
        lines = [f"{'routine':70s} {'t_excl [s]':>12s} {'calls':>8s}"]
        for k, e in rows[:top_n]:
            lines.append(f"{k[:70]:70s} {e.tcomp:12.4f} {e.ncalls:8d}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"tcomp": e.tcomp, "ncalls": e.ncalls}
                for k, e in self.entries.items()}


_tracker = ResourceTracker()
_tracker_lock = threading.Lock()


def get_tracker() -> ResourceTracker:
    return _tracker


@contextmanager
def routine(name: str):
    """Bracket a routine for the call-stack / resource tracker.

    Usage:  with routine('solve_SIA'): ...
    """
    _tracker.enter(name)
    try:
        yield
    finally:
        _tracker.exit(name)


def crash(msg: str, *args, **kwargs):
    """Fatal error: raise with routine path (reference crash())."""
    path = _tracker.path()
    raise CrashError(f"{path}: {msg.format(*args, **kwargs)}")


def warning(msg: str, *args, **kwargs):
    path = _tracker.path()
    print(colour_string(f"WARNING: {path}: {msg.format(*args, **kwargs)}", "yellow"),
          file=sys.stderr)


def happy(msg: str, *args, **kwargs):
    print(colour_string(msg.format(*args, **kwargs), "green"))
