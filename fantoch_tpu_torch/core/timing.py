"""Time sources: wall clock for the real runner, virtual clock for the sim.

Reference: fantoch/src/time.rs:3-111 (``SysTime`` trait, ``RunTime``,
``SimTime``).
"""

from __future__ import annotations

import time as _time
from typing import Protocol


class SysTime(Protocol):
    def millis(self) -> int: ...

    def micros(self) -> int: ...


class RunTime:
    """Wall-clock time (fantoch/src/time.rs:9-27)."""

    def millis(self) -> int:
        return _time.time_ns() // 1_000_000

    def micros(self) -> int:
        return _time.time_ns() // 1_000


class SimTime:
    """Settable monotonic virtual clock (fantoch/src/time.rs:30-78).

    Stored in milliseconds; ``micros`` derives from it so simulated
    timestamps are consistent across both granularities.
    """

    def __init__(self, start_millis: int = 0):
        self._millis = start_millis

    def set_millis(self, millis: int) -> None:
        assert millis >= self._millis, "simulation time must be monotonically non-decreasing"
        self._millis = millis

    def add_millis(self, millis: int) -> None:
        assert millis >= 0, "simulation time must be monotonically non-decreasing"
        self._millis += millis

    def millis(self) -> int:
        return self._millis

    def micros(self) -> int:
        return self._millis * 1000
