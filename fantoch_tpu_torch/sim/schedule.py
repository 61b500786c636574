"""Discrete-event schedule: a min-heap of (time, action).

Reference: fantoch/src/sim/schedule.rs:6-60.  Popping advances the virtual
clock to the entry's schedule time.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Generic, List, Optional, Tuple, TypeVar

from fantoch_tpu_torch.core.timing import SimTime

A = TypeVar("A")


class Schedule(Generic[A]):
    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, A]] = []
        # tie-breaker keeps heap entries comparable without ordering actions
        # (insertion order within the same millisecond, like the reference's
        # arbitrary BinaryHeap tie order)
        self._counter = itertools.count()

    def schedule(self, time: SimTime, delay_ms: int, action: A) -> None:
        heapq.heappush(self._heap, (time.millis() + delay_ms, next(self._counter), action))

    def next_action(self, time: SimTime) -> Optional[A]:
        if not self._heap:
            return None
        schedule_time, _, action = heapq.heappop(self._heap)
        time.set_millis(schedule_time)
        return action

    def __len__(self) -> int:
        return len(self._heap)

    def actions(self):
        """Iterate pending actions (heap order, not delivery order) —
        the telemetry tick uses this to detect that it is the only thing
        left alive and stand down instead of spinning the loop forever."""
        for _time, _tie, action in self._heap:
            yield action
