"""Dot-based garbage-collection tracking.

Reference: fantoch/src/protocol/gc.rs:8-143.  The GC worker of each process
tracks (a) its own committed clock (an AEClock) and (b) the committed
VClocks received from every peer; the *stable* frontier is the meet of all
clocks — dots below it are committed everywhere and safe to GC.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from fantoch_tpu_torch.core.clocks import AEClock, VClock
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId, process_ids


class GCTrack:
    def __init__(self, process_id: ProcessId, shard_id: ShardId, n: int):
        self._process_id = process_id
        self._shard_id = shard_id
        self._n = n
        self._my_clock: AEClock[ProcessId] = AEClock(process_ids(shard_id, n))
        self._all_but_me: Dict[ProcessId, VClock[ProcessId]] = {}
        self._previous_stable: VClock[ProcessId] = VClock(process_ids(shard_id, n))

    def clock(self) -> VClock[ProcessId]:
        """Contiguous frontier of locally committed dots."""
        return self._my_clock.frontier()

    def my_clock(self) -> AEClock[ProcessId]:
        """Copy of the full committed clock (frontier + above-exceptions):
        the horizon a restarted replica sends with MSync.  Unlike
        ``_cmds`` this is never trimmed by GC, so it also covers commits
        whose info was already collected locally."""
        return self._my_clock.copy()

    def contains(self, dot: Dot) -> bool:
        """Whether ``dot`` was ever committed here (GC'd or not)."""
        events = self._my_clock.get(dot.source)
        return events is not None and events.contains(dot.sequence)

    def add_to_clock(self, dot: Dot) -> None:
        self._my_clock.add(dot.source, dot.sequence)
        assert len(self._my_clock) == self._n, "dots must belong to this shard"

    def update_clock(self, clock: AEClock[ProcessId]) -> None:
        """Replace the local clock (used when the executor drives GC)."""
        self._my_clock = clock
        assert len(self._my_clock) == self._n

    def update_clock_of(self, from_: ProcessId, clock: VClock[ProcessId]) -> None:
        """Join knowledge about `from_`'s committed clock (messages can be
        reordered, so replacing would not be monotone)."""
        current = self._all_but_me.get(from_)
        if current is None:
            # copy: the same message object may be delivered to many simulated
            # processes; aliasing it would leak commit knowledge across them
            self._all_but_me[from_] = clock.copy()
        else:
            current.join(clock)

    def stable(self) -> List[Tuple[ProcessId, int, int]]:
        """Newly-stable dot ranges [(process, start, end)] since last call
        (gc.rs:72-116)."""
        new_stable = self._stable_clock()
        dots: List[Tuple[ProcessId, int, int]] = []
        for process_id, previous in self._previous_stable.items():
            current = new_stable.get(process_id)
            start, end = previous + 1, current
            # never go backwards (reordered/multiplexed messages)
            new_stable.add(process_id, previous)
            if start <= end:
                dots.append((process_id, start, end))
        self._previous_stable = new_stable
        return dots

    def _stable_clock(self) -> VClock[ProcessId]:
        """Meet of all processes' committed clocks (gc.rs:120-137)."""
        if len(self._all_but_me) != self._n - 1:
            # no stable dots until we have info from every process
            return VClock(process_ids(self._shard_id, self._n))
        stable = self._my_clock.frontier()
        for clock in self._all_but_me.values():
            stable.meet(clock)
        return stable
