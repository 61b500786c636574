"""Shared commit-tracking / garbage-collection machinery.

Every leaderless protocol carries the same GC message set
(MCommitDot -> GC worker; periodic MGarbageCollection broadcast of the
committed clock; MStable forwarded to all workers once the meet advances).
The reference duplicates these handlers in each protocol file
(e.g. fantoch/src/protocol/basic.rs:261-315,
fantoch_ps/src/protocol/epaxos.rs:520-600); here they live once as a mixin
over ``self.bp``/``self._gc_track``/``self._cmds``/``self._to_processes``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from fantoch_tpu_torch.core.clocks import VClock
from fantoch_tpu_torch.core.ids import Dot, ProcessId
from fantoch_tpu_torch.protocol.base import ToForward, ToSend
from fantoch_tpu_torch.run.routing import GC_WORKER_INDEX, worker_index_no_shift


@dataclass
class MCommitDot:
    dot: Dot


@dataclass
class MGarbageCollection:
    committed: VClock


@dataclass
class MStable:
    stable: List[Tuple[ProcessId, int, int]]


@dataclass
class GarbageCollectionEvent:
    """Periodic event triggering a GC round."""


class CommitGCMixin:
    """Requires: self.bp (BaseProcess), self._gc_track (GCTrack),
    self._cmds (CommandsInfo), self._to_processes (deque)."""

    def gc_periodic_events(self):
        if self.bp.config.gc_interval_ms is not None:
            return [(GarbageCollectionEvent(), self.bp.config.gc_interval_ms)]
        return []

    def handle_gc_message(self, from_: ProcessId, msg) -> bool:
        """Dispatch a GC message; returns False if `msg` is not one."""
        if isinstance(msg, MCommitDot):
            assert from_ == self.bp.process_id
            self._gc_track.add_to_clock(msg.dot)
        elif isinstance(msg, MGarbageCollection):
            self._gc_track.update_clock_of(from_, msg.committed)
            stable = self._gc_track.stable()
            if stable:
                self._to_processes.append(ToForward(MStable(stable)))
        elif isinstance(msg, MStable):
            assert from_ == self.bp.process_id
            self.bp.stable(self._cmds.gc(msg.stable))
        else:
            return False
        return True

    def note_durable_commits(self, dots) -> None:
        """Restart-replay hook (run/wal.py): fold WAL-tail commit dots
        into the committed clock so the rejoin horizon (MSync) covers
        them — peers must not re-stream commits whose effects the
        executor tail replay already applied (re-applying would execute
        them twice).  Single-shard only, like the sync plane."""
        if self.bp.config.shard_count != 1:
            return
        for dot in dots:
            self._gc_track.add_to_clock(dot)

    def handle_gc_event(self) -> None:
        """Periodic: broadcast our committed clock."""
        committed = self._gc_track.clock()
        self._to_processes.append(
            ToSend(self.bp.all_but_me(), MGarbageCollection(committed))
        )

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None

    @staticmethod
    def event_index(event):
        """Periodic events (GC rounds) run on the reserved GC worker
        (fantoch/src/run/prelude.rs:18)."""
        return worker_index_no_shift(GC_WORKER_INDEX)

    @staticmethod
    def gc_message_index(msg):
        """Worker routing for GC messages; None if `msg` is not one, and the
        MStable broadcast-to-all-workers is represented as (None,)."""
        if isinstance(msg, (MCommitDot, MGarbageCollection)):
            return (worker_index_no_shift(GC_WORKER_INDEX),)
        if isinstance(msg, MStable):
            return (None,)
        return None
