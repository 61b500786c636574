"""Timestamp-with-predecessors commons for Caesar.

Reference: fantoch_ps/src/protocol/common/pred/clocks/{mod,quorum}.rs and
.../keys/sequential.rs.  Caesar timestamps are lexicographic
``(seq, process_id)`` pairs — globally unique, totally ordered.  Key clocks
store *which command* sits at each timestamp per key, so a proposal can
split conflicting commands into predecessors (lower timestamp) and
``blocked_by`` (higher timestamp — the wait condition's input).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import Key


@dataclass(frozen=True, order=True)
class Clock:
    """Lexicographic (seq, process_id) timestamp (mod.rs:27-62)."""

    seq: int
    process_id: ProcessId

    @staticmethod
    def zero(process_id: ProcessId) -> "Clock":
        return Clock(0, process_id)

    def is_zero(self) -> bool:
        return self.seq == 0

    def join(self, other: "Clock") -> "Clock":
        """Lexicographic max (mod.rs:41-57)."""
        return max(self, other)


class SequentialKeyClocks:
    """Per-key timestamp->dot maps + a monotone local sequence
    (keys/sequential.rs:13-140)."""

    __slots__ = ("process_id", "shard_id", "_seq", "_clocks")

    def __init__(self, process_id: ProcessId, shard_id: ShardId):
        self.process_id = process_id
        self.shard_id = shard_id
        self._seq = 0
        self._clocks: Dict[Key, Dict[Clock, Dot]] = {}

    def clock_next(self) -> Clock:
        self._seq += 1
        return Clock(self._seq, self.process_id)

    def clock_join(self, other: Clock) -> None:
        self._seq = max(self._seq, other.seq)

    def add(self, dot: Dot, cmd: Command, clock: Clock) -> None:
        """Index `dot` at `clock` on every key of the command; it then gets
        reported as a predecessor of higher-timestamp conflicts."""
        for key in cmd.keys(self.shard_id):
            commands = self._clocks.setdefault(key, {})
            assert clock not in commands, (
                "can't add a timestamp belonging to a command already added"
            )
            commands[clock] = dot

    def remove(self, cmd: Command, clock: Clock) -> None:
        for key in cmd.keys(self.shard_id):
            removed = self._clocks.get(key, {}).pop(clock, None)
            assert removed is not None, (
                "can't remove a timestamp belonging to a command never added"
            )

    def predecessors(
        self,
        dot: Dot,
        cmd: Command,
        clock: Clock,
        higher: Optional[Set[Dot]] = None,
    ) -> Set[Dot]:
        """Conflicting commands with a lower timestamp; fills `higher` with
        the higher-timestamp ones when provided (keys/sequential.rs:77-119)."""
        predecessors: Set[Dot] = set()
        for key in cmd.keys(self.shard_id):
            for cmd_clock, cmd_dot in self._clocks.get(key, {}).items():
                if cmd_clock < clock:
                    predecessors.add(cmd_dot)
                elif cmd_clock > clock:
                    if higher is not None:
                        higher.add(cmd_dot)
                else:
                    assert cmd_dot == dot, (
                        "found different command with the same timestamp"
                    )
        return predecessors

    def max_seq(self, cmd: Command, exclude: Optional[Dot] = None) -> int:
        """Highest timestamp sequence indexed on any of the command's keys
        (0 when none), excluding ``exclude`` (the dot under recovery must
        not floor itself).  The recovery plane's clock floor: every
        conflicting command this replica knows about — committed,
        accepted, executed-but-not-yet-GC'd — sits at or below it, so a
        free-choice recovered clock lifted strictly above the quorum max
        can never land below a timestamp survivors executed past."""
        floor = 0
        for key in cmd.keys(self.shard_id):
            for clock, dot in self._clocks.get(key, {}).items():
                if dot != exclude and clock.seq > floor:
                    floor = clock.seq
        return floor

    @classmethod
    def parallel(cls) -> bool:
        return False


KeyClocks = SequentialKeyClocks


class QuorumClocks:
    """Fast-quorum MProposeAck aggregation: max clock, dep union, AND of oks;
    complete either when the whole fast quorum replied or as soon as a
    majority replied with some not-ok (early slow path, quorum.rs:6-77)."""

    __slots__ = ("fast_quorum_size", "write_quorum_size", "_participants", "clock", "deps", "ok")

    def __init__(self, process_id: ProcessId, fast_quorum_size: int, write_quorum_size: int):
        self.fast_quorum_size = fast_quorum_size
        self.write_quorum_size = write_quorum_size
        self._participants: Set[ProcessId] = set()
        self.clock = Clock.zero(process_id)
        self.deps: Set[Dot] = set()
        self.ok = True

    def contains(self, process_id: ProcessId) -> bool:
        """Duplicate-delivery dedup (as in the mcollectack handlers): counting
        one participant twice would complete the quorum with fewer
        distinct reports — an unsound fast path."""
        return process_id in self._participants

    def add(self, process_id: ProcessId, clock: Clock, deps: Set[Dot], ok: bool) -> None:
        assert len(self._participants) < self.fast_quorum_size
        self._participants.add(process_id)
        self.clock = self.clock.join(clock)
        self.deps.update(deps)
        self.ok = self.ok and ok

    def all(self) -> bool:
        replied = len(self._participants)
        some_not_ok_after_majority = not self.ok and replied >= self.write_quorum_size
        return some_not_ok_after_majority or replied == self.fast_quorum_size

    def aggregated(self) -> Tuple[Clock, Set[Dot], bool]:
        deps, self.deps = self.deps, set()
        return self.clock, deps, self.ok


class QuorumRetries:
    """MRetryAck aggregation: dep union over the write quorum
    (quorum.rs:80-120)."""

    __slots__ = ("write_quorum_size", "_participants", "deps")

    def __init__(self, write_quorum_size: int):
        self.write_quorum_size = write_quorum_size
        self._participants: Set[ProcessId] = set()
        self.deps: Set[Dot] = set()

    def contains(self, process_id: ProcessId) -> bool:
        """Duplicate-delivery dedup (see QuorumClocks.contains)."""
        return process_id in self._participants

    def add(self, process_id: ProcessId, deps: Set[Dot]) -> None:
        assert len(self._participants) < self.write_quorum_size
        self._participants.add(process_id)
        self.deps.update(deps)

    def all(self) -> bool:
        return len(self._participants) == self.write_quorum_size

    def aggregated(self) -> Set[Dot]:
        deps, self.deps = self.deps, set()
        return deps
