"""Timestamp-vote commons for Newt/Tempo: vote ranges, per-key clocks, and
quorum clock aggregation.

Reference: fantoch_ps/src/protocol/common/table/votes.rs (Votes/VoteRange
with adjacent-range compression), .../table/clocks/keys/sequential.rs
(proposal = bump each key clock to max(min_clock, clock+1) and vote the
consumed range), .../table/clocks/quorum.rs (max clock + count-of-max).

The tensor analog of ``proposal`` is a scatter-max over key-hash buckets
(see ops/table_ops.py): each committed batch bumps ``clock[key]`` with one
scatter-max and the consumed ranges fall out as
``(old_clock+1, new_clock)`` per key — vote ranges are born compressed.
This module is the host control-plane twin used by the protocol state
machine and the simulator tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import Key


@dataclass
class VoteRange:
    """Votes ``start..=end`` on some key by process ``by``
    (votes.rs:103-155)."""

    by: ProcessId
    start: int
    end: int

    def __post_init__(self) -> None:
        assert self.start <= self.end

    def try_compress(self, other: "VoteRange") -> bool:
        """Extend self with `other` if contiguous; True on success
        (votes.rs:133-148)."""
        assert self.by == other.by
        if self.end + 1 == other.start:
            self.end = other.end
            return True
        return False

    def votes(self) -> List[int]:
        return list(range(self.start, self.end + 1))

    def __repr__(self) -> str:
        if self.start == self.end:
            return f"<{self.by}: {self.start}>"
        return f"<{self.by}: {self.start}-{self.end}>"


class Votes:
    """All votes on some command: key -> list of VoteRange (votes.rs:8-100)."""

    __slots__ = ("_votes",)

    def __init__(self) -> None:
        self._votes: Dict[Key, List[VoteRange]] = {}

    def add(self, key: Key, vote: VoteRange) -> None:
        """Append, compressing with the last range when contiguous and by
        the same voter (a detached accumulator can interleave voters: a
        recovered noop's carried votes merge foreign ranges in before the
        next own-clock bump appends)."""
        current = self._votes.setdefault(key, [])
        if current and current[-1].by == vote.by and current[-1].try_compress(vote):
            return
        current.append(vote)

    def set(self, key: Key, key_votes: List[VoteRange]) -> None:
        assert key not in self._votes
        self._votes[key] = key_votes

    def merge(self, remote: "Votes") -> None:
        for key, key_votes in remote._votes.items():
            self._votes.setdefault(key, []).extend(key_votes)

    def get(self, key: Key) -> List[VoteRange]:
        return self._votes.get(key, [])

    def remove(self, key: Key) -> List[VoteRange]:
        return self._votes.pop(key, [])

    def __len__(self) -> int:
        return len(self._votes)

    def is_empty(self) -> bool:
        return not self._votes

    def __iter__(self) -> Iterator[Tuple[Key, List[VoteRange]]]:
        return iter(self._votes.items())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Votes) and self._votes == other._votes

    def __repr__(self) -> str:
        return f"Votes({self._votes})"


class SequentialKeyClocks:
    """Per-key timestamp clocks with vote generation (sequential.rs:9-105).

    ``proposal`` bumps every key of the command to
    ``max(min_clock, highest-key-clock + 1)`` and returns the consumed vote
    ranges; ``detached``/``detached_all`` vote up to a target clock without
    proposing (used by clock-bump and commit notifications).
    """

    __slots__ = ("process_id", "shard_id", "_clocks")

    def __init__(self, process_id: ProcessId, shard_id: ShardId):
        self.process_id = process_id
        self.shard_id = shard_id
        self._clocks: Dict[Key, int] = {}

    def init_clocks(self, cmd: Command) -> None:
        """Ensure a clock exists per key so periodic bumps cover it."""
        for key in cmd.keys(self.shard_id):
            self._clocks.setdefault(key, 0)

    def proposal(self, cmd: Command, min_clock: int) -> Tuple[int, Votes]:
        clock = max(min_clock, self._cmd_clock(cmd) + 1)
        votes = Votes()
        self.detached(cmd, clock, votes)
        return clock, votes

    def detached(self, cmd: Command, up_to: int, votes: Votes) -> None:
        for key in cmd.keys(self.shard_id):
            self._maybe_bump(key, up_to, votes)

    def detached_all(self, up_to: int, votes: Votes) -> None:
        for key in self._clocks:
            self._maybe_bump(key, up_to, votes)

    def backfill_votes(self) -> Votes:
        """Re-statement of every vote this process ever issued: one
        ``[1, clock]`` range per known key.  Proposals and detached bumps
        both advance ``_clocks`` by exactly the ranges they vote, so a
        process's issued votes on a key are always the contiguous prefix
        up to its clock.  Safe to re-send wholesale (ranges dedup in the
        vote tables) — the rejoin plane (protocol/sync.py) uses it to
        heal the vote-frontier gaps a restarted replica would otherwise
        stall below forever."""
        votes = Votes()
        for key, clock in self._clocks.items():
            if clock > 0:
                votes.add(key, VoteRange(self.process_id, 1, clock))
        return votes

    @classmethod
    def parallel(cls) -> bool:
        return False

    def _cmd_clock(self, cmd: Command) -> int:
        return max(
            (self._clocks.get(key, 0) for key in cmd.keys(self.shard_id)),
            default=0,
        )

    def _maybe_bump(self, key: Key, up_to: int, votes: Votes) -> None:
        current = self._clocks.get(key, 0)
        if current < up_to:
            votes.add(key, VoteRange(self.process_id, current + 1, up_to))
            self._clocks[key] = up_to


# the default key-clocks; an Atomic/Locked split is unnecessary here — worker
# parallelism in the device runner batches proposals through one device step
# instead of sharing mutable clock maps across threads (see ops/)
KeyClocks = SequentialKeyClocks


class QuorumClocks:
    """Aggregates clocks reported by the fast quorum: tracks the max and how
    many times it was reported (quorum.rs:6-60)."""

    __slots__ = ("fast_quorum_size", "_participants", "max_clock", "max_clock_count")

    def __init__(self, fast_quorum_size: int):
        self.fast_quorum_size = fast_quorum_size
        self._participants: set = set()
        self.max_clock = 0
        self.max_clock_count = 0

    def contains(self, process_id: ProcessId) -> bool:
        """Already counted?  Handlers drop duplicate acks BEFORE add: a
        duplicated delivery (the sim's at-least-once nemesis) would
        double-count ``max_clock_count`` — and a spuriously-met ``>= f``
        max-count is an unsound fast-path commit (fuzzer-found)."""
        return process_id in self._participants

    def add(self, process_id: ProcessId, clock: int) -> Tuple[int, int]:
        assert process_id not in self._participants, "duplicate ack"
        assert len(self._participants) < self.fast_quorum_size
        self._participants.add(process_id)
        if clock > self.max_clock:
            self.max_clock = clock
            self.max_clock_count = 1
        elif clock == self.max_clock:
            self.max_clock_count += 1
        return self.max_clock, self.max_clock_count

    def all(self) -> bool:
        return len(self._participants) == self.fast_quorum_size
