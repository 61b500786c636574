"""Dependency tracking commons for graph-based protocols (EPaxos, Atlas).

Reference: fantoch_ps/src/protocol/common/graph/deps/keys/{mod,sequential}.rs
and .../deps/quorum.rs.  ``KeyDeps`` tracks, per key, the latest command that
touched it — a new command's dependencies are those latest conflicting
commands.  ``QuorumDeps`` aggregates dependency sets reported by fast-quorum
processes with per-dependency report counts, deciding the fast-path
condition (union == reported-by-all for EPaxos, threshold union for Atlas).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Set, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import Key


@dataclass(frozen=True)
class Dependency:
    """A dependency: the dot plus the shards that replicate it (None for
    noops).  Reference: deps/keys/mod.rs:18-35."""

    dot: Dot
    shards: Optional[FrozenSet[ShardId]]

    @staticmethod
    def from_cmd(dot: Dot, cmd: Command) -> "Dependency":
        return Dependency(dot, frozenset(cmd.shards()))

    @staticmethod
    def from_noop(dot: Dot) -> "Dependency":
        return Dependency(dot, None)


class _LatestRW:
    """Per-key (latest read, latest write) slots (locked.rs:10-15)."""

    __slots__ = ("read", "write")

    def __init__(self) -> None:
        self.read: Optional[Dependency] = None
        self.write: Optional[Dependency] = None


class KeyDeps:
    """Latest-per-key conflict index with the read/write split
    (deps/keys/locked.rs:10-122): a read-only command depends only on the
    latest *write* on each key (reads commute) and becomes the latest
    read; a write depends on the latest read AND write and becomes the
    latest write.  Read-heavy workloads thus commit with far fewer
    dependencies than the latest-*access* index of sequential.rs.

    The reference has Sequential (plain map, no split) and Locked (per-key
    RwLock, with the split) variants for worker parallelism; here one
    implementation serves both (see fantoch_tpu/protocol/info.py for the
    rationale) and adopts the Locked variant's sharper conflict relation.
    The batched device counterpart — the intra-batch latest-per-key chain
    — lives in fantoch_tpu/parallel/mesh_step.py (_intra_batch_chain) and
    fantoch_tpu/ops/table_ops.py (scatter-max key clocks).
    """

    def __init__(self, shard_id: ShardId):
        self._shard_id = shard_id
        self._latest: Dict[Key, _LatestRW] = {}
        self._noop_latest: Optional[Dependency] = None

    def add_cmd(
        self, dot: Dot, cmd: Command, past: Optional[Set[Dependency]] = None
    ) -> Set[Dependency]:
        """Record `dot` on each of `cmd`'s keys; returns its dependencies,
        seeded with `past` (remote deps) if given (locked.rs:84-128)."""
        deps: Set[Dependency] = set(past) if past else set()
        new_dep = Dependency.from_cmd(dot, cmd)
        read_only = cmd.read_only
        for key in cmd.keys(self._shard_id):
            entry = self._latest.get(key)
            if entry is None:
                entry = _LatestRW()
                self._latest[key] = entry
            if read_only:
                if entry.write is not None:
                    deps.add(entry.write)
                entry.read = new_dep
            else:
                if entry.read is not None:
                    deps.add(entry.read)
                    # clear the read slot: this write now depends on it, so
                    # later writes are ordered after it transitively — the
                    # reference keeps it (locked.rs:108-110) and ships one
                    # permanently redundant dep per subsequent write
                    entry.read = None
                if entry.write is not None:
                    deps.add(entry.write)
                entry.write = new_dep
        if self._noop_latest is not None:
            deps.add(self._noop_latest)
        return deps

    def add_noop(self, dot: Dot) -> Set[Dependency]:
        """A noop conflicts with everything: depends on every key's latest
        read and write plus the previous noop (locked.rs:130-170)."""
        deps: Set[Dependency] = set()
        prev = self._noop_latest
        self._noop_latest = Dependency.from_noop(dot)
        if prev is not None:
            deps.add(prev)
        for entry in self._latest.values():
            if entry.read is not None:
                deps.add(entry.read)
            if entry.write is not None:
                deps.add(entry.write)
        return deps

    # test-only queries (locked.rs:172-187)
    def cmd_deps(self, cmd: Command) -> Set[Dot]:
        deps: Set[Dot] = set()
        if self._noop_latest is not None:
            deps.add(self._noop_latest.dot)
        for key in cmd.keys(self._shard_id):
            entry = self._latest.get(key)
            if entry is not None:
                if entry.read is not None:
                    deps.add(entry.read.dot)
                if entry.write is not None:
                    deps.add(entry.write.dot)
        return deps

    def noop_deps(self) -> Set[Dot]:
        deps: Set[Dot] = set()
        for entry in self._latest.values():
            if entry.read is not None:
                deps.add(entry.read.dot)
            if entry.write is not None:
                deps.add(entry.write.dot)
        if self._noop_latest is not None:
            deps.add(self._noop_latest.dot)
        return deps

    @classmethod
    def parallel(cls) -> bool:
        return True


class QuorumDeps:
    """Per-dependency report counts over a fast quorum (deps/quorum.rs:8-100)."""

    def __init__(self, fast_quorum_size: int):
        self._fast_quorum_size = fast_quorum_size
        self._participants: Set[ProcessId] = set()
        self._threshold_deps: Dict[Dependency, int] = {}

    def contains(self, process_id: ProcessId) -> bool:
        """Already counted?  Handlers drop duplicate acks BEFORE add: a
        duplicated delivery (the sim's at-least-once nemesis) would
        double-count threshold reports — and a spuriously-met Atlas
        threshold is an unsound fast-path commit (fuzzer-found)."""
        return process_id in self._participants

    def add(self, process_id: ProcessId, deps: Set[Dependency]) -> None:
        assert process_id not in self._participants, "duplicate ack"
        assert len(self._participants) < self._fast_quorum_size
        self._participants.add(process_id)
        for dep in deps:
            self._threshold_deps[dep] = self._threshold_deps.get(dep, 0) + 1

    def all(self) -> bool:
        return len(self._participants) == self._fast_quorum_size

    def check_threshold_union(self, threshold: int) -> Tuple[Set[Dependency], bool]:
        """(union, every dep reported >= threshold times) — Atlas fast path."""
        assert self.all()
        equal = all(count >= threshold for count in self._threshold_deps.values())
        return set(self._threshold_deps), equal

    def check_union(self) -> Tuple[Set[Dependency], bool]:
        """(union, all quorum processes reported identical deps) — EPaxos
        fast path."""
        assert self.all()
        counts = set(self._threshold_deps.values())
        if not counts:
            equal = True  # no deps reported: trivially all equal
        elif len(counts) == 1:
            equal = counts.pop() == self._fast_quorum_size
        else:
            equal = False
        return set(self._threshold_deps), equal
