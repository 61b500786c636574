"""Multi-shard, multi-key commands and their (partially aggregated) results.

Reference: fantoch/src/command.rs:12-262.  A command is a map
``shard -> key -> op`` identified by a Rifl; conflict = key intersection;
results aggregate per-key op results until all keys have reported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple, TYPE_CHECKING

from fantoch_tpu_torch.core.ids import Rifl, ShardId
from fantoch_tpu_torch.core.kvs import KVOp, KVOpResult, Key, KVStore

if TYPE_CHECKING:
    from fantoch_tpu_torch.executor.base import ExecutorResult


class Command:
    """A client command spanning one or more shards (fantoch/src/command.rs:12-170)."""

    __slots__ = ("_rifl", "_shard_to_ops", "_read_only", "_total_key_count")

    def __init__(self, rifl: Rifl, shard_to_ops: Dict[ShardId, Dict[Key, Tuple[KVOp, ...]]]):
        assert shard_to_ops, "commands must have at least one shard"
        self._rifl = rifl
        self._shard_to_ops = shard_to_ops
        # read_only inference (fantoch/src/command.rs:28-36): a command is
        # read-only iff every op on every key is a read.  One pass over the
        # ops — this constructor sits on the client submit path, so no
        # intermediate list / multiple scans.
        reads = 0
        writes = 0
        total = 0
        for ops in shard_to_ops.values():
            total += len(ops)
            for key_ops in ops.values():
                for op in key_ops:
                    if op.is_read:
                        reads += 1
                    else:
                        writes += 1
        self._read_only = writes == 0
        # reference invariant (fantoch/src/command.rs:32-41): either all ops
        # are reads or none are — mixed commands break read-only fast paths
        assert reads == 0 or writes == 0, (
            "non-read-only commands cannot contain Get operations"
        )
        self._total_key_count = total

    @staticmethod
    def from_single(rifl: Rifl, shard_id: ShardId, key: Key, op: KVOp) -> "Command":
        # the dominant wire shape (one shard, one key, one op): the general
        # scan above degenerates to constants, so skip it — single-op
        # commands cannot violate the mixed-ops invariant
        cmd = Command.__new__(Command)
        cmd._rifl = rifl
        cmd._shard_to_ops = {shard_id: {key: (op,)}}
        cmd._read_only = op.is_read
        cmd._total_key_count = 1
        return cmd

    @staticmethod
    def from_keys(rifl: Rifl, shard_id: ShardId, key_ops: Dict[Key, Tuple[KVOp, ...]]) -> "Command":
        return Command(rifl, {shard_id: dict(key_ops)})

    @property
    def rifl(self) -> Rifl:
        return self._rifl

    @property
    def read_only(self) -> bool:
        return self._read_only

    @property
    def shard_count(self) -> int:
        return len(self._shard_to_ops)

    def shards(self) -> Iterator[ShardId]:
        return iter(self._shard_to_ops.keys())

    def replicated_by(self, shard_id: ShardId) -> bool:
        return shard_id in self._shard_to_ops

    def multi_shard(self) -> bool:
        return len(self._shard_to_ops) > 1

    def key_count(self, shard_id: ShardId) -> int:
        """Number of keys accessed on `shard_id` (fantoch/src/command.rs:88)."""
        return len(self._shard_to_ops.get(shard_id, {}))

    @property
    def total_key_count(self) -> int:
        return self._total_key_count

    def keys(self, shard_id: ShardId) -> Iterator[Key]:
        """Keys accessed on a given shard (fantoch/src/command.rs:97-103)."""
        return iter(self._shard_to_ops.get(shard_id, {}).keys())

    def iter_ops(self, shard_id: ShardId) -> Iterator[Tuple[Key, Tuple[KVOp, ...]]]:
        """(key, ops) pairs for one shard (fantoch/src/command.rs into_iter)."""
        return iter(self._shard_to_ops.get(shard_id, {}).items())

    def all_keys(self) -> Iterator[Tuple[ShardId, Key]]:
        for shard_id, ops in self._shard_to_ops.items():
            for key in ops:
                yield shard_id, key

    def conflicts(self, other: "Command") -> bool:
        """Key-intersection conflict check (fantoch/src/command.rs:141-147)."""
        for shard_id, ops in self._shard_to_ops.items():
            other_ops = other._shard_to_ops.get(shard_id)
            if other_ops and not ops.keys().isdisjoint(other_ops.keys()):
                return True
        return False

    def execute(self, shard_id: ShardId, store: KVStore) -> List["ExecutorResult"]:
        """Execute this command's ops for `shard_id`, returning per-key results.

        Reference: fantoch/src/command.rs:114-127.  Returns a list (not a
        generator): this is the serving hot path — one call per executed
        command — and the dominant shape is a single key with a single op,
        which skips the genexpr entirely.
        """
        from fantoch_tpu_torch.executor.base import ExecutorResult

        rifl = self._rifl
        out = []
        for key, key_ops in self._shard_to_ops.get(shard_id, {}).items():
            if len(key_ops) == 1:
                results = (store.execute(key, key_ops[0], rifl),)
            else:
                results = tuple(store.execute(key, op, rifl) for op in key_ops)
            out.append(ExecutorResult(rifl, key, results))
        return out

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Command)
            and self._rifl == other._rifl
            and self._shard_to_ops == other._shard_to_ops
        )

    def __hash__(self) -> int:
        return hash(self._rifl)

    def __repr__(self) -> str:
        keys = {s: sorted(ops) for s, ops in self._shard_to_ops.items()}
        return f"Command({self._rifl}, {keys})"


class CommandResult:
    """Partial aggregation of per-key results for one shard's portion.

    Reference: fantoch/src/command.rs:173-216.  Ready when `key_count` keys
    have reported.
    """

    __slots__ = ("_rifl", "_key_count", "_results")

    def __init__(self, rifl: Rifl, key_count: int):
        self._rifl = rifl
        self._key_count = key_count
        self._results: Dict[Key, Tuple[KVOpResult, ...]] = {}

    @property
    def rifl(self) -> Rifl:
        return self._rifl

    def add_partial(self, key: Key, result: Tuple[KVOpResult, ...]) -> bool:
        """Add one key's results; returns True once the result is ready."""
        assert key not in self._results, f"duplicate partial result for {key}"
        self._results[key] = result
        return self.ready

    def increment_key_count(self, by: int = 1) -> None:
        """Raise the number of expected partials (fantoch/src/command.rs:203)."""
        self._key_count += by

    @property
    def ready(self) -> bool:
        return len(self._results) == self._key_count

    @property
    def results(self) -> Dict[Key, Tuple[KVOpResult, ...]]:
        return self._results

    def merge(self, other: "CommandResult") -> None:
        """Merge results from another shard (used by ShardsPending aggregation)."""
        assert self._rifl == other._rifl
        self._key_count += other._key_count
        for key, res in other._results.items():
            assert key not in self._results
            self._results[key] = res

    def __repr__(self) -> str:
        return f"CommandResult({self._rifl}, {len(self._results)}/{self._key_count})"
