"""Identifier types.

TPU-native rebuild of the reference id layer (fantoch/src/id.rs:7-187):
``ProcessId``/``ClientId`` are plain ints, ``Dot`` (proposal identifier) and
``Rifl`` (request identifier for load balancing) are (source, sequence)
pairs.  Unlike the reference's generic ``Id<S>`` struct, we represent ids as
lightweight frozen dataclasses on the host control plane and as ``int32[2]``
(or packed ``int64``) lanes on device — see :mod:`fantoch_tpu_torch.ops.frontier`.
"""

from __future__ import annotations

import itertools
from typing import Iterator, NamedTuple, Tuple

# Process ids are small ints (reference uses u8); shard ids are ints (u64).
ProcessId = int
ClientId = int
ShardId = int


class Dot(NamedTuple):
    """Proposal identifier: (source process, per-source sequence).

    Reference: fantoch/src/id.rs:12 (``Dot = Id<ProcessId>``).  Ordering is
    lexicographic (source, sequence), matching the reference's derived Ord —
    this ordering is what makes SCC-internal execution order deterministic.

    A NamedTuple, not a frozen dataclass: dots materialize per command on
    every executor/protocol hot path and tuple construction is ~3x
    cheaper than a frozen dataclass's two ``object.__setattr__`` calls;
    ordering, equality, and hashing are field-lexicographic either way.
    """

    source: ProcessId
    sequence: int

    def __str__(self) -> str:  # e.g. "2.17", mirrors Display "source.sequence"
        return f"{self.source}.{self.sequence}"

    def target_shard(self, n: int) -> ShardId:
        """Shard that owns this dot under the id layout of util.process_ids.

        Reference: fantoch/src/id.rs:59-63 — process ids are laid out so shard
        ``s`` owns ids ``s*n+1..=(s+1)*n``.
        """
        return (self.source - 1) // n

    def packed(self) -> int:
        """Pack into a single int (source in high bits) for device tensors."""
        return (self.source << 48) | self.sequence

    @staticmethod
    def unpack(packed: int) -> "Dot":
        return Dot(packed >> 48, packed & ((1 << 48) - 1))


class Rifl(NamedTuple):
    """Request identifier: (client id, client-local sequence).

    Reference: fantoch/src/id.rs:16 (``Rifl = Id<ClientId>``).
    NamedTuple for the same hot-path reason as :class:`Dot`.
    """

    source: ClientId
    sequence: int

    def __str__(self) -> str:
        return f"{self.source}.{self.sequence}"


class IdGen:
    """Sequential id generator (fantoch/src/id.rs:65-92)."""

    def __init__(self, source: int):
        self._source = source
        self._seq = 0

    @property
    def source(self) -> int:
        return self._source

    def next_id(self) -> Dot:
        self._seq += 1
        return Dot(self._source, self._seq)


class RiflGen:
    """Like IdGen but producing Rifls."""

    def __init__(self, source: int):
        self._source = source
        self._seq = 0

    @property
    def source(self) -> int:
        return self._source

    def next_id(self) -> Rifl:
        self._seq += 1
        return Rifl(self._source, self._seq)


class AtomicIdGen:
    """Thread-safe id generator (fantoch/src/id.rs:95-131).

    The reference uses a lock-free AtomicU64; we use itertools.count which is
    atomic under the GIL, with a lock-free fast path.
    """

    def __init__(self, source: int):
        self._source = source
        self._counter = itertools.count(1)

    @property
    def source(self) -> int:
        return self._source

    def next_id(self) -> Dot:
        return Dot(self._source, next(self._counter))

    def resume_after(self, sequence: int) -> None:
        """Restart support: never hand out sequences at or below
        ``sequence`` (the WAL's recovered dot lease).  Boot-time only —
        callers must not race this with next_id."""
        self._counter = itertools.count(sequence + 1)


def process_ids(shard_id: ShardId, n: int) -> Iterator[ProcessId]:
    """Process ids of one shard: shard s owns ids s*n+1..=(s+1)*n.

    Reference: fantoch/src/util.rs:115-123.
    """
    start = shard_id * n + 1
    return iter(range(start, start + n))


def all_process_ids(shard_count: int, n: int) -> Iterator[Tuple[ProcessId, ShardId]]:
    """All (process id, shard id) pairs (fantoch/src/util.rs:125-132)."""
    for shard_id in range(shard_count):
        for process_id in process_ids(shard_id, n):
            yield process_id, shard_id
