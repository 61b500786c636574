"""Per-dot command info stores.

Reference: fantoch/src/protocol/info/{mod,sequential,locked}.rs.  Each
in-flight dot has an ``Info`` record (protocol-specific) created on first
access and garbage-collected once stable.  The reference's Locked variant
(Arc<SharedMap<Dot, RwLock<I>>>) exists for intra-process worker
parallelism; in this rebuild workers are asyncio tasks in one interpreter, so
a plain dict with the same interface serves both roles (the "parallel"
distinction lives at the batching layer instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, List, Tuple, TypeVar

from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId

I = TypeVar("I")


class CommandsInfo(Generic[I]):
    """dot -> protocol info store with GC (sequential.rs:7-80)."""

    def __init__(
        self,
        process_id: ProcessId,
        shard_id: ShardId,
        config: Config,
        fast_quorum_size: int,
        write_quorum_size: int,
        info_factory: Callable[[ProcessId, ShardId, Config, int, int], I],
    ):
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        self._fast_quorum_size = fast_quorum_size
        self._write_quorum_size = write_quorum_size
        self._factory = info_factory
        self._infos: Dict[Dot, I] = {}

    def get(self, dot: Dot) -> I:
        info = self._infos.get(dot)
        if info is None:
            info = self._factory(
                self._process_id,
                self._shard_id,
                self._config,
                self._fast_quorum_size,
                self._write_quorum_size,
            )
            self._infos[dot] = info
        return info

    def get_existing(self, dot: Dot):
        """Info for `dot` if present, without creating it (the Locked
        variant's `get`, locked.rs:34-44)."""
        return self._infos.get(dot)

    def contains(self, dot: Dot) -> bool:
        return dot in self._infos

    def gc(self, stable: List[Tuple[ProcessId, int, int]]) -> int:
        """Remove all dots in the stable ranges; returns removed count
        (sequential.rs:52-77)."""
        removed = 0
        for process_id, start, end in stable:
            for seq in range(start, end + 1):
                if self._infos.pop(Dot(process_id, seq), None) is not None:
                    removed += 1
        return removed

    def gc_single(self, dot: Dot):
        """Remove and return the info for `dot` (None if absent)."""
        return self._infos.pop(dot, None)

    def items(self):
        """Live (dot, info) pairs (insertion order) — the sync plane's
        scan surface (protocol/sync.py)."""
        return self._infos.items()

    def __len__(self) -> int:
        return len(self._infos)


# Alias used by protocols that declare themselves parallel; see module
# docstring for why this is the same class.
SequentialCommandsInfo = CommandsInfo
LockedCommandsInfo = CommandsInfo
