"""Shared utilities: key hashing, distance-based process sorting, logging.

Reference: fantoch/src/util.rs.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Iterator, List, Tuple

from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import Key
from fantoch_tpu_torch.core.planet import Planet, Region

logger = logging.getLogger("fantoch_tpu_torch")

# 64-bit FNV-1a: a stable, fast, dependency-free key hash.  The reference uses
# ahash (fantoch/src/util.rs:107-111); any stable 64-bit hash works as long as
# every process agrees on it, so we pick one that is reproducible across runs
# (Python's builtin hash() is salted per-process and therefore unusable here).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def key_hash(key: Key) -> int:
    h = _FNV_OFFSET
    for b in key.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def dots(repr_: Iterable[Tuple[ProcessId, int, int]]) -> Iterator[Dot]:
    """Expand (process, start, end) ranges into dots (fantoch/src/util.rs:135-140)."""
    for process_id, start, end in repr_:
        for seq in range(start, end + 1):
            yield Dot(process_id, seq)


def sort_processes_by_distance(
    region: Region,
    planet: Planet,
    processes: List[Tuple[ProcessId, ShardId, Region]],
) -> List[Tuple[ProcessId, ShardId]]:
    """Sort processes by the distance of their region from `region`; ties
    (same region) break by process id.  Reference: fantoch/src/util.rs:142-176.
    """
    sorted_regions = planet.sorted_by_distance(region)
    assert sorted_regions is not None, f"{region} should be part of planet"
    index_of = {reg: i for i, (_dist, reg) in enumerate(sorted_regions)}
    ordered = sorted(processes, key=lambda p: (index_of[p[2]], p[0]))
    return [(pid, shard) for pid, shard, _ in ordered]


def closest_process_per_shard(
    region: Region,
    planet: Planet,
    processes: List[Tuple[ProcessId, ShardId, Region]],
) -> Dict[ShardId, ProcessId]:
    """Closest process of each shard (fantoch/src/util.rs:178-192)."""
    out: Dict[ShardId, ProcessId] = {}
    for process_id, shard_id in sort_processes_by_distance(region, planet, processes):
        out.setdefault(shard_id, process_id)
    return out
