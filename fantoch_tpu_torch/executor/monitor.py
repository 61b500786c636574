"""Execution-order monitor: records per-key execution order so tests can
assert that all processes agree (the linearizable-agreement check).

Reference: fantoch/src/executor/monitor.rs:8-58.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from fantoch_tpu_torch.core.ids import Rifl
from fantoch_tpu_torch.core.kvs import Key


class ExecutionOrderMonitor:
    def __init__(self) -> None:
        self._order_per_key: Dict[Key, List[Rifl]] = {}
        # (key, rifl) pairs recorded as reads: with the KeyDeps read/write
        # split (graph_deps.py), reads commute and their relative order is
        # legitimately unordered — agreement checks compare write orders.
        # Keyed per (key, rifl), not rifl: a mixed command could read one
        # key and write another, and its writes must stay in the check.
        self._reads: set = set()

    def add(self, key: Key, rifl: Rifl, read: bool = False) -> None:
        self._order_per_key.setdefault(key, []).append(rifl)
        if read:
            self._reads.add((key, rifl))

    def merge(self, other: "ExecutionOrderMonitor") -> None:
        """Merge a disjoint-key monitor (multiple key-parallel executors)."""
        for key, rifls in other._order_per_key.items():
            assert key not in self._order_per_key, (
                "different monitors should operate on different keys"
            )
            self._order_per_key[key] = rifls
        self._reads |= other._reads

    def get_order(self, key: Key) -> Optional[List[Rifl]]:
        return self._order_per_key.get(key)

    def get_write_order(self, key: Key) -> Optional[List[Rifl]]:
        """Per-key order restricted to writes (reads commute; see add)."""
        order = self._order_per_key.get(key)
        if order is None:
            return None
        return [r for r in order if (key, r) not in self._reads]

    def keys(self) -> Iterator[Key]:
        return iter(self._order_per_key.keys())

    def __len__(self) -> int:
        return len(self._order_per_key)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ExecutionOrderMonitor)
            and self._order_per_key == other._order_per_key
        )

    def __repr__(self) -> str:
        return f"ExecutionOrderMonitor({self._order_per_key})"
