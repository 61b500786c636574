"""Vertex and pending indexes for the dependency graph.

Reference: fantoch_ps/src/executor/graph/index.rs.  ``VertexIndex`` maps
committed-but-unexecuted dots to their vertices; ``PendingIndex`` maps a
missing dependency dot to the dots waiting on it.  ``monitor_pending`` is
the liveness watchdog: a command pending past the threshold with no missing
dependencies means the executor lost an execution — panic loudly.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Set, Tuple

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.graph.tarjan import Vertex
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency
from fantoch_tpu_torch.utils import logger

MONITOR_PENDING_THRESHOLD_MS = 1000


class VertexIndex:
    def __init__(self, process_id: ProcessId):
        self._process_id = process_id
        self._index: Dict[Dot, Vertex] = {}

    def index(self, vertex: Vertex) -> Optional[Vertex]:
        """Index a vertex, returning any previously indexed vertex for the dot."""
        prev = self._index.get(vertex.dot)
        self._index[vertex.dot] = vertex
        return prev

    def dots(self) -> Iterator[Dot]:
        return iter(self._index.keys())

    def find(self, dot: Dot) -> Optional[Vertex]:
        return self._index.get(dot)

    def remove(self, dot: Dot) -> Optional[Vertex]:
        return self._index.pop(dot, None)

    def __len__(self) -> int:
        return len(self._index)

    def monitor_pending(
        self,
        executed_clock: AEClock,
        threshold_ms: int,
        time: SysTime,
        fail_missing_after_ms: Optional[int] = None,
        recovery_delay_ms: Optional[int] = None,
    ) -> Set[Dot]:
        """Log long-pending commands; panic on pending-with-no-missing-deps
        (index.rs:53-103).  With ``fail_missing_after_ms`` set, a command
        whose *missing* dependencies stay uncommitted past that bound
        raises a typed StalledExecutionError — the bounded-wait contract
        for dependencies owned by crashed replicas (a dot whose
        coordinator died before broadcasting commit never commits, and
        without this the executor waits on it forever).

        Returns the union of missing dependency dots seen below the fail
        bound: the runner feeds them to the protocol's recovery plane
        (``Protocol.nudge_recovery``), which can commit a dot the executor
        is starving on even when no live process ever got its payload (the
        noop path)."""
        now = time.millis()
        stuck_without_missing: Set[Dot] = set()
        stalled_missing: dict = {}
        stalled_for = 0
        all_missing: Set[Dot] = set()
        for vertex in self._index.values():
            pending_for = now - vertex.start_time_ms
            if pending_for < threshold_ms:
                continue
            visited: Set[Dot] = set()
            missing = self._missing_dependencies(vertex, executed_clock, visited)
            logger.info(
                "p%s: %s pending for %sms with deps %s | missing %s",
                self._process_id,
                vertex.dot,
                pending_for,
                vertex.deps,
                missing,
            )
            if not missing:
                stuck_without_missing.add(vertex.dot)
            else:
                all_missing |= missing
                if (
                    fail_missing_after_ms is not None
                    and pending_for >= fail_missing_after_ms
                ):
                    stalled_missing[vertex.dot] = missing
                    stalled_for = max(stalled_for, pending_for)
        if stuck_without_missing:
            raise AssertionError(
                f"p{self._process_id}: commands pending without missing "
                f"dependencies: {stuck_without_missing}"
            )
        if stalled_missing:
            from fantoch_tpu_torch.errors import StalledExecutionError

            raise StalledExecutionError(
                self._process_id, stalled_missing, stalled_for, recovery_delay_ms
            )
        return all_missing

    def _missing_dependencies(
        self, vertex: Vertex, executed_clock: AEClock, visited: Set[Dot]
    ) -> Set[Dot]:
        """Transitively collect missing (neither executed nor pending) deps."""
        missing: Set[Dot] = set()
        stack = [vertex]
        while stack:
            v = stack.pop()
            if v.dot in visited:
                continue
            visited.add(v.dot)
            for dep in v.deps:
                dep_dot = dep.dot
                if executed_clock.contains(dep_dot.source, dep_dot.sequence):
                    continue
                dep_vertex = self._index.get(dep_dot)
                if dep_vertex is not None:
                    stack.append(dep_vertex)
                else:
                    missing.add(dep_dot)
        return missing


class PendingIndex:
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        self._index: Dict[Dot, Set[Dot]] = {}

    def index(self, parent: Dependency, dot: Dot) -> Optional[Tuple[Dot, ShardId]]:
        """Record `dot` waiting on `parent`; on first sighting of a parent not
        replicated here, return (dep dot, owner shard) to request its info
        (index.rs:171-205)."""
        children = self._index.get(parent.dot)
        if children is not None:
            children.add(dot)
            return None
        self._index[parent.dot] = {dot}
        assert parent.shards is not None, "shards should be set if it's not a noop"
        if self._shard_id not in parent.shards:
            return parent.dot, parent.dot.target_shard(self._config.n)
        return None

    def remove(self, dep_dot: Dot) -> Optional[Set[Dot]]:
        return self._index.pop(dep_dot, None)

    def __len__(self) -> int:
        return len(self._index)
