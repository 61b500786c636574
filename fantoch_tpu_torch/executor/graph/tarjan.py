"""Tarjan SCC finder over the commit dependency graph — the host-side
execution-ordering oracle.

Reference: fantoch_ps/src/executor/graph/tarjan.rs:99-319.  Differences from
a textbook Tarjan:
- dependencies already executed (per the executed clock) are pruned;
- a missing dependency (not executed, not yet committed here) aborts the
  search (single shard / non-first find) or is accumulated so all missing
  deps can be requested at once (partial replication, first find);
- SCC members are added to the executed clock *eagerly* while popping, so
  later searches in the same batch skip them (tarjan.rs:274-299 — the
  order-sensitive optimization covered by the regression tests);
- SCC members are sorted by dot, which defines intra-SCC execution order.

The reference recurses; Python cannot recurse half-a-million deep chains, so
``strong_connect`` here runs an explicit-stack DFS with identical semantics.
The TPU counterpart of this walk is the batched resolver in
fantoch_tpu/ops/graph_resolve.py, integrated at this seam by
fantoch_tpu/executor/graph/batched.py.
"""

from __future__ import annotations

from enum import Enum
from typing import List, Optional, Set, Tuple

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

# commands are sorted inside an SCC by their dot
SCC = List[Dot]


class Vertex:
    __slots__ = ("dot", "cmd", "deps", "start_time_ms", "id", "low", "on_stack")

    def __init__(self, dot: Dot, cmd: Command, deps: List[Dependency], time: SysTime):
        self.dot = dot
        self.cmd = cmd
        self.deps = deps
        self.start_time_ms = time.millis()
        # tarjan bookkeeping
        self.id = 0
        self.low = 0
        self.on_stack = False

    def duration_ms(self, time: SysTime) -> int:
        return time.millis() - self.start_time_ms


class FinderResult(Enum):
    FOUND = "found"
    NOT_FOUND = "not_found"
    NOT_PENDING = "not_pending"
    MISSING_DEPENDENCIES = "missing"


class TarjanSCCFinder:
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        self._id = 0
        self._stack: List[Dot] = []  # tarjan stack (not the DFS stack)
        self._sccs: List[SCC] = []
        self._missing_deps: Set[Dependency] = set()

    def sccs(self) -> List[SCC]:
        sccs, self._sccs = self._sccs, []
        return sccs

    def finalize(self, vertex_index) -> Tuple[Set[Dot], Set[Dependency]]:
        """Reset finder state: clears ids of vertices still on the tarjan
        stack, returning (visited dots, accumulated missing deps)."""
        self._id = 0
        visited: Set[Dot] = set()
        while self._stack:
            dot = self._stack.pop()
            vertex = vertex_index.find(dot)
            assert vertex is not None, "stack member should exist"
            vertex.id = 0
            vertex.on_stack = False
            visited.add(dot)
        missing, self._missing_deps = self._missing_deps, set()
        return visited, missing

    def strong_connect(
        self,
        first_find: bool,
        root_dot: Dot,
        root_vertex: Vertex,
        executed_clock: AEClock,
        added_to_executed_clock: Set[Dot],
        vertex_index,
    ) -> Tuple[FinderResult, Optional[Set[Dependency]], int]:
        """Explicit-stack DFS from `root_dot`.

        Returns (result, missing deps if aborted, missing_deps_count).  The
        count includes misses accumulated in partial-replication first finds
        (where the search continues instead of aborting).
        """
        single_shard_abort = self._config.shard_count == 1 or not first_find

        # DFS frame: [vertex, next dep index, subtree missing count]
        frames: List[List] = []

        def push_frame(vertex: Vertex) -> None:
            self._id += 1
            vertex.id = vertex.low = self._id
            vertex.on_stack = True
            self._stack.append(vertex.dot)
            frames.append([vertex, 0, 0])

        push_frame(root_vertex)
        root_found = False

        while frames:
            frame = frames[-1]
            vertex: Vertex = frame[0]
            advanced = False
            while frame[1] < len(vertex.deps):
                dep = vertex.deps[frame[1]]
                frame[1] += 1
                dep_dot = dep.dot
                # ignore self-dependencies and executed deps
                if dep_dot == vertex.dot or executed_clock.contains(
                    dep_dot.source, dep_dot.sequence
                ):
                    continue
                dep_vertex = vertex_index.find(dep_dot)
                if dep_vertex is None:
                    # missing dependency
                    if single_shard_abort:
                        return FinderResult.MISSING_DEPENDENCIES, {dep}, 0
                    self._missing_deps.add(dep)
                    frame[2] += 1
                    continue
                if dep_vertex.id == 0:
                    push_frame(dep_vertex)
                    advanced = True
                    break
                if dep_vertex.on_stack:
                    vertex.low = min(vertex.low, dep_vertex.id)
            if advanced:
                continue

            # all deps processed: close this frame
            frames.pop()
            missing_count = frame[2]
            if missing_count == 0 and vertex.id == vertex.low:
                # SCC root: pop members off the tarjan stack
                scc: List[Dot] = []
                while True:
                    member_dot = self._stack.pop()
                    member_vertex = vertex_index.find(member_dot)
                    assert member_vertex is not None, "stack member should exist"
                    member_vertex.on_stack = False
                    scc.append(member_dot)
                    # eager executed-clock update: later searches in this batch
                    # see these as executed (tarjan.rs:274-299)
                    executed_clock.add(member_dot.source, member_dot.sequence)
                    if self._config.shard_count > 1:
                        added_to_executed_clock.add(member_dot)
                    if member_dot == vertex.dot:
                        break
                scc.sort()  # intra-SCC order is by dot
                self._sccs.append(scc)
                if vertex.dot == root_dot:
                    root_found = True
            if frames:
                parent = frames[-1]
                parent[0].low = min(parent[0].low, vertex.low)
                parent[2] += missing_count

        # DFS complete without aborting
        root_missing = len(self._missing_deps)
        if root_found:
            return FinderResult.FOUND, None, root_missing
        return FinderResult.NOT_FOUND, None, root_missing
