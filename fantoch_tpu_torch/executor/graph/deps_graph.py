"""DependencyGraph: orders committed commands by SCC/topological order.

Reference: fantoch_ps/src/executor/graph/mod.rs:46-678.  Commands arrive as
(dot, cmd, deps); each add triggers an SCC search from that dot.  Found SCCs
move to the ``to_execute`` queue (intra-SCC order = dot order) and unblock
pending dependents; missing dependencies park the command in the pending
index (and, under partial replication, produce cross-shard info requests).

This is the *host oracle* implementation.  The batched TPU path
(fantoch_tpu/ops/graph_resolve.py + executor/graph/batched.py) resolves the
same graphs with identical per-key order; the permutation tests assert
equality.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Set, Union

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId, all_process_ids
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind
from fantoch_tpu_torch.executor.graph.indexes import (
    MONITOR_PENDING_THRESHOLD_MS,
    PendingIndex,
    VertexIndex,
)
from fantoch_tpu_torch.executor.graph.tarjan import FinderResult, TarjanSCCFinder, Vertex
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency


class RequestReplyInfo:
    """RequestReply::Info (mod.rs:33-42)."""

    __slots__ = ("dot", "cmd", "deps")

    def __init__(self, dot: Dot, cmd: Command, deps: List[Dependency]):
        self.dot = dot
        self.cmd = cmd
        self.deps = deps


class RequestReplyExecuted:
    """RequestReply::Executed (mod.rs:39-42)."""

    __slots__ = ("dot",)

    def __init__(self, dot: Dot):
        self.dot = dot


RequestReply = Union[RequestReplyInfo, RequestReplyExecuted]


class DependencyGraph:
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        self.executor_index = 0
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        ids = [pid for pid, _ in all_process_ids(config.shard_count, config.n)]
        self._executed_clock: AEClock = AEClock(ids)
        self._vertex_index = VertexIndex(process_id)
        self._pending_index = PendingIndex(process_id, shard_id, config)
        self._finder = TarjanSCCFinder(process_id, shard_id, config)
        self._metrics: Metrics = Metrics()
        # main executor (index 0) outputs:
        self._to_execute: Deque[Command] = deque()
        self._out_requests: Dict[ShardId, Set[Dot]] = {}
        self._added_to_executed_clock: Set[Dot] = set()
        # secondary executor (index > 0) state:
        self._buffered_in_requests: Dict[ShardId, Set[Dot]] = {}
        self._out_request_replies: Dict[ShardId, List[RequestReply]] = {}

    def share_vertex_index(self, primary: "DependencyGraph") -> None:
        """Point this (secondary) graph at the primary's vertex index — the
        reference's SharedMap sharing across executor clones
        (index.rs:19-22).  Request serving must see pending vertices:
        executed-only answers deadlock cross-shard dependency cycles."""
        self._vertex_index = primary._vertex_index

    # --- outputs ---

    def command_to_execute(self) -> Optional[Command]:
        return self._to_execute.popleft() if self._to_execute else None

    def commands_to_execute(self) -> List[Command]:
        out, self._to_execute = list(self._to_execute), deque()
        return out

    def to_executors(self) -> Optional[Set[Dot]]:
        if not self._added_to_executed_clock:
            return None
        out, self._added_to_executed_clock = self._added_to_executed_clock, set()
        return out

    def requests(self) -> Dict[ShardId, Set[Dot]]:
        out, self._out_requests = self._out_requests, {}
        return out

    def request_replies(self) -> Dict[ShardId, List[RequestReply]]:
        out, self._out_request_replies = self._out_request_replies, {}
        return out

    def metrics(self) -> Metrics:
        return self._metrics

    def executed_clock(self) -> AEClock:
        return self._executed_clock

    # --- periodic ---

    def cleanup(self, time: SysTime) -> None:
        if self.executor_index > 0:
            buffered, self._buffered_in_requests = self._buffered_in_requests, {}
            for from_shard, dots in buffered.items():
                self.process_requests(from_shard, dots, time)

    def monitor_pending(self, time: SysTime):
        if self.executor_index == 0:
            fail_ms = self._config.executor_pending_fail_ms
            # a fail bound below the log threshold must still be honored:
            # the scan's early-skip would otherwise silently floor it
            threshold = (
                MONITOR_PENDING_THRESHOLD_MS
                if fail_ms is None
                else min(MONITOR_PENDING_THRESHOLD_MS, fail_ms)
            )
            return self._vertex_index.monitor_pending(
                self._executed_clock,
                threshold,
                time,
                fail_missing_after_ms=fail_ms,
                recovery_delay_ms=self._config.recovery_delay_ms,
            )
        return None

    def handle_executed(self, dots: Set[Dot], _time: SysTime) -> None:
        """Secondary executors absorb executed notifications from the main."""
        if self.executor_index > 0:
            for dot in dots:
                self._executed_clock.add(dot.source, dot.sequence)

    # --- main entry points ---

    def handle_add(self, dot: Dot, cmd: Command, deps: List[Dependency], time: SysTime) -> None:
        assert self.executor_index == 0
        vertex = Vertex(dot, cmd, deps, time)
        if self._vertex_index.index(vertex) is not None:
            raise AssertionError(f"p{self._process_id}: tried to index already indexed {dot}")

        result, abort_missing, _count = self._find_scc(first_find=True, dot=dot)
        dots = self._drain_sccs(time)
        visited, accumulated_missing = self._finder.finalize(self._vertex_index)

        if result is FinderResult.MISSING_DEPENDENCIES:
            self._index_pending(dot, abort_missing)
        elif result is FinderResult.NOT_FOUND:
            assert accumulated_missing, (
                "either there's a missing dependency, or we should find an SCC"
            )
            self._index_pending(dot, accumulated_missing)
        elif result is FinderResult.NOT_PENDING:
            raise AssertionError("just added dot must be pending")

        self._check_pending(dots, time)

    def handle_add_batch(self, adds, time: SysTime) -> None:
        """Bulk add: ``adds`` is an iterable of (dot, cmd, deps).

        The host oracle processes them one by one; the batched subclass
        overrides this to index everything first and resolve once — the
        shape a queue-draining runner (and the bench) feeds.
        """
        for dot, cmd, deps in adds:
            self.handle_add(dot, cmd, deps, time)

    def handle_noop(self, dot: Dot, time: SysTime) -> None:
        """A recovered-noop commit: count the dot as executed and retry its
        dependents — the RequestReplyExecuted path minus the network.  The
        batched subclass inherits this unchanged: its ``_executed_clock``
        aliases the device frontier and its ``_check_pending`` override
        marks the backlog dirty for the next resolve."""
        assert self.executor_index == 0
        self._executed_clock.add(dot.source, dot.sequence)
        self._added_to_executed_clock.add(dot)
        self._check_pending([dot], time)

    def handle_request(self, from_shard: ShardId, dots: Set[Dot], time: SysTime) -> None:
        assert self.executor_index > 0
        self._metrics.aggregate(ExecutorMetricsKind.IN_REQUESTS, 1)
        self.process_requests(from_shard, dots, time)

    def process_requests(self, from_shard: ShardId, dots, time: SysTime) -> None:
        """Answer a peer shard's request for dependency info (mod.rs:300-375)."""
        assert self.executor_index > 0
        for dot in dots:
            vertex = self._vertex_index.find(dot)
            if vertex is not None:
                assert not vertex.cmd.replicated_by(from_shard), (
                    f"{dot} is replicated by requesting shard {from_shard}"
                )
                self._out_request_replies.setdefault(from_shard, []).append(
                    RequestReplyInfo(dot, vertex.cmd, vertex.deps)
                )
            elif self._executed_clock.contains(dot.source, dot.sequence):
                self._out_request_replies.setdefault(from_shard, []).append(
                    RequestReplyExecuted(dot)
                )
            else:
                # not known yet: buffer and retry on cleanup
                self._buffered_in_requests.setdefault(from_shard, set()).add(dot)

    def handle_request_reply(self, infos: List[RequestReply], time: SysTime) -> None:
        assert self.executor_index == 0
        for info in infos:
            if isinstance(info, RequestReplyInfo):
                self.handle_add(info.dot, info.cmd, info.deps, time)
            else:
                self._executed_clock.add(info.dot.source, info.dot.sequence)
                self._added_to_executed_clock.add(info.dot)
                self._check_pending([info.dot], time)

    # --- internals ---

    def _find_scc(self, first_find: bool, dot: Dot):
        vertex = self._vertex_index.find(dot)
        if vertex is None:
            return FinderResult.NOT_PENDING, None, 0
        return self._finder.strong_connect(
            first_find,
            dot,
            vertex,
            self._executed_clock,
            self._added_to_executed_clock,
            self._vertex_index,
        )

    def _drain_sccs(self, time: SysTime) -> List[Dot]:
        """Move found SCCs into the execute queue; returns their dots."""
        dots: List[Dot] = []
        for scc in self._finder.sccs():
            self._metrics.collect(ExecutorMetricsKind.CHAIN_SIZE, len(scc))
            for dot in scc:
                vertex = self._vertex_index.remove(dot)
                assert vertex is not None, "dots from an SCC should exist"
                dots.append(dot)
                self._metrics.collect(
                    ExecutorMetricsKind.EXECUTION_DELAY, vertex.duration_ms(time)
                )
                self._to_execute.append(vertex.cmd)
        return dots

    def _index_pending(self, dot: Dot, missing_deps: Set[Dependency]) -> None:
        requests = 0
        for dep in missing_deps:
            target = self._pending_index.index(dep, dot)
            if target is not None:
                dep_dot, target_shard = target
                requests += 1
                self._out_requests.setdefault(target_shard, set()).add(dep_dot)
        self._metrics.aggregate(ExecutorMetricsKind.OUT_REQUESTS, requests)

    def _check_pending(self, dots: List[Dot], time: SysTime) -> None:
        """Breadth of newly-executed dots -> retry their pending dependents
        (mod.rs:558-644)."""
        assert self.executor_index == 0
        dots = list(dots)
        while dots:
            dot = dots.pop()
            pending = self._pending_index.remove(dot)
            if pending is None:
                continue
            visited: Set[Dot] = set()
            for pending_dot in pending:
                if pending_dot in visited:
                    continue
                result, abort_missing, _cnt = self._find_scc(False, pending_dot)
                new_dots = self._drain_sccs(time)
                new_visited, accumulated_missing = self._finder.finalize(self._vertex_index)
                if result is FinderResult.MISSING_DEPENDENCIES:
                    self._index_pending(pending_dot, abort_missing)
                elif result is FinderResult.NOT_FOUND:
                    self._index_pending(pending_dot, accumulated_missing)
                if result is not FinderResult.NOT_PENDING:
                    if new_dots:
                        visited.clear()
                    else:
                        visited.update(new_visited)
                dots.extend(new_dots)
