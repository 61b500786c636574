"""GraphExecutor: the executor wrapper around DependencyGraph.

Reference: fantoch_ps/src/executor/graph/executor.rs; the port of
fantoch_tpu/executor/graph/executor.py for one shard.  With
``Config.batched_graph_executor`` (and the device graph plane) commands
are ordered by ``BatchedDependencyGraph`` on the card; otherwise by the
host Tarjan oracle ``DependencyGraph``.  The cross-shard request/reply
infos of partial replication come with a later slice (ROADMAP.md
Queue A).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Set, Tuple

import numpy as np

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import KVStore
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import Executor, ExecutorResult
from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency


# --- execution info variants (executor.rs:205-222) ---


@dataclass
class GraphAdd:
    dot: Dot
    cmd: Command
    deps: Set[Dependency]


@dataclass
class GraphAddBatch:
    """A whole commit buffer crossing the Protocol/Executor boundary as
    arrays (single-shard only — multi-shard commits keep
    per-command GraphAdd with full Dependency shard sets).

    ``dep_dots`` is int64[B, W] of packed dependency dots
    (fantoch_tpu/ops/frontier.py pack_dots), -1 padded."""

    dot_src: "np.ndarray"
    dot_seq: "np.ndarray"
    key: "np.ndarray"  # int32 conflict-key hash, -1 = multi-key
    dep_dots: "np.ndarray"
    cmds: List[Command]


@dataclass
class GraphNoop:
    """A dot committed as a recovered noop (protocol/recovery.py): nothing
    executes — the dot just counts as executed so dependents waiting on it
    resolve (the same seam RequestReplyExecuted uses)."""

    dot: Dot


GraphExecutionInfo = object  # union of the above

_MAIN_EXECUTOR_INDEX = 0
_SECONDARY_EXECUTOR_INDEX = 1


class GraphExecutor(Executor):
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config,
                 *, device=None):
        """``device`` is the graph plane's (default ``cuda``; without CUDA
        and without an explicit device the batched graph raises)."""
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        if config.shard_count > 1:
            raise NotImplementedError(
                "partial replication (shard_count > 1) is not ported yet: "
                "ROADMAP.md Queue A"
            )
        if config.batched_graph_executor:
            from fantoch_tpu_torch.executor.graph.batched import (
                BatchedDependencyGraph,
            )

            self.graph = BatchedDependencyGraph(
                process_id, shard_id, config, device=device
            )
        else:
            self.graph = DependencyGraph(process_id, shard_id, config)
        self._store = KVStore(
            config.executor_monitor_execution_order,
            config.execution_digests,
        )
        self._to_clients: Deque[ExecutorResult] = deque()
        self._to_executors: List[Tuple[ShardId, GraphExecutionInfo]] = []
        # tracing: which handle_batch drain resolved each traced command
        self._trace_batch = 0

    def set_executor_index(self, index: int) -> None:
        self.graph.executor_index = index

    def cleanup(self, time: SysTime) -> None:
        """Periodic cleanup: nothing to do with one shard."""

    def monitor_pending(self, time: SysTime):
        """Liveness watchdog; returns the missing dependency dots (if any)
        so the runner can nudge the protocol's recovery plane."""
        return self.graph.monitor_pending(time)

    def handle_batch(self, infos, time: SysTime) -> None:
        """Group runs of GraphAdds into one batched graph add (a single
        device resolve with the batched resolver), preserving info order."""
        self._trace_batch += 1
        adds = []

        def flush():
            if adds:
                self.graph.handle_add_batch(adds, time)
                adds.clear()
                self._fetch_actions(time)

        for info in infos:
            if isinstance(info, GraphAdd) and not self._config.execute_at_commit:
                adds.append((info.dot, info.cmd, list(info.deps)))
            else:
                flush()
                self.handle(info, time)
        flush()

    def handle(self, info: GraphExecutionInfo, time: SysTime) -> None:
        if isinstance(info, GraphAdd):
            if self._config.execute_at_commit:
                self._execute(info.cmd)
            else:
                self.graph.handle_add(info.dot, info.cmd, list(info.deps), time)
                self._fetch_actions(time)
        elif isinstance(info, GraphAddBatch):
            if self._config.execute_at_commit:
                for cmd in info.cmds:
                    self._execute(cmd)
            elif getattr(self.graph, "_array_mode", False):
                self.graph.handle_add_arrays(
                    info.dot_src, info.dot_seq, info.key, info.dep_dots, info.cmds, time
                )
                self._fetch_actions(time)
            else:
                # host-oracle graph: unpack to per-command adds (buffered
                # batches are single-shard, so deps are local)
                shards = frozenset({self._shard_id})
                for i, cmd in enumerate(info.cmds):
                    deps = [
                        Dependency(Dot(int(p >> 32), int(p & 0xFFFFFFFF)), shards)
                        for p in info.dep_dots[i]
                        if p >= 0
                    ]
                    self.graph.handle_add(
                        Dot(int(info.dot_src[i]), int(info.dot_seq[i])), cmd, deps, time
                    )
                self._fetch_actions(time)
        elif isinstance(info, GraphNoop):
            # execute-at-commit has no ordering state to resolve
            if not self._config.execute_at_commit:
                self.graph.handle_noop(info.dot, time)
                self._fetch_actions(time)
        else:
            raise AssertionError(f"unknown execution info {info}")

    def device_counters(self):
        """Per-dispatch tallies of the resident graph plane (None when
        the plane is off) — the same ``Executor.device_counters`` seam
        the table and pred planes feed, so ``bin/obs.py summarize``, the
        telemetry series, and the bench rows cover EPaxos/Atlas like
        Newt and Caesar."""
        plane = getattr(self.graph, "_plane", None)
        if plane is None:
            return None
        return {
            "graph_plane_dispatches": plane.dispatches,
            "graph_plane_grows": plane.grows,
            "graph_plane_new_rows": plane.stats["new_rows"],
            "graph_plane_update_capacity": plane.stats["update_capacity"],
            "graph_plane_patched_cells": plane.stats["patched_cells"],
            "graph_plane_residual_rows": plane.stats["residual_rows"],
            "graph_plane_compactions": plane.stats["compactions"],
            "graph_plane_kernel_ms": round(plane.stats["kernel_ms"], 3),
            # host->device backlog materializations: 1 lazy initial, +1
            # per compaction / live capacity-or-width grow, +1 per
            # restart-from-snapshot — never one per resolve (the
            # residency invariant; new-row deltas are the only steady-
            # state host->device traffic)
            "graph_plane_resident_uploads": plane.resident_uploads,
            # configuration gauge (max-folded, not summed)
            "graph_plane_slot_capacity": plane._cap,
            # accelerator fault detection: failures detected and the
            # health gauge (max-folded)
            **{
                f"graph_plane_{k}": v
                for k, v in plane.fault_counters().items()
            },
        }

    def device_planes(self):
        plane = getattr(self.graph, "_plane", None)
        return (plane,) if plane is not None else ()

    def to_clients(self) -> Optional[ExecutorResult]:
        return self._to_clients.popleft() if self._to_clients else None

    def to_executors(self) -> Optional[Tuple[ShardId, GraphExecutionInfo]]:
        return self._to_executors.pop() if self._to_executors else None

    def executed(self, time: SysTime):
        """Executed clock consumed by the protocol's GC (non-standard in the
        reference's GraphExecutor — EPaxos/Atlas GC is driven by MCommitDot
        instead; kept for parity with Executor API)."""
        return None

    @classmethod
    def parallel(cls) -> bool:
        return True

    def metrics(self) -> Metrics:
        return self.graph.metrics()

    def monitor(self):
        return self._store.monitor

    # --- internals (executor.rs:124-196) ---

    def _fetch_actions(self, time: SysTime) -> None:
        while True:
            cmd = self.graph.command_to_execute()
            if cmd is None:
                break
            self._execute(cmd)

    def _execute(self, cmd: Command) -> None:
        tracer = self.tracer
        if tracer.enabled:
            # "ready" = the graph resolved the command into an executable
            # position (stable SCC); "executed" = KVStore work done
            tracer.span(
                "ready", cmd.rifl, pid=self._process_id,
                meta={"batch": self._trace_batch},
            )
        self._to_clients.extend(cmd.execute(self._shard_id, self._store))
        if tracer.enabled:
            tracer.span("executed", cmd.rifl, pid=self._process_id)

    # --- executor routing (executor.rs:242-262) ---

    @staticmethod
    def executor_index_of(info: GraphExecutionInfo):
        if isinstance(info, (GraphAdd, GraphAddBatch, GraphNoop)):
            return (0, _MAIN_EXECUTOR_INDEX)
        return (0, _SECONDARY_EXECUTOR_INDEX)
