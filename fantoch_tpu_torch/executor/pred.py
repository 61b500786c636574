"""PredecessorsExecutor: Caesar's two-phase readiness ordering.

The port of fantoch_tpu/executor/pred.py.  Reference:
fantoch_ps/src/executor/pred/{mod,index,executor}.rs.  A
committed command becomes executable in two phases:

* phase 1 — wait until every dependency is *committed* (its final clock is
  known, so the lower-clock comparison below is meaningful);
* phase 2 — wait until every dependency with a *lower clock* is executed.

Timestamps are unique and totally ordered, so unlike the SCC graph executor
there are no cycles to collapse: execution order is exactly increasing
commit timestamp among conflicts.

Three routes: the per-vertex host graph (the default and the oracle
twin), ``Config.batched_pred_executor`` (one ``ops/pred_resolve.
resolve_pred`` per batch on the executor's device, the blocked residue
handed back to the host indexes) and ``Config.device_pred_plane`` (the
resident window of ``executor/pred_plane.DevicePredPlane``).  ``device``
names the card of the last two (default ``cuda``; without CUDA and
without an explicit device they raise).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Set

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId, all_process_ids
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import Executor, ExecutorMetricsKind, ExecutorResult
from fantoch_tpu_torch.core.kvs import KVStore
from fantoch_tpu_torch.protocol.common.pred_clocks import Clock


@dataclass
class PredecessorsExecutionInfo:
    dot: Dot
    cmd: Command
    clock: Clock
    deps: Set[Dot]


@dataclass
class PredecessorsNoop:
    """A dot committed as a recovered noop (protocol/recovery.py): nothing
    executes, but dependents waiting on the dot in either phase resolve —
    the Caesar analog of the graph executor's GraphNoop seam."""

    dot: Dot


@dataclass
class PredExecutionArrays:
    """Column-borne Caesar commit batch (the ``TableVotesArrays``
    move): B committed rows and E dependency edges as flat columns, built
    by the protocol's :class:`PredArraysBuilder` and drained ONE batch
    per ``to_executors`` sweep — no per-command
    ``PredecessorsExecutionInfo`` objects on the plane path.  Noop rows
    carry ``clock_seq == -1`` and no payload."""

    dot_src: "np.ndarray"  # int64[B]
    dot_seq: "np.ndarray"  # int64[B]
    clock_seq: "np.ndarray"  # int64[B]; -1 == recovered-noop row
    clock_src: "np.ndarray"  # int64[B]
    cmds: list  # row -> Optional[Command] (None for noop rows)
    dep_row: "np.ndarray"  # int64[E] -> row index
    dep_src: "np.ndarray"  # int64[E]
    dep_seq: "np.ndarray"  # int64[E]


class PredArraysBuilder:
    """Column accumulator for Caesar's commit seam: the protocol appends
    committed ``(dot, cmd, clock, deps)`` rows / recovered noops and
    flushes ONE :class:`PredExecutionArrays` per drain."""

    __slots__ = (
        "_dot_src", "_dot_seq", "_clock_seq", "_clock_src", "_cmds",
        "_dep_row", "_dep_src", "_dep_seq",
    )

    def __init__(self) -> None:
        self._dot_src = []
        self._dot_seq = []
        self._clock_seq = []
        self._clock_src = []
        self._cmds = []
        self._dep_row = []
        self._dep_src = []
        self._dep_seq = []

    def add_commit(self, dot: Dot, cmd: Command, clock, deps) -> None:
        row = len(self._cmds)
        self._dot_src.append(dot.source)
        self._dot_seq.append(dot.sequence)
        self._clock_seq.append(clock.seq)
        self._clock_src.append(clock.process_id)
        self._cmds.append(cmd)
        for dep in deps:
            self._dep_row.append(row)
            self._dep_src.append(dep.source)
            self._dep_seq.append(dep.sequence)

    def add_noop(self, dot: Dot) -> None:
        self._dot_src.append(dot.source)
        self._dot_seq.append(dot.sequence)
        self._clock_seq.append(-1)
        self._clock_src.append(0)
        self._cmds.append(None)

    def __len__(self) -> int:
        return len(self._cmds)

    def take(self) -> Optional[PredExecutionArrays]:
        """Build the accumulated batch and reset; None when empty."""
        import numpy as np

        if not self._cmds:
            return None
        batch = PredExecutionArrays(
            dot_src=np.asarray(self._dot_src, dtype=np.int64),
            dot_seq=np.asarray(self._dot_seq, dtype=np.int64),
            clock_seq=np.asarray(self._clock_seq, dtype=np.int64),
            clock_src=np.asarray(self._clock_src, dtype=np.int64),
            cmds=self._cmds,
            dep_row=np.asarray(self._dep_row, dtype=np.int64),
            dep_src=np.asarray(self._dep_src, dtype=np.int64),
            dep_seq=np.asarray(self._dep_seq, dtype=np.int64),
        )
        self.__init__()
        return batch


def _unpack_arrays(batch: PredExecutionArrays):
    """Expand a column batch back into (infos, noop_dots) — the ONE
    canonical consumption path (host twin and device plane both take
    infos, so the oracle parity argument covers the arrays seam too)."""
    deps_of = [set() for _ in batch.cmds]
    for e in range(len(batch.dep_row)):
        deps_of[int(batch.dep_row[e])].add(
            Dot(int(batch.dep_src[e]), int(batch.dep_seq[e]))
        )
    infos = []
    noops = []
    for i, cmd in enumerate(batch.cmds):
        dot = Dot(int(batch.dot_src[i]), int(batch.dot_seq[i]))
        if int(batch.clock_seq[i]) < 0:
            noops.append(PredecessorsNoop(dot))
        else:
            infos.append(
                PredecessorsExecutionInfo(
                    dot,
                    cmd,
                    Clock(int(batch.clock_seq[i]), int(batch.clock_src[i])),
                    deps_of[i],
                )
            )
    return infos, noops


MONITOR_PENDING_THRESHOLD_MS = 1000


class _Vertex:
    __slots__ = ("dot", "cmd", "clock", "deps", "missing_deps", "start_time_ms")

    def __init__(self, dot: Dot, cmd: Command, clock: Clock, deps: Set[Dot], time: SysTime):
        self.dot = dot
        self.cmd = cmd
        self.clock = clock
        self.deps = deps
        self.missing_deps = 0
        self.start_time_ms = time.millis() if time is not None else 0


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _PendingIndex:
    """dep dot -> dots waiting on it (index.rs PendingIndex)."""

    __slots__ = ("_index",)

    def __init__(self) -> None:
        self._index: Dict[Dot, Set[Dot]] = {}

    def index(self, pending: Dot, dep: Dot) -> None:
        self._index.setdefault(dep, set()).add(pending)

    def remove(self, dep: Dot) -> Set[Dot]:
        return self._index.pop(dep, set())


class PredecessorsGraph:
    def __init__(self, process_id: ProcessId, config: Config, device=None):
        ids = [pid for pid, _ in all_process_ids(config.shard_count, config.n)]
        self._process_id = process_id
        self._config = config
        # the batched seam's device (resolve_pred; None = cuda, raising
        # without it); unused by the per-vertex path
        self._device = device
        self._committed_clock: AEClock = AEClock(ids)
        self._executed_clock: AEClock = AEClock(ids)
        self._vertices: Dict[Dot, _Vertex] = {}
        self._phase_one_pending = _PendingIndex()
        self._phase_two_pending = _PendingIndex()
        self._metrics: Metrics = Metrics()
        self._to_execute: Deque[Command] = deque()
        # watchdog memo: the transitive-missing map is recomputed only
        # when commit/noop/execution state actually changed since the
        # last tick (the _gen counter) — at 1M pending a re-walk per
        # tick dominated the watchdog; see _missing_map
        self._gen = 0
        self._memo_gen = -1
        self._memo: Dict[Dot, Set[Dot]] = {}

    def command_to_execute(self) -> Optional[Command]:
        return self._to_execute.popleft() if self._to_execute else None

    def executed(self) -> AEClock:
        return self._executed_clock.copy()

    def metrics(self) -> Metrics:
        return self._metrics

    def add(self, dot: Dot, cmd: Command, clock: Clock, deps: Set[Dot], time: SysTime) -> None:
        # a command may report itself as a dependency (its own clock is in
        # the key index when deps are recomputed); drop it up front
        deps = set(deps)
        deps.discard(dot)

        # index: mark committed, create the vertex
        added = self._committed_clock.add(dot.source, dot.sequence)
        assert added, "commands are committed exactly once"
        assert dot not in self._vertices
        self._gen += 1  # commit state changed: watchdog memo stale
        self._vertices[dot] = _Vertex(dot, cmd, clock, deps, time)

        # commands blocked on this dot at phase one may advance
        self._try_phase_one_pending(dot, time)
        self._move_to_phase_one(dot, time)

    def handle_noop(self, dot: Dot, time: SysTime) -> None:
        """A recovery-committed noop: mark the dot committed AND executed
        (nothing runs) and wake everything waiting on it in either phase —
        a phase-two waiter necessarily indexed the dot before it was known
        to be a noop, so both indexes must drain."""
        added = self._committed_clock.add(dot.source, dot.sequence)
        assert added, "commands are committed exactly once"
        added = self._executed_clock.add(dot.source, dot.sequence)
        assert added
        assert dot not in self._vertices, "a noop dot has no vertex"
        self._gen += 1  # commit state changed: watchdog memo stale
        self._try_phase_one_pending(dot, time)
        self._try_phase_two_pending(dot, time)

    def monitor_pending(self, time: SysTime):
        """Liveness watchdog (the graph executor's VertexIndex contract):
        log long-pending commands, panic on pending-with-no-missing-deps,
        surface a typed StalledExecutionError when missing dependencies
        stay uncommitted past ``Config.executor_pending_fail_ms``, and
        return the missing dots so the runner can nudge the protocol's
        recovery plane (``Protocol.nudge_recovery``)."""
        fail_ms = self._config.executor_pending_fail_ms
        threshold = (
            MONITOR_PENDING_THRESHOLD_MS
            if fail_ms is None
            else min(MONITOR_PENDING_THRESHOLD_MS, fail_ms)
        )
        now = time.millis()
        stuck_without_missing: Set[Dot] = set()
        stalled_missing: Dict[Dot, Set[Dot]] = {}
        stalled_for = 0
        all_missing: Set[Dot] = set()
        # lazily built: a healthy tick (no vertex past the threshold)
        # must cost no graph walk at all — the common case in an active
        # system, where commits bump _gen and the memo never carries over
        missing_map = None
        for vertex in self._vertices.values():
            pending_for = now - vertex.start_time_ms
            if pending_for < threshold:
                continue
            if missing_map is None:
                missing_map = self._missing_map()
            missing = missing_map[vertex.dot]
            if not missing:
                stuck_without_missing.add(vertex.dot)
            else:
                all_missing |= missing
                if fail_ms is not None and pending_for >= fail_ms:
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
                self._process_id,
                stalled_missing,
                stalled_for,
                self._config.recovery_delay_ms,
            )
        return all_missing

    def _missing_map(self) -> Dict[Dot, Set[Dot]]:
        """Transitively-missing dependency dots per pending vertex: an
        uncommitted dep blocks phase one directly; a committed-but-
        unexecuted lower-clock dep blocks phase two through ITS missing
        deps.  Computed as ONE bottom-up pass over the pending graph
        (blocking chains strictly decrease in clock, so the recursion is
        acyclic and shared subchains are computed once — the naive
        per-vertex re-walk was a fuzzer-found watchdog livelock), and
        MEMOIZED across watchdog ticks: the map only changes when a
        commit/noop/execution lands (``_gen``), so an idle tick at 1M
        pending is a dict read, not a graph walk."""
        if self._memo_gen == self._gen:
            return self._memo
        memo: Dict[Dot, Set[Dot]] = {}
        executed = self._executed_clock
        committed = self._committed_clock
        vertices = self._vertices
        for root in vertices.values():
            if root.dot in memo:
                continue
            # iterative post-order: children (lower-clock pending deps)
            # resolve before their dependents fold them in
            stack = [(root, None)]
            while stack:
                vertex, state = stack.pop()
                if state is None:
                    if vertex.dot in memo:
                        continue
                    missing: Set[Dot] = set()
                    pending_deps = []
                    for dep in vertex.deps:
                        if executed.contains(dep.source, dep.sequence):
                            continue
                        if not committed.contains(dep.source, dep.sequence):
                            missing.add(dep)
                            continue
                        dep_vertex = vertices.get(dep)
                        if dep_vertex is not None and dep_vertex.clock < vertex.clock:
                            pending_deps.append(dep_vertex)
                    stack.append((vertex, (missing, pending_deps)))
                    for dep_vertex in pending_deps:
                        if dep_vertex.dot not in memo:
                            stack.append((dep_vertex, None))
                else:
                    missing, pending_deps = state
                    for dep_vertex in pending_deps:
                        # computed by the post-order (acyclic: clocks
                        # strictly decrease along blocking edges)
                        missing |= memo.get(dep_vertex.dot, set())
                    memo[vertex.dot] = missing
        self._memo = memo
        self._memo_gen = self._gen
        return memo

    def _move_to_phase_one(self, dot: Dot, time: SysTime) -> None:
        vertex = self._vertices[dot]
        non_committed = 0
        for dep in vertex.deps:
            if not self._committed_clock.contains(dep.source, dep.sequence):
                non_committed += 1
                self._phase_one_pending.index(dot, dep)
        if non_committed > 0:
            vertex.missing_deps = non_committed
        else:
            self._move_to_phase_two(dot, time)

    def _move_to_phase_two(self, dot: Dot, time: SysTime) -> None:
        vertex = self._vertices[dot]
        non_executed = 0
        for dep in vertex.deps:
            if not self._executed_clock.contains(dep.source, dep.sequence):
                # all deps are committed by now (phase 1 passed), so the
                # dependency's final clock is known: only lower-clock deps
                # must execute first
                dep_vertex = self._vertices[dep]
                if dep_vertex.clock < vertex.clock:
                    non_executed += 1
                    self._phase_two_pending.index(dot, dep)
        if non_executed > 0:
            vertex.missing_deps = non_executed
        else:
            self._save_to_execute(dot, time)

    def _try_phase_one_pending(self, dot: Dot, time: SysTime) -> None:
        for pending in self._phase_one_pending.remove(dot):
            vertex = self._vertices[pending]
            vertex.missing_deps -= 1
            if vertex.missing_deps == 0:
                self._move_to_phase_two(pending, time)

    def _try_phase_two_pending(self, dot: Dot, time: SysTime) -> None:
        for pending in self._phase_two_pending.remove(dot):
            vertex = self._vertices[pending]
            vertex.missing_deps -= 1
            if vertex.missing_deps == 0:
                self._save_to_execute(pending, time)

    def _save_to_execute(self, dot: Dot, time: SysTime) -> None:
        added = self._executed_clock.add(dot.source, dot.sequence)
        assert added
        self._gen += 1  # execution state changed: watchdog memo stale
        vertex = self._vertices.pop(dot)
        if time is not None:
            self._metrics.collect(
                ExecutorMetricsKind.EXECUTION_DELAY,
                time.millis() - vertex.start_time_ms,
            )
        self._to_execute.append(vertex.cmd)
        self._try_phase_two_pending(dot, time)

    # --- the batched seam (ops/pred_resolve.py) ---

    # dep fan-out above this width falls back to the per-info path (the
    # kernel's dep matrix is [B, W]; Caesar deps are lower-clock conflict
    # sets, chain-like under per-key workloads)
    KERNEL_MAX_WIDTH = 32

    def add_batch(self, infos, time: SysTime) -> None:
        """Batched add: one ``resolve_pred`` on the graph's device resolves
        the whole batch's two-phase countdown; only the blocked residue
        enters the per-vertex pending indexes.  Semantics identical to calling
        ``add`` per info (oracle-equivalence tested)."""
        import numpy as np
        import torch

        from fantoch_tpu_torch.executor.device_plane import resolve_device
        from fantoch_tpu_torch.ops.pred_resolve import MISSING, TERMINAL, resolve_pred

        infos = [i for i in infos]
        width = max((len(i.deps) for i in infos), default=0)
        if width > self.KERNEL_MAX_WIDTH:
            for info in infos:
                self.add(info.dot, info.cmd, info.clock, info.deps, time)
            return
        B = len(infos)
        if B == 0:
            return
        row_of = {info.dot: r for r, info in enumerate(infos)}
        width = max(width, 1)
        deps = np.full((B, width), TERMINAL, dtype=np.int32)
        for r, info in enumerate(infos):
            s = 0
            for dep in info.deps:
                if dep == info.dot:
                    continue  # self-dependency, dropped like `add` does
                if self._executed_clock.contains(dep.source, dep.sequence):
                    continue  # TERMINAL
                in_batch = row_of.get(dep)
                if in_batch is not None:
                    deps[r, s] = in_batch
                else:
                    # not executed and not in this batch: either entirely
                    # unknown or committed-but-blocked in the host graph —
                    # both block the kernel; the residue path waits on it
                    deps[r, s] = MISSING
                s += 1
        # Caesar clocks are unique (seq, process) pairs: the kernel's
        # (clock, src, seq) lex key carries them exactly.  Batch and width
        # are padded to powers of two as in the reference (pad rows ride
        # the `committed=False` mask and never execute).
        Bp, Wp = _pad_pow2(B), _pad_pow2(width)
        deps_p = np.full((Bp, Wp), TERMINAL, dtype=np.int32)
        deps_p[:B, :width] = deps
        clock = np.zeros(Bp, dtype=np.int32)
        clock[:B] = np.fromiter((i.clock.seq for i in infos), np.int32, B)
        src = np.zeros(Bp, dtype=np.int32)
        src[:B] = np.fromiter((i.clock.process_id for i in infos), np.int32, B)
        seq = np.zeros(Bp, dtype=np.int32)
        committed = np.zeros(Bp, dtype=bool)
        committed[:B] = True
        dev = resolve_device(self._device)
        res = resolve_pred(
            *(torch.tensor(a, device=dev) for a in (deps_p, clock, src, seq, committed))
        )
        executed = res.executed.to("cpu").numpy()
        order = res.order.to("cpu").numpy()
        for r in order.tolist():
            if r >= B or not executed[r]:
                continue
            info = infos[r]
            # the kernel executed it: record commit+execution and wake any
            # host-graph vertices waiting on this dot in either phase
            added = self._committed_clock.add(info.dot.source, info.dot.sequence)
            assert added, "commands are committed exactly once"
            added = self._executed_clock.add(info.dot.source, info.dot.sequence)
            assert added
            self._gen += 1  # watchdog memo stale
            if time is not None:
                # same-batch execution: zero delay, but the histogram must
                # count every command the per-info path would count
                self._metrics.collect(ExecutorMetricsKind.EXECUTION_DELAY, 0)
            self._to_execute.append(info.cmd)
            self._try_phase_one_pending(info.dot, time)
            self._try_phase_two_pending(info.dot, time)
        # blocked residue: the ordinary per-vertex path owns it from here
        for r, info in enumerate(infos):
            if not executed[r]:
                self.add(info.dot, info.cmd, info.clock, info.deps, time)


class PredecessorsExecutor(Executor):
    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, config: Config,
        *, device=None,
    ):
        """``device`` is the card of the pred plane or the batched
        resolve (default ``cuda``; without CUDA and without an explicit
        device, building either raises)."""
        from fantoch_tpu_torch.executor.device_plane import resolve_device

        self._shard_id = shard_id
        self._execute_at_commit = config.execute_at_commit
        self._batched = config.batched_pred_executor
        # device-resident predecessors plane: the whole pending window
        # stays on device across feeds (executor/pred_plane.py); it
        # implements the PredecessorsGraph surface, so everything below
        # drives either twin identically (oracle-parity tested)
        if config.device_pred_plane and not config.execute_at_commit:
            from fantoch_tpu_torch.executor.pred_plane import DevicePredPlane

            self._graph = DevicePredPlane(process_id, config, device=device)
            # arm the fault detector (deadline + shadow-check) from config;
            # the simulator re-seeds it
            self._graph.configure_faults(config, process_id=process_id)
        else:
            if self._batched and not config.execute_at_commit:
                device = resolve_device(device)
            self._graph = PredecessorsGraph(process_id, config, device=device)
        self._store = KVStore(
            config.executor_monitor_execution_order,
            config.execution_digests,
        )
        self._to_clients: Deque[ExecutorResult] = deque()

    @property
    def _plane(self):
        from fantoch_tpu_torch.executor.pred_plane import DevicePredPlane

        return self._graph if isinstance(self._graph, DevicePredPlane) else None

    def handle(self, info, time) -> None:
        if isinstance(info, PredExecutionArrays):
            self.handle_batch([info], time)
            return
        if isinstance(info, PredecessorsNoop):
            # execute-at-commit has no ordering state to resolve
            if not self._execute_at_commit:
                self._graph.handle_noop(info.dot, time)
                self._drain()
            return
        if self._execute_at_commit:
            self._execute(info.cmd)
            return
        self._graph.add(info.dot, info.cmd, info.clock, info.deps, time)
        self._drain()

    def handle_batch(self, infos, time) -> None:
        """Batched seam: the device pred plane consumes the whole feed
        (adds + noops + any column batches from the protocol's arrays
        builder) as ONE resident dispatch; with
        ``Config.batched_pred_executor`` the batch resolves as one
        upload-per-batch kernel (ops/pred_resolve.resolve_pred);
        otherwise per-info.  Noops take the per-info path on the
        non-plane paths (they carry no clock for the kernel)."""
        plane = None if self._execute_at_commit else self._plane
        if plane is not None:
            # column batches feed the plane natively (no per-command
            # objects); interleaved object infos keep their relative
            # order by flushing as their own column feeds
            adds, noops = [], []

            def _flush_objects():
                if adds or noops:
                    plane.add_batch(adds, time, noops=noops)
                    adds.clear()
                    noops.clear()

            for info in infos:
                if isinstance(info, PredExecutionArrays):
                    _flush_objects()
                    plane.add_arrays(info, time)
                elif isinstance(info, PredecessorsNoop):
                    noops.append(info.dot)
                else:
                    adds.append(info)
            _flush_objects()
            self._drain()
            return
        expanded = []
        for info in infos:
            if isinstance(info, PredExecutionArrays):
                batch_infos, batch_noops = _unpack_arrays(info)
                expanded.extend(batch_infos)
                expanded.extend(batch_noops)
            else:
                expanded.append(info)
        infos = expanded
        if not self._batched or self._execute_at_commit:
            for info in infos:
                self.handle(info, time)
            return
        adds = [i for i in infos if not isinstance(i, PredecessorsNoop)]
        for info in infos:
            if isinstance(info, PredecessorsNoop):
                self._graph.handle_noop(info.dot, time)
        if adds:
            self._graph.add_batch(adds, time)
        self._drain()

    def monitor_pending(self, time):
        """Liveness watchdog; returns the missing dependency dots (if any)
        so the runner can nudge the protocol's recovery plane."""
        if self._execute_at_commit:
            return None
        return self._graph.monitor_pending(time)

    def device_counters(self):
        """Per-dispatch tallies of the resident predecessors plane (None
        when the plane is off); folded into the run layer's periodic
        metrics snapshot and the bench rows — the same
        ``Executor.device_counters`` seam the table plane feeds, so
        ``bin/obs.py summarize`` and the telemetry series cover Caesar
        like Newt."""
        plane = self._plane
        if plane is None:
            return None
        return {
            "pred_plane_dispatches": plane.dispatches,
            "pred_plane_grows": plane.grows,
            "pred_plane_new_rows": plane.stats["new_rows"],
            "pred_plane_update_capacity": plane.stats["update_capacity"],
            "pred_plane_residual_rows": plane.stats["residual_rows"],
            "pred_plane_compactions": plane.stats["compactions"],
            "pred_plane_kernel_ms": round(plane.stats["kernel_ms"], 3),
            # host->device window materializations: 1 lazy initial, +1
            # per compaction / live capacity-or-width grow, +1 per
            # restart-from-snapshot — never one per batch
            "pred_plane_resident_uploads": plane.resident_uploads,
            # configuration gauge (max-folded, not summed)
            "pred_plane_slot_capacity": plane._cap,
            # accelerator fault detection: failures detected and the
            # health gauge (max-folded)
            **{
                f"pred_plane_{k}": v
                for k, v in plane.fault_counters().items()
            },
        }

    def device_planes(self):
        plane = self._plane
        return (plane,) if plane is not None else ()

    def _drain(self) -> None:
        while True:
            cmd = self._graph.command_to_execute()
            if cmd is None:
                return
            self._execute(cmd)

    def _execute(self, cmd: Command) -> None:
        self._to_clients.extend(cmd.execute(self._shard_id, self._store))

    def to_clients(self) -> Optional[ExecutorResult]:
        return self._to_clients.popleft() if self._to_clients else None

    def executed(self, time):
        return self._graph.executed()

    @classmethod
    def parallel(cls) -> bool:
        # single process-global dependency graph: key-hash routing cannot
        # split it (the reference marks it parallel only because its infos
        # broadcast to every clone; with one shared graph that is wrong)
        return False

    def metrics(self):
        return self._graph.metrics()

    def monitor(self):
        return self._store.monitor
