"""System configuration and the per-protocol quorum-size formulas.

The port of fantoch_tpu/core/config.py, cut to the fields the ported
modules read (the graph, table, predecessors, slot and basic executors,
the five protocols, the clients and the simulator); each keeps its name,
default and check so a reader finds its counterpart.  The other knobs
(serving, WAL and overload) come with the slices that read them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from fantoch_tpu_torch.core.ids import ProcessId


@dataclass
class Config:
    """Flat system config (fantoch/src/config.rs:7-43); durations are in
    milliseconds."""

    # number of processes (per shard) and max tolerated faults
    n: int
    f: int
    # number of shards (partial replication); 1 = full replication
    shard_count: int = 1
    # if True, commands are executed at commit time by the protocol itself
    # (skipping the executor's ordering) — only safe for benchmarks
    execute_at_commit: bool = False
    # interval at which executors inform workers of executed commands
    # (drives dot-based GC); None disables the notification (default 5ms,
    # fantoch/src/config.rs:58-61)
    executor_executed_notification_interval_ms: Optional[int] = 5
    # interval at which executors check for stuck commands (liveness
    # watchdog; the simulator runs it under a fault plan)
    executor_monitor_pending_interval_ms: Optional[int] = None
    # bounded wait: a command pending on *missing* (never-committed)
    # dependencies past this threshold raises a typed StalledExecutionError
    # from the watchdog instead of hanging (None keeps the log-only
    # behavior)
    executor_pending_fail_ms: Optional[int] = None
    # bounded wait before per-dot recovery starts; only named in the
    # stall error here (None = recovery disabled)
    recovery_delay_ms: Optional[int] = None
    # FPaxos leader failover: followers suspect a silent leader after this
    # bound (ring successors stagger by distance) and run MultiSynod
    # prepare/promise with accepted-slot carry-forward; the leader
    # heartbeats at a quarter of it (None disables failover)
    fpaxos_leader_timeout_ms: Optional[int] = None
    # record per-key execution order for agreement checks in tests
    executor_monitor_execution_order: bool = False
    # order committed commands with the batched resolver
    # (executor/graph/batched.py) instead of the host Tarjan walk
    batched_graph_executor: bool = False
    # batch the Newt/Tempo table path: array-backed key clocks with
    # batched proposals (protocol/common/table_batched.py) and one
    # vectorized stability pass per executor batch (executor/table.py)
    batched_table_executor: bool = False
    # device-resident votes-table plane: the TableExecutor keeps the
    # (key_bucket x process) vote-frontier matrix on the card across
    # batches and runs vote coalescing + frontier update + stability as
    # one commit dispatch per batch (executor/table_plane.py over
    # ops/table_ops.fused_votes_commit).  Requires clocks below 2^31 (no
    # real-time-micros clock bumps)
    device_table_plane: bool = False
    # frontier-matrix element count (keys x n) at which the TableExecutor
    # host path routes stability to the kernel instead of the numpy
    # partition.  None = the built-in default (1 << 20), overridable via
    # the FANTOCH_TABLE_KERNEL_THRESHOLD env var; an explicit value here
    # beats both
    table_kernel_threshold: Optional[int] = None
    # batch Caesar's predecessor executor: two-phase countdown resolution
    # as one resolve per batch (ops/pred_resolve.resolve_pred at the
    # executor/pred.py seam)
    batched_pred_executor: bool = False
    # device-resident predecessors plane for Caesar: the
    # PredecessorsExecutor keeps the whole pending window (sparse
    # predecessor sets as an int32[C, W] slot matrix + clock columns) on
    # the card across batches, updated in place, one dispatch per feed;
    # missing-blocked rows stay resident and wake when their deps commit
    # (executor/pred_plane.py over ops/pred_resolve.resolve_pred_plane_step).
    # Caesar additionally routes commits through a column builder (one
    # PredExecutionArrays drain per to_executors sweep).  Requires
    # timestamp sequences below 2^31 (guarded with a typed
    # ClockOverflowError)
    device_pred_plane: bool = False
    # device-resident graph plane for EPaxos/Atlas: the batched graph
    # executor keeps its dependency backlog (src/seq/key columns plus the
    # dep-slot matrix) on the card across feeds
    # (executor/graph/graph_plane.py over
    # ops/graph_resolve.resolve_graph_plane_step).  None = the
    # FANTOCH_GRAPH_PLANE env var, else off.  Single-shard only; requires
    # batched_graph_executor
    device_graph_plane: Optional[bool] = None
    # backlog size at which the batched graph executor stops collecting
    # exact per-SCC structure metrics and takes the arrival-order
    # shortcut.  None = the FANTOCH_GRAPH_KERNEL_THRESHOLD env var, else
    # the built-in 4096; an explicit value here beats both
    graph_kernel_threshold: Optional[int] = None
    # the batched graph executor's host-column route (device_graph_plane
    # off): True orders each flush with the native C++ SCC resolver
    # (native/, built with g++ on first use; a library that cannot be
    # built raises), None and False with the kernels on the graph's
    # device.  The JAX package's None picks native by backend; the port
    # picks it only here
    host_native_resolver: Optional[bool] = None
    # the build directory of the port's libraries (core/compile_cache.py):
    # an explicit path here beats the FANTOCH_COMPILE_CACHE_DIR env var,
    # which beats the obs-dir / package defaults.  None = resolve
    # through env/defaults
    compile_cache_dir: Optional[str] = None
    # accelerator fault detection (executor/device_plane.py): per-dispatch
    # deadline in wall ms — a dispatch (including its blocking fetch)
    # overrunning it fails the plane with a typed DeviceFailedError,
    # raised to the caller.  Setting it ARMS the detector (the plane logs
    # each dispatch's inputs for the host twin).  None (default) = off
    device_dispatch_timeout_ms: Optional[float] = None
    # sampled shadow-check rate in [0, 1]: with probability p per
    # dispatch (seeded, deterministic) the plane replays the dispatch's
    # inputs through the plain version of the step on host-owned twin
    # state and compares the resident post-state and the outputs bit for
    # bit; a mismatch fails the plane with a typed DeviceCorruptionError
    # naming the first diverging row.  > 0 arms the detector
    plane_shadow_rate: float = 0.0
    # per-key hash chain over executed writes inside every executor's
    # KVStore (the audit plane's input; off by default)
    execution_digests: bool = False
    # record every commit decision (dot -> (rifl, value)) in a log that
    # survives GC, so the ConsistencyAuditor can check commit-value
    # agreement and classify committed-then-lost commands (audit/test
    # only: the log grows with the run)
    audit_log_commits: bool = False
    # garbage-collection interval; None disables GC (the simulator
    # requires it)
    gc_interval_ms: Optional[int] = None
    # leader process (leader-based protocols, i.e. FPaxos)
    leader: Optional[ProcessId] = None
    # Newt (Tempo) knobs
    newt_tiny_quorums: bool = False
    newt_clock_bump_interval_ms: Optional[int] = None
    newt_detached_send_interval_ms: Optional[int] = None
    # Caesar knob: wait-condition on (True = the full protocol)
    caesar_wait_condition: bool = True
    # skip sending MCollectAck to the coordinator when the process is in the
    # fast quorum and the coordinator will ack anyway
    skip_fast_ack: bool = False
    # adaptive ingest batching (run/ingest.py): the deadline budget (ms)
    # a queued submission may wait for its round to fill.  None = the
    # FANTOCH_INGEST_DEADLINE_MS env var, else no batching; 0 releases
    # every arrival at once.  The simulator batches only when a deadline
    # was requested
    ingest_deadline_ms: Optional[float] = None
    # fixed ingest size target overriding the EWMA-adaptive one (None =
    # the FANTOCH_INGEST_TARGET env var, else adaptive)
    ingest_target: Optional[int] = None
    # telemetry window (ms) of the simulator's telemetry tick; None = the
    # built-in 1 s window.  Telemetry is not ported yet: the simulator
    # raises when a telemetry path is given
    telemetry_interval_ms: Optional[int] = None
    # per-dot lifecycle tracing: fraction of commands traced, selected by
    # a deterministic hash of the command id; 0.0 disables tracing
    trace_sample_rate: float = 0.0
    # failure flight recorder (observability/recorder.py in the JAX
    # package; not ported yet: the simulator raises when it is on)
    flight_recorder: bool = False

    def __post_init__(self) -> None:
        if self.n == 0:
            raise ValueError("n must be positive")
        if self.f > self.n:
            raise ValueError(f"f = {self.f} must not exceed n = {self.n}")
        if self.ingest_deadline_ms is not None and self.ingest_deadline_ms < 0:
            raise ValueError(
                f"ingest_deadline_ms = {self.ingest_deadline_ms} must be "
                ">= 0 (0 = batching off)"
            )
        if self.ingest_target is not None and self.ingest_target < 1:
            raise ValueError(
                f"ingest_target = {self.ingest_target} must be >= 1"
            )
        if self.telemetry_interval_ms is not None and self.telemetry_interval_ms < 1:
            raise ValueError(
                f"telemetry_interval_ms = {self.telemetry_interval_ms} "
                "must be >= 1"
            )
        if self.device_graph_plane and not self.batched_graph_executor:
            # the plane lives inside BatchedDependencyGraph: without the
            # batched executor the knob would silently do nothing
            raise ValueError(
                "device_graph_plane requires batched_graph_executor"
            )
        if self.graph_kernel_threshold is not None and self.graph_kernel_threshold < 1:
            raise ValueError(
                f"graph_kernel_threshold = {self.graph_kernel_threshold} "
                "must be >= 1"
            )
        if (
            self.device_dispatch_timeout_ms is not None
            and self.device_dispatch_timeout_ms <= 0
        ):
            raise ValueError(
                f"device_dispatch_timeout_ms = "
                f"{self.device_dispatch_timeout_ms} must be > 0 "
                "(None = deadline off)"
            )
        if not (0.0 <= self.plane_shadow_rate <= 1.0):
            raise ValueError(
                f"plane_shadow_rate = {self.plane_shadow_rate} must be "
                "in [0, 1]"
            )
        if self.device_table_plane and self.newt_clock_bump_interval_ms is not None:
            # real-time clock bumps vote wall-clock micros, which overflow
            # the plane's 31-bit device-clock window (ops/table_ops.py)
            raise ValueError(
                "device_table_plane is incompatible with "
                "newt_clock_bump_interval_ms (real-time micros clocks "
                "exceed the 31-bit device window)"
            )

    # --- quorum sizes (protocol facts; fantoch/src/config.rs:252-317) ---

    def basic_quorum_size(self) -> int:
        return self.f + 1

    def fpaxos_quorum_size(self) -> int:
        return self.f + 1

    def atlas_quorum_sizes(self) -> Tuple[int, int]:
        """(fast_quorum_size, write_quorum_size) = (n//2 + f, f + 1)."""
        return (self.n // 2 + self.f, self.f + 1)

    def epaxos_quorum_sizes(self) -> Tuple[int, int]:
        """EPaxos always tolerates a minority: f = n//2.

        fast quorum = f + floor((f+1)/2)  (i.e. f + ceil(f/2) for the paper's
        3n/4-ish quorum), write quorum = f + 1.
        """
        f = self.n // 2
        return (f + (f + 1) // 2, f + 1)

    def caesar_quorum_sizes(self) -> Tuple[int, int]:
        """(fast, write) = (3n//4 + 1, n//2 + 1)."""
        return (3 * self.n // 4 + 1, self.n // 2 + 1)

    def newt_quorum_sizes(self) -> Tuple[int, int, int]:
        """(fast_quorum_size, write_quorum_size, stability_threshold).

        Stability threshold is ``n - fast_quorum_size + f``: it plus the
        minimum number of processes where clocks are computed
        (fast_quorum_size - f + 1) must exceed n.  With tiny quorums the fast
        quorum is 2f (clocks from f+1 processes), giving threshold n - f.
        """
        minority = self.n // 2
        if self.newt_tiny_quorums:
            fast, threshold = 2 * self.f, self.n - self.f
        else:
            fast, threshold = minority + self.f, minority + 1
        return (fast, self.f + 1, threshold)

    def with_(self, **kwargs) -> "Config":
        """Functional update helper."""
        return replace(self, **kwargs)
