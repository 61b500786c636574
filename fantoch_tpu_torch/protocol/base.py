"""Protocol interface: pure state machines with pulled outputs.

Reference: fantoch/src/protocol/mod.rs:42-186.  A protocol handles submits,
messages and periodic events, and exposes two output queues that drivers
pull: ``to_processes`` (network actions) and ``to_executors`` (execution
info for the ordering engine).  ``BaseProcess``
(fantoch/src/protocol/base.rs) carries the plumbing shared by all
protocols: quorums from a distance-sorted process list, dot generation, and
fast/slow/stable metrics.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import (
    Any,
    Dict,
    Generic,
    Iterator,
    List,
    Optional,
    Set,
    Tuple,
    TypeVar,
)

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, IdGen, ProcessId, ShardId
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.observability.tracer import NOOP_TRACER

# Compact representation of which dots have been executed
# (fantoch/src/protocol/mod.rs:40).
Executed = AEClock[ProcessId]


class ProtocolMetricsKind(Enum):
    """Reference: fantoch/src/protocol/mod.rs:147-161."""

    FAST_PATH = "fast_path"
    SLOW_PATH = "slow_path"
    STABLE = "stable"


ProtocolMetrics = Metrics  # keyed by ProtocolMetricsKind

Msg = TypeVar("Msg")


@dataclass
class ToSend(Generic[Msg]):
    """Send `msg` to every process in `target`
    (fantoch/src/protocol/mod.rs:177-182)."""

    target: Set[ProcessId]
    msg: Msg


@dataclass
class ToForward(Generic[Msg]):
    """Forward `msg` to another worker of the same process
    (fantoch/src/protocol/mod.rs:183-185)."""

    msg: Msg


Action = Any  # ToSend | ToForward


class Protocol(ABC):
    """Protocol state-machine interface (fantoch/src/protocol/mod.rs:42-112).

    Subclasses must also define, for the runner's worker routing, a
    ``message_index(msg)`` / ``event_index(event)`` pair returning
    :data:`fantoch_tpu_torch.run.routing.WorkerIndex` values.
    """

    # Executor class used by this protocol
    Executor: type

    @abstractmethod
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config): ...

    @classmethod
    def new(
        cls, process_id: ProcessId, shard_id: ShardId, config: Config
    ) -> Tuple["Protocol", List[Tuple[Any, int]]]:
        """Create a protocol instance plus its periodic events
        ``[(event, interval_ms)]``."""
        protocol = cls(process_id, shard_id, config)
        return protocol, protocol.periodic_events()

    def periodic_events(self) -> List[Tuple[Any, int]]:
        return []

    @property
    @abstractmethod
    def id(self) -> ProcessId: ...

    @property
    @abstractmethod
    def shard_id(self) -> ShardId: ...

    @abstractmethod
    def discover(
        self, processes: List[Tuple[ProcessId, ShardId]]
    ) -> Tuple[bool, Dict[ShardId, ProcessId]]: ...

    @abstractmethod
    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None: ...

    @abstractmethod
    def handle(
        self, from_: ProcessId, from_shard_id: ShardId, msg: Any, time: SysTime
    ) -> None: ...

    def handle_event(self, event: Any, time: SysTime) -> None:
        raise NotImplementedError(f"unhandled periodic event {event}")

    def handle_executed(self, executed: Executed, time: SysTime) -> None:
        """Notification of executed dots (GC worker only); default no-op."""

    def on_peer_down(self, peer_id: ProcessId, time: SysTime) -> None:
        """Run-layer failure-detector notification (a peer stayed silent
        past the heartbeat budget).  Default no-op; leader-based protocols
        use it to trigger failover without waiting out their own
        protocol-level timeout."""

    def on_peer_up(self, peer_id: ProcessId, time: SysTime) -> None:
        """Run-layer detector notification symmetric to
        :meth:`on_peer_down`: a peer declared dead is reachable again (it
        restarted, or the silence was a false positive).  Default no-op;
        protocols that route around dead peers (FPaxos pending-forwards,
        election candidate sets) refresh those targets here so a returned
        replica stops being routed around."""

    def rejoin(self, time: SysTime) -> None:
        """Restart hook: queue catch-up actions after this (restored)
        process re-enters the mesh.  Default no-op; protocols with the
        sync plane (protocol/sync.py) broadcast ``MSync`` with their
        committed horizon so live peers stream the commits this process
        missed while down."""

    def note_durable_chosen(self, records) -> None:
        """Restart-replay hook for slot-ordered protocols: ``(slot, cmd)``
        records whose effects the WAL tail replay already applied.
        Default no-op; FPaxos folds them into its chosen log + committed
        watermark so the rejoin MSlotSync floor covers them."""

    def note_durable_commits(self, dots) -> None:
        """Restart-replay hook: commit dots whose effects the WAL tail
        replay already applied to the executors.  Default no-op;
        GC-tracking protocols fold them into the committed clock so the
        rejoin horizon covers them (protocol/commit_gc.py)."""

    def snapshot(self) -> bytes:
        """Durable image of the full protocol state (commit info, per-dot
        synod state, dedup tables, GC clocks).  The tracer is excluded —
        an open span log is not durable state — and reattached by the
        restorer via :meth:`set_tracer`.  Restart = ``restore(snapshot)``
        [+ WAL tail replay in the run layer] + :meth:`rejoin` catch-up."""
        import pickle

        bp = getattr(self, "bp", None)
        saved = None
        if bp is not None and bp.tracer is not NOOP_TRACER:
            saved, bp.tracer = bp.tracer, NOOP_TRACER
        try:
            return pickle.dumps(self)
        finally:
            if saved is not None:
                bp.tracer = saved

    @classmethod
    def restore(cls, blob: bytes) -> "Protocol":
        """Rebuild a protocol instance from :meth:`snapshot` output."""
        import pickle

        process = pickle.loads(blob)
        assert isinstance(process, cls), (
            f"snapshot holds {type(process).__name__}, not {cls.__name__}"
        )
        return process

    def audit_commit_log(self) -> Optional[Dict[Any, Tuple[Any, Any]]]:
        """The commit log the consistency auditor consumes
        (``Config.audit_log_commits``): ident -> (rifl, value).  Default
        reads the shared BaseProcess log; None when auditing is off."""
        bp = getattr(self, "bp", None)
        return bp.audit_commits if bp is not None else None

    def nudge_recovery(self, dots, time: SysTime) -> None:
        """Executor-watchdog hint: these dots are missing dependencies of
        committed commands.  Default no-op; recovery-capable protocols
        start per-dot recovery consensus for them — including dots whose
        payload never reached any live process (recovered as noops)."""

    def set_device(self, device) -> None:
        """Runner hook: the card the protocol's own device state lives on
        (the runner's ``device``).  Protocols without such state ignore
        it."""

    def set_tracer(self, tracer) -> None:
        """Runner hook: install the lifecycle tracer
        (fantoch_tpu/observability).  Default wires it into the shared
        BaseProcess plumbing when present; protocols without a ``bp``
        simply stay untraced."""
        bp = getattr(self, "bp", None)
        if bp is not None:
            bp.tracer = tracer

    @abstractmethod
    def to_processes(self) -> Optional[Action]: ...

    def to_processes_iter(self) -> Iterator[Action]:
        while True:
            action = self.to_processes()
            if action is None:
                return
            yield action

    @abstractmethod
    def to_executors(self) -> Optional[Any]: ...

    def to_executors_iter(self) -> Iterator[Any]:
        while True:
            info = self.to_executors()
            if info is None:
                return
            yield info

    @classmethod
    def parallel(cls) -> bool: ...

    @classmethod
    def leaderless(cls) -> bool: ...

    @abstractmethod
    def metrics(self) -> ProtocolMetrics: ...

    # --- worker routing (MessageIndex trait, fantoch/src/protocol/mod.rs:163) ---

    @staticmethod
    def message_index(msg: Any):
        """Worker index for a message; None broadcasts to all workers."""
        return getattr(msg, "INDEX", None)

    @staticmethod
    def event_index(event: Any):
        return getattr(event, "INDEX", None)


class BaseProcess:
    """Shared protocol plumbing (fantoch/src/protocol/base.rs:10-199)."""

    def __init__(
        self,
        process_id: ProcessId,
        shard_id: ShardId,
        config: Config,
        fast_quorum_size: int,
        write_quorum_size: int,
    ):
        # ballots lead with `id` on the slow path and accepted-ballot 0 means
        # "never been through phase-2", so ids must be non-zero
        assert process_id != 0
        self.process_id = process_id
        self.shard_id = shard_id
        self.config = config
        self.fast_quorum_size = fast_quorum_size
        self.write_quorum_size = write_quorum_size
        self._all: Optional[List[ProcessId]] = None
        self._all_but_me: Optional[List[ProcessId]] = None
        self._fast_quorum: Optional[List[ProcessId]] = None
        self._write_quorum: Optional[List[ProcessId]] = None
        self._closest_shard_process: Dict[ShardId, ProcessId] = {}
        self._dot_gen = IdGen(process_id)
        self._metrics: Metrics = Metrics()
        # lifecycle tracer (observability plane); runners swap in a real
        # Tracer via Protocol.set_tracer when Config.trace_sample_rate > 0
        self.tracer = NOOP_TRACER
        # consistency-audit commit log (core/audit.py): every commit
        # decision as ident -> (rifl, value), surviving GC so the
        # post-run auditor can check commit-value agreement across
        # replicas.  None unless Config.audit_log_commits (audit/fuzz
        # instrumentation — the log grows with the run)
        self.audit_commits: Optional[Dict[Any, Tuple[Any, Any]]] = (
            {} if config.audit_log_commits else None
        )

    def discover(self, all_processes: List[Tuple[ProcessId, ShardId]]) -> bool:
        """Learn the (distance-sorted) process list; quorums are the closest
        `fast_quorum_size` / `write_quorum_size` same-shard processes.

        Reference: fantoch/src/protocol/base.rs:59-131.
        """
        self._closest_shard_process = {}
        processes: List[ProcessId] = []
        for process_id, shard_id in all_processes:
            if shard_id == self.shard_id:
                processes.append(process_id)
            else:
                # must be the closest process of that shard
                assert shard_id not in self._closest_shard_process, (
                    "process should only connect to the closest process of each shard"
                )
                self._closest_shard_process[shard_id] = process_id

        fast = processes[: self.fast_quorum_size]
        write = processes[: self.write_quorum_size]
        self._all = list(processes)
        self._all_but_me = [p for p in processes if p != self.process_id]
        self._fast_quorum = fast if len(fast) == self.fast_quorum_size else None
        self._write_quorum = write if len(write) == self.write_quorum_size else None
        return self._fast_quorum is not None and self._write_quorum is not None

    def next_dot(self) -> Dot:
        return self._dot_gen.next_id()

    def all(self) -> Set[ProcessId]:
        assert self._all is not None, "the set of all processes should be known"
        return set(self._all)

    def all_but_me(self) -> Set[ProcessId]:
        assert self._all_but_me is not None
        return set(self._all_but_me)

    def fast_quorum(self) -> Set[ProcessId]:
        assert self._fast_quorum is not None, "the fast quorum should be known"
        return set(self._fast_quorum)

    def write_quorum(self) -> Set[ProcessId]:
        assert self._write_quorum is not None, "the write quorum should be known"
        return set(self._write_quorum)

    def closest_process(self, shard_id: ShardId) -> ProcessId:
        return self._closest_shard_process[shard_id]

    def closest_shard_process(self) -> Dict[ShardId, ProcessId]:
        return self._closest_shard_process

    def metrics(self) -> Metrics:
        return self._metrics

    def fast_path(self, dot: Optional[Dot] = None, cmd=None) -> None:
        self._metrics.aggregate(ProtocolMetricsKind.FAST_PATH, 1)
        if self.tracer.enabled and cmd is not None:
            self.trace_span("path", cmd.rifl, dot=dot, meta={"path": "fast"})

    def slow_path(self, dot: Optional[Dot] = None, cmd=None) -> None:
        self._metrics.aggregate(ProtocolMetricsKind.SLOW_PATH, 1)
        if self.tracer.enabled and cmd is not None:
            self.trace_span("path", cmd.rifl, dot=dot, meta={"path": "slow"})

    def stable(self, count: int) -> None:
        self._metrics.aggregate(ProtocolMetricsKind.STABLE, count)

    def audit_commit(self, ident, rifl, value) -> None:
        """Record one commit decision for the consistency auditor:
        ``ident`` is the dot (leaderless) or slot (FPaxos), ``rifl`` the
        committed command's id (None for recovered noops), ``value`` the
        protocol's agreed payload (Newt clock, graph deps, Caesar
        (clock, deps), None where the ident alone carries the order).
        No-op unless ``Config.audit_log_commits``."""
        if self.audit_commits is not None:
            self.audit_commits[ident] = (rifl, value)

    def trace_span(self, stage: str, rifl, dot: Optional[Dot] = None,
                   meta=None) -> None:
        """Emit one lifecycle span event at this process (no-op unless a
        tracer is installed and the command is sampled)."""
        if self.tracer.enabled:
            self.tracer.span(stage, rifl, dot=dot, pid=self.process_id,
                             meta=meta)
