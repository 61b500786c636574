"""Executor interface: the pluggable ordering engine.

Reference: fantoch/src/executor/mod.rs:27-183.  A protocol emits
``ExecutionInfo`` values; an executor consumes them, decides when commands
are safe to execute (total order, dependency order, timestamp stability...),
runs them on the local KVStore and streams per-key ``ExecutorResult``s back
to clients.  ``MessageKey`` routing hashes keys to executor indices so
key-parallel executors scale across workers.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Generic, Iterator, NamedTuple, Optional, Tuple, TypeVar

from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import ProcessId, Rifl, ShardId
from fantoch_tpu_torch.core.kvs import KVOpResult, Key
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.observability.tracer import NOOP_TRACER


class ExecutorResult(NamedTuple):
    """Result of executing one key's ops of a command
    (fantoch/src/executor/mod.rs:169-183).

    A NamedTuple, not a dataclass: results are constructed once per
    executed key on the serving hot path, and tuple construction is
    several times cheaper than a frozen dataclass's __init__."""

    rifl: Rifl
    key: Key
    op_results: Tuple[KVOpResult, ...]


class ExecutorMetricsKind(Enum):
    """Reference: fantoch/src/executor/mod.rs:123-145."""

    EXECUTION_DELAY = "execution_delay"
    CHAIN_SIZE = "chain_size"
    OUT_REQUESTS = "out_requests"
    IN_REQUESTS = "in_requests"
    IN_REQUEST_REPLIES = "in_request_replies"


# ExecutionInfo type produced by the protocol for this executor
Info = TypeVar("Info")


class Executor(ABC, Generic[Info]):
    """Ordering engine interface (fantoch/src/executor/mod.rs:27-121).

    Implementations: BasicExecutor (immediate), GraphExecutor (SCC/topo order
    over the commit dependency graph — the TPU-accelerated one),
    TableExecutor (timestamp stability), PredecessorsExecutor (Caesar
    two-phase), SlotExecutor (total order by slot).
    """

    # lifecycle tracer (observability plane): class-level no-op default so
    # every executor is traceable without touching its __init__; runners
    # install a real tracer per instance via set_tracer
    tracer = NOOP_TRACER

    @abstractmethod
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config): ...

    def set_executor_index(self, index: int) -> None:
        """Executors are cloned per worker; each clone learns its index."""

    def set_tracer(self, tracer) -> None:
        """Runner hook: install the lifecycle tracer
        (fantoch_tpu/observability)."""
        self.tracer = tracer

    def device_counters(self) -> Optional[dict]:
        """Per-dispatch device-plane counters (dispatch count, batch
        occupancy, kernel wall-ms...), folded into the run layer's
        periodic metrics snapshot.  None when this executor drives no
        device plane."""
        return None

    def device_planes(self) -> tuple:
        """The device-resident planes this executor drives (empty when
        none) — the seam the simulator uses to seed each plane's fault
        detector from the sim seed."""
        return ()

    def snapshot(self) -> bytes:
        """Durable image of the executor state (ordering structures,
        KVStore, emit frontier).  Device-resident planes pickle their
        host mirrors and lazily re-materialize on the first dispatch
        after :meth:`restore` (one re-upload, counted by the plane).  The
        tracer is excluded and reattached by the restorer."""
        import pickle

        saved = self.__dict__.pop("tracer", None)
        try:
            return pickle.dumps(self)
        finally:
            if saved is not None:
                self.__dict__["tracer"] = saved

    @classmethod
    def restore(cls, blob: bytes) -> "Executor":
        """Rebuild an executor instance from :meth:`snapshot` output."""
        import pickle

        executor = pickle.loads(blob)
        assert isinstance(executor, Executor), type(executor).__name__
        return executor

    def cleanup(self, time: SysTime) -> None:
        """Periodic housekeeping (cross-shard request retries...)."""

    def monitor_pending(self, time: SysTime):
        """Liveness watchdog: check for stuck-but-satisfiable commands.
        May return a set of missing dependency dots for the runner to feed
        into the protocol's recovery plane (Protocol.nudge_recovery)."""
        return None

    @abstractmethod
    def handle(self, info: Info, time: SysTime) -> None:
        """Consume one ExecutionInfo from the protocol."""

    def handle_batch(self, infos, time: SysTime) -> None:
        """Consume a drained queue of ExecutionInfos at once.

        Drivers call this when several infos are available together (one
        protocol step's output, a queue drain); batch-oriented executors
        (GraphExecutor with the device resolver) override it to amortize
        one device round-trip over the whole batch."""
        for info in infos:
            self.handle(info, time)

    @abstractmethod
    def to_clients(self) -> Optional[ExecutorResult]:
        """Pop one ready result (None when drained)."""

    def to_clients_iter(self) -> Iterator[ExecutorResult]:
        while True:
            result = self.to_clients()
            if result is None:
                return
            yield result

    def to_executors(self) -> Optional[Tuple[ShardId, Info]]:
        """Pop one cross-shard executor message (partial replication only)."""
        return None

    def to_executors_iter(self) -> Iterator[Tuple[ShardId, Info]]:
        while True:
            msg = self.to_executors()
            if msg is None:
                return
            yield msg

    def executed(self, time: SysTime):
        """Committed-and-executed clock for GC (None if unsupported)."""
        return None

    @classmethod
    def parallel(cls) -> bool:
        """Whether this executor can run as multiple key-routed instances."""
        return False

    def metrics(self):
        return getattr(self, "_metrics", None)

    def monitor(self):
        """Execution-order monitor (tests only)."""
        return None

    def digest(self):
        """Per-key chained execution digest (core/audit.ExecutionDigest)
        when ``Config.execution_digests`` is on; None otherwise.  Every
        concrete executor funnels execution through a KVStore, so the
        shared lookup here covers them all."""
        store = getattr(self, "_store", None)
        return store.digest if store is not None else None


class MessageKey:
    """Key-based worker routing for execution infos
    (fantoch/src/executor/mod.rs:147-166): route to
    ``hash(key) % executors``."""

    @staticmethod
    def key_index(key: Key, executors: int) -> int:
        from fantoch_tpu_torch.utils import key_hash

        return key_hash(key) % executors
