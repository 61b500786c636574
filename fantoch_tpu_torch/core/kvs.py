"""Key-value store: the replicated state machine being ordered.

Reference: fantoch/src/kvs.rs:6-138.  ``Key``/``Value`` are strings; ops are
Get/Put/Delete with ``Optional[str]`` results.  The KVStore itself stays on
the host (it is control-plane: string keys, tiny values); the accelerator
works on *pre-hashed* int keys (see fantoch_tpu/ops) so the store never has
to cross the device boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from fantoch_tpu_torch.core.audit import ExecutionDigest
    from fantoch_tpu_torch.executor.monitor import ExecutionOrderMonitor
    from fantoch_tpu_torch.core.ids import Rifl

Key = str
Value = str
KVOpResult = Optional[Value]


class KVOpKind(Enum):
    GET = "Get"
    PUT = "Put"
    DELETE = "Delete"


@dataclass(frozen=True)
class KVOp:
    """A single-key operation (fantoch/src/kvs.rs:12-16)."""

    kind: KVOpKind
    value: Optional[Value] = None  # only for PUT

    @staticmethod
    def get() -> "KVOp":
        return KVOp(KVOpKind.GET)

    @staticmethod
    def put(value: Value) -> "KVOp":
        return KVOp(KVOpKind.PUT, value)

    @staticmethod
    def delete() -> "KVOp":
        return KVOp(KVOpKind.DELETE)

    @property
    def is_read(self) -> bool:
        return self.kind is KVOpKind.GET


class KVStore:
    """In-memory string KV store (fantoch/src/kvs.rs:21-69)."""

    def __init__(
        self,
        monitor_execution_order: bool = False,
        execution_digests: bool = False,
    ):
        self._store: Dict[Key, Value] = {}
        self._monitor: Optional["ExecutionOrderMonitor"] = None
        if monitor_execution_order:
            from fantoch_tpu_torch.executor.monitor import ExecutionOrderMonitor

            self._monitor = ExecutionOrderMonitor()
        # consistency-audit plane (core/audit.py): per-key hash chain
        # over executed writes, exchanged by the run layer for online
        # divergence detection (Config.execution_digests)
        self._digest: Optional["ExecutionDigest"] = None
        if execution_digests:
            from fantoch_tpu_torch.core.audit import ExecutionDigest

            self._digest = ExecutionDigest()

    @property
    def monitor(self) -> Optional["ExecutionOrderMonitor"]:
        return self._monitor

    @property
    def digest(self) -> Optional["ExecutionDigest"]:
        return self._digest

    def execute(self, key: Key, op: KVOp, rifl: "Rifl") -> KVOpResult:
        """Execute op on key, recording it in the monitor if enabled.

        Reference: fantoch/src/kvs.rs:37-56 (monitored execute).
        """
        if self._monitor is not None:
            self._monitor.add(key, rifl, read=op.is_read)
        if self._digest is not None and not op.is_read:
            # writes only: reads commute, so their relative order is
            # legitimately unordered across replicas (the monitor's
            # write-order rule)
            self._digest.record(key, rifl, op.kind.value, op.value)
        return self._do_execute(key, op)

    def _do_execute(self, key: Key, op: KVOp) -> KVOpResult:
        if op.kind is KVOpKind.GET:
            return self._store.get(key)
        if op.kind is KVOpKind.PUT:
            # Returns the previous value, like the reference's HashMap::insert.
            assert op.value is not None
            return self._put(key, op.value)
        if op.kind is KVOpKind.DELETE:
            return self._store.pop(key, None)
        raise AssertionError(f"unknown op kind {op.kind}")

    def _put(self, key: Key, value: Value) -> KVOpResult:
        prev = self._store.get(key)
        self._store[key] = value
        return prev
