"""Basic executor: executes ops immediately on receipt, key-parallel.

Reference: fantoch/src/executor/basic.rs:12-86.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple

from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import ProcessId, Rifl, ShardId
from fantoch_tpu_torch.core.kvs import KVOp, KVStore, Key
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import Executor, ExecutorResult


@dataclass(frozen=True)
class BasicExecutionInfo:
    rifl: Rifl
    key: Key
    ops: Tuple[KVOp, ...]

    @property
    def msg_key(self) -> Key:  # MessageKey routing
        return self.key


class BasicExecutor(Executor):
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config,
                 *, device=None):
        """``device`` is the runners' card keyword; the basic executor has
        no device plane and keeps nothing of it."""
        self._store = KVStore(
            config.executor_monitor_execution_order,
            config.execution_digests,
        )
        self._metrics: Metrics = Metrics()
        self._to_clients: deque = deque()

    def handle(self, info: BasicExecutionInfo, time: SysTime) -> None:
        op_results = tuple(self._store.execute(info.key, op, info.rifl) for op in info.ops)
        self._to_clients.append(ExecutorResult(info.rifl, info.key, op_results))

    def to_clients(self) -> Optional[ExecutorResult]:
        return self._to_clients.popleft() if self._to_clients else None

    @classmethod
    def parallel(cls) -> bool:
        return True

    def metrics(self) -> Metrics:
        return self._metrics

    def monitor(self):
        return self._store.monitor
