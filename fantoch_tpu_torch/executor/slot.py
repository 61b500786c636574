"""SlotExecutor: total-order execution by consecutive slot numbers.

Reference: fantoch_ps/src/executor/slot.rs.  Commands arrive tagged with
their consensus slot; execution simply buffers out-of-order slots and
drains while ``next_slot`` is present.  Sequential (not key-parallel): the
total order is global, not per-key.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import KVStore
from fantoch_tpu_torch.executor.base import Executor, ExecutorResult


@dataclass
class SlotExecutionInfo:
    slot: int
    cmd: Command


class SlotExecutor(Executor):
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config,
                 *, device=None):
        """``device`` is the runners' card keyword; a slot executor has no
        device plane and keeps nothing of it."""
        self._process_id = process_id
        self._shard_id = shard_id
        self._execute_at_commit = config.execute_at_commit
        # only leader failover legitimately re-chooses a slot (takeover
        # carry-forward); without it a duplicate delivery is a protocol
        # bug the original asserts must keep catching loudly
        self._failover = config.fpaxos_leader_timeout_ms is not None
        self._store = KVStore(
            config.executor_monitor_execution_order,
            config.execution_digests,
        )
        self._next_slot = 1
        self._to_execute: Dict[int, Command] = {}
        self._to_clients: Deque[ExecutorResult] = deque()

    def handle(self, info: SlotExecutionInfo, time) -> None:
        if self._execute_at_commit:
            self._execute(info.cmd)
            return
        if not self._failover:
            assert info.slot >= self._next_slot, "slots execute exactly once"
            assert info.slot not in self._to_execute
        elif info.slot in self._to_execute:
            # re-chosen via takeover carry-forward: exactly once — and the
            # re-chosen value must be the same command (ballots guarantee
            # it; a mismatch is a consensus safety violation)
            assert self._to_execute[info.slot].rifl == info.cmd.rifl, (
                f"slot {info.slot} re-chosen with a different command: "
                f"{self._to_execute[info.slot].rifl} vs {info.cmd.rifl}"
            )
            return
        elif info.slot < self._next_slot:
            return  # already executed (same-value re-choice)
        self._to_execute[info.slot] = info.cmd
        while True:
            cmd = self._to_execute.pop(self._next_slot, None)
            if cmd is None:
                return
            self._execute(cmd)
            self._next_slot += 1

    def _execute(self, cmd: Command) -> None:
        tracer = self.tracer
        if tracer.enabled:
            # slot order reached this command: ready and executed in the
            # same drain (total-order executors have no separate wait)
            tracer.span("ready", cmd.rifl, pid=self._process_id)
        self._to_clients.extend(cmd.execute(self._shard_id, self._store))
        if tracer.enabled:
            tracer.span("executed", cmd.rifl, pid=self._process_id)

    def to_clients(self) -> Optional[ExecutorResult]:
        return self._to_clients.popleft() if self._to_clients else None

    @classmethod
    def parallel(cls) -> bool:
        return False

    def monitor(self):
        return self._store.monitor
