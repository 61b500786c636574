"""Basic protocol: store at f+1 replicas, then commit.

Reference: fantoch/src/protocol/basic.rs:20-395.  Deliberately inconsistent
(no real consensus) — it exists to exercise the full machinery end-to-end:
submit -> MStore to fast quorum -> f+1 MStoreAck -> MCommit to all ->
per-key execution info, plus the complete GC message set
(MCommitDot/MGarbageCollection/MStable) shared by all leaderless protocols.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Set

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.basic import BasicExecutionInfo, BasicExecutor
from fantoch_tpu_torch.protocol.base import (
    Action,
    BaseProcess,
    Protocol,
    ProtocolMetrics,
    ToForward,
    ToSend,
)
from fantoch_tpu_torch.protocol.commit_gc import (
    CommitGCMixin,
    GarbageCollectionEvent,
    MCommitDot,
)
from fantoch_tpu_torch.protocol.gc import GCTrack
from fantoch_tpu_torch.protocol.info import CommandsInfo
from fantoch_tpu_torch.run.routing import worker_dot_index_shift


# --- messages ---


@dataclass
class MStore:
    dot: Dot
    cmd: Command


@dataclass
class MStoreAck:
    dot: Dot


@dataclass
class MCommit:
    dot: Dot
    cmd: Command


def _basic_info_factory(*_args) -> "BasicInfo":
    """Module-level (picklable) per-dot info factory: the model checker
    copies protocol state by pickling, which lambdas would break."""
    return BasicInfo()


@dataclass
class BasicInfo:
    """Per-dot lifecycle info (basic.rs:318-341)."""

    cmd: Optional[Command] = None
    acks: Set[ProcessId] = field(default_factory=set)


class Basic(CommitGCMixin, Protocol):
    Executor = BasicExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        fast_quorum_size = config.basic_quorum_size()
        write_quorum_size = 0  # 100% fast paths: no write quorum
        self.bp = BaseProcess(process_id, shard_id, config, fast_quorum_size, write_quorum_size)
        self._cmds: CommandsInfo[BasicInfo] = CommandsInfo(
            process_id,
            shard_id,
            config,
            fast_quorum_size,
            write_quorum_size,
            _basic_info_factory,
        )
        self._gc_track = GCTrack(process_id, shard_id, config.n)
        self._to_processes: deque = deque()
        self._to_executors: deque = deque()

    def periodic_events(self):
        return self.gc_periodic_events()

    @property
    def id(self) -> ProcessId:
        return self.bp.process_id

    @property
    def shard_id(self) -> ShardId:
        return self.bp.shard_id

    def discover(self, processes):
        connect_ok = self.bp.discover(processes)
        return connect_ok, dict(self.bp.closest_shard_process())

    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None:
        dot = dot if dot is not None else self.bp.next_dot()
        self._to_processes.append(ToSend(self.bp.fast_quorum(), MStore(dot, cmd)))

    def handle(self, from_, from_shard_id, msg, time):
        if isinstance(msg, MStore):
            self._handle_mstore(from_, msg.dot, msg.cmd)
        elif isinstance(msg, MStoreAck):
            self._handle_mstoreack(from_, msg.dot)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(from_, msg.dot, msg.cmd)
        elif not self.handle_gc_message(from_, msg):
            raise AssertionError(f"unknown message {msg}")

    def handle_event(self, event, time):
        assert isinstance(event, GarbageCollectionEvent)
        self.handle_gc_event()

    def to_processes(self) -> Optional[Action]:
        return self._to_processes.popleft() if self._to_processes else None

    def to_executors(self):
        return self._to_executors.popleft() if self._to_executors else None

    @classmethod
    def parallel(cls) -> bool:
        return True

    @classmethod
    def leaderless(cls) -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics()

    # --- handlers ---

    def _handle_mstore(self, from_: ProcessId, dot: Dot, cmd: Command) -> None:
        info = self._cmds.get(dot)
        info.cmd = cmd
        self._to_processes.append(ToSend({from_}, MStoreAck(dot)))

    def _handle_mstoreack(self, from_: ProcessId, dot: Dot) -> None:
        info = self._cmds.get(dot)
        info.acks.add(from_)
        if len(info.acks) == self.bp.config.basic_quorum_size():
            assert info.cmd is not None, "command should exist"
            self._to_processes.append(ToSend(self.bp.all(), MCommit(dot, info.cmd)))

    def _handle_mcommit(self, _from: ProcessId, dot: Dot, cmd: Command) -> None:
        info = self._cmds.get(dot)
        info.cmd = cmd
        self.bp.audit_commit(dot, cmd.rifl, None)
        # one execution info per key: lets the basic executor run key-parallel
        rifl = cmd.rifl
        for key, ops in cmd.iter_ops(self.bp.shard_id):
            self._to_executors.append(BasicExecutionInfo(rifl, key, ops))
        if self._gc_running():
            self._to_processes.append(ToForward(MCommitDot(dot)))
        else:
            self._cmds.gc_single(dot)

    # --- worker routing (basic.rs:354-384) ---

    @staticmethod
    def message_index(msg):
        if isinstance(msg, (MStore, MStoreAck, MCommit)):
            return worker_dot_index_shift(msg.dot)
        gc_index = CommitGCMixin.gc_message_index(msg)
        if gc_index is not None:
            return gc_index[0]
        raise AssertionError(f"unknown message {msg}")
