"""Shared machinery for dependency-graph consensus protocols (EPaxos, Atlas).

The reference implements EPaxos (fantoch_ps/src/protocol/epaxos.rs) and
Atlas (fantoch_ps/src/protocol/atlas.rs) as two nearly-identical ~1000-line
files; here the shared collect/commit/consensus/GC skeleton lives once and
the protocols specialize three points:
- quorum sizes (EPaxos: minority-tolerating fixed f; Atlas: n//2 + f),
- the fast-path condition over reported deps (union equality vs threshold
  union),
- whether the coordinator acks itself (EPaxos skips self-acks and sizes the
  quorum-deps tracker at fast_quorum_size - 1; Atlas counts itself).
"""

from __future__ import annotations

import functools

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Set, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.graph.executor import (
    GraphAdd,
    GraphAddBatch,
    GraphExecutor,
    GraphNoop,
)
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
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency, KeyDeps, QuorumDeps
from fantoch_tpu_torch.protocol.common.synod import (
    MAccept,
    MAccepted as SynodMAccepted,
    MChosen,
    Synod,
)
from fantoch_tpu_torch.protocol.gc import GCTrack
from fantoch_tpu_torch.protocol.info import CommandsInfo
from fantoch_tpu_torch.protocol.recovery import (
    MRecoveryPrepare,
    MRecoveryPromise,
    RecoveryEvent,
    RecoveryMixin,
)
from fantoch_tpu_torch.protocol.sync import (
    MSync,
    MSyncBackfill,
    MSyncReply,
    SyncMixin,
)
from fantoch_tpu_torch.protocol.partial import (
    MForwardSubmit,
    MShardAggregatedCommit,
    MShardCommit,
    PartialCommitMixin,
)
from fantoch_tpu_torch.run.routing import (
    GC_WORKER_INDEX,
    worker_dot_index_shift,
    worker_index_no_shift,
)


# --- messages (epaxos.rs:675-702 / atlas.rs:836-871) ---


class _CommitBuffer:
    """Array columns of committed commands, appended at commit time and
    flushed as one GraphAddBatch per executor drain."""

    __slots__ = ("shard_id", "src", "seq", "key", "deps", "cmds", "count")

    def __init__(self, shard_id: ShardId):
        self.shard_id = shard_id
        self.src: list = []
        self.seq: list = []
        self.key: list = []
        self.deps: list = []  # per-command tuple of packed dep dots
        self.cmds: list = []
        self.count = 0

    def append(self, dot: Dot, cmd: Command, deps) -> None:
        from fantoch_tpu_torch.executor.graph.batched import key_hash

        self.src.append(dot.source)
        self.seq.append(dot.sequence)
        if cmd.key_count(self.shard_id) == 1:
            self.key.append(key_hash(next(iter(cmd.keys(self.shard_id)))))
        else:
            self.key.append(-1)
        self.deps.append(
            tuple(
                (d.dot.source << 32) | d.dot.sequence for d in deps if d.dot != dot
            )
        )
        self.cmds.append(cmd)
        self.count += 1

    def flush(self) -> GraphAddBatch:
        import numpy as np

        width = max((len(d) for d in self.deps), default=1) or 1
        dep_dots = np.full((self.count, width), -1, dtype=np.int64)
        for i, d in enumerate(self.deps):
            dep_dots[i, : len(d)] = d
        out = GraphAddBatch(
            np.array(self.src, dtype=np.int64),
            np.array(self.seq, dtype=np.int64),
            np.array(self.key, dtype=np.int32),
            dep_dots,
            self.cmds,
        )
        self.src, self.seq, self.key, self.deps, self.cmds = [], [], [], [], []
        self.count = 0
        return out


@dataclass
class MCollect:
    dot: Dot
    cmd: Command
    deps: Set[Dependency]
    quorum: Set[ProcessId]


@dataclass
class MCollectAck:
    dot: Dot
    deps: Set[Dependency]


@dataclass
class ConsensusValue:
    """(is_noop, deps) — the value agreed on per dot (epaxos.rs:602-621).

    ``bottom()`` (the synod's pre-ack initial value) is the *noop*: a
    recovery promise carrying it means "this acceptor never acked the
    MCollect", which is exactly what distinguishes a never-payloaded dot
    (recovered as a committed noop) from a real report with empty deps.
    """

    deps: Set[Dependency]
    is_noop: bool = False

    @staticmethod
    def bottom() -> "ConsensusValue":
        return ConsensusValue(set(), is_noop=True)


@dataclass
class MCommit:
    dot: Dot
    value: ConsensusValue
    # payload piggyback on recovery chosen-replies: a rejoined replica can
    # hold a buffered commit for a dot whose MCollect it missed while
    # down AND that was still in flight when the MSync records were cut —
    # without the payload here, the prepare/chosen exchange would loop
    # payload-less forever and the dot's (subtracted-from-backfill) votes
    # would never fold (fuzzer-found rejoin stall)
    cmd: Optional[Command] = None


@dataclass
class MConsensus:
    dot: Dot
    ballot: int
    value: ConsensusValue
    # payload piggyback on recovery rounds, so a recovered value can commit
    # at processes the original MCollect broadcast never reached
    cmd: Optional[Command] = None


@dataclass
class MConsensusAck:
    dot: Dot
    ballot: int


class Status:
    START = "start"
    PAYLOAD = "payload"
    COLLECT = "collect"
    COMMIT = "commit"


def _recovery_proposal_gen(values):
    """Recovery value selection over the ballot-0 reports of an n-f promise
    quorum (protocol/recovery.py; the reference's todo!() at
    epaxos.rs:627-629).  Reports are the deps fast-quorum members set when
    acking the MCollect plus non-quorum holders' "late reports" (staged at
    payload receipt so conflict edges survive losing the
    quorum-intersection member); bottom (``is_noop``) marks acceptors that
    never saw the payload.  No report anywhere -> the dot is recovered as
    a committed noop; otherwise the union of reports — a free (therefore
    safe) choice whenever no commit was decided before recovery began,
    which protocol/recovery.py's safety note reduces to the
    recovery_delay_ms-exceeds-delivery-delay assumption."""
    deps: Set[Dependency] = set()
    reported = False
    for value in values.values():
        if not value.is_noop:
            reported = True
            deps |= value.deps
    if not reported:
        return ConsensusValue(set(), is_noop=True)
    return ConsensusValue(deps)


def _graph_info_factory(pid, _sid, _cfg, _fq, _wq, *, n, f, quorum_deps_size):
    """Picklable per-dot info factory (the model checker pickles state);
    a partial over primitives pickles by reference + args."""
    return GraphCommandInfo(pid, n, f, quorum_deps_size)


class GraphCommandInfo:
    """Per-dot lifecycle info (epaxos.rs:628-668)."""

    __slots__ = ("status", "quorum", "synod", "cmd", "quorum_deps")

    def __init__(self, process_id: ProcessId, n: int, f: int, quorum_deps_size: int):
        self.status = Status.START
        self.quorum: Set[ProcessId] = set()
        self.synod: Synod[ConsensusValue] = Synod(
            process_id, n, f, _recovery_proposal_gen, ConsensusValue.bottom()
        )
        self.cmd: Optional[Command] = None
        self.quorum_deps = QuorumDeps(quorum_deps_size)


class GraphProtocol(PartialCommitMixin, RecoveryMixin, SyncMixin, CommitGCMixin, Protocol):
    """Common skeleton; see module docstring for the specialization points."""

    Executor = GraphExecutor

    # --- subclass hooks ---

    @classmethod
    def quorum_sizes(cls, config: Config) -> Tuple[int, int]:
        raise NotImplementedError

    @classmethod
    def consensus_f(cls, config: Config) -> int:
        """The f used by the embedded synod."""
        raise NotImplementedError

    @classmethod
    def coordinator_self_ack(cls) -> bool:
        """Whether the coordinator's own deps join the quorum-deps tracker."""
        raise NotImplementedError

    def fast_path_condition(self, info: GraphCommandInfo) -> Tuple[Set[Dependency], bool]:
        raise NotImplementedError

    # --- construction ---

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        fast_quorum_size, write_quorum_size = self.quorum_sizes(config)
        self.bp = BaseProcess(process_id, shard_id, config, fast_quorum_size, write_quorum_size)
        self.key_deps = KeyDeps(shard_id)
        f = self.consensus_f(config)
        quorum_deps_size = (
            fast_quorum_size if self.coordinator_self_ack() else fast_quorum_size - 1
        )
        self._cmds: CommandsInfo[GraphCommandInfo] = CommandsInfo(
            process_id,
            shard_id,
            config,
            fast_quorum_size,
            write_quorum_size,
            functools.partial(
                _graph_info_factory, n=config.n, f=f,
                quorum_deps_size=quorum_deps_size,
            ),
        )
        self._gc_track = GCTrack(process_id, shard_id, config.n)
        self._to_processes: Deque[Action] = deque()
        self._to_executors: Deque[Any] = deque()
        # commit notifications that arrived before the MCollect (possible
        # even without failures, due to connection multiplexing)
        self._buffered_commits: Dict[Dot, Tuple[ProcessId, ConsensusValue]] = {}
        # single-shard commits cross the executor boundary as arrays built
        # incrementally here at commit time (GraphAddBatch); multi-shard
        # keeps per-command GraphAdd because remote
        # Dependency shard sets must survive the crossing
        self._commit_buffer = (
            _CommitBuffer(shard_id) if config.shard_count == 1 else None
        )
        self._init_partial()
        self._init_recovery()

    def periodic_events(self):
        return list(self.gc_periodic_events()) + self.recovery_periodic_events()

    @property
    def id(self) -> ProcessId:
        return self.bp.process_id

    @property
    def shard_id(self) -> ShardId:
        return self.bp.shard_id

    def discover(self, processes):
        connect_ok = self.bp.discover(processes)
        return connect_ok, dict(self.bp.closest_shard_process())

    @classmethod
    def supports_partial_replication(cls) -> bool:
        """EPaxos does not support partial replication (mirroring the
        reference: no partial messages in fantoch_ps/src/protocol/epaxos.rs);
        Atlas does (atlas.rs:157-165)."""
        return False

    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None:
        if cmd.shard_count > 1:
            assert self.supports_partial_replication(), (
                f"{type(self).__name__} does not support multi-shard commands"
            )
        dot = self._handle_submit(dot, cmd, target_shard=True)
        # trace: dot assigned + payload owned at the coordinator
        self.bp.trace_span("payload", cmd.rifl, dot=dot)

    def handle(self, from_, from_shard_id, msg, time):
        if isinstance(msg, MCollect):
            self._handle_mcollect(from_, msg.dot, msg.cmd, msg.quorum, msg.deps, time)
        elif isinstance(msg, MCollectAck):
            self._handle_mcollectack(from_, msg.dot, msg.deps)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(
                from_, msg.dot, msg.value, time, getattr(msg, "cmd", None)
            )
        elif isinstance(msg, MConsensus):
            self._handle_mconsensus(from_, msg.dot, msg.ballot, msg.value, msg.cmd, time)
        elif isinstance(msg, MConsensusAck):
            self._handle_mconsensusack(from_, msg.dot, msg.ballot)
        elif self.handle_recovery_message(from_, msg, time):
            pass
        elif self.handle_sync_message(from_, msg, time):
            pass
        elif self.handle_partial_message(from_, msg):
            pass
        elif not self.handle_gc_message(from_, msg):
            raise AssertionError(f"unknown message {msg}")

    def handle_event(self, event, time):
        if isinstance(event, RecoveryEvent):
            self.handle_recovery_event(time)
            return
        assert isinstance(event, GarbageCollectionEvent)
        self.handle_gc_event()

    def to_processes(self) -> Optional[Action]:
        return self._to_processes.popleft() if self._to_processes else None

    def to_executors(self):
        if self._commit_buffer is not None and self._commit_buffer.count:
            return self._commit_buffer.flush()
        return self._to_executors.popleft() if self._to_executors else None

    @classmethod
    def parallel(cls) -> bool:
        return KeyDeps.parallel()

    @classmethod
    def leaderless(cls) -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics()

    # --- handlers ---

    def _handle_submit(
        self, dot: Optional[Dot], cmd: Command, target_shard: bool
    ) -> Dot:
        dot = dot if dot is not None else self.bp.next_dot()
        # forward the submit to the other shards the command touches
        # (no-op for single-shard commands / forwarded submits)
        self.partial_submit_actions(dot, cmd, target_shard)
        deps = self.key_deps.add_cmd(dot, cmd, None)
        mcollect = MCollect(dot, cmd, deps, self.bp.fast_quorum())
        self._to_processes.append(ToSend(self.bp.all(), mcollect))
        return dot

    def _handle_mcollect(self, from_, dot, cmd, quorum, remote_deps, time) -> None:
        if self._gc_track.contains(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status != Status.START:
            return
        self._recovery_track(dot, time)
        if self.bp.process_id not in quorum:
            # not in the fast quorum: just store the payload; replay any
            # buffered commit now that we have it
            info.status = Status.PAYLOAD
            info.cmd = cmd
            if self._recovery_enabled():
                # record the payload in the conflict index and stage a
                # ballot-0 "late report": if this dot ever needs recovery,
                # our promise then carries the conflict edges we know
                # about.  Without it, two dots recovered from disjoint
                # survivor sets can commit with no dependency edge between
                # them — the quorum-intersection member that would have
                # reported the edge being exactly the crashed one
                deps = self.key_deps.add_cmd(dot, cmd, remote_deps)
                info.synod.set_if_not_accepted(lambda: ConsensusValue(set(deps)))
            self._replay_buffered_commit(dot, time)
            return

        message_from_self = from_ == self.bp.process_id
        if message_from_self:
            # coordinator already computed deps at submit
            deps = remote_deps
        else:
            deps = self.key_deps.add_cmd(dot, cmd, remote_deps)

        info.cmd = cmd
        value = ConsensusValue(set(deps))
        if not info.synod.set_if_not_accepted(lambda: value):
            # a recovery prepare already owns a higher ballot for this dot:
            # our promise forbids the ballot-0 ack, so keep the payload and
            # let recovery drive the commit
            info.status = Status.PAYLOAD
            self._replay_buffered_commit(dot, time)
            return
        info.status = Status.COLLECT
        info.quorum = set(quorum)

        if self.coordinator_self_ack() or not message_from_self:
            self._to_processes.append(ToSend({from_}, MCollectAck(dot, deps)))
        # with recovery in play a commit can be decided without this
        # member's ack and thus arrive before its MCollect — replay it
        self._replay_buffered_commit(dot, time)

    def _replay_buffered_commit(self, dot, time) -> None:
        buffered = self._buffered_commits.pop(dot, None)
        if buffered is not None:
            buf_from, buf_value = buffered
            self._handle_mcommit(buf_from, dot, buf_value, time)

    def _handle_mcollectack(self, from_, dot, deps) -> None:
        if self._gc_track.contains(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        if not self.coordinator_self_ack():
            assert from_ != self.bp.process_id
        info = self._cmds.get(dot)
        if info.status != Status.COLLECT:
            return
        if info.quorum_deps.contains(from_):
            # duplicate ack (at-least-once delivery): re-counting reports
            # would inflate the Atlas fast-path threshold unsoundly, and a
            # late duplicate after quorum completion (slow path / recovery
            # join keep status COLLECT) would trip the size assert
            return
        info.quorum_deps.add(from_, deps)
        if not info.quorum_deps.all():
            return
        final_deps, fast_path = self.fast_path_condition(info)
        value = ConsensusValue(final_deps)
        if not info.synod.can_skip_prepare():
            # a recovery proposer owns a higher ballot: neither the
            # unilateral fast-path commit nor the first-ballot shortcut is
            # sound anymore — join recovery with a full prepare instead
            prepare = info.synod.new_prepare()
            self._to_processes.append(
                ToSend(
                    self.bp.all(), MRecoveryPrepare(dot, prepare.ballot, info.cmd)
                )
            )
            return
        if fast_path:
            self.bp.fast_path(dot, info.cmd)
            self._mcommit_actions(dot, value)
        else:
            self.bp.slow_path(dot, info.cmd)
            ballot = info.synod.skip_prepare()
            self._to_processes.append(
                ToSend(self.bp.write_quorum(), MConsensus(dot, ballot, value))
            )

    def _handle_mcommit(self, from_, dot, value, time, cmd=None) -> None:
        if self._gc_track.contains(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status == Status.COMMIT:
            return
        if cmd is not None and info.cmd is None:
            # recovery chosen-reply piggyback: adopt so the commit below
            # can proceed instead of buffering payload-less.  A commit
            # buffered earlier for this dot is superseded by this one
            # (consensus decided the same value) — pop it or it leaks
            self._buffered_commits.pop(dot, None)
            info.cmd = cmd
            if info.status == Status.START:
                info.status = Status.PAYLOAD
        if value.is_noop:
            # recovered noop (the dot was never payloaded anywhere the
            # promise quorum could see): nothing executes — the executor's
            # noop seam just resolves any dependents waiting on the dot
            self._to_executors.append(GraphNoop(dot))
            self._commit_bookkeeping(info, from_, dot, value)
            return
        if info.status == Status.START:
            # MCollect may arrive after MCommit (multiplexing): buffer —
            # and track for recovery: if the MCollect never comes (it was
            # broadcast while this replica was down, and the commit was
            # still in flight when the rejoin records were cut), only the
            # recovery exchange can fetch the payload
            self._buffered_commits[dot] = (from_, value)
            self._recovery_track(dot, time)
            return
        cmd = info.cmd
        assert cmd is not None, "there should be a command payload"
        if self._commit_buffer is not None:
            self._commit_buffer.append(dot, cmd, value.deps)
        else:
            self._to_executors.append(GraphAdd(dot, cmd, set(value.deps)))
        self._commit_bookkeeping(info, from_, dot, value)

    def _commit_bookkeeping(self, info, from_, dot, value) -> None:
        info.status = Status.COMMIT
        if self.bp.audit_commits is not None:
            # audit plane: the agreed value is the dep set (noop commits
            # carry no command — record rifl None so the auditor never
            # counts them as a lost command)
            self.bp.audit_commit(
                dot,
                None if value.is_noop else (
                    info.cmd.rifl if info.cmd is not None else None
                ),
                "noop" if value.is_noop else tuple(
                    sorted(dep.dot for dep in value.deps)
                ),
            )
        if info.cmd is not None:
            meta = {"noop": True} if value.is_noop else None
            if (
                not value.is_noop
                and self.bp.tracer.enabled
                and self.bp.tracer.sample(info.cmd.rifl)
            ):
                # stamp the agreed dep set (capped) so the critical-path
                # walk can name WHICH dot the executor then waited on
                # (observability/critpath.py dep-wait blame); meta built
                # only for sampled spans — it costs a sort per commit
                deps = sorted(dep.dot for dep in value.deps)
                if deps:
                    meta = {"deps": [[d[0], d[1]] for d in deps[:16]]}
                    if len(deps) > 16:
                        meta["deps_total"] = len(deps)
            self.bp.trace_span("commit", info.cmd.rifl, dot=dot, meta=meta)
        out = info.synod.handle(from_, MChosen(value))
        assert out is None
        self._recovery_untrack(dot)
        if self._gc_running() and self._dot_in_my_shard(dot):
            self._to_processes.append(ToForward(MCommitDot(dot)))
        else:
            self._cmds.gc_single(dot)

    def _handle_mconsensus(self, from_, dot, ballot, value, cmd=None, time=None) -> None:
        if self._gc_track.contains(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None:
            self._adopt_recovered_payload(dot, info, cmd, time)
        out = info.synod.handle(from_, MAccept(ballot, value))
        if out is None:
            return  # ballot too low
        if isinstance(out, SynodMAccepted):
            self._to_processes.append(ToSend({from_}, MConsensusAck(dot, out.ballot)))
        elif isinstance(out, MChosen):
            # already chosen here (late MConsensus): replying the *local*
            # value is only sound single-shard — a multi-shard MCommit must
            # carry the cross-shard aggregate, which travels through
            # MShardAggregatedCommit (the coordinator's ack path)
            if info.cmd is None or info.cmd.shard_count == 1:
                self._to_processes.append(
                    ToSend({from_}, MCommit(dot, out.value, cmd=info.cmd))
                )
        else:
            raise AssertionError(f"unexpected synod output {out}")

    def _handle_mconsensusack(self, from_, dot, ballot) -> None:
        if self._gc_track.contains(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        out = info.synod.handle(from_, SynodMAccepted(ballot))
        if out is None:
            return
        assert isinstance(out, MChosen), f"unexpected synod output {out}"
        self._mcommit_actions(dot, out.value)

    def _mcommit_actions(self, dot: Dot, value: ConsensusValue) -> None:
        """Single-shard: broadcast MCommit.  Multi-shard: route the decided
        deps through the shard-commit aggregation (partial.rs:37-102)."""
        info = self._cmds.get(dot)
        cmd = info.cmd
        if cmd is None or not self.partial_mcommit_actions(dot, cmd, set(value.deps)):
            self._to_processes.append(ToSend(self.bp.all(), MCommit(dot, value)))

    # --- recovery hooks (protocol/recovery.py) ---

    def _adopt_recovered_payload(self, dot, info, cmd, time) -> None:
        info.cmd = cmd
        if info.status == Status.START:
            info.status = Status.PAYLOAD
            self._replay_buffered_commit(dot, time)

    def _recovery_commit_known(self, dot) -> bool:
        return dot in self._buffered_commits

    def _recovery_consensus_msg(self, dot, ballot, value, cmd):
        return MConsensus(dot, ballot, value, cmd)

    def _recovery_chosen_reply(self, to, dot, info, value) -> None:
        # same single-shard guard as the late-MConsensus reply: multi-shard
        # commits must carry the cross-shard aggregate.  The payload rides
        # along: the asker may hold a payload-less buffered commit
        if info.cmd is None or info.cmd.shard_count == 1:
            self._to_processes.append(
                ToSend({to}, MCommit(dot, value, cmd=info.cmd))
            )

    # --- rejoin sync hooks (protocol/sync.py) ---

    def _sync_record(self, dot, info):
        # the decided value lives in the per-dot synod once MChosen ran
        # (commit bookkeeping); cmd is None for recovered noops
        return (dot, info.cmd, info.synod.value())

    def _apply_sync_record(self, from_, record, time) -> None:
        dot, cmd, value = record
        if self._gc_track.contains(dot):
            return  # committed (and possibly executed + GC'd) here already
        info = self._cmds.get(dot)
        if info.status == Status.COMMIT:
            return
        if cmd is not None and info.cmd is None:
            self._adopt_recovered_payload(dot, info, cmd, time)
        self._handle_mcommit(from_, dot, value, time)

    # --- partial-replication adapters (deps union; atlas.rs:559-650) ---

    def _partial_initial_data(self):
        return set()

    def _partial_join(self, acc, data):
        return acc | set(data)

    def _partial_final_mcommit(self, dot: Dot, data, _local):
        return MCommit(dot, ConsensusValue(set(data)))

    def _dot_in_my_shard(self, dot: Dot) -> bool:
        return dot.target_shard(self.bp.config.n) == self.bp.shard_id

    # --- worker routing (epaxos.rs:704-740) ---

    @staticmethod
    def message_index(msg):
        if isinstance(
            msg,
            (
                MCollect,
                MCollectAck,
                MCommit,
                MConsensus,
                MConsensusAck,
                MForwardSubmit,
                MShardCommit,
                MShardAggregatedCommit,
                MRecoveryPrepare,
                MRecoveryPromise,
            ),
        ):
            return worker_dot_index_shift(msg.dot)
        if isinstance(msg, (MSync, MSyncReply, MSyncBackfill)):
            # dotless rejoin traffic: serialized on the GC worker (whose
            # committed clock it reads and whose retention it rides)
            return worker_index_no_shift(GC_WORKER_INDEX)
        gc_index = CommitGCMixin.gc_message_index(msg)
        if gc_index is not None:
            return gc_index[0]
        raise AssertionError(f"unknown message {msg}")


class EPaxos(GraphProtocol):
    """EPaxos: fast path iff *all* fast-quorum deps are equal; always
    tolerates a minority of faults (epaxos.rs:27-972)."""

    @classmethod
    def allowed_faults(cls, n: int) -> int:
        return n // 2

    @classmethod
    def quorum_sizes(cls, config: Config) -> Tuple[int, int]:
        return config.epaxos_quorum_sizes()

    @classmethod
    def consensus_f(cls, config: Config) -> int:
        return cls.allowed_faults(config.n)

    @classmethod
    def coordinator_self_ack(cls) -> bool:
        # the coordinator's deps don't join the fast-path check: the tracker
        # is sized fast_quorum_size - 1 and self-acks are never produced
        return False

    def fast_path_condition(self, info):
        return info.quorum_deps.check_union()


class Atlas(GraphProtocol):
    """Atlas: fast quorum n//2 + f; fast path via threshold union — every
    dependency reported at least f times (atlas.rs:28-1143).  Supports
    partial replication (MForwardSubmit / MShardCommit /
    MShardAggregatedCommit, atlas.rs:157-165)."""

    @classmethod
    def supports_partial_replication(cls) -> bool:
        return True

    @classmethod
    def quorum_sizes(cls, config: Config) -> Tuple[int, int]:
        return config.atlas_quorum_sizes()

    @classmethod
    def consensus_f(cls, config: Config) -> int:
        return config.f

    @classmethod
    def coordinator_self_ack(cls) -> bool:
        return True

    def fast_path_condition(self, info):
        return info.quorum_deps.check_threshold_union(self.bp.config.f)
