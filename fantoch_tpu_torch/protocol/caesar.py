"""Caesar: timestamp + predecessors consensus with a wait condition.

The port of fantoch_tpu/protocol/caesar.py.  Reference:
fantoch_ps/src/protocol/caesar.rs (1399 LoC).  The coordinator
assigns a globally-unique lexicographic timestamp ``Clock(seq, pid)`` to
each command and proposes it to everyone; each replica computes the
conflicting commands with lower timestamps (the predecessors) and replies:

* ACCEPT (ok) — no conflicting command with a *higher* timestamp blocks it;
* WAIT — blocked by higher-timestamp conflicts whose fate is unknown: the
  reply is delayed until they commit/accept (the wait condition,
  caesar.rs:266-451);
* REJECT (not ok) — some higher-timestamp conflict does not include this
  command in its deps, so the proposed timestamp is too low; the replica
  counter-proposes a higher one.

Fast path iff the whole fast quorum (3n/4 + 1) said ok; otherwise the
coordinator retries with the aggregated (clock, deps) through MRetry on the
write quorum (majority), which yields extended deps and then commits.
Execution is the PredecessorsExecutor: conflicts execute in timestamp
order.  GC is driven by the *executed* clock reported back by the executor
(handle_executed, caesar.rs:177-179).

Crash recovery (beyond the reference, whose wait-condition TODO at
caesar.rs:840-842 is where its recovery story ends): every per-dot info
embeds a :class:`~fantoch_tpu.protocol.common.synod.Synod` over the
``(clock, predecessors)`` pair.  Each replica stages its MProposeAck
report — including reject counter-proposals and retry refreshes — as the
synod's ballot-0 value, so a surviving process can drive the shared
per-dot recovery consensus (protocol/recovery.py) when a coordinator dies
mid-flight:

* a promise carries the acceptor's staged ``(clock, deps)`` report plus a
  ``clock_floor`` — the highest timestamp sequence indexed on the dot's
  keys (executed-everywhere GC keeps every non-globally-executed conflict
  indexed, so the floor upper-bounds anything survivors executed past);
* on the free-choice path the proposer takes the max reported clock and
  the union of reported predecessor sets; if the quorum floor reaches the
  chosen clock it issues a FRESH unique timestamp above the floor
  (``clock_next`` after joining the floor) and re-extends the
  predecessors under it — a recovered commit can therefore neither
  deadlock a waiting proposal (its commit resolves the wait condition
  like any other) nor land below timestamps survivors executed past (the
  floor-consumption class Newt's recovery closes too);
* a dot payloaded at no live process commits as a NOOP: nothing executes,
  the executor's noop seam resolves dependents, and commands it was
  blocking unblock unconditionally (a command that never existed cannot
  reject anyone).

Restart & rejoin ride the shared :class:`SyncMixin`: commit records carry
the decided ``(clock, deps)`` value (the synod's chosen value), and the
key-clock index rebuilds from applied records — Caesar has no detached
vote channel, so unlike Newt there is no separate frontier backfill: the
predecessor index travels entirely inside the commit records, and the
timestamp sequence floor rides ``clock_join`` on each applied clock.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Set, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.pred import (
    PredArraysBuilder,
    PredecessorsExecutionInfo,
    PredecessorsExecutor,
    PredecessorsNoop,
)
from fantoch_tpu_torch.protocol.base import (
    Action,
    BaseProcess,
    Executed,
    Protocol,
    ProtocolMetrics,
    ToSend,
)
from fantoch_tpu_torch.protocol.commit_gc import MGarbageCollection
from fantoch_tpu_torch.protocol.common.pred_clocks import (
    Clock,
    KeyClocks,
    QuorumClocks,
    QuorumRetries,
)
from fantoch_tpu_torch.protocol.common.synod import (
    MAccept as SynodMAccept,
    MAccepted as SynodMAccepted,
    MChosen as SynodMChosen,
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
from fantoch_tpu_torch.run.routing import (
    GC_WORKER_INDEX,
    worker_dot_index_shift,
    worker_index_no_shift,
)


# --- messages (caesar.rs:1088-1117) ---


@dataclass
class MPropose:
    dot: Dot
    cmd: Command
    clock: Clock


@dataclass
class MProposeAck:
    dot: Dot
    clock: Clock
    deps: Set[Dot]
    ok: bool


@dataclass
class MCommit:
    dot: Dot
    # None == recovered noop: the dot was payloaded at no live process,
    # nothing executes, dependents resolve through the executor noop seam
    clock: Optional[Clock]
    deps: Set[Dot]
    # payload piggyback on recovery chosen-replies and consensus-decided
    # commits: a recovering (or rejoining) replica can hold a buffered
    # commit for a dot whose MPropose it never saw — without the payload
    # the prepare/chosen exchange would loop payload-less forever
    cmd: Optional[Command] = None


@dataclass
class MRetry:
    dot: Dot
    clock: Clock
    deps: Set[Dot]


@dataclass
class MRetryAck:
    dot: Dot
    deps: Set[Dot]


@dataclass
class MConsensus:
    """Recovery phase-2: a recovery proposer's ``(clock, deps)`` accept at
    its ballot (the Caesar analog of newt.MConsensus — the normal slow
    path keeps the reference's ballot-less MRetry round; only recovery
    runs through the synod)."""

    dot: Dot
    ballot: int
    value: "CaesarConsensusValue"
    # payload piggyback so a recovered pair can commit at processes the
    # original MPropose broadcast never reached
    cmd: Optional[Command] = None


@dataclass
class MConsensusAck:
    dot: Dot
    ballot: int


@dataclass
class GarbageCollectionEvent:
    pass


class Status:
    START = "start"
    PROPOSE = "propose"
    REJECT = "reject"
    ACCEPT = "accept"
    COMMIT = "commit"


@dataclass(frozen=True)
class CaesarConsensusValue:
    """The pair agreed on per dot: the final timestamp and predecessor
    set.  ``clock None`` is the *noop* bottom: a recovery promise carrying
    it means "this acceptor never computed a report for the dot", which is
    what distinguishes a never-payloaded dot (recovered as a committed
    noop) from a real report with empty predecessors.  ``deps`` is a
    sorted tuple so equal values fingerprint identically in the model
    checker."""

    clock: Optional[Clock]
    deps: Tuple[Dot, ...]

    @property
    def is_noop(self) -> bool:
        return self.clock is None

    @staticmethod
    def bottom() -> "CaesarConsensusValue":
        return CaesarConsensusValue(None, ())


def _caesar_recovery_proposal_gen(values):
    """Recovery pair selection over the ballot-0 reports of the promise
    quorum (protocol/recovery.py): the highest reported clock with the
    union of reported predecessor sets; all-noop -> the dot is recovered
    as a committed noop.  The union may still be free-choice-adjusted
    (clock lift + predecessor re-extension) by ``_recovery_adjust_value``
    before it is proposed."""
    clock: Optional[Clock] = None
    deps: Set[Dot] = set()
    for value in values.values():
        if value.is_noop:
            continue
        deps |= set(value.deps)
        if clock is None or value.clock > clock:
            clock = value.clock
    if clock is None:
        return CaesarConsensusValue.bottom()
    return CaesarConsensusValue(clock, tuple(sorted(deps)))


def _caesar_info_factory(pid, _sid, cfg, fq, wq) -> "CaesarInfo":
    """Picklable per-dot info factory (the model checker pickles state)."""
    return CaesarInfo(pid, cfg.n, cfg.f, fq, wq)


class CaesarInfo:
    """Per-dot lifecycle info (caesar.rs:1039-1086)."""

    __slots__ = (
        "status",
        "cmd",
        "clock",
        "deps",
        "blocking",
        "blocked_by",
        "quorum_clocks",
        "quorum_retries",
        "synod",
    )

    def __init__(
        self,
        process_id: ProcessId,
        n: int,
        f: int,
        fast_quorum_size: int,
        write_quorum_size: int,
    ):
        self.status = Status.START
        self.cmd: Optional[Command] = None
        self.clock = Clock.zero(process_id)
        self.deps: Set[Dot] = set()
        # commands this command is blocking / blocked by (the wait condition)
        self.blocking: Set[Dot] = set()
        self.blocked_by: Set[Dot] = set()
        self.quorum_clocks = QuorumClocks(process_id, fast_quorum_size, write_quorum_size)
        self.quorum_retries = QuorumRetries(write_quorum_size)
        # per-dot recovery consensus over the (clock, deps) pair; ballot-0
        # holds this replica's staged MProposeAck report
        self.synod: Synod[CaesarConsensusValue] = Synod(
            process_id, n, f, _caesar_recovery_proposal_gen,
            CaesarConsensusValue.bottom(),
        )


class Caesar(RecoveryMixin, SyncMixin, Protocol):
    Executor = PredecessorsExecutor

    @classmethod
    def allowed_faults(cls, n: int) -> int:
        return n // 2

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        fast_quorum_size, write_quorum_size = config.caesar_quorum_sizes()
        self.bp = BaseProcess(process_id, shard_id, config, fast_quorum_size, write_quorum_size)
        self.key_clocks = KeyClocks(process_id, shard_id)
        self._cmds: CommandsInfo[CaesarInfo] = CommandsInfo(
            process_id,
            shard_id,
            config,
            fast_quorum_size,
            write_quorum_size,
            _caesar_info_factory,
        )
        self._gc_track = GCTrack(process_id, shard_id, config.n)
        self._to_processes: Deque[Action] = deque()
        self._to_executors: Deque[PredecessorsExecutionInfo] = deque()
        # column-borne commit seam (the TableVotesArraysBuilder
        # move): with the device pred plane on, commits/noops accumulate
        # as columns and drain ONE PredExecutionArrays per to_executors
        # sweep — no per-command info objects on the plane path (the
        # runner disables it via set_commit_arrays for executor pools)
        self._commit_arrays: Optional[PredArraysBuilder] = (
            PredArraysBuilder() if config.device_pred_plane else None
        )
        # MRetry/MCommit that arrived before the MPropose (multiplexing)
        self._buffered_retries: Dict[Dot, Tuple[ProcessId, Clock, Set[Dot]]] = {}
        self._buffered_commits: Dict[
            Dot, Tuple[ProcessId, Optional[Clock], Set[Dot]]
        ] = {}
        self._wait_condition = config.caesar_wait_condition
        # WAL-tail replayed commit dots not yet re-executed here: the
        # straggler/horizon overlay (see note_durable_commits) — they
        # cannot live in _gc_track because handle_executed REPLACES its
        # clock with the executor's executed clock, which excludes a
        # replayed commit still pending on a dependency
        self._durable_tail: set = set()
        self._init_recovery()
        # safety requires executed-everywhere GC: removing a command from the
        # key-clock index at commit time (the reference's no-GC shortcut,
        # caesar.rs:616-620, flagged unsafe by its own TODO at :840-842)
        # lets later proposals miss it as a predecessor, so conflicting
        # commands can execute in different orders on different replicas
        assert config.gc_interval_ms is not None, (
            "Caesar requires gc_interval_ms: commands may only leave the "
            "key-clock index once executed everywhere"
        )

    def periodic_events(self):
        # gc_interval_ms is mandatory (asserted in __init__)
        events = [(GarbageCollectionEvent(), self.bp.config.gc_interval_ms)]
        events.extend(self.recovery_periodic_events())
        return events

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
        clock = self.key_clocks.clock_next()
        # send to everyone: due to the wait condition the fastest ok-quorum
        # may not be the closest one
        self._to_processes.append(ToSend(self.bp.all(), MPropose(dot, cmd, clock)))

    def handle(self, from_, from_shard_id, msg, time):
        if isinstance(msg, MPropose):
            self._handle_mpropose(from_, msg.dot, msg.cmd, msg.clock, time)
        elif isinstance(msg, MProposeAck):
            self._handle_mproposeack(from_, msg.dot, msg.clock, msg.deps, msg.ok)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(
                from_, msg.dot, msg.clock, msg.deps, time, getattr(msg, "cmd", None)
            )
        elif isinstance(msg, MRetry):
            self._handle_mretry(from_, msg.dot, msg.clock, msg.deps, time)
        elif isinstance(msg, MRetryAck):
            self._handle_mretryack(from_, msg.dot, msg.deps)
        elif isinstance(msg, MConsensus):
            self._handle_mconsensus(from_, msg.dot, msg.ballot, msg.value, msg.cmd, time)
        elif isinstance(msg, MConsensusAck):
            self._handle_mconsensusack(from_, msg.dot, msg.ballot)
        elif isinstance(msg, MGarbageCollection):
            self._handle_mgc(from_, msg.committed)
        elif self.handle_recovery_message(from_, msg, time):
            pass
        elif self.handle_sync_message(from_, msg, time):
            pass
        else:
            raise AssertionError(f"unknown message {msg}")

    def handle_event(self, event, time):
        if isinstance(event, RecoveryEvent):
            self.handle_recovery_event(time)
            return
        assert isinstance(event, GarbageCollectionEvent)
        self._to_processes.append(
            ToSend(self.bp.all_but_me(), MGarbageCollection(self._gc_track.clock()))
        )

    def handle_executed(self, executed: Executed, time: SysTime) -> None:
        # GC is driven by the executor: a dot is collectable once *executed*
        # everywhere (not just committed — the key-clock index must keep
        # commands until no proposal can conflict with them)
        if self._durable_tail:
            # replayed-commit overlay dots age out once truly executed
            self._durable_tail = {
                dot
                for dot in self._durable_tail
                if not executed.contains(dot.source, dot.sequence)
            }
        self._gc_track.update_clock(executed)

    def note_durable_commits(self, dots) -> None:
        """Restart-replay hook (run/wal.py): remember WAL-tail commit dots
        so the straggler guards and the rejoin horizon cover them.  They
        go into an OVERLAY, not the GC clock: handle_executed replaces
        that clock wholesale with the executor's executed clock, which
        would silently drop a replayed commit still pending on a
        dependency — a later duplicate/re-streamed commit would then
        resurrect a fresh info and re-feed the executor, tripping its
        exactly-once assert."""
        if self.bp.config.shard_count != 1:
            return
        self._durable_tail.update(dots)

    def _gc_straggler(self, dot: Dot) -> bool:
        """True when ``dot``'s commit is already settled here — executed
        (the GC clock) or replayed from the WAL tail (the overlay) — so
        an incoming message for it is a straggler that must not
        resurrect a fresh info."""
        return self._gc_track.contains(dot) or dot in self._durable_tail

    def _recovery_settled(self, dot: Dot) -> bool:
        # recovery-plane guard (RecoveryMixin): WAL-tail replayed dots
        # are committed, never recovery candidates
        return self._gc_straggler(dot)

    def to_processes(self) -> Optional[Action]:
        return self._to_processes.popleft() if self._to_processes else None

    def to_executors(self):
        if self._commit_arrays is not None and len(self._commit_arrays):
            return self._commit_arrays.take()
        return self._to_executors.popleft() if self._to_executors else None

    def set_commit_arrays(self, enabled: bool) -> None:
        """Runner hook (the Newt seam's twin): the arrays commit seam
        assumes a single predecessors executor consumes this process's
        infos; executor pools must turn it off (falls back to
        per-command infos)."""
        if enabled and self._commit_arrays is None:
            self._commit_arrays = PredArraysBuilder()
        elif not enabled and self._commit_arrays is not None:
            # flush anything accumulated so no commit is lost
            pending = self._commit_arrays.take()
            if pending is not None:
                self._to_executors.append(pending)
            self._commit_arrays = None

    def _emit_commit(self, dot: Dot, cmd: Command, clock: Clock, deps: Set[Dot]) -> None:
        if self._commit_arrays is not None:
            self._commit_arrays.add_commit(dot, cmd, clock, deps)
        else:
            self._to_executors.append(
                PredecessorsExecutionInfo(dot, cmd, clock, deps)
            )

    def _emit_noop(self, dot: Dot) -> None:
        if self._commit_arrays is not None:
            self._commit_arrays.add_noop(dot)
        else:
            self._to_executors.append(PredecessorsNoop(dot))

    @classmethod
    def parallel(cls) -> bool:
        return KeyClocks.parallel()

    @classmethod
    def leaderless(cls) -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics()

    # --- handlers ---

    def _handle_mpropose(self, from_, dot, cmd, remote_clock: Clock, time) -> None:
        assert dot.source == from_, "the coordinator is the dot source"
        self.key_clocks.clock_join(remote_clock)

        if self._gc_straggler(dot):
            # straggler (late duplicate) for a dot already committed
            # everywhere and GC'd (or replayed from the WAL tail):
            # `_cmds.get` would resurrect a fresh START info, and a
            # trailing MCommit duplicate could then RE-feed the executor
            # (its exactly-once assert catches the replay) — the
            # GC-straggler class, Caesar edition
            return
        info = self._cmds.get(dot)
        if info.status != Status.START:
            return

        # predecessors under the proposed timestamp; higher-timestamp
        # conflicts block the reply (the wait condition's input)
        blocked_by: Set[Dot] = set()
        deps = self.key_clocks.predecessors(dot, cmd, remote_clock, blocked_by)

        info.status = Status.PROPOSE
        info.cmd = cmd
        info.deps = deps
        self._update_clock(dot, info, remote_clock)
        info.blocked_by = set(blocked_by)
        self._recovery_track(dot, time)

        # stage the ballot-0 recovery report NOW (the proposed pair as
        # computed here): a WAITING command's ack may never be sent, but
        # its promise must still carry the conflict edges this replica
        # knows about.  Failure means a recovery prepare already owns a
        # higher ballot — the ballot-0 ack is forbidden (our promise is a
        # contract); the command stays indexed (it must appear as a
        # predecessor of later proposals) and recovery drives the commit
        staged = info.synod.set_if_not_accepted(
            lambda: CaesarConsensusValue(remote_clock, tuple(sorted(deps)))
        )
        if not staged:
            self._replay_buffered(dot, time)
            return

        if not blocked_by:
            self._accept_command(dot, info)
        elif not self._wait_condition:
            self._reject_command(dot, info)
        else:
            # check each blocker: ACCEPT/COMMIT blockers with a good-enough
            # clock+deps can be ignored; an un-ignorable one rejects us right
            # away; unknown-fate ones register us in their blocking set
            reject = False
            not_blocked_by: Set[Dot] = set()
            for blocker in blocked_by:
                blocker_info = self._cmds.get_existing(blocker)
                if blocker_info is None:
                    # GCed = executed everywhere: can be ignored
                    not_blocked_by.add(blocker)
                    continue
                if blocker_info.status in (Status.ACCEPT, Status.COMMIT):
                    if self._safe_to_ignore(
                        dot, info.clock, blocker_info.clock, blocker_info.deps
                    ):
                        not_blocked_by.add(blocker)
                    else:
                        reject = True
                        break
                else:
                    blocker_info.blocking.add(dot)
            if reject:
                self._reject_command(dot, info)
            elif len(not_blocked_by) == len(blocked_by):
                self._accept_command(dot, info)
            else:
                info.blocked_by -= not_blocked_by
                assert info.blocked_by, "a waiting command must have blockers"

        # replay any buffered retry/commit now that we have the payload
        self._replay_buffered(dot, time)

    def _replay_buffered(self, dot, time) -> None:
        buffered = self._buffered_retries.pop(dot, None)
        if buffered is not None:
            self._handle_mretry(buffered[0], dot, buffered[1], buffered[2], time)
        buffered = self._buffered_commits.pop(dot, None)
        if buffered is not None:
            self._handle_mcommit(buffered[0], dot, buffered[1], buffered[2], time)

    def _handle_mproposeack(self, from_, dot, clock: Clock, deps, ok: bool) -> None:
        # get_existing: a straggler ack (MPropose went to all n, only the
        # fast quorum's replies matter) must not recreate a GCed info
        info = self._cmds.get_existing(dot)
        if info is None:
            return
        # the coordinator can end up rejecting its own command, hence REJECT
        if info.status not in (Status.PROPOSE, Status.REJECT):
            return
        if info.quorum_clocks.contains(from_):
            # duplicate ack (at-least-once delivery): double-counting a
            # participant would complete the quorum with fewer distinct
            # reports — an unsound fast path (the dedup class of both
            # mcollectack handlers)
            return
        if info.quorum_clocks.all():
            # straggler ack: MPropose goes to all n but the quorum (< n for
            # n>=5) completes first, and the commit/retry that flips the
            # status travels through the message queue — so a late ack can
            # legitimately arrive while the status is still PROPOSE/REJECT
            # (the reference panics here, reachable in the TCP runner's
            # reader-task queueing)
            return

        info.quorum_clocks.add(from_, clock, deps, ok)
        if not info.quorum_clocks.all():
            return

        if not info.synod.can_skip_prepare():
            # a recovery proposer owns a higher ballot for this dot: a
            # unilateral commit/retry is no longer sound — join recovery
            # with a full prepare instead (the Newt mcollectack pattern)
            prepare = info.synod.new_prepare()
            self._to_processes.append(
                ToSend(self.bp.all(), MRecoveryPrepare(dot, prepare.ballot, info.cmd))
            )
            return

        agg_clock, agg_deps, agg_ok = info.quorum_clocks.aggregated()
        if agg_ok:
            # everyone accepted the coordinator's proposal as-is
            assert agg_clock == info.clock
            self.bp.fast_path()
            self._to_processes.append(
                ToSend(self.bp.all(), MCommit(dot, agg_clock, agg_deps))
            )
        else:
            self.bp.slow_path()
            # sent to everyone: the new clock may unblock waiting commands
            self._to_processes.append(
                ToSend(self.bp.all(), MRetry(dot, agg_clock, agg_deps))
            )

    def _handle_mcommit(
        self, from_, dot, clock: Optional[Clock], deps, time=None, cmd=None
    ) -> None:
        if clock is not None:
            self.key_clocks.clock_join(clock)
        if self._gc_straggler(dot):
            return  # straggler for a settled dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status == Status.COMMIT:
            return
        if cmd is not None and info.cmd is None:
            # recovery chosen-reply / sync-record piggyback: adopt so the
            # commit below proceeds instead of buffering payload-less.  A
            # commit buffered earlier is superseded by this one (consensus
            # decided the same value) — pop it or it leaks
            self._buffered_commits.pop(dot, None)
            self._adopt_recovered_payload(dot, info, cmd, time)
            if info.status == Status.COMMIT:
                return  # adoption replayed a buffered retry chain to commit

        if clock is None:
            # recovered noop: the dot was payloaded at no live process.
            # Nothing executes and nothing is indexed — the executor noop
            # seam resolves dependents, and commands this dot was blocking
            # unblock unconditionally (a command that never existed cannot
            # reject anyone)
            info.status = Status.COMMIT
            # audit plane: a noop commit executes nothing — rifl None
            self.bp.audit_commit(dot, None, "noop")
            if info.cmd is not None and not info.clock.is_zero():
                # un-index: a noop must stop being reported as a
                # predecessor (and _gc_command must not try to remove it
                # again — the zero clock marks it)
                self.key_clocks.remove(info.cmd, info.clock)
                info.clock = Clock.zero(self.bp.process_id)
            self._emit_noop(dot)
            blocking, info.blocking = info.blocking, set()
            for blocked in blocking:
                blocked_info = self._cmds.get_existing(blocked)
                if blocked_info is None or blocked_info.status != Status.PROPOSE:
                    continue
                blocked_info.blocked_by.discard(dot)
                if not blocked_info.blocked_by:
                    self._accept_command(blocked, blocked_info)
            out = info.synod.handle(from_, SynodMChosen(CaesarConsensusValue.bottom()))
            assert out is None
            self._recovery_untrack(dot)
            return

        if info.status == Status.START:
            self._buffered_commits[dot] = (from_, clock, set(deps))
            if time is not None:
                # track for recovery: if the MPropose never comes (it was
                # broadcast while this replica was down and the commit
                # missed the rejoin records), only the recovery
                # chosen-reply exchange can fetch the payload
                self._recovery_track(dot, time)
            return

        cmd = info.cmd
        assert cmd is not None, "there should be a command payload"
        self._emit_commit(dot, cmd, clock, set(deps))

        info.status = Status.COMMIT
        # audit plane: agreement = same dot, same (clock, predecessors)
        self.bp.audit_commit(dot, cmd.rifl, (clock, tuple(sorted(deps))))
        info.deps = set(deps)
        self._update_clock(dot, info, clock)
        # settle the per-dot synod so recovery prepares short-circuit with
        # this decided pair, and stop any recovery retries for the dot
        out = info.synod.handle(
            from_, SynodMChosen(CaesarConsensusValue(clock, tuple(sorted(deps))))
        )
        assert out is None
        self._recovery_untrack(dot)

        blocking, info.blocking = info.blocking, set()
        self._try_to_unblock(dot, clock, info.deps, blocking)

    def _handle_mretry(self, from_, dot, clock: Clock, deps, time=None) -> None:
        self.key_clocks.clock_join(clock)
        if self._gc_straggler(dot):
            return  # straggler for a settled dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status == Status.START:
            self._buffered_retries[dot] = (from_, clock, set(deps))
            return
        if info.status == Status.COMMIT:
            return

        info.status = Status.ACCEPT
        info.deps = set(deps)
        self._update_clock(dot, info, clock)
        # refresh the staged ballot-0 report to the retry pair: a recovery
        # promise must report the freshest knowledge (no-op once a
        # recovery prepare froze the report by bumping the ballot)
        info.synod.set_if_not_accepted(
            lambda: CaesarConsensusValue(clock, tuple(sorted(deps)))
        )

        # reply with deps extended by our own lower-timestamp conflicts
        cmd = info.cmd
        assert cmd is not None
        new_deps = self.key_clocks.predecessors(dot, cmd, clock)
        new_deps.update(deps)
        self._to_processes.append(ToSend({from_}, MRetryAck(dot, new_deps)))

        blocking, info.blocking = info.blocking, set()
        self._try_to_unblock(dot, clock, info.deps, blocking)

    def _handle_mretryack(self, from_, dot, deps) -> None:
        info = self._cmds.get_existing(dot)
        if info is None or info.status != Status.ACCEPT:
            return
        if info.quorum_retries.contains(from_):
            return  # duplicate ack (at-least-once delivery)
        if info.quorum_retries.all():
            # straggler MRetryAck past write-quorum completion (see the
            # matching guard in _handle_mproposeack)
            return

        info.quorum_retries.add(from_, deps)
        if not info.quorum_retries.all():
            return
        if not info.synod.can_skip_prepare():
            # a recovery proposer owns a higher ballot: join recovery
            # instead of committing unilaterally
            prepare = info.synod.new_prepare()
            self._to_processes.append(
                ToSend(self.bp.all(), MRecoveryPrepare(dot, prepare.ballot, info.cmd))
            )
            return
        agg_deps = info.quorum_retries.aggregated()
        self._to_processes.append(
            ToSend(self.bp.all(), MCommit(dot, info.clock, agg_deps))
        )

    def _handle_mgc(self, from_: ProcessId, committed) -> None:
        self._gc_track.update_clock_of(from_, committed)
        stable = self._gc_track.stable()
        count = 0
        for process_id, start, end in stable:
            for seq in range(start, end + 1):
                self._gc_command(Dot(process_id, seq))
                count += 1
        if count:
            self.bp.stable(count)

    # --- recovery consensus (protocol/recovery.py + the synod phase-2) ---

    def _handle_mconsensus(self, from_, dot, ballot, value, cmd=None, time=None) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a settled dot: do not resurrect its info
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None:
            self._adopt_recovered_payload(dot, info, cmd, time)
        out = info.synod.handle(from_, SynodMAccept(ballot, value))
        if out is None:
            return  # ballot too low
        if isinstance(out, SynodMAccepted):
            self._to_processes.append(ToSend({from_}, MConsensusAck(dot, out.ballot)))
        elif isinstance(out, SynodMChosen):
            # already decided here: short-circuit with the commit
            self._recovery_chosen_reply(from_, dot, info, out.value)
        else:
            raise AssertionError(f"unexpected synod output {out}")

    def _handle_mconsensusack(self, from_, dot, ballot) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a settled dot: do not resurrect its info
        info = self._cmds.get(dot)
        out = info.synod.handle(from_, SynodMAccepted(ballot))
        if out is None:
            return
        assert isinstance(out, SynodMChosen), f"unexpected synod output {out}"
        value = out.value
        self._to_processes.append(
            ToSend(
                self.bp.all(),
                MCommit(dot, value.clock, set(value.deps), cmd=info.cmd),
            )
        )

    # --- recovery hooks (protocol/recovery.py) ---

    def _adopt_recovered_payload(self, dot, info, cmd, time) -> None:
        info.cmd = cmd
        if info.status != Status.START:
            return
        # index the payload like a REJECT-style counter-report: a fresh
        # unique timestamp above everything seen here plus its
        # predecessors under it.  The dot must appear as a predecessor of
        # later conflicting proposals, and the staged ballot-0 report must
        # carry the conflict edges this replica knows about (the graph
        # protocols' "late report" idiom)
        clock = self.key_clocks.clock_next()
        deps = self.key_clocks.predecessors(dot, cmd, clock)
        info.status = Status.PROPOSE
        info.deps = deps
        self._update_clock(dot, info, clock)
        info.synod.set_if_not_accepted(
            lambda: CaesarConsensusValue(clock, tuple(sorted(deps)))
        )
        self._replay_buffered(dot, time)

    def _recovery_commit_known(self, dot) -> bool:
        return dot in self._buffered_commits

    def _recovery_consensus_msg(self, dot, ballot, value, cmd):
        return MConsensus(dot, ballot, value, cmd)

    def _recovery_chosen_reply(self, to, dot, info, value) -> None:
        # the payload rides along: the asker may hold a payload-less
        # buffered commit (rejoin gap); noop values carry clock None
        self._to_processes.append(
            ToSend(
                {to},
                MCommit(dot, value.clock, set(value.deps), cmd=info.cmd),
            )
        )

    def _recovery_promise_floor(self, dot, info) -> int:
        # the highest timestamp sequence indexed on the dot's keys
        # (excluding the dot itself): executed-everywhere GC keeps every
        # conflict indexed until globally executed, so the promise
        # quorum's max floor upper-bounds any timestamp survivors may
        # already have executed past — the free choice lifts above it
        if info.cmd is None or info.status == Status.COMMIT:
            return 0
        return self.key_clocks.max_seq(info.cmd, exclude=dot)

    def _recovery_adjust_value(self, dot, info, value, floor: int):
        # free-choice pairs lift above the quorum's floor with a FRESH
        # unique timestamp (clock_next after joining the floor — Caesar
        # clocks are (seq, pid) pairs, so reusing a seq under our own pid
        # could collide with a timestamp we already issued), and the
        # predecessor union re-extends under the lifted clock so every
        # conflict this proposer knows about orders below it.  Noop stays
        # noop.
        if value.is_noop:
            return value
        clock = value.clock
        deps = set(value.deps)
        if info.cmd is not None and floor >= clock.seq:
            self.key_clocks.clock_join(Clock(floor, 0))
            clock = self.key_clocks.clock_next()
            deps |= self.key_clocks.predecessors(dot, info.cmd, clock)
        deps.discard(dot)
        return CaesarConsensusValue(clock, tuple(sorted(deps)))

    # --- rejoin sync hooks (protocol/sync.py) ---

    def _sync_record(self, dot, info):
        # the decided (clock, deps) pair lives in the per-dot synod once
        # MChosen ran (commit bookkeeping); cmd is None for recovered
        # noops that were never payloaded here
        return (dot, info.cmd, info.synod.value())

    def _apply_sync_record(self, from_, record, time) -> None:
        dot, cmd, value = record
        if self._gc_straggler(dot):
            return  # executed (or WAL-tail replayed) here already
        info = self._cmds.get(dot)
        if info.status == Status.COMMIT:
            return
        self._handle_mcommit(from_, dot, value.clock, set(value.deps), time, cmd)

    # _sync_backfill_actions: the SyncMixin default (no-op) is correct for
    # Caesar — unlike Newt there is no detached vote channel to re-state:
    # the predecessor index rebuilds entirely from applied commit records,
    # and the timestamp floor rides clock_join on each applied clock.
    # Ranges "held by pending dots" have no Caesar analog because nothing
    # is consumed at propose time; pending dots heal through the recovery
    # plane instead (every MPropose/buffered commit is _recovery_track'd).

    # --- wait-condition helpers (caesar.rs:826-1035) ---

    def _safe_to_ignore(
        self, my_dot: Dot, my_clock: Clock, their_clock: Clock, their_deps: Set[Dot]
    ) -> bool:
        # clocks only increase: the blocker's (ACCEPT/COMMIT) clock must
        # still be higher than ours.  Ignoring it is safe only if it depends
        # on us — then it executes after us despite the higher timestamp
        assert my_clock < their_clock
        return my_dot in their_deps

    def _try_to_unblock(
        self, dot: Dot, clock: Clock, deps: Set[Dot], blocking: Set[Dot]
    ) -> None:
        """`dot` gained a final-enough (clock, deps): re-examine every
        command it was blocking."""
        for blocked in blocking:
            blocked_info = self._cmds.get_existing(blocked)
            if blocked_info is None or blocked_info.status != Status.PROPOSE:
                continue
            if self._safe_to_ignore(blocked, blocked_info.clock, clock, deps):
                blocked_info.blocked_by.discard(dot)
                if not blocked_info.blocked_by:
                    self._accept_command(blocked, blocked_info)
            else:
                # reject ASAP — no point waiting for the other blockers
                self._reject_command(blocked, blocked_info)

    def _accept_command(self, dot: Dot, info: CaesarInfo) -> None:
        self._send_mpropose_ack(dot, info, info.clock, set(info.deps), True)

    def _reject_command(self, dot: Dot, info: CaesarInfo) -> None:
        info.status = Status.REJECT
        # counter-propose: a fresh higher timestamp and its predecessors
        new_clock = self.key_clocks.clock_next()
        cmd = info.cmd
        assert cmd is not None
        new_deps = self.key_clocks.predecessors(dot, cmd, new_clock)
        self._send_mpropose_ack(dot, info, new_clock, new_deps, False)

    def _send_mpropose_ack(
        self, dot: Dot, info: CaesarInfo, clock: Clock, deps: Set[Dot], ok: bool
    ) -> None:
        # refresh the staged ballot-0 report to the pair actually acked
        # (a reject counter-proposal supersedes the propose-time report;
        # no-op once a recovery prepare froze the report)
        info.synod.set_if_not_accepted(
            lambda: CaesarConsensusValue(clock, tuple(sorted(deps)))
        )
        self._to_processes.append(ToSend({dot.source}, MProposeAck(dot, clock, deps, ok)))

    # --- clock index maintenance (caesar.rs:786-838) ---

    def _update_clock(self, dot: Dot, info: CaesarInfo, new_clock: Clock) -> None:
        cmd = info.cmd
        assert cmd is not None
        if not info.clock.is_zero():
            self.key_clocks.remove(cmd, info.clock)
        self.key_clocks.add(dot, cmd, new_clock)
        info.clock = new_clock

    def _gc_command(self, dot: Dot) -> None:
        info = self._cmds.gc_single(dot)
        assert info is not None, "the GC worker sees every command"
        # recovered noops may carry no payload (never payloaded here) and
        # always carry a zero clock (un-indexed at commit)
        if info.cmd is not None and not info.clock.is_zero():
            self.key_clocks.remove(info.cmd, info.clock)

    # --- worker routing (caesar.rs:1119-1160) ---

    @staticmethod
    def message_index(msg):
        if isinstance(
            msg,
            (
                MPropose,
                MProposeAck,
                MCommit,
                MRetry,
                MRetryAck,
                MConsensus,
                MConsensusAck,
                MRecoveryPrepare,
                MRecoveryPromise,
            ),
        ):
            return worker_dot_index_shift(msg.dot)
        if isinstance(msg, MGarbageCollection):
            return worker_index_no_shift(GC_WORKER_INDEX)
        if isinstance(msg, (MSync, MSyncReply, MSyncBackfill)):
            # dotless rejoin traffic: serialized on the GC worker (whose
            # committed clock it reads and whose retention it rides)
            return worker_index_no_shift(GC_WORKER_INDEX)
        raise AssertionError(f"unknown message {msg}")

    @staticmethod
    def event_index(event):
        return worker_index_no_shift(GC_WORKER_INDEX)
