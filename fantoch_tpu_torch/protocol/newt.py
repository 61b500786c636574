"""Newt (Tempo): timestamp consensus with per-key clock votes.

Reference: fantoch_ps/src/protocol/newt.rs (1535 LoC).  Every command gets a
timestamp; the coordinator proposes ``max`` over its key clocks + 1, fast-
quorum members counter-propose considering the remote clock as a minimum,
and the command commits at the max reported clock — on the fast path iff
that max was reported by at least ``f`` quorum members (newt.rs:527-546),
else through a Synod round on the clock value (``ConsensusValue = u64``,
newt.rs:1107).  Execution is delegated to the TableExecutor: votes consumed
while proposing prove that no lower timestamp can ever be assigned, making
timestamps *stable* once enough frontiers pass them.

Extras mirrored here:
- tiny quorums (fast quorum ``2f``, stability ``n - f``) and
  ``skip_fast_ack`` (fast-quorum members commit directly when ``q == 2``,
  newt.rs:95-97,313,451);
- real-time clock bump: a periodic event votes all keys up to
  ``max(max_commit_clock, time.micros())`` so stability tracks wall time
  under low load (newt.rs:983-1006);
- detached-vote batching via the periodic ``SendDetached`` event.

Partial replication (newt.rs:1025-1100 + 680-730): the target shard
forwards submits (MForwardSubmit); every acking fast-quorum member also
MBumps the closest process of each other shard so their key clocks chase
the command's likely timestamp with detached votes; each shard's decided
clock travels to the dot owner via MShardCommit, the owner aggregates the
*max* over shards, and the final MCommit at each participant carries the
aggregated clock with the shard's locally-held Votes (Votes never cross
shards — the data2 channel of partial.rs).
"""

from __future__ import annotations

import copy

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Set, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.table import (
    TableDetachedVotes,
    TableExecutor,
    TableVotes,
    TableVotesArraysBuilder,
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
from fantoch_tpu_torch.protocol.common.synod import (
    MAccept,
    MAccepted as SynodMAccepted,
    MChosen,
    Synod,
)
from fantoch_tpu_torch.protocol.common.table_clocks import (
    KeyClocks,
    QuorumClocks,
    VoteRange,
    Votes,
)
from fantoch_tpu_torch.protocol.gc import GCTrack
from fantoch_tpu_torch.protocol.partial import (
    MForwardSubmit,
    MShardAggregatedCommit,
    MShardCommit,
    PartialCommitMixin,
)
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
    worker_dot_index_shift,
    worker_index_no_shift,
)


# --- messages (newt.rs:1173-1233) ---


@dataclass
class MCollect:
    dot: Dot
    cmd: Command
    quorum: Set[ProcessId]
    clock: int
    coordinator_votes: Votes


@dataclass
class MCollectAck:
    dot: Dot
    clock: int
    process_votes: Votes


@dataclass
class MCommit:
    dot: Dot
    clock: int
    votes: Votes
    # True when the commit was decided by recovery consensus rather than
    # the coordinator's aggregation: the carried votes then lack the fast
    # quorum's consumed ranges, and each member re-broadcasts its held
    # copy commit-coupled (see _handle_mcommit) so vote frontiers heal
    # without ever overtaking the ops they stabilize
    recovered: bool = False
    # payload piggyback on recovery chosen-replies: a rejoined replica can
    # hold a buffered commit for a dot whose MCollect it missed while
    # down AND that was still in flight when the MSync records were cut —
    # without the payload here the prepare/chosen exchange loops
    # payload-less forever and the dot's (subtracted-from-backfill) votes
    # never fold (fuzzer-found rejoin stall)
    cmd: Optional[Command] = None


@dataclass
class MCommitClock:
    """Notify the clock-bump worker of a commit clock (newt.rs:660-676)."""

    clock: int


@dataclass
class MBump:
    """Cross-shard key-clock priming: a fast-quorum member of the target
    shard tells the closest process of every other shard the clock it
    acked, so that shard's keys chase the likely final timestamp with
    detached votes (newt.rs:1045-1060, handler :680-708)."""

    dot: Dot
    clock: int


@dataclass
class MDetached:
    detached: Votes


@dataclass
class MConsensus:
    dot: Dot
    ballot: int
    clock: int
    # payload piggyback on recovery rounds, so a recovered clock can commit
    # at processes the original MCollect broadcast never reached
    cmd: Optional[Command] = None


@dataclass
class MConsensusAck:
    dot: Dot
    ballot: int


# --- periodic events ---


@dataclass
class ClockBumpEvent:
    pass


@dataclass
class SendDetachedEvent:
    pass


class Status:
    START = "start"
    PAYLOAD = "payload"
    COLLECT = "collect"
    COMMIT = "commit"


def _recovery_proposal_gen(values):
    """Recovery clock selection over the ballot-0 reports of an n-f promise
    quorum (protocol/recovery.py; the reference's todo!() at
    newt.rs:1110-1112).  Reports are the clocks fast-quorum members
    proposed when acking the MCollect; 0 marks acceptors that never did.
    All-zero -> the dot is recovered as a committed noop (clock 0, nothing
    executes); otherwise the max reported clock — agreement alone is what
    per-key order needs, and survivors' detached votes fill their own
    frontiers up to any committed clock."""
    return max(values.values(), default=0)


def _subtract_pending(votes: Votes, pending: Dict[str, list], by: ProcessId) -> Votes:
    """Remove ``pending`` intervals (per key) from backfill ``votes``
    (each key holds contiguous [1, clock] ranges by ``by``) — the
    consumed-for-pending-dots exclusion of the rejoin backfill."""
    out = Votes()
    for key, key_votes in votes:
        holes = sorted(pending.get(key, ()))
        for vote in key_votes:
            cursor = vote.start
            for hole_start, hole_end in holes:
                if hole_end < cursor or hole_start > vote.end:
                    continue
                if hole_start > cursor:
                    out.add(key, VoteRange(by, cursor, hole_start - 1))
                cursor = max(cursor, hole_end + 1)
            if cursor <= vote.end:
                out.add(key, VoteRange(by, cursor, vote.end))
    return out


def _newt_info_factory(pid, _sid, cfg, fq, _wq) -> "NewtInfo":
    """Picklable per-dot info factory (the model checker pickles state)."""
    return NewtInfo(pid, cfg.n, cfg.f, fq)


class NewtInfo:
    """Per-dot lifecycle info (newt.rs:1117-1170)."""

    __slots__ = (
        "status", "quorum", "synod", "cmd", "votes", "quorum_clocks",
        "recovery_consumed",
    )

    def __init__(self, process_id: ProcessId, n: int, f: int, fast_quorum_size: int):
        self.status = Status.START
        self.quorum: Set[ProcessId] = set()
        self.synod: Synod[int] = Synod(process_id, n, f, _recovery_proposal_gen, 0)
        self.cmd: Optional[Command] = None
        # coordinator-side aggregation of fast-quorum votes
        self.votes = Votes()
        self.quorum_clocks = QuorumClocks(fast_quorum_size)
        # True once a recovery PROMISE consumed votes for this dot
        # (_recovery_promise_floor): those ranges exist nowhere else, so
        # the commit handler must re-broadcast the held votes
        # commit-coupled even when the commit was decided by the normal
        # (non-recovery) path racing the prepare
        self.recovery_consumed = False


# --- mutation self-test hook (the chaos fuzzer's) ---
# When True, every GC-straggler guard below is bypassed, reintroducing a
# latent bug: a late retransmit for a dot that already went stable
# and was GC'd resurrects a fresh START info via `_cmds.get`, and a later
# payload adoption can REPLAY the commit — double-adding the ops to the
# vote table (same-(clock,dot) collision, duplicate execution).  The
# chaos fuzzer's mutation self-test flips this to prove the
# auditor+fuzzer detect the real historical violation, not just
# synthetic ones.  Never set outside tests.
_GC_STRAGGLER_GUARD_DISABLED = False


def _set_gc_straggler_guard(enabled: bool) -> None:
    """Test hook: disable (enabled=False) or restore the GC-straggler
    guards.  Pair with try/finally — a leaked disable corrupts every
    subsequent Newt run in the process."""
    global _GC_STRAGGLER_GUARD_DISABLED
    _GC_STRAGGLER_GUARD_DISABLED = not enabled


# the clock-bump worker owns all key clocks under worker parallelism
# (newt.rs:1236 CLOCK_BUMP_WORKER_INDEX)
CLOCK_BUMP_WORKER_INDEX = 1

# cap on MBump clocks buffered before their MCollect arrives; comfortably
# above any realistic in-flight multi-shard window (bumps are hints, so
# eviction never affects correctness)
_MBUMP_BUFFER_CAP = 4096


class Newt(PartialCommitMixin, RecoveryMixin, SyncMixin, CommitGCMixin, Protocol):
    Executor = TableExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        fast_quorum_size, write_quorum_size, _ = config.newt_quorum_sizes()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        if config.batched_table_executor:
            from fantoch_tpu_torch.protocol.common.table_batched import BatchedKeyClocks

            self.key_clocks = BatchedKeyClocks(process_id, shard_id)
        else:
            self.key_clocks = KeyClocks(process_id, shard_id)
        self._cmds: CommandsInfo[NewtInfo] = CommandsInfo(
            process_id,
            shard_id,
            config,
            fast_quorum_size,
            write_quorum_size,
            _newt_info_factory,
        )
        self._gc_track = GCTrack(process_id, shard_id, config.n)
        self._to_processes: Deque[Action] = deque()
        self._to_executors: Deque[Any] = deque()
        # batched commit seam: committed rows and detached votes accumulate
        # as columns and drain as ONE TableVotesArrays per to_executors
        # sweep — no per-command TableVotes objects on the batched path.
        # Requires all of a process's table infos to reach one executor
        # (the runner disables it via set_commit_arrays when the executor
        # pool routes per key)
        self._commit_arrays: Optional[TableVotesArraysBuilder] = (
            TableVotesArraysBuilder() if config.batched_table_executor else None
        )
        # accumulated detached votes, flushed by SendDetachedEvent
        self._detached = Votes()
        # MBump clocks that arrived before the MCollect (newt.rs:45,699-708).
        # Bounded: a bump is a clock-priming *hint*, so evicting the oldest
        # entry is always safe — this caps the stale residue of bumps that
        # trail a GC'd commit (get_existing cannot distinguish "never seen"
        # from "GC'd", and no later message would ever pop such an entry)
        self._buffered_mbumps: Dict[Dot, int] = {}
        self._init_partial()
        self._init_recovery()
        # MCommit before MCollect (multiplexing reorders): buffer
        # (from, clock, merged votes, recovered)
        self._buffered_mcommits: Dict[Dot, Tuple[ProcessId, int, Votes, bool]] = {}
        # highest committed clock: the floor for real-time clock bumps
        # (traceical clocks can run ahead of a simulated wall clock)
        self._max_commit_clock = 0
        self._skip_fast_ack = config.skip_fast_ack and fast_quorum_size == 2
        # liveness requires flushing detached votes: proposals consume vote
        # ranges beyond a command's final clock, and if those never reach the
        # other replicas' vote tables, their frontiers stall below the gap
        # and stability stops advancing.  The reference leaves this implicit
        # (its test macro "always set newt_detached_send_interval",
        # fantoch_ps/src/protocol/mod.rs:65); we make it explicit.
        assert config.newt_detached_send_interval_ms is not None, (
            "Newt requires newt_detached_send_interval_ms: without it, "
            "detached votes are never sent and timestamp stability stalls"
        )

    def set_device(self, device) -> None:
        # the batched clocks build their resident table on this card
        if self.bp.config.batched_table_executor:
            self.key_clocks._device = device

    def periodic_events(self):
        events = list(self.gc_periodic_events())
        if self.bp.config.newt_clock_bump_interval_ms is not None:
            events.append((ClockBumpEvent(), self.bp.config.newt_clock_bump_interval_ms))
        if self.bp.config.newt_detached_send_interval_ms is not None:
            events.append(
                (SendDetachedEvent(), self.bp.config.newt_detached_send_interval_ms)
            )
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
        dot = self._handle_submit(dot, cmd, target_shard=True)
        # trace: dot assigned + payload owned at the coordinator
        self.bp.trace_span("payload", cmd.rifl, dot=dot)

    def submit_batch(self, pairs, time: SysTime) -> None:
        """Batched submit seam: one kernel-batched clock proposal covers
        every command (BatchedKeyClocks.proposal_batch), then the per-dot
        MCollect fan-out proceeds as usual.  Falls back to per-command
        submits when the clocks are not array-backed."""
        proposal_batch = getattr(self.key_clocks, "proposal_batch", None)
        if proposal_batch is None:
            for dot, cmd in pairs:
                self.submit(dot, cmd, time)
            return
        dots = [
            dot if dot is not None else self.bp.next_dot() for dot, _ in pairs
        ]
        cmds = [cmd for _, cmd in pairs]
        for dot, cmd in zip(dots, cmds):
            self.partial_submit_actions(dot, cmd, target_shard=True)
        results = proposal_batch(cmds, [0] * len(cmds))
        for dot, cmd, (clock, process_votes) in zip(dots, cmds, results):
            self._emit_mcollect(dot, cmd, clock, process_votes)
        if self.bp.tracer.enabled:
            for dot, cmd in zip(dots, cmds):
                self.bp.trace_span("payload", cmd.rifl, dot=dot)

    def handle(self, from_, from_shard_id, msg, time):
        if isinstance(msg, MCollect):
            self._handle_mcollect(
                from_, msg.dot, msg.cmd, msg.quorum, msg.clock, msg.coordinator_votes, time
            )
        elif isinstance(msg, MCollectAck):
            self._handle_mcollectack(from_, msg.dot, msg.clock, msg.process_votes)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(
                from_, msg.dot, msg.clock, msg.votes, msg.recovered,
                getattr(msg, "cmd", None), time,
            )
        elif isinstance(msg, MCommitClock):
            assert from_ == self.bp.process_id
            self._max_commit_clock = max(self._max_commit_clock, msg.clock)
        elif isinstance(msg, MDetached):
            self._handle_mdetached(msg.detached)
        elif isinstance(msg, MConsensus):
            self._handle_mconsensus(from_, msg.dot, msg.ballot, msg.clock, msg.cmd, time)
        elif isinstance(msg, MConsensusAck):
            self._handle_mconsensusack(from_, msg.dot, msg.ballot)
        elif isinstance(msg, MBump):
            self._handle_mbump(msg.dot, msg.clock)
        elif self.handle_recovery_message(from_, msg, time):
            pass
        elif self.handle_sync_message(from_, msg, time):
            pass
        elif self.handle_partial_message(from_, msg):
            pass
        elif not self.handle_gc_message(from_, msg):
            raise AssertionError(f"unknown message {msg}")

    def handle_event(self, event, time):
        if isinstance(event, GarbageCollectionEvent):
            self.handle_gc_event()
        elif isinstance(event, ClockBumpEvent):
            self._handle_event_clock_bump(time)
        elif isinstance(event, SendDetachedEvent):
            self._handle_event_send_detached()
        elif isinstance(event, RecoveryEvent):
            self.handle_recovery_event(time)
        else:
            raise AssertionError(f"unknown event {event}")

    def to_processes(self) -> Optional[Action]:
        return self._to_processes.popleft() if self._to_processes else None

    def to_executors(self):
        if self._commit_arrays is not None and len(self._commit_arrays):
            return self._commit_arrays.take()
        return self._to_executors.popleft() if self._to_executors else None

    def set_commit_arrays(self, enabled: bool) -> None:
        """Runner hook: the arrays commit seam assumes a single table
        executor consumes this process's infos; per-key executor pools
        must turn it off (falls back to per-command TableVotes)."""
        if enabled and self._commit_arrays is None:
            self._commit_arrays = TableVotesArraysBuilder()
        elif not enabled and self._commit_arrays is not None:
            # flush anything accumulated so no commit is lost
            pending = self._commit_arrays.take()
            if pending is not None:
                self._to_executors.append(pending)
            self._commit_arrays = None

    @classmethod
    def parallel(cls) -> bool:
        return KeyClocks.parallel()

    @classmethod
    def leaderless(cls) -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics()

    # --- handlers ---

    def _gc_straggler(self, dot: Dot) -> bool:
        """True when ``dot``'s commit already went stable-everywhere and
        was GC'd here, so the message is a straggler that must not
        resurrect a fresh info.  The mutation self-test
        bypasses this via the module flag to prove the fuzzer catches
        the historical commit-replay bug."""
        return (not _GC_STRAGGLER_GUARD_DISABLED) and self._gc_track.contains(dot)

    def _handle_submit(
        self, dot: Optional[Dot], cmd: Command, target_shard: bool
    ) -> Dot:
        dot = dot if dot is not None else self.bp.next_dot()
        self.partial_submit_actions(dot, cmd, target_shard)
        # propose: bump key clocks, consuming votes; those votes are either
        # shipped in the MCollect (skip_fast_ack: quorum members can commit
        # without the ack round) or kept for the MCollectAck aggregation
        clock, process_votes = self.key_clocks.proposal(cmd, 0)
        self._emit_mcollect(dot, cmd, clock, process_votes)
        return dot

    def _emit_mcollect(
        self, dot: Dot, cmd: Command, clock: int, process_votes: Votes
    ) -> None:
        if self._skip_fast_ack:
            coordinator_votes = process_votes
        else:
            info = self._cmds.get(dot)
            info.votes = process_votes
            coordinator_votes = Votes()
        mcollect = MCollect(dot, cmd, self.bp.fast_quorum(), clock, coordinator_votes)
        self._to_processes.append(ToSend(self.bp.all(), mcollect))

    def _handle_mcollect(self, from_, dot, cmd, quorum, remote_clock, votes, time) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status != Status.START:
            return
        self._recovery_track(dot, time)

        if self.bp.process_id not in quorum:
            # not in the fast quorum: store the payload only; pre-create the
            # key clocks so periodic bumps cover these keys too
            if self.bp.config.newt_clock_bump_interval_ms is not None:
                self.key_clocks.init_clocks(cmd)
            info.status = Status.PAYLOAD
            info.cmd = cmd
            buffered_bump = self._buffered_mbumps.pop(dot, None)
            if buffered_bump is not None:
                self.key_clocks.detached(cmd, buffered_bump, self._detached)
            self._replay_buffered_mcommit(dot)
            return

        message_from_self = from_ == self.bp.process_id
        if message_from_self:
            # votes already consumed at submit time; don't double-vote
            clock, process_votes = remote_clock, Votes()
        else:
            clock, process_votes = self.key_clocks.proposal(cmd, remote_clock)

        info.cmd = cmd
        if not info.synod.set_if_not_accepted(lambda: clock):
            # a recovery prepare already owns a higher ballot: our promise
            # forbids the ballot-0 ack.  The proposal above consumed votes
            # from our key clocks, though — hold them (plus any coordinator
            # votes the MCollect carried) with the dot; the commit handler
            # releases them commit-coupled so our vote frontier never gains
            # a gap and never advances ahead of the dot's ops either
            info.votes.merge(votes)
            info.votes.merge(process_votes)
            info.status = Status.PAYLOAD
            self._replay_buffered_mcommit(dot)
            return
        info.status = Status.COLLECT
        info.quorum = set(quorum)

        if not message_from_self and self._skip_fast_ack:
            # tiny-quorums shortcut (q=2): this quorum member holds both the
            # coordinator's votes and its own — commit directly.  Count the
            # fast path here: exactly one non-coordinator member exists, so
            # commands are counted once (the reference skips accounting on
            # this path entirely, newt.rs:451-462, leaving commit totals
            # unverifiable under skip_fast_ack).
            self.bp.fast_path(dot, cmd)
            votes.merge(process_votes)
            self._mcommit_actions(info, dot, clock, votes)
        else:
            if self._recovery_enabled():
                # keep a copy of the votes we ship: if the coordinator dies
                # with the ack in flight, these consumed ranges exist
                # nowhere else and the resulting gap in our own vote
                # frontier would stall timestamp stability forever — the
                # commit handler re-flushes them through the detached
                # channel (ranges dedup, so double delivery is harmless)
                info.votes.merge(copy.deepcopy(process_votes))
            self._to_processes.append(
                ToSend({from_}, MCollectAck(dot, clock, process_votes))
            )
            # prime the other shards' key clocks with the acked clock
            # (newt.rs:1045-1060): each acking member bumps the closest
            # process of every other shard the command touches
            for shard_id in cmd.shards():
                if shard_id != self.bp.shard_id:
                    self._to_processes.append(
                        ToSend({self.bp.closest_process(shard_id)}, MBump(dot, clock))
                    )
        # a buffered MBump from another shard can now generate detached
        # votes (newt.rs:434-440)
        buffered_bump = self._buffered_mbumps.pop(dot, None)
        if buffered_bump is not None:
            self.key_clocks.detached(cmd, buffered_bump, self._detached)
        # with recovery in play a commit can be decided without this
        # member's ack and thus arrive before its MCollect — replay it
        self._replay_buffered_mcommit(dot)

    def _replay_buffered_mcommit(self, dot: Dot) -> None:
        buffered = self._buffered_mcommits.pop(dot, None)
        if buffered is not None:
            buf_from, buf_clock, buf_votes, buf_recovered = buffered
            self._handle_mcommit(buf_from, dot, buf_clock, buf_votes, buf_recovered)

    def _handle_mcollectack(self, from_, dot, clock, remote_votes) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if info.status != Status.COLLECT:
            return
        if info.quorum_clocks.contains(from_):
            # duplicate ack (at-least-once delivery): counting it again
            # would double-count max_clock_count — an unsound fast path —
            # and a late duplicate after the quorum completed (slow path /
            # recovery join keep status COLLECT) would trip the size
            # assert.  Votes were merged on the first copy; ranges dedup
            # anyway, so dropping the whole message is safe
            return
        info.votes.merge(remote_votes)
        max_clock, max_count = info.quorum_clocks.add(from_, clock)

        # detached-bump optimization (newt.rs:506-521): raise our own key
        # clocks to the highest clock seen so far, so later proposals can't
        # undercut this command's likely final timestamp.  When the ack is
        # from self the votes would never ride an MCommit — skip.
        cmd = info.cmd
        assert cmd is not None
        if from_ != self.bp.process_id:
            self.key_clocks.detached(cmd, max_clock, self._detached)

        if not info.quorum_clocks.all():
            return
        if not info.synod.can_skip_prepare():
            # a recovery proposer owns a higher ballot: neither the
            # unilateral fast-path commit nor the first-ballot shortcut is
            # sound anymore — join recovery with a full prepare; the
            # aggregated votes stay in info.votes for the eventual commit
            prepare = info.synod.new_prepare()
            self._to_processes.append(
                ToSend(
                    self.bp.all(), MRecoveryPrepare(dot, prepare.ballot, info.cmd)
                )
            )
            return
        if max_count >= self.bp.config.f:
            self.bp.fast_path(dot, cmd)
            votes, info.votes = info.votes, Votes()
            self._mcommit_actions(info, dot, max_clock, votes)
        else:
            self.bp.slow_path(dot, cmd)
            ballot = info.synod.skip_prepare()
            self._to_processes.append(
                ToSend(self.bp.write_quorum(), MConsensus(dot, ballot, max_clock))
            )

    def _handle_mbump(self, dot: Dot, clock: int) -> None:
        """Another shard's acked clock: chase it with detached votes, or
        buffer (keeping the max) until the MCollect delivers the payload
        (newt.rs:680-708).

        get_existing, not get: a bump racing behind the commit (the bump is
        one hop, the commit path is four) must not resurrect a GC'd info —
        the reference's `cmds.get` here re-creates it and leaks.  A bump
        for a dot with no info either precedes the MCollect (buffer; the
        MCollect handler drains it) or trails the commit (the commit
        handler drops the buffered entry, see _handle_mcommit)."""
        info = self._cmds.get_existing(dot)
        if info is not None and info.cmd is not None:
            if info.status != Status.COMMIT:
                self.key_clocks.detached(info.cmd, clock, self._detached)
            return
        prev = self._buffered_mbumps.get(dot, 0)
        if prev == 0 and len(self._buffered_mbumps) >= _MBUMP_BUFFER_CAP:
            # evict the oldest entry (dict = insertion order): either a
            # stale post-GC straggler or, at worst, a lost priming hint
            self._buffered_mbumps.pop(next(iter(self._buffered_mbumps)))
        self._buffered_mbumps[dot] = max(prev, clock)

    def _mcommit_actions(
        self, info: NewtInfo, dot: Dot, clock: int, votes: Votes, recovered: bool = False
    ) -> None:
        """Single-shard: broadcast MCommit.  Multi-shard: clock-max shard
        aggregation; the Votes stay here and rejoin the final MCommit
        (newt.rs:1063-1093)."""
        cmd = info.cmd
        if cmd is None or not self.partial_mcommit_actions(dot, cmd, clock, local=votes):
            self._to_processes.append(
                ToSend(self.bp.all(), MCommit(dot, clock, votes, recovered))
            )

    # --- recovery hooks (protocol/recovery.py) ---

    def _adopt_recovered_payload(self, dot, info, cmd, time) -> None:
        info.cmd = cmd
        if info.status == Status.START:
            info.status = Status.PAYLOAD
            buffered_bump = self._buffered_mbumps.pop(dot, None)
            if buffered_bump is not None:
                self.key_clocks.detached(cmd, buffered_bump, self._detached)
            self._replay_buffered_mcommit(dot)

    def _recovery_commit_known(self, dot) -> bool:
        return dot in self._buffered_mcommits

    def _recovery_consensus_msg(self, dot, ballot, value, cmd):
        return MConsensus(dot, ballot, value, cmd)

    def _recovery_promise_floor(self, dot, info) -> int:
        # Tempo-style promise: CONSUME votes through clock+1 (a full
        # proposal) and hold them with the dot, reporting the consumed
        # clock as the floor.  A floor merely *sampled* from the key
        # clocks is only an upper bound at promise time — between the
        # promise and the recovery commit, other commands keep voting and
        # stability can pass the recovered timestamp, so the late commit
        # executes out of (clock, dot) order (divergence; the fuzzer's
        # restart+hold schedules hit exactly this).  Consuming instead
        # leaves a GAP in this acceptor's vote column that only the
        # commit-coupled release fills: any stability set intersects the
        # promise quorum (stability threshold + n-f > n), so no
        # timestamp at or below the recovered clock can stabilize before
        # the dot's ops arrive.  Held votes for a dot that recovers as a
        # noop flush detached (the noop commit branch), so nothing leaks.
        if info.cmd is None or info.status == Status.COMMIT:
            return 0
        clock, votes = self.key_clocks.proposal(info.cmd, 0)
        info.votes.merge(votes)
        info.recovery_consumed = True
        return clock

    def _recovery_adjust_value(self, dot, info, value, floor: int):
        # free-choice clocks lift to the quorum's max consumed floor: the
        # floor reporter consumed votes through it, so the lifted clock is
        # covered by held ranges (no +1 — a clock above the consumed
        # region would reopen the stability-overtakes-commit gap).  Equal-
        # clock ties with already-executed commands are safe because the
        # floor is a *consumed* clock+1 proposal, strictly above every
        # vote its reporter ever issued.  Noop (0) stays noop.
        if value == 0:
            return value
        return max(value, floor)

    def _recovery_chosen_reply(self, to, dot, info, value) -> None:
        # same single-shard guard as the late-MConsensus reply; recovered
        # so the receiver re-broadcasts any votes it still holds.  The
        # payload rides along: the asker may hold a payload-less
        # buffered commit (rejoin gap)
        if info.cmd is None or info.cmd.shard_count == 1:
            self._to_processes.append(
                ToSend(
                    {to},
                    MCommit(dot, value, info.votes, recovered=True, cmd=info.cmd),
                )
            )

    # --- rejoin sync hooks (protocol/sync.py) ---

    def _sync_record(self, dot, info):
        # clock 0 == recovered noop; the commit's quorum votes were
        # consumed into tables long ago, so the record carries none — the
        # backfill re-statement below supplies the frontier coverage
        return (dot, info.cmd, info.synod.value())

    def _apply_sync_record(self, from_, record, time) -> None:
        dot, cmd, clock = record
        if self._gc_track.contains(dot):
            return  # committed (and possibly executed + GC'd) here already
        info = self._cmds.get(dot)
        if info.status == Status.COMMIT:
            return
        if cmd is not None and info.cmd is None:
            self._adopt_recovered_payload(dot, info, cmd, time)
        # recovered=True: if we held consumed-but-unshipped votes for the
        # dot across the crash, the commit handler re-broadcasts them
        # commit-coupled so no peer's frontier keeps our gap
        self._handle_mcommit(from_, dot, clock, Votes(), recovered=True)

    def _sync_backfill_votes(self) -> Optional[Votes]:
        """Vote-frontier healing payload: our issued votes are exactly
        [1, clock] per key (see KeyClocks.backfill_votes), MINUS the
        ranges consumed for still-pending dots.  Those must only ever
        travel commit-coupled: a table that sees them detached before
        the dot's ops would let stability overtake the commit and
        execute around it (the order-divergence hazard the commit
        handler's held-vote discipline exists to prevent).  The pending
        copies the recovery plane keeps (``info.votes``) are exactly
        that exclusion set, so backfill requires recovery enabled."""
        if not self._recovery_enabled():
            return None
        votes = self.key_clocks.backfill_votes()
        if votes.is_empty():
            return None
        me = self.bp.process_id
        pending: Dict[str, list] = {}
        for _dot, info in self._cmds.items():
            if info.status == Status.COMMIT or info.votes.is_empty():
                continue
            for key, key_votes in info.votes:
                for vote in key_votes:
                    if vote.by == me:
                        pending.setdefault(key, []).append((vote.start, vote.end))
        if pending:
            votes = _subtract_pending(votes, pending, me)
        return None if votes.is_empty() else votes

    def _sync_backfill_payload(self):
        # the record-serving side: barrier-gated (MSyncBackfill) — the
        # pending subtraction covers OUR unfinished dots, but ranges we
        # consumed for commits the REQUESTER has not applied yet are only
        # safe once it has folded every streamed record in, and delivery
        # under fault plans can reorder a plain detached message ahead of
        # the record chunks (fuzzer-found restart order divergence)
        return self._sync_backfill_votes()

    def _apply_sync_backfill(self, from_, votes, time) -> None:
        self._handle_mdetached(votes)

    def _sync_backfill_blocked(self) -> bool:
        # a payload-less buffered commit here means some dot's ops are
        # still in flight to us: an incoming backfill can carry the
        # ranges its quorum consumed for exactly that dot, and applying
        # them first lets stability overtake the commit (fuzzer-found:
        # a rejoiner's column reached a live peer ahead of the peer's
        # lost-behind-retransmits MCollect)
        return bool(self._buffered_mcommits)

    def _sync_backfill_actions(self, targets) -> None:
        """The REJOINER's own frontier re-statement toward live peers —
        sent through the same gated MSyncBackfill envelope (records=0:
        there is no record stream in this direction, but the receiver's
        buffered-commit gate must still hold it while any of its
        in-flight commits could own the covered ranges)."""
        votes = self._sync_backfill_votes()
        if votes is not None:
            self._to_processes.append(
                ToSend(set(targets), MSyncBackfill(votes, 0))
            )

    # --- partial-replication adapters (clock max; newt.rs:825-895) ---

    def _partial_initial_data(self):
        return 0

    def _partial_join(self, acc, data):
        return max(acc, data)

    def _partial_final_mcommit(self, dot: Dot, data, local):
        return MCommit(dot, data, local if local is not None else Votes())

    def _handle_mcommit(
        self, from_, dot, clock, votes: Votes, recovered=False,
        cmd=None, time=None,
    ) -> None:
        if self._gc_straggler(dot):
            # straggler for a dot already committed-everywhere and GC'd
            # (late retransmit, held-vote re-broadcast, rejoin traffic):
            # `_cmds.get` would resurrect a fresh START info and a later
            # payload adoption could REPLAY the commit — double-adding
            # the ops to the table.  The ops executed long ago; only the
            # carried vote ranges still matter (fold them detached)
            if not votes.is_empty():
                if self._commit_arrays is not None:
                    for key, key_votes in votes:
                        self._commit_arrays.add_detached(key, key_votes)
                else:
                    for key, key_votes in votes:
                        self._to_executors.append(TableDetachedVotes(key, key_votes))
            return
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None and info.status == Status.START:
            # recovery chosen-reply piggyback: adopt so the commit below
            # proceeds instead of buffering payload-less
            self._adopt_recovered_payload(dot, info, cmd, time)
        if info.status == Status.COMMIT:
            # duplicate commit — typically a member re-broadcasting its
            # held votes after a recovered commit: the ops are already in
            # our table, so the ranges can join it directly
            if not votes.is_empty():
                if self._commit_arrays is not None:
                    for key, key_votes in votes:
                        self._commit_arrays.add_detached(key, key_votes)
                else:
                    for key, key_votes in votes:
                        self._to_executors.append(
                            TableDetachedVotes(key, key_votes)
                        )
            return
        if clock == 0:
            # recovered noop (the dot never got a clock proposal anywhere
            # the promise quorum could see): nothing executes and nothing
            # stabilizes — settle the synod and stop recovery.  Votes held
            # for a noop dot couple to no ops, so they flush as detached —
            # including the CARRIED votes: the recovery proposer's own
            # held ranges (promise-consumed, or shipped-ack copies) ride
            # the MCommit broadcast, and dropping them here would leave a
            # permanent hole in that process's vote column at every
            # receiver (frontiers stall below it forever)
            info.status = Status.COMMIT
            # audit plane: a noop commit executes nothing — rifl None
            self.bp.audit_commit(dot, None, 0)
            self._buffered_mbumps.pop(dot, None)
            if not votes.is_empty():
                self._detached.merge(votes)
            if not info.votes.is_empty():
                held, info.votes = info.votes, Votes()
                self._detached.merge(held)
            out = info.synod.handle(from_, MChosen(clock))
            assert out is None
            self._recovery_untrack(dot)
            if self._gc_running() and self._dot_in_my_shard(dot):
                self._to_processes.append(ToForward(MCommitDot(dot)))
            else:
                self._cmds.gc_single(dot)
            return
        if info.status == Status.START:
            buffered = self._buffered_mcommits.get(dot)
            if buffered is not None:
                # merge (not overwrite): a recovered commit and a member's
                # held-vote re-broadcast may both arrive pre-payload
                _bf, _bc, buf_votes, buf_rec = buffered
                votes.merge(buf_votes)
                recovered = recovered or buf_rec
            self._buffered_mcommits[dot] = (from_, clock, votes, recovered)
            if time is not None:
                # track for recovery: if the MCollect never comes (it was
                # broadcast while this replica was down and the commit
                # missed the rejoin records), only the recovery
                # chosen-reply exchange can fetch the payload
                self._recovery_track(dot, time)
            return

        cmd = info.cmd
        assert cmd is not None, "there should be a command payload"
        if not info.votes.is_empty():
            # votes this process consumed for the dot (shipped toward a
            # possibly-dead coordinator, or held on the no-ack/interrupted
            # paths).  They may exist nowhere else, and they must reach
            # every table *with* the dot's ops — releasing them detached
            # would let stability overtake the commit on slower replicas.
            # So: join them to the local table add below, and when the
            # commit was recovery-decided (its votes lack the quorum's
            # consumed ranges) — or a recovery PROMISE consumed ranges
            # here that no aggregation ever saw — re-broadcast them
            # commit-coupled; receivers fold them in post-ops via the
            # duplicate-commit branch above
            held, info.votes = info.votes, Votes()
            if recovered or info.recovery_consumed:
                self._to_processes.append(
                    ToSend(
                        self.bp.all_but_me(),
                        MCommit(dot, clock, copy.deepcopy(held), recovered=True),
                    )
                )
            votes.merge(held)
        if self._commit_arrays is not None:
            # batched commit seam: rows go out as columns, not objects
            for key, ops in cmd.iter_ops(self.bp.shard_id):
                self._commit_arrays.add_row(
                    dot, clock, cmd.rifl, key, ops, votes.remove(key)
                )
        else:
            for key, ops in cmd.iter_ops(self.bp.shard_id):
                key_votes = votes.remove(key)
                self._to_executors.append(
                    TableVotes(dot, clock, cmd.rifl, key, ops, key_votes)
                )

        info.status = Status.COMMIT
        # audit plane: timestamp-order agreement = same dot, same clock
        self.bp.audit_commit(dot, cmd.rifl, clock)
        self.bp.trace_span(
            "commit", cmd.rifl, dot=dot,
            meta={"recovered": True} if recovered else None,
        )
        # a bump buffered between our commit and its own delivery is moot
        # (detached votes already cover the commit clock); one trailing the
        # GC'd commit ages out of the bounded buffer instead
        self._buffered_mbumps.pop(dot, None)
        out = info.synod.handle(from_, MChosen(clock))
        assert out is None
        self._recovery_untrack(dot)

        if self.bp.config.newt_clock_bump_interval_ms is not None:
            # real-time mode: the clock-bump worker generates detached votes
            # periodically; just teach it the commit clock
            self._to_processes.append(ToForward(MCommitClock(clock)))
        else:
            self.key_clocks.detached(cmd, clock, self._detached)

        if self._gc_running() and self._dot_in_my_shard(dot):
            self._to_processes.append(ToForward(MCommitDot(dot)))
        else:
            self._cmds.gc_single(dot)

    def _handle_mdetached(self, detached: Votes) -> None:
        if self._commit_arrays is not None:
            for key, key_votes in detached:
                self._commit_arrays.add_detached(key, key_votes)
            return
        for key, key_votes in detached:
            self._to_executors.append(TableDetachedVotes(key, key_votes))

    def _handle_mconsensus(self, from_, dot, ballot, clock, cmd=None, time=None) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None:
            self._adopt_recovered_payload(dot, info, cmd, time)
        out = info.synod.handle(from_, MAccept(ballot, clock))
        if out is None:
            return
        if isinstance(out, SynodMAccepted):
            self._to_processes.append(ToSend({from_}, MConsensusAck(dot, out.ballot)))
        elif isinstance(out, MChosen):
            # already chosen: answer with a commit carrying our local votes
            # (a recovery proposer re-running consensus against
            # already-chosen acceptors lands here).  Multi-shard commands
            # must not: the local clock lacks the cross-shard max, which
            # only travels via MShardAggregatedCommit
            if info.cmd is None or info.cmd.shard_count == 1:
                self._to_processes.append(
                    ToSend(
                        {from_},
                        MCommit(
                            dot, out.value, info.votes,
                            recovered=True, cmd=info.cmd,
                        ),
                    )
                )
        else:
            raise AssertionError(f"unexpected synod output {out}")

    def _handle_mconsensusack(self, from_, dot, ballot) -> None:
        if self._gc_straggler(dot):
            return  # straggler for a GC'd dot: do not resurrect its info
        info = self._cmds.get(dot)
        out = info.synod.handle(from_, SynodMAccepted(ballot))
        if out is None:
            return
        assert isinstance(out, MChosen), f"unexpected synod output {out}"
        votes, info.votes = info.votes, Votes()
        # first-round slow-path ballots are process ids (<= n); anything
        # above means this choice came from recovery prepare/promise and
        # the commit must carry the recovered flag (vote re-broadcasts)
        recovered = info.synod.current_ballot() > self.bp.config.n
        self._mcommit_actions(info, dot, out.value, votes, recovered)

    # --- periodic events ---

    def _handle_event_clock_bump(self, time: SysTime) -> None:
        # vote every key up to max(highest committed clock, now): stability
        # then tracks real time even for idle keys (newt.rs:983-1006; micros
        # because millis lack precision at high client counts)
        min_clock = max(self._max_commit_clock, time.micros())
        self.key_clocks.detached_all(min_clock, self._detached)

    def _handle_event_send_detached(self) -> None:
        if not self._detached.is_empty():
            detached, self._detached = self._detached, Votes()
            self._to_processes.append(ToSend(self.bp.all(), MDetached(detached)))
        # held rejoin backfills re-check on this cadence: the
        # buffered-commit gate clears as in-flight commits resolve, and
        # no single message reliably anchors that release
        self._sync_release_backfills(None)

    def _dot_in_my_shard(self, dot: Dot) -> bool:
        return dot.target_shard(self.bp.config.n) == self.bp.shard_id

    # --- worker routing (newt.rs:1236-1284) ---

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
                MBump,
                MShardCommit,
                MShardAggregatedCommit,
                MRecoveryPrepare,
                MRecoveryPromise,
            ),
        ):
            return worker_dot_index_shift(msg.dot)
        if isinstance(msg, MCommitClock):
            return worker_index_no_shift(CLOCK_BUMP_WORKER_INDEX)
        if isinstance(msg, MDetached):
            # any worker may feed detached votes to the executors
            return worker_index_no_shift(0)
        if isinstance(msg, (MSync, MSyncReply, MSyncBackfill)):
            # dotless rejoin traffic: serialized on the GC worker (whose
            # committed clock it reads and whose retention it rides)
            return worker_index_no_shift(0)
        gc_index = CommitGCMixin.gc_message_index(msg)
        if gc_index is not None:
            return gc_index[0]
        raise AssertionError(f"unknown message {msg}")

    @staticmethod
    def event_index(event):
        if isinstance(event, (ClockBumpEvent, SendDetachedEvent)):
            return worker_index_no_shift(CLOCK_BUMP_WORKER_INDEX)
        return CommitGCMixin.event_index(event)
