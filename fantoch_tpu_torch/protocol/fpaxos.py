"""FPaxos: leader-based Flexible Paxos over the MultiSynod agents.

Reference: fantoch_ps/src/protocol/fpaxos.rs.  Clients submit anywhere;
non-leaders forward to the leader, which allocates (ballot, slot) pairs and
drives phase-2 through per-slot commanders (spawned via a self-forward so
they can run slot-sharded across workers); acceptors sit at a fixed worker.
Chosen commands broadcast as MChosen and execute in slot order.  GC is
slot-watermark based — no MStable round: the acceptor worker both tracks
watermarks and holds the slots to collect (fpaxos.rs:419-447).

Leader failover (beyond the reference, whose acceptor carries a todo!()
for it at multi.rs:97-99): with ``Config.fpaxos_leader_timeout_ms`` set,
the leader heartbeats every quarter-timeout and followers watch for
silence — the ring successor suspects first (one timeout), the next one a
timeout later, and so on, so elections are staggered and deterministic.
A candidate runs MultiSynod prepare/promise over the accepted-slot maps of
an n-f quorum, carries every possibly-chosen value forward through fresh
commanders at its ballot, resumes allocation above every slot seen, and
announces itself via the heartbeat.  Followers re-forward their pending
(not-yet-chosen) submissions to the new leader, which dedups by rifl.
The run layer's heartbeat failure detector feeds ``on_peer_down`` so a
TCP cluster elects as soon as the detector fires rather than waiting out
the protocol timeout.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Set

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, Rifl, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.slot import SlotExecutionInfo, SlotExecutor
from fantoch_tpu_torch.protocol.base import (
    Action,
    BaseProcess,
    Protocol,
    ProtocolMetrics,
    ToForward,
    ToSend,
)
from fantoch_tpu_torch.protocol.common.multi_synod import (
    MAccept as SynodMAccept,
    MAccepted as SynodMAccepted,
    MChosen as SynodMChosen,
    MForwardSubmit as SynodMForwardSubmit,
    MPrepare as SynodMPrepare,
    MSpawnCommander as SynodMSpawnCommander,
    MultiSynod,
    SlotGCTrack,
)
from fantoch_tpu_torch.protocol.sync import MSlotSync, MSlotSyncReply, SlotSyncMixin
from fantoch_tpu_torch.run.routing import (
    LEADER_WORKER_INDEX,
    worker_index_no_shift,
    worker_index_shift,
)

# the acceptor owns ballot/accepted state and must be a single worker
# (fpaxos.rs:417)
ACCEPTOR_WORKER_INDEX = 1


# --- messages (fpaxos.rs:389-414) ---


@dataclass
class MForwardSubmit:
    cmd: Command


@dataclass
class MSpawnCommander:
    ballot: int
    slot: int
    cmd: Command


@dataclass
class MAccept:
    ballot: int
    slot: int
    cmd: Command


@dataclass
class MAccepted:
    ballot: int
    slot: int


@dataclass
class MChosen:
    slot: int
    cmd: Command


@dataclass
class MGarbageCollection:
    committed: int


@dataclass
class MPrepare:
    """Leader-election phase 1 (candidate ballot)."""

    ballot: int


@dataclass
class MPromise:
    """Phase-1 answer: the acceptor's accepted-slot map (slot -> (ballot,
    cmd)) for value carry-forward."""

    ballot: int
    accepted: Dict[int, tuple]


@dataclass
class MLeaderHeartbeat:
    """Periodic leadership announcement; also how a freshly-elected leader
    tells followers where to (re-)forward."""

    ballot: int


@dataclass
class GarbageCollectionEvent:
    pass


@dataclass
class LeaderCheckEvent:
    """Periodic failover tick: the leader heartbeats, followers judge
    silence (interval = fpaxos_leader_timeout_ms // 4)."""


class FPaxos(SlotSyncMixin, Protocol):
    Executor = SlotExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        # no fast quorum — there are no fast paths
        self.bp = BaseProcess(process_id, shard_id, config, 0, config.fpaxos_quorum_size())
        initial_leader = config.leader
        assert initial_leader is not None, (
            "in a leader-based protocol, the initial leader should be defined"
        )
        self._leader = initial_leader
        # ballot backing the current leadership belief (heartbeats carry
        # it; higher ballot wins)
        self._leader_ballot = initial_leader
        self._multi_synod: MultiSynod[Command] = MultiSynod(
            process_id, initial_leader, config.n, config.f
        )
        self._gc_track = SlotGCTrack(process_id, config.n)
        self._to_processes: Deque[Action] = deque()
        self._to_executors: Deque[SlotExecutionInfo] = deque()
        # failover state
        self._failover = config.fpaxos_leader_timeout_ms is not None
        if self._failover:
            # the acceptor must retain accepted slots until globally stable
            # (the gc-track path); gc_single-at-choose would let a new
            # leader resume allocation below a chosen slot it cannot see
            assert config.gc_interval_ms is not None, (
                "fpaxos_leader_timeout_ms requires gc_interval_ms: leader "
                "failover carries values forward from acceptor state, which "
                "must be retained until slots are globally stable"
            )
        # last virtual ms any message arrived from the current leader
        self._leader_heard: Optional[int] = None
        # elections started here (tracer counters are running totals)
        self._elections = 0
        # submissions forwarded but not yet chosen: re-forwarded on leader
        # change (Rifl -> Command); the leader dedups re-forwards below
        self._pending_forwards: Dict[Rifl, Command] = {}
        # rifls this process knows are allocated-or-chosen — the dedup set
        # that keeps a re-forward from executing a command twice.  Bounded
        # by the same stability horizon as the acceptor maps (pruning in
        # _handle_mgc keeps only the un-stable tail)
        self._seen_rifls: Set[Rifl] = set()
        self._rifl_slot: Dict[Rifl, int] = {}
        # chosen log: slot -> command for every chosen slot not yet
        # globally stable.  Doubles as (a) the re-chosen/duplicate dedup
        # set at takeover and under at-least-once delivery, and (b) the
        # retained record stream a rejoining replica pulls via MSlotSync
        # (retention argument: the dead replica's GC watermark froze, so
        # stability — and this log's pruning — stalled at its last
        # report).  Pruned by GC at the stability-minus-window horizon
        self._chosen_slots: Dict[int, Command] = {}
        # last virtual ms pending forwards were (re-)sent: lost forwards
        # (message loss; a leader crash-restart window with no election)
        # retry on a timeout cadence — the leader's rifl dedup makes
        # re-forwards exactly-once
        self._last_reforward_ms: Optional[int] = None
        # last virtual ms the leader re-drove its in-flight accept
        # rounds: an MAccept toward a crash-RESTARTING write-quorum
        # member evaporates during the downtime (no detector fires for a
        # restarting peer), and nothing else retries phase 2 — the slot,
        # and everything ordered after it, would stall forever
        # (fuzzer-found follower crash-restart stall)
        self._last_redrive_ms: Optional[int] = None
        # peers the run layer's failure detector declared dead
        self._down: Set[ProcessId] = set()

    def periodic_events(self):
        events = []
        if self.bp.config.gc_interval_ms is not None:
            events.append((GarbageCollectionEvent(), self.bp.config.gc_interval_ms))
        if self._failover:
            interval = max(1, self.bp.config.fpaxos_leader_timeout_ms // 4)
            events.append((LeaderCheckEvent(), interval))
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
        self._handle_submit(cmd)

    def handle(self, from_, from_shard_id, msg, time):
        if self._failover and from_ == self._leader and from_ != self.id:
            self._leader_heard = time.millis()
        if isinstance(msg, MForwardSubmit):
            self._handle_submit(msg.cmd)
        elif isinstance(msg, MSpawnCommander):
            self._handle_mspawn_commander(from_, msg.ballot, msg.slot, msg.cmd)
        elif isinstance(msg, MAccept):
            self._handle_maccept(from_, msg.ballot, msg.slot, msg.cmd)
        elif isinstance(msg, MAccepted):
            self._handle_maccepted(from_, msg.ballot, msg.slot)
        elif isinstance(msg, MChosen):
            self._handle_mchosen(msg.slot, msg.cmd)
        elif isinstance(msg, MGarbageCollection):
            self._handle_mgc(from_, msg.committed)
        elif isinstance(msg, MPrepare):
            self._handle_mprepare(from_, msg.ballot)
        elif isinstance(msg, MPromise):
            self._handle_mpromise(from_, msg.ballot, msg.accepted, time)
        elif isinstance(msg, MLeaderHeartbeat):
            self._handle_leader_heartbeat(from_, msg.ballot, time)
        elif self.handle_slot_sync_message(from_, msg, time):
            pass
        else:
            raise AssertionError(f"unknown message {msg}")

    def handle_event(self, event, time):
        if isinstance(event, LeaderCheckEvent):
            self._handle_leader_check(time)
            return
        assert isinstance(event, GarbageCollectionEvent)
        self._to_processes.append(
            ToSend(self.bp.all_but_me(), MGarbageCollection(self._gc_track.committed()))
        )

    def to_processes(self) -> Optional[Action]:
        return self._to_processes.popleft() if self._to_processes else None

    def to_executors(self):
        return self._to_executors.popleft() if self._to_executors else None

    @classmethod
    def parallel(cls) -> bool:
        return True

    @classmethod
    def leaderless(cls) -> bool:
        return False

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics()

    # --- handlers ---

    def _handle_submit(self, cmd: Command) -> None:
        if self._multi_synod.is_leader and cmd.rifl in self._seen_rifls:
            # already allocated (carried forward) or chosen: a follower's
            # post-failover re-forward OR a plain duplicated
            # MForwardSubmit delivery (at-least-once links) — allocating
            # a second slot would execute the command twice (fuzzer-found
            # without failover), so the rifl dedup always runs
            return
        out = self._multi_synod.submit(cmd)
        if isinstance(out, SynodMSpawnCommander):
            # we're the leader: spawn the commander via a self-forward so it
            # can land on a slot-sharded worker
            # trace: the leader allocating the slot is the dotless analog
            # of the coordinator's payload stage
            if self.bp.tracer.enabled:
                self.bp.trace_span("payload", cmd.rifl, meta={"slot": out.slot})
            self._register_allocation(out.value.rifl, out.slot)
            self._to_processes.append(
                ToForward(MSpawnCommander(out.ballot, out.slot, out.value))
            )
        elif isinstance(out, SynodMForwardSubmit):
            if self._failover:
                self._pending_forwards[cmd.rifl] = cmd
            self._to_processes.append(ToSend({self._leader}, MForwardSubmit(out.value)))
        else:
            raise AssertionError(f"can't handle {out} in submit")

    # without GC, the delivery-dedup sets are pruned to this many recent
    # slots (with GC, global stability prunes them exactly)
    _DEDUP_WINDOW = 4096

    def _prune_dedup_window(self) -> None:
        if len(self._chosen_slots) <= 2 * self._DEDUP_WINDOW:
            return
        floor = max(self._chosen_slots) - self._DEDUP_WINDOW
        self._chosen_slots = {
            s: cmd for s, cmd in self._chosen_slots.items() if s > floor
        }
        for rifl, slot in list(self._rifl_slot.items()):
            if slot <= floor:
                self._rifl_slot.pop(rifl, None)
                self._seen_rifls.discard(rifl)

    def _register_allocation(self, rifl: Rifl, slot: int) -> None:
        self._seen_rifls.add(rifl)
        self._rifl_slot[rifl] = slot

    def _handle_mspawn_commander(self, from_, ballot, slot, cmd) -> None:
        assert from_ == self.id, "spawn commander messages come from self"
        out = self._multi_synod.handle(from_, SynodMSpawnCommander(ballot, slot, cmd))
        assert isinstance(out, SynodMAccept)
        # steady state accepts go to the write quorum; a post-takeover
        # leader (ballot > n: initial-leader ballots are process ids) or a
        # known-dead quorum member means the quorum was sized for the
        # failure-free path and may contain dead processes — broadcast
        # then (still only f+1 accepts needed), without paying the n-fold
        # amplification on every failure-free command
        targets = self.bp.write_quorum()
        if self._failover and (ballot > self.bp.config.n or self._down & targets):
            targets = self.bp.all()
        self._to_processes.append(
            ToSend(targets, MAccept(out.ballot, out.slot, out.value))
        )

    def _handle_maccept(self, from_, ballot, slot, cmd) -> None:
        out = self._multi_synod.handle(from_, SynodMAccept(ballot, slot, cmd))
        if out is None:
            return  # ballot too low: this leader was superseded
        assert isinstance(out, SynodMAccepted)
        self._to_processes.append(ToSend({from_}, MAccepted(out.ballot, out.slot)))

    def _handle_maccepted(self, from_, ballot, slot) -> None:
        out = self._multi_synod.handle(from_, SynodMAccepted(ballot, slot))
        if out is None:
            return
        assert isinstance(out, SynodMChosen)
        self._to_processes.append(ToSend(self.bp.all(), MChosen(out.slot, out.value)))

    def _handle_mchosen(self, slot: int, cmd: Command) -> None:
        # exactly-once per slot under at-least-once delivery: a duplicated
        # MChosen (the sim's duplication nemesis; a resend tail in the run
        # layer) must not reach the executor twice — the takeover
        # carry-forward dedup doubles as the delivery dedup, so it runs
        # with or without failover (fuzzer-found: a duplicated MChosen
        # without failover tripped the slot executor's exactly-once
        # assert).  Pruned by GC at the global stability horizon; a
        # duplicate trailing even THAT is caught by the stable floor (the
        # GC-straggler guard: its slot executed everywhere long ago)
        if slot in self._chosen_slots or slot <= self._gc_track.stable_floor:
            return
        self._chosen_slots[slot] = cmd
        if self.bp.config.gc_interval_ms is None:
            # without GC nothing ever prunes the dedup state — keep a
            # bounded recent-slot window instead of growing forever (a
            # duplicate older than the window is ancient history; the
            # slot executor's next_slot floor also rejects it)
            self._prune_dedup_window()
        if self._failover:
            self._seen_rifls.add(cmd.rifl)
            self._pending_forwards.pop(cmd.rifl, None)
        if self.bp.tracer.enabled:
            self.bp.trace_span("commit", cmd.rifl, meta={"slot": slot})
        # audit plane: slot-order agreement = same slot, same command
        self.bp.audit_commit(slot, cmd.rifl, None)
        self._to_executors.append(SlotExecutionInfo(slot, cmd))
        if self.bp.config.gc_interval_ms is not None:
            self._gc_track.commit(slot)
        else:
            self._multi_synod.gc_single(slot)

    def _handle_mgc(self, from_: ProcessId, committed: int) -> None:
        self._gc_track.committed_by(from_, committed)
        start, end = self._gc_track.stable()
        if start <= end:
            self.bp.stable(self._multi_synod.gc(start, end))
            # stable slots can never be re-proposed (no acceptor still
            # holds them): prune the exactly-once bookkeeping — which now
            # runs with or without failover (delivery dedup).  Pruning
            # LAGS stability by the dedup window: a late duplicate of an
            # already-stable MChosen is caught by the stable floor, but a
            # late duplicate MForwardSubmit carries only a rifl — with
            # its entry pruned exactly at stability, the leader would
            # allocate a SECOND slot for an executed command
            # (fuzzer-found duplicate execution)
            cut = end - self._DEDUP_WINDOW
            self._chosen_slots = {
                s: cmd for s, cmd in self._chosen_slots.items() if s > cut
            }
            for rifl, slot in list(self._rifl_slot.items()):
                if slot <= cut:
                    self._rifl_slot.pop(rifl, None)
                    self._seen_rifls.discard(rifl)

    # --- rejoin catch-up (protocol/sync.py SlotSyncMixin) ---

    def rejoin(self, time: SysTime) -> None:
        """Restart hook: pull the chosen slots this replica missed while
        down, and restart the leader-silence clock (the restored
        ``_leader_heard`` is a pre-crash timestamp — judging the current
        leader by it would fire a spurious election on the first tick)."""
        if self._failover:
            self._leader_heard = time.millis()
            self._last_reforward_ms = time.millis()
        SlotSyncMixin.rejoin(self, time)

    def _slot_sync_floor(self) -> int:
        return self._gc_track.committed()

    def _slot_sync_records(self, floor: int):
        # sorted: chunk contents are a pure function of protocol state,
        # so same-seed traces stay identical
        return sorted(
            (slot, cmd)
            for slot, cmd in self._chosen_slots.items()
            if slot > floor
        )

    def _apply_slot_sync_record(self, from_: ProcessId, record, time: SysTime) -> None:
        slot, cmd = record
        # the normal chosen path: chosen-slot dedup + the stable floor
        # make overlapping peer replies exactly-once
        self._handle_mchosen(slot, cmd)

    def note_durable_chosen(self, records) -> None:
        """Restart-replay hook (run/wal.py): fold WAL-tail ``(slot, cmd)``
        records into the chosen log + committed watermark so the rejoin
        MSlotSync floor covers them — peers must not re-stream slots whose
        effects the executor tail replay already applied."""
        for slot, cmd in records:
            if slot in self._chosen_slots or slot <= self._gc_track.stable_floor:
                continue
            self._chosen_slots[slot] = cmd
            self._gc_track.commit(slot)
            if self._failover:
                self._seen_rifls.add(cmd.rifl)
                self._rifl_slot[cmd.rifl] = slot

    # --- leader failover ---

    def _ring_distance(self, candidate: ProcessId) -> int:
        return (candidate - self._leader) % self.bp.config.n

    def _handle_leader_check(self, time: SysTime) -> None:
        now = time.millis()
        if self._leader == self.id:
            if self._multi_synod.is_leader:
                self._to_processes.append(
                    ToSend(
                        self.bp.all_but_me(), MLeaderHeartbeat(self._leader_ballot)
                    )
                )
                # re-drive accept rounds stuck past a timeout: the
                # original fan-out may have been lost to a write-quorum
                # member's crash-restart window (frames to a down process
                # evaporate; a RESTARTING peer never trips the failure
                # detector, so on_peer_down's re-drive cannot cover this).
                # Broadcast is idempotent: acceptors re-accepting the same
                # (ballot, slot, value) are no-ops and the chosen-slot
                # dedup swallows re-chosen duplicates
                inflight = self._multi_synod.inflight()
                if inflight:
                    if self._last_redrive_ms is None:
                        self._last_redrive_ms = now
                    elif (
                        now - self._last_redrive_ms
                        >= self.bp.config.fpaxos_leader_timeout_ms
                    ):
                        self._last_redrive_ms = now
                        for ballot, slot, cmd in inflight:
                            self._to_processes.append(
                                ToSend(self.bp.all(), MAccept(ballot, slot, cmd))
                            )
                else:
                    self._last_redrive_ms = None
            return
        # pending-forward retry: a forward toward the leader can be lost
        # (message loss; a leader that crash-restarted inside the timeout
        # window — no election, so no heartbeat-change re-forward fires).
        # Retry on a timeout cadence; the leader's unconditional rifl
        # dedup makes re-forwards exactly-once, and dedup entries are
        # retained until global stability (which cannot pass a slot this
        # follower never saw chosen)
        if self._pending_forwards:
            if self._last_reforward_ms is None:
                self._last_reforward_ms = now
            elif now - self._last_reforward_ms >= self.bp.config.fpaxos_leader_timeout_ms:
                self._last_reforward_ms = now
                for cmd in self._pending_forwards.values():
                    self._to_processes.append(
                        ToSend({self._leader}, MForwardSubmit(cmd))
                    )
        else:
            self._last_reforward_ms = None
        if self._leader_heard is None:
            self._leader_heard = now  # start the clock at the first tick
            return
        # staggered suspicion: the ring successor campaigns after one
        # timeout, the next after two, ... — deterministic, collision-free
        timeout = self.bp.config.fpaxos_leader_timeout_ms
        wait = timeout * max(1, self._ring_distance(self.id))
        if now - self._leader_heard >= wait:
            self._leader_heard = now  # re-campaign only after another wait
            self._start_election()

    def _start_election(self) -> None:
        prepare = self._multi_synod.new_prepare()
        # trace: leader failover is the recovery trigger of the
        # leader-based world (a counter, not a span — no single dot
        # heals); counters are running totals, last observation wins
        self._elections += 1
        if self.bp.tracer.enabled:
            self.bp.tracer.counter(
                "fpaxos_elections", self._elections, pid=self.id,
                meta={"ballot": prepare.ballot},
            )
        # broadcast (self included: our own acceptor's promise counts)
        self._to_processes.append(ToSend(self.bp.all(), MPrepare(prepare.ballot)))

    def _handle_mprepare(self, from_: ProcessId, ballot: int) -> None:
        out = self._multi_synod.handle(from_, SynodMPrepare(ballot))
        if out is not None:
            self._to_processes.append(
                ToSend({from_}, MPromise(out.ballot, out.accepted))
            )

    def _handle_mpromise(self, from_: ProcessId, ballot: int, accepted, time) -> None:
        carry = self._multi_synod.handle_promise(from_, ballot, accepted)
        if carry is None:
            return
        # won the election: adopt leadership, resume allocation above the
        # chosen/stable horizon — the carry map covers accepted-but-
        # unstable slots only, and once GC pruned the acceptor maps a
        # winner trusting it alone re-allocates STABLE slots, whose
        # re-chosen events every stable-floor guard drops (the command is
        # lost, its client hangs; found by the FPaxos leader-kill WAL
        # restart row).  Any chosen-but-unstable slot is in some
        # promiser's accepted map (quorum intersection), and any stable
        # slot is at or below our own committed frontier (stability is a
        # min that includes us), so the max of the two is a sound floor
        self._multi_synod.resume_above(
            max(self._gc_track.committed(), max(self._chosen_slots, default=0))
        )
        # then re-propose every possibly-chosen slot at our ballot,
        # re-submit our own pending forwards, and announce
        self._leader = self.id
        self._leader_ballot = ballot
        for slot, cmd in carry.items():
            if slot in self._chosen_slots:
                continue  # already decided and known here
            self._register_allocation(cmd.rifl, slot)
            self._pending_forwards.pop(cmd.rifl, None)
            self._to_processes.append(ToForward(MSpawnCommander(ballot, slot, cmd)))
        pending, self._pending_forwards = self._pending_forwards, {}
        for cmd in pending.values():
            slot = self._rifl_slot.get(cmd.rifl)
            if slot is not None:
                # a stale own allocation from a superseded leadership
                # (pre-crash commander whose accept landed nowhere): the
                # dedup entry must clear or the re-submission below is
                # dropped and the command lost.  Stale means the slot is
                # occupied by NOBODY in the n-f promise view (unchosen —
                # it would have appeared in the carry map) OR by a
                # DIFFERENT command (an intervening leader reused the
                # slot number); only a same-rifl occupant proves our
                # allocation survived and the dedup should hold
                occupant = carry.get(slot)
                if occupant is None:
                    occupant = self._chosen_slots.get(slot)
                if occupant is None or occupant.rifl != cmd.rifl:
                    self._seen_rifls.discard(cmd.rifl)
                    self._rifl_slot.pop(cmd.rifl, None)
            self._handle_submit(cmd)
        self._to_processes.append(
            ToSend(self.bp.all_but_me(), MLeaderHeartbeat(ballot))
        )

    def _handle_leader_heartbeat(self, from_: ProcessId, ballot: int, time) -> None:
        if ballot < self._leader_ballot:
            return  # stale leader
        # a higher-ballot heartbeat proves an election this process never
        # voted in (it was crashed during the campaign and restored a
        # stale is_leader): stop allocating, and hand the values stranded
        # in superseded commanders to the real leader — those rounds can
        # never complete, and nothing else would retry them
        stale = self._multi_synod.demote_if_superseded(ballot)
        for _b, _slot, cmd in stale:
            self._pending_forwards[cmd.rifl] = cmd
        changed = from_ != self._leader
        self._leader = from_
        self._leader_ballot = ballot
        self._leader_heard = time.millis()
        if (changed or stale) and self._pending_forwards:
            # our earlier forwards may have died with the old leader:
            # re-forward everything not yet chosen (the leader dedups)
            for cmd in self._pending_forwards.values():
                self._to_processes.append(ToSend({from_}, MForwardSubmit(cmd)))

    def on_peer_down(self, peer_id: ProcessId, time: SysTime) -> None:
        """Run-layer failure-detector hook: elect immediately when the
        dead peer is the leader and we are the first live ring successor
        (the sim path relies on the staggered timeouts instead)."""
        if not self._failover:
            return
        self._down.add(peer_id)
        if self._multi_synod.is_leader and peer_id != self.id:
            # re-drive phase 2 for every in-flight slot: the original
            # accept fan-out was the f+1 write quorum and may have
            # included the dead peer — nothing else retries those rounds,
            # so their slots (and everything ordered after them) would
            # stall forever.  Broadcast: acceptors re-accepting the same
            # (ballot, slot, value) are idempotent and the chosen-slot
            # dedup swallows a re-chosen duplicate
            for ballot, slot, cmd in self._multi_synod.inflight():
                self._to_processes.append(
                    ToSend(self.bp.all(), MAccept(ballot, slot, cmd))
                )
        if peer_id != self._leader or self._leader == self.id:
            return
        candidates = sorted(
            (pid for pid in self.bp.all() if pid != self._leader and pid not in self._down),
            key=self._ring_distance,
        )
        if candidates and candidates[0] == self.id:
            self._leader_heard = time.millis()
            self._start_election()

    def on_peer_up(self, peer_id: ProcessId, time: SysTime) -> None:
        """Detector hook symmetric to :meth:`on_peer_down`: the peer is
        reachable again (restarted, or a false positive).  It re-enters
        the election candidate ring — a later failover may elect it —
        and our pending forwards are re-sent toward the current leader:
        frames queued while the peer was declared dead were dropped, and
        the leader's rifl dedup makes the re-forward exactly-once."""
        if not self._failover:
            return
        self._down.discard(peer_id)
        if self._pending_forwards and self._leader != self.id:
            for cmd in self._pending_forwards.values():
                self._to_processes.append(
                    ToSend({self._leader}, MForwardSubmit(cmd))
                )

    # --- worker routing (fpaxos.rs:416-465) ---

    @staticmethod
    def message_index(msg):
        if isinstance(msg, (MForwardSubmit, MPromise, MLeaderHeartbeat)):
            # leadership state (election, pending re-forwards) lives with
            # the submit path on the leader worker
            return worker_index_no_shift(LEADER_WORKER_INDEX)
        if isinstance(
            msg, (MAccept, MChosen, MGarbageCollection, MPrepare, MSlotSync, MSlotSyncReply)
        ):
            # the acceptor also learns chosen slots, runs gc tracking,
            # answers election prepares (its accepted map is the promise),
            # and serves/applies the rejoin slot-sync stream (the chosen
            # log lives with the MChosen handler)
            return worker_index_no_shift(ACCEPTOR_WORKER_INDEX)
        if isinstance(msg, (MSpawnCommander, MAccepted)):
            return worker_index_shift(msg.slot)
        raise AssertionError(f"unknown message {msg}")

    @staticmethod
    def event_index(event):
        if isinstance(event, LeaderCheckEvent):
            return worker_index_no_shift(LEADER_WORKER_INDEX)
        return worker_index_no_shift(ACCEPTOR_WORKER_INDEX)
