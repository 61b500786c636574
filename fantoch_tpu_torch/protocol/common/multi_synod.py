"""Flexible multi-decree Paxos (MultiSynod): leader, acceptor and per-slot
commanders, modeled after "Paxos Made Moderately Complex".

Reference: fantoch_ps/src/protocol/common/synod/multi.rs (agents) and
.../synod/gc.rs (slot-watermark GC track).  Phase-1 waits n-f promises,
phase-2 waits f+1 accepts; the initial leader's first ballot (its own id)
is implicitly joined by every acceptor at bootstrap, so steady-state
commands skip the prepare phase entirely.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generic, Optional, Set, Tuple, TypeVar

from fantoch_tpu_torch.core.ids import ProcessId

V = TypeVar("V")
Ballot = int
Slot = int


# MultiSynod messages (multi.rs:18-31); MChosen/MForwardSubmit are handled
# by the protocol layer, the rest route between the agents
@dataclass
class MPrepare:
    """Leader-election phase 1: a candidate's ballot (the reference's
    todo!() at multi.rs:97-99, implemented here)."""

    ballot: Ballot


@dataclass
class MPromise(Generic[V]):
    """Phase-1 answer: the acceptor's whole accepted-slot map, so the new
    leader can carry forward every value that may have been chosen."""

    ballot: Ballot
    accepted: Dict[Slot, Tuple[Ballot, V]]


@dataclass
class MSpawnCommander(Generic[V]):
    ballot: Ballot
    slot: Slot
    value: V


@dataclass
class MAccept(Generic[V]):
    ballot: Ballot
    slot: Slot
    value: V


@dataclass
class MAccepted:
    ballot: Ballot
    slot: Slot


@dataclass
class MChosen(Generic[V]):
    slot: Slot
    value: V


@dataclass
class MForwardSubmit(Generic[V]):
    value: V


class _Leader:
    """Ballot + slot allocator; only the leader allocates (multi.rs:170-210)."""

    __slots__ = ("process_id", "is_leader", "ballot", "last_slot")

    def __init__(self, process_id: ProcessId, initial_leader: ProcessId):
        self.process_id = process_id
        self.is_leader = process_id == initial_leader
        self.ballot: Ballot = process_id if self.is_leader else 0
        self.last_slot: Slot = 0

    def try_submit(self) -> Optional[Tuple[Ballot, Slot]]:
        if not self.is_leader:
            return None
        self.last_slot += 1
        return self.ballot, self.last_slot


class _Commander(Generic[V]):
    """Watches accepts for one slot until f+1 arrive (multi.rs:212-260)."""

    __slots__ = ("f", "ballot", "value", "accepts")

    def __init__(self, f: int, ballot: Ballot, value: V):
        self.f = f
        self.ballot = ballot
        self.value = value
        self.accepts: Set[ProcessId] = set()

    def handle_accepted(self, from_: ProcessId, ballot: Ballot) -> bool:
        if self.ballot != ballot:
            return False
        self.accepts.add(from_)
        return len(self.accepts) == self.f + 1


class _Acceptor(Generic[V]):
    """Ballot-guarded accepted-slot store (multi.rs:262-340).  Boots already
    joined to the initial leader's ballot."""

    __slots__ = ("ballot", "accepted")

    def __init__(self, initial_leader: ProcessId):
        self.ballot: Ballot = initial_leader
        self.accepted: Dict[Slot, Tuple[Ballot, V]] = {}

    def handle_prepare(self, ballot: Ballot) -> Optional[MPromise]:
        """Leader-election phase 1 (the reference's todo!() at
        multi.rs:97-99): join a higher ballot and promise the full
        accepted-slot map for value carry-forward."""
        if ballot <= self.ballot:
            return None
        self.ballot = ballot
        return MPromise(ballot, dict(self.accepted))

    def handle_accept(self, ballot: Ballot, slot: Slot, value: V) -> Optional[MAccepted]:
        if ballot < self.ballot:
            return None
        self.ballot = ballot
        self.accepted[slot] = (ballot, value)
        return MAccepted(ballot, slot)

    def gc(self, start: Slot, end: Slot) -> int:
        """Remove stable slots; counts only slots actually held (acceptors
        outside the leader's write quorum never saw them)."""
        return sum(1 for slot in range(start, end + 1) if self.accepted.pop(slot, None) is not None)

    def gc_single(self, slot: Slot) -> None:
        self.accepted.pop(slot, None)


class MultiSynod(Generic[V]):
    def __init__(self, process_id: ProcessId, initial_leader: ProcessId, n: int, f: int):
        self.n = n
        self.f = f
        self._leader = _Leader(process_id, initial_leader)
        self._acceptor: _Acceptor[V] = _Acceptor(initial_leader)
        self._commanders: Dict[Slot, _Commander[V]] = {}
        # election state: the ballot we're campaigning on + its promises
        self._campaign_ballot: Optional[Ballot] = None
        self._promises: Dict[ProcessId, Dict[Slot, Tuple[Ballot, V]]] = {}

    @property
    def is_leader(self) -> bool:
        return self._leader.is_leader

    def inflight(self):
        """(ballot, slot, value) of every allocated-but-unchosen slot —
        the accept rounds a leader must RE-DRIVE (broadcast) when a
        write-quorum member dies: the original f+1-sized accept fan-out
        may have included the corpse, and nothing else retries phase 2
        (fuzzer-found FPaxos stall)."""
        return sorted(
            (commander.ballot, slot, commander.value)
            for slot, commander in self._commanders.items()
        )

    def resume_above(self, slot: Slot) -> None:
        """Floor the slot allocator: a freshly-elected leader resumes
        above every slot it can PROVE allocated — the promise carry map
        alone is not enough once GC pruned globally-stable slots from the
        acceptor maps (the winner would re-allocate stable slots, whose
        re-chosen events every replica's stable-floor guard then drops:
        the command is lost and its client hangs forever)."""
        self._leader.last_slot = max(self._leader.last_slot, slot)

    def demote_if_superseded(self, ballot: Ballot):
        """A higher-ballot leadership proof arrived (an election heartbeat
        this process never voted in — e.g. it was crashed during the
        campaign and restored a stale ``is_leader``): stop allocating and
        pop every commander at a superseded ballot.  Those rounds can
        never complete (n - f acceptors joined the higher ballot, so at
        most f could still accept — below the f + 1 choose threshold);
        the protocol re-forwards their values to the real leader.
        Returns the popped (ballot, slot, value) triples, sorted."""
        if not self._leader.is_leader or ballot <= self._leader.ballot:
            return []
        self._leader.is_leader = False
        stale = sorted(
            (commander.ballot, slot, commander.value)
            for slot, commander in self._commanders.items()
            if commander.ballot < ballot
        )
        for _b, slot, _v in stale:
            del self._commanders[slot]
        return stale

    def submit(self, value: V):
        """MSpawnCommander if we're the leader, else MForwardSubmit."""
        allocated = self._leader.try_submit()
        if allocated is None:
            return MForwardSubmit(value)
        ballot, slot = allocated
        return MSpawnCommander(ballot, slot, value)

    def new_prepare(self) -> MPrepare:
        """Start (or restart) a leadership campaign: a fresh ballot owned
        by this process, above anything the local acceptor has joined."""
        round_ = self._acceptor.ballot // self.n
        self._campaign_ballot = self._leader.process_id + self.n * (round_ + 1)
        assert self._campaign_ballot > self._acceptor.ballot
        self._promises = {}
        self._leader.is_leader = False  # a superseded leader must re-win
        return MPrepare(self._campaign_ballot)

    def handle_promise(
        self, from_: ProcessId, ballot: Ballot, accepted: Dict[Slot, Tuple[Ballot, V]]
    ) -> Optional[Dict[Slot, V]]:
        """Count campaign promises; with n - f of them, take over: adopt
        the ballot, resume slot allocation above every slot seen, and
        return the carry-forward map (slot -> highest-ballot accepted
        value) the protocol must re-propose through fresh commanders."""
        if ballot != self._campaign_ballot or self._leader.is_leader:
            return None
        self._promises[from_] = accepted
        if len(self._promises) != self.n - self.f:
            return None
        carry: Dict[Slot, Tuple[Ballot, V]] = {}
        for acc in self._promises.values():
            for slot, (b, value) in acc.items():
                if slot not in carry or b > carry[slot][0]:
                    carry[slot] = (b, value)
        self._leader.is_leader = True
        self._leader.ballot = ballot
        self._leader.last_slot = max(
            self._leader.last_slot, max(carry, default=0)
        )
        self._promises = {}
        return {slot: value for slot, (_b, value) in sorted(carry.items())}

    def handle(self, from_: ProcessId, msg):
        if isinstance(msg, MPrepare):
            return self._handle_prepare(msg.ballot)
        if isinstance(msg, MSpawnCommander):
            return self._handle_spawn_commander(msg.ballot, msg.slot, msg.value)
        if isinstance(msg, MAccept):
            return self._acceptor.handle_accept(msg.ballot, msg.slot, msg.value)
        if isinstance(msg, MAccepted):
            return self._handle_maccepted(from_, msg.ballot, msg.slot)
        raise AssertionError(f"unexpected multi-synod message {msg}")

    def _handle_prepare(self, ballot: Ballot) -> Optional[MPromise]:
        out = self._acceptor.handle_prepare(ballot)
        if out is not None and self._leader.is_leader and ballot > self._leader.ballot:
            # superseded: stop allocating; live commanders die with their
            # ballot (their accepts are rejected at the joined acceptors)
            self._leader.is_leader = False
        return out

    def gc(self, start: Slot, end: Slot) -> int:
        return self._acceptor.gc(start, end)

    def gc_single(self, slot: Slot) -> None:
        self._acceptor.gc_single(slot)

    def _handle_spawn_commander(self, ballot: Ballot, slot: Slot, value: V) -> MAccept:
        prev = self._commanders.get(slot)
        # one commander per slot in steady state; a takeover re-proposes a
        # carried-forward slot at a strictly higher ballot, superseding any
        # commander a dethroned leader left behind
        assert prev is None or prev.ballot < ballot, "one commander per slot"
        self._commanders[slot] = _Commander(self.f, ballot, value)
        return MAccept(ballot, slot, value)

    def _handle_maccepted(self, from_: ProcessId, ballot: Ballot, slot: Slot):
        commander = self._commanders.get(slot)
        if commander is None:
            # commander already satisfied (or never existed here)
            return None
        if commander.handle_accepted(from_, ballot):
            del self._commanders[slot]
            return MChosen(slot, commander.value)
        return None


class SlotGCTrack:
    """Slot-watermark GC: local committed frontier + everyone else's
    watermarks; stable = the minimum (synod/gc.rs:7-77)."""

    __slots__ = ("process_id", "n", "_committed", "_all_but_me", "_previous_stable")

    def __init__(self, process_id: ProcessId, n: int):
        from fantoch_tpu_torch.core.clocks import AboveExSet

        self.process_id = process_id
        self.n = n
        self._committed = AboveExSet()
        self._all_but_me: Dict[ProcessId, int] = {}
        self._previous_stable = 0

    def commit(self, slot: Slot) -> None:
        self._committed.add(slot)

    def committed(self) -> int:
        return self._committed.frontier

    def committed_by(self, from_: ProcessId, committed: int) -> None:
        self._all_but_me[from_] = committed

    def stable(self) -> Tuple[int, int]:
        """Newly-stable slot range (start > end when nothing is new)."""
        new_stable = self._stable_slot()
        slot_range = (self._previous_stable + 1, new_stable)
        self._previous_stable = new_stable
        return slot_range

    @property
    def stable_floor(self) -> int:
        """Highest slot already handed to GC: a chosen/duplicate message
        at or below it is a straggler for pruned state and must not
        re-enter the pipeline (the FPaxos analog of the dot protocols'
        GC-straggler guards)."""
        return self._previous_stable

    def _stable_slot(self) -> int:
        if len(self._all_but_me) != self.n - 1:
            return 0
        return min(self._committed.frontier, min(self._all_but_me.values()))
