"""Single-decree Flexible Paxos (Synod): phase-1 waits n-f promises, phase-2
waits f+1 accepts.  Embedded in every per-dot info for slow paths.

Reference: fantoch_ps/src/protocol/common/synod/single.rs.  The coordinator
ballot trick: ballot 0 means "never accepted"; the original coordinator can
skip the prepare phase with ballot = its own id, because any prepared ballot
is > n and thus nothing can have been accepted below it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Generic, Optional, Set, Tuple, TypeVar

from fantoch_tpu_torch.core.ids import ProcessId

V = TypeVar("V")
Ballot = int


# Synod messages (single.rs:10-20)
@dataclass
class MChosen(Generic[V]):
    value: V


@dataclass
class MPrepare:
    ballot: Ballot


@dataclass
class MAccept(Generic[V]):
    ballot: Ballot
    value: V


@dataclass
class MPromise(Generic[V]):
    ballot: Ballot
    accepted: Tuple[Ballot, V]


@dataclass
class MAccepted:
    ballot: Ballot


SynodMessage = object  # union of the above


class Synod(Generic[V]):
    def __init__(
        self,
        process_id: ProcessId,
        n: int,
        f: int,
        proposal_gen: Callable[[Dict[ProcessId, V]], V],
        initial_value: V,
    ):
        self._proposer = _Proposer(process_id, n, f, proposal_gen)
        self._acceptor = _Acceptor(initial_value)
        self._chosen = False

    def set_if_not_accepted(self, value_gen: Callable[[], V]) -> bool:
        """Set the consensus value if nothing has been accepted yet (ballot
        still 0)."""
        return self._acceptor.set_if_not_accepted(value_gen)

    def value(self) -> V:
        return self._acceptor.value()

    def new_prepare(self) -> MPrepare:
        return self._proposer.new_prepare(self._acceptor)

    def skip_prepare(self) -> Ballot:
        """First-ballot shortcut for the original coordinator (single.rs:86-92)."""
        return self._proposer.skip_prepare(self._acceptor)

    def can_skip_prepare(self) -> bool:
        """The first-ballot shortcut is sound only while no prepare has
        touched the acceptor: once a recovery proposer owns a higher
        ballot, the original coordinator must go through prepare too."""
        return self._acceptor.ballot == 0

    def chosen(self) -> bool:
        return self._chosen

    def current_ballot(self) -> Ballot:
        """The proposer's active ballot: <= n on the first-ballot shortcut,
        > n once a recovery prepare ran (ballot = id + n * round)."""
        return self._proposer._ballot

    def handle(
        self,
        from_: ProcessId,
        msg,
        free_choice_adjust=None,
        free_choice_hold=None,
    ) -> Optional[SynodMessage]:
        """``free_choice_adjust`` (optional, transient — callers pass it
        per call so nothing unpicklable sticks to consensus state) maps
        the proposal-generator's value right before it is proposed.  It
        applies ONLY on the free-choice path (no promise carried an
        accepted ballot); a value bound by a prior accept is never
        touched.  The recovery plane uses it to lift recovered clocks
        above the promise quorum's stability floor.

        ``free_choice_hold`` (optional, transient like the adjuster) is
        consulted when the free-choice path has its n-f promises but not
        yet all n: ``hold(promisers)`` returning True keeps the proposer
        collecting instead of firing, so ballot-0 reports from live
        stragglers still join the union.  The recovery plane holds until
        every *known fast-quorum member* has reported: firing at the
        first n-f can drop the one report carrying a conflict edge (the
        fuzzer-found Atlas divergence — a dep known only to the second
        fast-quorum member, whose promise arrived 29ms after the quorum),
        and a dep/clock union missing such a report commits a value that
        orders the dot against nothing.  Holding is bounded by the
        caller (recovery releases after FREE_CHOICE_HOLD_ROUNDS rounds)
        so a genuinely dead member cannot block liveness."""
        if isinstance(msg, MChosen):
            self._chosen = True
            self._acceptor.set_value(msg.value)
            return None
        if isinstance(msg, MPrepare):
            return self._chosen_msg() or self._acceptor.handle_prepare(msg.ballot)
        if isinstance(msg, MAccept):
            return self._chosen_msg() or self._acceptor.handle_accept(msg.ballot, msg.value)
        if isinstance(msg, MPromise):
            if self._chosen:
                # post-decision latch: a duplicated promise (at-least-once
                # delivery) must not re-run the selection — a second
                # free choice could adjust to a NEWER clock floor and
                # emit a conflicting MAccept at the same ballot
                return None
            return self._proposer.handle_promise(
                from_, msg.ballot, msg.accepted, free_choice_adjust,
                free_choice_hold,
            )
        if isinstance(msg, MAccepted):
            if self._chosen:
                # duplicated accepteds after the choice would refill the
                # accept set from its post-choice reset and re-fire with
                # no proposal (the first-ballot-shortcut assert)
                return None
            return self._proposer.handle_accepted(from_, msg.ballot, self._acceptor)
        raise AssertionError(f"unknown synod message {msg}")

    def _chosen_msg(self) -> Optional[MChosen]:
        if self._chosen:
            return MChosen(self._acceptor.value())
        return None


class _Proposer(Generic[V]):
    def __init__(self, process_id, n, f, proposal_gen):
        self._process_id = process_id
        self._n = n
        self._f = f
        self._ballot: Ballot = 0
        self._proposal_gen = proposal_gen
        self._promises: Dict[ProcessId, Tuple[Ballot, V]] = {}
        self._accepts: Set[ProcessId] = set()
        self._proposal: Optional[V] = None

    def new_prepare(self, acceptor: "_Acceptor[V]") -> MPrepare:
        assert acceptor.ballot >= self._ballot
        # ballot owned by this process in the next round: id + n * round
        round_ = acceptor.ballot // self._n
        self._ballot = self._process_id + self._n * (round_ + 1)
        assert acceptor.ballot < self._ballot
        self._reset_state()
        return MPrepare(self._ballot)

    def skip_prepare(self, acceptor: "_Acceptor[V]") -> Ballot:
        assert acceptor.ballot == 0
        self._ballot = self._process_id
        return self._ballot

    def _reset_state(self) -> Tuple[Dict[ProcessId, Tuple[Ballot, V]], Optional[V]]:
        promises, self._promises = self._promises, {}
        self._accepts = set()
        proposal, self._proposal = self._proposal, None
        return promises, proposal

    def handle_promise(
        self, from_, ballot, accepted, free_choice_adjust=None,
        free_choice_hold=None,
    ) -> Optional[MAccept]:
        if ballot != self._ballot:
            return None
        if self._proposal is not None:
            # already proposed at this ballot: a late promise must not
            # re-run the selection (a second MAccept with a different
            # union would race the first)
            return None
        self._promises[from_] = accepted
        if len(self._promises) < self._n - self._f:
            return None
        # pick the value accepted at the highest ballot; if none was accepted
        # (all ballot 0), ask the proposal generator — the one point where
        # the value is a free (therefore adjustable) choice
        promises = self._promises
        highest_from = max(promises, key=lambda p: promises[p][0])
        highest_ballot = promises[highest_from][0]
        if highest_ballot == 0:
            if (
                free_choice_hold is not None
                and len(promises) < self._n
                and free_choice_hold(frozenset(promises))
            ):
                # keep collecting ballot-0 reports (see Synod.handle):
                # promises accumulate until the hold releases — by the
                # awaited report arriving (this path re-runs with >= n-f
                # promises) or by the caller's round bound
                return None
            values = {p: v for p, (_b, v) in promises.items()}
            proposal = self._proposal_gen(values)
            if free_choice_adjust is not None:
                proposal = free_choice_adjust(proposal)
        else:
            proposal = promises[highest_from][1]
        self._reset_state()
        self._proposal = proposal
        return MAccept(ballot, proposal)

    def handle_accepted(self, from_, ballot, acceptor: "_Acceptor[V]") -> Optional[MChosen]:
        if ballot != self._ballot:
            return None
        self._accepts.add(from_)
        if len(self._accepts) != self._f + 1:
            return None
        _, proposal = self._reset_state()
        if proposal is None:
            # first-ballot shortcut: the accepted value at our own ballot
            acc_ballot, acc_value = acceptor.accepted
            assert acc_ballot == self._process_id, (
                "there should have been a proposal before a value can be "
                "chosen (or we should still be at the first ballot)"
            )
            proposal = acc_value
        return MChosen(proposal)


class _Acceptor(Generic[V]):
    def __init__(self, initial_value: V):
        self.ballot: Ballot = 0
        self.accepted: Tuple[Ballot, V] = (0, initial_value)

    def set_if_not_accepted(self, value_gen: Callable[[], V]) -> bool:
        if self.ballot == 0:
            self.accepted = (0, value_gen())
            return True
        return False

    def set_value(self, value: V) -> None:
        self.accepted = (0, value)

    def value(self) -> V:
        return self.accepted[1]

    def handle_prepare(self, ballot: Ballot) -> Optional[MPromise]:
        if ballot > self.ballot:
            self.ballot = ballot
            return MPromise(ballot, self.accepted)
        return None

    def handle_accept(self, ballot: Ballot, value: V) -> Optional[MAccepted]:
        if ballot >= self.ballot:
            self.ballot = ballot
            self.accepted = (ballot, value)
            return MAccepted(ballot)
        return None
