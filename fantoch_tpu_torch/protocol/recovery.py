"""Per-dot recovery consensus shared by the leaderless protocols.

The reference leaves coordinator-crash recovery unimplemented (``todo!()``
at fantoch_ps epaxos.rs:627-629 and newt.rs:1110-1112); this module goes
beyond it: when a dot's commit is overdue (``Config.recovery_delay_ms``), a
surviving process drives the dot's embedded :class:`Synod` through the
full prepare/promise path that ``protocol/common/synod.py`` always carried
but nothing called.

Protocol flow (per overdue dot):

1. **Trigger** — a periodic :class:`RecoveryEvent` scans the protocol's
   pending-dot ledger.  The dot's owner (``dot.source``) retries first;
   ring successors stagger in at ``recovery_delay_ms`` increments so a
   dead owner's dots are picked up by exactly one process at a time
   (deterministic: no randomness, so fault traces stay byte-identical).
2. **Prepare** — ``synod.new_prepare()`` allocates a ballot above anything
   seen (``id + n * round``) and broadcasts :class:`MRecoveryPrepare`.
3. **Promise** — every acceptor answers with its ballot-0 value (the deps
   or clock it reported when it acked the original MCollect; the
   protocol's *bottom* when it never did) or its highest accepted value,
   plus the command payload when it holds one — so a recovering value can
   commit even at processes the original payload broadcast missed.  An
   acceptor that already learned the decision short-circuits with a
   commit reply instead.
4. **Select** — with ``n - f`` promises the synod proposer picks the
   highest-ballot accepted value; if nothing was ever accepted the
   protocol's ``proposal_gen`` runs over the ballot-0 reports: the union
   of reported deps (graph family) / the max reported clock (Newt) / the
   max reported clock with the union of reported predecessor sets
   (Caesar), or the protocol's *noop* bottom for dots never payloaded
   anywhere visible (owner crashed before its MCollect got out).  On
   that free-choice path the value is also passed through the protocol's
   ``_recovery_adjust_value`` with the max ``clock_floor`` the promises
   carried: Newt lifts recovered clocks strictly above the quorum's
   current key clocks, and Caesar re-issues a fresh unique timestamp
   above the quorum's max indexed sequence (re-extending the predecessor
   union under it), so a recovery-decided timestamp can never land at or
   below timestamps the survivors may already have executed past (the
   live-vs-reconstructed order divergence a *restarted* replica would
   otherwise expose).
5. **Phase 2** — the chosen value flows through the protocols' existing
   MConsensus/MConsensusAck handlers (broadcast rather than
   write-quorum-only, since quorum members may be the dead ones) and
   commits through the normal MCommit path; noop commits resolve
   dependents through the executor's noop seam without executing
   anything.

Safety note: ballots make concurrent recoveries and recovery-vs-slow-path
races safe (classic synod).  The one residual window is recovery racing a
*fast-path* commit that the (live or crashed) coordinator decided but that
no promiser has seen: the recovered value can then differ from the
decided one — the graph protocols' union includes non-quorum "late
reports" (extra conflict edges a fast-path value never saw) and can at
the same time miss deps/clock-maxima known only to reporters outside the
promise quorum.  With the all-at-once fan-out both the simulator and the
TCP writer perform, a decided commit either reaches every live process or
none, so the window requires an in-flight commit surviving past the
recovery trigger: ``recovery_delay_ms`` MUST exceed the maximum delivery
delay, retransmit tails included — size the knob accordingly (and the
model checker covers the message-driven interleavings exhaustively at
small scope).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import Dot, ProcessId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.protocol.base import ToSend
from fantoch_tpu_torch.protocol.common.synod import (
    MAccept as SynodMAccept,
    MChosen as SynodMChosen,
    MPrepare as SynodMPrepare,
    MPromise as SynodMPromise,
)


@dataclass
class MRecoveryPrepare:
    dot: Dot
    ballot: int
    # payload piggyback (symmetric to MRecoveryPromise.cmd): an acceptor
    # that never saw the MCollect adopts it so its promise can CONSUME
    # key-clock votes (Newt's _recovery_promise_floor).  Without it, a
    # payload-less promiser reports floor 0 and its vote column keeps
    # advancing — a stability set avoiding the consuming promisers can
    # then pass the recovered clock before the commit lands (the
    # fuzzer-found crash-restart order divergence)
    cmd: Optional[Command] = None


@dataclass
class MRecoveryPromise:
    dot: Dot
    ballot: int
    accepted: Tuple[int, Any]  # (accepted ballot, value)
    cmd: Optional[Command]  # payload piggyback for processes that miss it
    # the acceptor's current clock floor for the dot's keys (Newt: max
    # key clock; 0 when the payload is unknown or the protocol has no
    # clocks).  When the recovered value is a FREE choice (no promise
    # carried an accepted ballot), the proposer lifts the chosen clock
    # above the quorum's max floor: an n-f promise quorum intersects
    # every stability-threshold set, so the max floor upper-bounds any
    # timestamp that may already be stable — without the lift, a
    # recovered clock can land BELOW timestamps the survivors already
    # executed past, and a replica that later reconstructs order from
    # table state (a restarted one) diverges from the live history
    clock_floor: int = 0


@dataclass
class RecoveryEvent:
    """Periodic overdue-dot scan (interval = Config.recovery_delay_ms)."""


# free-choice selections wait for ALL n promises during the first
# this-many recovery rounds (ballot = id + n * round); later rounds fire
# at n - f so a crashed process cannot block recovery forever — by then
# its silence has outlived several recovery_delay_ms intervals, which
# the knob's contract already sizes well above any delivery delay.
# Waiting for every live report matters because the one ballot-0 report
# carrying a conflict edge may live ANYWHERE: at a fast-quorum member
# whose promise trails the first n - f (the fuzzer-found Atlas
# divergence — a dep known only to the straggling member), or at a
# NON-member whose late report (staged when the MCollect reached it) is
# the only place the edge was ever recorded.  A dep/clock union missing
# that report commits a value that orders the dot against nothing.
FREE_CHOICE_HOLD_ROUNDS = 2


class RecoveryMixin:
    """Requires from the host protocol: ``self.bp`` (BaseProcess),
    ``self._cmds`` (CommandsInfo over infos with ``.status``/``.synod``/
    ``.cmd``), ``self._to_processes`` (deque), a ``Status`` class with
    ``COMMIT``, and two hooks:

    * ``_recovery_consensus_msg(dot, ballot, value, cmd)`` — the protocol's
      MConsensus carrying a recovered value (and the payload piggyback);
    * ``_recovery_chosen_reply(to, dot, info, value)`` — answer a prepare
      for an already-decided dot with the protocol's commit message.
    """

    _STATUS_COMMIT = "commit"

    def _init_recovery(self) -> None:
        # dot -> virtual ms when it became pending (or last recovery try)
        self._pending_since: Dict[Dot, int] = {}
        # prepares issued for never-payloaded dots (tracer counters are
        # running totals)
        self._unpayloaded_prepares = 0
        # dot -> (ballot, max promise clock_floor) for the free-choice
        # clock lift (see MRecoveryPromise.clock_floor)
        self._promise_floors: Dict[Dot, Tuple[int, int]] = {}

    def _recovery_enabled(self) -> bool:
        cfg = self.bp.config
        # single-shard only: the partial-replication commit aggregation has
        # no recovery story yet (cross-shard MShardCommit state dies with
        # the dot owner)
        return cfg.recovery_delay_ms is not None and cfg.shard_count == 1

    def recovery_periodic_events(self):
        if self._recovery_enabled():
            return [(RecoveryEvent(), self.bp.config.recovery_delay_ms)]
        return []

    def _recovery_track(self, dot: Dot, time: SysTime) -> None:
        if not self._recovery_enabled() or dot in self._pending_since:
            return
        if self._recovery_settled(dot):
            # straggler for a dot already committed everywhere and GC'd
            # (a late duplicate prepare/commit), or settled by a WAL-tail
            # replay: enrolling it would pin a resurrected info in
            # permanent recovery churn — its noop commit is dropped by
            # every receiver's own straggler guard, so the round ladder
            # would never terminate
            return
        self._pending_since[dot] = time.millis()

    def _recovery_untrack(self, dot: Dot) -> None:
        if self._recovery_enabled():
            self._pending_since.pop(dot, None)
            # floor bookkeeping for an abandoned/committed round must not
            # outlive the dot (it is not GC'd with the per-dot info)
            self._promise_floors.pop(dot, None)

    # --- triggers ---

    def nudge_recovery(self, dots, time: SysTime) -> None:
        """Executor-watchdog hint (Protocol.nudge_recovery): track missing
        dependency dots so the periodic scan recovers them — the only path
        by which a dot payloaded at no live process (its owner crashed
        before the broadcast got out) heals, as a committed noop."""
        if not self._recovery_enabled():
            return
        for dot in sorted(dots):
            self._recovery_track(dot, time)

    def handle_recovery_event(self, time: SysTime) -> None:
        if not self._recovery_enabled():
            return
        now = time.millis()
        delay = self.bp.config.recovery_delay_ms
        n = self.bp.config.n
        me = self.bp.process_id
        gc_track = getattr(self, "_gc_track", None)
        for dot in list(self._pending_since):
            if gc_track is not None and gc_track.contains(dot):
                # committed everywhere and GC'd since it was tracked:
                # done — `_cmds.get` below would resurrect a fresh info
                # and re-run recovery for a dead dot forever
                self._pending_since.pop(dot, None)
                self._promise_floors.pop(dot, None)
                continue
            # get (not get_existing): a nudged dot may have no info yet —
            # recovery then runs on the fresh bottom synod and, with no
            # payload anywhere, commits it as a noop
            info = self._cmds.get(dot)
            if info.status == self._STATUS_COMMIT:
                self._pending_since.pop(dot, None)
                continue
            # stagger: the owner retries after one delay, its ring
            # successor after two, and so on — one new proposer per
            # interval.  For a dot whose DECISION this process already
            # holds (a payload-less buffered commit: the rejoin-gap
            # class), the full ring stagger only delays a heal that any
            # committed peer answers with an instant chosen reply — so
            # those dots compress the stagger to quarter-delay strides
            # (still distinct per process, so concurrent recoverers stay
            # phase-disjoint; fuzzer-found: a rejoiner's buffered commit
            # at ring distance 3 healed delay*4 late, past the run tail)
            stride = delay
            if self._recovery_commit_known(dot):
                stride = max(1, delay // 4)
            wait = delay + stride * ((me - dot.source) % n)
            if now - self._pending_since[dot] < wait:
                continue
            # rebase so this proposer retries once per n*delay, keeping
            # its ring phase: proposers sharing one retry cadence duel
            # forever (each prepare preempts the other's accept phase —
            # deterministically so in the sim), so the ring offsets must
            # stay disjoint across retries, not just on the first join
            self._pending_since[dot] = now + delay * n - wait
            prepare = info.synod.new_prepare()
            # trace: the dot entered recovery consensus (out-of-chain
            # stage when the payload is known here, else a counter — a
            # never-payloaded dot has no rifl to span against)
            tracer = self.bp.tracer
            if tracer.enabled:
                if info.cmd is not None:
                    tracer.span(
                        "recovery", info.cmd.rifl, dot=dot, pid=me,
                        meta={"ballot": prepare.ballot},
                    )
                else:
                    self._unpayloaded_prepares += 1
                    tracer.counter(
                        "recovery_unpayloaded_prepares",
                        self._unpayloaded_prepares, pid=me,
                    )
            self._to_processes.append(
                ToSend(
                    self.bp.all(),
                    MRecoveryPrepare(dot, prepare.ballot, info.cmd),
                )
            )

    # --- wire handlers ---

    def handle_recovery_message(self, from_: ProcessId, msg: Any, time: SysTime) -> bool:
        """Dispatch a recovery message; returns False if ``msg`` is not
        one."""
        if isinstance(msg, MRecoveryPrepare):
            self._handle_recovery_prepare(
                from_, msg.dot, msg.ballot, getattr(msg, "cmd", None), time
            )
        elif isinstance(msg, MRecoveryPromise):
            self._handle_recovery_promise(
                from_, msg.dot, msg.ballot, msg.accepted, msg.cmd, time,
                getattr(msg, "clock_floor", 0),
            )
        else:
            return False
        return True

    def _recovery_gc_straggler(self, dot: Dot) -> bool:
        """True when ``dot`` already committed here and its info was (or
        can be) GC'd: a LATE DUPLICATE recovery message for it must be
        dropped outright.  ``_cmds.get`` would resurrect a fresh info,
        and the promise-floor hook would then CONSUME key-clock votes for
        a dot whose commit — the only thing that ever releases them —
        already happened: the consumed ranges leak forever, the
        acceptor's vote column keeps a permanent hole, and timestamp
        stability stalls mesh-wide (fuzzer-found under the
        late-retransmit nemesis, soak seed 99).

        Committed-but-still-live dots (info present) are NOT stragglers:
        their synod short-circuits the prepare with a chosen reply — the
        payload-fetch heal path rejoin-gap buffered commits depend on."""
        return (
            self._recovery_settled(dot)
            and self._cmds.get_existing(dot) is None
        )

    def _handle_recovery_prepare(
        self,
        from_: ProcessId,
        dot: Dot,
        ballot: int,
        cmd: Optional[Command] = None,
        time: Optional[SysTime] = None,
    ) -> None:
        if self._recovery_gc_straggler(dot):
            # committed here already: a live proposer cannot exist for a
            # stable-everywhere dot (it would have committed it too), so
            # this is a late duplicate — do not resurrect, do not consume
            return
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None:
            # adopt the piggybacked payload BEFORE promising: the promise
            # floor consumes key-clock votes, which needs the keys
            self._adopt_recovered_payload(dot, info, cmd, time)
        if time is not None and info.status != self._STATUS_COMMIT:
            # a prepare names a dot someone considers overdue — track it
            # HERE too: the promise may adopt a payload and consume votes
            # (state that must eventually release commit-coupled), and if
            # the proposer dies mid-round, this process must be able to
            # finish the recovery itself (ring stagger) instead of
            # holding a permanent gap in its vote column
            self._recovery_track(dot, time)
        out = info.synod.handle(from_, SynodMPrepare(ballot))
        if out is None:
            return  # stale ballot
        if isinstance(out, SynodMPromise):
            self._to_processes.append(
                ToSend(
                    {from_},
                    MRecoveryPromise(
                        dot, out.ballot, out.accepted, info.cmd,
                        self._recovery_promise_floor(dot, info),
                    ),
                )
            )
        elif isinstance(out, SynodMChosen):
            # already decided here: short-circuit the proposer with a commit
            self._recovery_chosen_reply(from_, dot, info, out.value)
        else:  # pragma: no cover
            raise AssertionError(f"unexpected synod output {out}")

    def _handle_recovery_promise(
        self,
        from_: ProcessId,
        dot: Dot,
        ballot: int,
        accepted: Tuple[int, Any],
        cmd: Optional[Command],
        time: SysTime,
        clock_floor: int = 0,
    ) -> None:
        if self._recovery_gc_straggler(dot):
            return  # late duplicate for a GC'd dot: do not resurrect
        info = self._cmds.get(dot)
        if cmd is not None and info.cmd is None:
            # adopt the piggybacked payload so a later commit can execute
            # even if the original MCollect never reached us
            self._adopt_recovered_payload(dot, info, cmd, time)
        # floor bookkeeping for the free-choice clock lift: track the max
        # reported floor per (dot, ballot) round; the synod applies the
        # adjuster ONLY when the value is a free choice (no promise
        # carried an accepted ballot), so a bound value is never touched
        state = self._promise_floors.get(dot)
        if state is None or state[0] != ballot:
            state = (ballot, 0)
        state = (ballot, max(state[1], clock_floor))
        self._promise_floors[dot] = state
        floor = state[1]

        def adjust(value):
            return self._recovery_adjust_value(dot, info, value, floor)

        # free-choice hold (see FREE_CHOICE_HOLD_ROUNDS): during the
        # first rounds, wait for ALL n ballot-0 reports — the one report
        # carrying a conflict edge (or the highest consumed clock floor)
        # can live at ANY process, quorum member or not, and a union
        # missing it commits a value that orders the dot against nothing.
        # The synod only consults the hold below n promises, so an
        # all-alive mesh fires after one delivery round-trip; a crashed
        # process blocks only until the round cap
        hold = None
        round_ = (ballot - 1) // self.bp.config.n
        if round_ <= FREE_CHOICE_HOLD_ROUNDS:
            def hold(_promisers):
                return True

        out = info.synod.handle(
            from_, SynodMPromise(ballot, accepted),
            free_choice_adjust=adjust, free_choice_hold=hold,
        )
        if out is None:
            return  # not this ballot, or still below n - f promises
        assert isinstance(out, SynodMAccept), f"unexpected synod output {out}"
        self._promise_floors.pop(dot, None)
        # broadcast (not write-quorum-only): the write quorum was sized for
        # the failure-free path and may contain the dead processes recovery
        # is routing around; phase-2 still only needs f + 1 accepts
        self._to_processes.append(
            ToSend(
                self.bp.all(),
                self._recovery_consensus_msg(dot, out.ballot, out.value, info.cmd),
            )
        )

    # --- hooks for the host protocol ---

    def _recovery_settled(self, dot) -> bool:
        """Whether ``dot``'s commit is already settled at this process —
        the shared guard behind straggler drops and scan eviction.
        Default: the GC clock; Caesar adds its WAL-tail replay overlay
        (its executed-driven clock cannot absorb durable folds)."""
        gc_track = getattr(self, "_gc_track", None)
        return gc_track is not None and gc_track.contains(dot)

    def _recovery_commit_known(self, dot) -> bool:
        """Whether this process already holds the dot's decided commit
        (buffered payload-less — the rejoin-gap class): recovery then
        only needs to fetch the payload via a chosen reply, so the scan
        compresses its ring stagger.  Default False."""
        return False

    def _recovery_promise_floor(self, dot, info) -> int:
        """The acceptor's clock floor for the dot's keys (see
        MRecoveryPromise.clock_floor).  Default 0 — clockless protocols
        (the graph family) never lift.  Newt CONSUMES votes through the
        floor it reports; Caesar reports the max indexed timestamp
        sequence on the dot's keys (excluding the dot itself)."""
        return 0

    def _recovery_adjust_value(self, dot, info, value, floor: int):
        """Lift a FREE-choice recovered value to the promise quorum's max
        clock floor.  Default identity; Newt lifts non-noop clocks to
        ``max(value, floor)`` — the floor is a clock the reporting
        acceptor CONSUMED votes through (see ``_recovery_promise_floor``),
        so the lifted clock is covered by held ranges released
        commit-coupled; lifting ABOVE it (a +1) would land on a clock
        nobody consumed and reopen the stability-overtakes-commit gap.
        Caesar instead issues a FRESH unique timestamp above the floor
        and re-extends the predecessor union under it."""
        return value

    def _adopt_recovered_payload(self, dot: Dot, info, cmd: Command, time: SysTime) -> None:
        info.cmd = cmd

    def _recovery_consensus_msg(self, dot: Dot, ballot: int, value, cmd):
        raise NotImplementedError

    def _recovery_chosen_reply(self, to: ProcessId, dot: Dot, info, value) -> None:
        raise NotImplementedError
