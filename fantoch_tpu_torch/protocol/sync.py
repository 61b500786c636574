"""Rejoin catch-up: committed-command sync for restarted replicas.

A replica that crashes and restarts from its WAL + snapshot (run/wal.py,
sim crash-restart) knows everything it committed before the crash but
nothing the mesh decided while it was down.  Peers dropped its frames the
moment they declared it dead, so the network never replays that history —
the returning replica must *pull* it.  This mixin is the pull:

1. **MSync** — on :meth:`rejoin` the restarted process broadcasts its
   committed-dot horizon: the GC tracker's own AEClock (contiguous
   frontier + above-exceptions), which survives in the snapshot and —
   because GC only trims ``_cmds``, never the clock — also covers commits
   whose info was already garbage-collected locally.
2. **MSyncReply** — each live peer scans its commit-info store for
   committed dots outside that horizon and streams protocol-specific
   commit records back, chunked (:data:`SYNC_CHUNK` per message) so one
   reply never balloons.  Retention is guaranteed by the
   executed-everywhere GC clock: while the requester was down its
   executed frontier froze, so the mesh's stability meet — and therefore
   GC — stalled at its last notification; everything it missed is still
   in some live peer's ``_cmds``.
3. **Apply** — the requester applies each record through the protocol's
   normal commit machinery (payload adoption + MCommit handler), which is
   idempotent per dot (``Status.COMMIT`` short-circuit), so the same
   record arriving from several peers — or racing a recovery-decided
   commit — is exactly-once.

Protocols plug in two hooks (:meth:`SyncMixin._sync_record` /
:meth:`SyncMixin._apply_sync_record`) plus an optional
:meth:`SyncMixin._sync_backfill_actions` used by Newt: vote-frontier gaps
cannot be reconstructed from commit records alone, but every process's
issued votes on a key are exactly the contiguous range ``[1, its key
clock]``, so peers (and the rejoiner) re-state that range wholesale as
detached votes — ranges dedup in the vote tables, and the restarted
replica's stability frontier heals instead of stalling below a
permanent gap.  Caesar plugs in the same two hooks with records carrying
the decided ``(clock, preds)`` pair; it needs no backfill (the
predecessor index rebuilds entirely from applied records).

Leader-based FPaxos orders a single slot log rather than per-process dot
clocks, so it rejoins through the sibling :class:`SlotSyncMixin` below:
``MSlotSync`` carries the rejoiner's contiguous committed-slot floor and
peers stream ``(slot, command)`` records from their retained chosen log
(pruned only at global stability, which stalled while the replica was
down).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

from fantoch_tpu_torch.core.ids import ProcessId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.protocol.base import ToSend

# commit records per MSyncReply message: bounds per-message work at the
# requester and keeps the sim's per-delivery cost flat
SYNC_CHUNK = 128


@dataclass
class MSync:
    """Restarted replica -> everyone: my committed horizon (an
    ``AEClock[ProcessId]``); send me what I missed."""

    committed: Any


@dataclass
class MSyncReply:
    """One chunk of protocol-specific commit records past the
    requester's horizon."""

    records: List[Tuple]


@dataclass
class MSyncBackfill:
    """A peer's frontier backfill (Newt: its vote column ``[1, key
    clock]`` per key, minus pending-held ranges), gated on ``records``:
    the receiver applies it only after it has applied that many of the
    peer's sync records.  The old scheme shipped the backfill as a plain
    detached-votes message appended after the record chunks and relied
    on in-order delivery — but fault-plan links (delay jitter, reorder,
    retransmits; the run layer's reconnect windows are the analog) can
    deliver the backfill FIRST, and a consumed range released before its
    dot's ops arrive lets timestamp stability overtake the commit: the
    rejoiner executes a higher-clock command around a lower-clock one
    and diverges from the live history (fuzzer-found, soak seed 99)."""

    votes: Any
    records: int


@dataclass
class MSlotSync:
    """Restarted replica -> everyone (slot-ordered protocols): my
    contiguous committed-slot floor; stream me the chosen slots above
    it."""

    floor: int


@dataclass
class MSlotSyncReply:
    """One chunk of ``(slot, command)`` chosen records past the
    requester's floor."""

    records: List[Tuple]


class SlotSyncMixin:
    """Slot-log rejoin catch-up for leader-based protocols (FPaxos): the
    dot-horizon MSync above keys off per-process AEClocks, but a slot
    protocol's history is one shared log — the rejoiner sends its
    executed/committed slot floor and live peers stream the chosen
    ``(slot, command)`` records above it from their retained chosen log
    (retention is the same executed-everywhere argument: the dead
    replica's GC watermark froze, so global stability — and therefore
    chosen-log pruning — stalled at its last report).  Application runs
    through the protocol's normal chosen handler, which is idempotent per
    slot (chosen-slot dedup + the ``SlotGCTrack.stable_floor`` straggler
    guard), so overlapping peer replies are exactly-once.

    Requires from the host: ``self.bp``, ``self._to_processes``, a
    ``_slot_sync_floor()`` (the rejoiner's contiguous committed-slot
    frontier), ``_slot_sync_records(floor)`` (sorted chosen records above
    the floor this peer can serve), and ``_apply_slot_sync_record``."""

    def _slot_sync_enabled(self) -> bool:
        # retention needs the GC watermark plane; without it the chosen
        # log is pruned by the bounded dedup window instead and cannot
        # promise coverage
        return (
            self.bp.config.gc_interval_ms is not None
            and self.bp.config.shard_count == 1
        )

    def rejoin(self, time: SysTime) -> None:
        if not self._slot_sync_enabled():
            return
        targets = self.bp.all_but_me()
        if not targets:
            return
        self._to_processes.append(
            ToSend(targets, MSlotSync(self._slot_sync_floor()))
        )

    def handle_slot_sync_message(self, from_: ProcessId, msg: Any, time: SysTime) -> bool:
        """Dispatch a slot-sync message; returns False if ``msg`` is not
        one."""
        if isinstance(msg, MSlotSync):
            if self._slot_sync_enabled():
                records = self._slot_sync_records(msg.floor)
                for start in range(0, len(records), SYNC_CHUNK):
                    self._to_processes.append(
                        ToSend({from_}, MSlotSyncReply(records[start : start + SYNC_CHUNK]))
                    )
        elif isinstance(msg, MSlotSyncReply):
            for record in msg.records:
                self._apply_slot_sync_record(from_, record, time)
        else:
            return False
        return True

    # --- hooks for the host protocol ---

    def _slot_sync_floor(self) -> int:
        raise NotImplementedError

    def _slot_sync_records(self, floor: int):
        raise NotImplementedError

    def _apply_slot_sync_record(self, from_: ProcessId, record, time: SysTime) -> None:
        raise NotImplementedError


class SyncMixin:
    """Requires from the host protocol: ``self.bp`` (BaseProcess),
    ``self._cmds`` (CommandsInfo with ``items()``), ``self._gc_track``
    (GCTrack), ``self._to_processes`` (deque), and a ``Status`` whose
    committed state is ``"commit"``.  Single-shard only, like the
    recovery plane (cross-shard commit aggregation state dies with the
    dot owner)."""

    _SYNC_STATUS_COMMIT = "commit"

    def _sync_enabled(self) -> bool:
        return self.bp.config.shard_count == 1

    # --- the restarted side ---

    def rejoin(self, time: SysTime) -> None:
        if not self._sync_enabled():
            return
        # fresh catch-up round: per-peer record counters and held
        # backfills from a previous life must not leak into this round's
        # barrier (a restored counter would release a new backfill early)
        self._sync_records_seen = {}
        self._held_backfills = {}
        targets = self.bp.all_but_me()
        if not targets:
            return
        self._to_processes.append(
            ToSend(targets, MSync(self._gc_track.my_clock()))
        )
        # the requester's own backfill toward the live peers needs no
        # barrier: peers hold every commit its consumed ranges belong to
        # (in-flight commits at crash time fanned out to them, and its
        # pending dots are subtracted)
        self._sync_backfill_actions(targets)

    # --- wire handlers ---

    def handle_sync_message(self, from_: ProcessId, msg: Any, time: SysTime) -> bool:
        """Dispatch a sync message; returns False if ``msg`` is not one."""
        if isinstance(msg, MSync):
            self._handle_msync(from_, msg.committed, time)
        elif isinstance(msg, MSyncReply):
            # count DISTINCT records toward the backfill barrier: a
            # duplicated/retransmitted chunk must not inflate the counter
            # past the threshold while another chunk is still in flight
            # (that would release the backfill early — the very hazard
            # the barrier exists for)
            seen = self._sync_seen().setdefault(from_, set())
            for record in msg.records:
                seen.add(record[0])
                self._apply_sync_record(from_, record, time)
            self._maybe_apply_backfill(from_, time)
        elif isinstance(msg, MSyncBackfill):
            # barrier (see MSyncBackfill): hold until every record this
            # peer streamed has been applied here — delivery can reorder
            # the backfill ahead of its own record chunks, and a consumed
            # range released before its dot's ops arrive lets stability
            # overtake the commit at the rejoiner
            self._held()[from_] = (msg.votes, msg.records)
            self._maybe_apply_backfill(from_, time)
        else:
            return False
        return True

    def _sync_seen(self) -> dict:
        if not hasattr(self, "_sync_records_seen"):
            self._sync_records_seen = {}
        return self._sync_records_seen

    def _held(self) -> dict:
        if not hasattr(self, "_held_backfills"):
            self._held_backfills = {}
        return self._held_backfills

    def _maybe_apply_backfill(self, from_: ProcessId, time: SysTime) -> None:
        held = self._held().get(from_)
        if held is None:
            return
        votes, needed = held
        if (
            len(self._sync_seen().get(from_, ())) >= needed
            and not self._sync_backfill_blocked()
        ):
            self._held().pop(from_, None)
            self._apply_sync_backfill(from_, votes, time)

    def _sync_release_backfills(self, time: SysTime) -> None:
        """Periodic retry hook: re-check every held backfill (the
        buffered-commit gate clears as in-flight commits resolve, with
        no message to anchor the release on)."""
        for from_ in list(self._held()):
            self._maybe_apply_backfill(from_, time)

    def _handle_msync(self, from_: ProcessId, committed, time: SysTime) -> None:
        if not self._sync_enabled():
            return
        records = []
        # sorted: chunk contents are a pure function of protocol state,
        # not dict insertion history — same-seed traces stay identical
        for dot, info in sorted(self._cmds.items()):
            if info.status != self._SYNC_STATUS_COMMIT:
                continue
            if committed.contains(dot.source, dot.sequence):
                continue
            records.append(self._sync_record(dot, info))
        for start in range(0, len(records), SYNC_CHUNK):
            self._to_processes.append(
                ToSend({from_}, MSyncReply(records[start : start + SYNC_CHUNK]))
            )
        # even with no missing commits the requester may have vote gaps —
        # but the backfill may only APPLY after the records above (the
        # MSyncBackfill barrier), because nothing guarantees in-order
        # delivery under fault plans
        payload = self._sync_backfill_payload()
        if payload is not None:
            self._to_processes.append(
                ToSend({from_}, MSyncBackfill(payload, len(records)))
            )

    # --- hooks for the host protocol ---

    def _sync_backfill_payload(self):
        """Optional: the frontier-backfill payload a record-serving peer
        sends barrier-gated (Newt's detached-vote re-statement).  Default
        None — no backfill message."""
        return None

    def _sync_backfill_blocked(self) -> bool:
        """Receiver-side gate shared by BOTH backfill directions: a
        backfill must not apply while this process holds payload-less
        BUFFERED commits — the backfilled column can cover ranges the
        sender consumed for exactly those commits, and releasing them
        before the ops land lets stability overtake the commit (the
        fuzzer-found live-peer variant: a rejoiner's backfill reached a
        peer whose copy of an in-flight commit was still lost behind
        retransmits).  Default False; Newt checks its buffered-MCommit
        map."""
        return False

    def _apply_sync_backfill(self, from_: ProcessId, votes, time: SysTime) -> None:
        """Apply a peer's barrier-released backfill.  Default no-op."""

    def _sync_backfill_actions(self, targets) -> None:
        """Optional: queue frontier-backfill actions toward ``targets``
        (Newt's detached-vote re-statement on the REJOINER side, where
        no barrier is needed).  Default no-op."""

    def _sync_record(self, dot, info):
        """One commit record for ``dot`` (committed here, unknown to the
        requester)."""
        raise NotImplementedError

    def _apply_sync_record(self, from_: ProcessId, record, time: SysTime) -> None:
        """Apply one peer commit record; must be idempotent per dot."""
        raise NotImplementedError
