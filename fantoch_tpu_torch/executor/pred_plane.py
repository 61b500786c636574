"""Device-resident predecessors plane for Caesar's two-phase ordering.

The port of fantoch_tpu/executor/pred_plane.py.  The host twin
(:class:`~fantoch_tpu_torch.executor.pred.PredecessorsGraph`) resolves the
two-phase countdown per vertex in Python; this plane keeps the whole
pending window — sparse predecessor sets as a resident ``int32[C, W]``
slot matrix plus (clock, src, occ, executed) columns — ON the card across
batches, updated in place by each dispatch
(``ops/pred_resolve.resolve_pred_plane_step``), and each executor feed is
ONE dispatch that installs the new commits, re-points the dep cells whose
missing dots just arrived, and runs the two-phase fixpoint over
everything still pending.

Residual protocol: a missing-blocked row (a dependency not committed
here yet) stays resident — its ``MISSING`` cells are patched when the dep
commits in a later feed (or resolves as a recovered noop).

Host bookkeeping is column-native: dots are packed int64s,
installs/emissions are vectorized numpy over the feed, and the only
per-item host work is one dict probe per dependency.  Slots are never
refcounted: allocation is a bump pointer, and when the window fills the
plane compacts — still-pending rows re-pack to the bottom (dep cells
remapped through one LUT; cells referencing executed rows fold to
``TERMINAL``) in one fetch + counted re-upload.

Buffer lifecycle (resident tensors, lazy host-mirror re-materialization
with exactly ONE counted re-upload, pow2 capacity growth, per-dispatch
counters) and fault detection come from the shared
:class:`~fantoch_tpu_torch.executor.device_plane.DevicePlane` base.  An
armed plane (deadline or shadow rate) raises a typed error to the caller
and never serves a dispatch from its host twin.

Clock width: device clocks are int32; the plane refuses timestamp
sequences at or above ``2^31 - 1`` with the shared typed error.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from fantoch_tpu_torch.core.clocks import AEClock
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, all_process_ids
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.errors import ClockOverflowError
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind
from fantoch_tpu_torch.executor.device_plane import DevicePlane, next_pow2 as _pow2
from fantoch_tpu_torch.ops.pred_resolve import (
    MISSING,
    TERMINAL,
    resolve_pred_plane_step,
)
from fantoch_tpu_torch.protocol.common.pred_clocks import Clock

__all__ = ["ClockOverflowError", "DevicePredPlane", "state_from_numpy", "state_to_numpy"]

_INT32_MAX = (1 << 31) - 1

# packed dot id: (source << 40) | sequence — sources are small ints,
# sequences are per-source counters
_PACK_SHIFT = 40
_SEQ_MASK = (1 << _PACK_SHIFT) - 1

# resident state layout: (deps int32[C, W], clock, src int32[C], occ,
# executed bool[C])
_STATE_DTYPES = (np.int32, np.int32, np.int32, np.bool_, np.bool_)


def _pack(src: int, seq: int) -> int:
    return (src << _PACK_SHIFT) | seq


def _pack_cols(src: np.ndarray, seq: np.ndarray) -> np.ndarray:
    return (src.astype(np.int64) << _PACK_SHIFT) | seq.astype(np.int64)


def state_from_numpy(state, device) -> Tuple[torch.Tensor, ...]:
    """A pred plane's resident state as the port's tensors on ``device``:
    ``state`` is the five host arrays a plane's host mirror holds (the JAX
    package's ``DevicePredPlane._fetch_state()`` gives the same five), so
    both packages can continue from one window."""
    assert len(state) == len(_STATE_DTYPES), "five resident arrays expected"
    return tuple(
        torch.tensor(np.asarray(a, dtype=dt), device=device)
        for a, dt in zip(state, _STATE_DTYPES)
    )


def state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    """The inverse of :func:`state_from_numpy`: host numpy copies."""
    return tuple(t.to("cpu", copy=True).numpy() for t in state)


class DevicePredPlane(DevicePlane):
    """Resident two-phase predecessor window + one dispatch per executor
    feed.  Drop-in for the ``PredecessorsGraph`` surface the
    :class:`~fantoch_tpu_torch.executor.pred.PredecessorsExecutor` drives
    (add/add_batch/handle_noop/command_to_execute/executed/metrics/
    monitor_pending)."""

    __slots__ = (
        "_process_id",
        "_config",
        "_width",
        "_next_slot",
        "_executed_clock",
        "_exec_recent",
        "_slot_of",
        "_slot_src",
        "_slot_seq",
        "_slot_start",
        "_slot_cseq",
        "_slot_csrc",
        "_slot_cmd",
        "_waiters",
        "_waiter_since",
        "_metrics",
        "_to_execute",
    )

    plane_name = "pred"

    def __init__(
        self,
        process_id: ProcessId,
        config: Config,
        slot_capacity: int = 1024,
        width: int = 4,
        device=None,
    ):
        super().__init__(
            slot_capacity,
            stats={
                # per-dispatch tallies: new_rows/update_capacity is the
                # install-batch occupancy (padding waste), residual_rows
                # the still-blocked window after the dispatch, kernel_ms
                # the blocking dispatch+transfer wall time; compactions
                # counts window re-packs (each is one counted re-upload)
                "new_rows": 0,
                "update_capacity": 0,
                "residual_rows": 0,
                "compactions": 0,
                "kernel_ms": 0.0,
            },
            device=device,
        )
        ids = [pid for pid, _ in all_process_ids(config.shard_count, config.n)]
        self._process_id = process_id
        self._config = config
        self._width = _pow2(max(width, 1))
        self._next_slot = 0
        # the GC-facing executed clock, fed by batched add_range at
        # emission; _exec_recent is the flat probe set for encode-time dep
        # checks (cleared at compaction, so it is bounded by the
        # compaction cadence — older dots fall back to the clock)
        self._executed_clock: AEClock = AEClock(ids)
        self._exec_recent: Set[int] = set()
        # packed dot -> slot, PENDING rows only (emission pops)
        self._slot_of: Dict[int, int] = {}
        # per-slot host columns (vectorized install/emission)
        self._slot_src = np.zeros(self._cap, dtype=np.int64)
        self._slot_seq = np.zeros(self._cap, dtype=np.int64)
        self._slot_start = np.zeros(self._cap, dtype=np.int64)
        # timestamp columns mirrored host-side: execution order among one
        # dispatch's newly-executed rows is a host lexsort over these (a
        # sort over the executed handful instead of a full-capacity
        # device sort per dispatch)
        self._slot_cseq = np.zeros(self._cap, dtype=np.int64)
        self._slot_csrc = np.zeros(self._cap, dtype=np.int64)
        self._slot_cmd: Dict[int, Command] = {}
        # missing packed dot -> [(slot, col), ...] cells awaiting it, with
        # first-registration time (the watchdog only nudges dots missing
        # past the pending threshold)
        self._waiters: Dict[int, List[Tuple[int, int]]] = {}
        self._waiter_since: Dict[int, int] = {}
        self._metrics: Metrics = Metrics()
        self._to_execute: Deque[Command] = deque()

    # --- PredecessorsGraph surface ---

    def command_to_execute(self) -> Optional[Command]:
        return self._to_execute.popleft() if self._to_execute else None

    def executed(self) -> AEClock:
        return self._executed_clock.copy()

    def metrics(self) -> Metrics:
        return self._metrics

    @property
    def pending_count(self) -> int:
        """Resident rows still blocked (committed, not yet executed)."""
        return len(self._slot_of)

    def add(self, dot: Dot, cmd: Command, clock: Clock, deps: Set[Dot], time) -> None:
        from fantoch_tpu_torch.executor.pred import PredecessorsExecutionInfo

        self.add_batch([PredecessorsExecutionInfo(dot, cmd, clock, deps)], time)

    def handle_noop(self, dot: Dot, time: SysTime) -> None:
        self.add_batch([], time, noops=[dot])

    def add_batch(self, infos, time, noops=()) -> None:
        """Object-path feed: builds the column batch and funnels through
        the one column path (``add_arrays``)."""
        from fantoch_tpu_torch.executor.pred import PredArraysBuilder

        builder = PredArraysBuilder()
        for dot in noops:
            builder.add_noop(dot)
        for info in infos:
            builder.add_commit(info.dot, info.cmd, info.clock, info.deps)
        batch = builder.take()
        if batch is not None:
            self.add_arrays(batch, time)

    def add_arrays(self, batch, time) -> None:
        """One resident dispatch for a column feed
        (:class:`~fantoch_tpu_torch.executor.pred.PredExecutionArrays`):
        noop resolutions, new committed rows, and the dep patches that wake
        earlier missing-blocked residents.  A failed plane refuses the feed
        before any host bookkeeping."""
        self._check_usable()
        clock_seq = np.asarray(batch.clock_seq, dtype=np.int64)
        noop_rows = clock_seq < 0
        live = ~noop_rows
        B = int(live.sum())
        # room FIRST: a mid-feed compaction renumbers slots, and both the
        # noop patches and the install below must see the final numbering
        if B:
            self._make_room(B)
        patches: List[Tuple[int, int, int]] = []
        if noop_rows.any():
            for i in np.flatnonzero(noop_rows).tolist():
                self._note_noop(
                    int(batch.dot_src[i]), int(batch.dot_seq[i]), patches
                )
        if B == 0:
            if patches:
                self._dispatch_columns(
                    np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty((0, self._width), np.int32), patches, time,
                    csrc=np.empty(0, np.int64),
                )
            return

        dot_src = np.asarray(batch.dot_src, dtype=np.int64)[live]
        dot_seq = np.asarray(batch.dot_seq, dtype=np.int64)[live]
        cseq = clock_seq[live]
        csrc = np.asarray(batch.clock_src, dtype=np.int64)[live]
        if len(cseq) and int(cseq.max()) >= _INT32_MAX:
            raise ClockOverflowError(
                "caesar timestamp seq >= 2^31 - 1: the device pred plane "
                "is 31-bit windowed (disable device_pred_plane)"
            )
        if noop_rows.any():
            # re-base dep_row onto the live rows
            row_lut = np.cumsum(live) - 1
            cmds = [c for c, n in zip(batch.cmds, noop_rows) if not n]
        else:
            row_lut = None
            cmds = batch.cmds

        packed = _pack_cols(dot_src, dot_seq)
        packed_list = packed.tolist()
        slot_of = self._slot_of
        exec_recent = self._exec_recent
        for pd in packed_list:
            # the executed-clock probe covers dots that executed before
            # the last compaction cleared the recent set — a duplicate
            # commit must trip loudly here like the host twin's
            # committed-clock assert, never re-install and re-execute
            assert (
                pd not in slot_of
                and pd not in exec_recent
                and not self._executed_clock.contains(pd >> _PACK_SHIFT, pd & _SEQ_MASK)
            ), "commands are committed exactly once"

        # bump-allocate contiguous slots for the whole feed
        base = self._next_slot
        self._next_slot = base + B
        slots = np.arange(base, base + B, dtype=np.int64)
        slot_of.update(zip(packed_list, range(base, base + B)))
        self._slot_src[base : base + B] = dot_src
        self._slot_seq[base : base + B] = dot_seq
        self._slot_cseq[base : base + B] = cseq
        self._slot_csrc[base : base + B] = csrc
        now = time.millis() if time is not None else 0
        self._slot_start[base : base + B] = now
        self._slot_cmd.update(zip(range(base, base + B), cmds))

        # --- dependency encode (vectorized where it can be) ---
        E = len(batch.dep_row)
        if E:
            dep_row = np.asarray(batch.dep_row, dtype=np.int64)
            if row_lut is not None:
                dep_row = row_lut[dep_row]
            dep_pd = _pack_cols(
                np.asarray(batch.dep_src, np.int64),
                np.asarray(batch.dep_seq, np.int64),
            )
            # self-deps are semantic no-ops (the host twin drops them)
            self_dep = dep_pd == packed[dep_row]
            # one dict/set probe per dependency — the only per-item work
            exec_clock = self._executed_clock
            vals = np.empty(E, dtype=np.int64)
            dep_pd_list = dep_pd.tolist()
            missing_at: List[int] = []
            for e, pd in enumerate(dep_pd_list):
                v = slot_of.get(pd)
                if v is not None:
                    vals[e] = v
                elif pd in exec_recent:
                    vals[e] = TERMINAL
                elif exec_clock.contains(pd >> _PACK_SHIFT, pd & _SEQ_MASK):
                    vals[e] = TERMINAL
                else:
                    vals[e] = MISSING
                    missing_at.append(e)
                    self._waiter_since.setdefault(pd, now)
            vals[self_dep] = TERMINAL
            # per-row dep columns: dep_row is emitted row-grouped by the
            # builder, so the column index is the running offset in-group
            iota = np.arange(E, dtype=np.int64)
            head = np.r_[True, dep_row[1:] != dep_row[:-1]]
            col = iota - np.maximum.accumulate(np.where(head, iota, 0))
            width_needed = int(col.max()) + 1 if E else 1
            self._ensure_width(width_needed)
            rows = np.full((B, self._width), TERMINAL, dtype=np.int32)
            rows[dep_row, col] = vals
            # register waiters for the MISSING cells
            for e in missing_at:
                if self_dep[e] or vals[e] != MISSING:
                    continue
                self._waiters.setdefault(dep_pd_list[e], []).append(
                    (int(slots[dep_row[e]]), int(col[e]))
                )
        else:
            rows = np.full((B, self._width), TERMINAL, dtype=np.int32)

        # the residual re-feed: earlier rows waiting on this feed's dots
        if self._waiters:
            for pd, slot in zip(packed_list, range(base, base + B)):
                cells = self._waiters.pop(pd, None)
                if cells is None:
                    continue
                self._waiter_since.pop(pd, None)
                for w_slot, w_col in cells:
                    patches.append((w_slot, w_col, slot))

        self._dispatch_columns(slots, cseq, rows, patches, time, csrc=csrc)

    # --- internals ---

    def _note_noop(self, src: int, seq: int, patches) -> None:
        """A recovery-committed noop: committed AND executed (nothing
        runs), and every cell waiting on it resolves to TERMINAL — a
        command that never existed blocks nobody (the host twin's
        handle_noop)."""
        pd = _pack(src, seq)
        assert pd not in self._slot_of, "a noop dot has no resident slot"
        added = self._executed_clock.add(src, seq)
        assert added, "commands are committed exactly once"
        self._exec_recent.add(pd)
        self._waiter_since.pop(pd, None)
        for w_slot, w_col in self._waiters.pop(pd, ()):
            patches.append((w_slot, w_col, TERMINAL))

    def _make_room(self, need: int) -> None:
        """Ensure ``need`` contiguous bump slots: grow while the pending
        window could not fit at 3/4 capacity (the hysteresis keeps a few
        residual rows from flapping the capacity), then compact the
        window (re-pack pending rows to the bottom — same capacity) when
        the bump pointer is exhausted anyway."""
        while len(self._slot_of) + need > (3 * self._cap) // 4:
            self._grow_columns()
        if self._next_slot + need > self._cap:
            self._compact()

    def _grow_columns(self) -> None:
        self._grow()  # doubles _cap; re-pads resident state when live
        for name in (
            "_slot_src", "_slot_seq", "_slot_start", "_slot_cseq",
            "_slot_csrc",
        ):
            old = getattr(self, name)
            grown = np.zeros(self._cap, dtype=np.int64)
            grown[: len(old)] = old
            setattr(self, name, grown)

    def _compact(self) -> None:
        """Re-pack the pending window to the bottom of the slot space: one
        dep-matrix fetch, dep cells remapped through a LUT (references to
        executed rows fold to TERMINAL), one counted re-upload.  Clears the
        recent-executed probe set — those dots are all in the executed
        clock."""
        if self._fault_armed and self._twin_state is not None:
            # the twin is the trusted copy: a resident bit flip the shadow
            # check has not sampled yet must never survive a compaction
            self._twin_fold()
            deps = self._twin_state[0]
        else:
            self._materialize()
            # only the dep matrix needs the device round trip: timestamps
            # and occupancy rebuild from the host-mirrored slot columns
            deps = self._resident[0].to("cpu").numpy()
        old = np.fromiter(self._slot_of.values(), np.int64, len(self._slot_of))
        old.sort()  # stable re-pack keeps slot order deterministic
        P = len(old)
        lut = np.full(self._cap, TERMINAL, dtype=np.int32)
        lut[old] = np.arange(P, dtype=np.int32)
        new_deps = deps[old]
        live_cells = new_deps >= 0
        new_deps = np.where(
            live_cells, lut[np.clip(new_deps, 0, self._cap - 1)], new_deps
        )
        state = self._stash_width_cap(self._cap)
        state[0][:P] = new_deps
        state[1][:P] = self._slot_cseq[old]
        state[2][:P] = self._slot_csrc[old]
        state[3][:P] = True  # occ
        # executed stays False: only pending rows survive a compaction
        self._upload(tuple(state))
        self._host_mirror = None
        self._twin_resync(tuple(state))
        # host columns follow the same re-pack
        self._slot_src[:P] = self._slot_src[old]
        self._slot_seq[:P] = self._slot_seq[old]
        self._slot_start[:P] = self._slot_start[old]
        self._slot_cseq[:P] = self._slot_cseq[old]
        self._slot_csrc[:P] = self._slot_csrc[old]
        # in-place mutation, never rebinding: callers (add_arrays) hold
        # local aliases of these registries across a mid-feed compaction
        cmds = {int(lut[s]): self._slot_cmd[int(s)] for s in old.tolist()}
        self._slot_cmd.clear()
        self._slot_cmd.update(cmds)
        pend_pd = _pack_cols(self._slot_src[:P], self._slot_seq[:P])
        self._slot_of.clear()
        self._slot_of.update(zip(pend_pd.tolist(), range(P)))
        remapped = {
            pd: [(int(lut[s]), c) for s, c in cells]
            for pd, cells in self._waiters.items()
        }
        self._waiters.clear()
        self._waiters.update(remapped)
        self._exec_recent.clear()
        self._next_slot = P
        self.stats["compactions"] += 1

    def _ensure_width(self, width: int) -> None:
        if width <= self._width:
            return
        new_w = _pow2(width)
        if self._fault_armed and self._twin_state is not None:
            # widen from the folded twin (entries logged at the old width
            # cannot replay against the widened state)
            self._twin_fold()
            had_resident = self._resident is not None
            self._width = new_w
            self._twin_state = self._pad_state(self._twin_state, self._cap)
            if had_resident:
                self._upload(self._twin_state)
        elif self._resident is not None:
            state = self._fetch_state()
            self._width = new_w
            self._upload(self._pad_state(state, self._cap))
        else:
            self._width = new_w
        self.grows += 1

    # --- host twin (the fault detector; DevicePlane base) ---

    def _twin_replay(self, state, entry):
        """One logged window step replayed through the plain version on CPU
        tensors made from the host-owned twin state and the exact padded
        install/patch columns the resident dispatch consumed."""
        out = resolve_pred_plane_step(
            *state_from_numpy(state, "cpu"), *(torch.tensor(c) for c in entry)
        )
        return state_to_numpy(out[:5]), (out.newly.numpy(),)

    def _dispatch_columns(self, slots, cseq, rows, patches, time, csrc) -> None:
        U, P = len(slots), len(patches)
        if U == 0 and P == 0:
            self._materialize()
            return
        # pad the columns to pow2 (the reference's schedule, so both
        # packages feed their steps identical columns)
        ucap = _pow2(max(U, 1))
        pcap = _pow2(max(P, 64))
        u_row = np.full(ucap, self._cap, dtype=np.int32)  # pad -> dropped
        u_deps = np.full((ucap, self._width), TERMINAL, dtype=np.int32)
        u_clock = np.zeros(ucap, dtype=np.int32)
        u_src = np.zeros(ucap, dtype=np.int32)
        if U:
            u_row[:U] = slots
            u_deps[:U] = rows
            u_clock[:U] = cseq
            u_src[:U] = csrc
        p_row = np.full(pcap, self._cap, dtype=np.int32)  # pad -> dropped
        p_col = np.zeros(pcap, dtype=np.int32)
        p_val = np.zeros(pcap, dtype=np.int32)
        for i, (slot, col, val) in enumerate(patches):
            p_row[i], p_col[i], p_val[i] = slot, col, val

        # the twin logs the exact padded columns before the dispatch
        # (armed-only no-op)
        entry = (u_row, u_deps, u_clock, u_src, p_row, p_col, p_val)
        self._twin_note(entry)
        t0 = _time.perf_counter()
        # an injected hang/raise fails the plane here, before any launch
        fault = self._fault_check_pre()
        self._materialize()
        dev = self._device
        feed = [torch.tensor(c, device=dev) for c in entry]
        timer = self._timer()
        out = resolve_pred_plane_step(*self._resident, *feed)
        timer.stop()
        self._resident = tuple(out[:5])
        if fault is not None:
            self._poison_resident(fault)
        # one blocking transfer for the dispatch's result
        newly = out.newly.to("cpu", copy=True).numpy()
        self._check_deadline(t0)
        if self._shadow_sampled():
            self._shadow_compare(self._fetch_state(), (newly,))
        if newly.any():
            self._emit(newly, time)
        self._count_dispatch(
            t0,
            new_rows=U,
            update_capacity=ucap,
            residual_rows=self.pending_count,
        )

    def _emit(self, newly: np.ndarray, time) -> None:
        """Vectorized emission of one dispatch's executed slots in (clock,
        src) timestamp order — a host lexsort over the executed handful
        (the slot timestamp columns are host-mirrored); the executed clock
        folds contiguous per-source runs via add_range, and the pending
        registry drops the rows."""
        exec_slots = np.flatnonzero(newly).astype(np.int64)
        exec_slots = exec_slots[
            np.lexsort(
                (self._slot_csrc[exec_slots], self._slot_cseq[exec_slots])
            )
        ]
        srcs = self._slot_src[exec_slots]
        seqs = self._slot_seq[exec_slots]
        cmds = self._slot_cmd
        to_exec = self._to_execute
        slot_of = self._slot_of
        recent = self._exec_recent
        pds = _pack_cols(srcs, seqs).tolist()
        for slot, pd in zip(exec_slots.tolist(), pds):
            to_exec.append(cmds.pop(slot))
            del slot_of[pd]
            recent.add(pd)
        # executed clock: per-source contiguous runs fold to add_range
        sort = np.lexsort((seqs, srcs))
        s_src, s_seq = srcs[sort], seqs[sort]
        run_head = np.r_[
            True, (s_src[1:] != s_src[:-1]) | (s_seq[1:] != s_seq[:-1] + 1)
        ]
        starts = np.flatnonzero(run_head)
        ends = np.r_[starts[1:], len(s_seq)] - 1
        clock = self._executed_clock
        for a, b in zip(starts.tolist(), ends.tolist()):
            clock.add_range(int(s_src[a]), int(s_seq[a]), int(s_seq[b]))
        if time is not None:
            now = time.millis()
            self._metrics.collect_many(
                ExecutorMetricsKind.EXECUTION_DELAY,
                np.maximum(now - self._slot_start[exec_slots], 0),
            )

    # --- liveness watchdog (the PredecessorsGraph contract) ---

    def monitor_pending(self, time: SysTime):
        """Long-pending resident rows are, transitively, blocked on the
        plane's missing frontier (every blocked chain bottoms out at a
        MISSING cell — a fixpoint row with no missing reachable would have
        executed); the frontier IS ``_waiters``' key set, so no walk is
        needed.  Only dots missing PAST the pending threshold are nudged —
        the frontier also holds dots of healthy in-flight commits, and
        starting recovery consensus against those would preempt live
        coordinators."""
        from fantoch_tpu_torch.executor.pred import MONITOR_PENDING_THRESHOLD_MS

        fail_ms = self._config.executor_pending_fail_ms
        threshold = (
            MONITOR_PENDING_THRESHOLD_MS
            if fail_ms is None
            else min(MONITOR_PENDING_THRESHOLD_MS, fail_ms)
        )
        now = time.millis()
        missing = {
            Dot(pd >> _PACK_SHIFT, pd & _SEQ_MASK)
            for pd, since in self._waiter_since.items()
            if now - since >= threshold
        }
        stuck_without_missing: Set[Dot] = set()
        stalled_missing: Dict[Dot, Set[Dot]] = {}
        stalled_for = 0
        all_missing: Set[Dot] = set()
        for pd, slot in self._slot_of.items():
            pending_for = now - int(self._slot_start[slot])
            if pending_for < threshold:
                continue
            dot = Dot(pd >> _PACK_SHIFT, pd & _SEQ_MASK)
            if not self._waiters:
                # no missing frontier AT ALL: a long-pending row is a
                # plane bug (every blocked chain bottoms out missing)
                stuck_without_missing.add(dot)
                continue
            if not missing:
                # blocked behind deps whose missing cells are younger than
                # the threshold: not actionable yet
                continue
            all_missing |= missing
            if fail_ms is not None and pending_for >= fail_ms:
                stalled_missing[dot] = missing
                stalled_for = max(stalled_for, pending_for)
        if stuck_without_missing:
            raise AssertionError(
                f"p{self._process_id}: commands pending without missing "
                f"dependencies: {stuck_without_missing}"
            )
        if stalled_missing:
            from fantoch_tpu_torch.errors import StalledExecutionError

            raise StalledExecutionError(
                self._process_id,
                stalled_missing,
                stalled_for,
                self._config.recovery_delay_ms,
            )
        return all_missing

    # --- DevicePlane state hooks ---

    def _fresh_state(self):
        return tuple(self._stash_width_cap(self._cap))

    def _pad_state(self, state, cap: int):
        deps, clock, src, occ, executed = state
        rows = min(len(clock), cap)
        cols = min(deps.shape[1], self._width)
        out = self._stash_width_cap(cap)
        out[0][:rows, :cols] = deps[:rows, :cols]
        out[1][:rows] = clock[:rows]
        out[2][:rows] = src[:rows]
        out[3][:rows] = occ[:rows]
        out[4][:rows] = executed[:rows]
        return tuple(out)

    def _stash_width_cap(self, cap: int):
        return [
            np.full((cap, self._width), TERMINAL, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=bool),
            np.zeros(cap, dtype=bool),
        ]
