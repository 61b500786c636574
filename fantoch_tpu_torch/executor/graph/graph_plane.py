"""Device-resident dependency backlog for the batched graph executor.

The port of fantoch_tpu/executor/graph/graph_plane.py.  The dependency
backlog — src/seq/key columns plus the int32[C, W] dep-slot matrix —
lives on the card across feeds and is updated in place; each executor
feed is ONE dispatch (``ops/graph_resolve.resolve_graph_plane_step``)
that installs the new rows, patches the ``MISSING`` cells whose dots just
committed, and re-resolves the whole pending window.  Only the emitted
order comes back.

Residual protocol: a missing-blocked row (a dependency not committed
here yet) stays resident — its ``MISSING`` cells are patched when the
dep commits in a later feed (or resolves as a recovered noop), so
blocked rows never round-trip through host columns.

Host bookkeeping is column-native: dots are packed int64s,
installs/emissions are vectorized numpy over the feed, and the only
per-item host work is one dict probe per dependency.  Slots are
bump-allocated; when the window fills the plane compacts — still-pending
rows re-pack to the bottom (dep cells remapped through a LUT, references
to executed rows folding to ``TERMINAL``) in one counted re-upload, with
3/4-capacity grow hysteresis.  The full backlog state is also mirrored on
the host (installs and patches are cheap numpy writes), so compaction,
the stuck-cycle host oracle and the liveness watchdog never fetch device
state.

Each dispatch is drained at once: its result columns are fetched and
emitted before the feed returns.

Buffer lifecycle — resident tensors, lazy host-mirror re-materialization
after restore with exactly ONE counted re-upload, pow2 capacity growth,
per-dispatch counters, the fault-detection health gauge — is the shared
:class:`~fantoch_tpu_torch.executor.device_plane.DevicePlane` base.

Modes: ``keyed`` while every resident row is single-key with at most one
live dependency; otherwise ``general`` (window at or below the kernel-size
gate: exact structure, SCC leaders fetched for CHAIN_SIZE) or
``general_resident`` (above it: the peel-and-compact resolver).  Cycles
the general resolvers cannot collapse come back ``stuck`` and finish on
the host Tarjan oracle, whose follow-up dispatch marks them executed.

Clock width: device dot sequences are int32; the plane refuses
sequences at or above ``2^31 - 1`` with the shared typed error.
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.metrics import Metrics
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.errors import ClockOverflowError
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind
from fantoch_tpu_torch.executor.device_plane import DevicePlane, next_pow2 as _pow2
from fantoch_tpu_torch.ops.frontier import DeviceFrontier, pack_dots
from fantoch_tpu_torch.ops.graph_resolve import (
    MISSING,
    TERMINAL,
    resolve_graph_plane_step,
)

_INT32_MAX = (1 << 31) - 1
_SEQ_MASK = (1 << 32) - 1
# resident state layout: (deps int32[C, W], key, src, seq int32[C],
# occ, executed bool[C])
_STATE_DTYPES = (np.int32, np.int32, np.int32, np.int32, np.bool_, np.bool_)


def state_from_numpy(state, device) -> Tuple[torch.Tensor, ...]:
    """A graph plane's resident state as the port's tensors on ``device``:
    ``state`` is the six host arrays a plane's host mirror holds (the JAX
    package's ``DeviceGraphPlane._fetch_state()`` gives the same six), so
    both packages can continue from one backlog."""
    assert len(state) == len(_STATE_DTYPES), "six resident arrays expected"
    return tuple(
        torch.tensor(np.asarray(a, dtype=dt), device=device)
        for a, dt in zip(state, _STATE_DTYPES)
    )


def state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    """The inverse of :func:`state_from_numpy`: host numpy copies."""
    return tuple(t.to("cpu", copy=True).numpy() for t in state)


def graph_plane_enabled(config: Config) -> bool:
    """The plane routing switch: an explicit ``Config.device_graph_plane``
    beats the ``FANTOCH_GRAPH_PLANE`` env var beats the default (off —
    the host-column path stays the oracle twin)."""
    if config.device_graph_plane is not None:
        return bool(config.device_graph_plane)
    env = os.environ.get("FANTOCH_GRAPH_PLANE")
    if env is None or env == "":
        return False
    return env not in ("0", "false", "no")


class DeviceGraphPlane(DevicePlane):
    """Resident dependency backlog + one fused dispatch per executor
    feed.  Driven by :class:`BatchedDependencyGraph` behind
    ``Config.device_graph_plane`` (the host-column path is the oracle
    twin — per-key execution-order parity tested in
    tests/test_graph_plane.py)."""

    __slots__ = (
        "_process_id",
        "_shard_id",
        "_config",
        "_frontier",
        "_metrics",
        "_structure_threshold",
        "_width",
        "_next_slot",
        "_slot_of",
        "_slot_src",
        "_slot_seq",
        "_slot_key",
        "_slot_tms",
        "_slot_deps",
        "_slot_general",
        "_general_rows",
        "_exec_host",
        "_slot_cmd",
        "_waiters",
        "_waiter_since",
        "_patches",
        "_emitted",
    )

    plane_name = "graph"

    def __init__(
        self,
        process_id: ProcessId,
        shard_id: ShardId,
        config: Config,
        frontier: DeviceFrontier,
        metrics: Metrics,
        *,
        structure_threshold: int = 4096,
        slot_capacity: int = 1024,
        width: int = 4,
        device=None,
    ):
        super().__init__(
            slot_capacity,
            device=device,
            stats={
                # per-dispatch tallies: new_rows/update_capacity is the
                # install-batch occupancy (padding waste), patched_cells
                # the waiter-index patches applied, residual_rows the
                # still-blocked window after the drain, kernel_ms the
                # dispatch->fetch wall; compactions counts window
                # re-packs (each is one counted re-upload)
                "new_rows": 0,
                "update_capacity": 0,
                "patched_cells": 0,
                "residual_rows": 0,
                "compactions": 0,
                "kernel_ms": 0.0,
            },
        )
        self._process_id = process_id
        self._shard_id = shard_id
        self._config = config
        # the graph's executed frontier and metrics are SHARED (one
        # executed set, one histogram registry — pickle preserves the
        # sharing within one executor snapshot)
        self._frontier = frontier
        self._metrics = metrics
        self._structure_threshold = structure_threshold
        self._width = _pow2(max(width, 1))
        self._next_slot = 0
        # packed dot -> slot, PENDING rows only (emission pops)
        self._slot_of: Dict[int, int] = {}
        # host mirrors of the resident columns (installs/patches are
        # cheap numpy writes, so compaction/oracle/watchdog never fetch)
        self._slot_src = np.zeros(self._cap, dtype=np.int64)
        self._slot_seq = np.zeros(self._cap, dtype=np.int64)
        self._slot_key = np.full(self._cap, -1, dtype=np.int32)
        self._slot_tms = np.zeros(self._cap, dtype=np.float64)
        self._slot_deps = np.full(
            (self._cap, self._width), TERMINAL, dtype=np.int32
        )
        # rows that disqualify the keyed kernel (multi-key, or >1 live
        # dep at install); the counter gates the per-dispatch mode
        self._slot_general = np.zeros(self._cap, dtype=bool)
        self._general_rows = 0
        self._exec_host = np.zeros(self._cap, dtype=bool)
        self._slot_cmd: Dict[int, object] = {}
        # missing packed dot -> [(slot, col), ...] cells awaiting it,
        # with first-registration time (the watchdog only nudges dots
        # missing past the pending threshold)
        self._waiters: Dict[int, List[Tuple[int, int]]] = {}
        self._waiter_since: Dict[int, float] = {}
        # dep patches buffered between dispatches (noop resolutions land
        # here; arrival patches are generated at feed time)
        self._patches: List[Tuple[int, int, int]] = []
        # drained emissions awaiting the graph: (cmds, src, seq) chunks
        self._emitted: List[Tuple[list, np.ndarray, np.ndarray]] = []

    # --- feed surface (BatchedDependencyGraph drives this) ---

    @property
    def pending_count(self) -> int:
        """Resident rows still blocked (committed, not yet executed)."""
        return len(self._slot_of)

    @property
    def has_patches(self) -> bool:
        return bool(self._patches)

    def reserve(self, capacity: int) -> None:
        """Pre-size the slot window (bench/serving loops: a capacity that
        covers the whole run keeps ``resident_uploads`` at exactly 1 —
        no compaction re-uploads).  Only before the first install."""
        assert self._next_slot == 0 and self._resident is None
        while self._cap < _pow2(capacity):
            self._grow_columns()

    def feed(
        self,
        dot_src: np.ndarray,  # int64[B]
        dot_seq: np.ndarray,  # int64[B]
        key: np.ndarray,  # int32[B] conflict-key hash (-1 = multi-key)
        tms: np.ndarray,  # float64[B] commit time (ms)
        dep_dots: np.ndarray,  # int64[B, W] packed dep dots, -1 pad
        cmds: List[object],
        time: SysTime,
    ) -> None:
        """Install one column feed and dispatch the resident resolve."""
        B = len(dot_src)
        if B == 0:
            return self.flush(time)
        if int(dot_seq.max()) >= _INT32_MAX:
            raise ClockOverflowError(
                "dot sequence >= 2^31 - 1: the device graph plane is "
                "31-bit windowed (disable device_graph_plane)"
            )
        now = float(time.millis()) if time is not None else 0.0
        self._make_room(B)
        packed = pack_dots(dot_src, dot_seq)
        packed_list = packed.tolist()
        slot_of = self._slot_of
        # exactly-once: a dot may be neither resident, nor executed, nor
        # repeated within the feed itself (the host twin's duplicate-dot
        # assert, extended across feeds)
        assert len(set(packed_list)) == B, "duplicate dot added"
        for pd in packed_list:
            assert pd not in slot_of, "duplicate dot added"
        assert not self._frontier.contains_batch(dot_src, dot_seq).any(), (
            "duplicate dot added"
        )

        # bump-allocate contiguous slots for the whole feed
        base = self._next_slot
        self._next_slot = base + B
        slots = np.arange(base, base + B, dtype=np.int64)
        slot_of.update(zip(packed_list, range(base, base + B)))
        self._slot_src[base : base + B] = dot_src
        self._slot_seq[base : base + B] = dot_seq
        self._slot_key[base : base + B] = key
        self._slot_tms[base : base + B] = tms
        self._exec_host[base : base + B] = False
        self._slot_cmd.update(zip(range(base, base + B), cmds))

        # --- dependency encode (vectorized; one dict probe per dep) ---
        valid = (dep_dots >= 0) & (dep_dots != packed[:, None])  # self-deps drop
        r_idx, c_src = np.nonzero(valid)
        if len(r_idx):
            v = dep_dots[r_idx, c_src]
            vals = np.empty(len(v), dtype=np.int64)
            miss_at: List[int] = []
            for e, pd in enumerate(v.tolist()):
                s = slot_of.get(pd)
                if s is not None:
                    vals[e] = s
                else:
                    miss_at.append(e)
            if miss_at:
                mp = np.asarray(miss_at, dtype=np.int64)
                mv = v[mp]
                # not in the window: executed -> TERMINAL, else MISSING
                # (one vectorized frontier probe for the whole feed)
                ex = self._frontier.contains_batch(
                    mv >> 32, mv & _SEQ_MASK
                )
                vals[mp] = np.where(ex, TERMINAL, MISSING)
            # already-satisfied cells (executed deps) encode to nothing:
            # only live cells occupy dep columns, so steady-state serving
            # feeds (most deps executed at install) never widen the window
            keep = vals != TERMINAL
            r_idx, v, vals = r_idx[keep], v[keep], vals[keep]
            live_cnt = np.bincount(r_idx, minlength=B)
            width_needed = int(live_cnt.max()) if len(r_idx) else 0
            self._ensure_width(max(width_needed, 1))
            u_deps = np.full((B, self._width), TERMINAL, dtype=np.int32)
            head = np.r_[True, r_idx[1:] != r_idx[:-1]] if len(r_idx) else (
                np.zeros(0, dtype=bool)
            )
            iota = np.arange(len(r_idx), dtype=np.int64)
            cols = iota - np.maximum.accumulate(np.where(head, iota, 0))
            u_deps[r_idx, cols] = vals
            for e in np.nonzero(vals == MISSING)[0].tolist():
                pd = int(v[e])
                w_slot, w_col = int(base + r_idx[e]), int(cols[e])
                self._waiters.setdefault(pd, []).append((w_slot, w_col))
                self._waiter_since.setdefault(pd, now)
        else:
            live_cnt = np.zeros(B, dtype=np.int64)
            self._ensure_width(1)
            u_deps = np.full((B, self._width), TERMINAL, dtype=np.int32)
        self._slot_deps[base : base + B] = u_deps
        gen = (key < 0) | (live_cnt > 1)
        self._slot_general[base : base + B] = gen
        self._general_rows += int(gen.sum())

        # the residual re-feed: earlier rows waiting on this feed's dots
        # get their MISSING cells patched to the new slots
        if self._waiters:
            for pd, slot in zip(packed_list, range(base, base + B)):
                cells = self._waiters.pop(pd, None)
                if cells is None:
                    continue
                self._waiter_since.pop(pd, None)
                for w_slot, w_col in cells:
                    self._patches.append((w_slot, w_col, slot))
                    self._slot_deps[w_slot, w_col] = slot

        self._dispatch(
            slots,
            u_deps,
            key.astype(np.int32, copy=False),
            dot_src.astype(np.int32),
            dot_seq.astype(np.int32),
            time,
        )

    def note_noop(self, source: int, sequence: int) -> None:
        """A recovery-committed noop: the dot counts as executed (the
        graph adds it to the shared frontier), and every cell waiting on
        it resolves to TERMINAL on the next dispatch."""
        pd = (int(source) << 32) | int(sequence)
        assert pd not in self._slot_of, "a noop dot has no resident slot"
        self._waiter_since.pop(pd, None)
        for w_slot, w_col in self._waiters.pop(pd, ()):
            self._patches.append((w_slot, w_col, TERMINAL))
            self._slot_deps[w_slot, w_col] = TERMINAL

    def flush(self, time: SysTime) -> None:
        """Dispatch any buffered patches (noop resolutions with no new
        feed)."""
        if self._patches:
            empty = np.empty(0, dtype=np.int64)
            self._dispatch(
                empty,
                np.empty((0, self._width), dtype=np.int32),
                empty.astype(np.int32),
                empty.astype(np.int32),
                empty.astype(np.int32),
                time,
            )

    def take_emitted(self) -> List[Tuple[list, np.ndarray, np.ndarray]]:
        """Drained (cmds, src, seq) emission chunks in execution order
        since the last take (the graph routes them to the object drain
        or the order-arrays drain)."""
        out, self._emitted = self._emitted, []
        return out

    # --- the resident dispatch ---

    def _mode(self) -> str:
        """Single-key functional windows ride the sort-based keyed
        kernels; multi-key / multi-dep windows ride ``resolve_general``
        below the kernel-size gate and the resident peeler above it."""
        if self._general_rows > 0:
            if self._cap <= self._structure_threshold:
                return "general"
            return "general_resident"
        return "keyed"

    def _dispatch(self, slots, u_deps, u_key, u_src, u_seq, time) -> None:
        """One resident dispatch, drained at once: fetch the result
        columns, check the deadline and (when sampled) the shadow twin,
        then emit.  A detected fault raises to the caller before anything
        is emitted."""
        patches, self._patches = self._patches, []
        U, P = len(slots), len(patches)
        if U == 0 and P == 0:
            return
        t0 = _time.perf_counter()
        out, mode, ucap = self._dispatch_raw(
            slots, u_deps, u_key, u_src, u_seq, patches, ()
        )
        order, newly, stuck, leader = self._fetch_result(mode, out)
        self._check_deadline(t0)
        if self._shadow_sampled():
            self._shadow_compare(self._fetch_state(), (order, newly))
        self._emit(order[newly[order]], leader, time)
        # stuck residues (general modes: 3+-cycles the device pass cannot
        # collapse) finish on the host Tarjan oracle; a follow-up dispatch
        # marks them executed on device and resolves dependents
        while stuck is not None:
            stuck_slots = np.nonzero(stuck & ~self._exec_host)[0]
            if not len(stuck_slots):
                break
            closed = self._close_stuck(stuck_slots)
            if not len(closed):
                break  # budget misclassification: wait for a later feed
            self._stuck_oracle(closed, time)
            empty = np.empty(0, dtype=np.int64)
            out, mode, _ucap = self._dispatch_raw(
                empty, np.empty((0, self._width), np.int32),
                empty.astype(np.int32), empty.astype(np.int32),
                empty.astype(np.int32), (), closed,
            )
            order, newly, stuck, leader = self._fetch_result(mode, out)
            self._emit(order[newly[order]], leader, time)
        self._count_dispatch(
            t0,
            new_rows=U,
            update_capacity=ucap,
            patched_cells=P,
            residual_rows=self.pending_count,
        )

    def _pad_columns(self, slots, u_deps, u_key, u_src, u_seq, patches, marks):
        """The padded kernel columns for one dispatch — shared by the
        resident dispatch and the host twin's stuck follow-ups, so both
        feed the kernel bit-identical inputs."""
        cap = self._cap
        U, P, E = len(slots), len(patches), len(marks)
        # pad to pow2 FLOORS: the feed columns keep a few stable shapes
        # (the JAX package needed it for compiled programs; the port keeps
        # the same padding so both feed their steps identical columns)
        ucap = _pow2(max(U, 64))
        pcap = _pow2(max(P, 64))
        ecap = _pow2(max(E, 8))
        u_row = np.full(ucap, cap, dtype=np.int32)  # pad -> dropped
        u_dep = np.full((ucap, self._width), TERMINAL, dtype=np.int32)
        u_k = np.zeros(ucap, dtype=np.int32)
        u_s = np.zeros(ucap, dtype=np.int32)
        u_q = np.zeros(ucap, dtype=np.int32)
        if U:
            u_row[:U] = slots
            u_dep[:U] = u_deps
            u_k[:U] = u_key
            u_s[:U] = u_src
            u_q[:U] = u_seq
        p_row = np.full(pcap, cap, dtype=np.int32)  # pad -> dropped
        p_col = np.zeros(pcap, dtype=np.int32)
        p_val = np.zeros(pcap, dtype=np.int32)
        for i, (slot, col, val) in enumerate(patches):
            p_row[i], p_col[i], p_val[i] = slot, col, val
        e_row = np.full(ecap, cap, dtype=np.int32)  # pad -> dropped
        if E:
            e_row[:E] = marks
        return (u_row, u_dep, u_k, u_s, u_q, p_row, p_col, p_val, e_row), ucap

    def _dispatch_raw(self, slots, u_deps, u_key, u_src, u_seq, patches, marks):
        self._check_usable()
        cols, ucap = self._pad_columns(
            slots, u_deps, u_key, u_src, u_seq, patches, marks
        )
        mode = self._mode()
        # every dispatch — primary AND stuck follow-up — is logged with
        # its mode, so the twin replays the identical step sequence and
        # tracks the resident state bit for bit (armed-only no-op)
        self._twin_note((mode,) + cols)
        # an injected hang/raise fails the plane here, before any launch
        fault = self._fault_check_pre()
        self._materialize()
        dev = self._device
        feed = [torch.tensor(c, device=dev) for c in cols]
        timer = self._timer()
        out = resolve_graph_plane_step(*self._resident, *feed, mode=mode)
        timer.stop()
        self._resident = tuple(out[:6])
        if fault is not None:
            self._poison_resident(fault)
        return out, mode, ucap

    # --- host twin (the fault detector; DevicePlane base) ---

    def _twin_replay(self, state, entry):
        """One logged dispatch replayed through the plain version of the
        step on CPU tensors made from the host-owned twin state; returns
        the new state and the result columns, all host numpy."""
        mode, cols = entry[0], entry[1:]
        out = resolve_graph_plane_step(
            *state_from_numpy(state, "cpu"),
            *(torch.tensor(c) for c in cols),
            mode=mode,
        )
        return state_to_numpy(out[:6]), self._fetch_result(mode, out)

    def _fetch_result(self, mode: str, out):
        """The dispatch's small result columns as host numpy (the backlog
        state itself never round-trips): ``keyed`` has no stuck/leader,
        the general modes fetch ``stuck``, and ``general`` alone fetches
        the SCC ``leader`` (exact CHAIN_SIZE below the kernel-size gate)."""
        def host(t):
            return t.to("cpu", copy=True).numpy()

        if mode == "keyed":
            return host(out.order), host(out.newly), None, None
        leader = host(out.leader) if mode == "general" else None
        return host(out.order), host(out.newly), host(out.stuck), leader

    def _emit(self, slots: np.ndarray, leader, time) -> None:
        """Host bookkeeping for one drain's executed slots, in emission
        order.  Idempotent (already-executed slots are dropped) so the
        stuck-cycle follow-up may re-emit a slot harmlessly."""
        slots = np.asarray(slots, dtype=np.int64)
        if len(slots):
            slots = slots[~self._exec_host[slots]]
        if not len(slots):
            return
        self._exec_host[slots] = True
        src = self._slot_src[slots]
        seq = self._slot_seq[slots]
        cmds = self._slot_cmd
        emitted_cmds = [cmds.pop(s) for s in slots.tolist()]
        slot_of = self._slot_of
        for pd in pack_dots(src, seq).tolist():
            del slot_of[pd]
        self._general_rows -= int(self._slot_general[slots].sum())
        self._frontier.add_batch(src, seq)
        if time is not None:
            now = float(time.millis())
            self._metrics.collect_many(
                ExecutorMetricsKind.EXECUTION_DELAY,
                np.maximum(now - self._slot_tms[slots], 0.0),
            )
        if leader is not None:
            # exact per-SCC structure (structure modes only — the same
            # gating as the host-column path's want_structure)
            leaders = leader[slots]
            sizes = np.diff(
                np.concatenate(
                    [[0], np.nonzero(np.diff(leaders))[0] + 1, [len(slots)]]
                )
            )
            self._metrics.collect_many(ExecutorMetricsKind.CHAIN_SIZE, sizes)
        self._emitted.append((emitted_cmds, src, seq))

    # --- stuck-cycle host oracle (slot space) ---

    def _folded_deps(self) -> np.ndarray:
        """The host mirror of the dep matrix with cells on executed
        slots folded to TERMINAL — what the device's resolve sees."""
        deps = self._slot_deps
        live = deps >= 0
        safe = np.clip(deps, 0, self._cap - 1)
        return np.where(live & self._exec_host[safe], TERMINAL, deps)

    def _close_stuck(self, stuck_slots: np.ndarray) -> np.ndarray:
        from fantoch_tpu_torch.executor.graph.batched import _close_stuck_set

        return np.asarray(
            _close_stuck_set(stuck_slots, self._folded_deps(), ~self._exec_host)
        )

    def _stuck_oracle(self, slots: np.ndarray, time) -> None:
        """Host Tarjan over the (dep-closed) stuck residue, restricted to
        stuck members — the host-column path's python oracle in slot
        space (stuck residues are rare 3+-cycles; the mirrors make the
        subgraph free to build)."""
        from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
        from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

        in_set = set(slots.tolist())
        oracle = DependencyGraph(self._process_id, self._shard_id, self._config)
        shards = frozenset({self._shard_id})
        row_of = {id(self._slot_cmd[int(s)]): int(s) for s in slots}
        emitted_rows: List[int] = []
        for s in slots.tolist():
            dot = Dot(int(self._slot_src[s]), int(self._slot_seq[s]))
            dep_list = [
                Dependency(
                    Dot(int(self._slot_src[t]), int(self._slot_seq[t])), shards
                )
                for t in self._slot_deps[s].tolist()
                if t in in_set
            ]
            oracle.handle_add(dot, self._slot_cmd[s], dep_list, time)
            for done in oracle.commands_to_execute():
                emitted_rows.append(row_of[id(done)])
        assert len(emitted_rows) == len(slots), (
            f"stuck residue not fully resolvable: "
            f"{len(emitted_rows)}/{len(slots)}"
        )
        chain_hist = oracle.metrics().get_collected(ExecutorMetricsKind.CHAIN_SIZE)
        if chain_hist is not None:
            from fantoch_tpu_torch.core.metrics import Histogram

            self._metrics.collected.setdefault(
                ExecutorMetricsKind.CHAIN_SIZE, Histogram()
            ).merge(chain_hist)
        self._emit(np.asarray(emitted_rows, dtype=np.int64), None, time)

    # --- capacity management ---

    def _make_room(self, need: int) -> None:
        """Ensure ``need`` contiguous bump slots: grow while the pending
        window could not fit at 3/4 capacity (growing a LIVE window
        reallocates the resident state — the hysteresis keeps a few
        residual rows from flapping the capacity), then compact (re-pack
        pending rows to the bottom — same capacity, one counted
        re-upload) when the bump pointer is exhausted anyway."""
        while len(self._slot_of) + need > (3 * self._cap) // 4:
            self._grow_columns()
        if self._next_slot + need > self._cap:
            self._compact()

    def _grow_columns(self) -> None:
        old_cap = self._cap
        self._grow()  # doubles _cap; re-pads resident state when live
        for name in ("_slot_src", "_slot_seq", "_slot_tms"):
            old = getattr(self, name)
            grown = np.zeros(self._cap, dtype=old.dtype)
            grown[:old_cap] = old
            setattr(self, name, grown)
        key = np.full(self._cap, -1, dtype=np.int32)
        key[:old_cap] = self._slot_key
        self._slot_key = key
        deps = np.full((self._cap, self._width), TERMINAL, dtype=np.int32)
        deps[:old_cap] = self._slot_deps
        self._slot_deps = deps
        for name in ("_slot_general", "_exec_host"):
            old = getattr(self, name)
            grown = np.zeros(self._cap, dtype=bool)
            grown[:old_cap] = old
            setattr(self, name, grown)

    def _ensure_width(self, width: int) -> None:
        if width <= self._width:
            return
        if self._twin_log:
            # entries logged at the old width cannot replay against the
            # widened twin: fold them out first
            self._twin_fold()
        new_w = _pow2(width)
        deps = np.full((self._cap, new_w), TERMINAL, dtype=np.int32)
        deps[:, : self._width] = self._slot_deps
        self._slot_deps = deps
        self._width = new_w
        state = self._rebuild_state()
        if self._resident is not None:
            self._upload(state)
        elif self._host_mirror is not None:
            self._host_mirror = state
        if self._twin_state is not None:
            self._twin_resync(state)
        self.grows += 1

    def _compact(self) -> None:
        """Re-pack the pending window to the bottom of the slot space
        from the HOST MIRRORS (no device fetch): dep cells remap through
        a LUT, references to executed rows fold to TERMINAL, one counted
        re-upload."""
        if self._twin_log:
            # entries describe the pre-compaction slot layout: fold them
            # before the renumbering
            self._twin_fold()
        cap = self._cap
        old = np.fromiter(self._slot_of.values(), np.int64, len(self._slot_of))
        old.sort()  # stable re-pack keeps slot order deterministic
        P = len(old)
        lut = np.full(cap, TERMINAL, dtype=np.int32)
        lut[old] = np.arange(P, dtype=np.int32)
        nd = self._slot_deps[old]
        live = nd >= 0
        safe = np.clip(nd, 0, cap - 1)
        nd = np.where(
            live,
            np.where(self._exec_host[safe], TERMINAL, lut[safe]),
            nd,
        ).astype(np.int32)
        # host columns follow the same re-pack
        self._slot_src[:P] = self._slot_src[old]
        self._slot_seq[:P] = self._slot_seq[old]
        self._slot_key[:P] = self._slot_key[old]
        self._slot_tms[:P] = self._slot_tms[old]
        self._slot_deps[:P] = nd
        self._slot_deps[P:] = TERMINAL
        self._slot_general[:P] = self._slot_general[old]
        self._slot_general[P:] = False
        self._general_rows = int(self._slot_general[:P].sum())
        self._exec_host[:] = False
        cmds = {int(lut[s]): self._slot_cmd[int(s)] for s in old.tolist()}
        self._slot_cmd.clear()
        self._slot_cmd.update(cmds)
        pend_pd = pack_dots(self._slot_src[:P], self._slot_seq[:P])
        self._slot_of.clear()
        self._slot_of.update(zip(pend_pd.tolist(), range(P)))
        remapped = {
            pd: [(int(lut[s]), c) for s, c in cells]
            for pd, cells in self._waiters.items()
        }
        self._waiters.clear()
        self._waiters.update(remapped)
        self._patches = [
            (int(lut[s]), c, int(lut[v]) if v >= 0 else v)
            for s, c, v in self._patches
        ]
        self._next_slot = P
        state = self._rebuild_state()
        if self._resident is not None or self._host_mirror is None:
            self._upload(state)
        else:
            self._host_mirror = state
        if self._twin_state is not None:
            self._twin_resync(state)
        self.stats["compactions"] += 1

    def _rebuild_state(self) -> Tuple[np.ndarray, ...]:
        """Full device state from the host mirrors at the current
        capacity/width (compaction, width growth, restore)."""
        cap = self._cap
        occ = np.zeros(cap, dtype=bool)
        occ[: self._next_slot] = True
        return (
            self._slot_deps.copy(),
            self._slot_key.copy(),
            self._slot_src.astype(np.int32),
            self._slot_seq.astype(np.int32),
            occ,
            self._exec_host.copy(),
        )

    # --- liveness watchdog (the BatchedDependencyGraph contract) ---

    def monitor_pending(self, time: SysTime):
        """Per-row liveness check over the host mirrors: old pending
        rows must be *transitively* missing-blocked (panic otherwise — a
        lost execution), rows blocked on missing deps past
        ``Config.executor_pending_fail_ms`` raise the typed stall, and
        the overdue missing dots are returned so the runner can nudge
        recovery.  A waiter dot found executed in the frontier is a lost
        wake and folds like an executed cell (its dependents then panic
        as pending-without-missing, exactly like the host twin)."""
        if not self._slot_of:
            return None
        from fantoch_tpu_torch.executor.graph.indexes import (
            MONITOR_PENDING_THRESHOLD_MS,
        )

        now = float(time.millis())
        pend = np.fromiter(self._slot_of.values(), np.int64, len(self._slot_of))
        pending_for = now - self._slot_tms[pend]
        old_mask = pending_for >= MONITOR_PENDING_THRESHOLD_MS
        fail_ms = self._config.executor_pending_fail_ms
        ripe_mask = pending_for >= fail_ms if fail_ms is not None else None
        if not old_mask.any() and (ripe_mask is None or not ripe_mask.any()):
            return None
        # genuinely-missing frontier: waiter dots not executed; a waiter
        # dot IN the frontier is a lost wake — skipping it here leaves
        # its dependents without a missing set, so they trip the
        # pending-without-missing panic below
        row_missing: Dict[int, Set[Dot]] = {}
        if self._waiters:
            pds = np.fromiter(self._waiters.keys(), np.int64, len(self._waiters))
            executed = self._frontier.contains_batch(pds >> 32, pds & _SEQ_MASK)
            for pd, ex in zip(pds.tolist(), executed.tolist()):
                if ex:
                    continue
                dot = Dot(pd >> 32, pd & _SEQ_MASK)
                for slot, _col in self._waiters[pd]:
                    row_missing.setdefault(slot, set()).add(dot)
        cap = self._cap
        deps = self._folded_deps()
        direct = np.zeros(cap, dtype=bool)
        if row_missing:
            direct[np.fromiter(row_missing.keys(), np.int64)] = True
        nudge = {
            dot
            for slot in np.asarray(pend[old_mask]).tolist()
            for dot in row_missing.get(slot, ())
        }
        if ripe_mask is not None:
            stalled = pend[(direct[pend]) & ripe_mask]
            if len(stalled):
                from fantoch_tpu_torch.errors import StalledExecutionError

                missing_map = {
                    Dot(int(self._slot_src[s]), int(self._slot_seq[s])):
                        row_missing[int(s)]
                    for s in stalled.tolist()[:8]
                }
                raise StalledExecutionError(
                    self._process_id,
                    missing_map,
                    int((now - self._slot_tms[stalled]).max()),
                    self._config.recovery_delay_ms,
                )
        # forward-propagate blockedness (MISSING cells whose dot is NOT
        # lost) to dependents; an old pending row left uncovered means an
        # execution was lost — panic naming the dots (host twin contract)
        blocked = ((deps == MISSING).any(axis=1)) & direct
        valid = deps >= 0
        safe = np.clip(deps, 0, cap - 1)
        old_slots = np.zeros(cap, dtype=bool)
        old_slots[pend[old_mask]] = True
        while True:
            uncovered = old_slots & ~blocked
            if not uncovered.any():
                return nudge
            grown = blocked | np.where(valid, blocked[safe], False).any(axis=1)
            if (grown == blocked).all():
                break
            blocked = grown
        dots = [
            Dot(int(self._slot_src[s]), int(self._slot_seq[s]))
            for s in np.nonzero(uncovered)[0][:8]
        ]
        raise AssertionError(
            f"p{self._process_id}: {int(uncovered.sum())} commands pending "
            f"without missing dependencies: {dots}"
        )

    # --- DevicePlane state hooks ---

    def _fresh_state(self):
        return (
            np.full((self._cap, self._width), TERMINAL, dtype=np.int32),
            np.full(self._cap, -1, dtype=np.int32),
            np.zeros(self._cap, dtype=np.int32),
            np.zeros(self._cap, dtype=np.int32),
            np.zeros(self._cap, dtype=bool),
            np.zeros(self._cap, dtype=bool),
        )

    def _pad_state(self, state, cap: int):
        deps, key, src, seq, occ, executed = state
        rows = min(len(key), cap)
        cols = min(deps.shape[1], self._width)
        out = [
            np.full((cap, self._width), TERMINAL, dtype=np.int32),
            np.full(cap, -1, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=bool),
            np.zeros(cap, dtype=bool),
        ]
        out[0][:rows, :cols] = deps[:rows, :cols]
        out[1][:rows] = key[:rows]
        out[2][:rows] = src[:rows]
        out[3][:rows] = seq[:rows]
        out[4][:rows] = occ[:rows]
        out[5][:rows] = executed[:rows]
        return tuple(out)
