"""Batched device-resolved DependencyGraph, on its device plane.

The port of fantoch_tpu/executor/graph/batched.py for the route the
north-star metric runs: ``Config(batched_graph_executor=True,
device_graph_plane=True)``.  ``BatchedDependencyGraph`` is a drop-in for
the host-oracle ``DependencyGraph`` at the same seam.  Commands cross the
boundary as arrays (``handle_add_arrays`` appends whole commit buffers;
the (dot, cmd, deps) tuple APIs are thin converters) into an append-only
column backlog, and each output drain feeds the backlog to the
device-resident plane (executor/graph/graph_plane.py) as ONE dispatch.

Resolution is lazy: adds mark the backlog dirty and the resolve runs once
per output drain (``commands_to_execute`` & friends).  With nothing
resident, a large feed whose every dependency points backwards and none
is missing is already in execution order and emits host-side with zero
dispatches (the arrival-order fast path).

Per-key execution order is identical to the host oracle's: conflicting
commands are always dependency-linked, so their relative order is forced
by the condensation topology (or by dot order inside an SCC).

Not ported yet (ROADMAP.md Queue A): the host-column resolve route (the
plane switched off, including the native C++ shortcut) and partial
replication (``shard_count > 1``); both raise here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind
from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
from fantoch_tpu_torch.executor.graph.graph_plane import (
    DeviceGraphPlane,
    graph_plane_enabled,
)
from fantoch_tpu_torch.ops.frontier import DeviceFrontier, pack_dots
from fantoch_tpu_torch.ops.graph_resolve import MISSING, TERMINAL
from fantoch_tpu_torch.utils import key_hash as _framework_key_hash

_NO_DEP = np.int64(-1)  # packed-dep sentinel: no dependency in this slot
# the built-in DEFAULT of the kernel-size gate: Config.graph_kernel_threshold
# beats the FANTOCH_GRAPH_KERNEL_THRESHOLD env var beats this value; below
# it the arrival-order fast path stays off so small batches keep exact
# structure from the resolvers
_STRUCTURE_THRESHOLD = 4096


def key_hash(key: str) -> int:
    """Stable 31-bit conflict-key hash: the framework-wide key hash folded
    to int32 range for the device kernels.  Collisions only cost resolver
    performance, not correctness."""
    return _framework_key_hash(key) & 0x7FFFFFFF


class _Backlog:
    """Append-only column store for committed-but-unexecuted commands."""

    __slots__ = ("cmds", "chunks", "scalars", "count")

    def __init__(self) -> None:
        self.cmds: List[Command] = []
        # each chunk: (src i64[b], seq i64[b], key i32[b], tms f64[b],
        #             deps i64[b, w] packed dots, _NO_DEP padded)
        self.chunks: List[Tuple[np.ndarray, ...]] = []
        self.scalars: List[Tuple[int, int, int, float, Tuple[int, ...]]] = []
        self.count = 0

    def append_arrays(self, src, seq, key, tms, deps, cmds) -> None:
        assert len(src) == len(cmds)
        self.chunks.append((src, seq, key, tms, deps))
        self.cmds.extend(cmds)
        self.count += len(src)

    def append_one(self, src, seq, key, tms, dep_packed, cmd) -> None:
        self.scalars.append((src, seq, key, tms, dep_packed))
        self.cmds.append(cmd)
        self.count += 1

    def columns(self):
        """Materialize (src, seq, key, tms, deps[B, W]) over everything."""
        chunks = list(self.chunks)
        if self.scalars:
            width = max(len(d) for *_x, d in self.scalars)
            width = max(width, 1)
            src = np.fromiter((s for s, *_ in self.scalars), np.int64)
            seq = np.fromiter((q for _, q, *_ in self.scalars), np.int64)
            key = np.fromiter((k for _, _, k, *_ in self.scalars), np.int32)
            tms = np.fromiter((t for _, _, _, t, _ in self.scalars), np.float64)
            deps = np.full((len(self.scalars), width), _NO_DEP)
            for i, (*_x, d) in enumerate(self.scalars):
                deps[i, : len(d)] = d
            chunks.append((src, seq, key, tms, deps))
        if not chunks:
            empty = np.empty(0, np.int64)
            return empty, empty, empty.astype(np.int32), empty.astype(np.float64), np.empty((0, 1), np.int64)
        width = max(c[4].shape[1] for c in chunks)
        dep_mats = []
        for c in chunks:
            mat = c[4]
            if mat.shape[1] < width:
                pad = np.full((mat.shape[0], width - mat.shape[1]), _NO_DEP)
                mat = np.concatenate([mat, pad], axis=1)
            dep_mats.append(mat)
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
            np.concatenate([c[2] for c in chunks]),
            np.concatenate([c[3] for c in chunks]),
            np.concatenate(dep_mats, axis=0),
        )

    def replace(self, src, seq, key, tms, deps, cmds) -> None:
        self.chunks = [(src, seq, key, tms, deps)] if len(src) else []
        self.scalars = []
        self.cmds = cmds
        self.count = len(cmds)


class BatchedDependencyGraph(DependencyGraph):
    """DependencyGraph whose ordering core is the device graph plane."""

    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, config: Config,
        *, device=None,
    ):
        super().__init__(process_id, shard_id, config)
        if config.shard_count > 1:
            raise ValueError(
                "device_graph_plane requires shard_count == 1 (the backlog "
                "plane keeps no per-dep shard sets)"
            )
        if not graph_plane_enabled(config):
            raise NotImplementedError(
                "the host-column resolve route (device_graph_plane off) is "
                "not ported yet: ROADMAP.md Queue A"
            )
        self._array_mode = True
        from fantoch_tpu_torch.core.ids import all_process_ids

        ids = [pid for pid, _ in all_process_ids(config.shard_count, config.n)]
        self._frontier = DeviceFrontier(ids)
        # keep the inherited name pointing at the frontier so the host
        # Tarjan oracle (stuck residues) sees the same executed set
        self._executed_clock = self._frontier  # type: ignore[assignment]
        self._backlog = _Backlog()
        self._dirty = False
        self._last_time: Optional[SysTime] = None
        from fantoch_tpu_torch.executor.device_plane import resolve_threshold

        self._structure_threshold = resolve_threshold(
            config.graph_kernel_threshold,
            "FANTOCH_GRAPH_KERNEL_THRESHOLD",
            _STRUCTURE_THRESHOLD,
        )
        self._plane = DeviceGraphPlane(
            process_id, shard_id, config, self._frontier, self._metrics,
            structure_threshold=self._structure_threshold,
            device=device,
        )
        # arm the fault detector (deadline + shadow-check) from the config
        self._plane.configure_faults(config, process_id=process_id)
        # opt-in array drain: consumers that don't need Command objects
        # read the execution order as (src, seq) columns
        self.record_order_arrays = False
        self._order_arrays: List[Tuple[np.ndarray, np.ndarray]] = []

    # --- add paths ---

    def handle_add(self, dot: Dot, cmd: Command, deps, time: SysTime) -> None:
        assert self.executor_index == 0
        self._append_tuple(dot, cmd, deps, time)
        self._dirty = True
        self._last_time = time

    def handle_add_batch(self, adds, time: SysTime) -> None:
        """Bulk tuple add: one resolve for the batch on the next drain."""
        assert self.executor_index == 0
        for dot, cmd, deps in adds:
            self._append_tuple(dot, cmd, deps, time)
        self._dirty = True
        self._last_time = time

    def handle_add_arrays(
        self,
        dot_src: np.ndarray,  # int64[b]
        dot_seq: np.ndarray,  # int64[b]
        key: np.ndarray,  # int32[b] conflict-key hash (-1 = multi-key)
        dep_dots: np.ndarray,  # int64[b, w] packed dep dots (pack_dots), -1 pad
        cmds: List[Command],
        time: SysTime,
    ) -> None:
        """The tensorized seam: the protocol's commit buffer lands here as
        whole arrays — no per-command Python in the executor."""
        assert self.executor_index == 0
        tms = np.full(len(cmds), float(time.millis()), np.float64)
        self._backlog.append_arrays(
            dot_src.astype(np.int64, copy=False),
            dot_seq.astype(np.int64, copy=False),
            key.astype(np.int32, copy=False),
            tms,
            dep_dots.astype(np.int64, copy=False),
            cmds,
        )
        self._dirty = True
        self._last_time = time

    def _append_tuple(self, dot: Dot, cmd: Command, deps, time: SysTime) -> None:
        if cmd.key_count(self._shard_id) == 1:
            khash = key_hash(next(iter(cmd.keys(self._shard_id))))
        else:
            khash = -1
        packed = tuple(
            (int(d.dot.source) << 32) | int(d.dot.sequence)
            for d in deps
            if d.dot != dot  # self-dependency pruned (tarjan.py:129)
        )
        self._backlog.append_one(
            int(dot.source), int(dot.sequence), khash, float(time.millis()), packed, cmd
        )

    # --- executed notifications ---

    def handle_executed(self, dots, _time: SysTime) -> None:
        if self.executor_index > 0 and dots:
            src = np.fromiter((d.source for d in dots), np.int64, len(dots))
            seq = np.fromiter((d.sequence for d in dots), np.int64, len(dots))
            self._frontier.add_batch(src, seq)

    def _check_pending(self, dots, time: SysTime) -> None:
        """Executed-dot notifications just mark the backlog dirty: the next
        drain re-resolves with the updated frontier."""
        assert self.executor_index == 0
        self._dirty = True

    def handle_noop(self, dot: Dot, time: SysTime) -> None:
        # the plane's waiter index patches every MISSING cell waiting on
        # the noop dot to TERMINAL on the next dispatch
        self._plane.note_noop(int(dot.source), int(dot.sequence))
        super().handle_noop(dot, time)

    # --- lazy resolution at the output drains ---

    def command_to_execute(self) -> Optional[Command]:
        self._flush()
        return super().command_to_execute()

    def commands_to_execute(self) -> List[Command]:
        self._flush()
        return super().commands_to_execute()

    def monitor_pending(self, time: SysTime):
        self._flush(time)
        return self._plane.monitor_pending(time)

    def _flush(self, time: Optional[SysTime] = None) -> None:
        if not self._dirty:
            return
        self._dirty = False
        if time is None:
            time = self._last_time
        if time is None:
            from fantoch_tpu_torch.core.timing import RunTime

            time = RunTime()
        self._resolve_backlog(time)

    # --- the batched ordering core ---

    def _map_deps(self, src, seq, deps) -> np.ndarray:
        """Vectorized dep-dot -> batch-slot join.  Returns int32[B, W] with
        TERMINAL (executed / none / self) and MISSING sentinels.

        Join strategy: dot sequences are near-dense per source (they come
        from per-process DotGens), so a direct-addressed (source, seq)
        table is one scatter + one gather — ~10x cheaper than the
        sort+searchsorted join at 250k rows.  Falls back to the sort join
        when the address space would be sparse (pathological seq gaps)."""
        batch, width = deps.shape
        flat = deps.reshape(-1)
        valid = flat >= 0
        out = np.full(batch * width, TERMINAL, dtype=np.int32)
        if not valid.any():
            # still run the join machinery's duplicate-dot check: a dot
            # delivered twice must raise even in a no-conflict batch
            self._join_rows(src, seq, flat[:0])
        else:
            v = flat[valid]
            slot = self._join_rows(src, seq, v)
            in_batch = slot >= 0
            # not in batch: executed -> TERMINAL, else MISSING
            dep_src = v >> 32
            dep_seq = v & 0xFFFFFFFF
            executed = self._frontier.contains_batch(dep_src, dep_seq)
            res = np.where(
                in_batch, slot, np.where(executed, TERMINAL, MISSING)
            ).astype(np.int32)
            # self-dependency guard (array chunks may carry them)
            rows = np.nonzero(valid)[0] // width
            res = np.where(res == rows, TERMINAL, res)
            out[valid] = res
        return out.reshape(batch, width)

    def _join_rows(self, src, seq, v) -> np.ndarray:
        """Row index per packed dep dot in ``v`` (-1 = not in batch)."""
        batch = len(src)
        if batch == 0:
            return np.full(len(v), -1, dtype=np.int64)
        src_lo, src_hi = int(src.min()), int(src.max())
        seq_lo, seq_hi = int(seq.min()), int(seq.max())
        span = (src_hi - src_lo + 1) * (seq_hi - seq_lo + 1)
        # n sources x a dense seq range is ~n*batch: allow up to 16x
        # (int32 table, 16 MB at 250k rows) before falling back to sorting
        if span <= 16 * batch + (1 << 16):
            table = np.full(span, -1, dtype=np.int32)
            width_seq = seq_hi - seq_lo + 1
            addr = (src - src_lo) * width_seq + (seq - seq_lo)
            rng = np.arange(batch, dtype=np.int32)
            table[addr] = rng
            # duplicate-dot detection: a duplicate overwrites its earlier
            # row, so the gather-back no longer matches arange
            assert (table[addr] == rng).all(), "duplicate dot added"
            dep_src = v >> 32
            dep_seq = v & 0xFFFFFFFF
            in_range = (
                (dep_src >= src_lo) & (dep_src <= src_hi)
                & (dep_seq >= seq_lo) & (dep_seq <= seq_hi)
            )
            dep_addr = np.where(
                in_range, (dep_src - src_lo) * width_seq + (dep_seq - seq_lo), 0
            )
            return np.where(in_range, table[dep_addr], -1)
        packed = pack_dots(src, seq)
        sort_idx = np.argsort(packed, kind="stable").astype(np.int64)
        sorted_packed = packed[sort_idx]
        assert (np.diff(sorted_packed) > 0).all(), "duplicate dot added"
        j = np.searchsorted(sorted_packed, v)
        j = np.minimum(j, batch - 1)
        return np.where(sorted_packed[j] == v, sort_idx[j], -1)

    def _resolve_backlog(self, time: SysTime) -> None:
        if not self._backlog.count:
            if self._plane.has_patches:
                # patches with no new feed (noop resolutions): the plane
                # still needs one dispatch to wake waiting residents
                self._plane.flush(time)
                self._drain_plane_emissions()
            return
        # a profiler span around the whole resolve (a no-op unless a
        # torch.profiler session is recording)
        with record_function("graph_resolve"):
            self._resolve_backlog_plane(time)

    # --- the device-resident backlog plane (Config.device_graph_plane) ---

    def _resolve_backlog_plane(self, time: SysTime) -> None:
        """One resident dispatch per flush: the feed columns transfer
        into the plane (new-row deltas are the only host->device traffic)
        and the whole pending window re-resolves in place.  The
        arrival-order fast path is preserved: with nothing resident, a
        backward-only no-missing feed emits host-side with zero
        dispatches, exactly like the host-column twin."""
        plane = self._plane
        src, seq, key, tms, deps = self._backlog.columns()
        batch = len(src)  # > 0: _resolve_backlog early-returns on empty
        if (
            batch > self._structure_threshold
            and plane.pending_count == 0
            and not plane.has_patches
        ):
            dep_rows = self._map_deps(src, seq, deps)
            if (
                bool((dep_rows < np.arange(batch, dtype=np.int32)[:, None]).all())
                and not bool((dep_rows == MISSING).any())
            ):
                if self.record_order_arrays:
                    self._order_arrays.append((src, seq))
                else:
                    self._to_execute.extend(self._backlog.cmds)
                self._frontier.add_batch(src, seq)
                now = float(time.millis())
                self._metrics.collect_many(
                    ExecutorMetricsKind.EXECUTION_DELAY,
                    np.maximum(now - tms, 0.0),
                )
                self._backlog.replace(
                    src[:0], seq[:0], key[:0], tms[:0], deps[:0], []
                )
                return
        cmds = self._backlog.cmds
        self._backlog.replace(src[:0], seq[:0], key[:0], tms[:0], deps[:0], [])
        plane.feed(src, seq, key, tms, deps, cmds, time)
        self._drain_plane_emissions()

    def _drain_plane_emissions(self) -> None:
        for cmds, src, seq in self._plane.take_emitted():
            if self.record_order_arrays:
                self._order_arrays.append((src, seq))
            else:
                self._to_execute.extend(cmds)

    def resolve_now(self, time: SysTime) -> None:
        """Public flush: run the pending resolve without draining objects
        (array-drain consumers pair this with take_order_arrays)."""
        self._last_time = time
        self._flush(time)

    def take_order_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, seq) of executed dots in execution order since the last
        take; requires ``record_order_arrays``."""
        assert self.record_order_arrays
        if not self._order_arrays:
            empty = np.empty(0, np.int64)
            return empty, empty
        chunks, self._order_arrays = self._order_arrays, []
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
        )


def _close_stuck_set(
    stuck_rows: np.ndarray, dep_rows: np.ndarray, remaining_mask: np.ndarray
) -> np.ndarray:
    """Enforce the stuck-residue contract before the host oracle runs: a
    row may only enter the oracle if every in-batch dependency is emitted
    or itself in the stuck set.  ``resolve_general``'s iteration budget can
    misclassify rows as stuck when a *missing* dependency lies deeper than
    its propagation horizon (merge vertices advance it one hop per round);
    the oracle drops out-of-set deps as satisfied, so an unclosed set would
    execute commands whose dependencies never committed.  Rows filtered
    out here simply stay in the backlog for a later resolve."""
    from collections import deque as _deque

    batch, _width = dep_rows.shape
    in_set = np.zeros(batch, dtype=bool)
    in_set[stuck_rows] = True
    emitted = ~remaining_mask
    valid = dep_rows >= 0
    safe = np.clip(dep_rows, 0, batch - 1)
    # seed disqualifiers: a MISSING slot, or a dep that is neither emitted
    # nor in the set (one vectorized pass; the common case — a genuinely
    # closed cycle residue — returns here)
    slot_ok = np.where(valid, emitted[safe] | in_set[safe], dep_rows != MISSING)
    bad = in_set & ~slot_ok.all(axis=1)
    if not bad.any():
        return np.asarray(stuck_rows)
    # O(edges) reverse-worklist: removal propagates to in-set dependents
    rev: dict = {}
    for r in np.asarray(stuck_rows).tolist():
        for d in dep_rows[r]:
            d = int(d)
            if d >= 0 and in_set[d]:
                rev.setdefault(d, []).append(r)
    removed = bad
    work = _deque(np.nonzero(bad)[0].tolist())
    while work:
        r = work.popleft()
        for dependent in rev.get(r, ()):
            if not removed[dependent]:
                removed[dependent] = True
                work.append(dependent)
    return np.nonzero(in_set & ~removed)[0]
