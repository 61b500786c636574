"""Batched device-resolved DependencyGraph.

The port of fantoch_tpu/executor/graph/batched.py.  ``BatchedDependencyGraph``
is a drop-in for the host-oracle ``DependencyGraph`` at the same seam
(``Config.batched_graph_executor``).  Commands cross the boundary as arrays
(``handle_add_arrays`` appends whole commit buffers; the (dot, cmd, deps)
tuple APIs are thin converters) into an append-only column backlog.

Resolution is lazy: adds mark the backlog dirty and the resolve runs once
per output drain (``commands_to_execute`` & friends).  Two routes:

* the device-resident plane (``Config.device_graph_plane``): each drain
  feeds the backlog to ``executor/graph/graph_plane.py`` as ONE dispatch;
* the host-column route, the default: each drain maps the backlog's
  dependency dots to batch slots on the host, uploads the columns to the
  graph's device once, resolves them with the port's kernels
  (``resolve_keyed_auto`` for single-key functional batches, padded to a
  power of two with private pad keys; ``resolve_general_resident`` for
  large multi-key batches; ``resolve_general`` for small ones), fetches the
  results in one copy, and finishes ``stuck`` residues (rare 3+-cycles) on
  the Python Tarjan oracle.  ``Config.host_native_resolver=True`` resolves
  the whole backlog with the native C++ Tarjan (``native/``) instead: for a
  deployment with no card (``device="cpu"``), where the JAX package picks
  it by default; nothing in the port sets it.

Either way, with nothing pending, a large backlog whose every dependency
points backwards and none is missing is already in execution order and
emits host-side with no resolve (the arrival-order fast path).

Per-key execution order is identical to the host oracle's: conflicting
commands are always dependency-linked, so their relative order is forced
by the condensation topology (or by dot order inside an SCC).

Partial replication (``shard_count > 1``, host-column route only): the
backlog keeps the original ``Dependency`` objects per row; after a
resolve, MISSING deps whose shard set excludes this shard produce one info
request each to the dep's target shard (index.rs:171-205), and the
secondary (request-serving) executor answers peer shards straight from the
primary's backlog, pending rows included (mod.rs:300-375).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind
from fantoch_tpu_torch.executor.device_plane import resolve_device
from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
from fantoch_tpu_torch.executor.graph.graph_plane import (
    DeviceGraphPlane,
    graph_plane_enabled,
)
from fantoch_tpu_torch.ops.frontier import DeviceFrontier, pack_dots
from fantoch_tpu_torch.ops.graph_resolve import (
    MISSING,
    TERMINAL,
    _pow2_at_least,
    resolve_general,
    resolve_general_resident,
    resolve_keyed_auto,
)
from fantoch_tpu_torch.utils import key_hash as _framework_key_hash

_NO_DEP = np.int64(-1)  # packed-dep sentinel: no dependency in this slot
# the built-in DEFAULT of the kernel-size gate: Config.graph_kernel_threshold
# beats the FANTOCH_GRAPH_KERNEL_THRESHOLD env var beats this value; below
# it the keyed route asks for full structure (exact CHAIN_SIZE) and the
# arrival-order fast path stays off, above it the multi-key route takes the
# peel-and-compact resolver
_STRUCTURE_THRESHOLD = 4096


def key_hash(key: str) -> int:
    """Stable 31-bit conflict-key hash: the framework-wide key hash folded
    to int32 range for the device kernels.  Collisions only cost resolver
    performance, not correctness."""
    return _framework_key_hash(key) & 0x7FFFFFFF


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Result columns as host numpy in ONE device-to-host copy: each is
    flattened to int32 and the pieces concatenated on their device first
    (bool columns come back bool)."""
    host = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        piece = host[at : at + t.numel()].reshape(t.shape)
        out.append(piece.astype(bool) if t.dtype == torch.bool else piece)
        at += t.numel()
    return out


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
    """DependencyGraph whose ordering core is the batched resolver."""

    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, config: Config,
        *, device=None,
    ):
        """``device`` is where the resolves run (default ``cuda``; without
        CUDA and without an explicit device this raises)."""
        super().__init__(process_id, shard_id, config)
        self._array_mode = True
        self._multi_shard = config.shard_count > 1
        if self._multi_shard:
            # multi-shard bookkeeping (single-shard pays none of this):
            # packed dot -> (cmd, deps) for request serving from the
            # backlog; packed dep dot -> shard set; the set of remote deps
            # already requested; the primary graph a secondary serves from
            self._by_dot: dict = {}
            self._dep_shards: dict = {}
            self._requested: set = set()
            self._primary: Optional["BatchedDependencyGraph"] = None
        if config.device_graph_plane and self._multi_shard:
            raise ValueError(
                "device_graph_plane requires shard_count == 1 (the backlog "
                "plane keeps no per-dep shard sets)"
            )
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
        self._plane = None
        self._native = bool(config.host_native_resolver)
        if graph_plane_enabled(config) and not self._multi_shard:
            self._plane = DeviceGraphPlane(
                process_id, shard_id, config, self._frontier, self._metrics,
                structure_threshold=self._structure_threshold,
                device=device,
            )
            # arm the fault detector (deadline + shadow-check) from the config
            self._plane.configure_faults(config, process_id=process_id)
        elif not self._native:
            self._device = resolve_device(device)
        # host-column flushes by route ("fast", "native", "keyed",
        # "general_resident", "general"), read by the
        # chip smoke and the tests
        self.routes: Counter = Counter()
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
        assert not self._multi_shard, (
            "array adds carry no shard sets; multi-shard commits arrive as "
            "per-command GraphAdd (graph_protocol.py commit buffer gating)"
        )
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
        if self._multi_shard:
            # shard sets must survive: cross-shard requests need them, and
            # request replies forward the full Dependency list
            self._by_dot[(int(dot.source) << 32) | int(dot.sequence)] = (
                cmd, list(deps)
            )
            for d in deps:
                if d.shards is not None:
                    self._dep_shards.setdefault(
                        (int(d.dot.source) << 32) | int(d.dot.sequence),
                        d.shards,
                    )
        self._backlog.append_one(
            int(dot.source), int(dot.sequence), khash, float(time.millis()), packed, cmd
        )

    # --- executed notifications / request replies ---

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
        if self._plane is not None:
            # the plane's waiter index patches every MISSING cell waiting
            # on the noop dot to TERMINAL on the next dispatch
            self._plane.note_noop(int(dot.source), int(dot.sequence))
        super().handle_noop(dot, time)

    def handle_request_reply(self, infos, time: SysTime) -> None:
        from fantoch_tpu_torch.executor.graph.deps_graph import RequestReplyInfo

        for info in infos:
            if isinstance(info, RequestReplyInfo):
                self.handle_add(info.dot, info.cmd, info.deps, time)
            else:
                self._frontier.add(info.dot.source, info.dot.sequence)
                self._added_to_executed_clock.add(info.dot)
                packed = (int(info.dot.source) << 32) | int(info.dot.sequence)
                self._dep_shards.pop(packed, None)
                self._requested.discard(packed)
                self._dirty = True

    # --- cross-shard request serving (secondary executor; mod.rs:300-375) ---

    def share_vertex_index(self, primary: "DependencyGraph") -> None:
        super().share_vertex_index(primary)
        if self._multi_shard:
            self._primary = primary  # serve requests from the array backlog

    def process_requests(self, from_shard: ShardId, dots, time: SysTime) -> None:
        """Answer a peer shard's dependency-info request from the primary's
        array backlog — including rows still *pending* there (answering
        only executed dots deadlocks cross-shard dependency cycles)."""
        assert self.executor_index > 0
        from fantoch_tpu_torch.executor.graph.deps_graph import (
            RequestReplyExecuted,
            RequestReplyInfo,
        )

        source = self._primary if self._primary is not None else self
        for dot in dots:
            packed = (int(dot.source) << 32) | int(dot.sequence)
            entry = source._by_dot.get(packed)
            if entry is not None:
                cmd, deps = entry
                assert not cmd.replicated_by(from_shard), (
                    f"{dot} is replicated by requesting shard {from_shard}"
                )
                self._out_request_replies.setdefault(from_shard, []).append(
                    RequestReplyInfo(dot, cmd, deps)
                )
            elif self._frontier.contains(dot.source, dot.sequence) or (
                source is not self
                and source._frontier.contains(dot.source, dot.sequence)
            ):
                self._out_request_replies.setdefault(from_shard, []).append(
                    RequestReplyExecuted(dot)
                )
            else:
                # not known yet: buffer and retry on cleanup
                self._buffered_in_requests.setdefault(from_shard, set()).add(dot)

    def _note_emitted(self, src_rows, seq_rows) -> None:
        """Multi-shard emit bookkeeping: drop served entries (and the
        request/shard-set records for executed deps — the PendingIndex
        removes on execution too, index.rs remove) and record the executed
        dots for the GraphExecuted broadcast (to_executors)."""
        if not self._multi_shard:
            return
        for p in pack_dots(src_rows, seq_rows).tolist():
            self._by_dot.pop(p, None)
            self._dep_shards.pop(p, None)
            self._requested.discard(p)
            self._added_to_executed_clock.add(Dot(p >> 32, p & 0xFFFFFFFF))

    def _request_missing(self, dep_rows, deps, remaining_mask) -> None:
        """One info request per first-sighted missing dep whose shard set
        excludes this shard (PendingIndex.index semantics,
        index.rs:171-205); local missing deps arrive via local commits."""
        miss_slots = (dep_rows == MISSING) & remaining_mask[:, None]
        if not miss_slots.any():
            return
        requests = 0
        for packed in np.unique(deps[miss_slots]).tolist():
            if packed in self._requested:
                continue
            self._requested.add(packed)
            shards = self._dep_shards.get(packed)
            if shards is None or self._shard_id in shards:
                continue
            dot = Dot(packed >> 32, packed & 0xFFFFFFFF)
            self._out_requests.setdefault(
                dot.target_shard(self._config.n), set()
            ).add(dot)
            requests += 1
        if requests:
            self._metrics.aggregate(ExecutorMetricsKind.OUT_REQUESTS, requests)

    # --- lazy resolution at the output drains ---

    def command_to_execute(self) -> Optional[Command]:
        self._flush()
        return super().command_to_execute()

    def commands_to_execute(self) -> List[Command]:
        self._flush()
        return super().commands_to_execute()

    def monitor_pending(self, time: SysTime):
        self._flush(time)
        if self._plane is not None:
            return self._plane.monitor_pending(time)
        # liveness watchdog (index.rs:53-103): after a resolve, every
        # still-pending row must be *transitively* missing-blocked — the
        # resolvers emit everything else.  An old row whose dependency
        # closure contains no missing dep means an execution was lost:
        # panic naming the dots, like the reference's pending monitor.
        if not self._backlog.count:
            return None
        src, seq, _key, tms, deps = self._backlog.columns()
        from fantoch_tpu_torch.executor.graph.indexes import (
            MONITOR_PENDING_THRESHOLD_MS,
        )

        pending_for = float(time.millis()) - tms
        old = pending_for >= MONITOR_PENDING_THRESHOLD_MS
        # the bounded-wait mask has its own (possibly lower) threshold —
        # it must not loosen the lost-execution check, which stays on `old`
        fail_ms = self._config.executor_pending_fail_ms
        ripe = pending_for >= fail_ms if fail_ms is not None else None
        if not old.any() and (ripe is None or not ripe.any()):
            return None
        dep_rows = self._map_deps(src, seq, deps)
        batch = len(src)
        blocked = (dep_rows == MISSING).any(axis=1)
        # missing dependency dots of old blocked rows: returned so the
        # runner can nudge the protocol's recovery plane
        nudge = {
            Dot(int(d) >> 32, int(d) & 0xFFFFFFFF)
            for i in np.nonzero(blocked & old)[0]
            for d, r in zip(deps[i], dep_rows[i])
            if r == MISSING and d >= 0
        }
        # bounded wait (Config.executor_pending_fail_ms): a row blocked on
        # a missing dependency past the fail bound raises a typed error
        if ripe is not None:
            stalled = blocked & ripe
            if stalled.any():
                missing_map = {}
                for i in np.nonzero(stalled)[0][:8]:
                    missing_map[Dot(int(src[i]), int(seq[i]))] = {
                        Dot(int(d) >> 32, int(d) & 0xFFFFFFFF)
                        for d, r in zip(deps[i], dep_rows[i])
                        if r == MISSING and d >= 0
                    }
                from fantoch_tpu_torch.errors import StalledExecutionError

                raise StalledExecutionError(
                    self._process_id,
                    missing_map,
                    int(pending_for[stalled].max()),
                    self._config.recovery_delay_ms,
                )
        # forward-propagate blockedness to dependents, with an early exit
        # the moment every old row is covered
        valid = dep_rows >= 0
        safe = np.clip(dep_rows, 0, batch - 1)
        while True:
            lost = old & ~blocked
            if not lost.any():
                return nudge
            grown = blocked | np.where(valid, blocked[safe], False).any(axis=1)
            if (grown == blocked).all():
                break
            blocked = grown
        dots = [Dot(int(src[i]), int(seq[i])) for i in np.nonzero(lost)[0][:8]]
        raise AssertionError(
            f"p{self._process_id}: {int(lost.sum())} commands pending "
            f"without missing dependencies: {dots}"
        )

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
            if self._plane is not None and self._plane.has_patches:
                # patches with no new feed (noop resolutions): the plane
                # still needs one dispatch to wake waiting residents
                self._plane.flush(time)
                self._drain_plane_emissions()
            return
        # a profiler span around the whole resolve (a no-op unless a
        # torch.profiler session is recording)
        with record_function("graph_resolve"):
            if self._plane is not None:
                self._resolve_backlog_plane(time)
            else:
                self._resolve_backlog_inner(time)

    def _resolve_native(self, dep_rows, src, seq, batch):
        """Whole-backlog resolve on the native host Tarjan (CSR over the
        already-joined dep slots; TERMINAL pruned, MISSING kept as -2).
        Returns the emitted rows; never leaves stuck residues (a full
        Tarjan resolves every non-missing-blocked SCC)."""
        from fantoch_tpu_torch import native

        mask = dep_rows != TERMINAL
        counts = mask.sum(axis=1, dtype=np.int64)
        offsets = np.zeros(batch + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        targets = dep_rows[mask].astype(np.int32)  # row-major slot order
        order, sizes = native.resolve_sccs(
            offsets.astype(np.int32), targets, pack_dots(src, seq)
        )
        if batch <= self._structure_threshold and len(order):
            # exact CHAIN_SIZE only at small sizes (the walk is O(#SCCs)
            # Python — the keyed route's want_structure gating)
            pos, scc_sizes = 0, []
            while pos < len(order):
                scc_sizes.append(int(sizes[pos]))
                pos += int(sizes[pos])
            self._metrics.collect_many(ExecutorMetricsKind.CHAIN_SIZE, scc_sizes)
        return order.astype(np.int64)

    def _resolve_backlog_inner(self, time: SysTime) -> None:
        """The host-column route: one resolve over the whole backlog."""
        src, seq, key, tms, deps = self._backlog.columns()
        batch = len(src)
        dep_rows = self._map_deps(src, seq, deps)

        # host arrival-order fast path: when every in-batch dependency
        # points at an *earlier* row and nothing is missing, the graph is a
        # DAG whose arrival order is already a valid execution order.
        # Gated to large batches so small (sim/test) batches keep exact
        # CHAIN_SIZE structure from the full resolvers.
        if (
            batch > self._structure_threshold
            and bool((dep_rows < np.arange(batch, dtype=np.int32)[:, None]).all())
            and not bool((dep_rows == MISSING).any())
        ):
            self.routes["fast"] += 1
            if self.record_order_arrays:
                self._order_arrays.append((src, seq))
            else:
                self._to_execute.extend(self._backlog.cmds)
            self._frontier.add_batch(src, seq)
            self._note_emitted(src, seq)
            now = float(time.millis())
            self._metrics.collect_many(
                ExecutorMetricsKind.EXECUTION_DELAY, np.maximum(now - tms, 0.0)
            )
            self._backlog.replace(
                src[:0], seq[:0], key[:0], tms[:0], deps[:0], []
            )
            return

        if self._native:
            self.routes["native"] += 1
            emitted = self._resolve_native(dep_rows, src, seq, batch)
            remaining_mask = np.ones(batch, dtype=bool)
            if len(emitted):
                self._emit_rows(emitted, src, seq, tms, time)
                remaining_mask[emitted] = False
            self._shrink_backlog(remaining_mask, src, seq, key, tms, deps, dep_rows)
            return

        # compress to functional form when every row has <= 1 live dep
        live = dep_rows != TERMINAL
        live_counts = live.sum(axis=1)
        functional = bool((live_counts <= 1).all())
        src32 = src.astype(np.int32)
        seq32 = (seq - seq.min()).astype(np.int32)
        dev = self._device

        def upload(*cols):
            return [torch.tensor(c, device=dev) for c in cols]

        stuck_rows = None
        if functional and bool((key >= 0).all()):
            self.routes["keyed"] += 1
            col = np.where(
                live_counts > 0,
                dep_rows[np.arange(batch), np.argmax(live, axis=1)],
                TERMINAL,
            ).astype(np.int32)
            # pad to pow2 (the reference's compiled-shape padding; the port
            # keeps it so both resolve identical columns).  Distinct private
            # pad keys: each pad row is its own single-row run, resolves as
            # a singleton and is filtered out of the emitted prefix
            padded_b = _pow2_at_least(batch)
            pk = np.iinfo(np.int32).max - np.arange(padded_b, dtype=np.int32)
            pc = np.full(padded_b, TERMINAL, dtype=np.int32)
            ps = np.zeros(padded_b, np.int32)
            pq = np.zeros(padded_b, np.int32)
            pk[:batch] = key
            pc[:batch] = col
            ps[:batch] = src32
            pq[:batch] = seq32
            want_structure = batch <= self._structure_threshold
            res = resolve_keyed_auto(
                *upload(pk, pc, ps, pq), return_structure=want_structure
            )
            if want_structure:
                order, n_res, leader = _fetch(res.order, res.n_resolved, res.leader)
            else:
                order, n_res = _fetch(res.order, res.n_resolved)
            emitted = order[: int(n_res)]
            emitted = emitted[emitted < batch]  # drop resolved pad rows
            if want_structure and len(emitted):
                self._collect_chain_sizes(leader[emitted])
        elif batch > self._structure_threshold:
            # large multi-key batch: the peel-and-compact peeler's cost
            # tracks the per-level live set instead of B x depth
            self.routes["general_resident"] += 1
            mat, ps, pq = _padded_general(dep_rows, src32, seq32)
            res = resolve_general_resident(*upload(mat, ps, pq))
            order, resolved, stuck = _fetch(res.order, res.resolved, res.stuck)
            order = order[order < batch]
            emitted = order[resolved[order]]
            stuck = stuck[:batch]
            stuck_rows = np.nonzero(stuck)[0] if stuck.any() else None
        else:
            self.routes["general"] += 1
            mat, ps, pq = _padded_general(dep_rows, src32, seq32)
            # resolve_general's fast-path test (every dependency backward,
            # none missing; _map_deps pruned self-dependencies), counted on
            # the host columns
            rows = np.arange(mat.shape[0], dtype=np.int32)[:, None]
            n_bad = int(((mat > rows) | (mat == MISSING)).sum())
            res = resolve_general(*upload(mat, ps, pq), n_bad=n_bad)
            order, resolved, stuck, leader = _fetch(
                res.order, res.resolved, res.stuck, res.leader
            )
            order = order[order < batch]
            emitted = order[resolved[order]]
            stuck = stuck[:batch]
            stuck_rows = np.nonzero(stuck)[0] if stuck.any() else None
            if len(emitted):
                self._collect_chain_sizes(leader[emitted])

        remaining_mask = np.ones(batch, dtype=bool)
        if len(emitted):
            emitted = emitted.astype(np.int64)
            self._emit_rows(emitted, src, seq, tms, time)
            remaining_mask[emitted] = False

        if stuck_rows is not None and len(stuck_rows):
            stuck_rows = _close_stuck_set(stuck_rows, dep_rows, remaining_mask)
        if stuck_rows is not None and len(stuck_rows):
            oracle_emitted = self._resolve_stuck_rows(
                stuck_rows, src, seq, deps, tms, time
            )
            remaining_mask[oracle_emitted] = False

        self._shrink_backlog(remaining_mask, src, seq, key, tms, deps, dep_rows)

    def _collect_chain_sizes(self, leaders: np.ndarray) -> None:
        """One CHAIN_SIZE sample per SCC: the emitted rows' leaders change
        at every SCC boundary."""
        n = len(leaders)
        sizes = np.diff(
            np.concatenate([[0], np.nonzero(np.diff(leaders))[0] + 1, [n]])
        )
        self._metrics.collect_many(ExecutorMetricsKind.CHAIN_SIZE, sizes)

    def _shrink_backlog(
        self, remaining_mask, src, seq, key, tms, deps, dep_rows=None
    ) -> None:
        if self._multi_shard and dep_rows is not None:
            self._request_missing(dep_rows, deps, remaining_mask)
        if self._multi_shard and len(self._dep_shards) > 4 * max(
            int(remaining_mask.sum()), 64
        ):
            # amortized GC of the dep-shard / requested records: only deps
            # still referenced by surviving rows matter (a dep that
            # executed before its dependent arrived would otherwise leak
            # forever — _note_emitted only covers locally emitted dots).
            # Dropping an in-flight request record at worst re-requests.
            live = set(deps[remaining_mask][deps[remaining_mask] >= 0].tolist())
            self._dep_shards = {
                p: s for p, s in self._dep_shards.items() if p in live
            }
            self._requested &= live
        keep = np.nonzero(remaining_mask)[0]
        cmds = self._backlog.cmds
        self._backlog.replace(
            src[keep],
            seq[keep],
            key[keep],
            tms[keep],
            deps[keep],
            [cmds[i] for i in keep],
        )

    def _emit_rows(self, rows: np.ndarray, src, seq, tms, time: SysTime) -> None:
        if self.record_order_arrays:
            # array-native consumer: the execution order leaves as columns
            self._order_arrays.append((src[rows], seq[rows]))
        else:
            cmds = self._backlog.cmds
            # map + tolist: ~3x faster than a genexpr with ndarray indices
            # at 250k rows (list.__getitem__ on ints, one C-level loop)
            self._to_execute.extend(map(cmds.__getitem__, rows.tolist()))
        self._frontier.add_batch(src[rows], seq[rows])
        self._note_emitted(src[rows], seq[rows])
        now = float(time.millis())
        self._metrics.collect_many(
            ExecutorMetricsKind.EXECUTION_DELAY, np.maximum(now - tms[rows], 0.0)
        )

    def _resolve_stuck_rows(
        self, stuck_rows, src, seq, deps, tms, time: SysTime
    ) -> np.ndarray:
        """The Python Tarjan oracle over the stuck residue (dep-closed by
        ``_close_stuck_set``): rebuild the subgraph with deps restricted to
        stuck members (everything else the device either emitted before
        them or left missing-blocked) and run it to completion.  (The JAX
        package prefers its native resolver here when it builds; in the
        port the native route, when selected, resolves the whole backlog
        and leaves no stuck residue.)"""
        from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

        stuck_set = {
            (int(src[i]) << 32) | int(seq[i]): int(i) for i in stuck_rows
        }
        oracle = DependencyGraph(self._process_id, self._shard_id, self._config)
        shards = frozenset({self._shard_id})
        cmds = self._backlog.cmds
        emitted_rows: List[int] = []
        row_of = {id(cmds[int(i)]): int(i) for i in stuck_rows}
        for i in stuck_rows:
            i = int(i)
            dot = Dot(int(src[i]), int(seq[i]))
            dep_list = [
                Dependency(Dot(int(p >> 32), int(p & 0xFFFFFFFF)), shards)
                for p in deps[i]
                if int(p) in stuck_set
            ]
            oracle.handle_add(dot, cmds[i], dep_list, time)
            for done in oracle.commands_to_execute():
                r = row_of[id(done)]
                emitted_rows.append(r)
                self._metrics.collect(
                    ExecutorMetricsKind.EXECUTION_DELAY,
                    max(int(time.millis() - tms[r]), 0),
                )
                if self.record_order_arrays:
                    self._order_arrays.append((src[r : r + 1], seq[r : r + 1]))
                else:
                    self._to_execute.append(done)
        chain_hist = oracle.metrics().get_collected(ExecutorMetricsKind.CHAIN_SIZE)
        if chain_hist is not None:
            from fantoch_tpu_torch.core.metrics import Histogram

            self._metrics.collected.setdefault(
                ExecutorMetricsKind.CHAIN_SIZE, Histogram()
            ).merge(chain_hist)
        rows = np.array(emitted_rows, dtype=np.int64)
        if len(rows):
            self._frontier.add_batch(src[rows], seq[rows])
            self._note_emitted(src[rows], seq[rows])
        assert len(rows) == len(stuck_rows), (
            f"stuck residue not fully resolvable: {len(rows)}/{len(stuck_rows)}"
        )
        return rows

    # --- the device-resident backlog plane (Config.device_graph_plane) ---

    def _resolve_backlog_plane(self, time: SysTime) -> None:
        """One resident dispatch per flush: the feed columns transfer
        into the plane (new-row deltas are the only host->device traffic)
        and the whole pending window re-resolves in place.  The
        arrival-order fast path is preserved: with nothing resident, a
        backward-only no-missing feed emits host-side with zero
        dispatches, exactly like the host-column route."""
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


def _padded_general(dep_rows, src32, seq32):
    """The multi-key columns padded to powers of two (rows and width), pad
    cells TERMINAL: pad rows resolve as rank-0 singletons and are dropped
    from the emitted prefix."""
    batch = dep_rows.shape[0]
    padded_b = _pow2_at_least(batch)
    padded_w = _pow2_at_least(max(dep_rows.shape[1], 1))
    mat = np.full((padded_b, padded_w), TERMINAL, dtype=np.int32)
    mat[:batch, : dep_rows.shape[1]] = dep_rows
    ps = np.zeros(padded_b, np.int32)
    pq = np.zeros(padded_b, np.int32)
    ps[:batch] = src32
    pq[:batch] = seq32
    return mat, ps, pq


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
