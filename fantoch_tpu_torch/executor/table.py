"""TableExecutor: timestamp-stability ordering for Newt/Tempo.

The port of fantoch_tpu/executor/table.py.  Reference: fantoch_ps/src/executor/table/{mod,executor}.rs.  Commands carry
a timestamp (clock) and the votes consumed while computing it; a per-key
``VotesTable`` buffers ops sorted by ``(clock, dot)`` and executes every op
whose sort id is below the *stable clock* — the
``(n - stability_threshold)``-th smallest per-process vote frontier, i.e.
the timestamp such that at least ``stability_threshold`` processes have
voted all timestamps up to it, so no new command can be assigned a lower
one (mod.rs:247-270).

Tensor note: per-key frontiers are one ``int32[K, n]`` tensor on the card
and the stable clock one order statistic along the process axis (see
ops/table_ops.py); this host twin keys tables lazily for the simulator and
runner control plane.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from itertools import repeat
from typing import Deque, Dict, List, Optional, Tuple

from fantoch_tpu_torch.core.clocks import RangeEventSet
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import Dot, ProcessId, Rifl, ShardId, process_ids
from fantoch_tpu_torch.core.kvs import Key, KVOp, KVOpKind, KVStore
from fantoch_tpu_torch.executor.base import Executor, ExecutorResult
from fantoch_tpu_torch.protocol.common.table_clocks import VoteRange

# ops with equal clocks are tie-broken by dot (mod.rs:18 ``SortId``)
SortId = Tuple[int, Dot]


@dataclass
class TableVotes:
    """TableExecutionInfo::Votes (executor.rs:121-129)."""

    dot: Dot
    clock: int
    rifl: Rifl
    key: Key
    ops: Tuple[KVOp, ...]
    votes: List[VoteRange]


@dataclass
class TableDetachedVotes:
    """TableExecutionInfo::DetachedVotes (executor.rs:130-133)."""

    key: Key
    votes: List[VoteRange]


@dataclass
class TableVotesArrays:
    """Array-borne TableVotes batch: B committed rows and
    V vote ranges as columns — the whole proposal->stability->execution
    flow stays in arrays; Rifl/ExecutorResult objects materialize only at
    the client boundary.  Pairs with
    ``BatchedKeyClocks.proposal_batch_arrays``.

    ``vote_row`` ties each vote range to the row whose key it covers
    (coordinator + quorum votes ride with their command, as in MCommit —
    fantoch_ps/src/protocol/newt.rs commit path); detached votes ride the
    optional ``det_*`` columns (one entry per detached vote range,
    ``det_keys`` naming the key directly since there is no row)."""

    keys: List[Key]  # row -> key string
    dot_src: "np.ndarray"  # int64[B]
    dot_seq: "np.ndarray"  # int64[B]
    clock: "np.ndarray"  # int64[B]
    rifl_src: "np.ndarray"  # int64[B]
    rifl_seq: "np.ndarray"  # int64[B]
    ops: List[Tuple[KVOp, ...]]  # row -> command payload
    vote_row: "np.ndarray"  # int64[V] -> row index
    vote_by: "np.ndarray"  # int64[V] process id
    vote_start: "np.ndarray"  # int64[V]
    vote_end: "np.ndarray"  # int64[V]
    det_keys: Optional[List[Key]] = None  # detached vote -> key string
    det_by: Optional["np.ndarray"] = None  # int64[D]
    det_start: Optional["np.ndarray"] = None  # int64[D]
    det_end: Optional["np.ndarray"] = None  # int64[D]


class TableVotesArraysBuilder:
    """Column accumulator for the array-native commit seam: protocols
    (Newt's MCommit path) and the device-plane object converter append
    committed rows / detached votes and flush ONE ``TableVotesArrays``
    per drain — no per-command ``TableVotes`` dataclasses on the batched
    path."""

    __slots__ = (
        "_keys", "_dot_src", "_dot_seq", "_clock", "_rifl_src", "_rifl_seq",
        "_ops", "_vrow", "_vby", "_vstart", "_vend",
        "_dkeys", "_dby", "_dstart", "_dend",
    )

    def __init__(self) -> None:
        self._keys: List[Key] = []
        self._dot_src: List[int] = []
        self._dot_seq: List[int] = []
        self._clock: List[int] = []
        self._rifl_src: List[int] = []
        self._rifl_seq: List[int] = []
        self._ops: List[Tuple[KVOp, ...]] = []
        self._vrow: List[int] = []
        self._vby: List[int] = []
        self._vstart: List[int] = []
        self._vend: List[int] = []
        self._dkeys: List[Key] = []
        self._dby: List[int] = []
        self._dstart: List[int] = []
        self._dend: List[int] = []

    def add_row(
        self,
        dot: Dot,
        clock: int,
        rifl: Rifl,
        key: Key,
        ops: Tuple[KVOp, ...],
        votes,
    ) -> None:
        row = len(self._keys)
        self._keys.append(key)
        self._dot_src.append(dot.source)
        self._dot_seq.append(dot.sequence)
        self._clock.append(clock)
        self._rifl_src.append(rifl.source)
        self._rifl_seq.append(rifl.sequence)
        self._ops.append(ops)
        for vote in votes:
            self._vrow.append(row)
            self._vby.append(vote.by)
            self._vstart.append(vote.start)
            self._vend.append(vote.end)

    def add_detached(self, key: Key, votes) -> None:
        for vote in votes:
            self._dkeys.append(key)
            self._dby.append(vote.by)
            self._dstart.append(vote.start)
            self._dend.append(vote.end)

    def __len__(self) -> int:
        return len(self._keys) + len(self._dkeys)

    def take(self) -> Optional[TableVotesArrays]:
        """Build the accumulated batch and reset; None when empty."""
        import numpy as np

        if not self._keys and not self._dkeys:
            return None
        batch = TableVotesArrays(
            keys=self._keys,
            dot_src=np.asarray(self._dot_src, dtype=np.int64),
            dot_seq=np.asarray(self._dot_seq, dtype=np.int64),
            clock=np.asarray(self._clock, dtype=np.int64),
            rifl_src=np.asarray(self._rifl_src, dtype=np.int64),
            rifl_seq=np.asarray(self._rifl_seq, dtype=np.int64),
            ops=self._ops,
            vote_row=np.asarray(self._vrow, dtype=np.int64),
            vote_by=np.asarray(self._vby, dtype=np.int64),
            vote_start=np.asarray(self._vstart, dtype=np.int64),
            vote_end=np.asarray(self._vend, dtype=np.int64),
            det_keys=self._dkeys or None,
            det_by=np.asarray(self._dby, dtype=np.int64) if self._dkeys else None,
            det_start=(
                np.asarray(self._dstart, dtype=np.int64) if self._dkeys else None
            ),
            det_end=np.asarray(self._dend, dtype=np.int64) if self._dkeys else None,
        )
        self.__init__()
        return batch


TableExecutionInfo = object  # TableVotes | TableDetachedVotes | TableVotesArrays


class VotesTable:
    """Single-key table: vote frontiers per process + clock-sorted op buffer
    (mod.rs:104-270)."""

    __slots__ = ("key", "process_id", "n", "stability_threshold", "_votes", "_ops")

    def __init__(
        self,
        key: Key,
        process_id: ProcessId,
        shard_id: ShardId,
        n: int,
        stability_threshold: int,
    ):
        assert stability_threshold <= n, (
            "stability threshold must always be at most the number of processes"
        )
        self.key = key
        self.process_id = process_id
        self.n = n
        self.stability_threshold = stability_threshold
        self._votes: Dict[ProcessId, RangeEventSet] = {
            pid: RangeEventSet() for pid in process_ids(shard_id, n)
        }
        self._ops: List[Tuple[SortId, Rifl, Tuple[KVOp, ...]]] = []

    def add(
        self,
        dot: Dot,
        clock: int,
        rifl: Rifl,
        ops: Tuple[KVOp, ...],
        votes: List[VoteRange],
    ) -> None:
        self.add_op(dot, clock, rifl, ops)
        self.add_votes(votes)

    def add_op(
        self, dot: Dot, clock: int, rifl: Rifl, ops: Tuple[KVOp, ...]
    ) -> None:
        sort_id = (clock, dot)
        entry = (sort_id, rifl, ops)
        pos = bisect_left(self._ops, entry)
        # duplicate (clock, dot) check in O(log): only a sort_id-equal
        # neighbor could collide
        assert not (
            pos < len(self._ops) and self._ops[pos][0] == sort_id
        ) and not (pos > 0 and self._ops[pos - 1][0] == sort_id), (
            "two commands cannot occupy the same (clock, dot) slot"
        )
        self._ops.insert(pos, entry)

    def add_votes(self, votes: List[VoteRange]) -> None:
        for vote in votes:
            self._votes[vote.by].add_range(vote.start, vote.end)

    def stable_ops(self) -> List[Tuple[Rifl, Tuple[KVOp, ...]]]:
        """Pop every op with sort id strictly below
        ``(stable_clock + 1, first dot)`` — i.e. with clock <= stable_clock
        (mod.rs:200-244; the reference's split_off keeps ops at the bound
        buffered)."""
        return self.stable_ops_at(self.stable_clock())

    def stable_ops_at(
        self, stable_clock: int
    ) -> List[Tuple[Rifl, Tuple[KVOp, ...]]]:
        """stable_ops with a precomputed stable clock (the batched path
        computes all keys' clocks in one kernel and pops per key)."""
        next_stable: SortId = (stable_clock + 1, Dot(1, 1))
        cut = bisect_left(self._ops, (next_stable,))
        stable = [(rifl, ops) for _, rifl, ops in self._ops[:cut]]
        del self._ops[:cut]
        return stable

    def stable_clock(self) -> int:
        """(n - threshold)-th smallest per-process vote frontier
        (mod.rs:247-270)."""
        frontiers = sorted(es.frontier for es in self._votes.values())
        return frontiers[self.n - self.stability_threshold]

    def frontier_row(self) -> List[int]:
        """Per-process vote frontiers in fixed process order (one row of
        the batched ``int32[K, n]`` frontier matrix)."""
        return [es.frontier for es in self._votes.values()]


class MultiVotesTable:
    """Lazily-keyed map of VotesTable (mod.rs:21-102)."""

    __slots__ = ("process_id", "shard_id", "n", "stability_threshold", "_tables")

    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, n: int, stability_threshold: int
    ):
        self.process_id = process_id
        self.shard_id = shard_id
        self.n = n
        self.stability_threshold = stability_threshold
        self._tables: Dict[Key, VotesTable] = {}

    def add_votes(
        self,
        dot: Dot,
        clock: int,
        rifl: Rifl,
        key: Key,
        ops: Tuple[KVOp, ...],
        votes: List[VoteRange],
    ) -> List[Tuple[Rifl, Tuple[KVOp, ...]]]:
        table = self._table(key)
        table.add(dot, clock, rifl, ops, votes)
        return table.stable_ops()

    def add_detached_votes(
        self, key: Key, votes: List[VoteRange]
    ) -> List[Tuple[Rifl, Tuple[KVOp, ...]]]:
        table = self._table(key)
        table.add_votes(votes)
        return table.stable_ops()

    def _table(self, key: Key) -> VotesTable:
        table = self._tables.get(key)
        if table is None:
            table = VotesTable(
                key, self.process_id, self.shard_id, self.n, self.stability_threshold
            )
            self._tables[key] = table
        return table


class TableExecutor(Executor):
    """Executes ops as their timestamps become stable (executor.rs:14-120).

    With ``Config.batched_table_executor`` the per-info stability check is
    replaced by one vectorized pass per batch: votes and ops buffer first,
    then every touched key's stable clock comes out of a single
    ``(n - threshold)``-th order statistic over the frontier matrix — the
    :func:`fantoch_tpu_torch.ops.table_ops.stable_clocks` kernel at device
    scale, a numpy partition below it (identical semantics; kernel
    dispatch only pays off across many keys).

    ``device`` is the card of the votes-table plane and of that kernel
    (default ``cuda``; without CUDA and without an explicit device, the
    plane raises when it is built and the kernel route when it is taken)."""

    # frontier-matrix element count (keys x n) at which the device kernel
    # beats host numpy: an order statistic over 3-5 columns is a few ns/row
    # on host, so the dispatch only amortizes at millions of elements.
    # Default for Config.table_kernel_threshold = None without an env
    # override (FANTOCH_TABLE_KERNEL_THRESHOLD)
    _KERNEL_THRESHOLD = 1 << 20

    @classmethod
    def _resolve_kernel_threshold(cls, config: Config) -> int:
        from fantoch_tpu_torch.executor.device_plane import resolve_threshold

        return resolve_threshold(
            config.table_kernel_threshold,
            "FANTOCH_TABLE_KERNEL_THRESHOLD",
            cls._KERNEL_THRESHOLD,
        )

    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, config: Config,
        *, device=None,
    ):
        _, _, stability_threshold = config.newt_quorum_sizes()
        self._device = device
        self._process_id = process_id
        self._execute_at_commit = config.execute_at_commit
        # tracing: which batch drain stabilized each traced command
        self._trace_batch = 0
        self._table = MultiVotesTable(process_id, shard_id, config.n, stability_threshold)
        self._store = KVStore(
            config.executor_monitor_execution_order,
            config.execution_digests,
        )
        self._to_clients: Deque[ExecutorResult] = deque()
        self._batched = config.batched_table_executor
        self._n = config.n
        self._stability_threshold = stability_threshold
        self._kernel_threshold = self._resolve_kernel_threshold(config)
        # device-resident votes-table plane: frontiers live on the card
        # across batches; handle/handle_batch/handle_batch_arrays all
        # route through it so the state never forks (executor/table_plane)
        self._plane = None
        if config.device_table_plane:
            from fantoch_tpu_torch.executor.table_plane import DeviceTablePlane

            self._plane = DeviceTablePlane(
                config.n, stability_threshold, device=device
            )
            # arm the fault detector (deadline + shadow-check) from config;
            # the simulator re-seeds it on top (Executor.device_planes)
            self._plane.configure_faults(config, process_id=process_id)

    def _as_arrays_batches(self, infos):
        """Normalize a mixed info stream into TableVotesArrays batches,
        preserving relative order: consecutive object infos merge into one
        batch; pre-built array batches pass through."""
        builder = TableVotesArraysBuilder()
        for info in infos:
            if isinstance(info, TableVotesArrays):
                merged = builder.take()
                if merged is not None:
                    yield merged
                yield info
            elif isinstance(info, TableVotes):
                builder.add_row(
                    info.dot, info.clock, info.rifl, info.key, info.ops,
                    info.votes,
                )
            elif isinstance(info, TableDetachedVotes):
                builder.add_detached(info.key, info.votes)
            else:
                raise AssertionError(f"unknown table execution info {info}")
        merged = builder.take()
        if merged is not None:
            yield merged

    def handle_batch(self, infos, time) -> None:
        self._trace_batch += 1
        if self._plane is not None and not self._execute_at_commit:
            # device plane: every path funnels through the arrays seam so
            # the resident frontier state never forks from a host twin
            for batch in self._as_arrays_batches(infos):
                self.handle_batch_arrays(batch, time)
            return
        if not self._batched or self._execute_at_commit:
            for info in infos:
                self.handle(info, time)
            return
        arrays = [i for i in infos if isinstance(i, TableVotesArrays)]
        if arrays:
            # array batches ride the info stream (Newt's batched commit
            # seam); peel them off for the arrays path
            for batch in arrays:
                self.handle_batch_arrays(batch, time)
            infos = [i for i in infos if not isinstance(i, TableVotesArrays)]
            if not infos:
                return
        # pass 1 (host): buffer ops and *accumulate* votes — per-(key,
        # process) ranges coalesce before touching the RangeEventSets, so
        # a batch of contiguous proposals costs one add_range, not one per
        # command per voter
        touched: Dict[Key, VotesTable] = {}
        acc: Dict[Tuple[Key, ProcessId], List[Tuple[int, int]]] = {}
        for info in infos:
            if isinstance(info, TableVotes):
                table = self._table._table(info.key)
                table.add_op(info.dot, info.clock, info.rifl, info.ops)
                touched[info.key] = table
                for vote in info.votes:
                    acc.setdefault((info.key, vote.by), []).append(
                        (vote.start, vote.end)
                    )
            elif isinstance(info, TableDetachedVotes):
                touched[info.key] = self._table._table(info.key)
                for vote in info.votes:
                    acc.setdefault((info.key, vote.by), []).append(
                        (vote.start, vote.end)
                    )
            else:
                raise AssertionError(f"unknown table execution info {info}")
        for (key, by), ranges in acc.items():
            events = touched[key]._votes[by]
            ranges.sort()
            start, end = ranges[0]
            for nxt_start, nxt_end in ranges[1:]:
                if nxt_start <= end + 1:
                    end = max(end, nxt_end)
                else:
                    events.add_range(start, end)
                    start, end = nxt_start, nxt_end
            events.add_range(start, end)
        if not touched:
            return
        # pass 2 (vectorized): one stability computation over all touched
        # keys (mod.rs:247-270 across the whole batch)
        import numpy as np

        frontiers = np.array(
            [t.frontier_row() for t in touched.values()], dtype=np.int64
        )
        stable = self._stable_clocks(frontiers)
        for (key, table), clock in zip(touched.items(), stable.tolist()):
            ready = table.stable_ops_at(int(clock))
            if ready:
                self._execute(key, ready)

    def handle_batch_arrays(self, batch: TableVotesArrays, time) -> None:
        """The array-native twin of ``handle_batch``: votes coalesce and
        ops order entirely in numpy (or in ONE fused device dispatch when
        the resident plane is on); per-row Python happens only where a
        result object must exist (KVStore execution).  Semantics are
        identical to feeding the equivalent ``TableVotes`` /
        ``TableDetachedVotes`` infos one by one (oracle-equivalence
        tested)."""
        import numpy as np

        self._trace_batch += 1
        B = len(batch.keys)
        det_keys = batch.det_keys or []
        D = len(det_keys)
        if B == 0 and D == 0:
            return
        if self._execute_at_commit:
            if B:
                order = np.lexsort((batch.dot_seq, batch.dot_src, batch.clock))
                for i in order.tolist():
                    self._execute(
                        batch.keys[i],
                        [(Rifl(int(batch.rifl_src[i]), int(batch.rifl_seq[i])),
                          batch.ops[i])],
                    )
            return
        # row + detached keys share one id space.  First-appearance dict
        # factorization: one dict.get per row (cheaper than np.unique's
        # object-array sort)
        index: Dict[Key, int] = {}
        key_list: List[Key] = []
        all_keys = list(batch.keys) + list(det_keys) if D else batch.keys
        key_ids_all = np.empty(B + D, dtype=np.int64)
        for j, k in enumerate(all_keys):
            idx = index.get(k)
            if idx is None:
                idx = len(key_list)
                index[k] = idx
                key_list.append(k)
            key_ids_all[j] = idx
        key_ids = key_ids_all[:B]

        # 1. vote columns: committed rows' votes + detached votes
        V = len(batch.vote_row)
        vkey = key_ids[batch.vote_row] if V else np.empty(0, np.int64)
        vby = np.asarray(batch.vote_by, dtype=np.int64)
        vs = np.asarray(batch.vote_start, dtype=np.int64)
        ve = np.asarray(batch.vote_end, dtype=np.int64)
        if D:
            vkey = np.concatenate([vkey, key_ids_all[B:]])
            vby = np.concatenate([vby, np.asarray(batch.det_by, np.int64)])
            vs = np.concatenate([vs, np.asarray(batch.det_start, np.int64)])
            ve = np.concatenate([ve, np.asarray(batch.det_end, np.int64)])

        # 2. frontier update + stability over all touched keys in one pass:
        # either the resident device plane (one fused dispatch; VotesTable
        # objects materialize lazily, only where an op tail buffers) or
        # the host RangeEventSets + frontier-matrix rebuild
        if self._plane is not None:
            tables = None
            stable = self._plane_stable(key_list, vkey, vby, vs, ve)
        else:
            tables = {k: self._table._table(k) for k in key_list}
            self._coalesce_votes_host(tables, key_list, vkey, vby, vs, ve)
            frontiers = np.array(
                [tables[k].frontier_row() for k in key_list], dtype=np.int64
            )
            stable = self._stable_clocks(frontiers)

        # 3. ops: (key, clock, dot)-sort the batch once; per key segment,
        # the stable prefix executes straight from the columns and only
        # the unstable tail is object-buffered (flow-through batches touch
        # the VotesTable op buffer not at all)
        keys_with_rows = set()
        if B:
            order = np.lexsort(
                (batch.dot_seq, batch.dot_src, batch.clock, key_ids)
            )
            sk = key_ids[order]
            # the object path's add_op asserts (clock, dot) uniqueness per
            # key; the stable prefix below bypasses add_op, so check it
            # here — one vector comparison over the sorted rows
            if len(order) > 1:
                a, b = order[:-1], order[1:]
                dup = (
                    (sk[:-1] == sk[1:])
                    & (batch.clock[a] == batch.clock[b])
                    & (batch.dot_src[a] == batch.dot_src[b])
                    & (batch.dot_seq[a] == batch.dot_seq[b])
                )
                assert not dup.any(), (
                    "two commands cannot occupy the same (clock, dot) slot"
                )
            seg_starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            seg_ends = np.r_[seg_starts[1:], len(order)]
            # python-int columns once per batch: segment emits index into
            # plain lists (C-level int64 -> int conversion, not per-row)
            src_list = batch.rifl_src.tolist()
            seq_list = batch.rifl_seq.tolist()
            ops_all = batch.ops
            for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
                rows = order[s:e]
                k = int(sk[s])
                keys_with_rows.add(k)
                key = key_list[k]
                table = (
                    tables[key] if tables is not None
                    else self._table._tables.get(key)
                )
                stable_k = int(stable[k])
                if table is not None and table._ops:
                    # rare path: older buffered ops interleave — go through
                    # the object buffer to keep the global (clock, dot) order
                    for i in rows.tolist():
                        table.add_op(
                            Dot(int(batch.dot_src[i]), int(batch.dot_seq[i])),
                            int(batch.clock[i]),
                            Rifl(src_list[i], seq_list[i]),
                            ops_all[i],
                        )
                    ready = table.stable_ops_at(stable_k)
                    if ready:
                        self._execute(key, ready)
                    continue
                cut = int(
                    np.searchsorted(batch.clock[rows], stable_k, side="right")
                )
                if cut:
                    self._emit_stable_rows(
                        key, rows[:cut].tolist(), ops_all, src_list, seq_list,
                    )
                tail = rows[cut:]
                if len(tail):
                    if table is None:  # plane path materializes lazily
                        table = self._table._table(key)
                    for i in tail.tolist():
                        table.add_op(
                            Dot(int(batch.dot_src[i]), int(batch.dot_seq[i])),
                            int(batch.clock[i]),
                            Rifl(src_list[i], seq_list[i]),
                            ops_all[i],
                        )
        # vote-only keys (detached votes, no rows this batch): stability
        # may have advanced past buffered ops — drain them
        for k, key in enumerate(key_list):
            if k in keys_with_rows:
                continue
            table = (
                tables[key] if tables is not None
                else self._table._tables.get(key)
            )
            if table is not None and table._ops:
                ready = table.stable_ops_at(int(stable[k]))
                if ready:
                    self._execute(key, ready)

    def _coalesce_votes_host(
        self, tables, key_list, vkey, vby, vs, ve
    ) -> None:
        """Coalesce vote columns per (key, process) entirely in numpy —
        sort by (key, by, start), compute the per-group running max end
        (groups separated with a large offset so one accumulate serves
        all), and cut merged runs where a start clears the running end by
        > 1.  One add_range call per *merged run* (~ touched keys x
        voters), not per vote row."""
        import numpy as np

        V = len(vkey)
        if not V:
            return
        vorder = np.lexsort((vs, vby, vkey))
        vk = vkey[vorder]
        vb = vby[vorder]
        vs = vs[vorder]
        ve = ve[vorder]
        grp_change = np.r_[True, (vk[1:] != vk[:-1]) | (vb[1:] != vb[:-1])]
        gid = np.cumsum(grp_change) - 1
        base = np.int64(ve.min())
        spread = np.int64(int(ve.max()) - int(base) + 2)
        ngroups = int(gid[-1]) + 1
        if ngroups * int(spread) < (1 << 62):
            # rebase + per-group offset keeps one global accumulate
            # from leaking a group's max end into the next group
            off = gid * spread
            run_end = np.maximum.accumulate((ve - base) + off) - off + base
            prev_end = np.empty_like(run_end)
            prev_end[0] = vs[0]  # dead: grp_change[0] forces a run
            prev_end[1:] = run_end[:-1]
            new_run = grp_change | (vs > prev_end + 1)
            run_starts = np.flatnonzero(new_run)
            m_key = vk[run_starts].tolist()
            m_by = vb[run_starts].tolist()
            m_start = vs[run_starts].tolist()
            m_end = np.maximum.reduceat(ve, run_starts).tolist()
            for k, by, start, end in zip(m_key, m_by, m_start, m_end):
                tables[key_list[k]]._votes[by].add_range(start, end)
        else:
            # pathological clock spread: per-row host merge
            i = 0
            while i < V:
                k, by = int(vk[i]), int(vb[i])
                events = tables[key_list[k]]._votes[by]
                start, end = int(vs[i]), int(ve[i])
                i += 1
                while i < V and vk[i] == k and vb[i] == by:
                    nxt_s, nxt_e = int(vs[i]), int(ve[i])
                    if nxt_s <= end + 1:
                        end = max(end, nxt_e)
                    else:
                        events.add_range(start, end)
                        start, end = nxt_s, nxt_e
                    i += 1
                events.add_range(start, end)

    def _plane_stable(self, key_list, vkey, vby, vs, ve) -> "np.ndarray":
        """Resident-plane stability: ONE commit dispatch applies
        the batch's (already key-id'd) vote columns and returns the
        post-batch stable clock per key_list entry."""
        import numpy as np

        plane = self._plane
        buckets = np.fromiter(
            (plane.bucket(k) for k in key_list), np.int64, len(key_list)
        )
        stable_all = plane.commit_votes(
            buckets[vkey] if len(vkey) else np.empty(0, np.int64),
            vby, vs, ve,
        )
        return stable_all[buckets]

    def _stable_clocks(self, frontiers) -> "np.ndarray":
        import numpy as np

        k, n = frontiers.shape
        col = n - self._stability_threshold
        if k * n >= self._kernel_threshold:
            base = int(frontiers.min())
            rebased = frontiers - base  # order statistic is shift-invariant
            if int(rebased.max()) < (1 << 31):
                import torch

                from fantoch_tpu_torch.executor.device_plane import resolve_device
                from fantoch_tpu_torch.ops.table_ops import stable_clocks

                out = stable_clocks(
                    torch.tensor(
                        rebased.astype(np.int32),
                        device=resolve_device(self._device),
                    ),
                    threshold=self._stability_threshold,
                )
                return out.cpu().numpy().astype(np.int64) + base
        return np.partition(frontiers, col, axis=1)[:, col]

    def handle(self, info, time) -> None:
        if isinstance(info, TableVotesArrays):
            self.handle_batch_arrays(info, time)
            return
        if self._plane is not None and not self._execute_at_commit:
            # the resident plane owns all vote state: single infos route
            # through the arrays seam too
            for batch in self._as_arrays_batches([info]):
                self.handle_batch_arrays(batch, time)
            return
        if isinstance(info, TableVotes):
            if self._execute_at_commit:
                self._execute(info.key, [(info.rifl, info.ops)])
            else:
                ready = self._table.add_votes(
                    info.dot, info.clock, info.rifl, info.key, info.ops, info.votes
                )
                self._execute(info.key, ready)
        elif isinstance(info, TableDetachedVotes):
            if not self._execute_at_commit:
                ready = self._table.add_detached_votes(info.key, info.votes)
                self._execute(info.key, ready)
        else:
            raise AssertionError(f"unknown table execution info {info}")

    def _emit_stable_rows(
        self, key: Key, rows: List[int], ops_all, src_list, seq_list
    ) -> None:
        """Emit a key's stable prefix straight from the batch columns
        (rows already in (clock, dot) order).  The dominant serving shape
        — single-op PUT rows with no execution monitor — applies to the
        KVStore as ONE dict write: each row's result is the previous
        row's value (HashMap::insert semantics, exactly what per-op
        execution returns), so only the Rifl/ExecutorResult constructions
        themselves remain per-row work.  Anything else falls back to
        per-op execution."""
        store = self._store
        if store.monitor is None and store.digest is None:
            # single pass doubles as the fast-path check and the value
            # extraction; bail to per-op execution on the first non-put
            vals = []
            fast = True
            for i in rows:
                ops = ops_all[i]
                if len(ops) == 1 and ops[0].kind is KVOpKind.PUT:
                    vals.append(ops[0].value)
                else:
                    fast = False
                    break
            if fast and vals:
                kv = store._store
                prevs = [kv.get(key)]
                prevs.extend(vals[:-1])  # row i returns row i-1's value
                kv[key] = vals[-1]
                # C-level construction: zip(prevs) yields the 1-tuples,
                # map drives Rifl/ExecutorResult without bytecode per row
                self._to_clients.extend(
                    map(
                        ExecutorResult,
                        map(
                            Rifl,
                            [src_list[i] for i in rows],
                            [seq_list[i] for i in rows],
                        ),
                        repeat(key),
                        zip(prevs),
                    )
                )
                tracer = self.tracer
                if tracer.enabled:
                    for i in rows:
                        rifl = (src_list[i], seq_list[i])
                        tracer.span(
                            "ready", rifl, pid=self._process_id,
                            meta={"batch": self._trace_batch},
                        )
                        tracer.span("executed", rifl, pid=self._process_id)
                return
        self._execute(
            key,
            [(Rifl(src_list[i], seq_list[i]), ops_all[i]) for i in rows],
        )

    def _execute(self, key: Key, to_execute: List[Tuple[Rifl, Tuple[KVOp, ...]]]) -> None:
        tracer = self.tracer
        if tracer.enabled:
            # "ready" = the timestamp became stable this batch
            for rifl, _ops in to_execute:
                tracer.span(
                    "ready", rifl, pid=self._process_id,
                    meta={"batch": self._trace_batch},
                )
        store_execute = self._store.execute
        append = self._to_clients.append
        for rifl, ops in to_execute:
            if len(ops) == 1:
                results = (store_execute(key, ops[0], rifl),)
            else:
                results = tuple(store_execute(key, op, rifl) for op in ops)
            append(ExecutorResult(rifl, key, results))
        if tracer.enabled:
            for rifl, _ops in to_execute:
                tracer.span("executed", rifl, pid=self._process_id)

    def device_counters(self):
        """Per-dispatch tallies of the resident votes-table plane (None
        when the plane is off); folded into the run layer's periodic
        metrics snapshot and the bench rows."""
        if self._plane is None:
            return None
        plane = self._plane
        return {
            "table_plane_dispatches": plane.dispatches,
            "table_plane_grows": plane.grows,
            "table_plane_vote_rows": plane.stats["vote_rows"],
            "table_plane_row_capacity": plane.stats["row_capacity"],
            "table_plane_residual_runs": plane.stats["residual_runs"],
            "table_plane_kernel_ms": round(plane.stats["kernel_ms"], 3),
            # host->device frontier materializations: stays at 1 in
            # steady state; restart-from-snapshot costs exactly one more
            "table_plane_resident_uploads": plane.resident_uploads,
            # accelerator fault detection: failures detected and the
            # health gauge (max-folded)
            **{
                f"table_plane_{k}": v
                for k, v in plane.fault_counters().items()
            },
        }

    def device_planes(self):
        return (self._plane,) if self._plane is not None else ()

    def to_clients(self) -> Optional[ExecutorResult]:
        return self._to_clients.popleft() if self._to_clients else None

    @classmethod
    def parallel(cls) -> bool:
        return True

    def monitor(self):
        return self._store.monitor

    @staticmethod
    def key_of(info) -> Key:
        """MessageKey routing (executor.rs:163-170)."""
        return info.key
