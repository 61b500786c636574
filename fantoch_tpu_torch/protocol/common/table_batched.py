"""Array-backed key clocks for the Newt/Tempo proposal path.

The port of fantoch_tpu/protocol/common/table_batched.py.  The host twin (``SequentialKeyClocks``, table_clocks.py) bumps one dict
entry per key per command — the per-command Python the reference pays per
``SequentialKeyClocks::proposal`` call
(fantoch_ps/src/protocol/common/table/clocks/keys/sequential.rs:36-47).
``BatchedKeyClocks`` holds the clock table as a dense int64 array over a
key registry and adds ``proposal_batch``: one
:func:`fantoch_tpu_torch.ops.table_ops.resident_clock_proposal` call
assigns clocks + consumed vote ranges to a whole batch of single-key
commands (commands on the same key receive consecutive clocks in batch
order, exactly the sequential semantics).  Scalar ``proposal`` /
``detached`` / ``detached_all`` keep the full SequentialKeyClocks
interface, so this is a drop-in replacement selected by
``Config.batched_table_executor``.

Clock width: the kernel works in int32; ``proposal_batch`` rebases int64
host clocks when they fit a 31-bit window above zero and falls back to the
sequential loop otherwise (real-time microsecond clocks — the window
machinery of ops/table_ops.ClockWindow belongs to the device-resident
serving path, not this host seam).  That route is chosen by the clock
values, never by a failure, and ``device_counters()`` counts each time it
is taken (``clock_window_fallbacks``).

Device: the clock table lives on ``device`` (default ``cuda``), resolved
when the first batch builds the table; without CUDA and without an
explicit device that build raises.  The scalar paths never touch it.  The
simulator hands Newt its own device (``Protocol.set_device``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import ProcessId, ShardId
from fantoch_tpu_torch.core.kvs import Key
from fantoch_tpu_torch.executor.device_plane import resolve_device
from fantoch_tpu_torch.ops.table_ops import (
    next_pow2 as _pow2,
    resident_clock_bump,
    resident_clock_proposal,
)
from fantoch_tpu_torch.protocol.common.table_clocks import VoteRange, Votes

_INT32_MAX = (1 << 31) - 1


class BatchedKeyClocks:
    """SequentialKeyClocks semantics over a dense clock array.

    The batched proposal path keeps the clock table DEVICE-RESIDENT
    across batches (``ops/table_ops.resident_clock_proposal`` updates it
    in place): successive ``proposal_batch_arrays`` calls never
    re-upload or re-download the table.  The host ``_clocks`` mirror goes
    stale while the device copy leads; scalar-path accesses
    (``proposal``/``detached``/``detached_all``) re-sync the host view
    but KEEP the device table resident — their bumps are recorded and
    folded into the next batch dispatch as one O(bumps) scatter-max
    (``ops/table_ops.resident_clock_bump``, in place), so live Newt's
    scalar detached-bumps between submit batches do not degrade the
    proposal path to upload-per-batch.  The device copy is dropped only when the key
    registry outgrows its capacity, on pickling, and when a genuine
    31-bit overflow forces the sequential fallback.
    """

    __slots__ = (
        "process_id", "shard_id", "_key_index", "_keys", "_clocks", "_count",
        "_dev_prior", "_dev_kcap", "_host_stale", "_host_max",
        "_pending_bumps", "resident_uploads", "window_fallbacks", "_device",
    )

    def __init__(self, process_id: ProcessId, shard_id: ShardId, device=None):
        self.process_id = process_id
        self.shard_id = shard_id
        # the clock table's card (None = cuda, resolved at the first build)
        self._device = device
        self._key_index: Dict[Key, int] = {}
        self._keys: List[Key] = []
        self._clocks = np.zeros(64, dtype=np.int64)
        self._count = 0
        self._dev_prior = None  # resident int32[kcap] clock table
        self._dev_kcap = 0
        self._host_stale = False
        # upper bound on any clock in the table (host or device): the
        # window guard must not read the device table, so the bound is
        # maintained incrementally and tightened at materialize time
        self._host_max = 0
        # scalar bumps applied to the host mirror while the device table
        # stays resident: bucket -> bumped-to clock, folded into the next
        # batch dispatch (scatter-max) and cleared
        self._pending_bumps: Dict[int, int] = {}
        # full-table uploads (first build + capacity regrows + rebuilds
        # after a drop) — the residency regression instrument: steady
        # state holds this at 1 however many scalar bumps interleave
        self.resident_uploads = 0
        # batches the 31-bit window guard sent to the sequential loop
        self.window_fallbacks = 0

    def device_counters(self) -> Dict[str, int]:
        """Full-table uploads and 31-bit-window fallbacks of the proposal
        table (the executors' ``device_counters()`` seam, for the clocks)."""
        return {
            "clock_table_resident_uploads": self.resident_uploads,
            "clock_window_fallbacks": self.window_fallbacks,
        }

    def _sync_host(self) -> None:
        """Refresh the host mirror from the resident device table WITHOUT
        dropping it (scalar paths need current clock values; their bumps
        ride ``_pending_bumps`` back to the device).  Buckets registered
        after the last batch hold 0 on both sides; the device table's
        last slot is the pad bucket and is never copied.  ``_host_max``
        is NOT tightened here: it still bounds the resident pad bucket's
        accumulated garbage."""
        if self._dev_prior is not None and self._host_stale:
            dev = self._dev_prior.to("cpu", copy=True).numpy().astype(np.int64)
            # never copy the device table's LAST slot: it is the pad
            # bucket, whose clock accumulates garbage from pad rows.
            # A real key at that index can only have registered after
            # the last dispatch (dispatch guarantees real indices
            # <= len(dev) - 2), so its live clock is the host's 0
            take = min(self._count, len(dev) - 1)
            self._clocks[:take] = dev[:take]
            self._host_stale = False

    def _materialize_host(self) -> None:
        """Sync the host mirror and DROP the device copy (the caller is
        about to rebuild it, pickle, or fall back to the sequential
        path).  Pending scalar bumps are already in the host mirror, so
        they die with the device copy; the window bound tightens to the
        actual table max (pad-bucket garbage is dropped here)."""
        self._sync_host()
        if self._dev_prior is not None:
            self._dev_prior = None
            self._dev_kcap = 0
            if self._count:
                self._host_max = int(self._clocks[: self._count].max())
            else:
                self._host_max = 0
        self._pending_bumps.clear()

    def __getstate__(self):
        # device tensors don't travel in a pickle (sim snapshots):
        # materialize the host view and ship that
        self._materialize_host()
        return {
            s: getattr(self, s)
            for s in self.__slots__
            if s not in ("_dev_prior",)
        }

    def __setstate__(self, state):
        for k, v in state.items():
            setattr(self, k, v)
        self._dev_prior = None
        self._dev_kcap = 0
        self._host_stale = False

    # --- registry ---

    def _index(self, key: Key) -> int:
        idx = self._key_index.get(key)
        if idx is None:
            idx = self._count
            self._key_index[key] = idx
            self._keys.append(key)
            self._count += 1
            if idx >= len(self._clocks):
                grown = np.zeros(len(self._clocks) * 2, dtype=np.int64)
                grown[: len(self._clocks)] = self._clocks
                self._clocks = grown
        return idx

    def init_clocks(self, cmd: Command) -> None:
        for key in cmd.keys(self.shard_id):
            self._index(key)

    # --- scalar SequentialKeyClocks interface ---

    def proposal(self, cmd: Command, min_clock: int) -> Tuple[int, Votes]:
        self._sync_host()
        clock = max(min_clock, self._cmd_clock(cmd) + 1)
        votes = Votes()
        self.detached(cmd, clock, votes)
        return clock, votes

    def detached(self, cmd: Command, up_to: int, votes: Votes) -> None:
        self._sync_host()
        for key in cmd.keys(self.shard_id):
            self._maybe_bump(key, up_to, votes)

    def detached_all(self, up_to: int, votes: Votes) -> None:
        # vectorized sweep over every registered key (the clock-bump event
        # touches the whole table, newt.rs:983-1006)
        self._sync_host()
        self._host_max = max(self._host_max, up_to)
        count = self._count
        current = self._clocks[:count]
        behind = np.nonzero(current < up_to)[0]
        resident = self._dev_prior is not None
        for idx in behind.tolist():
            votes.add(
                self._keys[idx],
                VoteRange(self.process_id, int(current[idx]) + 1, up_to),
            )
            if resident:
                self._pending_bumps[idx] = up_to
        current[behind] = up_to

    def backfill_votes(self) -> Votes:
        """Array twin of ``SequentialKeyClocks.backfill_votes``: one
        ``[1, clock]`` range per known key — the contiguous prefix of
        every vote this process ever issued (see the host twin for why
        that invariant holds).  Used by the rejoin plane
        (protocol/sync.py); does not disturb device residency."""
        self._sync_host()
        votes = Votes()
        count = self._count
        clocks = self._clocks[:count]
        for idx in np.nonzero(clocks > 0)[0].tolist():
            votes.add(
                self._keys[idx],
                VoteRange(self.process_id, 1, int(clocks[idx])),
            )
        return votes

    @classmethod
    def parallel(cls) -> bool:
        return False

    def _cmd_clock(self, cmd: Command) -> int:
        return max(
            (int(self._clocks[self._index(key)]) for key in cmd.keys(self.shard_id)),
            default=0,
        )

    def _maybe_bump(self, key: Key, up_to: int, votes: Votes) -> None:
        idx = self._index(key)
        current = int(self._clocks[idx])
        if current < up_to:
            votes.add(key, VoteRange(self.process_id, current + 1, up_to))
            self._clocks[idx] = up_to
            if up_to > self._host_max:
                self._host_max = up_to
            if self._dev_prior is not None:
                # the resident device table still holds `current`; the
                # next batch dispatch folds this bump in (scatter-max)
                self._pending_bumps[idx] = up_to

    # --- the batched proposal seam ---

    def proposal_batch(
        self, cmds: List[Command], min_clocks: List[int]
    ) -> List[Tuple[int, Votes]]:
        """Clocks + votes for a whole batch, preserving batch order within
        each key (== running ``proposal`` sequentially).  Single-key
        commands with window-sized clocks go through the device kernel;
        anything else falls back to the sequential loop."""
        assert len(cmds) == len(min_clocks)
        batch = len(cmds)
        if batch == 0:
            return []
        keys: List[Key] = []
        single = True
        for cmd in cmds:
            if cmd.key_count(self.shard_id) != 1:
                single = False
                break
            keys.append(next(iter(cmd.keys(self.shard_id))))
        if single:
            out = self._proposal_batch_kernel(keys, min_clocks)
            if out is not None:
                return out
        return [self.proposal(cmd, mc) for cmd, mc in zip(cmds, min_clocks)]

    def proposal_batch_arrays(
        self, keys: List[Key], min_clocks
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Array-native proposal seam: clocks + consumed vote-range starts
        as int64 columns, NO Votes/VoteRange objects — per-command object
        building happens only at whatever boundary actually needs
        objects.  The vote consumed by row ``i`` is
        ``[vote_start[i], clock[i]]`` by this process.

        Returns None when clocks exceed the 31-bit kernel window
        (real-time micros; callers fall back to the sequential loop) and
        counts it in ``window_fallbacks``.
        Semantics: identical to running ``proposal`` sequentially —
        same-key commands get consecutive clocks in batch order
        (fantoch_ps/src/protocol/common/table/votes.rs:133 ranges).

        Residency: the clock table stays ON DEVICE between calls
        (``resident_clock_proposal`` updates it in place); only the
        per-row clock/vote_start columns cross the host boundary.  The
        table is rebuilt from the host mirror when the key registry
        outgrows the device capacity (pow2 schedule) or after a scalar
        access dropped the device copy."""
        batch = len(keys)
        ki = self._key_index
        try:
            idx_list = [ki[k] for k in keys]
        except KeyError:
            for k in keys:
                self._index(k)
            idx_list = [ki[k] for k in keys]
        mins = np.asarray(min_clocks, dtype=np.int64)
        # pad the key table to pow2 (the reference's schedule, so both
        # packages see identical tables); pad the batch with pad-bucket rows
        kcap = _pow2(max(self._count, 1) + 1)
        bcap = _pow2(batch)
        # 31-bit window guard without reading the device table: no bucket
        # (pad included) can exceed max(previous bound, batch mins) plus
        # the padded batch size, so the bound threads through batches
        hi = max(self._host_max, int(mins.max()) if batch else 0)
        if hi + bcap + 1 > _INT32_MAX:
            # the incrementally-grown bound includes pad-bucket drift
            # (+bcap per resident batch): materializing tightens it to
            # the true table max, so only genuine real-time-micros
            # clocks still overflow and pay the sequential fallback
            self._materialize_host()
            hi = max(self._host_max, int(mins.max()) if batch else 0)
            if hi + bcap + 1 > _INT32_MAX:
                self.window_fallbacks += 1
                return None
        if self._dev_prior is None or self._dev_kcap < kcap:
            # first batch, or the registry outgrew the device capacity:
            # (re)build the resident table from the host mirror
            self._materialize_host()
            prior = np.zeros(kcap, dtype=np.int32)
            prior[: self._count] = self._clocks[: self._count]
            # torch.tensor COPIES (never an alias of host numpy: the
            # proposal writes into this tensor)
            self._dev_prior = torch.tensor(prior, device=resolve_device(self._device))
            self._dev_kcap = kcap
            self.resident_uploads += 1
        elif self._pending_bumps:
            # scalar bumps interleaved since the last batch: fold them
            # into the resident table as ONE in-place scatter-max —
            # O(bumps) host->device traffic instead of a full-table
            # re-upload.  No rebuild above
            # means every bumped bucket is < _dev_kcap - 1 (the pad
            # slot), so the scatter stays inside the real region.
            items = sorted(self._pending_bumps.items())
            m = len(items)
            mcap = _pow2(m)
            bidx = np.full(mcap, self._dev_kcap - 1, dtype=np.int32)
            bval = np.zeros(mcap, dtype=np.int32)
            bidx[:m] = [i for i, _ in items]
            bval[:m] = [v for _, v in items]
            dev = self._dev_prior.device
            resident_clock_bump(
                self._dev_prior,
                torch.tensor(bidx, device=dev),
                torch.tensor(bval, device=dev),
            )
            self._pending_bumps.clear()
        pk = np.full(bcap, self._dev_kcap - 1, dtype=np.int32)  # pad bucket
        pm = np.zeros(bcap, dtype=np.int32)
        pk[:batch] = idx_list
        pm[:batch] = mins.astype(np.int32)
        dev = self._dev_prior.device
        clock_d, start_d, _ = resident_clock_proposal(
            self._dev_prior,
            torch.tensor(pk, device=dev),
            torch.tensor(pm, device=dev),
        )
        self._host_stale = True
        self._host_max = hi + bcap
        # one blocking transfer for the two row outputs; the clock table
        # never crosses
        clock, vote_start = torch.stack((clock_d, start_d)).cpu().numpy()
        return (
            clock[:batch].astype(np.int64),
            vote_start[:batch].astype(np.int64),
        )

    def _proposal_batch_kernel(
        self, keys: List[Key], min_clocks: List[int]
    ) -> Optional[List[Tuple[int, Votes]]]:
        arrays = self.proposal_batch_arrays(keys, min_clocks)
        if arrays is None:
            return None
        clock, vote_start = arrays
        out: List[Tuple[int, Votes]] = []
        for i in range(len(keys)):
            votes = Votes()
            votes.set(
                keys[i],
                [VoteRange(self.process_id, int(vote_start[i]), int(clock[i]))],
            )
            out.append((int(clock[i]), votes))
        return out

