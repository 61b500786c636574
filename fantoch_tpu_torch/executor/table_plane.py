"""Device-resident votes-table plane for the Newt/Tempo commit path.

The port of fantoch_tpu/executor/table_plane.py.  The host twin
(executor/table.py) keeps one ``RangeEventSet`` per (key, process); this
plane keeps the ``(key_bucket x process)`` frontier matrix ON the card
across batches (updated in place, ``ops/table_ops.fused_votes_commit``),
and each batch is one commit dispatch doing vote-range coalescing, the
frontier update and stability.

Exactness: a merged vote run that starts beyond a frontier gap cannot
advance the watermark; the dispatch marks it *residual* and this class
buffers and re-feeds it with every later batch until the gap fills —
after which the frontier equals what the RangeEventSets would hold.

Buffer lifecycle (resident tensors, lazy host-mirror re-materialization
with the single counted re-upload, pow2 growth, per-dispatch counters)
and fault detection come from the shared
:class:`~fantoch_tpu_torch.executor.device_plane.DevicePlane` base.  An
armed plane (deadline or shadow rate) raises a typed error to the caller
and never serves a batch from its host twin, as the graph plane does.

Clock width: device clocks are int32.  The plane refuses clocks at or
above ``2^31 - 1`` with a typed error instead of silently wrapping —
real-time-micros clock bumps (``Config.newt_clock_bump_interval_ms``)
are rejected at config time (core/config.py).
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from fantoch_tpu_torch.errors import ClockOverflowError
from fantoch_tpu_torch.executor.device_plane import DevicePlane, next_pow2 as _pow2
from fantoch_tpu_torch.ops.table_ops import fused_votes_commit, stable_clocks

__all__ = [
    "ClockOverflowError",
    "DeviceTablePlane",
    "state_from_numpy",
    "state_to_numpy",
]

_INT32_MAX = (1 << 31) - 1


def state_from_numpy(state, device) -> Tuple[torch.Tensor, ...]:
    """A table plane's resident state as the port's tensors on ``device``:
    ``state`` is the 1-tuple ``(frontier int32[K, n],)`` a plane's host
    mirror holds (the JAX package's ``DeviceTablePlane._fetch_state()``
    gives the same), so both packages can continue from one table."""
    assert len(state) == 1, "the frontier matrix alone expected"
    return (torch.tensor(np.asarray(state[0], dtype=np.int32), device=device),)


def state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    """The inverse of :func:`state_from_numpy`: host numpy copies."""
    return tuple(t.to("cpu", copy=True).numpy() for t in state)


class DeviceTablePlane(DevicePlane):
    """Resident vote-frontier state + one commit dispatch per batch.

    ``commit_votes`` consumes vote columns (already bucketed) and returns
    the post-batch stable clock of every registered bucket; the frontier
    matrix never crosses the host boundary.
    """

    __slots__ = ("n", "threshold")

    plane_name = "table"

    def __init__(
        self, n: int, stability_threshold: int, key_buckets: int = 1024,
        device=None,
    ):
        assert stability_threshold <= n
        super().__init__(
            key_buckets,
            stats={
                # per-dispatch tallies: vote_rows/row_capacity is the batch
                # occupancy (padding waste), kernel_ms the blocking
                # dispatch+transfer wall time
                "vote_rows": 0,
                "row_capacity": 0,
                "residual_runs": 0,
                "kernel_ms": 0.0,
            },
            device=device,
        )
        self.n = n
        self.threshold = stability_threshold

    # --- DevicePlane state hooks (state = the 1-tuple frontier matrix) ---

    def _fresh_state(self) -> Tuple[np.ndarray, ...]:
        return (np.zeros((self._cap, self.n), dtype=np.int32),)

    def _pad_state(self, state, cap: int) -> Tuple[np.ndarray, ...]:
        (host,) = state
        padded = np.zeros((cap, self.n), dtype=np.int32)
        rows = min(len(host), cap)
        padded[:rows] = host[:rows]
        return (padded,)

    # --- host twin (the fault detector; DevicePlane base) ---

    def _twin_replay(self, state, entry):
        """One logged commit dispatch replayed through the plain version on
        CPU tensors made from the host-owned twin state and the exact padded
        columns the resident dispatch consumed."""
        out = fused_votes_commit(
            *state_from_numpy(state, "cpu"),
            *(torch.tensor(c) for c in entry),
            threshold=self.threshold,
        )
        return state_to_numpy(out[:1]), tuple(t.numpy() for t in out[1:])

    # --- the commit dispatch ---

    def commit_votes(
        self,
        vkey: np.ndarray,  # int64[V] bucket ids (from ``bucket``)
        vby: np.ndarray,  # int64[V] process ids, 1-based (protocol ids)
        vstart: np.ndarray,  # int64[V]
        vend: np.ndarray,  # int64[V]
    ) -> np.ndarray:
        """Apply a batch of vote ranges; returns ``int64[key_count]``
        stable clocks (post-batch) for every registered bucket.  Residual
        (beyond-gap) runs are buffered internally and re-fed with the
        next batch."""
        self._check_usable()
        if len(vend) and int(np.max(vend)) >= _INT32_MAX:
            raise ClockOverflowError(
                "vote endpoint >= 2^31 - 1: the device table plane is "
                "31-bit windowed (disable device_table_plane for "
                "real-time-micros clocks)"
            )
        # prepend buffered residuals so gap-filling batches coalesce with
        # the runs they unblock
        vkey, vby, vstart, vend = self._take_residuals((vkey, vby, vstart, vend))
        V = len(vkey)
        if V == 0:
            return self._stable_only()

        # pad the vote columns to pow2 (the reference's schedule)
        vcap = _pow2(V)
        pk = np.zeros(vcap, dtype=np.int32)
        pb = np.zeros(vcap, dtype=np.int32)
        ps = np.zeros(vcap, dtype=np.int32)
        pe = np.zeros(vcap, dtype=np.int32)
        pk[:V] = vkey
        pb[:V] = vby - 1  # protocol process ids are 1-based; columns 0-based
        ps[:V] = vstart
        pe[:V] = vend
        pvalid = np.zeros(vcap, dtype=bool)
        pvalid[:V] = True
        cols = (pk, pb, ps, pe, pvalid)

        # the twin logs the exact padded columns before the dispatch
        # (armed-only no-op)
        self._twin_note(cols)
        t0 = time.perf_counter()
        self._materialize()
        dev = self._device
        out = fused_votes_commit(
            *self._resident,
            *(torch.tensor(c, device=dev) for c in cols),
            threshold=self.threshold,
        )
        fetched = tuple(t.to("cpu", copy=True).numpy() for t in out[1:])
        self._check_deadline(t0)
        if self._shadow_sampled():
            self._shadow_compare(self._fetch_state(), fetched)
        stable, run_key, run_by, run_start, run_end, residual = fetched
        res = np.flatnonzero(residual)
        self._count_dispatch(
            t0, vote_rows=V, row_capacity=vcap, residual_runs=len(res)
        )
        self._put_residuals(
            (
                run_key[res].astype(np.int64),
                (run_by[res] + 1).astype(np.int64),  # back to 1-based
                run_start[res].astype(np.int64),
                run_end[res].astype(np.int64),
            )
        )
        return stable.astype(np.int64)[: self.key_count]

    def _stable_only(self) -> np.ndarray:
        """The V == 0 path: stability unchanged — read it off the resident
        state."""
        self._materialize()
        stable = stable_clocks(self._resident[0], threshold=self.threshold)
        return stable.to("cpu").numpy().astype(np.int64)[: self.key_count]

    # --- introspection (tests / debugging) ---

    def frontiers(self) -> np.ndarray:
        """Host copy of the live ``int64[key_count, n]`` frontier matrix
        (a device round-trip; for tests and debugging only)."""
        if self._resident is None:
            if self._host_mirror is not None:
                return self._host_mirror[0][: self.key_count].astype(np.int64)
            return np.zeros((self.key_count, self.n), dtype=np.int64)
        return self._fetch_state()[0].astype(np.int64)[: self.key_count]
