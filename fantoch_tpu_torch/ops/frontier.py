"""Executed-clock frontier with vectorized batch operations.

The device/array mirror of ``AEClock`` (fantoch_tpu/core/clocks.py) that
the reference keeps as ``Executed = AEClock<ProcessId>``
(fantoch/src/protocol/mod.rs:40) and consults per-dependency inside the
Tarjan walk (fantoch_ps/src/executor/graph/tarjan.rs:131-136).

Representation: per-source contiguous watermark (``seq <= watermark[src]``
=> executed) plus a single sorted array of packed above-watermark
exceptions (``src << 32 | seq``).  Both membership tests and adds are
numpy-vectorized over whole batches, which removes the per-dep Python
``executed_clock.contains`` calls; the scalar ``add``/``contains`` keep
AEClock compatibility for the host Tarjan oracle's stuck-residue walks.

``watermarks()``/``exceptions()`` expose the dense arrays for device use
(e.g. shipping the frontier into a jitted resolve as int64 operands).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

_SEQ_BITS = 32
_SEQ_MASK = (1 << _SEQ_BITS) - 1


def pack_dots(src: np.ndarray, seq: np.ndarray) -> np.ndarray:
    """(source, sequence) -> single sortable int64 per dot."""
    return (src.astype(np.int64) << _SEQ_BITS) | seq.astype(np.int64)


class DeviceFrontier:
    """Vectorized executed-dot set over a fixed universe of process ids."""

    __slots__ = (
        "_max_id", "_watermark", "_exceptions", "_dirty", "_chunks", "_clean"
    )

    def __init__(self, process_ids: Iterable[int]):
        ids = list(process_ids)
        assert ids and min(ids) >= 0
        self._max_id = max(ids)
        # dense by process id (ids are small: shard*n+1..): O(max_id) memory
        self._watermark = np.zeros(self._max_id + 1, dtype=np.int64)
        self._exceptions = np.empty(0, dtype=np.int64)  # sorted packed dots
        self._dirty: List[int] = []  # unsorted packed scalar adds
        self._chunks: List[np.ndarray] = []  # whole-batch adds, uncompacted
        self._clean = True  # one compact pass is a fixpoint until new adds

    def _ensure(self, source: int) -> None:
        """Grow the dense watermark vector for an unseen source (AEClock
        accepts any actor; dots from not-yet-discovered processes must not
        crash the frontier)."""
        if source > self._max_id:
            grown = np.zeros(source + 1, dtype=np.int64)
            grown[: self._max_id + 1] = self._watermark
            self._watermark = grown
            self._max_id = source

    # --- scalar AEClock-compatible API (host Tarjan oracle) ---

    def add(self, source: int, sequence: int) -> bool:
        if self.contains(source, sequence):
            return False
        self._dirty.append((int(source) << _SEQ_BITS) | int(sequence))
        self._clean = False
        if len(self._dirty) >= 1024:
            self._compact()
        return True

    def contains(self, source: int, sequence: int) -> bool:
        self._ensure(source)
        if self._chunks:
            self._compact()
        if sequence <= self._watermark[source]:
            return True
        packed = (int(source) << _SEQ_BITS) | int(sequence)
        if self._dirty and packed in self._dirty:
            return True
        i = np.searchsorted(self._exceptions, packed)
        return bool(i < len(self._exceptions) and self._exceptions[i] == packed)

    def add_range(self, source: int, start: int, end: int) -> None:
        seqs = np.arange(start, end + 1, dtype=np.int64)
        self.add_batch(np.full(len(seqs), source, dtype=np.int64), seqs)

    # --- vectorized batch API ---

    def contains_batch(self, src: np.ndarray, seq: np.ndarray) -> np.ndarray:
        """bool[len(src)]: which (src, seq) dots are executed."""
        if len(src):
            self._ensure(int(np.max(src)))
        self._compact()
        below = seq <= self._watermark[src]
        if len(self._exceptions) == 0:
            return below
        packed = pack_dots(src, seq)
        i = np.searchsorted(self._exceptions, packed)
        i = np.minimum(i, len(self._exceptions) - 1)
        return below | (self._exceptions[i] == packed)

    def add_batch(self, src: np.ndarray, seq: np.ndarray) -> None:
        """Whole-batch add: stored as an uncompacted chunk; compaction is
        lazy (first read), so back-to-back batch adds pay one merge."""
        if len(src) == 0:
            return
        self._ensure(int(np.max(src)))
        self._chunks.append(pack_dots(src, seq))
        self._clean = False

    def _compact(self) -> None:
        """Merge dirty adds into the sorted exception array, then advance
        watermarks over contiguous runs and drop covered exceptions."""
        if self._clean:
            return
        self._clean = True
        if self._dirty or self._chunks:
            fresh = self._chunks
            if self._dirty:
                fresh = fresh + [np.array(self._dirty, dtype=np.int64)]
            self._dirty = []
            self._chunks = []
            merged = np.concatenate([self._exceptions, *fresh])
            self._exceptions = np.unique(merged)  # sort + dedupe
        if len(self._exceptions) == 0:
            return
        exc = self._exceptions
        src = (exc >> _SEQ_BITS).astype(np.int64)
        seq = (exc & _SEQ_MASK).astype(np.int64)
        # already-covered exceptions (watermark advanced past them)
        alive = seq > self._watermark[src]
        if not alive.all():
            exc, src, seq = exc[alive], src[alive], seq[alive]
        # contiguity: within each source's sorted run, an exception extends
        # the watermark iff seq == watermark + (position in run) + 1; a
        # prefix-sum formulation: rank-in-run r, candidate = watermark[src]
        # + r + 1; the run of consumable events is the maximal prefix with
        # seq == candidate.
        if len(exc):
            run_first = np.ones(len(exc), dtype=bool)
            run_first[1:] = src[1:] != src[:-1]
            run_start = np.maximum.accumulate(
                np.where(run_first, np.arange(len(exc)), 0)
            )
            rank = np.arange(len(exc)) - run_start
            candidate = self._watermark[src] + rank + 1
            is_step = seq == candidate
            # a gap breaks the rest of the run: prefix-and within runs
            run_broken = np.maximum.accumulate(
                np.where(~is_step, np.arange(len(exc)), -1)
            )
            consumable = is_step & (run_broken < run_start)
            if consumable.any():
                np.maximum.at(self._watermark, src[consumable], seq[consumable])
                exc = exc[~consumable]
        self._exceptions = exc

    # --- device-facing views ---

    def watermarks(self) -> np.ndarray:
        """int64[max_id + 1] contiguous frontier per source."""
        self._compact()
        return self._watermark.copy()

    def exceptions(self) -> np.ndarray:
        """Sorted int64 packed dots above the watermark."""
        self._compact()
        return self._exceptions.copy()

    def frontier_of(self, source: int) -> int:
        self._compact()
        return int(self._watermark[source])

    def event_count(self) -> int:
        self._compact()
        return int(self._watermark.sum()) + len(self._exceptions)
