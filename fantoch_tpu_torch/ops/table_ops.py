"""Batched table ops for the Newt/Tempo timestamp path.

The port of fantoch_tpu/ops/table_ops.py, keeping its names.  The two hot
loops of the table protocol/executor become tensor ops:

* ``batched_clock_proposal`` — the tensor twin of
  ``SequentialKeyClocks::proposal`` for a batch of single-key commands:
  commands on the same key receive consecutive clocks continuing from the
  key's prior clock, each lower-bounded by its ``min_clock``.  Within one
  key group ordered j = 0..m-1::

      clock_j = max(min_j, clock_{j-1} + 1)
              = rank_j + max_{i <= j}(max(prior+1, min_i) - rank_i)

  a segmented max-scan of ``max(prior+1, min) - rank``.  Vote ranges are
  born compressed: process p votes ``(prev_end + 1, clock_j)`` per command.
* ``stable_clocks`` — the tensor twin of ``VotesTable::stable_clock`` over
  all key tables at once: the ``(n - threshold)``-th smallest per-process
  vote frontier of each key.

Every function composes the wrappers of ``ops/table_kernels.py``: CPU
tensors run their plain versions, CUDA tensors the hand-written kernels of
``csrc/table_plane.cu`` (the TPU kernels ``votes_commit_pallas`` and
``table_round_pallas`` of fantoch_tpu/ops/pallas_resolve.py).  Where the
reference donates a resident table, the port updates the tensor in place.

Clock width: device clocks are **31-bit windowed**.  Raw wall-clock micros
(Newt's real-time mode) overflow int32 after ~35 minutes, so callers
rebase device clocks against a window floor (:class:`ClockWindow`); the
host twins (protocol/common/table_clocks.py) use unbounded Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from fantoch_tpu_torch.ops import table_kernels as T

_WINDOW_MAX = (1 << 31) - 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the shared padding schedule of every
    table-plane caller (key tables, vote columns, batch rows)."""
    p = 1
    while p < n:
        p *= 2
    return p


class ClockWindow:
    """31-bit device-clock window over unbounded host clocks.

    Host-side clocks are int64; device kernels see ``clock - floor`` as
    int32.  The floor advances monotonically with the protocol's GC'd
    stable clock — every *live* comparison happens above it, so
    subtracting it is order-preserving.  ``advance`` returns the shift to
    apply to device-resident clock tables (see :func:`shift_table`);
    entries at or below the new floor clamp to 0, which keeps proposal
    semantics (``max(prior + 1, min)``) because a floor-or-older prior
    constrains nothing above the floor.
    """

    __slots__ = ("_floor",)

    def __init__(self, floor: int = 0):
        assert floor >= 0
        self._floor = int(floor)

    @property
    def floor(self) -> int:
        return self._floor

    def rebase(self, values) -> np.ndarray:
        """Host int64 clocks -> int32 device clocks (values - floor).

        Zero stays zero (the "no clock yet" bottom), everything else must
        lie in (floor, floor + 2^31)."""
        values = np.asarray(values, dtype=np.int64)
        out = np.where(values == 0, 0, values - self._floor)
        # strict: a clock exactly at the floor would alias the bottom (0)
        assert (out[values != 0] > 0).all(), (
            f"clock at or below the window floor {self._floor}: "
            f"min {values.min()}"
        )
        assert (out <= _WINDOW_MAX).all(), (
            f"clock overflows the 31-bit window above floor {self._floor}: "
            f"max {values.max()} (advance the window)"
        )
        return out.astype(np.int32)

    def restore(self, device_values) -> np.ndarray:
        """Device int32 clocks -> host int64 clocks (values + floor)."""
        vals = np.asarray(device_values, dtype=np.int64)
        return np.where(vals == 0, 0, vals + self._floor)

    def advance(self, new_floor: int) -> int:
        """Move the floor forward (monotone); returns the int32 shift to
        subtract from device-resident clock tables."""
        new_floor = int(new_floor)
        assert new_floor >= self._floor, "window floor is monotone"
        shift = new_floor - self._floor
        assert shift <= _WINDOW_MAX
        self._floor = new_floor
        return shift


def shift_table(table: torch.Tensor, shift) -> torch.Tensor:
    """Rebase a device-resident clock table after ``ClockWindow.advance``:
    entries at or below the new floor clamp to 0 (no constraint).  Returns
    a new tensor, as the reference does."""
    return torch.clamp_min(table - int(shift), 0).to(torch.int32)


# Running max of values within segments of equal seg_id (segments
# contiguous), 1-D: plain PyTorch on any device, as the reference's is plain
# XLA.  The kernels scan inside clock_proposal and vote_runs.
segmented_running_max = T.seg_running_max_plain


def _proposal_core(prior, key, min_clock):
    """The proposal of one batch: returns ``(clock[B], vote_start[B],
    new_prior[K])`` and leaves ``prior`` as it was."""
    new_prior = prior.clone()
    clock, vote_start = T.clock_proposal(new_prior, key, min_clock)
    return clock, vote_start, new_prior


def batched_clock_proposal(prior, key, min_clock):
    """Returns ``(clock[B], vote_start[B], new_prior[K])``.

    ``clock`` is the proposed timestamp per command; the voter's consumed
    range for command i is ``(vote_start[i], clock[i])``; ``new_prior`` is
    the key-clock table after the whole batch (== the last clock per key).
    Batch order is proposal order within each key."""
    return _proposal_core(prior, key, min_clock)


def resident_clock_proposal(prior, key, min_clock):
    """:func:`batched_clock_proposal` on a resident key-clock table:
    ``prior`` is updated in place (the reference donates it) and returned
    as ``new_prior``, so the table never crosses the host boundary between
    batches."""
    clock, vote_start = T.clock_proposal(prior, key, min_clock)
    return clock, vote_start, prior


def resident_clock_bump(prior, idx, clock):
    """Fold host-side scalar clock bumps into the resident key-clock table
    in place: a scatter-max of the bumped buckets' new clocks (bumps are
    monotone, so max == set here, and max keeps pad rows — bucket K-1,
    clock 0 — harmless).  Returns ``prior``."""
    T.clock_bump(prior, idx, clock)
    return prior


def stable_clocks(frontiers, *, threshold: int):
    """Stable clock per key: the ``(n - threshold)``-th smallest of the n
    per-process vote frontiers (``int32[K, n] -> int32[K]``)."""
    assert threshold <= frontiers.shape[1]
    return T.stable_rows(frontiers, threshold)


# ---------------------------------------------------------------------------
# Device-resident votes-table plane: the commit path as in-place dispatches.
#
# The host twin of the vote state is one RangeEventSet per (key, process)
# (executor/table.py VotesTable._votes): sorted disjoint non-adjacent
# ranges whose *frontier* (largest contiguous voted prefix) feeds the
# stability order statistic.  On the card the state is the frontier matrix
# ``int32[K, n]`` alone; a merged vote run that lands beyond a frontier
# gap cannot advance it and is returned to the caller as *residual* — the
# caller re-feeds residuals with the next batch, so once the gap fills the
# frontier catches up exactly as the RangeEventSet would.  After
# interval-merging, runs per (key, process) are disjoint and non-adjacent,
# so AT MOST ONE run per group can extend the frontier in a batch — which
# is what makes the update a single scatter-max, no iteration.
# ---------------------------------------------------------------------------


def _votes_commit_core(frontier, vkey, vby, vstart, vend, valid, *, threshold):
    """One commit: coalesce the vote ranges per (key, process), advance
    ``frontier`` in place and compute every key's stable clock.  Returns
    ``(frontier, stable[K], run_key[V], run_by[V], run_start[V],
    run_end[V], residual[V])``."""
    run_key, run_by, run_start, run_end, residual = T.vote_runs(
        frontier, vkey, vby, vstart, vend, valid
    )
    stable = T.stable_rows(frontier, threshold)
    return frontier, stable, run_key, run_by, run_start, run_end, residual


def fused_votes_commit(frontier, vkey, vby, vstart, vend, valid, *, threshold):
    """One table-plane commit dispatch over the resident ``frontier``
    (``int32[K, n]``, updated in place) and the vote columns
    ``vkey``/``vby`` (0-based)/``vstart``/``vend`` (``int32[V]``) with
    ``valid`` (``bool[V]``, pad rows False).

    Returns ``(frontier, stable[K], run_key[V], run_by[V], run_start[V],
    run_end[V], residual[V])``: the ``run_*`` columns hold the merged vote
    runs (one slot per run, invalid slots have ``residual`` False) and
    ``residual`` marks runs that start beyond the frontier gap — the
    caller buffers those and re-feeds them with the next batch."""
    return _votes_commit_core(
        frontier, vkey, vby, vstart, vend, valid, threshold=threshold
    )


def _fused_round_core(prior, frontier, key, min_clock, threshold, voters):
    """One full table round: proposal + contiguous vote application +
    stability.  The dense serving regime: the first ``voters`` processes
    vote every consumed range each round, so the per-key merged vote run is
    ``(prior + 1, new_prior)`` — contiguous with a voter's frontier iff
    that frontier already reached ``prior``.  Voters with a gap (``gaps``
    counts them) do NOT advance.  ``prior`` and ``frontier`` are updated in
    place."""
    prior_old = prior.clone()
    clock, vote_start = T.clock_proposal(prior, key, min_clock)
    _stable, executable, gaps = T.stable_rows(
        frontier, threshold, (key, clock, prior_old, prior, voters)
    )
    return prior, frontier, clock, vote_start, executable, gaps


def fused_table_round(prior, frontier, key, min_clock, *, threshold, voters):
    """Proposal + vote coalescing + frontier update + stability for one
    batch of single-key commands in the dense all-votes regime, on the
    resident ``prior``/``frontier`` (updated in place).  Returns
    ``(prior, frontier, clock[B], vote_start[B], executable[B], gaps[])``;
    callers keep the last key bucket as a pad bucket if they pad batches
    (the BatchedKeyClocks convention)."""
    return _fused_round_core(prior, frontier, key, min_clock, threshold, voters)


def fused_table_rounds(prior, frontier, keys, min_clocks, *, threshold, voters):
    """A chain of :func:`fused_table_round` over ``keys``/``min_clocks``
    (``int32[S, B]``): one launch sequence per round, no host read between
    rounds.  Returns ``(prior, frontier, clock[S, B], vote_start[S, B],
    executable[S, B], gaps[S])``."""
    outs = [
        _fused_round_core(prior, frontier, keys[s], min_clocks[s], threshold, voters)[2:]
        for s in range(keys.shape[0])
    ]
    clock, vote_start, executable, gaps = (
        torch.stack([o[i] for o in outs]) for i in range(4)
    )
    return prior, frontier, clock, vote_start, executable, gaps
