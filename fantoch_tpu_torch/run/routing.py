"""Worker-index routing: maps messages/events to worker pool indices.

Reference: fantoch/src/run/prelude.rs:11-35.
Messages with the same index always land on the same worker; two reserved
indices exist for the GC worker / leader (0) and protocol-specific workers
(e.g. Newt's clock-bump worker at 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

from fantoch_tpu_torch.core.ids import Dot

# worker index used by leader-based protocols
LEADER_WORKER_INDEX = 0
# worker index used for garbage collection (same as leader: leader-based
# protocols run gc in the leader/acceptor worker)
GC_WORKER_INDEX = 0
# number of reserved worker indices
WORKERS_INDEXES_RESERVED = 2

# An index is (reserved, index): the actual worker is
# `reserved + index % (pool_size - reserved)` (ignoring reservation when the
# pool is too small).  None means broadcast to all workers.
WorkerIndex = Optional[Tuple[int, int]]


def worker_index_no_shift(index: int) -> WorkerIndex:
    """Route to one of the reserved workers (index must be reserved)."""
    assert index < WORKERS_INDEXES_RESERVED
    return (0, index)


def worker_index_shift(index: int) -> WorkerIndex:
    """Route to a non-reserved worker."""
    return (WORKERS_INDEXES_RESERVED, index)


def worker_dot_index_shift(dot: Dot) -> WorkerIndex:
    """Route by dot sequence (the common case for leaderless protocols)."""
    return worker_index_shift(dot.sequence)
