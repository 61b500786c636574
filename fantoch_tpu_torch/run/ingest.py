"""Adaptive ingest batching for the simulator's open-loop arrivals.

Batching amortizes a device dispatch over a whole round instead of paying
it per trickle of arrivals: this module is the accumulate-fuse-dispatch-
lazily discipline of the GraphBLAS nonblocking-execution line (PAPERS.md)
applied to the ingest edge.

* :class:`AdaptiveIngestBatcher` — hold queued submissions until a
  **size target** or a **deadline budget** fills.  The size target
  tracks the recent queue-arrival rate (EWMA): the expected number of
  arrivals inside one deadline window, so under saturation rounds go
  out full and under a trickle the target collapses to 1 and nothing
  waits.  The deadline bounds the latency a queued command can pay to
  batching.  An **idle-system fast path** releases a lone closed-loop
  command immediately — sync latency never regresses.

Knob resolution: explicit argument > ``Config`` field > env var — any
spelling is the same knob, never three.

Time is injected (float milliseconds): the sim passes its virtual clock
— the batcher itself never reads a clock, which is what makes the sim
wire-through deterministic (same-seed byte-identical traces with the
batcher on).
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Tuple

ENV_INGEST_DEADLINE_MS = "FANTOCH_INGEST_DEADLINE_MS"
ENV_INGEST_TARGET = "FANTOCH_INGEST_TARGET"


def requested_ingest_deadline_ms(
    explicit: Optional[float] = None, config: Any = None
) -> Optional[float]:
    """The explicitly requested ingest deadline budget, by precedence:
    an explicit value, then ``Config.ingest_deadline_ms``, then the
    ``FANTOCH_INGEST_DEADLINE_MS`` env var — or None when no channel
    requested one (the sim, which releases every arrival at once unless
    asked, branches on this)."""
    deadline = explicit
    if deadline is None and config is not None:
        deadline = getattr(config, "ingest_deadline_ms", None)
    if deadline is None:
        raw = os.environ.get(ENV_INGEST_DEADLINE_MS)
        if raw:
            deadline = float(raw)
    return None if deadline is None else float(deadline)


def resolve_ingest_target(
    explicit: Optional[int] = None, config: Any = None
) -> Optional[int]:
    """Fixed size-target override (explicit > ``Config.ingest_target`` >
    ``FANTOCH_INGEST_TARGET`` env).  None means adaptive: the batcher
    tracks the target from the EWMA arrival rate."""
    target = explicit
    if target is None and config is not None:
        target = getattr(config, "ingest_target", None)
    if target is None:
        raw = os.environ.get(ENV_INGEST_TARGET)
        if raw:
            target = int(raw)
    if target is None:
        return None
    target = int(target)
    if target < 1:
        raise ValueError(f"ingest target must be >= 1, got {target}")
    return target


class AdaptiveIngestBatcher:
    """Release-gating for one serving queue: size target or deadline.

    The caller owns the queue; the batcher only decides *when* to
    release.  Protocol per iteration: ``note_arrivals(now_ms, n)`` as
    submissions land, then ``poll(now_ms, queued, idle_system)`` —
    ``(True, None)`` means release everything queued now,
    ``(False, wait_ms)`` means hold for up to ``wait_ms`` more (or until
    more arrivals make the size target), ``(False, None)`` means the
    queue is empty.  After a release, ``note_release(now_ms, rows)``
    closes the window and tallies the cause.

    Release causes:

    * **fast** — ``idle_system`` (nothing in flight anywhere): a lone
      closed-loop command dispatches immediately, whatever the EWMA
      says.  This is the sync-latency guarantee.
    * **size** — ``queued >= target`` where ``target`` is the expected
      arrivals per deadline window, ``ceil(ewma_rate * deadline)``
      clamped to ``[1, max_target]`` (or the fixed ``--ingest-target``
      override).  A cold EWMA targets 1, so batching only engages once
      sustained load is *measured*.
    * **deadline** — the oldest queued command has waited the full
      budget.

    A gap longer than ~8 deadline windows hard-resets the EWMA instead
    of decaying it: an idle period ends the throughput regime, and the
    first command after it must not inherit a stale high target.
    """

    __slots__ = (
        "deadline_ms", "max_target", "fixed_target", "_alpha",
        "_rate_per_ms", "_accum", "_last_arrival_ms", "_window_start",
        "_cause", "arrivals", "releases", "released_rows",
        "releases_fast", "releases_size", "releases_deadline",
    )

    def __init__(
        self,
        deadline_ms: float,
        max_target: int,
        fixed_target: Optional[int] = None,
        alpha: float = 0.2,
    ):
        assert deadline_ms >= 0 and max_target >= 1
        assert fixed_target is None or fixed_target >= 1
        self.deadline_ms = float(deadline_ms)
        self.max_target = int(max_target)
        self.fixed_target = fixed_target
        self._alpha = float(alpha)
        self._rate_per_ms = 0.0  # EWMA arrivals per millisecond
        self._accum = 0.0  # arrivals recorded at _last_arrival_ms
        self._last_arrival_ms: Optional[float] = None
        self._window_start: Optional[float] = None  # oldest unreleased wait
        self._cause: Optional[str] = None
        self.arrivals = 0
        self.releases = 0
        self.released_rows = 0
        self.releases_fast = 0
        self.releases_size = 0
        self.releases_deadline = 0

    def note_arrivals(self, now_ms: float, n: int = 1) -> None:
        """Fold ``n`` submissions arriving at ``now_ms`` into the EWMA
        and open the deadline window if it is not already open."""
        if n <= 0:
            return
        self.arrivals += n
        if self._window_start is None:
            self._window_start = now_ms
        last = self._last_arrival_ms
        self._last_arrival_ms = now_ms
        if last is None:
            self._accum = float(n)
            return
        dt = now_ms - last
        if dt <= 0.0:
            self._accum += n
            return
        inst = self._accum / dt
        self._accum = float(n)
        idle_bound = max(self.deadline_ms, 0.125) * 8.0
        if dt >= idle_bound:
            # the throughput regime ended across the gap: snap, don't
            # decay — a closed-loop client must see target 1 at once
            self._rate_per_ms = inst
        else:
            self._rate_per_ms += self._alpha * (inst - self._rate_per_ms)

    def rate_per_s(self) -> float:
        return self._rate_per_ms * 1000.0

    def target(self) -> int:
        """The current size target (rows that trigger a release)."""
        if self.fixed_target is not None:
            return min(self.fixed_target, self.max_target)
        if self.deadline_ms <= 0:
            return 1
        expected = math.ceil(self._rate_per_ms * self.deadline_ms)
        return max(1, min(int(expected), self.max_target))

    def poll(
        self, now_ms: float, queued: int, idle_system: bool = False
    ) -> Tuple[bool, Optional[float]]:
        """``(release, wait_ms)`` for ``queued`` pending submissions at
        ``now_ms``; ``idle_system`` is the fast-path witness (nothing in
        flight downstream — the queued command is alone in the system)."""
        if queued <= 0:
            self._window_start = None
            return (False, None)
        if self._window_start is None:
            # arrivals the caller never noted individually (e.g. drained
            # from an inner queue): the window opens at first sight
            self._window_start = now_ms
        if self.deadline_ms <= 0:
            self._cause = "size"
            return (True, None)
        if idle_system:
            self._cause = "fast"
            return (True, None)
        if queued >= self.target():
            self._cause = "size"
            return (True, None)
        waited = now_ms - self._window_start
        if waited >= self.deadline_ms:
            self._cause = "deadline"
            return (True, None)
        return (False, self.deadline_ms - waited)

    def note_release(self, now_ms: float, rows: int) -> None:
        """Tally one release of ``rows`` commands and close the window
        (the next arrival or poll reopens it)."""
        self.releases += 1
        self.released_rows += rows
        cause = self._cause or "size"
        if cause == "fast":
            self.releases_fast += 1
        elif cause == "deadline":
            self.releases_deadline += 1
        else:
            self.releases_size += 1
        self._cause = None
        self._window_start = None

    def counters(self) -> dict:
        """Tallies for the metrics snapshot (``ingest_target`` and
        ``ingest_rate_per_s`` are gauges, the rest monotone)."""
        return {
            "ingest_arrivals": self.arrivals,
            "ingest_releases": self.releases,
            "ingest_released_rows": self.released_rows,
            "ingest_releases_fast": self.releases_fast,
            "ingest_releases_size": self.releases_size,
            "ingest_releases_deadline": self.releases_deadline,
            "ingest_target": self.target(),
            "ingest_rate_per_s": round(self.rate_per_s(), 1),
        }
