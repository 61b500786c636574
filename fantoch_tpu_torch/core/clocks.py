"""Event-set clocks: the lattice used for executed/committed tracking and GC.

Host-side equivalent of the reference's `threshold` crate types:
- ``AboveExSet``: a set of events (positive ints) stored as a contiguous
  frontier plus an exception set of events above it.
- ``AEClock``: map actor -> AboveExSet (used as ``Executed``/committed
  clocks, e.g. fantoch/src/protocol/mod.rs:40).
- ``VClock``: map actor -> max event, i.e. a plain vector clock with
  join (pointwise max) and meet (pointwise min) — the meet across processes
  yields the stable frontier for GC (fantoch/src/protocol/gc.rs:120-137).

The device-side mirror of AEClock is a dense ``int64[n]`` frontier vector
plus a bounded exception buffer — see fantoch_tpu/ops/frontier.py.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, Iterator, Optional, Set, Tuple, TypeVar

A = TypeVar("A", bound=Hashable)


class AboveExSet:
    """Frontier + above-frontier exceptions event set."""

    __slots__ = ("_frontier", "_above")

    def __init__(self, frontier: int = 0, above: Optional[Set[int]] = None):
        self._frontier = frontier
        self._above: Set[int] = above or set()

    def add(self, event: int) -> bool:
        """Add an event; returns True if newly added."""
        if event <= self._frontier or event in self._above:
            return False
        if event == self._frontier + 1:
            self._frontier = event
            # absorb contiguous exceptions
            while self._frontier + 1 in self._above:
                self._frontier += 1
                self._above.discard(self._frontier)
        else:
            self._above.add(event)
        return True

    def add_range(self, start: int, end: int) -> None:
        for event in range(start, end + 1):
            self.add(event)

    def contains(self, event: int) -> bool:
        return event <= self._frontier or event in self._above

    @property
    def frontier(self) -> int:
        """Highest event such that all events up to it are present."""
        return self._frontier

    def join(self, other: "AboveExSet") -> None:
        for event in other.events():
            self.add(event)

    def events(self) -> Iterator[int]:
        yield from range(1, self._frontier + 1)
        yield from sorted(self._above)

    def event_count(self) -> int:
        return self._frontier + len(self._above)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, AboveExSet)
            and self._frontier == other._frontier
            and self._above == other._above
        )

    def __repr__(self) -> str:
        return f"AboveExSet({self._frontier}, +{sorted(self._above)})"

    def copy(self) -> "AboveExSet":
        return AboveExSet(self._frontier, set(self._above))


class RangeEventSet:
    """Event set stored as sorted disjoint ranges — O(log r) adds for
    arbitrarily wide ranges.

    Newt vote ranges span real-time microsecond clocks (ranges of millions
    of events per bump, fantoch_ps/src/protocol/newt.rs clock-bump), so the
    per-event ``AboveExSet`` representation is unusable there; this is the
    analog of the threshold crate's ``ARClock`` event sets.
    """

    __slots__ = ("_ranges",)

    def __init__(self) -> None:
        # sorted, disjoint, non-adjacent [start, end] (inclusive) ranges
        self._ranges: list = []

    def add_range(self, start: int, end: int) -> bool:
        """Union [start, end] in; returns True if any event was new."""
        assert start <= end
        import bisect

        ranges = self._ranges
        # first range that could touch [start, end]: rightmost with
        # range_start <= end + 1, scanning left while overlapping/adjacent
        lo = bisect.bisect_left(ranges, (start,))
        if lo > 0 and ranges[lo - 1][1] >= start - 1:
            lo -= 1
        hi = lo
        new_start, new_end = start, end
        while hi < len(ranges) and ranges[hi][0] <= end + 1:
            r_start, r_end = ranges[hi]
            new_start = min(new_start, r_start)
            new_end = max(new_end, r_end)
            hi += 1
        if hi == lo:
            ranges.insert(lo, (start, end))
            return True
        covered = hi - lo == 1 and ranges[lo][0] <= start and ranges[lo][1] >= end
        ranges[lo:hi] = [(new_start, new_end)]
        return not covered

    def contains(self, event: int) -> bool:
        import bisect

        i = bisect.bisect_right(self._ranges, (event, float("inf")))
        return i > 0 and self._ranges[i - 1][1] >= event

    @property
    def frontier(self) -> int:
        """Highest event e with 1..=e all present."""
        if self._ranges and self._ranges[0][0] == 1:
            return self._ranges[0][1]
        return 0

    def event_count(self) -> int:
        return sum(end - start + 1 for start, end in self._ranges)

    def ranges(self):
        return list(self._ranges)

    def __repr__(self) -> str:
        return f"RangeEventSet({self._ranges})"


class AEClock(Generic[A]):
    """Above-exception clock: actor -> AboveExSet."""

    def __init__(self, actors: Iterable[A] = ()):  # bottom clock over actors
        self._clock: Dict[A, AboveExSet] = {actor: AboveExSet() for actor in actors}

    def add(self, actor: A, event: int) -> bool:
        return self._clock.setdefault(actor, AboveExSet()).add(event)

    def add_range(self, actor: A, start: int, end: int) -> None:
        self._clock.setdefault(actor, AboveExSet()).add_range(start, end)

    def contains(self, actor: A, event: int) -> bool:
        eset = self._clock.get(actor)
        return eset is not None and eset.contains(event)

    def get(self, actor: A) -> Optional[AboveExSet]:
        return self._clock.get(actor)

    def frontier(self) -> "VClock[A]":
        """VClock of contiguous frontiers."""
        out: VClock[A] = VClock()
        for actor, eset in self._clock.items():
            out.set(actor, eset.frontier)
        return out

    def join(self, other: "AEClock[A]") -> None:
        for actor, eset in other._clock.items():
            self._clock.setdefault(actor, AboveExSet()).join(eset)

    def actors(self) -> Iterator[A]:
        return iter(self._clock.keys())

    def event_count(self) -> int:
        return sum(e.event_count() for e in self._clock.values())

    def __len__(self) -> int:
        return len(self._clock)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, AEClock) and self._clock == other._clock

    def __repr__(self) -> str:
        return f"AEClock({self._clock})"

    def copy(self) -> "AEClock[A]":
        out: AEClock[A] = AEClock()
        out._clock = {a: e.copy() for a, e in self._clock.items()}
        return out


class VClock(Generic[A]):
    """Plain vector clock: actor -> max contiguous event."""

    def __init__(self, actors: Iterable[A] = ()):  # bottom clock over actors
        self._clock: Dict[A, int] = {actor: 0 for actor in actors}

    def set(self, actor: A, event: int) -> None:
        self._clock[actor] = event

    def add(self, actor: A, event: int) -> None:
        """Monotone add: only moves the entry forward."""
        if event > self._clock.get(actor, 0):
            self._clock[actor] = event

    def get(self, actor: A) -> int:
        return self._clock.get(actor, 0)

    def contains(self, actor: A, event: int) -> bool:
        return event <= self._clock.get(actor, 0)

    def join(self, other: "VClock[A]") -> None:
        """Pointwise max."""
        for actor, event in other._clock.items():
            if event > self._clock.get(actor, 0):
                self._clock[actor] = event

    def meet(self, other: "VClock[A]") -> None:
        """Pointwise min over this clock's actors (intersection frontier)."""
        for actor in self._clock:
            self._clock[actor] = min(self._clock[actor], other._clock.get(actor, 0))

    def actors(self) -> Iterator[A]:
        return iter(self._clock.keys())

    def items(self) -> Iterator[Tuple[A, int]]:
        return iter(self._clock.items())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, VClock) and self._clock == other._clock

    def __repr__(self) -> str:
        return f"VClock({self._clock})"

    def copy(self) -> "VClock[A]":
        out: VClock[A] = VClock()
        out._clock = dict(self._clock)
        return out
