"""Metrics: exact histograms + aggregated counters.

Reference: fantoch_prof/src/metrics/{mod,histogram,float}.rs — an exact
``Histogram`` over a value->count map with mean/stddev/cov/percentiles, and a
``Metrics`` container holding named histograms and counters with merge
support (used for protocol fast/slow/stable accounting and executor stats).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Generic, Hashable, Iterable, List, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)


class Histogram:
    """Exact histogram over integer values (fantoch_prof/src/metrics/histogram.rs:15-120)."""

    def __init__(self) -> None:
        self._values: Counter = Counter()
        self._count = 0

    def increment(self, value: int, count: int = 1) -> None:
        self._values[value] += count
        self._count += count

    def merge(self, other: "Histogram") -> None:
        self._values.update(other._values)
        self._count += other._count

    @property
    def count(self) -> int:
        return self._count

    def values(self) -> Iterable[Tuple[int, int]]:
        return sorted(self._values.items())

    def mean(self) -> float:
        if self._count == 0:
            return 0.0
        return sum(v * c for v, c in self._values.items()) / self._count

    def stddev(self) -> float:
        if self._count <= 1:
            return 0.0
        mean = self.mean()
        # corrected sample variance (count - 1), matching
        # fantoch_prof/src/metrics/histogram.rs compute_variance
        var = sum(c * (v - mean) ** 2 for v, c in self._values.items()) / (self._count - 1)
        return math.sqrt(var)

    def cov(self) -> float:
        """Coefficient of variation: stddev / mean."""
        mean = self.mean()
        return self.stddev() / mean if mean else 0.0

    def mdtm(self) -> float:
        """Mean distance to mean (mean absolute deviation)."""
        if self._count == 0:
            return 0.0
        mean = self.mean()
        return sum(c * abs(v - mean) for v, c in self._values.items()) / self._count

    def percentile(self, p: float) -> float:
        """p in [0, 1]; nearest-rank percentile over the exact values."""
        assert 0.0 <= p <= 1.0
        if self._count == 0:
            return 0.0
        rank = max(1, math.ceil(p * self._count))
        seen = 0
        for value, count in sorted(self._values.items()):
            seen += count
            if seen >= rank:
                return float(value)
        return float(max(self._values))

    def min(self) -> int:
        return min(self._values) if self._values else 0

    def max(self) -> int:
        return max(self._values) if self._values else 0

    def all_values(self) -> List[int]:
        out: List[int] = []
        for value, count in sorted(self._values.items()):
            out.extend([value] * count)
        return out

    def __repr__(self) -> str:
        if self._count == 0:
            return "Histogram(empty)"
        return (
            f"Histogram(n={self._count}, mean={self.mean():.2f}, "
            f"p95={self.percentile(0.95):.0f}, p99={self.percentile(0.99):.0f})"
        )


class Metrics(Generic[K]):
    """Named histograms + aggregated counters (fantoch_prof/src/metrics/mod.rs:17-68)."""

    def __init__(self) -> None:
        self._collected: Dict[K, Histogram] = {}
        self._aggregated: Dict[K, int] = {}

    def collect(self, kind: K, value: int) -> None:
        self._collected.setdefault(kind, Histogram()).increment(value)

    def collect_many(self, kind: K, values) -> None:
        """Bulk histogram update from an array of values (one Counter merge
        instead of a Python call per command — the batched executor path)."""
        import numpy as np

        values = np.asarray(values)
        if values.size == 0:
            return
        uniq, counts = np.unique(values.astype(np.int64), return_counts=True)
        hist = self._collected.setdefault(kind, Histogram())
        for v, c in zip(uniq.tolist(), counts.tolist()):
            hist.increment(v, int(c))

    def aggregate(self, kind: K, by: int = 1) -> None:
        self._aggregated[kind] = self._aggregated.get(kind, 0) + by

    def get_collected(self, kind: K) -> Optional[Histogram]:
        return self._collected.get(kind)

    def get_aggregated(self, kind: K) -> Optional[int]:
        return self._aggregated.get(kind)

    def merge(self, other: "Metrics[K]") -> None:
        for kind, hist in other._collected.items():
            self._collected.setdefault(kind, Histogram()).merge(hist)
        for kind, count in other._aggregated.items():
            self._aggregated[kind] = self._aggregated.get(kind, 0) + count

    @property
    def collected(self) -> Dict[K, Histogram]:
        return self._collected

    @property
    def aggregated(self) -> Dict[K, int]:
        return self._aggregated

    def __repr__(self) -> str:
        return f"Metrics(aggregated={self._aggregated}, collected={self._collected})"
