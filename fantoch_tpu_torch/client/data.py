"""Per-client latency/throughput records.

Reference: fantoch/src/client/data.rs:6-157 — a map from end-time (ms) to
the latencies (µs) of commands that finished then, with merge/prune and
latency & throughput iterators.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple


class ClientData:
    def __init__(self) -> None:
        # end time (ms) -> list of latencies (µs)
        self._data: Dict[int, List[int]] = {}

    def record(self, latency_micros: int, end_time_millis: int) -> None:
        self._data.setdefault(end_time_millis, []).append(latency_micros)

    def merge(self, other: "ClientData") -> None:
        for end_time, latencies in other._data.items():
            self._data.setdefault(end_time, []).extend(latencies)

    def prune(self, start_millis: int, end_millis: int) -> None:
        """Keep only commands that ended within [start, end] (warmup/cooldown
        trimming in experiments)."""
        self._data = {
            t: ls for t, ls in self._data.items() if start_millis <= t <= end_millis
        }

    def latency_data(self) -> Iterator[int]:
        """All latencies in µs."""
        for latencies in self._data.values():
            yield from latencies

    def throughput_data(self) -> Iterator[Tuple[int, int]]:
        """(end_time_ms, commands finished at that ms)."""
        for end_time in sorted(self._data):
            yield end_time, len(self._data[end_time])

    def start_and_end(self) -> Tuple[int, int]:
        assert self._data, "no data recorded"
        times = self._data.keys()
        return min(times), max(times)

    def span_millis(self) -> Tuple[float, int]:
        """(first command's submit time, last command's end time), ms —
        the client's actual serving span reconstructed from the records
        (submit = end - latency), so throughput accounting can exclude
        harness boot/teardown wall it never served through."""
        assert self._data, "no data recorded"
        first = min(
            end - max(latencies) / 1000.0
            for end, latencies in self._data.items()
        )
        return first, max(self._data)

    def command_count(self) -> int:
        return sum(len(ls) for ls in self._data.values())
