"""Windowed time-series telemetry over the exact-histogram metrics plane.

The port of fantoch_tpu/observability/timeseries.py (jax-free: only its imports
are re-pointed).

The tracing plane answers "where did *this command's* time go" —
post hoc, span by span.  This layer answers "where is the time going
*right now*": every ``Config.telemetry_interval_ms`` (default 1 s) each
source emits one *window line* — per-window rates for its monotone
counters, a per-window snapshot (count/mean/p50/p95/p99/max) of each
exact histogram's delta, and its instantaneous gauges — into a
torn-tail-tolerant JSONL ring.  One schema, two timelines:

- the sim runner emits on virtual time (same seed => byte-identical
  series — the sim's determinism contract extended to telemetry);
- the run-layer runtimes (process / device / client) emit on wall time
  from a periodic task — the same cadence that writes the legacy metrics
  snapshot, so there is ONE telemetry writer per process.

A window line is canonical JSON (sorted keys, compact separators)::

    {"ctr": {name: cumulative_total},     # monotone counters
     "g":   {name: gauge},                # instantaneous values
     "h":   {name: {count, mean, p50, p95, p99, max}},  # window delta
     "k":   "win", "rate": {name: per_second}, "seq": n,
     "src": "p1", "t": <micros>, "w": <window_ms>}

``rate`` is the counter delta over the *realized* window (the wall
timeline's sleeps jitter; the denominator is measured, not assumed).
``h`` snapshots only histograms that saw samples this window — an empty
window emits ``"h": {}`` rather than repeating stale percentiles.

The file is a *ring*: after ``ring_windows`` lines the live file rotates
to ``<path>.1`` (one previous generation kept), so a long-running server
bounds its telemetry disk to ~2 rings.  The reader merges both
generations and, like the tracer's, tolerates a torn final line (crash
mid-write) per file.

No reference counterpart: ``fantoch_prof``'s metrics_logger ships only
post-hoc aggregates; this is the live instrument ROADMAP items 1 and 3
are tuned with.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from fantoch_tpu_torch.core.metrics import Histogram

# one knob's built-in default (Config.telemetry_interval_ms resolves
# over it): per-second windows, the classic dstat/Prometheus cadence
DEFAULT_WINDOW_MS = 1000
# ring bound: windows kept per generation (two generations on disk)
DEFAULT_RING_WINDOWS = 4096

# the key set every process-level source must carry (scrape validation
# and `obs watch` both key on these; names match the bench/tally keys)
REQUIRED_PROCESS_COUNTERS = ("submitted", "replied")


def hist_window_row(hist: Histogram) -> Dict[str, float]:
    """One histogram's window snapshot: the p50/p95/p99 shape consumers
    (watch, exposition, the regress gate) read without replaying the
    value->count map."""
    return {
        "count": hist.count,
        "mean": round(hist.mean(), 1),
        "p50": hist.percentile(0.50),
        "p95": hist.percentile(0.95),
        "p99": hist.percentile(0.99),
        "max": float(hist.max()),
    }


def _delta_hist(cur: Counter, prev: Counter) -> Histogram:
    """Exact histogram of the samples that arrived since the previous
    window (cumulative counters subtract exactly — the point of keeping
    exact value->count maps instead of decaying sketches)."""
    hist = Histogram()
    for value, count in cur.items():
        delta = count - prev.get(value, 0)
        if delta > 0:
            hist.increment(value, delta)
    return hist


class SeriesWriter:
    """Multi-source window emitter over one JSONL ring.

    ``time`` is any :class:`fantoch_tpu_torch.core.timing.SysTime` — the sim
    passes its virtual clock (byte-identical same-seed series), the run
    layer its wall clock.  One writer may carry several sources (the sim
    emits every process + the client plane into one file); per-source
    delta state keys on ``src``.

    ``emit`` takes *cumulative* counters and histograms: the writer owns
    the delta/rate arithmetic, so sources stay a plain "what are my
    totals right now" sample with no windowing logic at every call site.
    """

    def __init__(
        self,
        path: str,
        time,
        window_ms: int = DEFAULT_WINDOW_MS,
        ring_windows: int = DEFAULT_RING_WINDOWS,
    ):
        assert window_ms >= 1 and ring_windows >= 1
        self.path = path
        self.window_ms = window_ms
        self._time = time
        self._ring_windows = ring_windows
        # a fresh writer owns the whole ring: drop a previous run's
        # rotated generation, or the reader would prefer its (higher-seq)
        # stale windows over this run's live ones
        try:
            os.remove(path + ".1")
        except FileNotFoundError:
            pass
        self._fh = open(path, "w", buffering=1 << 16)
        self._lines = 0
        self._closed = False
        # src -> (prev_t_us, prev counter totals, prev histogram maps)
        self._prev: Dict[str, Tuple[int, Dict[str, float], Dict[str, Counter]]] = {}
        self._seq: Dict[str, int] = {}
        self._t0 = time.micros()

    def emit(
        self,
        src: str,
        counters: Optional[Dict[str, float]] = None,
        gauges: Optional[Dict[str, float]] = None,
        hists: Optional[Dict[str, Histogram]] = None,
    ) -> Dict[str, Any]:
        """Write one window line for ``src``; returns the emitted dict.

        The first window of a source spans from writer construction (the
        run's start) to now, so early activity is rated, not lost."""
        now = self._time.micros()
        counters = counters or {}
        hists = hists or {}
        prev_t, prev_ctr, prev_hists = self._prev.get(
            src, (self._t0, {}, {})
        )
        dt_s = max(now - prev_t, 1) / 1e6
        rate = {
            name: round((value - prev_ctr.get(name, 0.0)) / dt_s, 3)
            for name, value in sorted(counters.items())
        }
        hist_rows: Dict[str, Dict[str, float]] = {}
        cur_hists: Dict[str, Counter] = {}
        for name, hist in sorted(hists.items()):
            cur = Counter(dict(hist.values()))
            cur_hists[name] = cur
            delta = _delta_hist(cur, prev_hists.get(name, Counter()))
            if delta.count:
                hist_rows[name] = hist_window_row(delta)
        seq = self._seq.get(src, 0)
        ev: Dict[str, Any] = {
            "k": "win",
            "src": src,
            "seq": seq,
            "t": now,
            "w": self.window_ms,
            "ctr": dict(sorted(counters.items())),
            "rate": rate,
            "g": dict(sorted((gauges or {}).items())),
            "h": hist_rows,
        }
        self._write(ev)
        self._seq[src] = seq + 1
        self._prev[src] = (now, dict(counters), cur_hists)
        return ev

    def _write(self, ev: Dict[str, Any]) -> None:
        if self._closed:
            return
        # canonical serialization: same-seed sim series must be
        # byte-identical (the tracer's discipline)
        self._fh.write(json.dumps(ev, sort_keys=True, separators=(",", ":")))
        self._fh.write("\n")
        self._lines += 1
        if self._lines >= self._ring_windows:
            self._rotate()

    def _rotate(self) -> None:
        """Ring rollover: the live generation becomes ``<path>.1`` (the
        previous one is dropped) and a fresh live file starts.  Delta
        state survives rotation — cumulative counters keep counting."""
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "w", buffering=1 << 16)
        self._lines = 0

    def flush(self) -> None:
        if not self._closed:
            self._fh.flush()

    def close(self) -> None:
        if not self._closed:
            self._fh.flush()
            self._fh.close()
            self._closed = True


def _read_one(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail — the crash-consistent prefix ends here
    return out


def read_series(path: str) -> List[Dict[str, Any]]:
    """Read a telemetry ring: the rotated generation (``<path>.1``) first,
    then the live file, each tolerating a truncated final line.  A crash
    mid-rotation leaves at worst one whole generation missing — never a
    misparse."""
    out: List[Dict[str, Any]] = []
    for candidate in (path + ".1", path):
        if os.path.exists(candidate):
            out.extend(_read_one(candidate))
    return out


def latest_windows(
    events: List[Dict[str, Any]],
) -> Dict[str, Dict[str, Any]]:
    """Most recent window per source — what a live view renders."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("k") == "win":
            prev = out.get(ev["src"])
            if prev is None or ev["seq"] >= prev["seq"]:
                out[ev["src"]] = ev
    return out
