"""Device counters: library builds and loads, per-dispatch device time.

The port of fantoch_tpu/observability/device.py.  The device planes do
their work in fused dispatches, so per-item latency attribution stops at
the batch boundary — what remains observable is *per-dispatch*: how many
dispatches, how long the card worked on each, how much of the serving
span it sat idle, and whether a library was built mid-run (the port's
compile wall: an ``nvcc`` run takes seconds).

* **Builds and loads.**  The JAX package counts XLA recompiles through
  ``jax.monitoring``; the port's kernels are built once per source by
  ops/_build.py (and native/), which count every compiler run and every
  ``dlopen`` in the build audit (core/compile_cache.py).  Read through
  the JAX package's names: :func:`recompile_count` is the compiler runs,
  :func:`cache_hit_count` the loads of a library already built (the
  build directory is the port's persistent cache),
  :func:`cache_miss_count` the loads that needed a build, and
  :func:`compile_ms` the compiler wall.  Nothing is subscribed: the
  loaders count themselves, so :func:`subscribe_recompiles` only says so.
* **Per-dispatch device time.**  Every plane dispatch is bracketed by a
  :class:`DispatchTimer`: two CUDA events on the current stream on a
  card, the host clock on the CPU.  The plane settles the timer once its
  blocking fetch has drained the dispatch, and the time folds into
  :func:`dispatch_counters` (per plane and in all), with
  ``device_busy_ms`` (the summed device time), ``device_span_ms`` (host
  wall from the first dispatch's start to the last one's settle) and
  :func:`derive_idle_frac`'s ``device_idle_frac``.

:func:`merge_counters` and :func:`derive_idle_frac` keep the JAX
package's fold semantics.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from fantoch_tpu_torch.core import compile_cache


def subscribe_recompiles() -> bool:
    """Build counting is always on (the loaders count themselves);
    returns True, as the JAX package's does once its hooks install."""
    return True


def recompile_count() -> int:
    """Compiler runs (nvcc / g++) in this process."""
    return sum(c["builds"] for c in compile_cache.library_counts().values())


def compile_ms() -> float:
    """Cumulative compiler wall milliseconds in this process."""
    return compile_cache.build_ms()


def cache_hit_count() -> int:
    """Loads of a library that was already built (a ``dlopen`` of the
    hashed library in the build directory, no compiler run)."""
    counts = compile_cache.library_counts().values()
    return sum(max(0, c["loads"] - c["builds"]) for c in counts)


def cache_miss_count() -> int:
    """Loads that needed a compiler run first."""
    counts = compile_cache.library_counts().values()
    return sum(min(c["loads"], c["builds"]) for c in counts)


# --- per-dispatch device time ---

# plane name -> [dispatches, device ms]; plus the serving span's ends
_dispatch: Dict[str, list] = {}
_span_start: Optional[float] = None
_span_end: Optional[float] = None


class DispatchTimer:
    """Device time of one dispatch: CUDA events around its kernels on a
    card (``start``/``stop`` record on the current stream, ``elapsed_ms``
    waits for the end event), the host clock on the CPU."""

    __slots__ = ("_cuda", "_start", "_end", "host_start")

    def __init__(self, device) -> None:
        self._cuda = getattr(device, "type", str(device)) == "cuda"
        self._start = self._end = None
        self.host_start = 0.0

    def start(self) -> "DispatchTimer":
        self.host_start = time.perf_counter()
        if self._cuda:
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def stop(self) -> None:
        if self._cuda:
            import torch

            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        else:
            self._end = time.perf_counter()

    def elapsed_ms(self) -> float:
        if self._cuda:
            self._end.synchronize()
            return float(self._start.elapsed_time(self._end))
        return (self._end - self.host_start) * 1000.0


def record_dispatch(plane: str, timers: List[DispatchTimer]) -> float:
    """Fold one drained dispatch (the brackets of its launches: a graph
    dispatch with stuck follow-ups has several) into the counters;
    returns its device milliseconds."""
    global _span_start, _span_end
    ms = sum(timer.elapsed_ms() for timer in timers)
    entry = _dispatch.setdefault(plane, [0, 0.0])
    entry[0] += 1
    entry[1] += ms
    start = timers[0].host_start
    if _span_start is None or start < _span_start:
        _span_start = start
    _span_end = time.perf_counter()
    return ms


def reset_dispatch_counters() -> None:
    global _span_start, _span_end
    _dispatch.clear()
    _span_start = _span_end = None


def dispatch_counters() -> Dict[str, float]:
    """Per-plane dispatch counts and device ms, the process totals, and
    ``device_idle_frac`` over the span from the first dispatch to the
    last."""
    out: Dict[str, float] = {}
    for plane, (count, ms) in sorted(_dispatch.items()):
        out[f"{plane}_plane_device_dispatches"] = count
        out[f"{plane}_plane_device_ms"] = round(ms, 3)
    busy = sum(ms for _count, ms in _dispatch.values())
    out["device_dispatches"] = sum(count for count, _ms in _dispatch.values())
    out["device_busy_ms"] = round(busy, 3)
    if _span_start is not None:
        out["device_span_ms"] = round((_span_end - _span_start) * 1000.0, 3)
    return derive_idle_frac(out)


def device_counters() -> Dict[str, float]:
    """Everything this module counts, as one flat dict (the metrics
    snapshot's ``device`` fold and the tracer's counter events)."""
    return {
        "extension_builds": recompile_count(),
        "extension_loads": cache_hit_count() + cache_miss_count(),
        "extension_build_ms": compile_ms(),
        **dispatch_counters(),
    }


# fold semantics per counter kind: most keys are monotone tallies and
# SUM across executors; gauges would be nonsense summed — ratios are
# dropped (derive_idle_frac recomputes from the folded walls) and
# configuration gauges fold by max
_RATIO_KEYS = frozenset({"device_idle_frac"})
_GAUGE_MAX_KEYS = frozenset(
    {
        "device_pipeline_depth",
        "pred_plane_slot_capacity",
        "graph_plane_slot_capacity",
        # plane health gauge (0 healthy / 3 failed — ordered by numeric
        # severity, so the max IS the worst health across co-hosted
        # executors)
        "table_plane_health",
        "pred_plane_health",
        "graph_plane_health",
    }
)


def merge_counters(
    into: Dict[str, float], add: Optional[Dict[str, float]]
) -> Dict[str, float]:
    """Accumulate one executor's counter dict into a process-level one
    (used by the metrics snapshot fold): tallies sum, ratio keys are
    skipped (:func:`derive_idle_frac` recomputes them from the folded
    busy/span walls), configuration gauges (pipeline depth) fold by
    max."""
    if add:
        for name, value in add.items():
            if name in _RATIO_KEYS:
                continue
            if name in _GAUGE_MAX_KEYS:
                into[name] = max(into.get(name, 0), value)
            else:
                into[name] = into.get(name, 0) + value
    return into


def derive_idle_frac(counters: Dict[str, float]) -> Dict[str, float]:
    """Recompute ``device_idle_frac`` from (possibly folded)
    ``device_busy_ms`` / ``device_span_ms`` totals: the fraction of the
    serving span the device sat idle waiting on host work.  Spans of
    co-hosted executors overlap in wall time, so after a fold this is an
    approximation (busy and span inflate together); per-process counters
    are exact."""
    span = counters.get("device_span_ms", 0.0)
    if span and span > 0:
        busy = counters.get("device_busy_ms", 0.0)
        counters["device_idle_frac"] = round(
            max(0.0, 1.0 - busy / span), 4
        )
    return counters
