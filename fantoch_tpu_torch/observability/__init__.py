"""Per-dot lifecycle tracing plane: the port of fantoch_tpu/observability.

- :mod:`tracer` — sampled span emission (one schema for sim virtual time
  and run wall clock) into a crash-consistent JSONL log;
- :mod:`report` — span assembly, stage-latency breakdown (p50/p95/p99 per
  stage over :class:`fantoch_tpu_torch.core.metrics.Histogram`), trace diff;
- :mod:`recorder` — the failure flight recorder (an unsampled ring dumped
  as ``flight_p<pid>.json`` black boxes);
- :mod:`critpath` — cross-process critical-path attribution;
- :mod:`perfetto` — Chrome/Perfetto trace-event JSON conversion;
- :mod:`device` — device counters (library builds and loads from the
  build audit, per-dispatch device time by CUDA events) folded into
  metrics snapshots;
- :mod:`timeseries` — live windowed telemetry (per-window rates +
  histogram snapshots) as torn-tail-tolerant JSONL rings, on both
  timelines (sim virtual time / run wall time);
- :mod:`exposition` — Prometheus-text ``/metrics`` endpoint plus the
  on-demand ``torch.profiler`` capture trigger (HTTP ``/profile?ms=N`` or
  SIGUSR2).
"""

from fantoch_tpu_torch.observability.tracer import (
    EXTRA_STAGES,
    NOOP_TRACER,
    STAGES,
    Tracer,
    read_trace,
    span_hash,
)
from fantoch_tpu_torch.observability.device import (
    cache_hit_count,
    cache_miss_count,
    recompile_count,
    subscribe_recompiles,
)
from fantoch_tpu_torch.observability.timeseries import (
    SeriesWriter,
    latest_windows,
    read_series,
)

__all__ = [
    "SeriesWriter",
    "latest_windows",
    "read_series",
    "EXTRA_STAGES",
    "NOOP_TRACER",
    "STAGES",
    "Tracer",
    "read_trace",
    "span_hash",
    "cache_hit_count",
    "cache_miss_count",
    "recompile_count",
    "subscribe_recompiles",
]
