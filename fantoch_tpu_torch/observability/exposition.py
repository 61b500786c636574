"""Prometheus-text exposition + on-demand device profiling.

The port of fantoch_tpu/observability/exposition.py.  Every runtime can
serve its live telemetry sample over plain HTTP: ``GET /metrics``
renders the same (counters, gauges, histograms) triple the time-series
writer windows, as Prometheus text format 0.0.4 —

- monotone counters as ``fantoch_<name>_total`` (names match the bench
  and tally keys, so a dashboard's query and a BENCH row's key agree);
- gauges as ``fantoch_<name>``;
- exact histograms as real Prometheus histograms: cumulative
  power-of-two ``le`` buckets derived from the value->count map, plus
  ``_sum``/``_count``.

``GET /profile?ms=N`` starts an on-demand ``torch.profiler`` session
(CPU and CUDA activities) for N milliseconds and saves it as a Chrome
trace next to the obs dir, so the kernels of a serving rig can be
profiled in place, no restart.  ``install_profile_signal`` arms the same
capture on SIGUSR2 for rigs without the port open.  On a card the
capture always records the card: when the profiler cannot trace CUDA,
the capture fails (an ``error`` key) rather than save a host-only trace.

The HTTP layer is deliberately tiny (asyncio streams, GET only, one
response per connection): a scrape endpoint, not a web server.  A tiny
parser (:func:`parse_prometheus`) rides along for tests — rendering and
parsing round-trip, so exposition well-formedness is checked instead of
discovered by the first real Prometheus pointed at it.
"""

from __future__ import annotations

import asyncio
import json
import re
import time as _time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from fantoch_tpu_torch.core.metrics import Histogram
from fantoch_tpu_torch.utils import logger

PREFIX = "fantoch_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def metric_name(name: str) -> str:
    """Bench/tally key -> Prometheus metric name (prefixed, sanitized)."""
    return PREFIX + _NAME_RE.sub("_", str(name))


def _fmt(value: float) -> str:
    """Canonical sample value: integers render without a trailing .0."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _labels_str(labels: Optional[Dict[str, str]], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted((labels or {}).items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def hist_buckets(hist: Histogram) -> List[Tuple[float, int]]:
    """Cumulative power-of-two buckets over an exact histogram:
    ``[(le, cumulative_count)]`` ending with ``(inf, count)``.  Bounds
    double from 1 up to the first power covering the max value, so the
    bucket count is ~log2(max) regardless of sample count."""
    values = list(hist.values())
    bounds: List[float] = [1.0]
    if values:
        top = max(v for v, _c in values)
        while bounds[-1] < top:
            bounds.append(bounds[-1] * 2)
    out: List[Tuple[float, int]] = []
    for bound in bounds:
        out.append((bound, sum(c for v, c in values if v <= bound)))
    out.append((float("inf"), hist.count))
    return out


def render_prometheus(
    counters: Optional[Dict[str, float]] = None,
    gauges: Optional[Dict[str, float]] = None,
    hists: Optional[Dict[str, Histogram]] = None,
    labels: Optional[Dict[str, str]] = None,
) -> str:
    """The (counters, gauges, histograms) telemetry triple as Prometheus
    text exposition format 0.0.4."""
    lines: List[str] = []
    base = _labels_str(labels)
    for name, value in sorted((counters or {}).items()):
        metric = metric_name(name) + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric}{base} {_fmt(value)}")
    for name, value in sorted((gauges or {}).items()):
        metric = metric_name(name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{base} {_fmt(value)}")
    for name, hist in sorted((hists or {}).items()):
        metric = metric_name(name)
        lines.append(f"# TYPE {metric} histogram")
        for le, cum in hist_buckets(hist):
            le_s = "+Inf" if le == float("inf") else _fmt(le)
            bucket_labels = _labels_str(labels, f'le="{le_s}"')
            lines.append(f"{metric}_bucket{bucket_labels} {cum}")
        total = sum(v * c for v, c in hist.values())
        lines.append(f"{metric}_sum{base} {_fmt(total)}")
        lines.append(f"{metric}_count{base} {_fmt(hist.count)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Tiny exposition parser: ``{metric: {labelset: value}}``.

    Validates well-formedness as it goes — every sample must follow a
    ``# TYPE`` declaration of its family, histogram buckets must be
    cumulative and end at ``+Inf`` — and raises ``ValueError`` on any
    violation (the round-trip test and ``obs scrape --json`` both lean
    on this being strict)."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    typed: Dict[str, str] = {}
    bucket_state: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                typed[parts[2]] = parts[3]
            continue
        match = _SAMPLE_RE.match(line)
        if match is None:
            raise ValueError(f"malformed sample line: {raw!r}")
        name = match.group("name")
        labels = tuple(sorted(_LABEL_RE.findall(match.group("labels") or "")))
        value_s = match.group("value")
        value = float("inf") if value_s == "+Inf" else float(value_s)
        family = re.sub(r"_(total|bucket|sum|count)$", "", name)
        if name not in typed and family not in typed:
            raise ValueError(f"sample {name!r} precedes its # TYPE line")
        if name.endswith("_bucket"):
            le = dict(labels).get("le")
            if le is None:
                raise ValueError(f"histogram bucket without le: {raw!r}")
            rest = tuple(kv for kv in labels if kv[0] != "le")
            key = (family, rest)
            prev = bucket_state.get(key, -1.0)
            if value < prev:
                raise ValueError(
                    f"non-cumulative buckets for {family}: {value} < {prev}"
                )
            bucket_state[key] = value
        out.setdefault(name, {})[labels] = value
    for family, kind in typed.items():
        if kind == "histogram":
            has_inf = any(
                dict(labels).get("le") == "+Inf"
                for labels in out.get(family + "_bucket", {})
            )
            if not has_inf:
                raise ValueError(f"histogram {family} missing +Inf bucket")
    return out


# --- on-demand device profiling ---

_capture_active = False


def profile_output_dir(*candidates: Optional[str]) -> str:
    """Where profiling artifacts land: next to the first configured
    observability path among ``candidates`` (telemetry series, metrics
    file), else the working directory.  ONE rule shared by the HTTP
    trigger, the SIGUSR2 handler, and both runtimes — so every trigger
    spelling saves captures to the same place."""
    import os

    for path in candidates:
        if path:
            return os.path.dirname(os.path.abspath(path))
    return "."


async def capture_device_profile(out_dir: str, ms: int) -> Dict[str, Any]:
    """One ``torch.profiler`` session of ``ms`` milliseconds (CPU and, on
    a card, CUDA activities), saved as a Chrome trace at
    ``out_dir/device_trace_<epoch_ms>.json``.  Serialized (one capture at
    a time) and cooperative: the sleep yields, so serving continues while
    the profiler records it.  A failure is reported under ``error``."""
    global _capture_active
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, supported_activities
    except Exception as exc:  # noqa: BLE001 — torch absent: report, don't die
        return {"error": f"torch.profiler unavailable: {exc!r}"}
    if _capture_active:
        return {"error": "a capture is already running"}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        # on a card the capture must see it: never a host-only trace
        if ProfilerActivity.CUDA not in supported_activities():
            return {"error": "torch.profiler cannot trace CUDA on this card"}
        activities.append(ProfilerActivity.CUDA)
    ms = max(1, min(int(ms), 60_000))
    path = f"{out_dir}/device_trace_{_time.time_ns() // 1_000_000}.json"
    _capture_active = True
    try:
        with profile(activities=activities) as session:
            await asyncio.sleep(ms / 1000)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        session.export_chrome_trace(path)
    except Exception as exc:  # noqa: BLE001 — a failed capture must not kill serving
        return {"error": f"profiler capture failed: {exc!r}"}
    finally:
        _capture_active = False
    logger.warning("device profile captured: %s (%d ms)", path, ms)
    return {
        "path": path,
        "ms": ms,
        "activities": [a.name for a in activities],
    }


def install_profile_signal(out_dir: str, ms: int = 1000) -> bool:
    """Arm SIGUSR2 to trigger a device-profile capture (for rigs without
    the metrics port open: ``kill -USR2 <pid>`` mid-run).  Returns False
    where signals can't be installed (non-main thread, Windows)."""
    import signal

    try:
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(
            signal.SIGUSR2,
            lambda: asyncio.ensure_future(capture_device_profile(out_dir, ms)),
        )
        return True
    except (NotImplementedError, RuntimeError, ValueError):
        return False


class MetricsServer:
    """Plain-asyncio exposition endpoint.

    ``sample_fn`` returns the (counters, gauges, hists) triple (and may
    be a bound runtime method — it runs on the event loop between
    handler steps, so it reads a consistent snapshot).  Routes:

    - ``GET /metrics``        -> Prometheus text exposition
    - ``GET /profile?ms=N``   -> torch.profiler capture, JSON reply
    - anything else           -> 404
    """

    def __init__(
        self,
        sample_fn,
        port: int,
        host: str = "127.0.0.1",
        labels: Optional[Dict[str, str]] = None,
        profile_dir: str = ".",
    ):
        self._sample_fn = sample_fn
        self._host = host
        self.port = port
        self._labels = labels
        self._profile_dir = profile_dir
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self._host, self.port
        )
        # port 0 = OS-assigned: publish the real one
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader, writer) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), 10.0)
            # drain headers up to the blank line (we never read a body)
            while True:
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.decode("latin-1").split()
            if len(parts) < 2 or parts[0] != "GET":
                await self._respond(writer, 405, "text/plain", "GET only\n")
                return
            url = urlparse(parts[1])
            if url.path == "/metrics":
                counters, gauges, hists = self._sample_fn()
                body = render_prometheus(counters, gauges, hists, self._labels)
                await self._respond(
                    writer, 200, "text/plain; version=0.0.4", body
                )
            elif url.path == "/profile":
                try:
                    ms = int(parse_qs(url.query).get("ms", ["1000"])[0])
                except ValueError:
                    await self._respond(
                        writer, 400, "application/json",
                        json.dumps({"error": "ms must be an integer"}) + "\n",
                    )
                    return
                result = await capture_device_profile(self._profile_dir, ms)
                await self._respond(
                    writer,
                    200 if "path" in result else 503,
                    "application/json",
                    json.dumps(result) + "\n",
                )
            else:
                await self._respond(writer, 404, "text/plain", "not found\n")
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError):
            pass  # a broken scraper is the scraper's problem
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _respond(writer, status: int, ctype: str, body: str) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed",
                  503: "Service Unavailable"}.get(status, "OK")
        payload = body.encode()
        writer.write(
            (
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n"
            ).encode()
        )
        writer.write(payload)
        await writer.drain()
