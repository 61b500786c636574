"""Span assembly and stage-latency breakdown over a trace event stream.

The port of fantoch_tpu/observability/report.py (jax-free: only its imports
are re-pointed).

A span log holds *events* (possibly from several processes and the
client plane); this module reduces them to one span per command and a
per-stage latency report whose segments telescope exactly to the
client-observed latency: ``sum(stage durations) == reply - submit`` for
every span with both endpoints, so the breakdown *explains* the latency
histogram instead of approximating it.

Canonical-event selection: client stages (``submit``/``reply``) come
from client events; process stages prefer the coordinator's timeline
(``pid == dot.source``) so the same stage observed at every replica does
not smear the span — but a stage the coordinator never emitted (it
crashed; recovery committed the dot elsewhere) falls back to the
earliest replica observation rather than vanishing.  Spans without a
dot (leader-based protocols) keep the earliest event per stage, and
out-of-chain stages (``recovery``) always do — the recoverer is never
the dead coordinator.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from fantoch_tpu_torch.core.metrics import Histogram
from fantoch_tpu_torch.observability.tracer import EXTRA_STAGES, STAGES

SpanKey = Tuple[int, int]  # (rifl.source, rifl.sequence)


def assemble_spans(events: Iterable[Dict[str, Any]]) -> Dict[SpanKey, Dict[str, Any]]:
    """Reduce span events to ``rifl -> {"dot", "pid", "stages":
    {stage: t_us}, "meta": {stage: m}}`` using the canonical-event
    selection above (``pid`` is the process whose timeline the span
    keeps: the coordinator, or the first process observed for dotless
    spans)."""
    events = [ev for ev in events if ev.get("k") == "span"]
    # pass 1: the dot each rifl resolved to (stamped at the payload stage)
    dots: Dict[SpanKey, Tuple[int, int]] = {}
    for ev in events:
        dot = ev.get("dot")
        if dot is not None:
            dots.setdefault(tuple(ev["rifl"]), tuple(dot))
    spans: Dict[SpanKey, Dict[str, Any]] = {}
    # per (span, stage): True when the kept event is canonical (a client
    # event, or the coordinator's own) — canonical beats fallback,
    # fallback keeps the earliest observation
    canon: Dict[Tuple[SpanKey, str], bool] = {}
    for ev in events:
        rifl = tuple(ev["rifl"])
        stage = ev["stage"]
        span = spans.setdefault(
            rifl,
            {"rifl": rifl, "dot": dots.get(rifl), "pid": None,
             "stages": {}, "meta": {}},
        )
        dot = span["dot"]
        key = (rifl, stage)
        seen = stage in span["stages"]
        if "cid" in ev:
            keep, canonical = not seen, True
        elif stage in EXTRA_STAGES or dot is None:
            # out-of-chain stages (the recoverer is never the dead
            # coordinator) and dotless (leader-based) spans: earliest
            # observation wins
            keep = not seen or ev["t"] < span["stages"][stage]
            canonical = False
        elif ev.get("pid") == dot[0]:
            # the coordinator's own timeline: replaces any replica
            # fallback, first coordinator observation wins
            keep, canonical = not (seen and canon[key]), True
        else:
            # replica re-observation: fallback so the stage survives a
            # crashed coordinator; earliest wins, never beats canonical
            keep = not seen or (
                not canon[key] and ev["t"] < span["stages"][stage]
            )
            canonical = False
        if keep:
            span["stages"][stage] = ev["t"]
            canon[key] = canonical
            if "m" in ev:
                span["meta"][stage] = ev["m"]
            elif stage in span["meta"]:
                del span["meta"][stage]
            if span["pid"] is None and "pid" in ev:
                span["pid"] = ev["pid"]
    for span in spans.values():
        if span["dot"] is not None:
            span["pid"] = span["dot"][0]
    return spans


def span_segments(span: Dict[str, Any]) -> List[Tuple[str, int, int]]:
    """Consecutive canonical-stage segments present in one span:
    ``[(name, t_start, t_end)]`` with names like ``"submit->payload"``.
    Segments are between consecutive *present* stages, so they telescope
    to ``reply - submit`` whatever stages a protocol emits."""
    present = [(s, span["stages"][s]) for s in STAGES if s in span["stages"]]
    return [
        (f"{a}->{b}", ta, tb)
        for (a, ta), (b, tb) in zip(present, present[1:])
    ]


def stage_breakdown(
    spans: Dict[SpanKey, Dict[str, Any]],
) -> Dict[str, Histogram]:
    """Per-segment latency histograms (microseconds) plus ``end_to_end``
    (reply - submit).  Feeds the exact-histogram machinery of
    :mod:`fantoch_tpu_torch.core.metrics` so percentiles match the rest of the
    metrics plane."""
    hists: Dict[str, Histogram] = {}
    for span in spans.values():
        for name, ta, tb in span_segments(span):
            hists.setdefault(name, Histogram()).increment(tb - ta)
        stages = span["stages"]
        if "submit" in stages and "reply" in stages:
            hists.setdefault("end_to_end", Histogram()).increment(
                stages["reply"] - stages["submit"]
            )
    return hists


def monotonic_violations(
    spans: Dict[SpanKey, Dict[str, Any]],
) -> List[Tuple[SpanKey, str]]:
    """Spans whose canonical stages run backwards (should be empty; a
    non-empty result means a hook site or clock is lying)."""
    bad = []
    for rifl, span in spans.items():
        for name, ta, tb in span_segments(span):
            if tb < ta:
                bad.append((rifl, name))
    return bad


def counters_total(events: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    """Final value per counter name (counters are emitted as running
    totals; the last observation wins per (name, pid), then pids sum —
    except depth gauges, where the cluster-wide value is the worst
    process's, not the sum of everyone's)."""
    last: Dict[Tuple[str, Optional[int]], float] = {}
    for ev in events:
        if ev.get("k") == "ctr":
            last[(ev["name"], ev.get("pid"))] = ev["v"]
    out: Dict[str, float] = {}
    for (name, _pid), value in last.items():
        if name.endswith(("_hwm", "_plane_health")) or name == "queue_depth":
            # gauges: the cluster-wide value is the worst process's
            # (plane health is severity-ordered, so max IS worst)
            out[name] = max(out.get(name, 0), value)
        else:
            out[name] = out.get(name, 0) + value
    return out


def _hist_row(hist: Histogram) -> Dict[str, float]:
    return {
        "count": hist.count,
        "mean_us": round(hist.mean(), 1),
        "p50_us": hist.percentile(0.50),
        "p95_us": hist.percentile(0.95),
        "p99_us": hist.percentile(0.99),
        "max_us": hist.max(),
    }


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``obs summarize`` payload: span totals, stage coverage,
    per-segment p50/p95/p99, end-to-end stats, device counters."""
    spans = assemble_spans(events)
    hists = stage_breakdown(spans)
    coverage: Dict[str, int] = {s: 0 for s in STAGES}
    for span in spans.values():
        for stage in span["stages"]:
            if stage in coverage:
                coverage[stage] += 1
    segment_order = [
        f"{a}->{b}" for a, b in zip(STAGES, STAGES[1:])
    ]
    segments = {
        name: _hist_row(hists[name])
        for name in segment_order + sorted(
            k for k in hists if k not in segment_order and k != "end_to_end"
        )
        if name in hists
    }
    out: Dict[str, Any] = {
        "spans": len(spans),
        "events": len(events),
        "stage_coverage": coverage,
        "segments": segments,
        "monotonic_violations": len(monotonic_violations(spans)),
    }
    if "end_to_end" in hists:
        out["end_to_end"] = _hist_row(hists["end_to_end"])
    counters = counters_total(events)
    if counters:
        out["device_counters"] = counters
    return out


def diff_stages(
    a: List[Dict[str, Any]],
    b: List[Dict[str, Any]],
    tol_frac: float = 0.5,
    tol_abs_us: int = 20_000,
    limit: int = 10,
) -> Dict[str, Any]:
    """Tolerance diff of assembled span *stage latencies* between two
    traces — the comparison that works for run-layer (wall-clock) logs,
    where byte identity can never hold.  Spans match by rifl (same
    workload/seed => same rifls); each matched span's per-segment
    durations must agree within ``tol_abs_us + tol_frac * max(a, b)``.
    Returns ``{"matched", "only_a", "only_b", "mismatches": [lines]}``
    — empty mismatch/only lists mean the two runs have the same latency
    *structure* within tolerance."""
    spans_a = assemble_spans(a)
    spans_b = assemble_spans(b)
    only_a = sorted(set(spans_a) - set(spans_b))
    only_b = sorted(set(spans_b) - set(spans_a))
    mismatches: List[str] = []
    matched = 0
    for rifl in sorted(set(spans_a) & set(spans_b)):
        matched += 1
        seg_a = {n: tb - ta for n, ta, tb in span_segments(spans_a[rifl])}
        seg_b = {n: tb - ta for n, ta, tb in span_segments(spans_b[rifl])}
        for name in sorted(set(seg_a) | set(seg_b)):
            if len(mismatches) >= limit:
                mismatches.append("... (diff truncated)")
                return {
                    "matched": matched, "only_a": only_a, "only_b": only_b,
                    "mismatches": mismatches,
                }
            da, db = seg_a.get(name), seg_b.get(name)
            if da is None or db is None:
                mismatches.append(
                    f"span {rifl}: segment {name} present in only one trace "
                    f"({da} vs {db})"
                )
                continue
            tol = tol_abs_us + tol_frac * max(da, db)
            if abs(da - db) > tol:
                mismatches.append(
                    f"span {rifl}: {name} {da}us vs {db}us "
                    f"(delta {abs(da - db)}us > tol {tol:.0f}us)"
                )
    return {
        "matched": matched, "only_a": only_a, "only_b": only_b,
        "mismatches": mismatches,
    }


def diff_events(
    a: List[Dict[str, Any]], b: List[Dict[str, Any]], limit: int = 10
) -> List[str]:
    """Structural diff of two event streams (order-sensitive — two
    same-seed sim traces must match event for event).  Returns
    human-readable mismatch lines, empty when identical."""
    import json

    out: List[str] = []
    if len(a) != len(b):
        out.append(f"event count differs: {len(a)} vs {len(b)}")
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea != eb:
            out.append(
                f"event {i}: "
                f"{json.dumps(ea, sort_keys=True)} != "
                f"{json.dumps(eb, sort_keys=True)}"
            )
            if len(out) >= limit:
                out.append("... (diff truncated)")
                break
    return out
