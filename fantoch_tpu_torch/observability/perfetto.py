"""Chrome/Perfetto trace-event JSON conversion.

The port of fantoch_tpu/observability/perfetto.py (jax-free: only its imports
are re-pointed).

Emits the (legacy, universally-supported) Trace Event Format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

- one complete (``ph: "X"``) event per span *segment* on the
  coordinating process's track, ``tid`` = issuing client, args carrying
  the rifl/dot and any stage meta (path decision, batch id);
- flow (``ph: "s"`` / ``"f"``) event pairs per matched message edge —
  the arrows between process tracks that show WHERE a span's wait
  crossed the network (the critpath stitching, rendered);
- counter (``ph: "C"``) events for the device-plane tallies, one track
  per counter name;
- metadata (``ph: "M"``) events naming process tracks.

Timestamps are microseconds, exactly as recorded (virtual in sim
traces, wall clock in run traces).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from fantoch_tpu_torch.observability.report import assemble_spans, span_segments

# track for client-side-only spans; host-global counters (emitted with no
# pid, e.g. extension_builds) get their own track rather than polluting it
CLIENT_PID = 0
GLOBAL_PID = -1


def to_perfetto(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert a span-event stream to a trace-event JSON object."""
    spans = assemble_spans(events)
    trace: List[Dict[str, Any]] = []
    pids = set()
    for span in spans.values():
        dot = span["dot"]
        rifl = span["rifl"]
        # the span's kept timeline: the coordinator, or (dotless,
        # leader-based) the first process observed — never mislabel
        # protocol work as client-side
        pid = span["pid"] if span["pid"] is not None else CLIENT_PID
        pids.add(pid)
        for name, ta, tb in span_segments(span):
            args: Dict[str, Any] = {"rifl": f"{rifl[0]}.{rifl[1]}"}
            if dot is not None:
                args["dot"] = f"{dot[0]}.{dot[1]}"
            stage_to = name.split("->", 1)[1]
            meta = span["meta"].get(stage_to)
            if meta:
                args.update(meta)
            trace.append(
                {
                    "name": name,
                    "cat": "dot",
                    "ph": "X",
                    "ts": ta,
                    "dur": tb - ta,
                    "pid": pid,
                    "tid": rifl[0],
                    "args": args,
                }
            )
    # flow arrows between process tracks: one s/f pair per matched
    # message edge (the critpath stitching, rendered).  Flows bind to
    # the rifl's track when the dot resolves to a known span, so the
    # arrow lands on the same row as the span's segments
    from fantoch_tpu_torch.observability.critpath import match_edges

    rifl_of_dot = {
        tuple(span["dot"]): span["rifl"]
        for span in spans.values()
        if span["dot"] is not None
    }
    dot_edges, _client_edges = match_edges(events)
    for dot, hops in sorted(dot_edges.items()):
        tid = rifl_of_dot.get(dot, (0,))[0]
        for hop in hops:
            if hop["ts"] is None or hop["tr"] is None:
                continue  # half-observed hop (drop, or unsampled side)
            if hop["tr"] < hop["ts"]:
                # raw timestamps only here: a cross-machine skew larger
                # than the flight would draw a backwards arrow — skip
                # (the critpath correlator, not the viewer, owns offsets)
                continue
            # dst is part of the id: run-layer broadcasts share ONE seq
            # across the fan-out (dst disambiguates on the wire too)
            flow_id = (
                f"{dot[0]}.{dot[1]}:{hop['src']}.{hop['seq']}>{hop['dst']}"
            )
            pids.update((hop["src"], hop["dst"]))
            trace.append({
                "name": hop["mt"], "cat": "edge", "ph": "s",
                "id": flow_id, "ts": hop["ts"], "pid": hop["src"],
                "tid": tid,
            })
            trace.append({
                "name": hop["mt"], "cat": "edge", "ph": "f", "bp": "e",
                "id": flow_id, "ts": hop["tr"], "pid": hop["dst"],
                "tid": tid,
            })
    for ev in events:
        if ev.get("k") != "ctr":
            continue
        pid = ev.get("pid")
        if pid is None:
            pid = GLOBAL_PID
        pids.add(pid)
        trace.append(
            {
                "name": ev["name"],
                "cat": "device",
                "ph": "C",
                "ts": ev["t"],
                "pid": pid,
                "args": {"value": ev["v"]},
            }
        )
    for pid in sorted(pids):
        trace.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {
                    "name": (
                        "clients" if pid == CLIENT_PID
                        else "global" if pid == GLOBAL_PID
                        else f"p{pid}"
                    )
                },
            }
        )
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_perfetto(events: List[Dict[str, Any]], path: str) -> int:
    """Write the converted trace; returns the number of trace events."""
    obj = to_perfetto(events)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return len(obj["traceEvents"])


def validate_perfetto(obj: Dict[str, Any]) -> None:
    """Assert the minimal trace-event invariants the viewers rely on
    (used by tests and the trace-smoke gate)."""
    assert isinstance(obj.get("traceEvents"), list), "traceEvents missing"
    flows: dict = {}
    for ev in obj["traceEvents"]:
        assert "ph" in ev and "pid" in ev, ev
        if ev["ph"] == "X":
            assert "ts" in ev and "dur" in ev and ev["dur"] >= 0, ev
        elif ev["ph"] == "C":
            assert "ts" in ev and "value" in ev["args"], ev
        elif ev["ph"] in ("s", "f"):
            assert "ts" in ev and "id" in ev, ev
            flows.setdefault(ev["id"], []).append(ev)
    for flow_id, pair in flows.items():
        # every flow id must form a start+finish pair whose finish does
        # not precede its start (the arrow the viewers draw)
        phases = sorted(ev["ph"] for ev in pair)
        assert phases == ["f", "s"], (flow_id, phases)
        start = next(ev for ev in pair if ev["ph"] == "s")
        finish = next(ev for ev in pair if ev["ph"] == "f")
        assert finish["ts"] >= start["ts"], (flow_id, start, finish)
