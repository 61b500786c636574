"""Causal critical-path attribution over a stitched multi-process trace.

The port of fantoch_tpu/observability/critpath.py (jax-free: only its imports
are re-pointed).

The span reports (observability/report.py) telescope one coordinator's
timeline; this module answers the next question — *what was each
command actually waiting on* — by stitching spans causally across
processes (Dapper-style, via the ``k == "edge"`` message events the
tracer now emits) and walking each span's DAG backwards from the
client-observed reply:

- ``submit -> payload`` splits into client→coordinator network flight
  (the ``Submit`` ingress edge) and coordinator ingest queueing;
- ``payload -> path`` is the quorum wait: the *blocking* edge is the
  latest ack delivered at the coordinator before the fast/slow
  decision, and it names WHICH peer was slowest, decomposed into
  outbound network / remote turnaround / return network via the
  matching request edge;
- ``commit -> ready`` is the dependency wait: the committed-deps stamp
  on the commit span names WHICH dot the executor was blocked on (the
  dependency whose own commit landed last at the coordinator);
- ``executed -> reply`` splits into result emit and coordinator→client
  network flight (the ``Reply`` edge).

Every attribution vector is built ON the span's stage segments, so the
entries telescope *exactly* to ``reply - submit`` — the blame report
explains the latency histogram, it never approximates it.

Clocks: sim traces share one virtual clock (``hdr.clock == "virtual"``)
and need no correction.  Run-layer traces stamp per-process wall
clocks; cross-process math first resolves per-peer offsets from the
heartbeat RTT samples the run layer emits (``k == "off"``,
run/links.ClockOffsetEstimator — best = lowest-RTT sample, NTP-style
error bound rtt/2), and client↔coordinator offsets from the spans'
own request/reply brackets (min-RTT over the trace).  Flight-recorder
dumps (observability/recorder.py) re-enter through the very same
correlator via ``flight_events``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from fantoch_tpu_torch.core.metrics import Histogram
from fantoch_tpu_torch.observability.report import (
    assemble_spans,
    counters_total,
    span_segments,
)

SpanKey = Tuple[int, int]

# client-plane hop names (edges paired by rifl, not (src, seq))
INGRESS = "Submit"
REPLY = "Reply"


# --- edge + offset collection ---


def wall_clock(events: Iterable[Dict[str, Any]]) -> bool:
    """True when any contributing log stamped wall-clock time (run
    layer): cross-process math then needs offset resolution."""
    return any(
        ev.get("k") == "hdr" and ev.get("clock") == "wall" for ev in events
    )


def match_edges(
    events: Iterable[Dict[str, Any]],
) -> Tuple[Dict[Tuple[int, int], List[Dict[str, Any]]], Dict[Tuple[SpanKey, str], Dict[str, Any]]]:
    """Pair send/recv edge events.

    Returns ``(dot_edges, client_edges)``: per-dot lists of matched
    peer hops ``{"mt", "src", "dst", "seq", "ts", "tr"}`` (``ts`` =
    send time on the sender's clock, ``tr`` = receive time on the
    receiver's; either may be None for a half-observed hop), and the
    earliest client-plane edge per ``(rifl, kind)`` (the other half of
    a client hop is the client's own submit/reply span event).

    Hops pair on ``(src, seq, dst, dot)``: the run layer allocates one
    seq per broadcast (dst disambiguates the fan-out; the frame still
    serializes once), and including the dot refuses to pair halves
    from different commands even if seq spaces ever collide (e.g. a
    peer's log retaining a previous incarnation's edges).  Duplicate
    deliveries (nemesis dup, reconnect resend) keep the EARLIEST
    receive — the first delivery is what unblocks the receiver."""
    sends: Dict[Tuple, Dict[str, Any]] = {}
    recvs: Dict[Tuple, Dict[str, Any]] = {}
    client: Dict[Tuple[SpanKey, str], Dict[str, Any]] = {}
    for ev in events:
        if ev.get("k") != "edge":
            continue
        if "rifl" in ev and ev["mt"] in (INGRESS, REPLY):
            key = (tuple(ev["rifl"]), ev["mt"])
            kept = client.get(key)
            if kept is None or ev["t"] < kept["t"]:
                client[key] = ev
            continue
        if "dot" not in ev:
            continue
        pair_key = (ev["src"], ev["seq"], ev["dst"], tuple(ev["dot"]))
        if ev["io"] == "s":
            sends.setdefault(pair_key, ev)
        else:
            kept = recvs.get(pair_key)
            if kept is None or ev["t"] < kept["t"]:
                recvs[pair_key] = ev
    dot_edges: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    for pair_key in sends.keys() | recvs.keys():
        ev = sends.get(pair_key) or recvs[pair_key]
        recv = recvs.get(pair_key)
        send = sends.get(pair_key)
        dot_edges.setdefault(tuple(ev["dot"]), []).append({
            "mt": ev["mt"],
            "src": ev["src"],
            "dst": ev["dst"],
            "seq": ev["seq"],
            "ts": send["t"] if send is not None else None,
            "tr": recv["t"] if recv is not None else None,
        })
    return dot_edges, client


class OffsetTable:
    """Pairwise clock-offset resolution.  ``best[(p, q)]`` holds the
    lowest-RTT ``(rtt_us, off_us)`` sample where ``off ≈ q's clock -
    p's clock`` as estimated BY ``p``.  ``shift(frm, to)`` returns the
    additive correction that moves a timestamp stamped on ``frm``'s
    clock into ``to``'s frame (0 in the virtual-clock domain, or when
    no sample exists for the pair)."""

    def __init__(self, events: Iterable[Dict[str, Any]], wall: bool):
        self.wall = wall
        self.best: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for ev in events:
            if ev.get("k") != "off":
                continue
            key = (ev["pid"], ev["peer"])
            kept = self.best.get(key)
            if kept is None or ev["rtt"] < kept[0]:
                self.best[key] = (ev["rtt"], ev["off"])

    def shift(self, frm: Optional[int], to: Optional[int]) -> int:
        if not self.wall or frm == to or frm is None or to is None:
            return 0
        # direct: `to` measured frm's clock as off = frm_clock - to_clock
        direct = self.best.get((to, frm))
        if direct is not None:
            return -direct[1]
        reverse = self.best.get((frm, to))
        if reverse is not None:
            return reverse[1]
        return 0

    def rows(self) -> List[Dict[str, Any]]:
        return [
            {"pid": pid, "peer": peer, "offset_us": off, "rtt_us": rtt}
            for (pid, peer), (rtt, off) in sorted(self.best.items())
        ]


def estimate_client_offsets(
    spans: Dict[SpanKey, Dict[str, Any]],
    client_edges: Dict[Tuple[SpanKey, str], Dict[str, Any]],
    wall: bool,
) -> Dict[Tuple[int, int], int]:
    """Client-plane → coordinator clock offsets, one per (client id,
    coordinator pid) pair, from the spans' own request/reply brackets:
    for each span with all four stamps (submit t0 / ingress t1 /
    reply-send t2 / reply t3) the NTP estimate is ``off = ((t1-t0) -
    (t3-t2)) / 2`` with error bounded by the bracket RTT — keep the
    lowest-RTT sample per pair.  Keyed per CLIENT, not just per
    coordinator: distinct client processes (distinct machines) have
    distinct clocks, and one client's tight bracket must not correct
    another's timestamps.  Zero in the virtual-clock domain."""
    if not wall:
        return {}
    best: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for rifl, span in spans.items():
        pid = span["pid"]
        stages = span["stages"]
        ingress = client_edges.get((rifl, INGRESS))
        reply_send = client_edges.get((rifl, REPLY))
        if (
            pid is None
            or ingress is None
            or reply_send is None
            or "submit" not in stages
            or "reply" not in stages
        ):
            continue
        t0, t3 = stages["submit"], stages["reply"]
        t1, t2 = ingress["t"], reply_send["t"]
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            continue
        off = ((t1 - t0) - (t3 - t2)) // 2
        key = (rifl[0], pid)
        kept = best.get(key)
        if kept is None or rtt < kept[0]:
            best[key] = (rtt, off)
    return {key: off for key, (_rtt, off) in best.items()}


def commit_times(
    events: Iterable[Dict[str, Any]],
) -> Dict[Tuple[Tuple[int, int], int], int]:
    """Earliest observed ``commit`` stamp per (dot, pid) — the
    dependency-wait walk asks when each dep became committed AT the
    blocked span's coordinator."""
    out: Dict[Tuple[Tuple[int, int], int], int] = {}
    for ev in events:
        if ev.get("k") != "span" or ev.get("stage") != "commit":
            continue
        dot = ev.get("dot")
        pid = ev.get("pid")
        if dot is None or pid is None:
            continue
        key = (tuple(dot), pid)
        if key not in out or ev["t"] < out[key]:
            out[key] = ev["t"]
    return out


# --- per-span attribution ---


def _clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(value, hi))


def attribute_span(
    span: Dict[str, Any],
    dot_edges: Dict[Tuple[int, int], List[Dict[str, Any]]],
    client_edges: Dict[Tuple[SpanKey, str], Dict[str, Any]],
    offsets: OffsetTable,
    client_offsets: Dict[int, int],
    commit_at: Dict[Tuple[Tuple[int, int], int], int],
) -> Dict[str, Any]:
    """One command's attribution vector.

    ``stages`` are the span's own telescoping segments (their sum IS
    ``reply - submit`` whenever both endpoints exist — exact by
    construction); ``blame`` decorates them with the blocking cause
    resolved from the edge DAG: the client/coordinator network splits,
    the slowest-quorum-member decomposition, the blocking dependency
    dot, and the out-of-chain recovery detour when one occurred."""
    rifl = span["rifl"]
    dot = span["dot"]
    pid = span["pid"]
    stages = span["stages"]
    segs = span_segments(span)
    vector: Dict[str, Any] = {
        "rifl": list(rifl),
        "dot": list(dot) if dot is not None else None,
        "pid": pid,
        "stages": {name: tb - ta for name, ta, tb in segs},
    }
    total = (
        stages["reply"] - stages["submit"]
        if "submit" in stages and "reply" in stages
        else None
    )
    vector["total_us"] = total
    blame: Dict[str, Any] = {}
    off_client = client_offsets.get((rifl[0], pid), 0)

    # submit -> first process stage: network flight vs ingest queue
    ingress = client_edges.get((rifl, INGRESS))
    first_seg = segs[0] if segs else None
    if ingress is not None and first_seg is not None and first_seg[0].startswith("submit->"):
        seg_us = first_seg[2] - first_seg[1]
        net = _clamp(ingress["t"] - (stages["submit"] + off_client), 0, seg_us)
        blame["client_net_us"] = int(net)
        blame["coord_queue_us"] = int(seg_us - net)

    # payload -> ingest: the adaptive batcher's hold (run/ingest.py) —
    # an explicit bucket, already a stage segment so it telescopes by
    # construction (the deadline budget is attributed, not hidden)
    if "payload" in stages and "ingest" in stages:
        blame["ingest_batching_us"] = int(
            _clamp(stages["ingest"] - stages["payload"], 0, float("inf"))
        )

    # payload -> path: the quorum wait and its slowest member
    if dot is not None and pid is not None and "path" in stages:
        edges = dot_edges.get(tuple(dot), ())
        acks = [
            e for e in edges
            if e["dst"] == pid and e["tr"] is not None and e["tr"] <= stages["path"]
        ]
        if acks:
            blocking = max(acks, key=lambda e: e["tr"])
            peer = blocking["src"]
            # the quorum wait starts when the round left ingest (the
            # batching hold has its own bucket above); payload is the
            # pre-batching fallback
            start = stages.get("ingest", stages.get("payload"))
            if start is None and "submit" in stages:
                # payload stamp lost (a restart truncates the
                # coordinator's log): submit is on the CLIENT clock —
                # shift it into the coordinator's domain first
                start = stages["submit"] + off_client
            quorum: Dict[str, Any] = {
                "pid": peer,
                "mt": blocking["mt"],
                "wait_us": (
                    int(_clamp(blocking["tr"] - start, 0, float("inf")))
                    if start is not None else None
                ),
            }
            # decompose via the matching outbound request hop
            request = min(
                (
                    e for e in edges
                    if e["src"] == pid and e["dst"] == peer and e["ts"] is not None
                ),
                key=lambda e: e["ts"],
                default=None,
            )
            shift = offsets.shift(peer, pid)
            if blocking["ts"] is not None:
                remote_send = blocking["ts"] + shift
                quorum["back_net_us"] = int(
                    _clamp(blocking["tr"] - remote_send, 0, float("inf"))
                )
                if request is not None and request["tr"] is not None:
                    remote_recv = request["tr"] + shift
                    quorum["out_net_us"] = int(
                        _clamp(remote_recv - request["ts"], 0, float("inf"))
                    )
                    quorum["remote_us"] = int(
                        _clamp(remote_send - remote_recv, 0, float("inf"))
                    )
            blame["quorum"] = quorum

    # commit -> ready: the blocking dependency
    deps = span["meta"].get("commit", {}).get("deps")
    if deps and pid is not None and "commit" in stages and "ready" in stages:
        observed = [
            (commit_at[key], list(dep))
            for dep in deps
            if (key := (tuple(dep), pid)) in commit_at
        ]
        if observed:
            t_dep, dep = max(observed)
            blame["dep"] = {
                "dot": dep,
                "commit_us": t_dep,
                "wait_us": int(
                    _clamp(
                        t_dep - stages["commit"], 0,
                        stages["ready"] - stages["commit"],
                    )
                ),
            }

    # executed -> reply: result emit vs return network flight
    reply_send = client_edges.get((rifl, REPLY))
    last_seg = segs[-1] if segs else None
    if reply_send is not None and last_seg is not None and last_seg[0].endswith("->reply"):
        seg_us = last_seg[2] - last_seg[1]
        net = _clamp(
            (stages["reply"] + off_client) - reply_send["t"], 0, seg_us
        )
        blame["reply_net_us"] = int(net)
        blame["emit_us"] = int(seg_us - net)

    # out-of-chain recovery detour: name it when the dot took one
    if "recovery" in stages:
        ref = stages.get("commit", stages.get("reply"))
        blame["recovery"] = {
            "entered_us": stages["recovery"],
            "to_commit_us": (
                int(ref - stages["recovery"]) if ref is not None else None
            ),
        }

    vector["blame"] = blame
    vector["stitched"] = _is_stitched(span, blame, ingress, reply_send)
    return vector


def _is_stitched(span, blame, ingress, reply_send) -> bool:
    """A span counts as *stitched* when every cross-process transition
    it exhibits was resolved from edges: the client hops both matched,
    and — for dotted spans that record a fast/slow decision — the
    blocking quorum ack was found.  Process-only spans (no client
    endpoints, e.g. an abandoned command) never count."""
    stages = span["stages"]
    if "submit" not in stages or "reply" not in stages:
        return False
    if ingress is None or reply_send is None:
        return False
    if span["dot"] is not None and "path" in stages and "quorum" not in blame:
        return False
    return True


# --- the blame report ---


def critpath_report(
    events: List[Dict[str, Any]],
    percentile: float = 0.99,
    exemplars: int = 3,
) -> Dict[str, Any]:
    """Assemble spans + edges + offsets and reduce to the p99 blame
    payload: stitch coverage, per-segment totals, the tail cohort's
    mean attribution per stage, the per-peer quorum-blame and
    network/skew tables, and the worst exemplar vectors."""
    wall = wall_clock(events)
    spans = assemble_spans(events)
    dot_edges, client_edges = match_edges(events)
    offsets = OffsetTable(events, wall)
    client_offsets = estimate_client_offsets(spans, client_edges, wall)
    commit_at = commit_times(events)
    vectors = [
        attribute_span(
            span, dot_edges, client_edges, offsets, client_offsets, commit_at
        )
        for span in spans.values()
    ]
    complete = [v for v in vectors if v["total_us"] is not None]
    stitched = [v for v in complete if v["stitched"]]
    # exactness audit: stage segments must telescope to reply - submit
    telescoping_violations = sum(
        1 for v in complete if sum(v["stages"].values()) != v["total_us"]
    )
    e2e = Histogram()
    for v in complete:
        e2e.increment(v["total_us"])
    threshold = e2e.percentile(percentile) if complete else 0
    cohort = [v for v in complete if v["total_us"] >= threshold]

    def _stage_means(vecs: List[Dict[str, Any]]) -> Dict[str, int]:
        sums: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        for v in vecs:
            for name, us in v["stages"].items():
                sums[name] = sums.get(name, 0) + us
                counts[name] = counts.get(name, 0) + 1
        return {
            name: sums[name] // counts[name] for name in sums
        }

    def _quorum_table(vecs: List[Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
        table: Dict[int, Dict[str, Any]] = {}
        for v in vecs:
            quorum = v["blame"].get("quorum")
            if quorum is None or quorum.get("wait_us") is None:
                continue
            row = table.setdefault(
                quorum["pid"],
                {"count": 0, "wait_us": 0, "net_us": 0, "remote_us": 0},
            )
            row["count"] += 1
            row["wait_us"] += quorum["wait_us"]
            row["net_us"] += quorum.get("out_net_us", 0) + quorum.get(
                "back_net_us", 0
            )
            row["remote_us"] += quorum.get("remote_us", 0)
        for row in table.values():
            for key in ("wait_us", "net_us", "remote_us"):
                row[f"mean_{key}"] = row.pop(key) // max(1, row["count"])
        return table

    def _ingest_row(vecs: List[Dict[str, Any]]) -> Dict[str, int]:
        waits = [
            v["blame"]["ingest_batching_us"]
            for v in vecs
            if "ingest_batching_us" in v["blame"]
        ]
        return {
            "spans": len(waits),
            "mean_us": sum(waits) // len(waits) if waits else 0,
            "max_us": max(waits) if waits else 0,
        }

    p99_means = _stage_means(cohort)
    dominant = max(p99_means.items(), key=lambda kv: kv[1])[0] if p99_means else None
    counters = counters_total(events)
    device = {
        name: value
        for name, value in counters.items()
        if name.startswith("device_") or name.endswith(
            ("_dispatches", "_kernel_ms", "_resident_uploads",
             "_failovers", "_rebuilds", "_degraded_ms", "_plane_health")
        )
    }
    recoveries = sum(1 for v in complete if "recovery" in v["blame"])
    degraded = _degraded_serving_row(counters)
    report: Dict[str, Any] = {
        "clock": "wall" if wall else "virtual",
        "spans": len(complete),
        "stitched": len(stitched),
        "stitch_rate": (
            round(len(stitched) / len(complete), 4) if complete else 0.0
        ),
        "telescoping_violations": telescoping_violations,
        "end_to_end_p99_us": threshold,
        "stage_means_us": _stage_means(complete),
        "p99": {
            "threshold_us": threshold,
            "count": len(cohort),
            "stage_means_us": p99_means,
            "dominant_stage": dominant,
        },
        "quorum_blame": _quorum_table(complete),
        "p99_quorum_blame": _quorum_table(cohort),
        # the adaptive batcher's hold, as an explicit bucket (exact:
        # each entry is the span's payload->ingest stage segment)
        "ingest_batching": _ingest_row(complete),
        "p99_ingest_batching": _ingest_row(cohort),
        "recovered_spans": recoveries,
        # accelerator degraded-serving blame: wall spent serving from
        # the host twin after a device failover (per plane), so a tail
        # dominated by twin-speed serving is named instead of smeared
        # across the stage segments it inflates
        "degraded_serving": degraded,
        "peers": offsets.rows(),
        # string-keyed for JSON: one estimate per (client, coordinator)
        "client_offsets_us": {
            f"c{cid}->p{pid}": off
            for (cid, pid), off in sorted(client_offsets.items())
        },
        "exemplars": sorted(
            cohort, key=lambda v: -(v["total_us"] or 0)
        )[:exemplars],
    }
    if device:
        report["device"] = device
    return report


def _degraded_serving_row(counters: Dict[str, float]) -> Dict[str, Any]:
    """The degraded-serving blame bucket: per-plane host-twin serving
    wall (``*_plane_degraded_ms``) plus failover/rebuild tallies from
    the trace's counter events.  Empty planes dict when no plane ever
    degraded — the common case costs one dict scan."""
    planes: Dict[str, Dict[str, float]] = {}
    for name, value in counters.items():
        for suffix in ("_degraded_ms", "_failovers", "_rebuilds"):
            if name.endswith(f"_plane{suffix}"):
                plane = name[: -len(f"_plane{suffix}")]
                planes.setdefault(
                    plane, {"degraded_ms": 0.0, "failovers": 0, "rebuilds": 0}
                )[suffix[1:]] = value
    planes = {
        plane: row
        for plane, row in planes.items()
        if row["failovers"] or row["degraded_ms"]
    }
    return {
        "planes": planes,
        "degraded_ms": round(
            sum(row["degraded_ms"] for row in planes.values()), 3
        ),
        "failovers": int(sum(row["failovers"] for row in planes.values())),
        "rebuilds": int(sum(row["rebuilds"] for row in planes.values())),
    }


def dominant_quorum_peer(report: Dict[str, Any], tail: bool = True) -> Optional[int]:
    """The peer contributing the most TOTAL quorum wait (count x mean;
    tail cohort by default) — what the SlowProcess/delayed-link
    assertions key on.  Total wait, not blame count: a topology where
    one peer sits in most fast quorums is blamed often for small waits,
    and the deliberately slowed peer must still dominate."""
    table = report["p99_quorum_blame" if tail else "quorum_blame"]
    if not table:
        return None
    return max(
        table.items(),
        key=lambda kv: (kv[1]["count"] * kv[1]["mean_wait_us"], -kv[0]),
    )[0]
