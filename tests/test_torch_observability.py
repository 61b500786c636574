"""Port parity: the observability modules on the same inputs.

``fantoch_tpu_torch/observability`` (report, recorder, timeseries,
critpath, perfetto, exposition, device) and ``utils/prof.py`` against the
JAX package's, through the jax-free rows of ``tests/test_observability.py``,
``tests/test_telemetry.py`` and ``tests/test_critpath.py``: the span
schema, span assembly after a crashed coordinator, deterministic
sampling, the series windows, the torn tail, ring rotation (and a fresh
writer over a stale generation), the Prometheus round trip, its parser's
rejections and a live scrape, the offset table and the client-offset
estimate, attribution on hand-built events, Perfetto flows, the flight
ring (bounded, SIGUSR1), the prof registry (also over a sim of the port's
classes) and ``idle_frac`` folding.  Each row runs on both packages with
the reference's assertions, and what it returns — files written, parsed
values, reports — must be equal, byte for byte where it is a file.  No
field is excluded: these rows hold no wall-clock value (the prof rows
compare the histograms' names and counts, not their microseconds).

The port's own additions are checked on the port alone: the device
counters (per-dispatch device time, ``device_idle_frac`` in [0, 1]) and
``capture_device_profile``, which on the CPU saves a CPU-only Chrome
trace.

``regress`` (the bench records' regression check) is ``bench.py``'s, not
``observability/timeseries.py``'s; the port has no bench yet, so it has
no counterpart to hold.

One collected item on purpose (ROADMAP.md Queue C); the rows run no JAX
computation, but the reference calls run under ``jax_ref`` all the same.
"""

import asyncio
import importlib
import json
import os
import signal
import time
import urllib.error
import urllib.request

import pytest

from torch_jax_ref import jax_ref  # noqa: F401  (the fixture)

JAX, PORT = "fantoch_tpu", "fantoch_tpu_torch"


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# the tracer, span assembly, sampling
# ---------------------------------------------------------------------------


def span_schema(pkg, tmp):
    SimTime = mod(pkg, "core.timing").SimTime
    perfetto = mod(pkg, "observability.perfetto")
    assemble_spans = mod(pkg, "observability.report").assemble_spans
    tracer_mod = mod(pkg, "observability.tracer")
    clock = SimTime()
    path = f"{tmp}/t.jsonl"
    tracer = tracer_mod.Tracer(clock, path, sample_rate=1.0)
    rifl, dot = (7, 1), (2, 9)
    tracer.span("submit", rifl, cid=7)
    clock.add_millis(5)
    tracer.span("payload", rifl, dot=dot, pid=2)
    tracer.span("path", rifl, dot=dot, pid=2, meta={"path": "fast"})
    clock.add_millis(5)
    tracer.span("commit", rifl, dot=dot, pid=2)
    tracer.span("ready", rifl, pid=2, meta={"batch": 1})
    tracer.span("executed", rifl, pid=2)
    clock.add_millis(5)
    tracer.span("reply", rifl, cid=7)
    tracer.counter("table_plane_dispatches", 4, pid=2)
    tracer.close()
    events = tracer_mod.read_trace(path)
    assert len(events) == 9
    assert events[0] == {"k": "hdr", "clock": "virtual", "v": 1}
    spans = assemble_spans(events)
    span = spans[rifl]
    assert span["dot"] == dot
    assert list(span["stages"]) == [
        "submit", "payload", "path", "commit", "ready", "executed", "reply"]
    assert span["meta"]["path"] == {"path": "fast"}
    trace = perfetto.to_perfetto(events)
    perfetto.validate_perfetto(trace)
    perfetto.validate_perfetto(json.loads(json.dumps(trace)))
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert "submit->payload" in names and "table_plane_dispatches" in names
    log = read_bytes(path)
    with open(path, "a") as fh:
        fh.write('{"k":"span","stage":"reply","rifl":[7,')
    assert len(tracer_mod.read_trace(path)) == 9
    return log, json.dumps(trace, sort_keys=True), repr(spans)


def crashed_coordinator(pkg, _tmp):
    assemble_spans = mod(pkg, "observability.report").assemble_spans
    rifl, dot = [7, 1], [1, 5]

    def ev(stage, t, pid=None, cid=None, meta=None):
        e = {"k": "span", "stage": stage, "rifl": rifl, "t": t}
        if pid is not None:
            e["pid"] = pid
        if cid is not None:
            e["cid"] = cid
        if meta is not None:
            e["m"] = meta
        return e

    crashed = [
        ev("submit", 0, cid=7),
        {**ev("payload", 10, pid=1), "dot": dot},
        ev("recovery", 30, pid=2, meta={"ballot": 12}),
        ev("commit", 40, pid=2),
        ev("commit", 45, pid=3),
        ev("ready", 50, pid=2),
        ev("executed", 60, pid=2),
        ev("reply", 80, cid=7),
    ]
    span = assemble_spans(crashed)[tuple(rifl)]
    assert span["stages"] == {
        "submit": 0, "payload": 10, "recovery": 30, "commit": 40,
        "ready": 50, "executed": 60, "reply": 80,
    }
    assert span["meta"]["recovery"] == {"ballot": 12}
    assert span["pid"] == 1
    healthy = [
        {**ev("payload", 10, pid=1), "dot": dot},
        ev("commit", 38, pid=2),
        ev("commit", 40, pid=1),
        ev("commit", 39, pid=3),
    ]
    healthy_span = assemble_spans(healthy)[tuple(rifl)]
    assert healthy_span["stages"]["commit"] == 40
    return repr(span), repr(healthy_span)


def traced_sim(pkg, path, seed, sample_rate):
    """The reference's ``_traced_sim``: EPaxos (host executor) at n = 3
    through the simulator, the span log at ``path``."""
    core, client = mod(pkg, "core"), mod(pkg, "client")
    config = core.Config(
        n=3, f=1, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
        trace_sample_rate=sample_rate,
    )
    planet = core.Planet.new("gcp")
    regions = sorted(planet.regions())[:3]
    workload = client.Workload(
        shard_count=1, key_gen=client.ConflictRateKeyGen(50),
        keys_per_command=2, commands_per_client=4, payload_size=1,
    )
    kw = {"device": "cpu"} if pkg == PORT else {}
    runner = mod(pkg, "sim").Runner(
        mod(pkg, "protocol").EPaxos, planet, config, workload,
        clients_per_process=2, process_regions=list(regions),
        client_regions=list(regions), seed=seed, trace_path=str(path), **kw,
    )
    runner.run(extra_sim_time_ms=1000)


def deterministic_sampling(pkg, tmp):
    assemble_spans = mod(pkg, "observability.report").assemble_spans
    tracer_mod = mod(pkg, "observability.tracer")
    SimTime = mod(pkg, "core.timing").SimTime
    traced_sim(pkg, f"{tmp}/a.jsonl", 5, 0.5)
    traced_sim(pkg, f"{tmp}/b.jsonl", 5, 0.5)
    traced_sim(pkg, f"{tmp}/full.jsonl", 5, 1.0)
    sampled_a = set(assemble_spans(tracer_mod.read_trace(f"{tmp}/a.jsonl")))
    sampled_b = set(assemble_spans(tracer_mod.read_trace(f"{tmp}/b.jsonl")))
    full = set(assemble_spans(tracer_mod.read_trace(f"{tmp}/full.jsonl")))
    assert sampled_a == sampled_b and sampled_a <= full
    threshold = int(0.5 * (1 << 32))
    assert sampled_a == {r for r in full if tracer_mod.span_hash(*r) < threshold}
    off = tracer_mod.Tracer(SimTime(), f"{tmp}/off.jsonl", sample_rate=0.0)
    assert not off.sample((1, 1))
    on = tracer_mod.Tracer(SimTime(), f"{tmp}/on.jsonl", sample_rate=1.0)
    assert all(on.sample((s, q)) for s in range(1, 5) for q in range(1, 50))
    return (sorted(sampled_a), read_bytes(f"{tmp}/a.jsonl"),
            read_bytes(f"{tmp}/full.jsonl"))


# ---------------------------------------------------------------------------
# the series
# ---------------------------------------------------------------------------


def series_windows(pkg, tmp):
    ts = mod(pkg, "observability.timeseries")
    Histogram = mod(pkg, "core.metrics").Histogram
    SimTime = mod(pkg, "core.timing").SimTime
    path = f"{tmp}/s.jsonl"
    clock = SimTime()
    writer = ts.SeriesWriter(path, clock, window_ms=1000)
    hist = Histogram()
    hist.increment(10, 4)
    clock.add_millis(1000)
    first = writer.emit("p1", {"submitted": 100}, hists={"lat": hist})
    assert first["rate"]["submitted"] == 100.0
    assert first["h"]["lat"]["count"] == 4 and first["h"]["lat"]["p50"] == 10
    hist.increment(50, 2)
    clock.add_millis(2000)
    second = writer.emit("p1", {"submitted": 160}, hists={"lat": hist})
    assert second["rate"]["submitted"] == 30.0
    assert second["h"]["lat"]["count"] == 2 and second["h"]["lat"]["p50"] == 50
    clock.add_millis(1000)
    quiet = writer.emit("p1", {"submitted": 160}, hists={"lat": hist})
    assert quiet["h"] == {} and quiet["rate"]["submitted"] == 0.0
    writer.close()
    windows = ts.read_series(path)
    assert [w["seq"] for w in windows] == [0, 1, 2]
    assert windows == [first, second, quiet]
    return read_bytes(path)


def torn_tail(pkg, tmp):
    ts = mod(pkg, "observability.timeseries")
    SimTime = mod(pkg, "core.timing").SimTime
    path = f"{tmp}/s.jsonl"
    clock = SimTime()
    writer = ts.SeriesWriter(path, clock, window_ms=1000)
    for i in range(3):
        clock.add_millis(1000)
        writer.emit("p1", {"submitted": i})
    writer.close()
    whole = ts.read_series(path)
    assert len(whole) == 3
    raw = read_bytes(path)
    with open(path, "wb") as fh:
        fh.write(raw[: raw.rfind(b'{"ctr"') + 17])
    torn = ts.read_series(path)
    assert torn == whole[:2]
    open(path, "wb").close()
    assert ts.read_series(path) == []
    return raw, torn


def ring_rotation(pkg, tmp):
    ts = mod(pkg, "observability.timeseries")
    SimTime = mod(pkg, "core.timing").SimTime
    path = f"{tmp}/s.jsonl"
    clock = SimTime()
    writer = ts.SeriesWriter(path, clock, window_ms=1000, ring_windows=4)
    for i in range(10):
        clock.add_millis(1000)
        writer.emit("p1", {"submitted": i})
    writer.close()
    windows = ts.read_series(path)
    assert 4 <= len(windows) <= 8
    last = ts.latest_windows(windows)["p1"]
    assert last["ctr"]["submitted"] == 9 and last["seq"] == 9
    rotated = (read_bytes(path), read_bytes(f"{path}.1"))
    # a fresh writer on the same path drops the stale generation
    path = f"{tmp}/r.jsonl"
    clock = SimTime()
    writer = ts.SeriesWriter(path, clock, window_ms=1000, ring_windows=3)
    for i in range(7):
        clock.add_millis(1000)
        writer.emit("p1", {"submitted": i})
    writer.close()
    assert os.path.exists(f"{path}.1")
    fresh_clock = SimTime()
    fresh = ts.SeriesWriter(path, fresh_clock, window_ms=1000, ring_windows=3)
    fresh_clock.add_millis(1000)
    fresh.emit("p1", {"submitted": 0})
    fresh.close()
    last = ts.latest_windows(ts.read_series(path))["p1"]
    assert last["seq"] == 0 and last["ctr"]["submitted"] == 0
    return rotated, windows, read_bytes(path)


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------


def prometheus(pkg, _tmp):
    ex = mod(pkg, "observability.exposition")
    Histogram = mod(pkg, "core.metrics").Histogram
    hist = Histogram()
    for value, count in ((1, 3), (7, 2), (900, 1)):
        hist.increment(value, count)
    text = ex.render_prometheus(
        {"submitted": 42, "device_busy_ms": 1.5}, {"queue_depth": 3},
        {"latency_ms": hist}, labels={"pid": "1"},
    )
    parsed = ex.parse_prometheus(text)
    labels = (("pid", "1"),)
    assert parsed["fantoch_submitted_total"][labels] == 42
    assert parsed["fantoch_device_busy_ms_total"][labels] == 1.5
    assert parsed["fantoch_queue_depth"][labels] == 3
    assert parsed["fantoch_latency_ms_count"][labels] == 6
    assert parsed["fantoch_latency_ms_sum"][labels] == 3 + 14 + 900
    buckets = parsed["fantoch_latency_ms_bucket"]
    assert next(v for k, v in buckets.items() if dict(k)["le"] == "+Inf") == 6
    assert next(v for k, v in buckets.items() if dict(k)["le"] == "1") == 3
    ordered = sorted(
        (float(dict(k)["le"].replace("+Inf", "inf")), v) for k, v in buckets.items())
    assert all(a[1] <= b[1] for a, b in zip(ordered, ordered[1:]))
    rejected = []
    for bad in (
        "fantoch_x_total 1\n",
        '# TYPE fantoch_h histogram\nfantoch_h_bucket{le="1"} 5\n'
        'fantoch_h_bucket{le="2"} 3\n',
        '# TYPE fantoch_h histogram\nfantoch_h_bucket{le="1"} 1\n',
        "# TYPE fantoch_y gauge\nfantoch_y{bad\n",
    ):
        with pytest.raises(ValueError) as info:
            ex.parse_prometheus(bad)
        rejected.append(str(info.value))
    return text, parsed, rejected, ex.profile_output_dir(None, "/a/b/c.jsonl")


def metrics_server(pkg, _tmp):
    ex = mod(pkg, "observability.exposition")
    Histogram = mod(pkg, "core.metrics").Histogram

    def sample():
        hist = Histogram()
        hist.increment(4, 2)
        return {"submitted": 9}, {"queue_depth": 1}, {"lat": hist}

    def fetch(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as reply:
                return reply.status, reply.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()

    async def scenario():
        server = ex.MetricsServer(sample, 0, labels={"pid": "7"})
        await server.start()
        try:
            loop = asyncio.get_running_loop()
            base = f"http://127.0.0.1:{server.port}"
            return [
                await loop.run_in_executor(None, fetch, base + path)
                for path in ("/metrics", "/nope", "/profile?ms=x")
            ]
        finally:
            await server.stop()

    replies = asyncio.run(scenario())
    parsed = ex.parse_prometheus(replies[0][1])
    assert parsed["fantoch_submitted_total"][(("pid", "7"),)] == 9
    assert [status for status, _body in replies] == [200, 404, 400]
    return replies


# ---------------------------------------------------------------------------
# critical path, Perfetto flows
# ---------------------------------------------------------------------------


def handbuilt_events():
    """``tests/test_critpath.py``'s one command: coordinator p1, quorum
    member p2 whose clock runs 1000us ahead."""
    rifl, dot = [9, 1], [1, 4]
    return [
        {"k": "hdr", "clock": "wall", "v": 1},
        {"k": "off", "pid": 1, "peer": 2, "off": 1000, "rtt": 120, "t": 0},
        {"k": "span", "stage": "submit", "rifl": rifl, "cid": 9, "t": 0},
        {"k": "edge", "io": "r", "mt": "Submit", "src": 0, "dst": 1,
         "seq": 0, "rifl": rifl, "t": 100},
        {"k": "span", "stage": "payload", "rifl": rifl, "dot": dot,
         "pid": 1, "t": 200},
        {"k": "edge", "io": "s", "mt": "MCollect", "src": 1, "dst": 2,
         "seq": 1, "dot": dot, "t": 210},
        {"k": "edge", "io": "r", "mt": "MCollect", "src": 1, "dst": 2,
         "seq": 1, "dot": dot, "t": 1460},
        {"k": "edge", "io": "s", "mt": "MCollectAck", "src": 2, "dst": 1,
         "seq": 1, "dot": dot, "t": 1660},
        {"k": "edge", "io": "r", "mt": "MCollectAck", "src": 2, "dst": 1,
         "seq": 1, "dot": dot, "t": 910},
        {"k": "span", "stage": "path", "rifl": rifl, "dot": dot,
         "pid": 1, "t": 1000, "m": {"path": "fast"}},
        {"k": "span", "stage": "commit", "rifl": rifl, "dot": dot,
         "pid": 1, "t": 1100, "m": {"deps": [[2, 7]]}},
        {"k": "span", "stage": "commit", "rifl": [8, 1], "dot": [2, 7],
         "pid": 1, "t": 1400},
        {"k": "span", "stage": "ready", "rifl": rifl, "pid": 1, "t": 1500},
        {"k": "span", "stage": "executed", "rifl": rifl, "pid": 1, "t": 1600},
        {"k": "edge", "io": "s", "mt": "Reply", "src": 1, "dst": 0,
         "seq": 0, "rifl": rifl, "t": 1650},
        {"k": "span", "stage": "reply", "rifl": rifl, "cid": 9, "t": 1900},
    ]


def offsets(pkg, _tmp):
    cp = mod(pkg, "observability.critpath")
    events = [
        {"k": "hdr", "clock": "wall", "v": 1},
        {"k": "off", "pid": 1, "peer": 2, "off": 500, "rtt": 300, "t": 0},
        {"k": "off", "pid": 1, "peer": 2, "off": 480, "rtt": 100, "t": 5},
    ]
    table = cp.OffsetTable(events, wall=True)
    shifts = [table.shift(a, b) for a, b in ((2, 1), (1, 2), (1, 1), (3, 1))]
    assert shifts == [-480, 480, 0, 0]
    assert cp.OffsetTable(events, wall=False).shift(2, 1) == 0
    events = handbuilt_events()
    spans = mod(pkg, "observability.report").assemble_spans(events)
    _dot_edges, client_edges = cp.match_edges(events)
    client = cp.estimate_client_offsets(spans, client_edges, wall=True)
    virtual = cp.estimate_client_offsets(spans, client_edges, wall=False)
    return shifts, client, virtual


def attribution(pkg, _tmp):
    cp = mod(pkg, "observability.critpath")
    events = handbuilt_events()
    spans = mod(pkg, "observability.report").assemble_spans(events)
    dot_edges, client_edges = cp.match_edges(events)
    table = cp.OffsetTable(events, wall=True)
    client_off = cp.estimate_client_offsets(spans, client_edges, wall=True)
    vector = cp.attribute_span(
        spans[(9, 1)], dot_edges, client_edges, table, client_off,
        cp.commit_times(events),
    )
    assert vector["stitched"]
    assert sum(vector["stages"].values()) == vector["total_us"] == 1900
    blame = vector["blame"]
    assert blame["client_net_us"] + blame["coord_queue_us"] == 200
    quorum = blame["quorum"]
    assert quorum["pid"] == 2 and quorum["mt"] == "MCollectAck"
    assert (quorum["out_net_us"], quorum["remote_us"], quorum["back_net_us"]) == (
        250, 200, 250)
    assert quorum["wait_us"] == 910 - 200
    assert blame["dep"]["dot"] == [2, 7] and blame["dep"]["wait_us"] == 300
    assert blame["emit_us"] + blame["reply_net_us"] == 300
    report = cp.critpath_report(events)
    assert report["stitch_rate"] == 1.0 and report["telescoping_violations"] == 0
    assert cp.dominant_quorum_peer(report) == 2
    return json.dumps(vector, sort_keys=True), json.dumps(report, sort_keys=True)


def perfetto_flows(pkg, _tmp):
    pf = mod(pkg, "observability.perfetto")
    edge_event = mod(pkg, "observability.tracer").edge_event
    events = [
        edge_event(10, "s", "MCollect", 1, 2, 7, dot=(1, 1)),
        edge_event(10, "s", "MCollect", 1, 3, 7, dot=(1, 1)),
        edge_event(20, "r", "MCollect", 1, 2, 7, dot=(1, 1)),
        edge_event(26, "r", "MCollect", 1, 3, 7, dot=(1, 1)),
    ]
    broadcast = pf.to_perfetto(events)
    flows = [ev for ev in broadcast["traceEvents"] if ev["ph"] in ("s", "f")]
    assert len(flows) == 4
    assert len({ev["id"] for ev in flows if ev["ph"] == "s"}) == 2
    pf.validate_perfetto(broadcast)
    handbuilt = pf.to_perfetto(handbuilt_events())
    pf.validate_perfetto(handbuilt)
    pairs = {}
    for ev in handbuilt["traceEvents"]:
        if ev["ph"] in ("s", "f"):
            pairs.setdefault(ev["id"], []).append(ev["pid"])
    assert any(len(set(p)) == 2 for p in pairs.values())
    return json.dumps(broadcast, sort_keys=True), json.dumps(handbuilt, sort_keys=True)


# ---------------------------------------------------------------------------
# the flight ring
# ---------------------------------------------------------------------------


def flight_ring(pkg, tmp, monkeypatch):
    rec = mod(pkg, "observability.recorder")
    SimTime = mod(pkg, "core.timing").SimTime
    NOOP = mod(pkg, "observability.tracer").NOOP_TRACER
    monkeypatch.setenv("FANTOCH_FLIGHT_EVENTS", "8")
    clock = SimTime()
    recorder = rec.FlightRecorder(clock, pid=4, inner=NOOP, clock="virtual")
    assert recorder.enabled and recorder.sample((1, 1))
    for sequence in range(20):
        recorder.span("submit", (1, sequence), cid=1)
    assert len(recorder.events()) == 8
    assert recorder.events()[-1]["rifl"] == [1, 19]
    path = recorder.dump(f"{tmp}/f.json", "unit")
    meta, events = rec.read_flight(path)
    assert meta["pid"] == 4 and meta["reason"] == "unit" and len(events) == 8
    monkeypatch.delenv("FANTOCH_FLIGHT_EVENTS")
    # SIGUSR1 dumps the ring (main thread, on a running loop)

    async def scenario():
        usr = rec.FlightRecorder(SimTime(), pid=7, inner=NOOP, clock="virtual")
        usr.span("submit", (1, 1), cid=1)
        assert rec.install_flight_signal(usr, tmp)
        os.kill(os.getpid(), signal.SIGUSR1)
        await asyncio.sleep(0.1)
        asyncio.get_running_loop().remove_signal_handler(signal.SIGUSR1)
        return usr

    usr = asyncio.run(scenario())
    assert usr.dumps == [f"{tmp}/flight_p7.json"]
    meta, usr_events = rec.read_flight(usr.dumps[0])
    assert meta["reason"] == "SIGUSR1" and len(usr_events) == 1
    merged = rec.flight_events([path, usr.dumps[0]])
    return read_bytes(path), read_bytes(usr.dumps[0]), merged


# ---------------------------------------------------------------------------
# prof, idle_frac folding
# ---------------------------------------------------------------------------


def prof_rows(pkg, _tmp):
    prof = mod(pkg, "utils.prof")
    Metrics = mod(pkg, "core.metrics").Metrics
    prof.reset()

    @prof.profiled
    def work():
        time.sleep(0.001)

    for _ in range(3):
        work()
    with prof.elapsed("region"):
        time.sleep(0.001)
    snap = prof.snapshot()
    hist = next(v for k, v in snap.items() if "work" in k)
    assert "region" in snap and hist.count == 3 and hist.mean() >= 1000
    assert "region" in prof.format_snapshot()
    registry = sorted((name.split(".")[-1], h.count) for name, h in snap.items())
    prof.reset()

    async def scenario():
        r1, r2 = Metrics(), Metrics()

        async def task(registry, name):
            prof.set_registry(registry)
            for _ in range(3):
                with prof.elapsed(name):
                    await asyncio.sleep(0)
            return set(prof.snapshot())

        s1, s2 = await asyncio.gather(task(r1, "one"), task(r2, "two"))
        return r1, r2, s1, s2

    r1, r2, s1, s2 = asyncio.run(scenario())
    assert set(r1.collected) == {"one"} and r1.collected["one"].count == 3
    assert set(r2.collected) == {"two"} and r2.collected["two"].count == 3
    assert s1 == {"one"} and s2 == {"two"}
    assert "one" not in prof.snapshot() and "two" not in prof.snapshot()
    with prof.scoped_registry() as reg:
        with prof.elapsed("inner"):
            pass
        assert "inner" in prof.snapshot()
    assert "inner" not in prof.snapshot() and reg.collected["inner"].count == 1
    # auto-instrumentation over the package's own classes and a sim (the
    # sim's classes imported first: only classes loaded by then are
    # wrapped, so the count of wrapped methods depends on what else the
    # process has loaded and is not compared)
    mod(pkg, "protocol"), mod(pkg, "sim")
    prof.reset()
    count = prof.auto_instrument()
    assert count > 0
    try:
        traced_sim(pkg, f"{_tmp}/prof.jsonl", 3, 0.0)
        spans = prof.snapshot()
        assert [k for k in spans if k.endswith(".handle")]
        assert [k for k in spans if "handle_batch" in k]
        assert "p99" in prof.format_snapshot()
        instrumented = sorted((k, h.count) for k, h in spans.items())
    finally:
        prof.uninstrument()
        prof.reset()
    GraphProtocol = mod(pkg, "protocol.graph_protocol").GraphProtocol
    assert not getattr(GraphProtocol.handle, "_prof_wrapped", False)
    return registry, instrumented


def idle_frac(pkg, _tmp):
    device = mod(pkg, "observability.device")
    a = {"device_busy_ms": 30.0, "device_span_ms": 100.0,
         "device_idle_frac": 0.7, "device_pipeline_depth": 2,
         "graph_plane_health": 0}
    b = {"device_busy_ms": 50.0, "device_span_ms": 100.0,
         "device_idle_frac": 0.5, "device_pipeline_depth": 2,
         "graph_plane_health": 3, "graph_plane_dispatches": 4}
    folded = device.merge_counters(device.merge_counters({}, a), b)
    assert "device_idle_frac" not in folded
    assert folded["device_pipeline_depth"] == 2
    assert folded["graph_plane_health"] == 3
    device.derive_idle_frac(folded)
    assert abs(folded["device_idle_frac"] - (1 - 80.0 / 200.0)) < 1e-9
    clamped = device.derive_idle_frac({"device_busy_ms": 5.0, "device_span_ms": 1.0})
    assert clamped["device_idle_frac"] == 0.0
    assert "device_idle_frac" not in device.derive_idle_frac({"device_busy_ms": 5.0})
    assert device.merge_counters({"x": 1}, None) == {"x": 1}
    return folded, clamped


ROWS = (
    span_schema, crashed_coordinator, deterministic_sampling, series_windows,
    torn_tail, ring_rotation, prometheus, metrics_server, offsets,
    attribution, perfetto_flows, prof_rows, idle_frac,
)


# ---------------------------------------------------------------------------
# the port's own: device counters, the profile capture
# ---------------------------------------------------------------------------


def port_device_counters(tmp):
    """Per-dispatch device time (the host clock on the CPU) through a
    table plane; the build counters read the audit."""
    import numpy as np

    device = mod(PORT, "observability.device")
    plane = mod(PORT, "executor.table_plane").DeviceTablePlane(
        3, stability_threshold=2, key_buckets=4, device="cpu")
    for k in range(4):
        plane.bucket(f"k{k}")
    device.reset_dispatch_counters()
    assert "device_idle_frac" not in device.dispatch_counters()
    for i in range(3):
        keys = np.arange(4, dtype=np.int64)
        plane.commit_votes(keys, keys % 3 + 1, keys * 0 + 1, keys * 0 + 1 + i)
    counters = device.device_counters()
    assert counters["table_plane_device_dispatches"] == 3 == plane.dispatches
    assert counters["device_dispatches"] == 3
    assert counters["table_plane_device_ms"] > 0
    assert 0.0 <= counters["device_idle_frac"] <= 1.0
    assert counters["device_busy_ms"] <= counters["device_span_ms"]
    for name in ("extension_builds", "extension_loads", "extension_build_ms"):
        assert counters[name] >= 0
    assert device.subscribe_recompiles()
    assert device.recompile_count() == counters["extension_builds"]
    assert device.cache_hit_count() + device.cache_miss_count() == counters[
        "extension_loads"]


def port_profile_capture(tmp):
    ex = mod(PORT, "observability.exposition")

    async def scenario():
        first = asyncio.ensure_future(ex.capture_device_profile(tmp, 50))
        await asyncio.sleep(0.01)
        # one capture at a time
        busy = await ex.capture_device_profile(tmp, 50)
        return await first, busy

    result, busy = asyncio.run(scenario())
    assert busy == {"error": "a capture is already running"}
    assert result["ms"] == 50 and result["activities"] == ["CPU"], result
    with open(result["path"]) as fh:
        trace = json.load(fh)
    assert "traceEvents" in trace


def test_observability_matches_jax(jax_ref, monkeypatch, tmp_path):
    for row in ROWS + (flight_ring,):
        outputs = {}
        for pkg in (JAX, PORT):
            tmp = tmp_path / row.__name__ / pkg
            tmp.mkdir(parents=True)
            args = (pkg, str(tmp)) + ((monkeypatch,) if row is flight_ring else ())
            outputs[pkg] = row(*args)
        assert outputs[PORT] == outputs[JAX], row.__name__
    port_device_counters(str(tmp_path))
    port_profile_capture(str(tmp_path))
