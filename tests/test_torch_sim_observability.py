"""Port parity: the simulator's observability, planes on, byte for byte.

EPaxos (the batched graph executor on its device graph plane) and Newt
(the batched table executor on its device votes-table plane) through
``fantoch_tpu_torch.sim.Runner(device="cpu")`` and the JAX package's
``Runner`` at the same seed, each with tracing at rate 1.0, the flight
recorder and the telemetry series on:

* the span log, the series and the flight dumps (an explicit
  ``dump_flight`` at the end of a run) are byte-identical files.  The
  reference cannot window Newt's series (its table executor keeps no
  metrics, and its runner reads them: an ``AttributeError``, asserted);
  the port's runner skips an executor without metrics, so Newt's series
  is checked on the port alone (every process windowed, every reply
  counted), and its reference run goes without the series, which moves
  no other output;
* the critical-path report (``critpath_report``) and the Perfetto JSON
  (``to_perfetto``) each package computes from its own span log are
  equal;
* a forced stall (p1 crashed at 60 ms, ``executor_pending_fail_ms`` 800:
  the reference's ``test_sim_stall_dumps_correlatable_flight_rings``
  with the plane on) raises ``StalledExecutionError`` in both, and the
  flight dumps it writes are byte-identical.

No field is excluded: the simulator writes no wall-clock value into any
of these files (device ms and ``device_idle_frac`` live in the device
counters, which the simulator neither traces nor windows).

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``.
"""

import dataclasses
import glob
import importlib
import json
import os

import pytest
import torch

from torch_jax_ref import jax_ref  # noqa: F401  (the fixture)

torch.set_num_threads(1)

JAX, PORT = "fantoch_tpu", "fantoch_tpu_torch"
SEED = 0

PROTOCOLS = {
    "EPaxos": dict(batched_graph_executor=True, device_graph_plane=True,
                   host_native_resolver=False),
    "Newt": dict(newt_detached_send_interval_ms=100, batched_table_executor=True,
                 device_table_plane=True),
}


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def sim(pkg, name, out, stall=False, telemetry=True):
    """One n = 5 (n = 3 for the stall) run of ``name`` with every
    observability output under ``out``; returns the runner and the typed
    failure that ended it (None)."""
    core, client = mod(pkg, "core"), mod(pkg, "client")
    n, f = (3, 1) if stall else (5, 2)
    knobs = dict(PROTOCOLS[name], trace_sample_rate=1.0, telemetry_interval_ms=50)
    if stall:
        knobs.update(executor_monitor_pending_interval_ms=200,
                     executor_pending_fail_ms=800)
    config = core.Config(n, f, **knobs).with_(
        executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100, shard_count=1)
    planet = core.Planet.new("gcp")
    workload = client.Workload(
        shard_count=1, key_gen=client.ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=4, payload_size=1, read_only_percentage=0)
    regions = sorted(planet.regions())[:n]
    plan = None
    if stall:
        plan = dataclasses.replace(
            mod(pkg, "sim.faults").FaultPlan().with_crash(1, at_ms=60),
            max_sim_time_ms=6000)
    kw = {"device": "cpu"} if pkg == PORT else {}
    os.makedirs(out, exist_ok=True)
    runner = mod(pkg, "sim").Runner(
        getattr(mod(pkg, "protocol"), name), planet, config, workload, 2,
        process_regions=list(regions), client_regions=list(regions), seed=SEED,
        trace_path=f"{out}/trace.jsonl", flight_dir=f"{out}/flight",
        telemetry_path=f"{out}/series.jsonl" if telemetry else None,
        fault_plan=plan, **kw)
    if not stall:
        runner.reorder_messages()
    failure = None
    try:
        runner.run(extra_sim_time_ms=2000)
    except mod(pkg, "errors").FaultToleranceError as exc:
        failure = exc
    if failure is None:
        runner.dump_flight("end of run")
    return runner, failure


def files(out):
    return {
        os.path.relpath(path, out): open(path, "rb").read()
        for path in sorted(glob.glob(f"{out}/**", recursive=True))
        if os.path.isfile(path)
    }


def derived(pkg, out):
    """The critical path and the Perfetto JSON of the span log."""
    events = mod(pkg, "observability.tracer").read_trace(f"{out}/trace.jsonl")
    report = mod(pkg, "observability.critpath").critpath_report(events)
    trace = mod(pkg, "observability.perfetto").to_perfetto(events)
    mod(pkg, "observability.perfetto").validate_perfetto(trace)
    return report, json.dumps(trace, sort_keys=True)


def test_sim_observability_matches_jax(jax_ref, tmp_path):
    for name in PROTOCOLS:
        outs = {pkg: str(tmp_path / name / pkg) for pkg in (JAX, PORT)}
        # the reference's Newt cannot window its series: its table
        # executor keeps no metrics and the runner reads them anyway
        # (ROADMAP.md Queue C); so its Newt runs without the series, which
        # changes no other output (the ticks schedule nothing else)
        ref_series = name != "Newt"
        if not ref_series:
            with pytest.raises(AttributeError):
                sim(JAX, name, str(tmp_path / name / "jax-series"))
        runs = {pkg: sim(pkg, name, outs[pkg], telemetry=ref_series or pkg == PORT)
                for pkg in (JAX, PORT)}
        assert all(failure is None for _runner, failure in runs.values()), name
        got, want = files(outs[PORT]), files(outs[JAX])
        assert {"trace.jsonl", "series.jsonl", "flight/flight_p1.json"} <= set(got)
        if not ref_series:
            series = mod(PORT, "observability.timeseries").read_series(
                f"{outs[PORT]}/series.jsonl")
            sources = mod(PORT, "observability.timeseries").latest_windows(series)
            assert sorted(sources) == ["clients"] + [f"p{p}" for p in range(1, 6)]
            assert sources["clients"]["ctr"]["replied"] == 5 * 2 * 4, sources
            del got["series.jsonl"]
        assert sorted(got) == sorted(want), name
        for path in want:
            assert got[path] == want[path], f"{name}: {path} differs"
        report, trace = derived(PORT, outs[PORT])
        assert (report, trace) == derived(JAX, outs[JAX]), name
        assert report["stitch_rate"] == 1.0, (name, report["stitch_rate"])
        assert report["telescoping_violations"] == 0, name
        runner = runs[PORT][0]
        for _pid, (_p, executor, _q) in runner._simulation.processes():
            counters = executor.device_counters()
            assert any(k.endswith("_plane_dispatches") and v > 0
                       for k, v in counters.items()), (name, counters)
    # the forced stall: typed, and the same black boxes
    outs = {pkg: str(tmp_path / "stall" / pkg) for pkg in (JAX, PORT)}
    runs = {pkg: sim(pkg, "EPaxos", outs[pkg], stall=True) for pkg in (JAX, PORT)}
    for pkg, (_runner, failure) in runs.items():
        errors = mod(pkg, "errors")
        assert isinstance(failure, errors.StalledExecutionError), (pkg, failure)
    got, want = files(outs[PORT]), files(outs[JAX])
    dumps = sorted(p for p in got if p.startswith("flight/"))
    assert dumps == ["flight/flight_clients.json"] + [
        f"flight/flight_p{p}.json" for p in (1, 2, 3)], dumps
    assert got == want
    meta = json.loads(got["flight/flight_p2.json"])
    assert meta["reason"].startswith("StalledExecutionError") and meta["events"]
    flight = mod(PORT, "observability.recorder").flight_events(
        [f"{outs[PORT]}/{p}" for p in dumps])
    report = mod(PORT, "observability.critpath").critpath_report(flight)
    assert report["spans"] > 0 and report["telescoping_violations"] == 0
