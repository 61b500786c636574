"""Port parity: the device-fault injector and fault detection on the planes.

``fantoch_tpu_torch/sim/device_faults.py`` and the injector hook of
``fantoch_tpu_torch/executor/device_plane.py`` against the JAX package's,
on the CPU (``device="cpu"``: every kernel on its plain version):

* the injector rows of ``tests/test_device_faults.py`` (the window, the
  one-shot corrupt, the process filter, the env spec and the fault plan's
  round trip), each run through both packages' injectors with the same
  results.  The port has no ``rebuild_allowed`` (no plane of it calls
  one), so the window row checks that veto on the reference only;
* hang, raise and corrupt on the table, pred and graph planes.  The
  reference fails over to its host twin and serves every batch bit for
  bit; the port raises the typed error (``DeviceFailedError``,
  ``DeviceCorruptionError`` naming the first diverging row) at the
  faulted dispatch, after the failure listener heard of it.  Asserted:
  the error at dispatch k, no kernel call for a hung or raising dispatch
  (one for a corrupt one, whose shadow check then names row 0), nothing
  emitted at or past it, a failed plane refusing the next batch, and
  every output before it equal to the reference's;
* an EPaxos sim whose fault plan hangs p2's graph plane: the typed error
  ends the port's run, one flight dump per process is written, and the
  ``device-*`` nemesis lines equal the reference's.  The one field the
  flight dumps are not compared on is ``reason``: the reference's dump
  is written by its failover listener (``device-failover-p2-graph``),
  the port's by the run's typed-failure dump (``DeviceFailedError: p2:
  graph plane dispatch #5 failed [hang]``); both name the plane.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``.
"""

import glob
import importlib
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from harness import CLIENTS_PER_PROCESS
from torch_jax_ref import jax_ref  # noqa: F401  (the fixture)

torch.set_num_threads(1)

JAX, PORT = "fantoch_tpu", "fantoch_tpu_torch"
SHARD = 0
# the flight-dump fields held unequal on purpose (see the module docstring)
FLIGHT_EXCLUDED = ("reason",)


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def device_kw(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


class Spy:
    """Counts the resident calls of a module-level step a plane
    dispatches through (on the CPU the step is the plain version: a call
    is what a kernel launch is on the card); the host twin's replays of
    the same step are not counted."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def step(*args, **kwargs):
            if sys._getframe(1).f_code.co_name != "_twin_replay":
                self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, step)


# ---------------------------------------------------------------------------
# the injector model
# ---------------------------------------------------------------------------


def injector_rows(pkg, monkeypatch):
    df = mod(pkg, "sim.device_faults")
    Plan = mod(pkg, "sim.faults").FaultPlan
    out = {}
    # the window: hang/raise re-fire inside it, not outside
    fault = df.DeviceFault("table", "hang", at_dispatch=3, down_dispatches=2)
    fired = []
    inj = df.DeviceFaultInjector([fault], 1, record=lambda *a: fired.append(a))
    out["window"] = [
        inj.on_dispatch(p, d) is fault
        for p, d in (("table", 2), ("pred", 3), ("table", 3), ("table", 4),
                     ("table", 5))
    ]
    out["window_fired"] = fired
    if pkg == JAX:
        assert not inj.rebuild_allowed("table", 4)
        assert inj.rebuild_allowed("table", 5)
        assert inj.rebuild_allowed("pred", 4)
    else:
        assert not hasattr(inj, "rebuild_allowed")
    # corrupt fires exactly once
    fault = df.DeviceFault("pred", "corrupt", at_dispatch=2, down_dispatches=4)
    inj = df.DeviceFaultInjector([fault], 1)
    out["corrupt"] = [inj.on_dispatch("pred", d) is fault for d in (2, 3)]
    out["corrupt_fired"] = inj.fired
    # the process filter
    fault = df.DeviceFault("table", "raise", at_dispatch=1, down_dispatches=2,
                           process_id=2)
    out["filter"] = [
        df.DeviceFaultInjector([fault], pid).on_dispatch("table", 1) is fault
        for pid in (1, 2, None)
    ]
    # the env spec
    faults = df.faults_from_env("table:hang:3:5:2, pred:corrupt:7")
    out["env"] = [f.to_dict() for f in faults]
    assert faults == (
        df.DeviceFault("table", "hang", at_dispatch=3, down_dispatches=5,
                       process_id=2),
        df.DeviceFault("pred", "corrupt", at_dispatch=7),
    )
    assert df.faults_from_env("") == ()
    for bad in ("table:hang", "hbm:hang:3", "table:melt:3", "table:hang:-1"):
        with pytest.raises(ValueError):
            df.faults_from_env(bad)
    # install_env_faults arms every plane given, from the environment
    class Plane:
        injector = None

        def attach_injector(self, injector):
            self.injector = injector

    planes = [Plane(), None, Plane()]
    monkeypatch.delenv(df.ENV_DEVICE_FAULT, raising=False)
    assert df.install_env_faults(planes, 1) is None
    monkeypatch.setenv(df.ENV_DEVICE_FAULT, "graph:raise:2:1:1")
    inj = df.install_env_faults(planes, 1)
    assert planes[0].injector is inj and planes[2].injector is inj
    out["installed"] = [f.to_dict() for f in inj.faults_for("graph")]
    assert df.install_env_faults([None], 1) is None
    monkeypatch.delenv(df.ENV_DEVICE_FAULT)
    # the fault plan carries device faults through its dict form
    plan = Plan(seed=3).with_device_fault(
        process_id=1, plane="graph", kind="hang", at_dispatch=4,
        down_dispatches=2,
    )
    again = Plan.from_dict(plan.to_dict())
    assert again.device_faults == plan.device_faults
    out["plan"] = [f.to_dict() for f in again.device_faults]
    return out


# ---------------------------------------------------------------------------
# the planes: the typed error at dispatch k, nothing past it
# ---------------------------------------------------------------------------


def arm(pkg, plane, fault, shadow, seed, heard):
    """Arm ``plane`` as the fault tests do; the port's also gets a failure
    listener (``heard`` collects its calls)."""
    df = mod(pkg, "sim.device_faults")
    config = mod(pkg, "core").Config(3, 1, plane_shadow_rate=shadow)
    plane.configure_faults(config, seed=seed, process_id=1)
    plane.attach_injector(df.DeviceFaultInjector([fault(pkg)], 1))
    if pkg == PORT:
        plane.attach_failure_listener(lambda p, exc: heard.append((p, exc)))


def table_feeds(rounds=12, n_keys=8):
    rng = np.random.default_rng(7)
    feeds = []
    for _ in range(rounds):
        count = 16
        vk = rng.integers(0, n_keys, count).astype(np.int64)
        vb = rng.integers(1, 4, count).astype(np.int64)
        vs = rng.integers(1, 40, count).astype(np.int64)
        feeds.append((vk, vb, vs, vs + rng.integers(0, 6, count).astype(np.int64)))
    return feeds


def table_run(pkg, fault, shadow, heard, n_keys=8):
    """The reference's ``_table_run``: the same seeded vote batches
    through a DeviceTablePlane; returns the stable clocks of every batch
    served, the error that stopped the feed (None) and the plane."""
    plane = mod(pkg, "executor.table_plane").DeviceTablePlane(
        3, stability_threshold=2, key_buckets=n_keys, **device_kw(pkg))
    for k in range(n_keys):
        plane.bucket(f"k{k}")
    if fault is not None:
        arm(pkg, plane, fault, shadow, 5, heard)
    outputs = []
    for feed in table_feeds(n_keys=n_keys):
        try:
            outputs.append(plane.commit_votes(*feed).tolist())
        except mod(pkg, "errors").FaultToleranceError as exc:
            return outputs, exc, plane, feed
    return outputs, None, plane, None


def pred_infos(pkg, count=80, keys=("Ka", "Kb", "Kc")):
    """The reference's ``_pred_workload`` (seed 42)."""
    core = mod(pkg, "core")
    Clock = mod(pkg, "protocol.common.pred_clocks").Clock
    Info = mod(pkg, "executor.pred").PredecessorsExecutionInfo
    rng = random.Random(42)
    per_key = {k: [] for k in keys}
    infos = []
    for i in range(count):
        dot = core.Dot(rng.randrange(1, 4), i + 1)
        ks = rng.sample(list(keys), rng.randrange(1, 3))
        deps = set()
        for k in ks:
            deps.update(per_key[k])
            per_key[k].append(dot)
        command = core.Command.from_keys(
            core.Rifl(9, i + 1), SHARD, {k: (core.KVOp.put(str(i)),) for k in ks})
        infos.append(Info(dot, command, Clock(i + 1, dot.source), deps))
    return infos


def pred_run(pkg, fault, shadow, heard):
    """The reference's ``_pred_run`` (7 infos a batch, per-info
    handles); returns the executed rifls of every handle served."""
    core = mod(pkg, "core")
    config = core.Config(3, 1, device_pred_plane=True,
                         executor_monitor_execution_order=True,
                         plane_shadow_rate=shadow)
    executor = mod(pkg, "executor.pred").PredecessorsExecutor(
        1, SHARD, config, **device_kw(pkg))
    if fault is not None:
        arm(pkg, executor._plane, fault, shadow, 7, heard)
    outputs = []
    for info in pred_infos(pkg):
        try:
            executor.handle(info, None)
        except mod(pkg, "errors").FaultToleranceError as exc:
            return outputs, exc, executor._plane, info
        outputs.append(sorted(
            (r.rifl.source, r.rifl.sequence) for r in executor.to_clients_iter()))
    return outputs, None, executor._plane, None


def graph_feeds():
    """The reference's ``graph_feeds`` (seed 5, two processes of six
    commands, shuffled, in feeds of 1-5)."""
    import itertools

    rng = random.Random(5)
    dots = [(pid, seq) for pid in (1, 2) for seq in range(1, 7)]
    keys = {dot: set(rng.sample(["A", "B", "C", "D"], 2)) for dot in dots}
    deps = {dot: set() for dot in dots}
    for left, right in itertools.combinations(dots, 2):
        if not (keys[left] & keys[right]):
            continue
        if left[0] == right[0]:
            deps[right if left[1] < right[1] else left].add(
                left if left[1] < right[1] else right)
        else:
            choice = rng.randrange(3)
            if choice in (0, 2):
                deps[left].add(right)
            if choice in (1, 2):
                deps[right].add(left)
    args = [(dot, sorted(keys[dot]), deps[dot]) for dot in dots]
    rng.shuffle(args)
    feeds, at = [], 0
    while at < len(args):
        size = rng.randrange(1, 6)
        feeds.append(args[at:at + size])
        at += size
    return feeds


def graph_run(pkg, fault, shadow, heard):
    """The reference's ``_graph_run`` at pipeline depth 1; returns the
    rifls drained after every feed served."""
    core = mod(pkg, "core")
    Dependency = mod(pkg, "protocol.common.graph_deps").Dependency
    config = core.Config(3, 1, host_native_resolver=False,
                         batched_graph_executor=True, device_graph_plane=True,
                         plane_shadow_rate=shadow)
    graph = mod(pkg, "executor.graph.batched").BatchedDependencyGraph(
        1, SHARD, config, **device_kw(pkg))
    if fault is not None:
        arm(pkg, graph._plane, fault, shadow, 11, heard)
    outputs = []
    for feed in graph_feeds():
        adds = [
            (core.Dot(*dot),
             core.Command.from_keys(core.Rifl(*dot), SHARD,
                                    {k: (core.KVOp.put(""),) for k in keys}),
             [Dependency(core.Dot(*d), frozenset({SHARD})) for d in sorted(deps)])
            for dot, keys, deps in feed
        ]
        try:
            graph.handle_add_batch(adds, core.RunTime())
            ready = graph.commands_to_execute()
        except mod(pkg, "errors").FaultToleranceError as exc:
            return outputs, exc, graph._plane, adds
        outputs.append([(c.rifl.source, c.rifl.sequence) for c in ready])
    return outputs, None, graph._plane, None


# plane -> (run, the port module and step its dispatch calls, how to
# feed the failed plane once more, dispatch k)
PLANES = {
    "table": (table_run, "executor.table_plane", "fused_votes_commit",
              lambda plane, feed: plane.commit_votes(*feed), 4),
    "pred": (pred_run, "executor.pred_plane", "resolve_pred_plane_step",
             None, 3),
    "graph": (graph_run, "executor.graph.graph_plane", "resolve_graph_plane_step",
              None, 2),
}


def plane_case(plane_name, kind, monkeypatch):
    run, step_module, step_name, refeed, k = PLANES[plane_name]
    shadow = 1.0 if kind == "corrupt" else 0.0

    def fault(pkg):
        return mod(pkg, "sim.device_faults").DeviceFault(
            plane_name, kind, at_dispatch=k, down_dispatches=3)

    # the reference: failover and cutback, every batch served bit for bit
    want, want_exc, want_plane, _ = run(JAX, fault, shadow, [])
    assert want_exc is None
    assert want_plane.fault_counters()["failovers"] == 1
    unfaulted = run(JAX, None, 0.0, [])[0]
    assert want == unfaulted, f"{plane_name} {kind}: the reference's failover"

    spy = Spy(monkeypatch, mod(PORT, step_module), step_name)
    heard = []
    got, exc, plane, pending = run(PORT, fault, shadow, heard)
    errors = mod(PORT, "errors")
    label = f"{plane_name} {kind}"
    if kind == "corrupt":
        assert isinstance(exc, errors.DeviceCorruptionError), (label, exc)
        assert (exc.array_index, exc.row) == (0, 0), (label, exc)
        if plane_name == "table":
            assert exc.key == "k0", exc
    else:
        assert isinstance(exc, errors.DeviceFailedError), (label, exc)
        assert exc.kind == kind, (label, exc)
    # at dispatch k: nothing counted past it; a hung or raising dispatch
    # launched nothing, a corrupt one its step once
    assert exc.dispatch == k and plane.dispatches == k, (label, exc, plane.dispatches)
    assert spy.calls == k + (kind == "corrupt"), (label, spy.calls)
    # the listener heard it, the plane is failed and refuses a next batch
    assert [(p, e) for p, e in heard] == [(plane, exc)], label
    assert plane.health_name() == "failed"
    assert plane.fault_counters()["failures"] == 1
    assert plane.last_failure is exc
    if refeed is not None:
        with pytest.raises(errors.DeviceFailedError, match=r"\[failed\]"):
            refeed(plane, pending)
    assert spy.calls == k + (kind == "corrupt"), label
    # every output before it equal to the reference's
    assert got and got == want[: len(got)], label
    return {"outputs": len(got), "dispatch": exc.dispatch}


# ---------------------------------------------------------------------------
# a sim whose fault plan carries a device fault
# ---------------------------------------------------------------------------


def sim_run(pkg, out_dir, at_dispatch=5):
    core, client = mod(pkg, "core"), mod(pkg, "client")
    plan = mod(pkg, "sim.faults").FaultPlan(seed=3).with_device_fault(
        process_id=2, plane="graph", kind="hang", at_dispatch=at_dispatch,
        down_dispatches=2)
    config = core.Config(
        5, 2, batched_graph_executor=True, device_graph_plane=True,
        host_native_resolver=False, trace_sample_rate=1.0,
    ).with_(executor_monitor_execution_order=True, gc_interval_ms=100,
            executor_executed_notification_interval_ms=100, shard_count=1)
    planet = core.Planet.new("gcp")
    workload = client.Workload(
        shard_count=1, key_gen=client.ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=4, payload_size=1, read_only_percentage=0)
    regions = sorted(planet.regions())[:5]
    runner = mod(pkg, "sim").Runner(
        mod(pkg, "protocol").EPaxos, planet, config, workload, CLIENTS_PER_PROCESS,
        process_regions=list(regions), client_regions=list(regions), seed=0,
        flight_dir=out_dir, fault_plan=plan, **device_kw(pkg))
    runner.reorder_messages()
    exc = None
    try:
        runner.run(extra_sim_time_ms=2000)
    except mod(pkg, "errors").FaultToleranceError as error:
        exc = error
    lines = [line for line in runner.nemesis.trace_lines() if " device-" in line]
    return runner, exc, lines


def read_dumps(out_dir):
    dumps = {}
    for path in sorted(glob.glob(f"{out_dir}/flight_*.json")):
        with open(path) as fh:
            dumps[os.path.basename(path)] = json.load(fh)
    return dumps


def sim_case(tmp_path):
    _ref, ref_exc, ref_lines = sim_run(JAX, str(tmp_path / "jax"))
    assert ref_exc is None  # the reference fails over and runs on
    runner, exc, lines = sim_run(PORT, str(tmp_path / "port"))
    errors = mod(PORT, "errors")
    assert isinstance(exc, errors.DeviceFailedError) and exc.kind == "hang", exc
    assert exc.plane == "graph" and exc.dispatch == 5, exc
    assert lines == ref_lines[: len(lines)], (lines, ref_lines)
    assert [line.split()[1] for line in lines] == ["device-hang", "device-failover"]
    got, want = read_dumps(tmp_path / "port"), read_dumps(tmp_path / "jax")
    names = sorted(got)
    assert names == [f"flight_p{p}.json" for p in range(1, 6)] + ["flight_clients.json"] \
        or names == ["flight_clients.json"] + [f"flight_p{p}.json" for p in range(1, 6)]
    assert sorted(want) == names
    assert sorted(runner.flight_dumps) == sorted(
        str(tmp_path / "port" / name) for name in names)
    for name in names:
        assert "graph" in got[name]["reason"], got[name]["reason"]
        assert got[name]["reason"].startswith("DeviceFailedError")
        strip = lambda blob: {k: v for k, v in blob.items() if k not in FLIGHT_EXCLUDED}
        assert strip(got[name]) == strip(want[name]), name
    return lines


def test_device_faults_match_jax(jax_ref, monkeypatch, tmp_path):
    rows = {pkg: injector_rows(pkg, monkeypatch) for pkg in (JAX, PORT)}
    assert rows[PORT] == rows[JAX]
    for plane_name in PLANES:
        for kind in ("hang", "raise", "corrupt"):
            with monkeypatch.context() as patch:
                plane_case(plane_name, kind, patch)
    sim_case(tmp_path)
