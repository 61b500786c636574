"""The port's package rules, checked on the CPU.

* ``fantoch_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``fantoch_tpu`` (an AST scan plus a fresh interpreter that
  imports every port module, the simulator, EPaxos/Atlas and the clients
  among them).
* No silent CPU route: without CUDA, building a graph or pred plane or its
  executor without ``device=`` raises, and a wrapper handed CUDA tensors
  launches its kernel or raises — it never reaches its plain version.  An
  armed plane (graph or pred) whose dispatch is late or disagrees with its
  shadow twin raises to the caller, emits nothing from that round and
  refuses every later dispatch: no other route serves the work.  The
  kernel build targets ``sm_90a`` into a directory ``.gitignore`` lists.

Two collected items on purpose (see test_torch_graph_resolve.py).
"""

import ast
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fantoch_tpu_torch.core import Command, Config, Dot, KVOp, Rifl, RunTime
from fantoch_tpu_torch.errors import DeviceCorruptionError, DeviceFailedError
from fantoch_tpu_torch.executor.graph.batched import BatchedDependencyGraph
from fantoch_tpu_torch.executor.graph import graph_plane
from fantoch_tpu_torch.executor.graph.executor import GraphExecutor
from fantoch_tpu_torch.executor import pred_plane
from fantoch_tpu_torch.executor.pred import PredecessorsExecutionInfo, PredecessorsExecutor
from fantoch_tpu_torch.ops import _build
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve
from fantoch_tpu_torch.ops import pred_kernels as PK
from fantoch_tpu_torch.ops import pred_resolve
from fantoch_tpu_torch.protocol.common.pred_clocks import Clock
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fantoch_tpu_torch"
PLANE_CFG = Config(3, 1, batched_graph_executor=True, device_graph_plane=True)
PRED_CFG = Config(3, 1, device_pred_plane=True)


def _forbidden(name):
    return name is not None and any(
        name == root or name.startswith(root + ".") for root in ("jax", "fantoch_tpu")
    )


def test_port_imports_no_jax_and_no_reference_package():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    for entry in ("sim.runner", "protocol.graph_protocol", "protocol.caesar", "client"):
        assert f"fantoch_tpu_torch.{entry}" in modules, entry
    script = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'fantoch_tpu')]\n"
        "assert not bad, bad\n"
        "from fantoch_tpu_torch.protocol import Atlas, Caesar, EPaxos\n"
        "from fantoch_tpu_torch.sim import Runner\n"
        "from fantoch_tpu_torch.core import Planet\n"
        "assert Planet.new('gcp').regions()\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


class _PlainReached(Exception):
    pass


def _armed_graph(monkeypatch, steps, **knobs):
    """A CPU plane armed with ``knobs``, its step calls counted in
    ``steps``, and a feed helper that adds one single-key command."""
    real = graph_resolve.resolve_graph_plane_step

    def counted(*args, **kwargs):
        steps.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(graph_plane, "resolve_graph_plane_step", counted)
    config = Config(3, 1, batched_graph_executor=True, device_graph_plane=True, **knobs)
    graph = BatchedDependencyGraph(1, 0, config, device="cpu")

    def feed(seq):
        cmd = Command.from_keys(Rifl(1, seq), 0, {"a": (KVOp.put(""),)})
        graph.handle_add(Dot(1, seq), cmd, [], RunTime())
        return graph.commands_to_execute()

    return graph, feed


def _armed_plane_fails_to_the_caller(monkeypatch):
    # a late dispatch: the deadline raises, nothing of the round is
    # emitted, and the step ran once (no twin served the round)
    steps = []
    graph, feed = _armed_graph(monkeypatch, steps, device_dispatch_timeout_ms=1e-9)
    with pytest.raises(DeviceFailedError) as info:
        feed(1)
    assert info.value.kind == "timeout" and steps == ["cpu"], steps
    plane = graph._plane
    assert plane.health_name() == "failed" and plane.fault_counters()["failures"] == 1
    assert graph.commands_to_execute() == [] and plane.pending_count == 1
    # a failed plane refuses later rounds and snapshots outright
    with pytest.raises(DeviceFailedError) as info:
        feed(2)
    assert info.value.kind == "failed" and steps == ["cpu"], steps
    with pytest.raises(DeviceFailedError):
        pickle.dumps(plane)

    # a resident cell flipped between rounds: the shadow check names it
    # and the round's outputs never reach the host bookkeeping
    steps = []
    graph, feed = _armed_graph(monkeypatch, steps, plane_shadow_rate=1.0)
    assert len(feed(1)) == 1
    plane = graph._plane
    plane._resident[2][0] ^= 1  # the src column of row 0
    with pytest.raises(DeviceCorruptionError) as info:
        feed(2)
    assert (info.value.array_index, info.value.row) == (2, 0), str(info.value)
    assert graph.commands_to_execute() == [] and plane.health_name() == "failed"
    # the primary step and the twin's replay, once per round
    assert len(steps) == 4, steps
    for name in dir(K):
        if name.endswith("_plain"):
            def refuse(*_a, _name=name, **_k):
                raise _PlainReached(_name)
            monkeypatch.setattr(K, name, refuse)
    with pytest.raises(DeviceFailedError):
        feed(3)


def _armed_pred_plane_fails_to_the_caller(monkeypatch):
    # the pred plane's step calls, counted by device
    steps = []
    real = pred_resolve.resolve_pred_plane_step

    def counted(*args):
        steps.append(args[0].device.type)
        return real(*args)

    monkeypatch.setattr(pred_plane, "resolve_pred_plane_step", counted)

    def info(seq, deps=()):
        cmd = Command.from_keys(Rifl(1, seq), 0, {"a": (KVOp.put(""),)})
        return PredecessorsExecutionInfo(Dot(1, seq), cmd, Clock(seq, 1), set(deps))

    # a late dispatch raises; nothing of it executes; the plane refuses
    # later feeds without dispatching and refuses a snapshot
    ex = PredecessorsExecutor(
        1, 0, PRED_CFG.with_(device_dispatch_timeout_ms=1e-9), device="cpu"
    )
    with pytest.raises(DeviceFailedError) as info_:
        ex.handle_batch([info(1)], None)
    assert info_.value.kind == "timeout" and steps == ["cpu"], steps
    plane = ex._graph
    assert plane.health_name() == "failed" and plane.fault_counters()["failures"] == 1
    assert ex.to_clients() is None and plane.pending_count == 1
    with pytest.raises(DeviceFailedError) as info_:
        ex.handle_batch([info(2)], None)
    assert info_.value.kind == "failed" and steps == ["cpu"], steps
    with pytest.raises(DeviceFailedError):
        pickle.dumps(plane)

    # a flipped resident cell: the shadow check names it, nothing of the
    # dispatch executes, and the twin replayed once per dispatch
    steps.clear()
    ex = PredecessorsExecutor(1, 0, PRED_CFG.with_(plane_shadow_rate=1.0), device="cpu")
    ex.handle_batch([info(1)], None)
    assert ex.to_clients() is not None
    plane = ex._graph
    plane._resident[2][0] ^= 1  # the src column of row 0
    with pytest.raises(DeviceCorruptionError) as info_:
        ex.handle_batch([info(2, [Dot(1, 1)])], None)
    assert (info_.value.array_index, info_.value.row) == (2, 0), str(info_.value)
    assert ex.to_clients() is None and plane.health_name() == "failed"
    assert len(steps) == 4, steps


def test_no_silent_cpu_route(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # no device given and no CUDA: the plane, the graph and the executor raise
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedDependencyGraph(1, 0, PLANE_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphExecutor(1, 0, PLANE_CFG)
    GraphExecutor(1, 0, PLANE_CFG, device="cpu")  # an explicit CPU is fine
    # the same for the pred plane and the batched pred resolve; the host
    # predecessors graph needs no device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred_plane.DevicePredPlane(1, PRED_CFG)
    for cfg in (PRED_CFG, Config(3, 1, batched_pred_executor=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PredecessorsExecutor(1, 0, cfg)
        PredecessorsExecutor(1, 0, cfg, device="cpu")
    PredecessorsExecutor(1, 0, Config(3, 1))

    # a multi-key command rides the general mode; routes not ported yet
    # raise instead of guessing
    graph = BatchedDependencyGraph(1, 0, PLANE_CFG, device="cpu")
    two_keys = Command.from_keys(Rifl(1, 1), 0, {"a": (KVOp.put(""),), "b": (KVOp.put(""),)})
    ghost = Dot(2, 1)
    graph.handle_add(Dot(1, 1), two_keys, [Dependency(ghost, frozenset({0}))], RunTime())
    assert graph.commands_to_execute() == []
    assert graph._plane._mode() == "general" and graph._plane.dispatches == 1
    ghost_cmd = Command.from_keys(Rifl(2, 1), 0, {"a": (KVOp.put(""),)})
    graph.handle_add(ghost, ghost_cmd, [], RunTime())
    assert graph.commands_to_execute() == [ghost_cmd, two_keys]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedDependencyGraph(1, 0, Config(3, 1, batched_graph_executor=True),
                               device="cpu")
    from fantoch_tpu_torch.client import ConflictRateKeyGen, Workload
    from fantoch_tpu_torch.core import Planet
    from fantoch_tpu_torch.protocol import EPaxos
    from fantoch_tpu_torch.sim import Runner

    planet = Planet.new("gcp")
    regions = sorted(planet.regions())[:3]
    workload = Workload(1, ConflictRateKeyGen(50), 2, 1, 1)
    sim_cfg = PLANE_CFG.with_(gc_interval_ms=100)
    for kwargs in ({"telemetry_path": "t.jsonl"}, {"flight_dir": "."}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Runner(EPaxos, planet, sim_cfg, workload, 1, regions, regions,
                   device="cpu", **kwargs)
    # the simulator's default device is the card
    with pytest.raises((RuntimeError, AssertionError)):
        Runner(EPaxos, planet, sim_cfg, workload, 1, regions, regions).run()
    cap, width = 8, 2
    state = [torch.full((cap, width), -1, dtype=torch.int32)] + [
        torch.zeros(cap, dtype=torch.int32) for _ in range(3)
    ] + [torch.zeros(cap, dtype=torch.bool) for _ in range(2)]
    feed = [torch.full((4,), cap, dtype=torch.int32),
            torch.full((4, width), -1, dtype=torch.int32)] + [
        torch.zeros(4, dtype=torch.int32) for _ in range(3)
    ] + [torch.full((4,), cap, dtype=torch.int32)] + [
        torch.zeros(4, dtype=torch.int32) for _ in range(2)
    ] + [torch.full((4,), cap, dtype=torch.int32)]
    for mode in ("general", "general_resident"):
        out = graph_resolve.resolve_graph_plane_step(
            *[t.clone() for t in state], *feed, mode=mode
        )
        assert not out.newly.any() and not out.stuck.any()

    _armed_plane_fails_to_the_caller(monkeypatch)
    _armed_pred_plane_fails_to_the_caller(monkeypatch)

    # tensors that claim to live on the card never reach a plain version
    for module in (K, PK):
        for name in dir(module):
            if name.endswith("_plain"):
                def refuse(*_a, _name=name, **_k):
                    raise _PlainReached(_name)
                monkeypatch.setattr(module, name, refuse)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    pred_state = [state[0], state[1], state[2], state[4], state[5]]
    pred_feed = [feed[0], feed[1], feed[2], feed[3], feed[5], feed[6], feed[7]]
    calls = [
        lambda: graph_resolve.resolve_graph_plane_step(*state, *feed, mode="keyed"),
        lambda: graph_resolve.resolve_graph_plane_step(*state, *feed, mode="general"),
        lambda: graph_resolve.resolve_general_resident(state[0], state[1], state[2]),
        lambda: K.mutual_collapse(state[0]),
        lambda: K.affine_loop(state[0], state[0], state[4], state[1], state[1], 8),
        lambda: K.peel_stage(state[0], state[1], state[4], state[5], state[2], 4,
                             run_to_fixpoint=True),
        lambda: K.peel_compact(state[0], mode="init"),
        lambda: K.lex_sort([state[1]]),
        lambda: K.link_scan(state[1], state[2], state[3]),
        lambda: K.pointer_doubling(state[1]),
        lambda: K.group_scan(state[1], state[2]),
        lambda: K.plane_epilogue(state[4], state[5]),
        lambda: pred_resolve.resolve_pred_plane_step(*pred_state, *pred_feed),
        lambda: PK.pred_plane_step(*pred_state, *pred_feed),
    ]
    for call in calls:
        with pytest.raises(Exception) as info:
            call()
        assert not isinstance(info.value, _PlainReached), info.value

    # the build: nvcc for sm_90a, into a directory .gitignore lists
    cmd = _build.build_command(Path("x.cu"), Path("y.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    ignored = (ROOT / ".gitignore").read_text().split()
    assert str(_build.BUILD_DIR.relative_to(ROOT)) + "/" in ignored
    assert np.all(np.asarray([K.num_doubling_steps(n) for n in (2, 64, 1 << 20)])
                  == [2, 7, 21])
