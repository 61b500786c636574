"""Port parity: Caesar end to end through the simulator.

``fantoch_tpu_torch.sim.runner.Runner(device="cpu")`` against the JAX
package's ``Runner`` with the same seed, on the ``tests/harness.py`` shape
(two keys per command at 50% conflict, message reordering on), in the
reference's three Caesar configs (n = 3, f = 1 with and without the wait
condition, n = 5, f = 2 with seed 2) and through each of the predecessors
executor's three routes: the per-vertex host graph,
``batched_pred_executor`` and the device predecessors plane
(``device_pred_plane``, on CPU tensors: the plain version of the pred
kernels).  The two runs must produce the same per-process, per-key
execution order (``ExecutionOrderMonitor``), the same client latency
histograms, the same FAST_PATH/SLOW_PATH/STABLE counts and the same
per-key execution digests; the port's ``ConsistencyAuditor`` must pass and
every process's pred plane must have dispatched.  Also the ``pred_clocks``
unit checks and the straggler-ack case of the reference's Caesar tests,
on the port.  Exact equality throughout.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``: tolerant duration listeners and no persistent compile
cache for the test's span.
"""

import inspect

import pytest
import torch

import jax
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

from harness import CLIENTS_PER_PROCESS, COMMANDS_PER_CLIENT, CONFLICT_RATE

import fantoch_tpu.client as jclient
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol as jprotocol
import fantoch_tpu.sim as jsim
import fantoch_tpu_torch.client as tclient
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol as tprotocol
import fantoch_tpu_torch.sim as tsim
from fantoch_tpu_torch.core.audit import ConsistencyAuditor
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import Dot, Rifl
from fantoch_tpu_torch.core.kvs import KVOp
from fantoch_tpu_torch.core.timing import SimTime
from fantoch_tpu_torch.protocol.caesar import MCommit, MPropose, MProposeAck
from fantoch_tpu_torch.protocol.base import ToSend
from fantoch_tpu_torch.protocol.common.pred_clocks import (
    Clock,
    QuorumClocks,
    SequentialKeyClocks,
)

torch.set_num_threads(1)

SHARD = 0
# (n, f, wait condition, seed): tests/test_caesar.py's three sim rows
CONFIGS = ((3, 1, True, 0), (3, 1, False, 0), (5, 2, True, 2))
ROUTES = (
    ("host", {}),
    ("batched", {"batched_pred_executor": True}),
    ("plane", {"device_pred_plane": True}),
)


def _tolerant(listener):
    """``listener`` called with only the keyword arguments it accepts."""
    try:
        params = inspect.signature(listener).parameters
    except (TypeError, ValueError):
        return listener
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return listener
    names = set(params)

    def call(event, duration, **kwargs):
        return listener(
            event, duration, **{k: v for k, v in kwargs.items() if k in names}
        )

    return call


@pytest.fixture
def jax_ref(monkeypatch):
    """Tolerant duration listeners and no persistent compile cache for the
    test's span; both restored after."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        jax_cache.reset_cache()


def run_caesar(core, client, protocol, sim, n, f, wait, seed, route):
    """One harness-shaped Caesar run; returns (monitors, per-key orders,
    latency histograms, path counts, digests, runner)."""
    config = core.Config(
        n, f, caesar_wait_condition=wait, execution_digests=True, **route,
    ).with_(
        executor_monitor_execution_order=True,
        gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
        shard_count=1,
    )
    planet = core.Planet.new("gcp")
    workload = client.Workload(
        shard_count=1,
        key_gen=client.ConflictRateKeyGen(CONFLICT_RATE),
        keys_per_command=2,
        commands_per_client=COMMANDS_PER_CLIENT,
        payload_size=1,
        read_only_percentage=0,
    )
    regions = sorted(planet.regions())[:n]
    device = {"device": "cpu"} if sim is tsim else {}
    runner = sim.Runner(
        protocol.Caesar, planet, config, workload, CLIENTS_PER_PROCESS,
        process_regions=list(regions), client_regions=list(regions), seed=seed,
        **device,
    )
    runner.reorder_messages()
    metrics, monitors, latencies = runner.run(extra_sim_time_ms=10_000)
    orders = {
        pid: {
            key: [(r.source, r.sequence) for r in monitor.get_order(key)]
            for key in sorted(monitor.keys())
        }
        for pid, monitor in monitors.items()
    }
    hists = {
        str(region): (issued, list(hist.values()))
        for region, (issued, hist) in latencies.items()
    }
    kinds = protocol.ProtocolMetricsKind
    paths = {
        pid: tuple(
            m.get_aggregated(k) or 0
            for k in (kinds.FAST_PATH, kinds.SLOW_PATH, kinds.STABLE)
        )
        for pid, m in metrics.items()
    }
    digests = {
        pid: executor.digest().summary()
        for pid, (_p, executor, _q) in runner._simulation.processes()
    }
    return monitors, orders, hists, paths, digests, runner


def cmd(seq, keys):
    return Command.from_keys(Rifl(9, seq), SHARD, {k: (KVOp.put(str(seq)),) for k in keys})


def check_pred_clocks():
    """tests/test_caesar.py's commons rows, on the port."""
    assert Clock(10, 1) < Clock(10, 2) < Clock(11, 1)
    assert Clock(9, 5).join(Clock(10, 1)) == Clock(10, 1)
    assert Clock(10, 1).join(Clock(10, 3)) == Clock(10, 3)
    assert Clock(10, 3).join(Clock(9, 9)) == Clock(10, 3)

    clocks = SequentialKeyClocks(1, SHARD)
    a, b, c = Dot(1, 1), Dot(2, 1), Dot(3, 1)
    clocks.add(a, cmd(1, ["K"]), Clock(1, 1))
    clocks.add(b, cmd(2, ["K"]), Clock(3, 2))
    higher = set()
    assert clocks.predecessors(c, cmd(3, ["K"]), Clock(2, 3), higher) == {a}
    assert higher == {b}
    assert clocks.max_seq(cmd(1, ["K"])) == 3
    assert clocks.max_seq(cmd(1, ["K"]), exclude=b) == 1
    assert clocks.max_seq(cmd(3, ["OTHER"])) == 0
    clocks.remove(cmd(1, ["K"]), Clock(1, 1))
    assert clocks.predecessors(c, cmd(3, ["K"]), Clock(2, 3)) == set()

    # fq = 3, majority = 2: a majority with one not-ok completes early
    q = QuorumClocks(1, 3, 2)
    q.add(1, Clock(1, 1), {Dot(1, 1)}, True)
    assert not q.all() and q.contains(1) and not q.contains(2)
    q.add(2, Clock(2, 2), {Dot(2, 1)}, False)
    assert q.all(), "majority replied and someone rejected"
    clock, deps, ok = q.aggregated()
    assert clock == Clock(2, 2) and deps == {Dot(1, 1), Dot(2, 1)} and not ok
    q = QuorumClocks(1, 3, 2)
    q.add(1, Clock(1, 1), {Dot(1, 1)}, True)
    q.add(2, Clock(2, 2), set(), True)
    assert not q.all(), "two DISTINCT reports are not the fq=3 quorum"


def check_straggler_ack():
    """A 5th MProposeAck after the fast quorum (4 of 5) completed is a
    no-op (tests/test_caesar.py:210)."""
    time = SimTime()
    config = tcore.Config(n=5, f=2, caesar_wait_condition=True, gc_interval_ms=100)
    caesar = tprotocol.Caesar(1, SHARD, config)
    assert caesar.discover([(pid, SHARD) for pid in range(1, 6)])
    dot = Dot(1, 1)
    caesar.submit(dot, cmd(1, ["K"]), time)
    (propose,) = [a.msg for a in caesar.to_processes_iter() if isinstance(a.msg, MPropose)]
    caesar.handle(1, SHARD, propose, time)
    (ack,) = [a.msg for a in caesar.to_processes_iter() if isinstance(a.msg, MProposeAck)]
    assert ack.ok
    for from_ in (1, 2, 3, 4):
        caesar.handle(from_, SHARD, MProposeAck(dot, ack.clock, set(ack.deps), True), time)
    actions = list(caesar.to_processes_iter())
    assert any(isinstance(a, ToSend) and isinstance(a.msg, MCommit) for a in actions)
    caesar.handle(5, SHARD, MProposeAck(dot, ack.clock, set(ack.deps), True), time)
    assert list(caesar.to_processes_iter()) == [], "straggler ack is a no-op"


def test_caesar_sim_matches_jax(jax_ref):
    check_pred_clocks()
    check_straggler_ack()
    for n, f, wait, seed in CONFIGS:
        for route_name, route in ROUTES:
            case = f"n={n}, f={f}, wait={wait}, {route_name}"
            want = run_caesar(jcore, jclient, jprotocol, jsim, n, f, wait, seed, route)
            monitors, orders, hists, paths, digests, runner = run_caesar(
                tcore, tclient, tprotocol, tsim, n, f, wait, seed, route
            )
            assert orders == want[1], f"{case}: per-key execution orders differ"
            assert hists == want[2], f"{case}: client latency histograms differ"
            assert paths == want[3], f"{case}: FAST/SLOW/STABLE counts differ"
            assert digests == want[4], f"{case}: execution digests differ"
            verdict = ConsistencyAuditor().audit(monitors)
            assert verdict.ok, f"{case}: {verdict.describe()}"
            total = n * CLIENTS_PER_PROCESS * COMMANDS_PER_CLIENT
            assert all(
                len(set().union(*o.values())) == total for o in orders.values()
            ), case
            for _pid, (_process, executor, _q) in runner._simulation.processes():
                counters = executor.device_counters()
                if route_name != "plane":
                    assert counters is None, (case, counters)
                    continue
                assert counters["pred_plane_dispatches"] > 0, (case, counters)
                assert counters["pred_plane_failures"] == 0, (case, counters)
