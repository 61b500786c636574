"""Port parity: EPaxos and Atlas end to end through the simulator.

``fantoch_tpu_torch.sim.runner.Runner(device="cpu")`` against the JAX
package's ``Runner`` with the same seed, on the ``tests/harness.py``
shape: n = 5, f = 2, the batched graph executor on its device graph plane,
two keys per command at 50% conflict, message reordering on.  The two
runs must produce the same per-process, per-key execution order
(``ExecutionOrderMonitor``), the same client latency histograms, the same
FAST_PATH/SLOW_PATH/STABLE counts and the same per-key execution digests
(``Config.execution_digests``); the port's own ``ConsistencyAuditor``
must pass, and its planes must have dispatched in mode ``general``.
Exact equality throughout.

Two collected items on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``.
"""

import inspect

import pytest
import torch

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
from fantoch_tpu_torch.executor.graph import graph_plane as tplane

torch.set_num_threads(1)

SEED = 0


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
    """Reference calls run with jax's duration listeners wrapped to drop
    keyword arguments they do not take (a listener registered by
    ``subscribe_recompiles`` takes none, and jax 0.9 passes
    ``fun_name=``).  Restored after the test."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )


def _run(core, client, protocol, sim, name, **knobs):
    """One harness-shaped run; returns (monitors, per-key orders, latency
    histograms, path counts, digests, runner)."""
    config = core.Config(
        5, 2, batched_graph_executor=True, device_graph_plane=True,
        execution_digests=True, **knobs,
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
    regions = sorted(planet.regions())[: config.n]
    device = {"device": "cpu"} if sim is tsim else {}
    runner = sim.Runner(
        getattr(protocol, name), planet, config, workload, CLIENTS_PER_PROCESS,
        process_regions=list(regions), client_regions=list(regions), seed=SEED,
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


def _sim_parity(name, monkeypatch):
    modes = []
    real_step = tplane.resolve_graph_plane_step

    def step(*args, mode):
        modes.append(mode)
        return real_step(*args, mode=mode)

    monkeypatch.setattr(tplane, "resolve_graph_plane_step", step)
    want = _run(jcore, jclient, jprotocol, jsim, name, host_native_resolver=False)
    got = _run(tcore, tclient, tprotocol, tsim, name)
    monitors, orders, hists, paths, digests, runner = got
    assert orders == want[1], f"{name}: per-key execution orders differ"
    assert hists == want[2], f"{name}: client latency histograms differ"
    assert paths == want[3], f"{name}: FAST/SLOW/STABLE counts differ"
    assert digests == want[4], f"{name}: execution digests differ"
    verdict = ConsistencyAuditor().audit(monitors)
    assert verdict.ok, verdict.describe()
    total = 5 * CLIENTS_PER_PROCESS * COMMANDS_PER_CLIENT
    assert all(len(set().union(*o.values())) == total for o in orders.values())
    for _pid, (_p, executor, _q) in runner._simulation.processes():
        assert executor.device_counters()["graph_plane_dispatches"] > 0
    assert "general" in modes, sorted(set(modes))


def test_epaxos_sim_matches_jax(jax_ref, monkeypatch):
    _sim_parity("EPaxos", monkeypatch)


def test_atlas_sim_matches_jax(jax_ref, monkeypatch):
    _sim_parity("Atlas", monkeypatch)
