"""Port parity: Newt end to end through the simulator.

``fantoch_tpu_torch.sim.runner.Runner(device="cpu")`` against the JAX
package's ``Runner`` with the same seed, on the ``tests/harness.py``
shape (two keys per command at 50% conflict, message reordering on) at
n = 5, f = 2 and n = 3, f = 1, with the reference's Newt test config
(``newt_detached_send_interval_ms=100``) and the batched table executor on
its device votes-table plane (``batched_table_executor=True,
device_table_plane=True``).  The two runs must produce the same
per-process, per-key execution order (``ExecutionOrderMonitor``), the same
client latency histograms, the same FAST_PATH/SLOW_PATH/STABLE counts and
the same per-key execution digests; the port's ``ConsistencyAuditor``
must pass and every process's table plane must have dispatched.  Exact
equality throughout.

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


def run_newt(core, client, protocol, sim, n, f):
    """One harness-shaped Newt run; returns (monitors, per-key orders,
    latency histograms, path counts, digests, runner)."""
    config = core.Config(
        n, f, newt_detached_send_interval_ms=100, batched_table_executor=True,
        device_table_plane=True, execution_digests=True,
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
        protocol.Newt, planet, config, workload, CLIENTS_PER_PROCESS,
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


def test_newt_sim_matches_jax(jax_ref):
    for n, f in ((5, 2), (3, 1)):
        case = f"n={n}, f={f}"
        want = run_newt(jcore, jclient, jprotocol, jsim, n, f)
        monitors, orders, hists, paths, digests, runner = run_newt(
            tcore, tclient, tprotocol, tsim, n, f
        )
        assert orders == want[1], f"{case}: per-key execution orders differ"
        assert hists == want[2], f"{case}: client latency histograms differ"
        assert paths == want[3], f"{case}: FAST/SLOW/STABLE counts differ"
        assert digests == want[4], f"{case}: execution digests differ"
        verdict = ConsistencyAuditor().audit(monitors)
        assert verdict.ok, f"{case}: {verdict.describe()}"
        total = n * CLIENTS_PER_PROCESS * COMMANDS_PER_CLIENT
        assert all(len(set().union(*o.values())) == total for o in orders.values()), case
        for _pid, (process, executor, _q) in runner._simulation.processes():
            # the runner's device reaches the protocol's batched clocks too
            assert process.key_clocks._device == "cpu", case
            counters = executor.device_counters()
            assert counters["table_plane_dispatches"] > 0, (case, counters)
            assert counters["table_plane_failures"] == 0, (case, counters)
        if f == 2:
            assert sum(slow for _fast, slow, _stable in paths.values()) > 0, (
                f"{case}: f=2 with 50% conflicts takes slow paths")
