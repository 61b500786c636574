"""The simulator seeds every device plane's shadow sampler from its seed.

``Runner(..., seed=7)`` with ``Config.plane_shadow_rate=0.5`` arms every
process's device planes — the graph plane of EPaxos, the votes-table
plane of Newt and the predecessors plane of Caesar — and seeds their shadow-check sampler with the sim seed
(the draw is ``random.Random(f"{seed}:{plane}:{dispatch}")``), so a
same-seed run shadow-checks the same dispatches in both packages.  The JAX
package does it in ``sim/runner.py`` through ``Executor.device_planes()``;
the port does the same.  Checked right after construction (the planes are
armed when the runner registers each process) and after a short run.

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

import fantoch_tpu.client as jclient
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol as jprotocol
import fantoch_tpu.sim as jsim
import fantoch_tpu_torch.client as tclient
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol as tprotocol
import fantoch_tpu_torch.sim as tsim

torch.set_num_threads(1)

SEED = 7


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


def runner(core, client, protocol, sim, name, knobs):
    config = core.Config(
        3, 1, plane_shadow_rate=0.5, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100, **knobs,
    )
    planet = core.Planet.new("gcp")
    workload = client.Workload(
        shard_count=1, key_gen=client.ConflictRateKeyGen(50), keys_per_command=1,
        commands_per_client=2, payload_size=1,
    )
    regions = sorted(planet.regions())[:3]
    device = {"device": "cpu"} if sim is tsim else {}
    return sim.Runner(
        getattr(protocol, name), planet, config, workload, 1,
        process_regions=list(regions), client_regions=list(regions), seed=SEED,
        **device,
    )


def plane_seeds(run):
    return {
        (pid, plane.plane_name): (plane._fault_seed, plane._fault_pid, plane._shadow_rate)
        for pid, (_p, executor, _q) in run._simulation.processes()
        for plane in executor.device_planes()
    }


def test_planes_seeded_from_the_sim_seed(jax_ref):
    protocols = (
        ("EPaxos", {"batched_graph_executor": True, "device_graph_plane": True}),
        ("Newt", {"batched_table_executor": True, "device_table_plane": True,
                  "newt_detached_send_interval_ms": 100}),
        ("Caesar", {"device_pred_plane": True}),
    )
    kinds = {"EPaxos": "graph", "Newt": "table", "Caesar": "pred"}
    for name, knobs in protocols:
        want = {(pid, kinds[name]): (SEED, pid, 0.5) for pid in (1, 2, 3)}
        for pkg, pkgs in (("jax", (jcore, jclient, jprotocol, jsim)),
                          ("port", (tcore, tclient, tprotocol, tsim))):
            run = runner(*pkgs, name, knobs)
            assert plane_seeds(run) == want, f"{name} ({pkg}): {plane_seeds(run)}"
            run.run(extra_sim_time_ms=1_000)
            assert plane_seeds(run) == want, f"{name} ({pkg}) after a run"
