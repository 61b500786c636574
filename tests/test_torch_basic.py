"""Port parity: the Basic protocol and its executor.

``tests/test_protocol_basic.py``'s message walk and
``tests/test_sim_basic.py``'s two rows not marked slow, on the port
(``fantoch_tpu_torch.protocol.basic``, ``executor/basic.py``): each hop of
the Basic flow, the simulator's exact mean latencies for f = 0, 1, 2 (the
reference's golden numbers, fantoch/src/sim/runner.rs:726-866) with the
port's ``Runner(device="cpu")`` and the JAX package's ``Runner`` giving
the same latency histograms and STABLE counts, and the schedule's flow.
Exact equality throughout.

One collected item on purpose (ROADMAP.md Queue C).
"""

import os

import torch

import fantoch_tpu.client as jclient
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol as jprotocol
import fantoch_tpu.sim as jsim
import fantoch_tpu_torch.client as tclient
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol as tprotocol
import fantoch_tpu_torch.sim as tsim
from fantoch_tpu_torch.protocol import Basic, ToForward, ToSend
from fantoch_tpu_torch.protocol.basic import MCommit, MCommitDot, MStore, MStoreAck
from fantoch_tpu_torch.utils import closest_process_per_shard, sort_processes_by_distance

torch.set_num_threads(1)

# tests/test_sim_basic.py's load (shrunk under CI, as there)
COMMANDS_PER_CLIENT = 100 if os.environ.get("CI") else 1000


def run_basic(core, client, protocol, sim, f):
    """Basic on three GCP regions, clients in us-west1/us-west2; returns
    (per-region (issued, histogram), STABLE per process, means)."""
    planet = core.Planet.new("gcp")
    config = core.Config(n=3, f=f, gc_interval_ms=100)
    workload = client.Workload(
        shard_count=1,
        key_gen=client.ConflictRateKeyGen(100),
        keys_per_command=1,
        commands_per_client=COMMANDS_PER_CLIENT,
        payload_size=100,
    )
    process_regions = [core.Region(r) for r in ("asia-east1", "us-central1", "us-west1")]
    client_regions = [core.Region("us-west1"), core.Region("us-west2")]
    device = {"device": "cpu"} if sim is tsim else {}
    runner = sim.Runner(
        protocol.Basic, planet, config, workload, 1, process_regions,
        client_regions, **device,
    )
    metrics, _monitors, latencies = runner.run(extra_sim_time_ms=1000)
    hists = {
        str(region): (issued, list(hist.values()))
        for region, (issued, hist) in latencies.items()
    }
    stable = {
        pid: m.get_aggregated(protocol.ProtocolMetricsKind.STABLE)
        for pid, m in metrics.items()
    }
    means = tuple(latencies[core.Region(r)][1].mean() for r in ("us-west1", "us-west2"))
    return hists, stable, means


def basic_flow():
    """The Basic message walk (fantoch/src/protocol/basic.rs:397-598)."""
    simulation = tsim.Simulation()
    shard_id = 0
    region = tcore.Region("europe-west2")
    processes = [(1, shard_id, region), (2, shard_id, region), (3, shard_id, region)]
    planet = tcore.Planet.new("gcp")
    n, f = 3, 1
    config = tcore.Config(n, f)
    for process_id in (1, 2, 3):
        protocol, _events = Basic.new(process_id, shard_id, config)
        protocol.discover(sort_processes_by_distance(region, planet, processes))
        executor = Basic.Executor(process_id, shard_id, config, device="cpu")
        simulation.register_process(protocol, executor)
    workload = tclient.Workload(
        shard_count=1,
        key_gen=tclient.ConflictRateKeyGen(100),
        keys_per_command=1,
        commands_per_client=10,
        payload_size=100,
    )
    client = tclient.Client(1, workload)
    client.connect(closest_process_per_shard(region, planet, processes))
    target_shard, cmd = client.next_cmd(simulation.time)
    assert client.shard_process(target_shard) == 1  # ties break by id
    simulation.register_client(client)

    process, _, pending = simulation.get_process(1)
    pending.wait_for(cmd)
    process.submit(None, cmd, simulation.time)
    actions = list(process.to_processes_iter())
    assert len(actions) == 1
    mstore = actions.pop()
    assert isinstance(mstore, ToSend) and isinstance(mstore.msg, MStore)
    assert mstore.target == {1, 2}
    mstoreacks = simulation.forward_to_processes(1, mstore)
    assert len(mstoreacks) == 2 * f
    assert all(isinstance(a.msg, MStoreAck) for _, a in mstoreacks)
    pid, ack = mstoreacks.pop()
    assert simulation.forward_to_processes(pid, ack) == []
    pid, ack = mstoreacks.pop()
    mcommits = simulation.forward_to_processes(pid, ack)
    assert len(mcommits) == 1
    pid, mcommit = mcommits.pop()
    assert isinstance(mcommit, ToSend) and isinstance(mcommit.msg, MCommit)
    assert len(mcommit.target) == n
    to_sends = simulation.forward_to_processes(pid, mcommit)
    assert all(
        isinstance(a, ToForward) and isinstance(a.msg, MCommitDot) for _, a in to_sends
    )
    process, executor, pending = simulation.get_process(1)
    to_executor = list(process.to_executors_iter())
    assert len(to_executor) == 1
    ready = []
    for info in to_executor:
        executor.handle(info, simulation.time)
        ready.extend(executor.to_clients_iter())
    assert len(ready) == 1
    cmd_result = pending.add_executor_result(ready.pop())
    assert cmd_result is not None
    target, cmd = simulation.forward_to_client(cmd_result)
    process, _, _ = simulation.get_process(target)
    process.submit(None, cmd, simulation.time)
    actions = list(process.to_processes_iter())
    assert len(actions) == 1
    mstore = actions.pop()
    assert isinstance(mstore, ToSend) and isinstance(mstore.msg, MStore)
    assert mstore.msg.dot == tcore.Dot(1, 2)


def schedule_flow():
    """fantoch/src/sim/schedule.rs:63-120 on the port's Schedule."""
    time = tcore.SimTime()
    schedule = tsim.Schedule()
    assert schedule.next_action(time) is None
    schedule.schedule(time, 10, "a")
    assert schedule.next_action(time) == "a"
    assert time.millis() == 10
    assert schedule.next_action(time) is None
    schedule.schedule(time, 7, "b")
    schedule.schedule(time, 2, "c")
    assert schedule.next_action(time) == "c"
    assert time.millis() == 12
    schedule.schedule(time, 2, "d")
    schedule.schedule(time, 5, "e")
    assert schedule.next_action(time) == "d"
    assert time.millis() == 14
    assert {schedule.next_action(time), schedule.next_action(time)} == {"b", "e"}
    assert time.millis() == 17


def test_basic_matches_jax():
    basic_flow()
    for f, means in ((0, (0.0, 24.0)), (1, (34.0, 58.0)), (2, (118.0, 142.0))):
        want = run_basic(jcore, jclient, jprotocol, jsim, f)
        got = run_basic(tcore, tclient, tprotocol, tsim, f)
        assert got[0] == want[0], f"f={f}: client latency histograms differ"
        assert got[1] == want[1], f"f={f}: STABLE counts differ"
        assert got[2] == means, (f, got[2])
        issued = {issued for issued, _ in got[0].values()}
        assert issued == {COMMANDS_PER_CLIENT}
        assert set(got[1].values()) == {2 * COMMANDS_PER_CLIENT}
    schedule_flow()
