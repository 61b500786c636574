"""Port parity: MultiSynod, the slot executor and FPaxos.

``tests/test_fpaxos.py``'s seven cases on the port
(``fantoch_tpu_torch.protocol.common.multi_synod``, ``executor/slot.py``,
``protocol/fpaxos.py``): the MultiSynod happy path, a non-leader
forwarding, a stale ballot rejected, ``SlotGCTrack``, the slot executor
under every delivery permutation, and FPaxos n = 3, f = 1 and n = 5, f = 2
through the simulator, where the port's ``Runner(device="cpu")`` and the
JAX package's ``Runner`` with the same seed must give the same per-key
execution orders, the same client latency histograms and the same
FAST/SLOW/STABLE counts, and the port's run must pass the harness's
agreement and commit/GC accounting checks.  Exact equality throughout.

One collected item on purpose (ROADMAP.md Queue C).
"""

import itertools

import torch

from harness import (
    CLIENTS_PER_PROCESS,
    COMMANDS_PER_CLIENT,
    CONFLICT_RATE,
    check_metrics,
)

import fantoch_tpu.client as jclient
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol as jprotocol
import fantoch_tpu.sim as jsim
import fantoch_tpu_torch.client as tclient
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol as tprotocol
import fantoch_tpu_torch.sim as tsim
from fantoch_tpu_torch.core.audit import ConsistencyAuditor
from fantoch_tpu_torch.executor.slot import SlotExecutionInfo, SlotExecutor
from fantoch_tpu_torch.protocol.common.multi_synod import (
    MAccept,
    MAccepted,
    MChosen,
    MForwardSubmit,
    MSpawnCommander,
    MultiSynod,
    SlotGCTrack,
)

torch.set_num_threads(1)

SHARD = 0


def cmd(seq):
    return tcore.Command.from_single(
        tcore.Rifl(9, seq), SHARD, f"K{seq}", tcore.KVOp.put(str(seq))
    )


def sim_run(core, client, protocol, sim, config, seed):
    """One ``tests/harness.py``-shaped run; returns (per-key orders,
    latency histograms, path counts, monitors, config)."""
    config = config.with_(
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
        protocol.FPaxos, planet, config, workload, CLIENTS_PER_PROCESS,
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
    return orders, hists, paths, monitors, config


def test_fpaxos_matches_jax():
    # MultiSynod happy path: n=3, f=1, leader=1
    synods = {pid: MultiSynod(pid, 1, 3, 1) for pid in (1, 2, 3)}
    out = synods[1].submit(cmd(1))
    assert isinstance(out, MSpawnCommander) and out.slot == 1 and out.ballot == 1
    maccept = synods[1].handle(1, out)
    assert isinstance(maccept, MAccept)
    chosen = None
    for pid in (1, 2):  # the write quorum f+1 = 2 accepts
        maccepted = synods[pid].handle(1, maccept)
        assert isinstance(maccepted, MAccepted)
        result = synods[1].handle(pid, maccepted)
        if result is not None:
            chosen = result
    assert isinstance(chosen, MChosen) and chosen.slot == 1
    assert chosen.value == cmd(1)

    # a non-leader forwards; a stale ballot is rejected
    assert isinstance(MultiSynod(2, 1, 3, 1).submit(cmd(1)), MForwardSubmit)
    synod = MultiSynod(2, 1, 3, 1)
    assert synod.handle(9, MAccept(0, 1, cmd(1))) is None
    assert synod.handle(1, MAccept(1, 1, cmd(1))) is not None

    # slot GC: stable = the minimum committed slot over all processes
    track = SlotGCTrack(1, 3)
    track.commit(1)
    track.commit(2)
    assert track.committed() == 2
    assert track.stable() == (1, 0)
    track.committed_by(2, 1)
    track.committed_by(3, 5)
    assert track.stable() == (1, 1)
    track.committed_by(2, 2)
    assert track.stable() == (2, 2)

    # the slot executor executes in slot order whatever the delivery order
    # (it takes the runners' device keyword and keeps nothing of it)
    cmds = [cmd(seq) for seq in range(1, 5)]
    for perm in itertools.permutations(range(4)):
        ex = SlotExecutor(1, SHARD, tcore.Config(n=3, f=1), device="cpu")
        executed = []
        for i in perm:
            ex.handle(SlotExecutionInfo(i + 1, cmds[i]), None)
            executed.extend(r.rifl for r in ex.to_clients_iter())
        assert executed == [c.rifl for c in cmds], perm

    # FPaxos through both simulators
    for n, f, seed in ((3, 1, 0), (5, 2, 1)):
        want = sim_run(jcore, jclient, jprotocol, jsim,
                       jcore.Config(n=n, f=f, leader=1), seed)
        got = sim_run(tcore, tclient, tprotocol, tsim,
                      tcore.Config(n=n, f=f, leader=1), seed)
        case = f"FPaxos n={n} f={f}"
        assert got[0] == want[0], f"{case}: per-key execution orders differ"
        assert got[1] == want[1], f"{case}: client latency histograms differ"
        assert got[2] == want[2], f"{case}: FAST/SLOW/STABLE counts differ"
        verdict = ConsistencyAuditor().audit(got[3])
        assert verdict.ok, verdict.describe()
        check_metrics(got[4], COMMANDS_PER_CLIENT, CLIENTS_PER_PROCESS, got[2])
