"""Port parity: partial replication (``shard_count > 1``) end to end at
the protocol + executor level.

``tests/test_partial.py``'s eight cases, each run on the port and on the
JAX package with the same in-test message router (no network): Atlas,
EPaxos and Newt across 2-3 shards, the MForwardSubmit / MShardCommit /
MShardAggregatedCommit aggregation, and the per-process GraphExecutors'
cross-shard Request/RequestReply dependency fetch.  Every process's
execution order and the whole message trail must equal the reference's,
and each case's own assertions hold on the port.  The batched graph
executor runs its host-column route on CPU tensors (the reference pinned
to its XLA route with ``host_native_resolver=False``) and its native route
(both packages with ``host_native_resolver=True``).

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``.
"""

import copy
import importlib
from collections import deque
from types import SimpleNamespace

import pytest
import torch

from torch_jax_ref import jax_ref  # noqa: F401 — the fixture

torch.set_num_threads(1)

PACKAGES = ("fantoch_tpu", "fantoch_tpu_torch")


def _modules(root):
    imp = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root,
        core=imp("core"),
        base=imp("protocol.base"),
        graph=imp("protocol.graph_protocol"),
        newt=imp("protocol.newt"),
        gexec=imp("executor.graph.executor"),
    )


class Cluster:
    """shard_count x n processes + executors with a manual message router
    (``tests/test_partial.py``'s harness, over either package)."""

    def __init__(self, m, n, f, shard_count, protocol="Atlas", **knobs):
        self.m = m
        core = m.core
        self.config = core.Config(
            n=n, f=f, shard_count=shard_count, gc_interval_ms=100, **knobs
        )
        cls = getattr(m.newt if protocol == "Newt" else m.graph, protocol)
        device = {"device": "cpu"} if m.root == "fantoch_tpu_torch" else {}
        self.protocols, self.executors, self.shard_of = {}, {}, {}
        self.queue = deque()  # (from_pid, from_shard, to_pid, msg)
        self.messages_seen = []
        for shard in range(shard_count):
            ids = list(core.process_ids(shard, n))
            for pid in ids:
                proto = cls(pid, shard, self.config)
                offset = pid - ids[0]
                discover = [(pid, shard)] + [(p, shard) for p in ids if p != pid]
                for other in range(shard_count):
                    if other != shard:
                        discover.append((list(core.process_ids(other, n))[offset], other))
                ok, _ = proto.discover(discover)
                assert ok
                self.protocols[pid] = proto
                executor = cls.Executor(pid, shard, self.config, **device)
                executor.set_executor_index(0)
                self.executors[pid] = executor
                self.shard_of[pid] = shard
        self.time = core.RunTime()

    def submit(self, pid, cmd):
        self.protocols[pid].submit(None, cmd, self.time)
        self.drain(pid)

    def drain(self, pid):
        proto = self.protocols[pid]
        for action in proto.to_processes_iter():
            if isinstance(action, self.m.base.ToSend):
                targets = sorted(action.target)
                copies = [action.msg] + [copy.deepcopy(action.msg) for _ in targets[1:]]
                for target, msg in zip(targets, copies):
                    self.queue.append((pid, self.shard_of[pid], target, msg))
            elif isinstance(action, self.m.base.ToForward):
                self.queue.append((pid, self.shard_of[pid], pid, action.msg))
        for info in proto.to_executors_iter():
            self.executors[pid].handle(info, self.time)
            self._drain_executor(pid)

    def _drain_executor(self, pid):
        executor = self.executors[pid]
        while True:
            out = executor.to_executors()
            if out is None:
                break
            to_shard, xinfo = out
            if to_shard == self.shard_of[pid]:
                target = pid
            else:
                target = self.protocols[pid].bp.closest_process(to_shard)
            peer = self.executors[target]
            if isinstance(xinfo, self.m.gexec.GraphRequest):
                peer.set_executor_index(1)
                peer.handle(xinfo, self.time)
                peer.graph.cleanup(self.time)
                peer.set_executor_index(0)
            else:
                peer.handle(xinfo, self.time)
            self._drain_executor(target)

    def run(self, max_steps=10_000):
        steps = 0
        while self.queue:
            steps += 1
            assert steps < max_steps, "message storm / livelock"
            from_pid, from_shard, to_pid, msg = self.queue.popleft()
            self.messages_seen.append(type(msg).__name__)
            self.protocols[to_pid].handle(from_pid, from_shard, msg, self.time)
            self.drain(to_pid)

    def pump_detached(self):
        """Fire Newt's detached-vote flush (the periodic event the message
        walk has no timer for)."""
        for pid, proto in self.protocols.items():
            proto.handle_event(self.m.newt.SendDetachedEvent(), self.time)
            self.drain(pid)
        self.run()

    def executed(self, pid):
        """(client, sequence) of the rifls executed at pid, in order."""
        out = []
        while True:
            res = self.executors[pid].to_clients()
            if res is None:
                return out
            out.append((res.rifl.source, res.rifl.sequence))


def multi_shard_cmd(core, rifl_seq, keys_by_shard):
    return core.Command(
        core.Rifl(1, rifl_seq),
        {
            shard: {key: (core.KVOp.put(f"v{rifl_seq}"),) for key in keys}
            for shard, keys in keys_by_shard.items()
        },
    )


# each case: (name, cluster kwargs, script(cluster, cmd) -> None, check)
def _two_shard(c, cmd):
    c.submit(1, cmd(1, {0: ["a"], 1: ["b"]}))
    c.run()


def _conflicting(c, cmd):
    c.submit(1, cmd(1, {0: ["a"], 1: ["b"]}))
    c.submit(2, cmd(2, {0: ["a"], 1: ["b"]}))
    c.run()


def _three_shard(c, cmd):
    c.submit(1, cmd(1, {0: ["a"], 1: ["b"], 2: ["c"]}))
    c.run()


def _cross_fetch(c, cmd):
    c.submit(4, cmd(1, {1: ["b"]}))
    c.run()
    c.submit(1, cmd(2, {0: ["a"], 1: ["b"]}))
    c.run()


def _newt(c, cmd):
    _two_shard(c, cmd)
    for _ in range(4):
        c.pump_detached()


def _all_once(orders, _shards, _seen):
    return all(o == [(1, 1)] for o in orders.values())


def _agree(orders, _shards, _seen):
    return all(sorted(o) == [(1, 1), (1, 2)] for o in orders.values()) and (
        len({tuple(o) for o in orders.values()}) == 1
    )


def _fetched(orders, shards, _seen):
    return all(
        o == ([(1, 1), (1, 2)] if shards[pid] == 1 else [(1, 2)])
        for pid, o in orders.items()
    )


def _three(orders, shards, seen):
    return (
        _all_once(orders, shards, seen)
        and seen.count("MForwardSubmit") == 2
        and seen.count("MShardCommit") == 3
    )


def _trail(*names):
    def check(orders, shards, seen):
        return _all_once(orders, shards, seen) and set(names) <= set(seen)

    return check


ROUTES = (
    {"batched_graph_executor": True, "host_native_resolver": False},
    {"batched_graph_executor": True, "host_native_resolver": True},
)
CASES = [
    ("atlas two-shard", 2, "Atlas", ({},), _two_shard,
     _trail("MForwardSubmit", "MShardCommit", "MShardAggregatedCommit", "MCommit")),
    ("atlas conflicting", 2, "Atlas", ({},), _conflicting, _agree),
    ("atlas three-shard", 3, "Atlas", ({},), _three_shard, _three),
    ("atlas cross-shard fetch", 2, "Atlas", ({},), _cross_fetch, _fetched),
    ("newt two-shard", 2, "Newt", ({"newt_detached_send_interval_ms": 50},), _newt,
     _trail("MForwardSubmit", "MBump", "MShardCommit", "MShardAggregatedCommit",
            "MCommit")),
    ("atlas two-shard batched", 2, "Atlas", ROUTES, _conflicting, _agree),
    ("atlas cross-shard fetch batched", 2, "Atlas", ROUTES, _cross_fetch, _fetched),
]


def _run(root, shards, protocol, knobs, script):
    m = _modules(root)
    cluster = Cluster(m, 3, 1, shards, protocol, **knobs)
    script(cluster, lambda seq, by_shard: multi_shard_cmd(m.core, seq, by_shard))
    orders = {pid: cluster.executed(pid) for pid in cluster.protocols}
    return orders, cluster


def test_partial_replication_matches_jax(jax_ref):
    routes = []
    for name, shards, protocol, variants, script, check in CASES:
        for knobs in variants:
            case = f"{name} {knobs}"
            want, ref_cluster = _run("fantoch_tpu", shards, protocol, knobs, script)
            got, cluster = _run("fantoch_tpu_torch", shards, protocol, knobs, script)
            assert got == want, f"{case}: execution orders differ"
            assert cluster.messages_seen == ref_cluster.messages_seen, (
                f"{case}: message trails differ"
            )
            assert check(got, cluster.shard_of, cluster.messages_seen), (case, got)
            if knobs.get("batched_graph_executor"):
                for executor in cluster.executors.values():
                    routes.extend(executor.graph.routes)
    assert {"keyed", "native"} <= set(routes), sorted(set(routes))

    # EPaxos refuses a multi-shard command on both packages
    for root in PACKAGES:
        m = _modules(root)
        cluster = Cluster(m, 3, 1, 2, "EPaxos")
        cmd = multi_shard_cmd(m.core, 1, {0: ["a"], 1: ["b"]})
        with pytest.raises(AssertionError, match="does not support multi-shard"):
            cluster.protocols[1].submit(None, cmd, cluster.time)

    # Newt's MBump buffer is bounded: stale entries age out by eviction,
    # and re-bumping an entry keeps the max without evicting
    m = _modules("fantoch_tpu_torch")
    proto = Cluster(m, 3, 1, 2, "Newt", newt_detached_send_interval_ms=50).protocols[4]
    cap = m.newt._MBUMP_BUFFER_CAP
    proto._handle_mbump(m.core.Dot(1, 99), 7)
    assert proto._buffered_mbumps[m.core.Dot(1, 99)] == 7
    for seq in range(100, 100 + cap + 50):
        proto._handle_mbump(m.core.Dot(1, seq), seq)
    assert len(proto._buffered_mbumps) == cap
    assert m.core.Dot(1, 99) not in proto._buffered_mbumps
    newest = m.core.Dot(1, 100 + cap + 49)
    proto._handle_mbump(newest, 5)
    assert proto._buffered_mbumps[newest] == 100 + cap + 49
