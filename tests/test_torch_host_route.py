"""Port parity: the batched graph executor's host-column route.

The route the JAX package's batched graph executor takes by default
(``Config(batched_graph_executor=True)``, ``device_graph_plane`` off), on
the port's CPU tensors, where every kernel stage runs its plain version:

* ``resolve_keyed_auto`` (residual fits / overflows to the full doubling,
  with and without structure) and
  ``resolve_functional_keyed(return_structure=True)`` (a residual buffer
  that fits and one that overflows) on ``bench.build_workload`` batches
  and adversarial functional graphs;
* ``resolve_general_resident`` on multi-key matrices padded as the route
  pads them (a permuted DAG, cycle-rich, missing-blocked chains, one long
  chain, a closed publish gate) at the default terminal stage and at one
  of 64 rows, so several stages compact;
* ``BatchedDependencyGraph`` fed the same commits on both packages — the
  arrival-order fast path, the keyed route with and without structure and
  overflowing, the small and large multi-key routes, stuck residues
  finished by the
  Python oracle — flush by flush: the same emission and the same
  CHAIN_SIZE histogram.  The reference is pinned to its XLA route with
  ``host_native_resolver=False`` and its stuck residues to its Python
  oracle (its native library made unavailable for the test's span);
* EPaxos and Atlas through both simulators on this route (n = 5, two
  keys a command at 50% conflict, message reordering): the same per-key
  execution orders and client latency histograms;
* ``tests/test_graph_executor.py``'s cases for the port's
  ``DependencyGraph`` and ``BatchedDependencyGraph`` (kernel route on CPU
  tensors, and native route), per-key orders equal to the reference's.

Exact equality throughout.  One collected item on purpose (ROADMAP.md
Queue C).
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_workload
from torch_jax_ref import jax_ref  # noqa: F401 — the fixture

import fantoch_tpu.client as jclient
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol as jprotocol
import fantoch_tpu.sim as jsim
from fantoch_tpu import native as ref_native
from fantoch_tpu.executor.base import ExecutorMetricsKind as JKind
from fantoch_tpu.executor.graph.batched import BatchedDependencyGraph as RefBatched
from fantoch_tpu.ops import graph_resolve as ref
import fantoch_tpu_torch.client as tclient
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol as tprotocol
import fantoch_tpu_torch.sim as tsim
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind as TKind
from fantoch_tpu_torch.executor.graph.batched import (
    BatchedDependencyGraph,
    _padded_general,
)
from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
from fantoch_tpu_torch.ops import graph_resolve as port
from fantoch_tpu_torch.ops.frontier import pack_dots
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

torch.set_num_threads(1)

TERMINAL, MISSING = port.TERMINAL, port.MISSING
SHARD = 0
WIDTH = 4


def _equal(case, got, want):
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (case, name, g.dtype, w.dtype)
        assert np.array_equal(g, w), f"{case}: field {name} differs"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def keyed_inputs(n, seed):
    """(name, key, dep, src, seq): the north-star workload, chain
    inversions within windows of 16, a random functional graph with
    TERMINAL/MISSING, one ring through every row."""
    rng = np.random.default_rng(seed)
    key, dep, src, seq = build_workload(n, 0.5, clients=64, seed=seed)
    yield "workload", key, dep, src, seq
    perm = np.arange(n)
    for s in range(0, n, 16):
        rng.shuffle(perm[s : s + 16])
    inv = np.argsort(perm)
    dep_i = np.where(dep[perm] >= 0, inv[np.maximum(dep[perm], 0)], dep[perm])
    yield "inversions", key[perm], dep_i.astype(np.int32), src[perm], seq
    pick = rng.random(n)
    dep_r = np.where(
        pick < 0.05, TERMINAL, np.where(pick < 0.08, MISSING, rng.integers(0, n, n))
    ).astype(np.int32)
    yield "random-graph", rng.integers(0, 8, n).astype(np.int32), dep_r, src, seq
    yield "ring", np.zeros(n, np.int32), ((np.arange(n) + 1) % n).astype(np.int32), src, seq


def permuted_dag(rng, n, n_keys):
    """Each command on WIDTH keys, a dependency on the latest command of
    each, rows relabelled by a random permutation."""
    keys = rng.integers(0, n_keys, size=(n, WIDTH))
    deps = np.full((n, WIDTH), TERMINAL, np.int64)
    last = {}
    for i, row in enumerate(keys.tolist()):
        slot = 0
        for k in row:
            prev = last.get(k)
            if prev is not None and prev != i:
                deps[i, slot] = prev
                slot += 1
            last[k] = i
    perm = rng.permutation(n)
    out = np.full((n, WIDTH), TERMINAL, np.int64)
    out[perm] = np.where(deps >= 0, perm[np.maximum(deps, 0)], deps)
    return out.astype(np.int32)


def cycle_rich(rng, n, chunk=64, n_keys=24):
    """Consecutive commands on a key within a chunk linked one way or both:
    2-cycles, mutual cliques, directed cycles with no mutual edge."""
    keys = rng.integers(0, n_keys, size=(n, 2))
    deps = [[] for _ in range(n)]
    last = {}
    for i, row in enumerate(keys.tolist()):
        if i % chunk == 0:
            last = {}
        for k in sorted(set(row)):
            prev = last.get(k)
            if prev is not None:
                c = int(rng.integers(0, 3))
                if c in (0, 2) and len(deps[i]) < WIDTH:
                    deps[i].append(prev)
                if c in (1, 2) and len(deps[prev]) < WIDTH:
                    deps[prev].append(i)
            last[k] = i
    mat = np.full((n, WIDTH), TERMINAL, np.int32)
    for i, row in enumerate(deps):
        mat[i, : len(row)] = row
    return mat


def missing_chains(rng, n, length=25):
    """Chains in shuffled rows, every other head MISSING-blocked, some rows
    also depending on an earlier chain."""
    order = rng.permutation(n)
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    for c, start in enumerate(range(0, n, length)):
        rows = order[start : start + length]
        if c % 2:
            deps[rows[0], 0] = MISSING
        for a, b in zip(rows[:-1], rows[1:]):
            deps[b, 0] = a
        if start:
            for row in rows[rng.integers(0, len(rows), 3)]:
                deps[row, 1] = order[int(rng.integers(0, start))]
    return deps


def long_chain(n):
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    deps[: n - 1, 0] = np.arange(1, n)
    return deps


def dead_gate(n_cycles=24, n_chain=16):
    """Directed 3-cycles (never peel) beside a short chain."""
    n = 3 * n_cycles + n_chain
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    for c in range(n_cycles):
        for i in range(3):
            deps[3 * c + i, 0] = 3 * c + (i + 1) % 3
    for i in range(1, n_chain):
        deps[3 * n_cycles + i, 0] = 3 * n_cycles + i - 1
    return deps


def dots(n, seed):
    rng = np.random.default_rng(seed)
    return (1 + rng.integers(0, 5, n)).astype(np.int32), rng.permutation(n).astype(np.int32)


# ---------------------------------------------------------------------------
# the resolvers
# ---------------------------------------------------------------------------


def check_resolvers():
    branches = set()
    for n in (300, 4096, 8192):
        for name, key, dep, src, seq in keyed_inputs(n, n):
            t = [torch.tensor(a) for a in (key, dep, src, seq)]
            j = [jnp.asarray(a) for a in (key, dep, src, seq)]
            for rs in (64, n):
                want = ref.resolve_functional_keyed(
                    *j, residual_size=rs, return_structure=True)
                _equal(f"{n} {name} keyed structure {rs}",
                       port.resolve_functional_keyed(
                           *t, residual_size=rs, return_structure=True), want)
                branches.add(("structure", bool(want.overflow)))
            over = bool(ref.resolve_functional_keyed(
                *j, residual_size=ref._residual_size_for(n),
                return_structure=False).overflow)
            for structure in (True, False):
                _equal(f"{n} {name} auto {structure}",
                       port.resolve_keyed_auto(*t, return_structure=structure),
                       ref.resolve_keyed_auto(*j, return_structure=structure))
                branches.add(("auto", structure, over))
    assert {("auto", s, o) for s in (True, False) for o in (True, False)} <= branches
    assert {("structure", True), ("structure", False)} <= branches

    rng = np.random.default_rng(3)
    stuck = multi_stage = 0
    for name, deps in (
        ("dag", permuted_dag(rng, 5000, 300)), ("cycles", cycle_rich(rng, 3000)),
        ("missing", missing_chains(rng, 9000)), ("chain", long_chain(6000)),
        ("dead-gate", dead_gate()),
    ):
        cols = _padded_general(deps, *dots(len(deps), 1))
        for min_size in (4096, 64):
            want = ref.resolve_general_resident(
                *(jnp.asarray(c) for c in cols), min_size=min_size)
            got = port.resolve_general_resident(
                *(torch.tensor(c) for c in cols), min_size=min_size)
            _equal(f"{name} resident {min_size}", got, want)
            stuck += bool(np.asarray(want.stuck).any())
            multi_stage += len(deps) > 2 * min_size
    assert stuck and multi_stage


# ---------------------------------------------------------------------------
# the batched graph, both packages, flush by flush
# ---------------------------------------------------------------------------


def keyed_feeds(n, seed, shuffle):
    """Keyed commits (the north-star workload) as handle_add_arrays feeds:
    dots (src, index + 1), key, packed dep dots; arrival shuffled in
    windows of ``shuffle`` rows (0: in order)."""
    key, dep, src, _seq = build_workload(n, 0.5, clients=64, seed=seed)
    src = src.astype(np.int64)
    seq = np.arange(1, n + 1, dtype=np.int64)
    has = dep >= 0
    di = np.where(has, dep, 0)
    packed = np.where(has, (src[di] << 32) | seq[di], -1).reshape(-1, 1)
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed)
        for s in range(0, n, shuffle):
            rng.shuffle(order[s : s + shuffle])
    return src[order], seq[order], key[order], packed[order]


def general_feeds(deps, seed, missing_dot=None):
    """A multi-key matrix (batch-index deps) as feeds: key -1, packed dep
    dots; MISSING cells point at ``missing_dot`` (never committed)."""
    n = len(deps)
    src = (1 + np.arange(n) % 5).astype(np.int64)
    seq = (1 + np.arange(n) // 5).astype(np.int64)
    packed = np.where(deps >= 0, (src[np.maximum(deps, 0)] << 32) | seq[np.maximum(deps, 0)], -1)
    if missing_dot is not None:
        packed = np.where(deps == MISSING, missing_dot, packed)
    return src, seq, np.full(n, -1, np.int32), packed


def run_graph(root, feeds, cuts, knobs):
    core = jcore if root == "jax" else tcore
    kind = JKind if root == "jax" else TKind
    config = core.Config(3, 1, batched_graph_executor=True, **knobs)
    if root == "jax":
        graph = RefBatched(1, SHARD, config.with_(host_native_resolver=False))
    else:
        graph = BatchedDependencyGraph(1, SHARD, config, device="cpu")
    src, seq, key, packed = feeds
    time = core.RunTime()
    flushes = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        cmds = [
            core.Command.from_keys(core.Rifl(int(s), int(q)), SHARD,
                                   {f"k{k}": (core.KVOp.put(""),)})
            for s, q, k in zip(src[lo:hi].tolist(), seq[lo:hi].tolist(),
                               key[lo:hi].tolist())
        ]
        graph.handle_add_arrays(src[lo:hi], seq[lo:hi], key[lo:hi], packed[lo:hi],
                                cmds, time)
        flushes.append([(c.rifl.source, c.rifl.sequence)
                        for c in graph.commands_to_execute()])
    chain = graph.metrics().get_collected(kind.CHAIN_SIZE)
    return flushes, (list(chain.values()) if chain else None), graph


def check_graphs(monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    seen = {"overflow": 0, "stuck": 0}
    real_full, real_stuck = port.resolve_functional, BatchedDependencyGraph._resolve_stuck_rows

    def full(*args):
        seen["overflow"] += 1
        return real_full(*args)

    def stuck(self, rows, *args):
        seen["stuck"] += len(rows)
        return real_stuck(self, rows, *args)

    monkeypatch.setattr(port, "resolve_functional", full)
    monkeypatch.setattr(BatchedDependencyGraph, "_resolve_stuck_rows", stuck)
    rng = np.random.default_rng(5)
    ghost = (9 << 32) | 1
    cases = [
        # (name, feeds, cuts, knobs)
        ("keyed structure", keyed_feeds(3000, 1, 16), (0, 1000, 2200, 3000), {}),
        ("keyed large", keyed_feeds(12000, 2, 64), (0, 7000, 12000), {}),
        ("keyed overflow", keyed_feeds(9000, 3, 9000), (0, 9000), {}),
        ("fast path", keyed_feeds(6000, 4, 0), (0, 6000), {}),
        ("general small", general_feeds(cycle_rich(rng, 2000), 6), (0, 800, 2000), {}),
        ("general resident", general_feeds(permuted_dag(rng, 6000, 400), 7),
         (0, 6000), {}),
        ("general missing large", general_feeds(missing_chains(rng, 9000), 8, ghost),
         (0, 5000, 9000), {}),
        ("general stuck large", general_feeds(cycle_rich(rng, 5000), 9), (0, 5000), {}),
        ("threshold knob", keyed_feeds(3000, 10, 8), (0, 3000),
         {"graph_kernel_threshold": 512}),
    ]
    routes = set()
    for name, feeds, cuts, knobs in cases:
        want = run_graph("jax", feeds, cuts, knobs)
        got = run_graph("torch", feeds, cuts, knobs)
        assert got[0] == want[0], f"{name}: emission differs"
        assert got[1] == want[1], f"{name}: CHAIN_SIZE histograms differ"
        assert sum(map(len, got[0])) > 0, name
        if name in ("keyed structure", "general small"):
            assert got[1], f"{name}: no CHAIN_SIZE structure"
        routes |= set(got[2].routes)
    assert routes == {"fast", "keyed", "general", "general_resident"}, routes
    assert seen["overflow"] and seen["stuck"], seen


def sim_run(core, client, protocol, sim, name):
    config = core.Config(5, 2, batched_graph_executor=True).with_(
        executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
    )
    if sim is jsim:
        config = config.with_(host_native_resolver=False)
    planet = core.Planet.new("gcp")
    workload = client.Workload(
        shard_count=1, key_gen=client.ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=10, payload_size=1, read_only_percentage=0,
    )
    regions = sorted(planet.regions())[:5]
    device = {"device": "cpu"} if sim is tsim else {}
    runner = sim.Runner(
        getattr(protocol, name), planet, config, workload, 3,
        process_regions=list(regions), client_regions=list(regions), seed=0, **device,
    )
    runner.reorder_messages()
    _metrics, monitors, latencies = runner.run(extra_sim_time_ms=10_000)
    orders = {
        pid: {k: [(r.source, r.sequence) for r in m.get_order(k)] for k in sorted(m.keys())}
        for pid, m in monitors.items()
    }
    hists = {str(r): (i, list(h.values())) for r, (i, h) in latencies.items()}
    return orders, hists, runner


def check_sims():
    for name in ("EPaxos", "Atlas"):
        want = sim_run(jcore, jclient, jprotocol, jsim, name)
        got = sim_run(tcore, tclient, tprotocol, tsim, name)
        assert got[0] == want[0], f"{name}: per-key execution orders differ"
        assert got[1] == want[1], f"{name}: client latency histograms differ"
        for _pid, (_p, executor, _q) in got[2]._simulation.processes():
            assert executor.graph._plane is None and executor.graph.routes


# ---------------------------------------------------------------------------
# tests/test_graph_executor.py's cases, for both graph classes
# ---------------------------------------------------------------------------


def BatchedKernels(pid, shard, config):
    return BatchedDependencyGraph(pid, shard, config, device="cpu")


def BatchedNative(pid, shard, config):
    return BatchedDependencyGraph(pid, shard, config.with_(host_native_resolver=True))


GRAPHS = (DependencyGraph, BatchedKernels, BatchedNative)


def dep(dot):
    return Dependency(dot, frozenset({SHARD}))


def make_cmd(dot, keys):
    return tcore.Command.from_keys(
        tcore.Rifl(dot.source, dot.sequence), SHARD,
        {k: (tcore.KVOp.put(""),) for k in keys},
    )


def check_termination(n, args, graph_cls):
    """Feed (dot, keys, dep_dots) adds in order; every command must
    execute; returns the per-key execution order."""
    graph = graph_cls(1, SHARD, tcore.Config(n, 1))
    time = tcore.RunTime()
    pending, order = set(), {}
    for d, keys, dep_dots in args:
        cmd = make_cmd(d, keys if keys is not None else ["CONF"])
        pending.add(cmd.rifl)
        graph.handle_add(d, cmd, [dep(x) for x in dep_dots], time)
        for ready in graph.commands_to_execute():
            pending.remove(ready.rifl)
            for key in ready.keys(SHARD):
                order.setdefault(key, []).append(ready.rifl)
    assert not pending, f"not all commands executed: {pending}"
    return order


def random_adds(n, events_per_process, rng):
    """Random dep graphs with non-transitive conflicts (mod.rs:934-1033)."""
    dots_ = [tcore.Dot(pid, seq) for pid in tcore.process_ids(SHARD, n)
             for seq in range(1, events_per_process + 1)]
    keys = {d: set(rng.sample(["A", "B", "C", "D"], 2)) for d in dots_}
    deps = {d: set() for d in dots_}
    for left, right in itertools.combinations(dots_, 2):
        if not keys[left] & keys[right]:
            continue
        if left.source == right.source:
            if left.sequence < right.sequence:
                deps[right].add(left)
            else:
                deps[left].add(right)
        else:
            choice = rng.randrange(3)
            if choice in (0, 2):
                deps[left].add(right)
            if choice in (1, 2):
                deps[right].add(left)
    return [(d, sorted(keys[d]), deps[d]) for d in dots_]


def big_backward_batch(batch, conflict_every=2):
    src = np.ones(batch, dtype=np.int64)
    seq = np.arange(1, batch + 1, dtype=np.int64)
    key = np.arange(batch, dtype=np.int32) % conflict_every
    last, depm = {}, np.full((batch, 1), -1, dtype=np.int64)
    for i in range(batch):
        prev = last.get(int(key[i]))
        if prev is not None:
            depm[i, 0] = (1 << 32) | (prev + 1)
        last[int(key[i])] = i
    cmds = [make_cmd(tcore.Dot(1, i + 1), [f"key{key[i]}"]) for i in range(batch)]
    return src, seq, key, depm, cmds


def check_executor_cases():
    time = tcore.RunTime()
    Dot = tcore.Dot
    for graph_cls in GRAPHS:
        # two commands in a 2-cycle execute together, sorted by dot
        graph = graph_cls(1, SHARD, tcore.Config(2, 1))
        cmd_0, cmd_1 = make_cmd(Dot(1, 1), ["A"]), make_cmd(Dot(2, 1), ["A"])
        graph.handle_add(Dot(1, 1), cmd_0, [dep(Dot(2, 1))], time)
        assert graph.commands_to_execute() == []
        graph.handle_add(Dot(2, 1), cmd_1, [dep(Dot(1, 1))], time)
        assert graph.commands_to_execute() == [cmd_0, cmd_1], graph_cls
        # the two transitive-conflict regressions: different orders
        d1, d2, d3, d4, d5 = (Dot(1, s) for s in range(1, 6))
        deps = {d1: {d4}, d2: {d4}, d3: {d5}, d4: {d3}, d5: {d4}}
        a = check_termination(5, [(d, None, deps[d]) for d in [d3, d4, d5, d1, d2]], graph_cls)
        b = check_termination(5, [(d, None, deps[d]) for d in [d3, d4, d5, d2, d1]], graph_cls)
        assert a != b, graph_cls
        d11, d12, d21 = Dot(1, 1), Dot(1, 2), Dot(2, 1)
        args = {d11: (["A"], set()), d12: (["B"], set()), d21: (["A", "B"], {d12})}
        a = check_termination(3, [(d, *args[d]) for d in [d11, d12, d21]], graph_cls)
        b = check_termination(3, [(d, *args[d]) for d in [d12, d21, d11]], graph_cls)
        assert a != b, graph_cls

    # the 3-cycle under every delivery permutation, and random graphs under
    # sampled permutations: every graph class gives the oracle's order
    rng = random.Random(0)
    d1, d2, d3 = Dot(1, 1), Dot(2, 1), Dot(3, 1)
    workloads = [(1, [(d1, None, {d3}), (d2, None, {d1}), (d3, None, {d2})], None)]
    workloads += [(2, random_adds(2, 3, rng), 12) for _ in range(4)]
    for n, args, sample in workloads:
        expected = check_termination(n, list(args), DependencyGraph)
        perms = list(itertools.permutations(args))
        if sample:
            perms = rng.sample(perms, sample)
        for perm in perms:
            for graph_cls in GRAPHS:
                assert check_termination(n, list(perm), graph_cls) == expected, graph_cls

    for graph_cls in (BatchedKernels, BatchedNative):
        # large backward batches take the arrival-order fast path, and the
        # array drain yields the same order without Command objects
        src, seq, key, depm, cmds = big_backward_batch(5000)
        graph = graph_cls(1, SHARD, tcore.Config(3, 1))
        graph.handle_add_arrays(src, seq, key, depm, cmds, time)
        assert [c.rifl for c in graph.commands_to_execute()] == [c.rifl for c in cmds]
        assert graph.routes == {"fast": 1}
        graph = graph_cls(1, SHARD, tcore.Config(3, 1))
        graph.record_order_arrays = True
        graph.handle_add_arrays(src, seq, key, depm, cmds, time)
        graph.resolve_now(time)
        o_src, o_seq = graph.take_order_arrays()
        assert (o_src == src).all() and (o_seq == seq).all()
        assert not graph.commands_to_execute()

        # a missing dependency disables the shortcut until it arrives
        depm = depm.copy()
        depm[0, 0] = (2 << 32) | 1
        graph = graph_cls(1, SHARD, tcore.Config(3, 1))
        graph.handle_add_arrays(src, seq, key, depm, cmds, time)
        executed = graph.commands_to_execute()
        key0 = int((key == 0).sum())
        assert len(executed) == 5000 - key0
        assert all(c.rifl.sequence % 2 == 0 for c in executed)
        graph.handle_add(Dot(2, 1), make_cmd(Dot(2, 1), ["key0"]), [], time)
        late = graph.commands_to_execute()
        assert len(late) == key0 + 1
        assert [c.rifl for c in late if c.rifl != tcore.Rifl(2, 1)] == [
            c.rifl for c in cmds if c.rifl.sequence % 2 == 1]

    # the stuck set handed to the oracle is dependency-closed: nothing
    # executes past a missing dependency deeper than resolve_general's
    # propagation horizon (a ladder of merge vertices, newest first)
    n = 2048
    ghost = Dot(2, 1)
    src = np.ones(n, dtype=np.int64)
    seq = np.arange(n, 0, -1).astype(np.int64)
    depm = np.full((n, 2), -1, dtype=np.int64)
    for i in range(n - 2):
        depm[i] = [pack_dots(src[i + 1 : i + 2], seq[i + 1 : i + 2])[0],
                   pack_dots(src[i + 2 : i + 3], seq[i + 2 : i + 3])[0]]
    depm[n - 2] = [(2 << 32) | 1, (1 << 32) | 1]
    depm[n - 1, 0] = (2 << 32) | 1
    cmds = [make_cmd(Dot(1, int(seq[i])), ["x", "y"]) for i in range(n)]
    graph = BatchedKernels(1, SHARD, tcore.Config(3, 1))
    graph.handle_add_arrays(src, seq, np.full(n, -1, np.int32), depm, cmds, time)
    assert graph.commands_to_execute() == []
    graph.handle_add(ghost, make_cmd(ghost, ["x"]), [], time)
    drained = graph.commands_to_execute()
    assert len(drained) == n + 1 and drained[0].rifl == tcore.Rifl(2, 1)
    assert [c.rifl.sequence for c in drained[1:]] == list(range(1, n + 1))

    # the per-row liveness watchdog panics on a lost execution only
    clock = tcore.SimTime()
    for graph_cls in (BatchedKernels, BatchedNative):
        graph = graph_cls(1, SHARD, tcore.Config(3, 1))
        ghost = Dot(2, 7)
        graph.handle_add(Dot(1, 1), make_cmd(Dot(1, 1), ["a"]), [dep(ghost)], clock)
        assert graph.commands_to_execute() == []
        clock.add_millis(5000)
        graph.monitor_pending(clock)  # old but missing-blocked: fine
        graph._frontier.add(ghost.source, ghost.sequence)
        graph._dirty = False
        clock.add_millis(5000)
        with pytest.raises(AssertionError, match="without missing"):
            graph.monitor_pending(clock)

    # a large multi-key backlog with adversarial arrival resolves fully
    # with per-key order intact (the resident branch)
    n, nkeys = 5000, 64
    rng = random.Random(9)
    key_of = [(i % nkeys, (i * 7 + 1) % nkeys) for i in range(n)]
    last, deps = {}, []
    for i in range(n):
        row = set()
        for k in key_of[i]:
            if k in last and last[k] != i:
                row.add(last[k])
            last[k] = i
        deps.append(row)
    perm = list(range(n))
    rng.shuffle(perm)
    src = np.ones(n, dtype=np.int64)
    seq = np.array([p + 1 for p in perm], dtype=np.int64)
    width = max(len(d) for d in deps)
    depm = np.full((n, width), -1, dtype=np.int64)
    for pos, orig in enumerate(perm):
        for j, d in enumerate(sorted(deps[orig])):
            depm[pos, j] = (1 << 32) | (d + 1)
    cmds = [make_cmd(Dot(1, p + 1), [f"m{k}" for k in set(key_of[p])]) for p in perm]
    return src, seq, depm, cmds, key_of


def check_large_multikey(src, seq, depm, cmds, key_of):
    time = tcore.RunTime()
    n = len(src)
    graph = BatchedKernels(1, SHARD, tcore.Config(3, 1))
    graph.handle_add_arrays(src, seq, np.full(n, -1, np.int32), depm, cmds, time)
    executed = graph.commands_to_execute()
    assert len(executed) == n
    seen = {}
    for cmd in executed:
        orig = cmd.rifl.sequence - 1
        for k in set(key_of[orig]):
            assert seen.get(k, -1) < orig
            seen[k] = orig
    assert set(graph.routes) == {"general_resident"}


def test_host_route_matches_jax(jax_ref, monkeypatch):
    check_resolvers()
    check_graphs(monkeypatch)
    check_sims()
    check_large_multikey(*check_executor_cases())
