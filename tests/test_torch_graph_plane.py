"""Port parity: the device graph plane and the graph executor.

The port's ``DeviceGraphPlane`` (driven through ``BatchedDependencyGraph``
with ``device="cpu"``, where every kernel stage runs its plain PyTorch
version) and ``GraphExecutor`` against the JAX package's on the same
numpy-seeded feeds: the same emitted order, feed by feed, the same
resident state, the same counters.  Exact equality throughout.

Two collected items on purpose (scenarios loop inside a test and the
assert names the scenario); reference calls run under ``jax_ref``.
"""

import inspect
import pickle

import numpy as np
import pytest
import torch

from jax._src import monitoring as jax_monitoring

from bench import build_workload
import fantoch_tpu.core as jcore
import fantoch_tpu.protocol.common.graph_deps as jdeps
from fantoch_tpu.executor.graph import batched as jbatched
from fantoch_tpu.executor.graph import executor as jexecutor
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol.common.graph_deps as tdeps
from fantoch_tpu_torch.executor.graph import batched as tbatched
from fantoch_tpu_torch.executor.graph import executor as texecutor
from fantoch_tpu_torch.executor.graph.graph_plane import (
    state_from_numpy,
    state_to_numpy,
)
from fantoch_tpu_torch.ops.frontier import pack_dots

torch.set_num_threads(1)

SHARD = 0


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
    keyword arguments they do not take (see test_torch_graph_resolve.py:
    a listener registered by ``subscribe_recompiles`` takes none, and jax
    0.9 passes ``fun_name=``).  Restored after the test."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )


class _Side:
    """One package's graph plus the names it is built from."""

    def __init__(self, pkg, batched, **kwargs):
        self.pkg = pkg
        config = pkg.Config(
            3, 1, batched_graph_executor=True, device_graph_plane=True
        )
        self.graph = batched.BatchedDependencyGraph(1, SHARD, config, **kwargs)
        self.graph.record_order_arrays = True
        self.time = pkg.RunTime()

    def cmd(self, src, seq, key):
        return self.pkg.Command.from_keys(
            self.pkg.Rifl(src, seq), SHARD, {f"k{key}": (self.pkg.KVOp.put(""),)}
        )

    def feed(self, src, seq, key, dep_dots):
        cmds = [self.cmd(int(s), int(q), int(k)) for s, q, k in zip(src, seq, key)]
        keys = np.fromiter(
            (jbatched.key_hash(f"k{int(k)}") for k in key), np.int32, len(key)
        )
        self.graph.handle_add_arrays(src, seq, keys, dep_dots, cmds, self.time)
        self.graph.resolve_now(self.time)
        return self.graph.take_order_arrays()


def _workload(n, conflict, clients, seed, window):
    """``bench.build_workload`` commands as (src, seq, key, packed deps),
    in an arrival order shuffled within windows (commits arriving across
    replicas: deps on not-yet-arrived dots are MISSING until they do)."""
    key, dep, src, seq = build_workload(n, conflict, clients=clients, seed=seed)
    dot_src = src.astype(np.int64)
    dot_seq = seq.astype(np.int64) + 1
    has = dep >= 0
    di = np.where(has, dep, 0)
    dep_dots = np.where(has, pack_dots(dot_src[di], dot_seq[di]), -1).reshape(-1, 1)
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    for s in range(0, n, window):
        rng.shuffle(order[s : s + window])
    return dot_src[order], dot_seq[order], key[order], dep_dots[order]


def _shrink(plane, cap):
    """Shrink a fresh plane's window so compaction runs at test size."""
    assert plane._next_slot == 0 and plane._resident is None
    plane._cap = cap
    for name in ("_slot_src", "_slot_seq", "_slot_tms", "_slot_key",
                 "_slot_general", "_exec_host"):
        setattr(plane, name, getattr(plane, name)[:cap].copy())
    plane._slot_deps = plane._slot_deps[:cap].copy()


def _compare(case, ref, mine, got, want):
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), (
        f"{case}: emitted order differs"
    )
    rp, mp = ref.graph._plane, mine.graph._plane
    if rp._resident is not None:
        mine_state = state_to_numpy(mp._resident)
        for i, (a, b) in enumerate(zip(mine_state, rp._fetch_state())):
            assert np.array_equal(a, b), f"{case}: resident state array {i} differs"
    for name in ("dispatches", "resident_uploads", "grows", "pending_count"):
        assert getattr(mp, name) == getattr(rp, name), f"{case}: {name} differs"
    for name, value in rp.stats.items():
        if name != "kernel_ms":
            assert mp.stats[name] == value, f"{case}: stats[{name}] differs"


def _dep(pkg_deps, dot):
    return pkg_deps.Dependency(dot, frozenset({SHARD}))


def test_graph_plane_matches_jax(jax_ref):
    """Feed by feed: emitted chunks, resident state and counters equal the
    JAX plane's — through residual-carrying shuffled feeds, a window
    compacted repeatedly, the JAX backlog carried into the port mid-run
    with ``state_from_numpy``, snapshot/restore with its single
    re-upload, and a recovered noop that unblocks waiters."""
    src, seq, key, dep_dots = _workload(1536, 0.5, 32, 3, window=40)
    ref = _Side(jcore, jbatched)
    mine = _Side(tcore, tbatched, device="cpu")
    for side in (ref, mine):
        _shrink(side.graph._plane, 512)
    feed = 96
    for i, s in enumerate(range(0, 768, feed)):
        cut = slice(s, s + feed)
        want = ref.feed(src[cut], seq[cut], key[cut], dep_dots[cut])
        got = mine.feed(src[cut], seq[cut], key[cut], dep_dots[cut])
        _compare(f"feed {i}", ref, mine, got, want)
    plane = mine.graph._plane
    assert plane.stats["compactions"] >= 1 and plane.stats["patched_cells"] > 0
    assert plane.pending_count > 0, "the carry below needs a live backlog"

    # carry the JAX backlog into the port mid-run
    jax_state = ref.graph._plane._fetch_state()
    carried = state_from_numpy(jax_state, "cpu")
    for a, b in zip(state_to_numpy(carried), jax_state):
        assert a.dtype == b.dtype and np.array_equal(a, b), "state round trip"
    plane._resident = carried

    # snapshot/restore: ONE counted re-upload at the next dispatch
    ref.graph = pickle.loads(pickle.dumps(ref.graph))
    mine.graph = pickle.loads(pickle.dumps(mine.graph))
    plane = mine.graph._plane
    before = (plane.resident_uploads, plane.stats["compactions"], plane.grows)
    for i, s in enumerate(range(768, 1536, feed)):
        cut = slice(s, s + feed)
        want = ref.feed(src[cut], seq[cut], key[cut], dep_dots[cut])
        got = mine.feed(src[cut], seq[cut], key[cut], dep_dots[cut])
        _compare(f"feed {i} after restore", ref, mine, got, want)
    uploads = plane.resident_uploads - before[0]
    later = plane.stats["compactions"] - before[1] + plane.grows - before[2]
    assert uploads == 1 + later, (uploads, later)
    assert plane.pending_count == 0

    # a recovered noop unblocks the rows waiting on it
    for side, deps_mod in ((ref, jdeps), (mine, tdeps)):
        pkg, graph = side.pkg, side.graph
        graph.record_order_arrays = False
        ghost, waiter = pkg.Dot(9, 5), pkg.Dot(9, 6)
        graph.handle_add(waiter, side.cmd(9, 6, 0), [_dep(deps_mod, ghost)], side.time)
        assert graph.commands_to_execute() == []
        graph.handle_noop(ghost, side.time)
        got = [(c.rifl.source, c.rifl.sequence) for c in graph.commands_to_execute()]
        assert got == [(9, 6)], f"noop wake on {pkg.__name__}: {got}"


def _run_executor(pkg, exmod, feeds, **kwargs):
    config = pkg.Config(
        3, 1, batched_graph_executor=True, device_graph_plane=True,
        executor_monitor_execution_order=True,
    )
    ex = exmod.GraphExecutor(1, SHARD, config, **kwargs)
    time = pkg.RunTime()
    results = []
    for kind, payload in feeds:
        if kind == "noop":
            ex.handle(exmod.GraphNoop(pkg.Dot(*payload)), time)
        else:
            src, seq, key, dep_dots = payload
            cmds = [
                pkg.Command.from_keys(
                    pkg.Rifl(int(s), int(q)), SHARD,
                    {f"k{int(k)}": (pkg.KVOp.put(f"v{int(q)}"),)},
                )
                for s, q, k in zip(src, seq, key)
            ]
            keys = np.fromiter(
                (jbatched.key_hash(f"k{int(k)}") for k in key), np.int32, len(key)
            )
            ex.handle(exmod.GraphAddBatch(src, seq, keys, dep_dots, cmds), time)
        while (r := ex.to_clients()) is not None:
            results.append(
                ((r.rifl.source, r.rifl.sequence), r.key, repr(r.op_results))
            )
    monitor = ex.monitor()
    per_key = {
        k: [(r.source, r.sequence) for r in monitor.get_order(k)]
        for k in sorted(monitor.keys())
    }
    return results, per_key, ex.device_counters()


def test_graph_executor_matches_jax(jax_ref):
    """``GraphExecutor`` fed ``GraphAddBatch`` commit buffers (the bench
    workload, shuffled across feed boundaries so deps arrive late) and a
    ``GraphNoop`` for a dot that never commits: the same results, in the
    same order, and the same per-key execution order as the JAX
    executor — every command executed exactly once."""
    n = 2048
    src, seq, key, dep_dots = _workload(n, 0.5, 64, 7, window=40)
    # one command waits on a dot that is recovered as a noop
    dep_dots[n - 1, 0] = int(pack_dots(np.array([6]), np.array([1]))[0])
    feeds = [
        ("add", (src[s : s + 300], seq[s : s + 300], key[s : s + 300],
                 dep_dots[s : s + 300]))
        for s in range(0, n, 300)
    ] + [("noop", (6, 1))]
    want, want_keys, want_ctr = _run_executor(jcore, jexecutor, feeds)
    got, got_keys, got_ctr = _run_executor(tcore, texecutor, feeds, device="cpu")
    assert got == want, "executor results differ"
    assert got_keys == want_keys, "per-key execution order differs"
    assert len(got) == n and len({r[0] for r in got}) == n, "not exactly once"
    for name in ("graph_plane_dispatches", "graph_plane_resident_uploads",
                 "graph_plane_patched_cells", "graph_plane_compactions"):
        assert got_ctr[name] == want_ctr[name], f"counter {name} differs"
    assert got_ctr["graph_plane_patched_cells"] > 0
