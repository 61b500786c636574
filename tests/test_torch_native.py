"""Port parity: the native C++ SCC resolver (``fantoch_tpu_torch/native``).

The port's library against the JAX package's ``fantoch_tpu.native`` (the
same C++ contract, so the same ``(order, sizes)`` bit for bit) and against
the port's Python Tarjan oracle (``DependencyGraph``: the same per-key
order) on hand-built graphs, on random KeyDeps-shaped and multi-key
graphs with cycles and missing dependencies, and through the batched
graph executor: ``Config.host_native_resolver=True`` resolves the whole
backlog natively (a directed 3-ring no device pass collapses, plus a
dependent), with the same emission as the reference's native route and
the same per-key order as the port's kernel route.  A library that cannot
be built raises ``NativeBuildError``; nothing falls back.

One collected item on purpose (ROADMAP.md Queue C).
"""

import random

import numpy as np
import pytest
import torch

from torch_jax_ref import jax_ref  # noqa: F401 — the fixture

import fantoch_tpu.core as jcore
from fantoch_tpu import native as ref_native
from fantoch_tpu.executor.graph.batched import (
    BatchedDependencyGraph as RefBatched,
)
from fantoch_tpu.protocol.common.graph_deps import Dependency as RefDependency
import fantoch_tpu_torch.core as tcore
from fantoch_tpu_torch import native
from fantoch_tpu_torch.executor.graph.batched import BatchedDependencyGraph
from fantoch_tpu_torch.executor.graph.deps_graph import DependencyGraph
from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

torch.set_num_threads(1)

SHARD = 0


def _csr(rows):
    """(offsets, targets) of a list of target lists."""
    offsets = np.zeros(len(rows) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    targets = np.fromiter((t for r in rows for t in r), np.int32, offsets[-1])
    return offsets, targets


def _random_graph(rng, n, n_keys, width, p_missing, p_back):
    """Multi-key rows, each depending on the latest earlier row of each of
    its keys and, with probability ``p_back``, on a later one (cycles);
    some dependencies MISSING.  Returns (rows, dots, keys)."""
    keys = [rng.sample(range(n_keys), rng.randint(1, min(width, n_keys)))
            for _ in range(n)]
    rows = [[] for _ in range(n)]
    last = {}
    for i, ks in enumerate(keys):
        for k in ks:
            if k in last:
                rows[i].append(last[k])
                if rng.random() < p_back:
                    rows[last[k]].append(i)
            last[k] = i
        if rng.random() < p_missing:
            rows[i].append(-2)
    dots = np.array(
        [((1 + i % 5) << 32) | (1 + i // 5) for i in range(n)], np.int64
    )
    return rows, dots, keys


def _python_per_key(rows, dots, keys):
    """Per-key dot order and count the Python oracle executes."""
    graph = DependencyGraph(1, SHARD, tcore.Config(5, 1))
    shards = frozenset({SHARD})
    as_dot = lambda p: tcore.Dot(int(p) >> 32, int(p) & 0xFFFFFFFF)  # noqa: E731
    ghost = tcore.Dot(9, 1)  # never committed: a MISSING dependency
    order = {}
    for i in range(len(rows)):
        deps = [Dependency(ghost if t == -2 else as_dot(dots[t]), shards)
                for t in rows[i]]
        cmd = tcore.Command.from_keys(
            tcore.Rifl(1, i + 1), SHARD,
            {f"k{k}": (tcore.KVOp.put(""),) for k in keys[i]},
        )
        graph.handle_add(as_dot(dots[i]), cmd, deps, tcore.RunTime())
        for done in graph.commands_to_execute():
            row = done.rifl.sequence - 1
            for k in keys[row]:
                order.setdefault(k, []).append(row)
    return order


def _native_per_key(order, keys):
    out = {}
    for row in order.tolist():
        for k in keys[row]:
            out.setdefault(k, []).append(row)
    return out


def _ring_graph(root, cls, config, device):
    """A directed 3-ring (no mutual edge: stuck for the device pass) plus
    a dependent of all three, through a batched graph of either package."""
    core = jcore if root == "jax" else tcore
    dep = RefDependency if root == "jax" else Dependency
    time = core.RunTime()
    graph = cls(1, SHARD, config, **device)
    shards = frozenset({SHARD})
    d1, d2, d3, d4 = (core.Dot(1, 1), core.Dot(2, 1), core.Dot(3, 1),
                      core.Dot(1, 2))

    def cmd(dot):
        return core.Command.from_keys(
            core.Rifl(dot.source, dot.sequence), SHARD, {"A": (core.KVOp.put("v"),)}
        )

    graph.handle_add(d1, cmd(d1), [dep(d3, shards)], time)
    graph.handle_add(d2, cmd(d2), [dep(d1, shards)], time)
    graph.handle_add(d3, cmd(d3), [dep(d2, shards)], time)
    graph.handle_add(
        d4, cmd(d4), [dep(d1, shards), dep(d2, shards), dep(d3, shards)], time
    )
    return [(c.rifl.source, c.rifl.sequence) for c in graph.commands_to_execute()], graph


def test_native_resolver_matches_reference_and_oracle(jax_ref, monkeypatch, tmp_path):
    # the contract on hand-built graphs: chain 0<-1<-2; 2-cycle {3,4}; 5
    # blocked by a missing dep and 6 behind it; then missing-blocked
    # components omitted
    for rows, dots, order, sizes in (
        ([[], [0], [1], [4], [3], [-2], [5]], [10, 11, 12, 20, 13, 30, 31],
         [0, 1, 2, 4, 3], [1, 1, 1, 2, 2]),
        ([[-2], [0], [1], []], [1, 2, 3, 4], [3], [1]),
        ([], [], [], []),
    ):
        offsets, targets = _csr(rows)
        dots = np.asarray(dots, np.int64)
        got = native.resolve_sccs(offsets, targets, dots)
        assert got[0].tolist() == order and got[1].tolist() == sizes, rows
        want = ref_native.resolve_sccs(offsets, targets, dots)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), rows

    # random graphs: bit for bit against the reference library, per-key
    # order against the Python oracle
    rng = random.Random(21)
    cycles = blocked = 0
    for trial in range(24):
        n = rng.choice((40, 200, 1500))
        rows, dots, keys = _random_graph(
            rng, n, n_keys=rng.choice((3, 12, 64)), width=rng.choice((1, 2, 4)),
            p_missing=rng.choice((0.0, 0.01)), p_back=rng.choice((0.0, 0.1, 0.4)),
        )
        offsets, targets = _csr(rows)
        got = native.resolve_sccs(offsets, targets, dots)
        want = ref_native.resolve_sccs(offsets, targets, dots)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), trial
        assert _native_per_key(got[0], keys) == _python_per_key(rows, dots, keys), trial
        cycles += int((got[1] > 1).any())
        blocked += len(got[0]) < n
    assert cycles and blocked, (cycles, blocked)

    # through the batched graph: the native route on both packages, and
    # the port's kernel route (plain versions on the CPU) with its Python
    # stuck-residue oracle, which the reference reaches with its native
    # library unavailable
    got, graph = _ring_graph(
        "torch", BatchedDependencyGraph,
        tcore.Config(3, 1, batched_graph_executor=True, host_native_resolver=True),
        {},
    )
    want, _ = _ring_graph(
        "jax", RefBatched,
        jcore.Config(3, 1, batched_graph_executor=True, host_native_resolver=True),
        {},
    )
    expected = [(1, 1), (2, 1), (3, 1), (1, 2)]
    assert got == want == expected and graph.routes == {"native": 1}, (got, want)
    kernel, graph = _ring_graph(
        "torch", BatchedDependencyGraph,
        tcore.Config(3, 1, batched_graph_executor=True), {"device": "cpu"},
    )
    monkeypatch.setattr(ref_native, "available", lambda: False)
    want, _ = _ring_graph(
        "jax", RefBatched,
        jcore.Config(3, 1, batched_graph_executor=True, host_native_resolver=False),
        {},
    )
    assert kernel == want == expected and graph.routes == {"general": 1}, kernel

    # no probe and no fallback: a library that cannot be built raises
    def no_compiler(*_args, **_kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    with pytest.raises(native.NativeBuildError):
        _ring_graph(
            "torch", BatchedDependencyGraph,
            tcore.Config(3, 1, batched_graph_executor=True, host_native_resolver=True),
            {},
        )
