"""``pointer_doubling`` (``csrc/graph_plane_step.cu`` §6) against its plain
version, a numpy walk of every vertex and the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test: one
cooperative launch (``K.LOOP_BLOCK`` lowered to 64, so the emulated grid
is at most 4 blocks of 64 threads, and rows are walked grid-stride, several
rows a thread at once past 256 rows).  Every input
is called twice in a row, so a changed word left by the call before would
show.  The numpy-seeded inputs are ``chip_smoke.functional_graphs``'
kinds at 2,048 rows (all TERMINAL, all MISSING, MISSING mid-chain,
self-loops, 2-cycles, one cycle through every row, long tails into short
cycles, a random functional graph, chains whose ids rise and fall along
the walk), random graphs of n = 1, 2, 3 and 3,001 rows and a 4,096-row
hot-key chain with one break.  Each output must equal
``pointer_doubling_plain``, a numpy walk (a vertex on a cycle: its
leader the cycle's least id, rank 0; else resolved where its walk ends
at TERMINAL or on a cycle, its rank the hops there) and the reference's
``_doubling_core`` (``fantoch_tpu/ops/graph_resolve.py:96``).  Then one
keyed plane step sequence whose residual overflows (the full-window
doubling on the emulated kernel, the other stages on their plain
versions; a 1,024-slot window, shuffled feeds) must equal the
reference's ``resolve_graph_plane_step`` (mode ``keyed``) field by
field.  Tolerance: exact; the work is integers.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_graph_resolve.py).
"""

import numpy as np
import torch

import jax.numpy as jnp

import chip_smoke
from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port
from test_torch_graph_resolve import _FeedMaker, _fresh, jax_ref  # noqa: F401

torch.set_num_threads(1)

TERMINAL, MISSING = K.TERMINAL, K.MISSING
ROWS = 2048


def walk(dep):
    """(resolved, rank, leader, on_cycle) of every vertex by following its
    walk once (iteratively, each vertex settled after its successor)."""
    n = len(dep)
    on_cycle = np.zeros(n, bool)
    leader = np.arange(n, dtype=np.int32)
    resolved = np.zeros(n, bool)
    rank = np.full(n, K.INT32_MAX, np.int32)
    state = np.zeros(n, np.int8)  # 0 unseen, 1 on the current walk, 2 settled
    for s in range(n):
        path, v = [], s
        while v >= 0 and state[v] == 0:
            state[v] = 1
            path.append(v)
            v = int(dep[v])
        if v >= 0 and state[v] == 1:  # the walk closed a cycle at v
            cycle = path[path.index(v):]
            path = path[:path.index(v)]
            for u in cycle:
                on_cycle[u], leader[u], resolved[u], rank[u] = True, min(cycle), True, 0
                state[u] = 2
        for u in reversed(path):
            d = int(dep[u])
            if d == TERMINAL:
                resolved[u], rank[u] = True, 0
            elif d >= 0 and resolved[d]:
                resolved[u], rank[u] = True, rank[d] + 1
            state[u] = 2
    return resolved, rank, leader, on_cycle


def graphs(rng):
    out = dict(chip_smoke.functional_graphs(ROWS, 17))
    for n in (1, 2, 3, 3001):
        out[f"n = {n}, random"] = rng.integers(-2, n, n).astype(np.int32)
    hot = np.arange(4096, dtype=np.int32) - 1
    hot[1365] = MISSING
    out["hot-key chain, 4,096 rows, one break"] = hot
    return out


def test_doubling_kernel_matches_plain_walk_and_reference(jax_ref, monkeypatch):
    rng = np.random.default_rng(71)
    inputs = graphs(rng)
    expected = {}
    for name, dep in inputs.items():
        walked = walk(dep)
        theirs = [np.asarray(x) for x in ref._doubling_core(jnp.asarray(dep))]
        plain = K.pointer_doubling_plain(torch.tensor(dep))
        for i, (w, t, p) in enumerate(zip(walked, theirs, plain)):
            assert np.array_equal(w, t) and np.array_equal(p.numpy(), t), (name, i)
        expected[name] = plain
    # the kinds reach what they claim
    assert expected["all MISSING"][0].sum() == 0
    assert expected["one cycle through all rows"][3].all()
    assert expected["2-cycles"][3].all() and expected["self-loops"][3].all()
    assert not expected["hot-key chain, 4,096 rows, one break"][0][1365:].any()
    tails = expected["long tails into short cycles"]
    assert tails[3].any() and (~tails[3]).any() and tails[1][~tails[3]].max() > 8

    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        if fn == "gp_pointer_doubling":
            launched.append(args[-1])  # the block's threads
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    with emulated():
        for name, dep in inputs.items():
            for run in range(2):
                got = K.pointer_doubling(torch.tensor(dep))
                for i, (g, w) in enumerate(zip(got, expected[name])):
                    assert g.dtype == w.dtype and torch.equal(g, w), (name, run, i)
        assert len(launched) == 2 * len(inputs) and max(launched) == 64, launched

        # a keyed plane step sequence whose residual overflows: the
        # full-window doubling on the emulated kernel, the other stages on
        # their plain versions
        for name in ("graph_prologue", "lex_sort", "link_scan", "residual_view",
                     "group_scan", "emit_scatter", "plane_epilogue"):
            monkeypatch.setattr(K, name, getattr(K, f"{name}_plain"))
        full = []
        real_full = port.resolve_functional

        def counted_full(*args, **kwargs):
            full.append(int(args[0].numel()))
            return real_full(*args, **kwargs)

        monkeypatch.setattr(port, "resolve_functional", counted_full)
        cap, width = 1024, 4
        maker = _FeedMaker("shuffled", cap, width, 256, 256, 8, seed=cap)
        state = _fresh(cap, width)
        mine = tuple(torch.tensor(a) for a in state)
        launched.clear()
        for feed_i in range(2):
            feed = maker.next(state, feed_i)
            want = [np.asarray(x) for x in ref.resolve_graph_plane_step(
                *(jnp.array(a) for a in state), *(jnp.asarray(a) for a in feed),
                mode="keyed")]
            got = port.resolve_graph_plane_step(
                *mine, *(torch.tensor(a) for a in feed), mode="keyed")
            for field, g, w in zip(got._fields, got, want):
                assert np.array_equal(g.numpy(), w), (feed_i, field)
            state = tuple(want[:6])
            mine = tuple(got[:6])
    assert cap in full, full
    assert len(launched) >= full.count(cap), launched
