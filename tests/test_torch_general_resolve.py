"""Port parity: the general resolvers and the general plane-step modes.

The same numpy-seeded inputs go through the JAX reference
(``fantoch_tpu.ops.graph_resolve``: ``resolve_general``,
``resolve_general_resident``, ``_order_from_ranks`` and
``resolve_graph_plane_step`` in modes ``general`` and
``general_resident``, on the CPU the composed route) and through the port
(``fantoch_tpu_torch.ops.graph_resolve``, on CPU tensors the plain PyTorch
version of every kernel stage).  Tolerance: exact equality of every
output; the work is integers.

Two collected items on purpose (cases loop inside a test and the assert
names the case), and every reference call under the ``jax_ref`` fixture
(see test_torch_graph_resolve.py and ROADMAP.md Queue C).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src import monitoring as jax_monitoring

import chip_smoke
from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.executor.graph.graph_plane import (
    state_from_numpy,
    state_to_numpy,
)
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port

torch.set_num_threads(1)

TERMINAL, MISSING = port.TERMINAL, port.MISSING


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


def _assert_equal(case, fields, got, want):
    for name, g, w in zip(fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (case, name, g.dtype, w.dtype)
        assert np.array_equal(g, w), f"{case}: field {name} differs"


# ---------------------------------------------------------------------------
# dependency matrices
# ---------------------------------------------------------------------------


def _from_edges(n, edges, width=None):
    """int32[n, W] dep matrix from {row: [dep rows]}."""
    width = width or max([len(d) for d in edges.values()] + [1])
    deps = np.full((n, width), TERMINAL, np.int32)
    for row, targets in edges.items():
        deps[row, : len(targets)] = targets
    return deps


def _random_adds(rng, n_proc=2, events=3, keys="ABCD"):
    """The JAX package's ``random_adds`` generator (tests/test_graph_plane.py
    :81) as a dep matrix over shuffled rows: non-transitive conflicts,
    2-cycles, and directed 3+-cycles with no mutual edge."""
    dots = [(p, s) for p in range(1, n_proc + 1) for s in range(1, events + 1)]
    kset = {d: set(rng.choice(list(keys), 2, replace=False)) for d in dots}
    deps = {d: set() for d in dots}
    for i, left in enumerate(dots):
        for right in dots[i + 1 :]:
            if not kset[left] & kset[right]:
                continue
            if left[0] == right[0]:
                deps[max(left, right)].add(min(left, right))
            else:
                choice = int(rng.integers(0, 3))
                if choice in (0, 2):
                    deps[left].add(right)
                if choice in (1, 2):
                    deps[right].add(left)
    order = rng.permutation(len(dots))
    row = {dots[j]: i for i, j in enumerate(order)}
    return _from_edges(
        len(dots), {row[d]: sorted(row[x] for x in deps[d]) for d in dots}, width=8
    )


def _bench_general(batch=1 << 12, width=4):
    """``bench.py``'s general workload (:574-588: seed 7, ``width`` keys per
    command from 4096, a dep on the latest command of each key) in its
    adversarial arrival permutation (:620-634, seed 13): deps point forward
    as often as backward, so the fast path cannot apply."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 4096, size=(batch, width))
    deps = np.full((batch, width), TERMINAL, dtype=np.int32)
    last = {}
    for i in range(batch):
        slot = 0
        for k in keys[i]:
            prev = last.get(k)
            if prev is not None and prev != i and slot < width:
                deps[i, slot] = prev
                slot += 1
            last[k] = i
    perm = np.random.default_rng(13).permutation(batch)
    inv = np.empty(batch, np.int64)
    inv[perm] = np.arange(batch)
    return np.where(
        deps[inv] >= 0, perm[np.clip(deps[inv], 0, batch - 1)], TERMINAL
    ).astype(np.int32)


def _dead_gate_window():
    """48 rows in directed 3-cycles (no mutual edges: they never peel)
    beside a 16-row chain: with ``min_size=4`` the first stage reaches its
    fixpoint with 48 > 32 rows live, closes the publish gate, and the
    compaction cuts cycle rows (their dependents' cells become FROZEN)."""
    edges = {3 * c + i: [3 * c + (i + 1) % 3] for c in range(16) for i in range(3)}
    edges.update({48 + i: [47 + i] if i else [] for i in range(16)})
    return _from_edges(64, edges, width=2)


def _resolver_cases():
    rng = np.random.default_rng(23)
    # tests/test_ops_resolve.py's general cases (rows in dot order)
    yield "chain-and-merge", _from_edges(4, {1: [0], 3: [1, 2]}), (4096,)
    yield "two-cycle", _from_edges(2, {0: [1], 1: [0]}), (4096,)
    yield "three-cycle-stuck", _from_edges(3, {0: [2], 1: [0], 2: [1]}), (4096,)
    yield "three-way-mutual", _from_edges(3, {0: [2], 1: [2], 2: [0, 1]}), (4096,)
    yield "mutual-clique", _from_edges(4, {i: [j for j in range(4) if j != i]
                                          for i in range(4)}), (4096,)
    # a 2-member mutual SCC whose one live exit is a non-leader's, with a
    # dependent on its leader: composing through the leader would be wrong
    yield "scc-one-exit", _from_edges(
        7, {0: [1], 1: [0, 2], 2: [3], 3: [4], 4: [6], 5: [0], 6: []}
    ), (4096,)
    for trial in range(4):
        yield f"random-adds-{trial}", _random_adds(rng), (4096, 2)
    # MISSING cells and self-dependencies over a random multi-dep graph
    n = 96
    pick = rng.random((n, 4))
    deps = np.where(
        pick < 0.3, TERMINAL,
        np.where(pick < 0.4, MISSING, rng.integers(0, n, (n, 4))),
    ).astype(np.int32)
    deps[::7, 1] = np.arange(0, n, 7)  # self-dependencies
    yield "missing-and-self", deps, (4096, 8)
    # all-backward and nothing missing: the fast path
    back = np.where(deps >= np.arange(n)[:, None], TERMINAL, deps)
    yield "all-backward", back, (4096,)
    yield "bench-general-4096x4", _bench_general(), (4096, 256)
    yield "dead-gate", _dead_gate_window(), (4,)


def test_general_resolvers_match_jax(jax_ref, monkeypatch):
    """``resolve_general``, ``resolve_general_resident`` (at the default
    ``min_size`` and at one that makes it compact) and ``_order_from_ranks``
    equal the reference on order, resolved, rank, leader and stuck.  The
    fast path, the affine rounds, stuck cycles, compactions and the closed
    publish gate with FROZEN cells are each counted and required."""
    seen = {"fast": 0, "rounds": 0, "stuck": 0, "compact": 0, "frozen": 0}
    real_loop, real_compact = K.affine_loop, K.peel_compact

    def counted_loop(*args, **kwargs):
        out = real_loop(*args, **kwargs)
        seen["rounds"] += int(out[3].item())
        return out

    def counted_compact(*args, mode, half=0):
        out = real_compact(*args, mode=mode, half=half)
        if mode == "compact":
            seen["compact"] += 1
            seen["frozen"] += int((out[0][0] == K.FROZEN).sum())
        return out

    monkeypatch.setattr(K, "affine_loop", counted_loop)
    monkeypatch.setattr(K, "peel_compact", counted_compact)
    for name, deps, min_sizes in _resolver_cases():
        n = deps.shape[0]
        rng = np.random.default_rng(n)
        src = (1 + rng.integers(0, 5, n)).astype(np.int32)
        seq = rng.permutation(n).astype(np.int32)
        t = [torch.tensor(a) for a in (deps, src, seq)]
        j = [jnp.asarray(a) for a in (deps, src, seq)]
        rounds = seen["rounds"]
        # the cells that bar the fast path, counted here as the plane's
        # general prologue counts them
        n_bad = int(((deps > np.arange(n)[:, None]) | (deps == MISSING)).sum())
        got = port.resolve_general(*t, n_bad=n_bad)
        _assert_equal(f"{name} resolve_general", got._fields, got,
                      ref.resolve_general(*j))
        seen["fast"] += rounds == seen["rounds"]
        seen["stuck"] += int(got.stuck.any())
        _assert_equal(
            f"{name} _order_from_ranks", ("order",),
            (port._order_from_ranks(got.rank, got.leader, t[1], t[2]),),
            (ref._order_from_ranks(*(jnp.asarray(x.numpy()) for x in
                                     (got.rank, got.leader, t[1], t[2]))),),
        )
        for min_size in min_sizes:
            got = port.resolve_general_resident(*t, min_size=min_size)
            _assert_equal(f"{name} resolve_general_resident min_size={min_size}",
                          got._fields, got,
                          ref.resolve_general_resident(*j, min_size=min_size))
    assert all(seen.values()), seen


# ---------------------------------------------------------------------------
# the general plane step over multi-dispatch sequences
# ---------------------------------------------------------------------------


def _fresh(cap, width):
    return (
        np.full((cap, width), TERMINAL, np.int32),
        np.zeros(cap, np.int32),
        np.zeros(cap, np.int32),
        np.zeros(cap, np.int32),
        np.zeros(cap, bool),
        np.zeros(cap, bool),
    )


def _feed(rng, state, installed, cap, width, U, P, E, cycles):
    """One dispatch's padded columns: new rows with 0..width live cells
    (TERMINAL / MISSING / an earlier or later slot), multi-key rows
    (key -1), optional 2- and 3-cycles among the new rows, patches of
    MISSING cells (to a slot or TERMINAL) and host-oracle executed marks."""
    u_row = np.full(U, cap, np.int32)
    u_deps = np.full((U, width), TERMINAL, np.int32)
    u_key = np.zeros(U, np.int32)
    u_src = np.zeros(U, np.int32)
    u_seq = np.zeros(U, np.int32)
    n = min(int(rng.integers(1, U + 1)), cap - installed)
    for i in range(n):
        row = installed + i
        u_row[i] = row
        u_key[i] = -1 if rng.random() < 0.5 else rng.integers(0, 4)
        u_src[i] = rng.integers(1, 4)
        u_seq[i] = row + 1
        for w in range(int(rng.integers(0, width + 1))):
            pick = rng.random()
            u_deps[i, w] = (
                TERMINAL if pick < 0.15 else MISSING if pick < 0.3
                else rng.integers(0, installed + n)
            )
    if cycles and n >= 5:
        b = installed
        u_deps[0, 0], u_deps[1, 0] = b + 1, b  # a 2-cycle
        u_deps[2, 0], u_deps[3, 0], u_deps[4, 0] = b + 3, b + 4, b + 2  # a 3-cycle
    p_row = np.full(P, cap, np.int32)
    p_col = np.zeros(P, np.int32)
    p_val = np.zeros(P, np.int32)
    missing = np.argwhere(state[0][:installed] == MISSING)
    rng.shuffle(missing)
    for j, (r, c) in enumerate(missing[: int(rng.integers(0, P + 1))].tolist()):
        p_row[j], p_col[j], p_val[j] = r, c, rng.integers(-1, installed + n)
    e_row = np.full(E, cap, np.int32)
    if installed:
        marks = rng.choice(installed, min(E, installed), replace=False)
        k = int(rng.integers(0, len(marks) + 1))
        e_row[:k] = marks[:k]
    return (u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row), n


_STEP_CASES = (
    # (cap, U, P, E, feeds): a capacity that is not a power of two, and one
    # whose window the resident peeler compacts (min_size 4096 > cap, so a
    # single terminal stage: the compaction is covered above)
    (48, 8, 8, 4, 6),
    (256, 64, 32, 8, 4),
)


def test_general_plane_step_matches_jax(jax_ref):
    """Bit-for-bit ``GraphPlaneStep`` (all ten fields, state included) in
    modes ``general`` and ``general_resident`` over multi-dispatch
    sequences of installs, patches and marks, the port's state carried
    from the reference's with ``state_from_numpy`` halfway through.  Then
    the kernels' CUDA sources themselves, run on the CPU by
    ``csrc/emu/emulate.py``, on the first case's feeds: every wrapper call
    equals its plain version (``chip_smoke.Checker``, as on the card)."""
    stuck_seen = 0
    feeds = {}
    for mode in ("general", "general_resident"):
        for cap, U, P, E, n_feeds in _STEP_CASES:
            width = 4
            rng = np.random.default_rng(cap + len(mode))
            state = _fresh(cap, width)
            mine = tuple(torch.tensor(a) for a in state)
            installed = 0
            for feed_i in range(n_feeds):
                feed, n = _feed(rng, state, installed, cap, width, U, P, E,
                                cycles=feed_i == 1)
                installed += n
                feeds.setdefault((mode, cap), []).append(feed)
                want = ref.resolve_graph_plane_step(
                    *(jnp.array(a) for a in state),
                    *(jnp.asarray(a) for a in feed),
                    mode=mode,
                )
                want = [np.asarray(x) for x in want]
                got = port.resolve_graph_plane_step(
                    *mine, *(torch.tensor(a) for a in feed), mode=mode
                )
                _assert_equal(f"{mode} cap {cap} feed {feed_i}", got._fields, got, want)
                stuck_seen += int(got.stuck.any())
                state = tuple(want[:6])
                if feed_i == n_feeds // 2:
                    # continue from the reference's backlog
                    mine = state_from_numpy(state, "cpu")
                    for a, b in zip(state_to_numpy(mine), state):
                        assert a.dtype == b.dtype and np.array_equal(a, b)
                else:
                    mine = tuple(got[:6])
    assert stuck_seen, "no dispatch left a stuck cycle"

    checker = chip_smoke.Checker(K)
    with emulated():
        checker.install()
        try:
            for mode in ("general", "general_resident"):
                cap = _STEP_CASES[0][0]
                state = tuple(torch.tensor(a) for a in _fresh(cap, 4))
                for feed in feeds[(mode, cap)]:
                    out = port.resolve_graph_plane_step(
                        *state, *(torch.tensor(a) for a in feed), mode=mode
                    )
                    state = tuple(out[:6])
        finally:
            checker.uninstall()
    used = {name for name, count in checker.count.items() if count}
    assert set(K.GENERAL_KERNELS) <= used, used
