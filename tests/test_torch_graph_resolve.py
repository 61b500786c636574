"""Port parity: the keyed graph-plane step and the functional resolvers.

The same numpy-seeded inputs go through the JAX reference
(``fantoch_tpu.ops.graph_resolve``, on the CPU the composed route, which
``tests/test_pallas_resolve.py`` holds bit for bit against the Pallas
interpret route; one case forces the interpret route itself) and through
the port (``fantoch_tpu_torch.ops.graph_resolve``, on CPU tensors the plain
PyTorch version of every kernel stage).  Tolerance: exact equality of every
output; the work is integers.

Shape of this file, on purpose: two collected items (cases loop inside a
test and the assert names the case), few distinct JAX shapes (caps 32, 48,
256, 1024 and one 4096-row batch), and every reference call under the
``jax_ref`` fixture below.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src import monitoring as jax_monitoring

from bench import build_workload
from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu.ops import pallas_resolve
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
    keyword arguments they do not take.  A listener that takes none (as
    ``fantoch_tpu.observability.device`` registers once any code in the
    process called ``subscribe_recompiles``) otherwise makes every later
    JAX compile raise ``TypeError`` under jax 0.9, whose dispatch passes
    ``fun_name=``.  The list is restored after the test."""
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
# the keyed plane step over multi-feed sequences
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


class _FeedMaker:
    """Numpy-seeded dispatch feeds.  ``random``: 0..2 live cells per row
    (TERMINAL / MISSING / an earlier slot), a 2-cycle and a 3-cycle in
    the second feed, patches of MISSING cells, executed marks.
    ``chains``: latest-per-key deps in arrival order (every link
    verifies).  ``shuffled``: the same chains installed in an order
    shuffled within windows, as commits arrive across replicas — deps on
    uninstalled commands are MISSING and patched when they arrive."""

    def __init__(self, kind, cap, width, U, P, E, seed, n_keys=4, window=8):
        self.kind, self.cap, self.width = kind, cap, width
        self.U, self.P, self.E = U, P, E
        self.rng = np.random.default_rng(seed)
        self.installed = 0
        n = cap
        keys = self.rng.integers(0, n_keys, n)
        self.keys = keys.astype(np.int32)
        self.dep = np.full(n, -1, np.int64)
        last = {}
        for i, k in enumerate(keys.tolist()):
            self.dep[i] = last.get(k, -1)
            last[k] = i
        order = np.arange(n)
        if kind == "shuffled":
            for s in range(0, n, window):
                self.rng.shuffle(order[s : s + window])
        self.arrival = order
        self.slot_of = {}
        self.waiters = {}

    def next(self, state, feed_i):
        cap, width, U, P, E = self.cap, self.width, self.U, self.P, self.E
        rng = self.rng
        u_row = np.full(U, cap, np.int32)
        u_deps = np.full((U, width), TERMINAL, np.int32)
        u_key = np.zeros(U, np.int32)
        u_src = np.zeros(U, np.int32)
        u_seq = np.zeros(U, np.int32)
        p_row = np.full(P, cap, np.int32)
        p_col = np.zeros(P, np.int32)
        p_val = np.zeros(P, np.int32)
        e_row = np.full(E, cap, np.int32)
        n = min(U, cap - self.installed)
        base = self.installed
        patches = []
        if self.kind == "random":
            n = min(int(rng.integers(1, U + 1)), n)
            for i in range(n):
                row = base + i
                u_row[i] = row
                u_key[i] = rng.integers(0, 4)
                u_src[i] = rng.integers(1, 4)
                u_seq[i] = row + 1
                for w in range(int(rng.integers(0, 3))):
                    pick = rng.random()
                    u_deps[i, w] = (
                        TERMINAL if pick < 0.2 else MISSING if pick < 0.45
                        else rng.integers(0, max(row, 1))
                    )
            if feed_i == 1 and n >= 5:
                u_deps[0, 0], u_deps[1, 0] = base + 1, base  # 2-cycle
                u_deps[2, 0], u_deps[3, 0], u_deps[4, 0] = base + 3, base + 4, base + 2
                u_key[:5] = 1
            missing = np.argwhere(state[0][: self.installed] == MISSING)
            rng.shuffle(missing)
            for r, c in missing[: int(rng.integers(0, P + 1))].tolist():
                pick = rng.integers(-1, self.installed)
                patches.append((r, c, int(pick)))
            if self.installed:
                marks = rng.choice(self.installed, min(E, self.installed), replace=False)
                k = int(rng.integers(0, len(marks) + 1))
                e_row[:k] = marks[:k]
        else:
            for i in range(n):
                c = int(self.arrival[base + i])
                slot = base + i
                self.slot_of[c] = slot
                u_row[i] = slot
                u_key[i] = self.keys[c]
                u_src[i] = 1 + c % 5
                u_seq[i] = c + 1
                d = int(self.dep[c])
                if d >= 0:
                    if d in self.slot_of:
                        u_deps[i, 0] = self.slot_of[d]
                    else:
                        u_deps[i, 0] = MISSING
                        self.waiters[d] = (slot, 0)
                if c in self.waiters:
                    w_slot, w_col = self.waiters.pop(c)
                    patches.append((w_slot, w_col, slot))
        assert len(patches) <= P
        for j, (r, c, v) in enumerate(patches):
            p_row[j], p_col[j], p_val[j] = r, c, v
        self.installed += n
        return (u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row)


_STEP_CASES = (
    # (name, kind, cap, U, P, E, feeds, interpret)
    ("random-32", "random", 32, 8, 8, 4, 5, False),
    ("random-32-interpret", "random", 32, 8, 8, 4, 3, True),
    ("random-48", "random", 48, 8, 8, 4, 6, False),
    ("chains-1024", "chains", 1024, 256, 64, 8, 4, False),
    ("shuffled-256", "shuffled", 256, 64, 64, 8, 4, False),
    ("shuffled-1024", "shuffled", 1024, 256, 256, 8, 4, False),
)


def test_keyed_plane_step_matches_jax(jax_ref, monkeypatch):
    """Bit-for-bit GraphPlaneStep (all ten fields, state included) over
    multi-feed sequences: chains, 2- and 3-cycles, MISSING cells and their
    patches, executed marks, a capacity that is not a power of two, the
    all-verified fast path, the residual finish and the residual overflow
    (full-window doubling) — every branch is counted and required."""
    branches = {"residual": 0, "overflow": 0}
    real_emit, real_full = port._residual_emit, port.resolve_functional

    def counted_emit(*args):
        branches["residual"] += 1
        return real_emit(*args)

    def counted_full(*args, **kwargs):
        branches["overflow"] += 1
        return real_full(*args, **kwargs)

    monkeypatch.setattr(port, "_residual_emit", counted_emit)
    monkeypatch.setattr(port, "resolve_functional", counted_full)
    fast = 0
    for name, kind, cap, U, P, E, n_feeds, interpret in _STEP_CASES:
        width = 4
        maker = _FeedMaker(kind, cap, width, U, P, E, seed=cap + len(name))
        state = _fresh(cap, width)
        mine = tuple(torch.tensor(a) for a in state)
        for feed_i in range(n_feeds):
            feed = maker.next(state, feed_i)
            pallas_resolve.set_pallas_kernels(interpret)
            try:
                want = ref.resolve_graph_plane_step(
                    *(jnp.array(a) for a in state),
                    *(jnp.asarray(a) for a in feed),
                    mode="keyed",
                )
                want = [np.asarray(x) for x in want]
            finally:
                pallas_resolve.set_pallas_kernels(None)
            before = dict(branches)
            got = port.resolve_graph_plane_step(
                *mine, *(torch.tensor(a) for a in feed), mode="keyed"
            )
            fast += before == branches
            _assert_equal(f"{name} feed {feed_i}", got._fields, got, want)
            state = tuple(want[:6])
            mine = tuple(got[:6])
    assert fast and branches["residual"] and branches["overflow"], (fast, branches)

    # install rows and patch cells never repeat within a dispatch (the plane
    # bump-allocates rows and pops each waiter cell once); with a repeat the
    # scatter order would be undefined, so the plain version refuses it
    cap = 8
    for u_row, p_row, p_col, what in (
        ([3, 3], [cap, cap], [0, 0], "duplicate install row"),
        ([cap, cap], [2, 2], [1, 1], "duplicate patch cell"),
    ):
        feed = [np.array(u_row, np.int32), np.full((2, 2), TERMINAL, np.int32)] + [
            np.zeros(2, np.int32)] * 3 + [
            np.array(p_row, np.int32), np.array(p_col, np.int32),
            np.zeros(2, np.int32), np.full(2, cap, np.int32)]
        with pytest.raises(AssertionError, match=what):
            K.graph_prologue(*(torch.tensor(a) for a in _fresh(cap, 2)),
                             *(torch.tensor(a) for a in feed))


# ---------------------------------------------------------------------------
# the resolvers: _doubling_core, resolve_functional, resolve_functional_keyed
# ---------------------------------------------------------------------------


def _resolver_inputs(n=4096):
    rng = np.random.default_rng(11)
    key, dep, src, seq = build_workload(n, 0.5, clients=64, seed=5)
    yield "workload", key, dep, src, seq
    # chain inversions: relabel rows within windows of 16 (links point
    # forward; the in-run order no longer verifies)
    perm = np.arange(n)
    for s in range(0, n, 16):
        rng.shuffle(perm[s : s + 16])
    inv = np.argsort(perm)
    dep_i = np.where(dep[perm] >= 0, inv[np.maximum(dep[perm], 0)], dep[perm])
    yield "inversions", key[perm], dep_i.astype(np.int32), src[perm], seq
    # adversarial: a random functional graph (rho-shapes, self-loops,
    # long cycles), with TERMINAL and MISSING sentinels
    pick = rng.random(n)
    dep_r = np.where(
        pick < 0.05, TERMINAL, np.where(pick < 0.08, MISSING, rng.integers(0, n, n))
    ).astype(np.int32)
    yield "random-graph", rng.integers(0, 8, n).astype(np.int32), dep_r, src, seq
    # adversarial: one cycle through every vertex, one shared key
    ring = ((np.arange(n) + 1) % n).astype(np.int32)
    yield "ring", np.zeros(n, np.int32), ring, src, seq


def test_resolvers_match_jax(jax_ref):
    """``_doubling_core``, ``resolve_functional`` and
    ``resolve_functional_keyed(return_structure=False)`` equal the
    reference on a 4096-command ``bench.build_workload`` batch and on
    adversarial inputs, with a residual buffer that fits and one that
    overflows."""
    overflowed = fitted = 0
    for name, key, dep, src, seq in _resolver_inputs():
        t = [torch.tensor(a) for a in (key, dep, src, seq)]
        j = [jnp.asarray(a) for a in (key, dep, src, seq)]
        _assert_equal(
            f"{name} _doubling_core",
            ("resolved", "rank", "leader", "on_cycle"),
            port._doubling_core(t[1]),
            ref._doubling_core(j[1]),
        )
        got = port.resolve_functional(*t[1:])
        _assert_equal(f"{name} resolve_functional", got._fields, got,
                      ref.resolve_functional(*j[1:]))
        for residual_size in (64, 4096):
            want = ref.resolve_functional_keyed(
                *j, residual_size=residual_size, return_structure=False
            )
            got = port.resolve_functional_keyed(*t, residual_size=residual_size)
            _assert_equal(f"{name} keyed residual {residual_size}", got._fields,
                          got, want)
            overflowed += bool(want.overflow)
            fitted += not bool(want.overflow) and int(want.n_resolved) < len(key)
    assert overflowed and fitted, (overflowed, fitted)
