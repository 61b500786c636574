"""Port parity: the device graph plane in its general modes.

The port's ``BatchedDependencyGraph`` on its plane (``device="cpu"``: every
kernel stage runs its plain PyTorch version) against the JAX package's on
the same multi-key feeds — the windows that take modes ``general`` (at the
default kernel-size gate) and ``general_resident`` (above it).  Exact
equality throughout: per-key execution order, emission feed by feed, the
CHAIN_SIZE histogram, the stuck-cycle host-oracle follow-ups, the resident
state and the plane counters.

Two collected items on purpose (scenarios loop inside a test and the
assert names the scenario); reference calls run under ``jax_ref`` (see
test_torch_graph_resolve.py and ROADMAP.md Queue C).
"""

import inspect
import pickle
import random

import numpy as np
import pytest
import torch

from jax._src import monitoring as jax_monitoring

import fantoch_tpu.core as jcore
import fantoch_tpu.protocol.common.graph_deps as jdeps
from fantoch_tpu.executor.base import ExecutorMetricsKind as JKind
from fantoch_tpu.executor.graph import batched as jbatched
from fantoch_tpu.executor.graph import graph_plane as jplane
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol.common.graph_deps as tdeps
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind as TKind
from fantoch_tpu_torch.executor.graph import batched as tbatched
from fantoch_tpu_torch.executor.graph import graph_plane as tplane
from fantoch_tpu_torch.executor.graph.graph_plane import state_to_numpy

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
    keyword arguments they do not take (a listener registered by
    ``subscribe_recompiles`` takes none, and jax 0.9 passes
    ``fun_name=``).  Restored after the test."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )


@pytest.fixture
def traced(monkeypatch):
    """Per package: the mode of every plane dispatch (primary and stuck
    follow-up; the port's twin replays are not dispatches) and the slots
    each stuck-cycle host-oracle follow-up closed."""
    log = {}
    for name, mod in (("jax", jplane), ("port", tplane)):
        entry = log[name] = {"modes": [], "oracle": []}
        real_dispatch = mod.DeviceGraphPlane._dispatch_raw
        real_oracle = mod.DeviceGraphPlane._stuck_oracle

        def dispatch(self, *args, _real=real_dispatch, _entry=entry, **kwargs):
            _entry["modes"].append(self._mode())
            return _real(self, *args, **kwargs)

        def oracle(self, slots, time, _real=real_oracle, _entry=entry):
            _entry["oracle"].append(np.asarray(slots).tolist())
            return _real(self, slots, time)

        monkeypatch.setattr(mod.DeviceGraphPlane, "_dispatch_raw", dispatch)
        monkeypatch.setattr(mod.DeviceGraphPlane, "_stuck_oracle", oracle)
    # the port's shadow twin: the modes it replayed
    real_replay = tplane.DeviceGraphPlane._twin_replay
    replayed = log["replayed"] = []

    def replay(self, state, entry):
        replayed.append(entry[0])
        return real_replay(self, state, entry)

    monkeypatch.setattr(tplane.DeviceGraphPlane, "_twin_replay", replay)
    return log


class _Side:
    """One package's plane-backed graph, fed (dot, keys, dep dots) tuples."""

    def __init__(self, pkg, batched, deps_mod, kind, **kwargs):
        self.pkg, self.deps_mod, self.kind = pkg, deps_mod, kind
        self.config = pkg.Config(
            3, 1, batched_graph_executor=True, device_graph_plane=True,
            graph_kernel_threshold=kwargs.pop("threshold", None),
            **kwargs.pop("knobs", {}),
        )
        self.graph = batched.BatchedDependencyGraph(1, SHARD, self.config, **kwargs)
        self.time = pkg.RunTime()
        self.order = {}

    def feed(self, rows):
        pkg = self.pkg
        adds = []
        for (src, seq), keys, dep_dots in rows:
            cmd = pkg.Command.from_keys(
                pkg.Rifl(src, seq), SHARD, {k: (pkg.KVOp.put(""),) for k in keys}
            )
            deps = [
                self.deps_mod.Dependency(pkg.Dot(*d), frozenset({SHARD}))
                for d in sorted(dep_dots)
            ]
            adds.append((pkg.Dot(src, seq), cmd, deps))
        self.graph.handle_add_batch(adds, self.time)
        emitted = []
        for cmd in self.graph.commands_to_execute():
            rifl = (cmd.rifl.source, cmd.rifl.sequence)
            emitted.append(rifl)
            for key in sorted(cmd.keys(SHARD)):
                self.order.setdefault(key, []).append(rifl)
        return emitted

    def chain_sizes(self):
        hist = self.graph.metrics().get_collected(self.kind.CHAIN_SIZE)
        return list(hist.values()) if hist is not None else []


def _pair(**kwargs):
    """The JAX graph and the port's; the port's plane is armed with a
    shadow check on every dispatch, so its host twin replays each general
    step (stuck follow-ups included) and must agree bit for bit."""
    ref = _Side(jcore, jbatched, jdeps, JKind, **kwargs)
    mine = _Side(tcore, tbatched, tdeps, TKind, device="cpu",
                 knobs={"plane_shadow_rate": 1.0}, **kwargs)
    return ref, mine


def _random_adds(rng, n_proc, events):
    """The JAX package's ``random_adds`` (tests/test_graph_plane.py:81) over
    plain (source, sequence) dots: two keys per command, non-transitive
    conflicts, 2-cycles and directed 3+-cycles with no mutual edge."""
    dots = [(p, s) for p in range(1, n_proc + 1) for s in range(1, events + 1)]
    keys = {dot: set(rng.sample(["A", "B", "C", "D"], 2)) for dot in dots}
    deps = {dot: set() for dot in dots}
    for i, left in enumerate(dots):
        for right in dots[i + 1 :]:
            if not keys[left] & keys[right]:
                continue
            if left[0] == right[0]:
                deps[max(left, right)].add(min(left, right))
            else:
                choice = rng.randrange(3)
                if choice in (0, 2):
                    deps[left].add(right)
                if choice in (1, 2):
                    deps[right].add(left)
    return [(dot, sorted(keys[dot]), deps[dot]) for dot in dots]


def _chop(rng, args):
    """Shuffle and split into feeds of 1..5 (deps routinely arrive after
    their dependents: MISSING cells, patched by later feeds)."""
    shuffled = args[:]
    rng.shuffle(shuffled)
    feeds, at = [], 0
    while at < len(shuffled):
        size = rng.randrange(1, 6)
        feeds.append(shuffled[at : at + size])
        at += size
    return feeds


def _compare_planes(case, ref, mine):
    rp, mp = ref.graph._plane, mine.graph._plane
    if rp._resident is not None:
        for i, (a, b) in enumerate(zip(state_to_numpy(mp._resident), rp._fetch_state())):
            assert np.array_equal(a, b), f"{case}: resident state array {i} differs"
    for name in ("dispatches", "resident_uploads", "grows", "pending_count"):
        assert getattr(mp, name) == getattr(rp, name), f"{case}: {name} differs"
    for name, value in rp.stats.items():
        if name != "kernel_ms":
            assert mp.stats[name] == value, f"{case}: stats[{name}] differs"


def test_general_plane_matches_jax(jax_ref, traced):
    """Shuffled multi-key feeds (``random_adds`` + ``chop``, three trials
    each) at the default kernel-size gate (mode ``general``) and at
    ``graph_kernel_threshold=64`` (mode ``general_resident``): the same
    emission feed by feed, per-key order, CHAIN_SIZE histogram, stuck-cycle
    follow-ups, resident state and counters as the JAX plane."""
    for threshold, mode in ((None, "general"), (64, "general_resident")):
        rng = random.Random(5)
        for trial in range(3):
            case = f"{mode} trial {trial}"
            ref, mine = _pair(threshold=threshold)
            for i, feed in enumerate(_chop(rng, _random_adds(rng, 3, 4))):
                assert mine.feed(feed) == ref.feed(feed), f"{case} feed {i}: emission"
                _compare_planes(f"{case} feed {i}", ref, mine)
            assert mine.order == ref.order, f"{case}: per-key order differs"
            assert len(sum(mine.order.values(), [])) == 2 * 12, f"{case}: not all executed"
            assert mine.chain_sizes() == ref.chain_sizes(), f"{case}: CHAIN_SIZE differs"
            assert mine.graph._plane.health_name() == "healthy"
        assert traced["port"] == traced["jax"], f"{mode}: dispatch modes or oracle runs differ"
        assert mode in traced["port"]["modes"], traced["port"]["modes"]
        assert traced["port"]["oracle"], f"{mode}: no stuck-cycle follow-up ran"
        # the shadow twin replayed dispatches of this mode and agreed
        assert mode in traced["replayed"], traced["replayed"]
        _clear(traced)


def _clear(traced):
    for name in ("jax", "port"):
        traced[name]["modes"].clear()
        traced[name]["oracle"].clear()
    traced["replayed"].clear()


def _shrink(plane, cap):
    """Shrink a fresh plane's window so compaction runs at test size."""
    assert plane._next_slot == 0 and plane._resident is None
    plane._cap = cap
    for name in ("_slot_src", "_slot_seq", "_slot_tms", "_slot_key",
                 "_slot_general", "_exec_host"):
        setattr(plane, name, getattr(plane, name)[:cap].copy())
    plane._slot_deps = plane._slot_deps[:cap].copy()


def test_general_plane_compaction_width_restore(jax_ref, traced):
    """Blocked multi-key rows stay resident through repeated compactions,
    a width growth (a row waiting on more pending deps than the window is
    wide) and a snapshot/restore — one counted re-upload at the first
    dispatch after restore — and execute when their missing dep commits,
    in the JAX plane's order, in both general modes."""
    for threshold, mode in ((None, "general"), (8, "general_resident")):
        ref, mine = _pair(threshold=threshold)
        for side in (ref, mine):
            _shrink(side.graph._plane, 16)
        ghost = (3, 1)
        blocked = [((2, s), ["B", f"x{s}"], {ghost}) for s in range(1, 6)]
        feeds = [blocked[:3]]
        last = None
        for i in range(1, 41):
            dot = (1, i)
            deps = {last} if last else set()
            if i == 7:
                deps |= {d for d, _k, _x in blocked[:3]}  # wait on blocked rows
            feeds.append([(dot, ["K", f"y{i % 3}"], deps)])
            last = dot if i != 7 else None
        # five pending deps: wider than the 4-slot window
        feeds.append(blocked[3:] + [((4, 1), ["B", "K"], {d for d, _k, _x in blocked})])
        for i, feed in enumerate(feeds):
            assert mine.feed(feed) == ref.feed(feed), f"{mode} feed {i}: emission"
            _compare_planes(f"{mode} feed {i}", ref, mine)
        plane = mine.graph._plane
        assert plane.stats["compactions"] >= 2 and plane.grows >= 1
        assert plane._width == 8 and plane.pending_count == 7, plane.pending_count
        assert mode in traced["port"]["modes"], traced["port"]["modes"]

        ref.graph = pickle.loads(pickle.dumps(ref.graph))
        mine.graph = pickle.loads(pickle.dumps(mine.graph))
        plane = mine.graph._plane
        uploads = plane.resident_uploads
        wake = [(ghost, ["B"], set())]
        assert mine.feed(wake) == ref.feed(wake), f"{mode}: wake emission"
        _compare_planes(f"{mode} wake", ref, mine)
        assert plane.resident_uploads - uploads == 1, "restore costs one re-upload"
        assert plane.pending_count == 0 and mine.order == ref.order
        assert traced["port"] == traced["jax"], f"{mode}: dispatch modes differ"
        _clear(traced)
