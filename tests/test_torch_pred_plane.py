"""Port parity: the predecessors plane and the predecessors executor.

``fantoch_tpu_torch.executor.pred_plane.DevicePredPlane(device="cpu")``
and ``executor.pred.PredecessorsExecutor`` (on CPU tensors: the plain
version of the pred kernels) against the JAX package's, on the reference
scenarios of tests/test_pred_plane.py and tests/test_caesar.py, with the
same seeded inputs in both packages:

* multi-feed residuals over shuffled delivery; a recovered noop and a
  recovery-lifted clock; the arrays seam against the object feed;
* snapshot/restore with its one counted re-upload; compaction and growth
  around a missing-blocked row; width growth;
* the 31-bit clock overflow, the watchdog (nudge set and typed stall),
  a duplicate commit after a compaction, the device counters;
* the port continuing from the JAX plane's resident state
  (``state_from_numpy``), and an armed plane that raises on a corrupted
  cell and refuses later dispatches instead of serving from its twin;
* the ``batched_pred_executor`` oracle equivalence.

Each scenario runs in both packages and must give the same per-key
execution orders, executed sets and counters, and — where a window is
resident — the same resident state, bit for bit; the port's plane must
also agree with the port's own host twin.  Exact equality throughout.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``: tolerant duration listeners and no persistent compile
cache for the test's span.
"""

import inspect
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

import fantoch_tpu.core.timing as jtiming
import fantoch_tpu.errors as jerrors
import fantoch_tpu.executor.pred as jpred
import fantoch_tpu.executor.pred_plane as jplane
import fantoch_tpu.protocol.common.pred_clocks as jclocks
import fantoch_tpu_torch.core.timing as ttiming
import fantoch_tpu_torch.errors as terrors
import fantoch_tpu_torch.executor.pred as tpred
import fantoch_tpu_torch.executor.pred_plane as tplane
import fantoch_tpu_torch.protocol.common.pred_clocks as tclocks
from fantoch_tpu.core import Command as JCommand, Config as JConfig, Dot as JDot
from fantoch_tpu.core import KVOp as JKVOp, Rifl as JRifl
from fantoch_tpu_torch.core import Command as TCommand, Config as TConfig, Dot as TDot
from fantoch_tpu_torch.core import KVOp as TKVOp, Rifl as TRifl

torch.set_num_threads(1)

SHARD = 0

JAX = SimpleNamespace(
    name="jax", Command=JCommand, Config=JConfig, Dot=JDot, KVOp=JKVOp, Rifl=JRifl,
    pred=jpred, plane=jplane, clocks=jclocks, timing=jtiming, errors=jerrors, kw={},
)
PORT = SimpleNamespace(
    name="port", Command=TCommand, Config=TConfig, Dot=TDot, KVOp=TKVOp, Rifl=TRifl,
    pred=tpred, plane=tplane, clocks=tclocks, timing=ttiming, errors=terrors,
    kw={"device": "cpu"},
)


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
    """Tolerant duration listeners and no persistent compile cache for the
    test's span; both restored after."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        jax_cache.reset_cache()


# --- scenario plumbing: plain tuples in, each package's objects out ---


def cmd(pkg, seq, keys):
    return pkg.Command.from_keys(
        pkg.Rifl(9, seq), SHARD, {k: (pkg.KVOp.put(str(seq)),) for k in keys}
    )


def info(pkg, row):
    """``row`` = (src, seq, keys, clock_seq, clock_src, deps as (src, seq)
    pairs, rifl seq)."""
    src, seq, keys, cseq, csrc, deps, rifl = row
    return pkg.pred.PredecessorsExecutionInfo(
        pkg.Dot(src, seq), cmd(pkg, rifl, keys), pkg.clocks.Clock(cseq, csrc),
        {pkg.Dot(s, q) for s, q in deps},
    )


def noop(pkg, src, seq):
    return pkg.pred.PredecessorsNoop(pkg.Dot(src, seq))


def executor(pkg, plane=True, **cfg):
    config = pkg.Config(3, 1, device_pred_plane=plane,
                        executor_monitor_execution_order=True, **cfg)
    return pkg.pred.PredecessorsExecutor(1, SHARD, config, **pkg.kw)


def results(ex):
    """Executed rifls in order, and the per-key execution orders."""
    rifls = [(r.rifl.source, r.rifl.sequence) for r in ex.to_clients_iter()]
    monitor = ex.monitor()
    orders = {
        key: [(r.source, r.sequence) for r in monitor.get_order(key)]
        for key in sorted(monitor.keys())
    }
    return rifls, orders


def resident(ex):
    plane = ex._graph
    if plane._resident is None:
        return None
    return tuple(np.asarray(a) for a in plane._fetch_state())


def assert_same_state(jex, tex, case):
    want, got = resident(jex), resident(tex)
    assert (want is None) == (got is None), case
    if want is not None:
        for i, (w, g) in enumerate(zip(want, got)):
            assert w.dtype == g.dtype and np.array_equal(w, g), f"{case}: state array {i}"


# the fault slices of the counters: the port detects and raises
# (failures), the JAX package also fails over (failovers, rebuilds,
# degraded_ms); health is in both
PORT_ONLY = {"pred_plane_failures"}
JAX_ONLY = {"pred_plane_failovers", "pred_plane_rebuilds", "pred_plane_degraded_ms"}


def assert_same_counters(port, jax_, case):
    assert port.keys() - jax_.keys() == PORT_ONLY, case
    assert jax_.keys() - port.keys() == JAX_ONLY, case
    for key in port.keys() & jax_.keys() - {"pred_plane_kernel_ms"}:
        assert port[key] == jax_[key], (case, key, port[key], jax_[key])


def conflict_rows(rng, count=60, keys=("Ka", "Kb", "Kc")):
    per_key = {k: [] for k in keys}
    rows = []
    for i in range(count):
        src = rng.randrange(1, 4)
        ks = rng.sample(list(keys), rng.randrange(1, 3))
        deps = set()
        for k in ks:
            deps.update(per_key[k])
            per_key[k].append((src, i + 1))
        rows.append((src, i + 1, ks, i + 1, src, sorted(deps), i + 1))
    return rows


def shuffled_batches(rng, rows):
    rows = rows[:]
    rng.shuffle(rows)
    batches, at = [], 0
    while at < len(rows):
        size = rng.randrange(1, 9)
        batches.append(rows[at:at + size])
        at += size
    return batches


# --- scenarios ---


def case_multi_feed_residuals():
    rng = random.Random(5)
    for trial in range(4):
        batches = shuffled_batches(rng, conflict_rows(rng))
        out = {}
        for pkg in (JAX, PORT):
            ex_p, ex_h = executor(pkg), executor(pkg, plane=False)
            for batch in batches:
                ex_p.handle_batch([info(pkg, r) for r in batch], None)
                for r in batch:
                    ex_h.handle(info(pkg, r), None)
            got, want = results(ex_p), results(ex_h)
            assert sorted(got[0]) == sorted(want[0]) and got[1] == want[1], pkg.name
            out[pkg.name] = (got, ex_p, ex_p.device_counters())
        assert out["port"][0] == out["jax"][0], trial
        assert_same_counters(out["port"][2], out["jax"][2], trial)
        assert_same_state(out["jax"][1], out["port"][1], f"trial {trial}")


def case_noop_and_lifted_clock():
    out = {}
    for pkg in (JAX, PORT):
        exs = (executor(pkg), executor(pkg, plane=False))
        a = (1, 1, ["K"], 2, 1, [(3, 7)], 1)
        b = (1, 2, ["K"], 4, 1, [(1, 1), (3, 7), (2, 1)], 2)
        late = (2, 1, ["K"], 9, 2, [], 3)  # recovery-lifted above b
        for ex in exs:
            ex.handle_batch([info(pkg, a), info(pkg, b)], None)
            assert not list(ex.to_clients_iter())
            ex.handle_batch([info(pkg, late)], None)
            ex.handle_batch([noop(pkg, 3, 7)], None)
            assert ex.executed(None).contains(3, 7)
        got = [results(ex) for ex in exs]
        assert got[0] == got[1] and len(got[0][0]) == 3, pkg.name
        out[pkg.name] = got[0]
    assert out["port"] == out["jax"]


def case_arrays_seam():
    rng = random.Random(11)
    rows = conflict_rows(rng, count=40)
    src, seq, keys, cseq, csrc, deps, rifl = rows[10]
    rows[10] = (src, seq, keys, cseq, csrc, sorted(set(deps) | {(3, 99)}), rifl)
    out = {}
    for pkg in (JAX, PORT):
        builder = pkg.pred.PredArraysBuilder()
        infos = [info(pkg, r) for r in rows]
        for i in infos[:20]:
            builder.add_commit(i.dot, i.cmd, i.clock, i.deps)
        first = builder.take()
        builder.add_noop(pkg.Dot(3, 99))
        for i in infos[20:]:
            builder.add_commit(i.dot, i.cmd, i.clock, i.deps)
        second = builder.take()
        assert builder.take() is None
        ex_a, ex_o = executor(pkg), executor(pkg)
        ex_a.handle_batch([first], None)
        ex_a.handle_batch([second], None)
        ex_o.handle_batch(infos[:20], None)
        ex_o.handle_batch([noop(pkg, 3, 99)] + infos[20:], None)
        got = results(ex_a)
        assert got == results(ex_o), pkg.name
        out[pkg.name] = (got, ex_a)
    assert out["port"][0] == out["jax"][0]
    assert_same_state(out["jax"][1], out["port"][1], "arrays seam")


def case_snapshot_restore():
    out = {}
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        ex.handle_batch([info(pkg, (1, 1, ["K"], 2, 1, [(2, 1)], 1)),
                         info(pkg, (1, 2, ["K"], 3, 1, [(1, 1), (2, 1)], 2))], None)
        assert not list(ex.to_clients_iter())
        restored = pkg.pred.PredecessorsExecutor.restore(ex.snapshot())
        plane = restored._graph
        assert isinstance(plane, pkg.plane.DevicePredPlane)
        assert plane._resident is None
        uploads = plane.resident_uploads
        restored.handle_batch([info(pkg, (2, 1, ["K"], 1, 2, [], 3))], None)
        got = [r.rifl.sequence for r in restored.to_clients_iter()]
        assert got == [3, 1, 2], (pkg.name, got)
        assert plane.resident_uploads - uploads == 1, "restore costs ONE re-upload"
        again = pkg.pred.PredecessorsExecutor.restore(restored.snapshot())
        assert again.executed(None).contains(1, 2)
        out[pkg.name] = restored
    assert_same_state(out["jax"], out["port"], "restored")


def small_window(ex):
    plane = ex._graph
    plane._cap = 8
    for name in ("_slot_src", "_slot_seq", "_slot_start", "_slot_cseq", "_slot_csrc"):
        setattr(plane, name, getattr(plane, name)[:8].copy())
    return plane


def case_compaction_and_growth():
    out = {}
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        plane = small_window(ex)
        ex.handle_batch([info(pkg, (1, 100, ["B"], 200, 1, [(3, 1)], 100))], None)
        per = []
        states = []
        for i in range(40):
            ex.handle_batch([info(pkg, (1, i + 1, ["K"], i + 1, 1, per[-2:], i + 1))], None)
            per.append((1, i + 1))
            states.append(resident(ex))
        assert sum(1 for _ in ex.to_clients_iter()) == 40
        assert plane.stats["compactions"] >= 2 and plane.pending_count == 1
        ex.handle_batch([info(pkg, (3, 1, ["B"], 150, 3, [], 101))], None)
        got = [r.rifl.sequence for r in ex.to_clients_iter()]
        assert got == [101, 100], (pkg.name, got)
        out[pkg.name] = (states, plane.stats["compactions"], plane.grows, plane._cap)
    assert out["port"][1:] == out["jax"][1:]
    for i, (w, g) in enumerate(zip(out["jax"][0], out["port"][0])):
        assert all(np.array_equal(a, b) for a, b in zip(w, g)), f"feed {i}"


def case_width_growth():
    out = {}
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        plane = ex._graph
        start = plane._width
        deps, rows = [], []
        for i in range(start + 3):
            rows.append((1, i + 1, ["K"], i + 1, 1, list(deps), i + 1))
            deps.append((1, i + 1))
        ex.handle_batch([info(pkg, r) for r in rows[:start]], None)
        ex.handle_batch([info(pkg, r) for r in rows[start:]], None)
        assert plane._width > start
        out[pkg.name] = (results(ex), plane._width, plane.grows, ex)
    assert out["port"][:3] == out["jax"][:3]
    assert len(out["port"][0][0]) == 4 + 3
    assert_same_state(out["jax"][3], out["port"][3], "width growth")


def case_clock_overflow():
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        with pytest.raises(pkg.plane.ClockOverflowError):
            ex.handle_batch([info(pkg, (1, 1, ["K"], (1 << 31) - 1, 1, [], 1))], None)


def case_watchdog():
    for pkg in (JAX, PORT):
        Sim = pkg.timing.SimTime
        ex = executor(pkg, executor_pending_fail_ms=5000)
        ex.handle_batch([info(pkg, (2, 1, ["K"], 5, 2, [(1, 1)], 2))], Sim(0))
        assert ex.monitor_pending(Sim(2000)) == {pkg.Dot(1, 1)}
        with pytest.raises(pkg.errors.StalledExecutionError) as err:
            ex.monitor_pending(Sim(6000))
        assert pkg.Dot(1, 1) in err.value.missing[pkg.Dot(2, 1)]
        # only dots missing past the threshold are nudged
        ex = executor(pkg)
        ex.handle_batch([info(pkg, (1, 1, ["K"], 5, 1, [(3, 1)], 1))], Sim(0))
        ex.handle_batch([info(pkg, (1, 2, ["J"], 6, 1, [(3, 2)], 2))], Sim(900))
        assert ex.monitor_pending(Sim(1100)) == {pkg.Dot(3, 1)}
        assert ex.monitor_pending(Sim(2000)) == {pkg.Dot(3, 1), pkg.Dot(3, 2)}


def case_duplicate_after_compaction():
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        plane = small_window(ex)
        ex.handle_batch([info(pkg, (1, 1, ["K"], 1, 1, [], 1))], None)
        for i in range(2, 20):
            ex.handle_batch([info(pkg, (1, i, ["K"], i, 1, [], i))], None)
        assert plane.stats["compactions"] >= 1
        assert (1 << 40) | 1 not in plane._exec_recent
        with pytest.raises(AssertionError, match="exactly once"):
            ex.handle_batch([info(pkg, (1, 1, ["K"], 99, 1, [], 1))], None)


def case_device_counters():
    rows = conflict_rows(random.Random(3), count=20)
    out = {}
    for pkg in (JAX, PORT):
        ex = executor(pkg)
        ex.handle_batch([info(pkg, r) for r in rows], None)
        counters = ex.device_counters()
        assert counters["pred_plane_dispatches"] == 1
        assert counters["pred_plane_new_rows"] == 20
        assert counters["pred_plane_resident_uploads"] == 1
        assert counters["pred_plane_kernel_ms"] > 0
        assert counters["pred_plane_slot_capacity"] == ex._graph._cap
        assert executor(pkg, plane=False).device_counters() is None
        out[pkg.name] = counters
    assert_same_counters(out["port"], out["jax"], "one feed")


def case_state_carry():
    """The port continues from the JAX plane's resident window: the same
    feeds up to a point, then the port's resident state replaced by the
    JAX plane's through ``state_from_numpy``, then more feeds."""
    rng = random.Random(21)
    batches = shuffled_batches(rng, conflict_rows(rng, count=50))
    exs = {pkg.name: executor(pkg) for pkg in (JAX, PORT)}
    for i, batch in enumerate(batches):
        if i == len(batches) // 2:
            state = exs["jax"]._graph._fetch_state()
            exs["port"]._graph._resident = tplane.state_from_numpy(state, "cpu")
            assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
                tplane.state_to_numpy(exs["port"]._graph._resident), state))
        for pkg in (JAX, PORT):
            exs[pkg.name].handle_batch([info(pkg, r) for r in batch], None)
    assert results(exs["port"]) == results(exs["jax"])
    assert_same_state(exs["jax"], exs["port"], "state carry")


def case_armed_plane_raises():
    """A corrupted resident cell fails the shadow check: the port's plane
    raises before anything of the dispatch executes, marks itself failed
    and refuses later feeds and snapshots."""
    ex = executor(PORT, plane_shadow_rate=1.0)
    ex.handle_batch([info(PORT, (1, 1, ["K"], 1, 1, [], 1))], None)
    assert len(list(ex.to_clients_iter())) == 1
    plane = ex._graph
    plane._resident[1][0] += 7  # the clock column of row 0
    with pytest.raises(terrors.DeviceCorruptionError) as err:
        ex.handle_batch([info(PORT, (1, 2, ["K"], 2, 1, [(1, 1)], 2))], None)
    assert (err.value.array_index, err.value.row) == (1, 0), str(err.value)
    assert not list(ex.to_clients_iter()) and plane.health_name() == "failed"
    with pytest.raises(terrors.DeviceFailedError):
        ex.handle_batch([info(PORT, (1, 3, ["K"], 3, 1, [], 3))], None)
    with pytest.raises(terrors.DeviceFailedError):
        ex.snapshot()
    # a late dispatch: the deadline raises the same way
    ex = executor(PORT, device_dispatch_timeout_ms=1e-9)
    with pytest.raises(terrors.DeviceFailedError) as err:
        ex.handle_batch([info(PORT, (1, 1, ["K"], 1, 1, [], 1))], None)
    assert err.value.kind == "timeout" and not list(ex.to_clients_iter())


def case_batched_oracle():
    rng = random.Random(5)
    for trial in range(4):
        batches = shuffled_batches(rng, conflict_rows(rng, count=40))
        out = {}
        for pkg in (JAX, PORT):
            ex_b = executor(pkg, plane=False, batched_pred_executor=True)
            ex_s = executor(pkg, plane=False)
            for batch in batches:
                ex_b.handle_batch([info(pkg, r) for r in batch], None)
                for r in batch:
                    ex_s.handle(info(pkg, r), None)
            got, want = results(ex_b), results(ex_s)
            assert sorted(got[0]) == sorted(want[0]) and got[1] == want[1], pkg.name
            out[pkg.name] = got
        assert out["port"] == out["jax"], trial


CASES = (
    ("multi-feed residuals", case_multi_feed_residuals),
    ("noop and lifted clock", case_noop_and_lifted_clock),
    ("arrays seam", case_arrays_seam),
    ("snapshot/restore", case_snapshot_restore),
    ("compaction and growth", case_compaction_and_growth),
    ("width growth", case_width_growth),
    ("clock overflow", case_clock_overflow),
    ("watchdog", case_watchdog),
    ("duplicate after compaction", case_duplicate_after_compaction),
    ("device counters", case_device_counters),
    ("state carry", case_state_carry),
    ("armed plane", case_armed_plane_raises),
    ("batched oracle", case_batched_oracle),
)


def test_pred_plane_and_executor_match_jax(jax_ref):
    for name, case in CASES:
        try:
            case()
        except AssertionError as exc:
            raise AssertionError(f"case {name!r}: {exc}") from exc
