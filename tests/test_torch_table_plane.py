"""Port parity: the votes-table plane and the table executor.

``fantoch_tpu_torch.executor.table_plane.DeviceTablePlane`` and
``executor.table.TableExecutor`` (on CPU tensors: the plain versions of
the table kernels) against the JAX package's, on the same seeded inputs:

* the four executor feeds — ``handle``, ``handle_batch``,
  ``handle_batch_arrays`` and the device plane — in both packages, with
  and without ``execute_at_commit``, on randomized rounds with detached
  votes and gapped ranges: the same per-key executions and KVStore state,
  all eight equal;
* the plane alone on random vote batches: resident frontiers, stable
  clocks and buffered residuals equal to the reference plane's after every
  batch, and the frontiers never ahead of the ``RangeEventSet`` oracle;
* the residual gap fill, bucket growth, the 31-bit overflow rejection, the
  real-time-clock config rejection, the kernel-threshold knob;
* the resident state carried across packages (``state_from_numpy``), a
  pickle round trip with its one counted re-upload, and an armed plane
  that raises on a corrupted cell instead of serving from its twin.

Exact equality throughout.  One collected item on purpose (ROADMAP.md
Queue C); reference calls run under ``jax_ref``: tolerant duration
listeners and no persistent compile cache for the test's span.
"""

import inspect
import pickle
import random

import numpy as np
import pytest
import torch

import jax
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

import fantoch_tpu.core as jcore
import fantoch_tpu.executor.table as jtable
import fantoch_tpu.protocol.common.table_clocks as jclocks
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.executor.table as ttable
import fantoch_tpu_torch.protocol.common.table_clocks as tclocks
from fantoch_tpu.core.clocks import RangeEventSet
from fantoch_tpu.executor.table_plane import DeviceTablePlane as JPlane
from fantoch_tpu_torch.errors import DeviceCorruptionError, DeviceFailedError
from fantoch_tpu_torch.executor.table_plane import (
    ClockOverflowError,
    DeviceTablePlane as TPlane,
    state_from_numpy,
    state_to_numpy,
)

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


# ---------------------------------------------------------------------------
# the four executor feeds
# ---------------------------------------------------------------------------


def random_rounds(rng, n, n_rounds=10):
    """Rounds of protocol-consistent infos as plain tuples: ("row", seq,
    key, clock, votes) or ("detached", key, votes), votes (by, start, end);
    per-key consecutive clocks, the coordinator voting its consumed range,
    peers voting full, partial, gapped or no prefixes, occasional detached
    votes, and a final all-votes flush."""
    key_clock = {}
    seq = 1
    rounds = []
    for _ in range(n_rounds):
        infos = []
        for _ in range(rng.randrange(1, 12)):
            key = f"k{rng.randrange(4)}"
            c = key_clock.get(key, 0) + 1
            key_clock[key] = c
            votes = [(1, c, c)]
            for p in range(2, n + 1):
                kind = rng.randrange(4)
                if kind == 0:
                    votes.append((p, 1, c))
                elif kind == 1 and c > 2:
                    votes.append((p, 2, c))  # gap below: residual
                elif kind == 2 and c > 1:
                    votes.append((p, 1, c - 1))
            infos.append(("row", seq, key, c, votes))
            seq += 1
        if rng.randrange(3) == 0:
            key = rng.choice(sorted(key_clock))
            infos.append(("detached", key, [(p, 1, key_clock[key]) for p in range(2, n + 1)]))
        rounds.append(infos)
    rounds.append([
        ("detached", k, [(p, 1, c) for p in range(1, n + 1)])
        for k, c in sorted(key_clock.items())
    ])
    return rounds


def to_infos(pkg_core, pkg_table, pkg_clocks, infos):
    out = []
    for info in infos:
        if info[0] == "row":
            _, seq, key, clock, votes = info
            out.append(pkg_table.TableVotes(
                pkg_core.Dot(1, seq), clock, pkg_core.Rifl(1, seq), key,
                (pkg_core.KVOp.put(f"v{seq}"),),
                [pkg_clocks.VoteRange(*v) for v in votes],
            ))
        else:
            _, key, votes = info
            out.append(pkg_table.TableDetachedVotes(
                key, [pkg_clocks.VoteRange(*v) for v in votes]))
    return out


def to_arrays(pkg_table, infos):
    builder = pkg_table.TableVotesArraysBuilder()
    for info in infos:
        if isinstance(info, pkg_table.TableVotes):
            builder.add_row(info.dot, info.clock, info.rifl, info.key, info.ops,
                            info.votes)
        else:
            builder.add_detached(info.key, info.votes)
    return builder.take()


def drain(ex):
    out = {}
    while (r := ex.to_clients()) is not None:
        out.setdefault(r.key, []).append(
            ((r.rifl.source, r.rifl.sequence), [repr(x) for x in r.op_results])
        )
    return out


def run_feed(pkg, feed, rounds, n, execute_at_commit):
    pkg_core, pkg_table, pkg_clocks = pkg
    config = pkg_core.Config(
        n, 1, batched_table_executor=feed != "handle",
        device_table_plane=feed == "plane", execute_at_commit=execute_at_commit,
    )
    kwargs = {"device": "cpu"} if pkg_table is ttable else {}
    ex = pkg_table.TableExecutor(1, SHARD, config, **kwargs)
    time = pkg_core.RunTime()
    per_key = {}
    for plain in rounds:
        infos = to_infos(pkg_core, pkg_table, pkg_clocks, plain)
        if feed == "handle":
            for info in infos:
                ex.handle(info, time)
        elif feed == "batch":
            ex.handle_batch(infos, time)
        else:
            batch = to_arrays(pkg_table, infos)
            if batch is not None:
                ex.handle_batch_arrays(batch, time)
        for key, rows in drain(ex).items():
            per_key.setdefault(key, []).extend(rows)
    store = {k: repr(v) for k, v in ex._store._store.items()}
    return per_key, store, ex


def case_four_feeds():
    n = 3
    jpkg, tpkg = (jcore, jtable, jclocks), (tcore, ttable, tclocks)
    for execute_at_commit in (False, True):
        rounds = random_rounds(random.Random(11), n)
        want = run_feed(jpkg, "handle", rounds, n, execute_at_commit)[:2]
        for pkg_name, pkg in (("jax", jpkg), ("port", tpkg)):
            for feed in ("handle", "batch", "arrays", "plane"):
                got = run_feed(pkg, feed, rounds, n, execute_at_commit)
                assert got[:2] == want, (
                    f"{pkg_name} feed {feed} (execute_at_commit={execute_at_commit}) "
                    "differs from the reference's per-info feed")
                if pkg is tpkg and feed == "plane" and not execute_at_commit:
                    counters = got[2].device_counters()
                    assert counters["table_plane_dispatches"] > 0, counters
                    assert got[2].device_planes() == (got[2]._plane,)


# ---------------------------------------------------------------------------
# the plane alone
# ---------------------------------------------------------------------------


def oracle_frontiers(n_keys, n, applied):
    sets = [[RangeEventSet() for _ in range(n)] for _ in range(n_keys)]
    for k, by, s, e in applied:
        sets[k][by].add_range(s, e)
    return np.array([[sets[k][p].frontier for p in range(n)] for k in range(n_keys)])


def cols(*columns):
    return tuple(np.asarray(c, dtype=np.int64) for c in columns)


def case_plane_random_batches():
    rng = random.Random(5)
    n, n_keys = 3, 8
    tplane = TPlane(n, stability_threshold=2, key_buckets=8, device="cpu")
    jplane = JPlane(n, stability_threshold=2, key_buckets=8)
    for k in range(n_keys):
        assert tplane.bucket(f"k{k}") == jplane.bucket(f"k{k}")
    applied = []
    for batch in range(12):
        rows = []
        for _ in range(rng.randrange(1, 12)):
            k, by, s = rng.randrange(n_keys), rng.randrange(1, n + 1), rng.randrange(1, 25)
            rows.append((k, by, s, s + rng.randrange(6)))
            applied.append((k, by - 1, s, rows[-1][3]))
        batch_cols = cols(*zip(*rows))
        got = tplane.commit_votes(*batch_cols)
        want = jplane.commit_votes(*batch_cols)
        assert got.dtype == want.dtype and np.array_equal(got, want), f"batch {batch} stable"
        assert np.array_equal(tplane.frontiers(), jplane.frontiers()), f"batch {batch}"
        assert tplane.residual_count == jplane.residual_count, f"batch {batch} residuals"
        for a, b in zip(tplane._residuals, jplane._residuals):
            assert np.array_equal(a, b), f"batch {batch} residual columns"
        assert (tplane.frontiers() <= oracle_frontiers(n_keys, n, applied)).all(), (
            f"batch {batch}: the frontier overtook the RangeEventSets")
    assert tplane.stats["residual_runs"] > 0, "no batch left a residual run"
    empty = cols([], [], [], [])
    for spin in range(4):
        assert np.array_equal(tplane.commit_votes(*empty), jplane.commit_votes(*empty))
    assert np.array_equal(tplane.frontiers(), oracle_frontiers(n_keys, n, applied))
    assert tplane.dispatches == jplane.dispatches


def case_residual_gap_fill():
    for plane in (TPlane(3, 2, key_buckets=4, device="cpu"), JPlane(3, 2, key_buckets=4)):
        b = plane.bucket("x")
        plane.commit_votes(*cols([b], [1], [5], [9]))  # beyond the gap [1, 4]
        assert plane.residual_count == 1
        assert plane.frontiers()[0].tolist() == [0, 0, 0]
        plane.commit_votes(*cols([b], [1], [1], [4]))  # fills it
        assert plane.residual_count == 0
        assert plane.frontiers()[0].tolist() == [9, 0, 0]


def case_bucket_growth_and_overflow():
    plane = TPlane(3, 2, key_buckets=2, device="cpu")
    a = plane.bucket("a")
    plane.commit_votes(*cols([a], [1], [1], [4]))
    for i in range(10):
        plane.bucket(f"grow{i}")
    assert plane.grows >= 2 and plane._cap >= 11
    assert plane.frontiers()[a].tolist() == [4, 0, 0]
    assert plane.resident_uploads == 1 + plane.grows
    with pytest.raises(ClockOverflowError):
        plane.commit_votes(*cols([a], [1], [1], [1 << 31]))
    for pkg_core in (jcore, tcore):
        with pytest.raises(ValueError, match="device_table_plane"):
            pkg_core.Config(3, 1, device_table_plane=True, newt_clock_bump_interval_ms=10)


def case_kernel_threshold(monkeypatch):
    for pkg_core, pkg_table, kw in ((jcore, jtable, {}), (tcore, ttable, {"device": "cpu"})):
        base = pkg_core.Config(3, 1)
        explicit = pkg_core.Config(3, 1, table_kernel_threshold=123)
        assert pkg_table.TableExecutor(1, SHARD, base, **kw)._kernel_threshold == 1 << 20
        assert pkg_table.TableExecutor(1, SHARD, explicit, **kw)._kernel_threshold == 123
        with monkeypatch.context() as m:
            m.setenv("FANTOCH_TABLE_KERNEL_THRESHOLD", "77")
            assert pkg_table.TableExecutor(1, SHARD, base, **kw)._kernel_threshold == 77
            assert pkg_table.TableExecutor(1, SHARD, explicit, **kw)._kernel_threshold == 123
    frontiers = np.random.default_rng(3).integers(0, 1 << 20, size=(64, 5))
    want = np.sort(frontiers, axis=1)[:, 5 - 3]
    for threshold in (1, 1 << 60):
        config = tcore.Config(5, 1, table_kernel_threshold=threshold)
        got = ttable.TableExecutor(1, SHARD, config, device="cpu")._stable_clocks(frontiers)
        assert got.dtype == np.int64 and np.array_equal(got, want), threshold


def case_state_carry_and_pickle():
    """The port continues from the JAX plane's resident state; a pickled
    plane re-materializes with exactly one more counted upload."""
    rng = np.random.default_rng(8)
    jplane = JPlane(3, 2, key_buckets=8)
    tplane = TPlane(3, 2, key_buckets=8, device="cpu")
    for k in range(6):
        jplane.bucket(f"k{k}")
        tplane.bucket(f"k{k}")
    first = cols(rng.integers(0, 6, 20), rng.integers(1, 4, 20),
                 np.ones(20), rng.integers(1, 9, 20))
    jplane.commit_votes(*first)
    tplane._resident = state_from_numpy(jplane._fetch_state(), "cpu")
    tplane._residuals = tuple(np.array(c) for c in jplane._residuals)
    nxt = cols(rng.integers(0, 6, 20), rng.integers(1, 4, 20),
               rng.integers(1, 12, 20), rng.integers(12, 15, 20))
    assert np.array_equal(tplane.commit_votes(*nxt), jplane.commit_votes(*nxt))
    assert np.array_equal(state_to_numpy(tplane._resident)[0], jplane._fetch_state()[0])
    uploads = tplane.resident_uploads
    restored = pickle.loads(pickle.dumps(tplane))
    assert restored._resident is None
    assert np.array_equal(restored.frontiers(), jplane.frontiers())
    restored.commit_votes(*nxt)
    assert restored.resident_uploads == uploads + 1


def case_armed_plane_raises():
    """A corrupted resident cell fails the shadow check: the plane raises
    before the batch is used, marks itself failed and refuses later
    dispatches — it never serves from its twin."""
    config = tcore.Config(3, 1, plane_shadow_rate=1.0, batched_table_executor=True,
                          device_table_plane=True)
    plane = TPlane(3, 2, key_buckets=4, device="cpu")
    plane.configure_faults(config, seed=7, process_id=1)
    b = plane.bucket("x")
    plane.commit_votes(*cols([b], [1], [1], [3]))
    plane._resident[0][b, 1] += 5
    with pytest.raises(DeviceCorruptionError):
        plane.commit_votes(*cols([b], [2], [1], [3]))
    with pytest.raises(DeviceFailedError):
        plane.commit_votes(*cols([b], [3], [1], [3]))
    assert plane.health_name() == "failed"


CASES = (
    ("four executor feeds", case_four_feeds),
    ("plane, random batches", case_plane_random_batches),
    ("residual gap fill", case_residual_gap_fill),
    ("bucket growth and overflow", case_bucket_growth_and_overflow),
    ("kernel threshold", case_kernel_threshold),
    ("state carry and pickle", case_state_carry_and_pickle),
    ("armed plane", case_armed_plane_raises),
)


def test_table_plane_and_executor_match_jax(jax_ref, monkeypatch):
    for name, case in CASES:
        try:
            if name == "kernel threshold":
                case(monkeypatch)
            else:
                case()
        except AssertionError as exc:
            raise AssertionError(f"case {name!r}: {exc}") from exc
