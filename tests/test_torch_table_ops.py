"""Port parity: every function of ``ops/table_ops.py``.

The same numpy-seeded inputs go through the JAX reference
(``fantoch_tpu.ops.table_ops``, on the CPU its composed XLA route) and the
port (``fantoch_tpu_torch.ops.table_ops``, on CPU tensors the plain
PyTorch version of every kernel).  Tolerance: exact equality of values and
dtypes; the work is integers.  Each case is also held against a host
oracle — ``SequentialKeyClocks`` for proposals and bumps, ``VotesTable``
for stable clocks, a per-(key, process) interval merge in numpy for the
commit, numpy for the dense round.

One collected item on purpose: the cases loop inside the test and the
assert names the case, so this file sorts after every seed file in the
``--dist loadfile`` queue (ROADMAP.md Queue C).  Reference calls run under
``jax_ref``: jax's duration listeners wrapped to drop keywords they do not
take, and the persistent compile cache off, so these calls neither read
nor write the cache entries of the JAX package's own table tests.
"""

import inspect
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

from fantoch_tpu.core.command import Command
from fantoch_tpu.core.ids import Rifl
from fantoch_tpu.core.kvs import KVOp
from fantoch_tpu.executor.table import VotesTable
from fantoch_tpu.ops import table_ops as ref
from fantoch_tpu.protocol.common.table_clocks import SequentialKeyClocks, VoteRange
from fantoch_tpu_torch.ops import table_ops as port

torch.set_num_threads(1)

SHARD = 0
INT32_MAX = (1 << 31) - 1


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


def same(got, want, what):
    """Exact equality of a port tensor and a reference array, dtype too."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert np.array_equal(got, want), f"{what}: {got.tolist()} != {want.tolist()}"


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.int32))


def j32(a):
    # a copy, never an alias: several reference programs donate their table
    return jnp.array(np.asarray(a, dtype=np.int32))


# ---------------------------------------------------------------------------
# host oracles
# ---------------------------------------------------------------------------


def oracle_proposals(prior, keys, mins):
    """SequentialKeyClocks over the same prior: (clock, vote_start,
    new_prior) for a batch of single-key commands."""
    clocks = SequentialKeyClocks(1, SHARD)
    clocks._clocks = {str(k): int(v) for k, v in enumerate(prior)}
    out_clock, out_start = [], []
    for seq, (k, m) in enumerate(zip(keys, mins), start=1):
        cmd = Command.from_single(Rifl(9, seq), SHARD, str(k), KVOp.put("x"))
        clock, votes = clocks.proposal(cmd, int(m))
        (vote,) = votes.get(str(k))
        out_clock.append(clock)
        out_start.append(vote.start)
    return out_clock, out_start, [clocks._clocks[str(k)] for k in range(len(prior))]


def oracle_commit(frontier, vkey, vby, vstart, vend, valid, threshold):
    """The commit by per-(key, process) interval merge: the new frontier,
    the residual runs as (key, by, start, end) tuples, the stable clocks."""
    frontier = np.array(frontier, dtype=np.int64)
    n = frontier.shape[1]
    groups = {}
    for k, b, s, e, v in zip(vkey, vby, vstart, vend, valid):
        if v:
            groups.setdefault((int(k), int(b)), []).append((int(s), int(e)))
    residual = set()
    extend = {}
    for (k, b), ranges in groups.items():
        ranges.sort()
        runs = [list(ranges[0])]
        for s, e in ranges[1:]:
            if s <= runs[-1][1] + 1:
                runs[-1][1] = max(runs[-1][1], e)
            else:
                runs.append([s, e])
        f0 = frontier[k, b]
        for s, e in runs:
            if e > f0 and s <= f0 + 1:
                extend[(k, b)] = e
            elif e > f0:
                residual.add((k, b, s, e))
    for (k, b), e in extend.items():
        frontier[k, b] = max(frontier[k, b], e)
    stable = np.sort(frontier, axis=1)[:, n - threshold]
    return frontier, residual, stable


def residual_runs(out):
    _f, _s, rk, rb, rs, re, res = (np.asarray(a) for a in out)
    return {
        (int(k), int(b), int(s), int(e))
        for k, b, s, e in zip(rk[res], rb[res], rs[res], re[res])
    }


def votes_table_stable(frontiers, threshold):
    n = frontiers.shape[1]
    out = []
    for key, row in enumerate(frontiers):
        table = VotesTable(str(key), 1, SHARD, n, threshold)
        for pid, frontier in enumerate(row, start=1):
            if frontier > 0:
                table.add_votes([VoteRange(pid, 1, int(frontier))])
        out.append(table.stable_clock())
    return out


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def case_next_pow2():
    for n in (0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 4097):
        assert port.next_pow2(n) == ref.next_pow2(n), n


def case_segmented_running_max():
    rng = np.random.default_rng(1)
    for size in (1, 2, 7, 64, 300):
        seg = np.sort(rng.integers(0, 6, size)).astype(np.int32)
        val = rng.integers(-50, 50, size).astype(np.int32)
        same(port.segmented_running_max(t32(seg), t32(val)),
             ref.segmented_running_max(j32(seg), j32(val)), f"size {size}")


def case_proposal_random():
    rng = random.Random(7)
    for trial in range(20):
        n_keys, batch = 5, 40
        prior = [rng.randrange(0, 10) for _ in range(n_keys)]
        keys = [rng.randrange(n_keys) for _ in range(batch)]
        mins = [rng.choice([0, 0, 0, rng.randrange(30)]) for _ in range(batch)]
        got = port.batched_clock_proposal(t32(prior), t32(keys), t32(mins))
        want = ref.batched_clock_proposal(j32(prior), j32(keys), j32(mins))
        for g, w, what in zip(got, want, ("clock", "vote_start", "new_prior")):
            same(g, w, f"trial {trial} {what}")
        oracle = oracle_proposals(prior, keys, mins)
        for g, o, what in zip(got, oracle, ("clock", "vote_start", "new_prior")):
            assert g.tolist() == o, f"trial {trial} {what} vs SequentialKeyClocks"


def case_proposal_hot_key_chain():
    batch = 64
    got = port.batched_clock_proposal(
        t32(np.zeros(4)), t32(np.full(batch, 2)), t32(np.zeros(batch))
    )
    want = ref.batched_clock_proposal(
        j32(np.zeros(4)), j32(np.full(batch, 2)), j32(np.zeros(batch))
    )
    for g, w in zip(got, want):
        same(g, w, "hot key")
    assert got[0].tolist() == list(range(1, batch + 1))
    assert got[1].tolist() == list(range(1, batch + 1))
    assert got[2].tolist() == [0, 0, batch, 0]


def case_proposal_near_window_edge():
    """Clocks just below 2^31 - 1 equal the unbounded oracle; past the edge
    both packages wrap as int32 does (XLA's arithmetic), and agree."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 8, 200).astype(np.int32)
    mins = np.where(rng.random(200) < 0.2, INT32_MAX - 500, 0).astype(np.int32)
    prior = (INT32_MAX - 1000 + rng.integers(0, 300, 8)).astype(np.int32)
    got = port.batched_clock_proposal(t32(prior), t32(keys), t32(mins))
    want = ref.batched_clock_proposal(j32(prior), j32(keys), j32(mins))
    for g, w in zip(got, want):
        same(g, w, "below the edge")
    assert got[0].tolist() == oracle_proposals(prior, keys, mins)[0]
    prior = np.full(4, INT32_MAX - 2, dtype=np.int32)
    keys = np.array([1, 1, 1, 1, 2], dtype=np.int32)
    got = port.batched_clock_proposal(t32(prior), t32(keys), t32(np.zeros(5)))
    want = ref.batched_clock_proposal(j32(prior), j32(keys), j32(np.zeros(5)))
    for g, w in zip(got, want):
        same(g, w, "across the edge (int32 wrap)")


def case_resident_proposals_and_bumps():
    """Proposals on the resident table (updated in place) interleaved with
    bumps; the pad bucket K-1 takes the pad rows, as BatchedKeyClocks
    pads them."""
    rng = np.random.default_rng(5)
    kcap = 16
    host = SequentialKeyClocks(1, SHARD)
    table_p = t32(np.zeros(kcap))
    table_j = j32(np.zeros(kcap))
    for step in range(8):
        if step % 3 == 2:
            m = int(rng.integers(1, 6))
            idx = rng.integers(0, kcap - 1, m).astype(np.int32)
            val = rng.integers(1, 80, m).astype(np.int32)
            pad_idx = np.concatenate([idx, np.full(8 - m, kcap - 1)]).astype(np.int32)
            pad_val = np.concatenate([val, np.zeros(8 - m)]).astype(np.int32)
            out = port.resident_clock_bump(table_p, t32(pad_idx), t32(pad_val))
            assert out is table_p, "the bump is in place"
            table_j = ref.resident_clock_bump(table_j, j32(pad_idx), j32(pad_val))
            for i, v in zip(idx.tolist(), val.tolist()):
                host._clocks[str(i)] = max(host._clocks.get(str(i), 0), v)
        else:
            batch = int(rng.integers(1, 30))
            keys = np.where(rng.random(batch) < 0.5, 3, rng.integers(0, kcap - 1, batch))
            mins = np.where(rng.random(batch) < 0.2, rng.integers(0, 90, batch), 0)
            pk = np.concatenate([keys, np.full(32 - batch, kcap - 1)]).astype(np.int32)
            pm = np.concatenate([mins, np.zeros(32 - batch)]).astype(np.int32)
            clock, start, new_prior = port.resident_clock_proposal(table_p, t32(pk), t32(pm))
            assert new_prior is table_p, "the proposal is in place"
            wclock, wstart, table_j = ref.resident_clock_proposal(table_j, j32(pk), j32(pm))
            same(clock, wclock, f"step {step} clock")
            same(start, wstart, f"step {step} vote_start")
            for i, (k, m) in enumerate(zip(keys.tolist(), mins.tolist())):
                cmd = Command.from_single(Rifl(9, 100 * step + i + 1), SHARD, str(k),
                                          KVOp.put("x"))
                c, votes = host.proposal(cmd, m)
                assert (clock[i].item(), start[i].item()) == (c, votes.get(str(k))[0].start), (
                    f"step {step} row {i} vs SequentialKeyClocks")
        same(table_p, table_j, f"step {step} table")
        real = table_p[: kcap - 1].tolist()
        assert real == [host._clocks.get(str(k), 0) for k in range(kcap - 1)], (
            f"step {step}: real buckets vs SequentialKeyClocks (pad bucket leaked?)")


def case_stable_clocks():
    rng = random.Random(11)
    for n, threshold in ((3, 2), (5, 3), (5, 4), (7, 4)):
        frontiers = np.array(
            [[rng.randrange(0, 20) for _ in range(n)] for _ in range(8)], dtype=np.int32
        )
        got = port.stable_clocks(t32(frontiers), threshold=threshold)
        same(got, ref.stable_clocks(j32(frontiers), threshold=threshold), f"n={n}")
        assert got.tolist() == votes_table_stable(frontiers, threshold), (
            f"n={n} vs VotesTable")


def _commit_inputs(rng, kcap, n, V, gap_rate):
    vkey = rng.integers(0, kcap, V).astype(np.int32)
    vby = rng.integers(0, n, V).astype(np.int32)
    vstart = rng.integers(1, 30, V).astype(np.int32)
    vstart = np.where(rng.random(V) < gap_rate, vstart + 20, vstart).astype(np.int32)
    vend = (vstart + rng.integers(0, 6, V)).astype(np.int32)
    valid = rng.random(V) < 0.85
    return vkey, vby, vstart, vend, valid


def case_votes_commit():
    """Random batches with overlapping, adjacent and gapped ranges (gaps
    leave residual runs) and invalid pad rows; the frontier carries over
    from one commit to the next, on both sides."""
    rng = np.random.default_rng(9)
    for n, threshold in ((3, 2), (5, 3)):
        kcap = 16
        frontier_p = t32(np.zeros((kcap, n)))
        frontier_j = j32(np.zeros((kcap, n)))
        host = np.zeros((kcap, n), dtype=np.int32)
        saw_residual = False
        for batch in range(6):
            V = 64
            cols = _commit_inputs(rng, kcap, n, V, gap_rate=0.3)
            got = port.fused_votes_commit(frontier_p, *(t32(c) if c.dtype != bool
                                                         else torch.tensor(c) for c in cols),
                                          threshold=threshold)
            assert got[0] is frontier_p, "the frontier is updated in place"
            want = ref.fused_votes_commit_xla(
                frontier_j, *(j32(c) if c.dtype != bool else jnp.array(c) for c in cols),
                threshold=threshold,
            )
            frontier_j = want[0]
            for i, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"n={n} batch {batch} output {i}")
            o_frontier, o_residual, o_stable = oracle_commit(host, *cols, threshold)
            assert got[0].tolist() == o_frontier.tolist(), f"n={n} batch {batch} frontier"
            assert residual_runs(got) == o_residual, f"n={n} batch {batch} residual"
            assert got[1].tolist() == o_stable.tolist(), f"n={n} batch {batch} stable"
            saw_residual |= bool(o_residual)
            host = o_frontier.astype(np.int32)
        assert saw_residual, "no batch left a residual run"


def case_votes_commit_pad_cell():
    """Slots that are not runs scatter 0 into frontier[0, 0] (the
    reference's pad convention): a no-op while that cell is >= 0, and a
    negative cell is raised to 0 — in both packages alike."""
    for cell in (7, -5):
        frontier = np.zeros((4, 3), dtype=np.int32)
        frontier[0, 0] = cell
        cols = (np.array([2, 0], np.int32), np.array([1, 0], np.int32),
                np.array([1, 0], np.int32), np.array([3, 0], np.int32),
                np.array([True, False]))
        got = port.fused_votes_commit(t32(frontier), *(torch.tensor(c) for c in cols),
                                      threshold=2)
        want = ref.fused_votes_commit_xla(j32(frontier), *(jnp.array(c) for c in cols),
                                          threshold=2)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"frontier[0, 0] = {cell}, output {i}")
        assert got[0][0, 0].item() == max(cell, 0)
        assert got[0][2, 1].item() == 3


def _round_oracle(prior, frontier, keys, mins, threshold, voters):
    clock, start, new_prior = oracle_proposals(prior, keys, mins)
    frontier = np.array(frontier, dtype=np.int64)
    n = frontier.shape[1]
    touched = np.zeros(len(prior), bool)
    touched[keys] = True
    lane = touched[:, None] & (np.arange(n) < voters)[None, :]
    contiguous = frontier >= np.asarray(prior)[:, None]
    frontier = np.where(lane & contiguous,
                        np.maximum(frontier, np.asarray(new_prior)[:, None]), frontier)
    gaps = int((lane & ~contiguous).sum())
    stable = np.sort(frontier, axis=1)[:, n - threshold]
    executable = np.asarray(clock) <= stable[keys]
    return new_prior, frontier, clock, start, executable, gaps


def case_table_rounds():
    """fused_table_round against the reference and numpy, and an S = 3
    fused_table_rounds chain equal to three single rounds (and to the
    reference's chain); some voters lag so gaps appear."""
    rng = np.random.default_rng(13)
    kcap, n, threshold, voters, batch = 16, 3, 2, 3, 32
    prior = rng.integers(0, 5, kcap).astype(np.int32)
    frontier = rng.integers(0, 5, (kcap, n)).astype(np.int32)
    keys = rng.integers(0, kcap - 1, (3, batch)).astype(np.int32)
    mins = np.where(rng.random((3, batch)) < 0.2, rng.integers(0, 20, (3, batch)), 0)
    mins = mins.astype(np.int32)
    p_prior, p_frontier = t32(prior), t32(frontier)
    o_prior, o_frontier = prior, frontier
    singles = []
    total_gaps = 0
    for s in range(3):
        got = port.fused_table_round(p_prior, p_frontier, t32(keys[s]), t32(mins[s]),
                                     threshold=threshold, voters=voters)
        assert got[0] is p_prior and got[1] is p_frontier, "the round is in place"
        want = ref.fused_table_round_xla(j32(o_prior), j32(o_frontier), j32(keys[s]),
                                         j32(mins[s]), threshold=threshold, voters=voters)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"round {s} output {i}")
        oracle = _round_oracle(o_prior, o_frontier, keys[s], mins[s], threshold, voters)
        for i, (g, o) in enumerate(zip(got, oracle)):
            assert np.array_equal(np.asarray(g.tolist()), np.asarray(o)), (
                f"round {s} output {i} vs numpy")
        total_gaps += int(got[5])
        singles.append(tuple(t.clone() for t in got[2:]))
        o_prior, o_frontier = np.asarray(want[0]), np.asarray(want[1])
    assert total_gaps > 0, "no round had a lagging voter"
    chain = port.fused_table_rounds(t32(prior), t32(frontier), t32(keys), t32(mins),
                                    threshold=threshold, voters=voters)
    want = ref.fused_table_rounds(j32(prior), j32(frontier), j32(keys), j32(mins),
                                  threshold=threshold, voters=voters)
    for i, (g, w) in enumerate(zip(chain, want)):
        same(g, w, f"chain output {i}")
    same(chain[0], np.asarray(o_prior), "chain prior vs single rounds")
    same(chain[1], np.asarray(o_frontier), "chain frontier vs single rounds")
    for i in range(4):
        same(chain[2 + i], torch.stack([r[i] for r in singles]).numpy(),
             f"chain output {2 + i} vs single rounds")


def case_clock_window():
    floor = 40 * 60 * 1_000_000
    host = np.array([0, floor + 1, floor + 12345], dtype=np.int64)
    pw, rw = port.ClockWindow(floor), ref.ClockWindow(floor)
    same(pw.rebase(host), rw.rebase(host), "rebase")
    same(pw.restore(pw.rebase(host)), rw.restore(rw.rebase(host)), "restore")
    for window in (pw, rw):
        with pytest.raises(AssertionError, match="below the window floor"):
            window.rebase(np.array([floor - 1], dtype=np.int64))
        with pytest.raises(AssertionError, match="overflows"):
            window.rebase(np.array([floor + (1 << 31)], dtype=np.int64))
    assert pw.advance(floor + 50) == rw.advance(floor + 50) == 50
    table = np.array([0, 10, 50, 51, 1000], dtype=np.int32)
    same(port.shift_table(t32(table), 50), ref.shift_table(j32(table), 50), "shift_table")


def case_cross_window_boundary():
    """Real-time-scale proposals through the 31-bit window: a batch under
    floor A, the window advances, and the next batch continues the same
    chains — equal to the reference and to the unbounded oracle."""
    n_keys = 4
    t0 = 50 * 60 * 1_000_000
    host_prior = [t0 + k * 7 for k in range(n_keys)]
    results = []
    for ops, to_dev in ((port, t32), (ref, j32)):
        win = ops.ClockWindow(t0 - 1)
        table = to_dev(win.rebase(host_prior))
        keys1, mins1 = [0, 1, 0, 2, 0, 3, 1], [0, 0, t0 + 100, 0, 0, 0, 0]
        host = lambda a: win.restore(np.asarray(a.tolist()))  # noqa: E731
        clock1, start1, table = ops.batched_clock_proposal(
            table, to_dev(keys1), to_dev(win.rebase(mins1)))
        first = [host(clock1), host(start1)]
        shift = win.advance(t0 + 50)
        table = ops.shift_table(table, shift)
        keys2, mins2 = [0, 0, 1, 2, 3], [t0 + 550, 0, 0, 0, 0]
        clock2, start2, table = ops.batched_clock_proposal(
            table, to_dev(keys2), to_dev(win.rebase(mins2)))
        results.append(first + [host(clock2), host(start2)])
    for i, (g, w) in enumerate(zip(*results)):
        same(g, w, f"cross-window output {i}")
    base = t0 - 1
    want_clock, _s, _p = oracle_proposals(
        [p - base for p in host_prior], [0, 1, 0, 2, 0, 3, 1],
        [0, 0, t0 + 100 - base, 0, 0, 0, 0])
    assert results[0][0].tolist() == [c + base for c in want_clock]
    assert results[0][2][0] > max(results[0][0][[0, 2, 4]])


CASES = (
    ("next_pow2", case_next_pow2),
    ("segmented_running_max", case_segmented_running_max),
    ("proposal, random", case_proposal_random),
    ("proposal, hot-key chain", case_proposal_hot_key_chain),
    ("proposal, near the window edge", case_proposal_near_window_edge),
    ("resident proposals and bumps", case_resident_proposals_and_bumps),
    ("stable_clocks", case_stable_clocks),
    ("votes commit, gaps and invalid rows", case_votes_commit),
    ("votes commit, pad cell", case_votes_commit_pad_cell),
    ("table rounds", case_table_rounds),
    ("clock window", case_clock_window),
    ("cross-window boundary", case_cross_window_boundary),
)


def test_table_ops_match_jax(jax_ref):
    for name, case in CASES:
        try:
            case()
        except AssertionError as exc:
            raise AssertionError(f"case {name!r}: {exc}") from exc
