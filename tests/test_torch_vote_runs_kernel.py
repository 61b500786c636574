"""``vote_runs`` (``csrc/table_plane.cu`` §vote_runs) against its plain
version and the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test, in both
forms: one CTA (the three stages in one launch, up to ``T.VOTE_CTA_ROWS``
rows) and, with the gate lowered to 0 and ``T.VOTE_BLOCK`` to 64, tiles of 256
rows whose scans carry across tiles by decoupled look-back (a tile
wholly past the last run only fills its slots).  Every call is
held against ``vote_runs_plain`` by ``chip_smoke.Checker`` (the run
columns, residual and the frontier updated in place, exactly) and against
the reference's ``fused_votes_commit_xla`` (``fantoch_tpu/ops/
table_ops.py:260-315``).  The numpy-seeded inputs (V = 1,024 rows over a
64 x 3 frontier) hold a group whose 300 rows merge into one run across
tile boundaries and extend the frontier, a group of several runs (one
below the frontier, one that extends, one residual), invalid rows, ranges
that end before they start, a row ending at the int32 edge, valid runs on
cell (0, 0) under a negative ``frontier[0, 0]``, one that extends it to a
negative end while the slots that are not valid runs raise it to 0, the
same cell negative with no valid run on it (raised to 0 by those slots)
and with every slot a valid run elsewhere (left as it was).
Tolerance: exact; the work is integers.

The emulator runs the blocks of a launch that is not cooperative one after
another, so a tile's look-back always finds its predecessor's inclusive
prefix published, and it cannot show a race between blocks of one launch
(a read of the frontier before another block's write, or a status read
before its prefix lands); the card run of ``chip_smoke.py`` covers those.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``: tolerant duration listeners and the persistent compile
cache off (tests/test_torch_table_ops.py).
"""

import numpy as np
import torch

import jax.numpy as jnp

import chip_smoke
from fantoch_tpu.ops import table_ops as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import table_kernels as T
from test_torch_table_ops import jax_ref  # noqa: F401 (a fixture)

torch.set_num_threads(1)

KEYS, N, V = 64, 3, 1024
INT32_MAX = (1 << 31) - 1


def rows(rng, count, invalid=0.15):
    """``count`` random rows: keys and processes anywhere but cell (0, 0),
    starts in [1, 60], ends up to 6 past (a fifth of them before) the start."""
    key = rng.integers(1, KEYS, count)
    by = rng.integers(0, N, count)
    start = rng.integers(1, 60, count)
    end = np.where(rng.random(count) < 0.2, start - rng.integers(1, 4, count),
                   start + rng.integers(0, 6, count))
    valid = rng.random(count) >= invalid
    return [key, by, start, end, valid]


def put(cols, at, key, by, start, end, valid=True):
    """Rows ``at`` set to the given ranges on one cell."""
    cols[0][at], cols[1][at] = key, by
    cols[2][at], cols[3][at], cols[4][at] = start, end, valid


def case_mixed(rng):
    """A 300-row merge, a group of several runs, cell (0, 0) valid under a
    negative frontier, ranges past their ends, the int32 edge."""
    frontier = rng.integers(0, 30, (KEYS, N))
    cols = rows(rng, V)
    perm = rng.permutation(V)
    # key 3, process 1: 300 overlapping ranges, one run that extends
    merge = perm[:300]
    i = np.arange(300)
    put(cols, merge, 3, 1, 10 + i // 2, 12 + i // 2)
    frontier[3, 1] = 12
    # key 5, process 0: runs [1, 3] (below the frontier), [6, 8] (extends
    # from 5), [20, 25] (residual), [40, 41] (residual); a range past its
    # end inside the second
    for at, (s, e) in zip(perm[300:306], ((1, 3), (2, 2), (6, 8), (7, 5), (20, 25), (40, 41))):
        put(cols, at, 5, 0, s, e)
    frontier[5, 0] = 5
    # cell (0, 0): valid runs under a negative frontier, [-8, 4] extends
    for at, (s, e) in zip(perm[306:310], ((-8, -5), (-6, -2), (-1, 4), (9, 9))):
        put(cols, at, 0, 0, s, e)
    frontier[0, 0] = -7
    # key 7, process 2: a range ending at the int32 edge, later starts
    for at, (s, e) in zip(perm[310:314], ((2, INT32_MAX), (4, 6), (9, 12), (9, 3))):
        put(cols, at, 7, 2, s, e)
    frontier[7, 2] = 5
    return frontier, cols


def case_spare_slots(rng):
    """No valid run on cell (0, 0), invalid rows: frontier[0, 0] < 0 is
    raised to 0 by the slots that are not valid runs."""
    frontier = rng.integers(0, 30, (KEYS, N))
    frontier[0, 0] = -3
    return frontier, rows(rng, V, invalid=0.3)


def case_cell0_below_zero(rng):
    """One valid run on cell (0, 0) extends its negative frontier to a
    negative end, and invalid rows are there: the spare slots' 0 wins."""
    frontier = rng.integers(0, 30, (KEYS, N))
    frontier[0, 0] = -9
    cols = rows(rng, V, invalid=0.2)
    put(cols, rng.permutation(V)[:2], 0, 0, [-8, -7], [-5, -4])
    return frontier, cols


def case_every_slot_a_run(rng):
    """Every row its own valid run (gapped ranges on a few cells), none on
    cell (0, 0): frontier[0, 0] < 0 stays."""
    frontier = rng.integers(0, 4, (KEYS, N))
    frontier[0, 0] = -4
    i = rng.permutation(V)
    cells = i % 40
    start = 1 + 3 * (i // 40)  # a gap of 2 between a cell's ranges
    return frontier, [1 + cells // N, cells % N, start, start, np.ones(V, bool)]


def case_random(rng):
    """Random rows on every cell, cell (0, 0) included, and a frontier with
    negative cells."""
    frontier = rng.integers(-5, 40, (KEYS, N))
    cols = rows(rng, V)
    cols[0] = rng.integers(0, KEYS, V)
    return frontier, cols


CASES = (("mixed", case_mixed), ("spare slots", case_spare_slots),
         ("cell (0, 0) below zero", case_cell0_below_zero),
         ("every slot a run", case_every_slot_a_run), ("random", case_random))
# frontier[0, 0] after each case, where the case sets it: raised by its
# valid runs, raised to 0 by the spare slots, left below 0
CELL0 = {"mixed": 4, "spare slots": 0, "cell (0, 0) below zero": 0,
         "every slot a run": -4}


def reference(frontier, cols):
    """The reference's run columns and frontier (threshold irrelevant)."""
    out = ref.fused_votes_commit_xla(
        jnp.array(frontier, jnp.int32), *(jnp.array(c, jnp.int32) for c in cols[:4]),
        jnp.array(cols[4], bool), threshold=2,
    )
    new_frontier, _stable, *runs = out
    return [np.asarray(a) for a in runs], np.asarray(new_frontier)


def test_vote_runs_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    rng = np.random.default_rng(47)
    inputs = [(name, *case(rng)) for name, case in CASES]
    checker = chip_smoke.Checker(T)
    forms, runs = [], []
    real_launch = K._launch

    def launch(fn, *args):
        if fn == "tp_vote_runs":
            forms.append(args[-2])  # the one-CTA flag
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    with emulated():
        checker.install()
        try:
            for form, gate, block in (("one CTA", T.VOTE_CTA_ROWS, T.VOTE_BLOCK),
                                      ("tiles of 256 rows", 0, 64)):
                monkeypatch.setattr(T, "VOTE_CTA_ROWS", gate)
                monkeypatch.setattr(T, "VOTE_BLOCK", block)
                for name, frontier, cols in inputs:
                    want_runs, want_frontier = reference(frontier, cols)
                    got_frontier = torch.tensor(frontier.astype(np.int32))
                    got = T.vote_runs(
                        got_frontier, *(torch.tensor(c.astype(np.int32)) for c in cols[:4]),
                        torch.tensor(cols[4].astype(bool)))
                    what = f"{form}, {name}"
                    runs.append(int((got[3] != -(1 << 31)).sum()))
                    assert want_frontier[0, 0] == CELL0.get(name, want_frontier[0, 0]), what
                    for i, (g, w) in enumerate(zip(got, want_runs)):
                        assert np.array_equal(g.numpy(), w), f"{what}: output {i} differs"
                    assert np.array_equal(got_frontier.numpy(), want_frontier), what
        finally:
            checker.uninstall()
    assert checker.err["vote_runs"] == 0.0, checker.err
    assert checker.count["vote_runs"] == 2 * len(CASES), checker.count
    assert forms == [1] * len(CASES) + [0] * len(CASES), forms
    # some tile of 256 rows lies wholly past the last run (its own path)
    assert min(runs) <= V - 256, runs
    # the mixed case reaches what it claims: the 300 rows extend their cell
    # to 161, [6, 8] extends key 5's, [20, 25] and [40, 41] are residual
    runs, frontier = reference(*inputs[0][1:])
    residual = runs[4] & (runs[0] == 5) & (runs[1] == 0)
    assert {20, 40} <= set(runs[2][residual].tolist()), runs[2][residual]
    assert frontier[3, 1] >= 161 and frontier[5, 0] >= 8, (frontier[3, 1], frontier[5, 0])
