"""The votes-table kernels' CUDA source against their plain versions.

``csrc/table_plane.cu`` runs on the CPU through the emulator
(``csrc/emu/emulate.py``: g++, one OS thread per CUDA thread, barriers for
``__syncthreads``), behind the wrappers' own device test, and every
wrapper call is held against its plain PyTorch version by
``chip_smoke.Checker`` — outputs, in-place updated arguments, flags and
counts, exactly — as ``chip_smoke.py`` does on the card.  The inputs reach
every branch: hot-key runs, batches of several scan blocks (carries across
blocks), clocks at the int32 edge, vote gaps that leave residual runs,
invalid rows, a negative pad cell, the table round's lagging voters, and
up to ``MAX_VOTERS`` processes.  The emulator cannot show what nvcc
refuses or races between blocks; the card run does.

One collected item on purpose (ROADMAP.md Queue C); no JAX call here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import table_kernels as T
from fantoch_tpu_torch.ops import table_ops as port

torch.set_num_threads(1)

INT32_MAX = (1 << 31) - 1


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.int32))


def case_proposals(rng):
    """clock_proposal over 1 to 3 scan blocks, half the rows on one key,
    min clocks, and priors at the int32 edge (the sums wrap); clock_bump
    with duplicate buckets and pad rows."""
    for trial, batch in enumerate((1, 5, 1025, 2100)):
        kcap = 64
        prior = rng.integers(0, 40, kcap)
        if trial == 2:
            prior = INT32_MAX - rng.integers(0, 3, kcap)
        keys = np.where(rng.random(batch) < 0.5, 7, rng.integers(0, kcap - 1, batch))
        mins = np.where(rng.random(batch) < 0.3, rng.integers(0, 90, batch), 0)
        table = t32(prior)
        port.resident_clock_proposal(table, t32(keys), t32(mins))
        port.batched_clock_proposal(table, t32(keys[::-1].copy()), t32(mins))
        idx = np.concatenate([rng.integers(0, kcap - 1, 40), np.full(24, kcap - 1)])
        val = np.concatenate([rng.integers(0, 200, 40), np.zeros(24)])
        port.resident_clock_bump(table, t32(idx), t32(val))


def case_commits(rng):
    """vote_runs and stable_rows through fused_votes_commit: overlapping,
    adjacent and gapped ranges over 1 to 3 scan blocks, invalid rows, a
    negative frontier[0, 0], n from 3 to MAX_VOTERS."""
    for n, threshold, V in ((3, 2, 64), (5, 3, 1500), (T.MAX_VOTERS, 9, 2100)):
        kcap = 32
        frontier = t32(rng.integers(0, 10, (kcap, n)))
        frontier[0, 0] = -5
        for _batch in range(2):
            vkey = rng.integers(0, kcap, V)
            vby = rng.integers(0, n, V)
            vstart = rng.integers(1, 40, V)
            vstart = np.where(rng.random(V) < 0.3, vstart + 25, vstart)
            vend = vstart + rng.integers(0, 6, V)
            valid = torch.tensor(rng.random(V) < 0.85)
            port.fused_votes_commit(frontier, t32(vkey), t32(vby), t32(vstart),
                                    t32(vend), valid, threshold=threshold)
        port.stable_clocks(frontier, threshold=1)
        port.stable_clocks(frontier, threshold=n)


def case_rounds(rng):
    """The table round: stable_rows' round mode after clock_proposal, with
    lagging voters (gaps), fewer voters than processes, and the S = 3
    chain."""
    for n, threshold, voters, batch in ((3, 2, 3, 300), (5, 3, 4, 1200)):
        kcap = 64
        prior = t32(rng.integers(0, 5, kcap))
        frontier = t32(rng.integers(0, 5, (kcap, n)))
        keys = rng.integers(0, kcap - 1, (3, batch))
        mins = np.where(rng.random((3, batch)) < 0.2, rng.integers(0, 20, (3, batch)), 0)
        port.fused_table_round(prior, frontier, t32(keys[0]), t32(mins[0]),
                               threshold=threshold, voters=voters)
        port.fused_table_rounds(prior, frontier, t32(keys), t32(mins),
                                threshold=threshold, voters=voters)


def test_table_kernels_match_plain_versions():
    rng = np.random.default_rng(23)
    checker = chip_smoke.Checker(T)
    T.reset_launch_counts()
    with emulated():
        checker.install()
        try:
            for name, case in (("proposals", case_proposals), ("commits", case_commits),
                               ("rounds", case_rounds)):
                try:
                    case(rng)
                except AssertionError as exc:
                    raise AssertionError(f"case {name!r}: {exc}") from exc
            with pytest.raises(ValueError, match="at most"):
                T.stable_rows(t32(np.zeros((4, T.MAX_VOTERS + 1))), 2)
            with pytest.raises(ValueError, match="at least one row"):
                empty = t32(np.zeros(0))
                T.vote_runs(t32(np.zeros((4, 3))), empty, empty, empty, empty,
                            torch.zeros(0, dtype=torch.bool))
        finally:
            checker.uninstall()
    assert all(checker.count[name] > 0 for name in T.LAUNCHES), checker.count
    assert checker.err == {name: 0.0 for name in T.LAUNCHES}, checker.err
    # every checked call launched its kernels (the count the chip run reads)
    assert T.LAUNCHES == checker.count, (T.LAUNCHES, checker.count)
    assert checker.calls.keys() >= {"stable_rows, table round", "stable_rows"}
