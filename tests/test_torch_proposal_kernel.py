"""``clock_proposal`` as one look-back pass (``csrc/table_plane.cu``
§clock_proposal) against its plain version and the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test: a block
a tile of ``T.PROP_TILE`` rows carrying the run state by decoupled
look-back; the sort before it takes its plain version (the emulated radix sort takes seconds
a call).  Every input is called twice in a row on fresh copies of the key
table, so a status flag or ticket left by the call before would show.
The numpy-seeded inputs are ``chip_smoke.proposal_edge_cases``, the
cases phase 11 holds on the card: B = 1; the tile's and the gate's sizes
+-1 and twice +1, half the rows on one key; all rows on one key; every
row on its own key; priors at INT32_MAX - 3, so that clocks wrap; priors
at INT32_MAX (prior + 1 wraps) and near INT32_MIN under INT32_MIN
minimum clocks, so that base - rank wraps; ``min_clock`` above and below
``prior + 1``; then three calls in a row on one table.  Each call's
clocks, vote starts and the table after it must equal
``clock_proposal_plain`` and the reference's ``batched_clock_proposal``
and ``resident_clock_proposal`` (``fantoch_tpu/ops/table_ops.py:187,
204``).  Tolerance: exact; the work is int32 with wrap.

The emulator runs the blocks of a launch that is not cooperative one after
another, so a tile's look-back always finds its predecessor's prefix
published: it cannot show a race between tiles; ``chip_smoke.py`` phase 11
replays every call on the card for that.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_table_ops.py).
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


def reference(prior, key, min_clock):
    """(clock, vote_start, new prior) of both reference entry points, which
    must agree."""
    args = [jnp.asarray(a.numpy()) for a in (prior, key, min_clock)]
    batched = [np.asarray(x) for x in ref.batched_clock_proposal(*args)]
    resident = [np.asarray(x) for x in ref.resident_clock_proposal(
        jnp.array(prior.numpy()), *args[1:])]
    for b, r in zip(batched, resident):
        assert np.array_equal(b, r)
    return batched


def test_proposal_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    cases = list(chip_smoke.proposal_edge_cases(torch, T).items())
    rng = np.random.default_rng(23)
    # three calls in a row on one table, the table threaded through
    table = rng.integers(0, 40, chip_smoke.TABLE_KCAP).astype(np.int32)
    chained = []
    for b in (3000, 1500, 2500):
        key = np.where(rng.random(b) < 0.5, 9, rng.integers(0, 4096, b)).astype(np.int32)
        mins = np.where(rng.random(b) < 0.2, 70, 0).astype(np.int32)
        chained.append((torch.tensor(key), torch.tensor(mins)))
    expected = []
    for name, (prior, key, mins) in cases:
        p = prior.clone()
        clock, vote_start = T.clock_proposal_plain(p, key, mins)
        want = reference(prior, key, mins)
        for g, w in zip((clock, vote_start, p), want):
            assert np.array_equal(g.numpy(), w), name
        expected.append((clock, vote_start, p))
    wrap = dict(zip((n for n, _a in cases), expected))
    assert (wrap["B = 5000, priors at INT32_MAX - 3, clocks wrap"][0] < 0).any()
    prior = torch.tensor(table)
    chain_want = []
    for key, mins in chained:
        p = prior.clone()
        clock, vote_start = T.clock_proposal_plain(p, key, mins)
        for g, w in zip((clock, vote_start, p), reference(prior, key, mins)):
            assert np.array_equal(g.numpy(), w)
        chain_want.append((clock, vote_start, p))
        prior = p

    monkeypatch.setattr(K, "lex_sort", K.lex_sort_plain)
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        if fn == "tp_clock_proposal":
            launched.append(args[-2])  # the rows
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    with emulated():
        for (name, (prior, key, mins)), want in zip(cases, expected):
            for run in range(2):
                p = prior.clone()
                got = T.clock_proposal(p, key, mins)
                for i, (g, w) in enumerate(zip((*got, p), want)):
                    assert g.dtype == w.dtype and torch.equal(g, w), (name, run, i)
        prior = torch.tensor(table)
        for i, ((key, mins), want) in enumerate(zip(chained, chain_want)):
            got = T.clock_proposal(prior, key, mins)
            for j, (g, w) in enumerate(zip((*got, prior), want)):
                assert torch.equal(g, w), ("chained", i, j)
    assert len(launched) == 2 * len(cases) + len(chained), launched
    assert max(launched) > 2 * T.PROP_TILE, launched  # tiles carried across blocks
