"""``peel_compact`` (``csrc/graph_general.cu`` §12) in its three modes
against its plain version, and ``resolve_general_resident`` on the emulated
kernels against the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test.  Init and
the terminal publish are one cooperative launch each; the compaction is
two launches, a single-pass partition whose live count crosses tiles of
``K.COMPACT_TILE`` rows by decoupled look-back, then the gather.
``K.LOOP_BLOCK`` is lowered to 64, so a cooperative launch is at most 4
blocks of 64 threads on the emulated card and crosses a real grid
barrier.  Every call runs twice on the same inputs, so a flag or ticket
left by the call before would show.

On numpy-seeded states — stages of 3,000 and 4,096 rows (3,000 is no
power of two) with fewer live rows than ``half`` (kept rows whose targets
are finalized, missing and cut to ``FROZEN``), exactly ``half`` (the gate
stays open), one more (the gate closes), and the gate already closed; an
init over 3,000 rows with self-dependencies and MISSING cells; a terminal
publish into a larger batch with pads (3,000 and 3,001 rows: the stuck
flags four at a time and the rest one at a time) — every output and
every argument updated in place equals ``peel_compact_plain``.  Then
``resolve_general_resident`` under ``emulated()`` (every kernel emulated,
each call held against its plain version by ``chip_smoke.Checker``) equals
the reference's (``fantoch_tpu/ops/graph_resolve.py:746``) field by field
on a permuted DAG, MISSING-blocked chains and a window of directed cycles
that closes the publish gate.  Tolerance:
exact; the work is integers.

The emulator runs the blocks of a launch that is not cooperative one after
another, so the partition's look-back never waits: a race between its
tiles shows only on the card (``chip_smoke.py`` phase 10 replays every
call).

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_device_loops.py).
"""

import numpy as np
import torch

import jax.numpy as jnp

import chip_smoke
from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port
from test_torch_device_loops import (  # noqa: F401 (jax_ref is a fixture)
    dead_gate,
    dots,
    jax_ref,
    missing_chains,
    permuted_dag,
)

torch.set_num_threads(1)

TERMINAL, MISSING, FROZEN = K.TERMINAL, K.MISSING, K.FROZEN
WIDTH = 4


def stage(rng, size, live, batch, dead=0):
    """A stage of ``size`` rows, exactly ``live`` of them live (the others
    final or missing), random targets (rows, TERMINAL, MISSING and FROZEN),
    floors and ranks, rows mapped to distinct batch rows or the pad
    ``batch``; and outputs over ``batch`` rows with ``dead`` as given."""
    is_live = np.zeros(size, bool)
    is_live[rng.choice(size, live, replace=False)] = True
    final = ~is_live & (rng.random(size) < 0.6)
    miss = ~is_live & ~final
    tgt = rng.integers(0, size, (size, WIDTH))
    kind = rng.random((size, WIDTH))
    tgt = np.where(kind < 0.15, TERMINAL, np.where(kind < 0.2, MISSING,
                                                   np.where(kind < 0.25, FROZEN, tgt)))
    orig = rng.permutation(batch)[:size]
    orig = np.where(rng.random(size) < 0.1, batch, orig)
    cols = [tgt, rng.integers(0, 50, size), miss, final, rng.integers(0, 50, size), orig,
            rng.random(batch) < 0.3, rng.random(batch) < 0.1,
            rng.integers(0, 50, batch), np.array([dead])]
    types = [torch.int32, torch.int32, torch.bool, torch.bool, torch.int32, torch.int32,
             torch.bool, torch.bool, torch.int32, torch.int32]
    return [torch.tensor(c).to(t) for c, t in zip(cols, types)]


def same(what, got, want):
    got, want = chip_smoke.tensors_of(got), chip_smoke.tensors_of(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert torch.equal(g, w), f"{what}: tensor {i} differs from the plain version"


def check_call(what, args, kwargs):
    """The wrapper twice on clones of ``args`` against the plain version on
    clones of them: outputs and arguments updated in place.  Returns the
    plain version's outputs."""
    plain_args = chip_smoke.clone_args(args)
    want = K.peel_compact_plain(*plain_args, **kwargs)
    for run in range(2):
        got_args = chip_smoke.clone_args(args)
        got = K.peel_compact(*got_args, **kwargs)
        same(f"{what}, run {run}", got, want)
        same(f"{what}, run {run}: arguments", got_args, plain_args)
    return want, plain_args


def check_kernel_calls(rng):
    """The three modes on crafted states; returns what the cases reached."""
    reached = {"frozen": 0, "folded": 0, "closed": 0, "open at half": 0}
    deps = permuted_dag(rng, 3000, 200)
    deps[rng.choice(3000, 100, replace=False), 1] = MISSING
    rows = rng.choice(3000, 60, replace=False)
    deps[rows, 2] = rows  # self-dependencies: pruned
    check_call("init, 3000 x 4", (torch.tensor(deps),), {"mode": "init"})
    for size in (3000, 4096):
        half = size // 2
        for live, dead in ((half * 4 // 5, 0), (half, 0), (half + 1, 0), (half + 1, 1)):
            args = stage(rng, size, live, batch=size + 500, dead=dead)
            what = f"compact, {size} rows, {live} live, dead {dead}"
            (state, _n_live), after = check_call(what, args, {"mode": "compact",
                                                             "half": half})
            # the kept rows (live first, stably) and their targets
            tgt, final = args[0].numpy(), args[3].numpy()
            keep = np.argsort(~(~final & ~args[2].numpy()), kind="stable")[:half]
            valid = tgt[keep] >= 0
            to_final = valid & final[np.where(valid, tgt[keep], 0)]
            cut = valid & ~to_final & (state[0].numpy() == FROZEN)
            reached["folded"] += bool(to_final.any())
            reached["frozen"] += bool(cut.any())
            closed = int(after[9][0]) == 1 and dead == 0
            reached["closed"] += closed
            reached["open at half"] += live == half and int(after[9][0]) == 0
            assert closed == (live > half and dead == 0), what
    for dead, batch in ((0, 3000), (1, 3000), (0, 3001)):
        args = stage(rng, 1024, 300, batch=batch, dead=dead)
        check_call(f"publish, 1024 into {batch}, dead {dead}", args, {"mode": "publish"})
    return reached


def test_compact_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    rng = np.random.default_rng(83)
    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    modes = []
    real_launch = K._launch

    def launch(fn, *args):
        if fn == "gg_peel_compact":
            modes.append(args[-7])
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    resolves = [("permuted DAG", permuted_dag(rng, 3000, 200), 512),
                ("MISSING-blocked chains", missing_chains(rng, 2500), 256),
                ("publish gate closed", dead_gate(700, 300), 256)]
    with emulated():
        reached = check_kernel_calls(np.random.default_rng(7))
        assert all(reached.values()), reached
        checker = chip_smoke.Checker(K)
        checker.install()
        try:
            for name, deps, min_size in resolves:
                src, seq = dots(len(deps), 5)
                got = port.resolve_general_resident(
                    *(torch.tensor(a) for a in (deps, src, seq)), min_size=min_size)
                want = ref.resolve_general_resident(
                    *(jnp.asarray(a) for a in (deps, src, seq)), min_size=min_size)
                for field, g, w in zip(got._fields, got, want):
                    assert np.array_equal(g.numpy(), np.asarray(w)), (name, field)
        finally:
            checker.uninstall()
    assert checker.err["peel_compact"] == 0.0 and checker.count["peel_compact"] >= 12
    assert set(modes) == {0, 1, 2}, modes
