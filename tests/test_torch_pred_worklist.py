"""``pred_plane_step``'s fixpoint as a worklist over reverse edges
(``csrc/pred_plane.cu``) against its plain version and the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test, in both
forms: one CTA (the default shared-memory gate) and, with
``P.ONE_CTA_SMEM_BYTES`` lowered to 0 and ``P.GRID_BLOCK`` to 64, one
cooperative launch of four blocks on the emulated card, rows walked
grid-stride.  Every dispatch is held against ``pred_plane_step_plain`` by
``chip_smoke.Checker`` (the five state tensors updated in place and
``newly``, exactly) and against the reference's
``resolve_pred_plane_step_xla`` (``fantoch_tpu/ops/pred_resolve.py:123``),
each threading its own state across dispatches in a 2,048-slot window of
width 4.  The first dispatch installs a same-key chain of 1,100 commands
(longer than a block) in descending slot order, its head on a MISSING
cell; a row naming one target in two cells; a self-dependency and its
waiter; a MISSING cell and a row behind it; a row waiting on an IDLE slot;
deps past the window (read as row C - 1), one lower and one higher there;
and a row that readies three waiters at once.  The second installs the
chain's missing dot and patches the head to it.  Then a 64-slot window in
the grid form (four blocks of 64 threads, scan chunks of 16 rows) whose
last row has twelve waiters, eight times.  The work counter
(``P.last_work``) marks exactly the ``newly`` rows; the chain is walked in
one pass (no row pushed onto the worklist), the branching row pushes.

The emulator cannot show what nvcc refuses or memory-ordering faults
across SMs; the card run of ``chip_smoke.py`` does.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref``: tolerant duration listeners and the persistent compile
cache off (tests/test_torch_table_ops.py).
"""

import numpy as np
import torch

import jax.numpy as jnp

import chip_smoke
from fantoch_tpu.ops import pred_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import pred_kernels as P
from test_torch_table_ops import jax_ref  # noqa: F401 (a fixture)

torch.set_num_threads(1)

TERMINAL, MISSING = K.TERMINAL, K.MISSING
CAP, WIDTH, UCAP, PCAP = 2048, 4, 2048, 8
CHAIN = 1100


def feed(rows, deps, clock, src, patches=()):
    """Feed columns padded to UCAP installs and PCAP patches (pads at row
    CAP)."""
    u_row = np.full(UCAP, CAP, np.int32)
    u_deps = np.full((UCAP, WIDTH), TERMINAL, np.int32)
    u_clock = np.zeros(UCAP, np.int32)
    u_src = np.zeros(UCAP, np.int32)
    n = len(rows)
    u_row[:n], u_deps[:n], u_clock[:n], u_src[:n] = rows, deps, clock, src
    p = np.zeros((3, PCAP), np.int32)
    p[0] = CAP
    for i, cell in enumerate(patches):
        p[:, i] = cell
    return [u_row, u_deps, u_clock, u_src, *p]


def first_dispatch():
    rows, deps, clock = [], [], []

    def add(row, cells, at):
        rows.append(row)
        deps.append(list(cells) + [TERMINAL] * (WIDTH - len(cells)))
        clock.append(at)

    # the chain: command i in slot CHAIN - 1 - i, on its two predecessors;
    # the head waits on a dot not yet committed
    slot = CHAIN - 1 - np.arange(CHAIN)
    for i in range(CHAIN):
        add(slot[i], [MISSING if i == 0 else slot[i - 1]] + ([slot[i - 2]] if i > 1 else []),
            100 + i)
    base = 1200
    add(base + 1, [], 1)                            # a seed
    add(base, [base + 1, base + 1], 50)             # one target in two cells
    add(base + 2, [base + 2], 60)                   # a self-dependency...
    add(base + 3, [base + 2], 61)                   # ...and its waiter
    add(base + 4, [TERMINAL, MISSING], 62)          # a MISSING cell...
    add(base + 5, [base + 4], 63)                   # ...and a row behind it
    add(base + 6, [base + 40], 64)                  # an IDLE target
    add(CAP - 1, [], 2)                             # row C - 1, low clock
    add(base + 7, [CAP + 5], 65)                    # past C: waits on C - 1
    add(base + 13, [CAP + 9], 1)                    # past C, C - 1 higher
    add(base + 8, [base + 9], 66)                   # a branch: base + 9...
    add(base + 9, [], 3)
    for k in (10, 11, 12):                          # ...readies three at once
        add(base + k, [base + 8], 70 + k)
    return feed(rows, np.array(deps), clock, np.ones(len(rows)))


def second_dispatch():
    """The chain's missing dot commits in slot 1,300 and the head's MISSING
    cell is patched to it."""
    return feed([1300], np.full((1, WIDTH), TERMINAL), [1], [2],
                patches=[(CHAIN - 1, 0, 1300)])


def fresh(cap=CAP):
    return (np.full((cap, WIDTH), TERMINAL, np.int32), np.zeros(cap, np.int32),
            np.zeros(cap, np.int32), np.zeros(cap, bool), np.zeros(cap, bool))


SMALL = 64  # a window whose scan chunks (16 rows a block) are narrower than a block


def small_window():
    """Twelve rows waiting on the window's last row (by index C - 1 and
    past C), installed with it in one dispatch: its waiters are found
    through the CSR's last end, written by the scan's last chunk."""
    rows = list(range(12)) + [SMALL - 1]
    deps = np.full((13, WIDTH), TERMINAL)
    deps[:12, 0] = np.where(np.arange(12) % 2, SMALL - 1, SMALL + 7)
    deps[1:12, 1] = np.arange(11)  # and on the row before
    u_row = np.full(16, SMALL)
    u_deps = np.full((16, WIDTH), TERMINAL)
    u_clock, u_src = np.zeros(16), np.zeros(16)
    u_row[:13], u_deps[:13] = rows, deps
    u_clock[:13], u_src[:13] = list(range(10, 22)) + [1], 1
    p = np.zeros((3, 8), np.int32)
    p[0] = SMALL
    return [a.astype(np.int32) for a in (u_row, u_deps, u_clock, u_src)] + list(p)


def test_pred_worklist_matches_plain_and_reference(jax_ref, monkeypatch):
    dispatches = [first_dispatch(), second_dispatch()]
    # the reference, threading its own state
    state = tuple(jnp.asarray(a) for a in fresh())
    want = []
    for columns in dispatches:
        out = ref.resolve_pred_plane_step_xla(*state, *(jnp.asarray(c) for c in columns))
        state = tuple(out[:5])
        want.append([np.asarray(a) for a in out])
    newly = [w[5] for w in want]
    base = 1200
    assert newly[0][[base, base + 1, CAP - 1, base + 7, base + 8, base + 9, base + 13]].all()
    assert not newly[0][[base + 2, base + 3, base + 4, base + 5, base + 6]].any()
    assert newly[1].sum() == CHAIN + 1, "the patch did not wake the whole chain"

    checker = chip_smoke.Checker(P)
    P.reset_launch_counts()
    with emulated():
        checker.install()
        try:
            for form, gate, block in (("one CTA", P.ONE_CTA_SMEM_BYTES, P.GRID_BLOCK),
                                      ("grid", 0, 64)):
                monkeypatch.setattr(P, "ONE_CTA_SMEM_BYTES", gate)
                monkeypatch.setattr(P, "GRID_BLOCK", block)
                state = [torch.tensor(a) for a in fresh()]
                for d, columns in enumerate(dispatches):
                    what = f"{form}, dispatch {d}"
                    out = P.pred_plane_step(*state, *(torch.tensor(c) for c in columns))
                    for name, g, w in zip(("deps", "clock", "src", "occ", "executed",
                                           "newly"), out, want[d]):
                        assert np.array_equal(g.numpy(), w), f"{what}: {name}"
                    work = P.last_work()
                    assert work["marked"] == int(newly[d].sum()), (what, work)
                    if d == 0:  # base + 8 readies three rows: two are pushed
                        assert work["pushed"] >= 2, (what, work)
                    else:  # one walk down the chain
                        assert work["pushed"] == 0, (what, work)
        finally:
            checker.uninstall()
        # the grid form on a window narrower than four blocks, several
        # times (its blocks run at once here, so a stray write of the
        # CSR's last end would land in some run)
        columns = small_window()
        out = ref.resolve_pred_plane_step_xla(*(jnp.asarray(a) for a in fresh(SMALL)),
                                              *(jnp.asarray(c) for c in columns))
        want_small = [np.asarray(a) for a in out]
        assert want_small[5].sum() == 13, "the small window's rows did not all run"
        checker.install()
        try:
            monkeypatch.setattr(P, "ONE_CTA_SMEM_BYTES", 0)
            monkeypatch.setattr(P, "GRID_BLOCK", 64)
            for run in range(8):
                state = [torch.tensor(a) for a in fresh(SMALL)]
                got = P.pred_plane_step(*state, *(torch.tensor(c) for c in columns))
                assert np.array_equal(got[5].numpy(), want_small[5]), f"small window, run {run}"
        finally:
            checker.uninstall()
    assert checker.err == {"pred_plane_step": 0.0}, checker.err
    assert P.VARIANT_LAUNCHES == {"one_cta": 2, "grid": 10}, P.VARIANT_LAUNCHES
