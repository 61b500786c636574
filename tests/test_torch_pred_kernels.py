"""The predecessors-plane kernels' CUDA source against their plain version.

``csrc/pred_plane.cu`` runs on the CPU through the emulator
(``csrc/emu/emulate.py``: g++, one OS thread per CUDA thread, barriers for
``__syncthreads``), behind the wrapper's own device test, and every
``pred_plane_step`` call is held against ``pred_plane_step_plain`` by
``chip_smoke.Checker`` — the five state tensors updated in place and
``newly``, exactly — as ``chip_smoke.py`` does on the card.  Both
forms run, each one launch a dispatch: the one-CTA kernel at the default
shared-memory gate, and the cooperative grid with the gate lowered to 0,
in blocks of 256 threads and, so that the emulated card's four blocks
split the rows, of 64.  The feeds reach every
branch: pad install rows and patch cells, patches on rows the same
dispatch installs, MISSING cells, dep targets that are higher or lower in
(clock, src), equal clocks told apart by src, a self-dependency, a dep
index past the window (read as row C - 1), and a same-key chain in
descending slot order woken by a later patch, walked in one pass down
the chain (every row marked, none pushed onto the worklist).  The
emulator cannot show what nvcc refuses or memory-ordering faults across
SMs; the card run does.

One collected item on purpose (ROADMAP.md Queue C); no JAX call here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import pred_kernels as P
from fantoch_tpu_torch.ops import pred_resolve

torch.set_num_threads(1)

TERMINAL, MISSING = -1, -2


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.int32))


def fresh(cap, width):
    return [
        t32(np.full((cap, width), TERMINAL)),
        t32(np.zeros(cap)),
        t32(np.zeros(cap)),
        torch.zeros(cap, dtype=torch.bool),
        torch.zeros(cap, dtype=torch.bool),
    ]


def feed(cap, width, rows, deps, clock, src, patches=(), ucap=8, pcap=8):
    u_row = np.full(ucap, cap)
    u_deps = np.full((ucap, width), TERMINAL)
    u_clock = np.zeros(ucap)
    u_src = np.zeros(ucap)
    n = len(rows)
    u_row[:n] = rows
    if n:
        u_deps[:n], u_clock[:n], u_src[:n] = deps, clock, src
    p = np.zeros((3, pcap))
    p[0] = cap
    for i, cell in enumerate(patches):
        p[:, i] = cell
    return [t32(a) for a in (u_row, u_deps, u_clock, u_src, p[0], p[1], p[2])]


def step(state, columns):
    out = pred_resolve.resolve_pred_plane_step(*state, *columns)
    state[:] = out[:5]
    return out.newly


def case_random(rng):
    """Four dispatches of random installs and unique patch cells."""
    cap, width = 48, 4
    state = fresh(cap, width)
    installed = 0
    for _dispatch in range(4):
        n = 8
        rows = np.arange(installed, installed + n)
        deps = np.full((n, width), TERMINAL)
        for i, row in enumerate(rows):
            for w in range(width):
                choice = rng.random()
                if choice < 0.2:
                    deps[i, w] = MISSING
                elif choice < 0.8:
                    deps[i, w] = rng.integers(0, row + 1)  # the row itself too
                elif choice < 0.85:
                    deps[i, w] = cap + 3  # read as row cap - 1
        clock = rng.integers(1, 12, n)  # ties, told apart by src
        src = rng.integers(1, 4, n)
        cells = {}
        for _ in range(5):
            cell = (int(rng.integers(0, installed + n)), int(rng.integers(0, width)))
            cells[cell] = TERMINAL if rng.random() < 0.5 else int(rng.integers(0, installed + n))
        patches = [(r, c, v) for (r, c), v in cells.items()]
        step(state, feed(cap, width, rows, deps, clock, src, patches, ucap=16))
        installed += n


def case_chain_and_wake():
    """A chain in descending slot order, its head on a MISSING cell; the
    next dispatch installs the missing dot and patches the head to it."""
    cap, width, n = 64, 2, 40
    state = fresh(cap, width)
    slots = np.arange(n)[::-1]
    deps = np.full((n, width), TERMINAL)
    deps[0, 0] = MISSING
    for i in range(1, n):
        deps[i, 0] = slots[i - 1]
        if i > 1:
            deps[i, 1] = slots[i - 2]
    newly = step(state, feed(cap, width, slots, deps, np.arange(2, n + 2), np.ones(n),
                             ucap=64))
    assert not newly.any()
    newly = step(state, feed(cap, width, [n], np.full((1, width), TERMINAL), [1], [2],
                             patches=[(slots[0], 0, n)]))
    assert int(newly.sum()) == n + 1
    # one walk down the chain: every row marked, none through the worklist
    assert P.last_work() == {"marked": n + 1, "pushed": 0}, P.last_work()


def test_pred_kernels_match_plain_version(monkeypatch):
    rng = np.random.default_rng(31)
    checker = chip_smoke.Checker(P)
    P.reset_launch_counts()
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        launched.append(fn)
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    with emulated():
        checker.install()
        try:
            for variant, limit, block in (
                ("one_cta", P.ONE_CTA_SMEM_BYTES, P.GRID_BLOCK),
                ("grid", 0, P.GRID_BLOCK),
                ("grid, 64-thread blocks", 0, 64),
            ):
                monkeypatch.setattr(P, "ONE_CTA_SMEM_BYTES", limit)
                monkeypatch.setattr(P, "GRID_BLOCK", block)
                try:
                    if block != 64:
                        case_random(rng)
                    case_chain_and_wake()
                except AssertionError as exc:
                    raise AssertionError(f"variant {variant!r}: {exc}") from exc
            with pytest.raises(ValueError, match="int32"):
                state = fresh(8, 2)
                state[1] = state[1].long()
                checker.real["pred_plane_step"](*state, *feed(8, 2, [], None, [], []))
        finally:
            checker.uninstall()
    assert checker.err == {"pred_plane_step": 0.0}, checker.err
    # every checked call launched its kernels, in both variants
    assert P.LAUNCHES == checker.count == {"pred_plane_step": 14}, checker.count
    assert P.VARIANT_LAUNCHES == {"one_cta": 6, "grid": 8}, P.VARIANT_LAUNCHES
    # one launch a dispatch in either form, whatever the chain length
    assert launched.count("pp_one_cta") == 6
    assert launched.count("pp_grid") == 8
    assert len(launched) == 14, launched
