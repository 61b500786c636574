"""The predecessors-plane kernels' CUDA source against their plain version.

``csrc/pred_plane.cu`` runs on the CPU through the emulator
(``csrc/emu/emulate.py``: g++, one OS thread per CUDA thread, barriers for
``__syncthreads``), behind the wrapper's own device test, and every
``pred_plane_step`` call is held against ``pred_plane_step_plain`` by
``chip_smoke.Checker`` — the five state tensors updated in place and
``newly``, exactly — as ``chip_smoke.py`` does on the card.  Both
variants run: the one-CTA kernel at the default shared-memory gate, and
the grid-wide sweeps with the gate lowered to 0.  The feeds reach every
branch: pad install rows and patch cells, patches on rows the same
dispatch installs, MISSING cells, dep targets that are higher or lower in
(clock, src), equal clocks told apart by src, a self-dependency, a dep
index past the window (read as row C - 1), and a same-key chain in
descending slot order woken by a later patch, run with one grid-wide sweep
between host reads of the change flags so the wrapper reads them more
than once a dispatch.  The emulator cannot show what nvcc refuses
or races between blocks; the card run does.

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
    assert P.last_sweeps() >= 2  # a sweep that changed, one that did not


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
            for variant, limit, per_read in (
                ("one_cta", P.ONE_CTA_SMEM_BYTES, P.SWEEPS_PER_READ),
                ("grid", 0, P.SWEEPS_PER_READ),
                ("grid, one sweep a read", 0, 1),
            ):
                monkeypatch.setattr(P, "ONE_CTA_SMEM_BYTES", limit)
                monkeypatch.setattr(P, "SWEEPS_PER_READ", per_read)
                try:
                    if per_read > 1:
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
    assert launched.count("pp_one_cta") == 6
    assert launched.count("pp_grid_prepare") == launched.count("pp_grid_finish") == 8
    # one sweep a read: the chain's two dispatches read their flags at
    # least twice each
    assert launched.count("pp_grid_sweeps") >= 6 + 2 * 2, launched
