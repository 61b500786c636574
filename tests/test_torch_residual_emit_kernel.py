"""``residual_view`` with no remap fill and ``emit_scatter`` with its folded
epilogue streamed in vertex order (``csrc/graph_plane_step.cu`` §4 and §7)
against their plain versions and the JAX reference.

Both CUDA sources run on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrappers' own device test, with
``K.LOOP_BLOCK`` lowered to 64.  The numpy-made windows of 256-1,024 rows
are ``chip_smoke.residual_window``'s (runs broken into residual tails of a
chosen size and kind, with ``occ`` and ``executed`` from
``chip_smoke.window_state``): n_residual = 1 (an unresolved row; a row whose
dep leaves the residual), = res_n, > res_n (the emit unfolded only), deps
that leave the residual or go into another tail, a window whose row count
is not a multiple of the init's four rows a thread, a fold whose byte
columns are not word-aligned (the init's row-by-row path), and a window
followed by the same keys with a tail healed and a dep into a row that
was residual in the call before (the remap's entry there is of an earlier
epoch and must read as TERMINAL).  Each wrapper call runs twice in a row
and must equal its plain version, outputs and ``executed`` (updated in
place) alike; the folded calls must reach unresolved residual vertices
that are occupied and pending, already executed, and free.  Each window is
also resolved by the port's ``resolve_functional_keyed`` on the emulated
kernels (the other stages on their plain versions), which must equal the
reference's (``fantoch_tpu/ops/graph_resolve.py:210``) field by field.
Tolerance: exact; the work is integers.

The emulator runs the blocks of a launch one after another, so the
scatter's last block always finds every other block's count: a race
between them shows only on the card, where ``chip_smoke.py`` phase 13
replays every call.

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
from test_torch_device_loops import jax_ref  # noqa: F401 (a fixture)

torch.set_num_threads(1)

mixed = chip_smoke.mixed_tails
# (label, rows, keys, tails, res_n, state seed); each run of a window is
# rows // keys rows long, so a tail has fewer
CASES = (
    ("n_residual = 1, unresolved", 256, 16, [(1, "missing")], 64, 1),
    ("n_residual = 1, its dep leaving the residual", 256, 16, [(1, "leaves")], 64, 2),
    ("n_residual = res_n", 512, 16, mixed(64, 31, 3), 64, 4),
    ("n_residual > res_n (overflow, unfolded)", 512, 16, mixed(80, 31, 5), 64, 6),
    ("deps leaving the residual or going into another tail", 1024, 32,
     mixed(200, 31, 7, ("leaves", "into")), 256, 8),
    ("1,022 rows, not a multiple of 4", 1022, 14, mixed(150, 72, 9), 256, 10),
    ("a window with tails on runs 0 and 1", 512, 16, [(8, "missing"), (8, "missing")], 64,
     11),
    ("then run 0 healed, run 1's dep into run 0's former tail", 512, 16,
     [None, (4, "leaves")], 64, 11),
)
UNALIGNED = "1,022 rows, not a multiple of 4"  # its fold also on unaligned columns


def _same(got, want, what):
    for i, (g, w) in enumerate(zip(chip_smoke.tensors_of(got), chip_smoke.tensors_of(want))):
        assert g.dtype == w.dtype and torch.equal(g, w), (what, i)


def _unaligned(t):
    """``t`` in a buffer one byte in: contiguous, not word-aligned."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t
    return buf[1:]


def test_residual_view_and_emit_scatter_kernels_match_plain_and_reference(
        jax_ref, monkeypatch):
    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    # the other stages of the keyed resolve on their plain versions
    for name in ("lex_sort", "link_scan", "group_scan", "pointer_doubling"):
        monkeypatch.setattr(K, name, getattr(K, f"{name}_plain"))
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        launched.append(fn)
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    kinds = [0, 0, 0]
    n_residual = {}
    calls = 0
    for label, rows, keys, tails, res_n, seed in CASES:
        key, dep = chip_smoke.residual_window(rows, keys, tails)
        occ, executed = chip_smoke.window_state(rows, seed)
        view, emit, folded = chip_smoke.residual_stage_calls(
            torch, K, key, dep, res_n, occ, executed, "cpu")  # on the plain route
        n_residual[label] = view[6]
        assert (folded is None) == (view[6] > res_n), label
        forms = [("residual_view", view), ("emit_scatter", emit)]
        if folded is not None:
            forms.append(("emit_scatter", folded))
        with emulated():
            for name, args in forms:
                plain_args = chip_smoke.clone_args(args)
                want = getattr(K, f"{name}_plain")(*plain_args)
                what = f"{label}, {name}, {len(args)} arguments"
                for run in range(2):
                    got_args = chip_smoke.clone_args(args)
                    got = getattr(K, name)(*got_args)
                    _same(got, want, (what, run))
                    _same(got_args, plain_args, (what, run, "arguments"))
                    calls += 1
                if args is folded:
                    counts = chip_smoke.unresolved_kinds(folded, want)
                    kinds = [a + b for a, b in zip(kinds, counts)]
                    if label == UNALIGNED:
                        occ_u, executed_u = (_unaligned(t) for t in folded[6:8])
                        assert occ_u.data_ptr() % 4 and executed_u.data_ptr() % 4
                        got = K.emit_scatter(*folded[:6], occ_u, executed_u, folded[8])
                        _same(got, want, (what, "unaligned"))
                        _same(executed_u, plain_args[7], (what, "unaligned executed"))
                        calls += 1
            # the whole keyed resolve on the emulated kernels
            src = (1 + np.arange(rows) % 5).astype(np.int32)
            seq = np.arange(rows, dtype=np.int32)
            got = port.resolve_functional_keyed(
                *(torch.tensor(a) for a in (key, dep, src, seq)), residual_size=res_n)
        want_ref = ref.resolve_functional_keyed(
            *(jnp.asarray(a) for a in (key, dep, src, seq)), residual_size=res_n,
            return_structure=False)
        for field, g, w in zip(got._fields, got, want_ref):
            assert np.array_equal(g.numpy(), np.asarray(w)), (label, field)
    # one launch a wrapper call: the held calls, then two a resolve
    assert launched.count("gp_residual_view") == 2 * len(CASES) + len(CASES)
    assert launched.count("gp_emit_scatter") == calls - 2 * len(CASES) + len(CASES)
    # the cases reach what they claim
    assert all(kinds), f"unresolved residual vertices pending, executed, free: {kinds}"
    assert n_residual["n_residual = 1, unresolved"] == 1
    assert n_residual["n_residual = res_n"] == 64
    assert n_residual["n_residual > res_n (overflow, unfolded)"] == 80
