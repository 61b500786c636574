"""``group_scan`` (``csrc/graph_plane_step.cu`` §5: one elementwise launch,
no scan) against its plain version and the reference's formula.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test.  Its
inputs are ``_residual_emit``'s: captured from keyed plane dispatches on
the plain route (1,024-slot windows, feeds on 64 keys shuffled so the
residual branch runs, ``_FeedMaker``), then
``chip_smoke.group_scan_edge_cases`` at 2,048 rows (one group; one row a
group; n_residual = 0, 1, m - 1 and m; groups across the 256-thread
blocks; a long group before the INT32_MAX rows, which start inside a
warp) and a 2,000-row residual of groups of 1-64 rows, all numpy seeded.
The kernel takes a warp 32 rows: a row whose group began before its warp
is found by the warp's 32-way search.  Each call, twice in a row, must equal
``group_scan_plain`` and the reference's ``firstbad + emit_local``
(``fantoch_tpu/ops/graph_resolve.py:308-309, 335-336``) computed in numpy
(``chip_smoke.group_scan_numpy``), one launch a call.  Tolerance: exact;
the work is integers.

One collected item on purpose (ROADMAP.md Queue C); the feeds' reference
dispatches run under ``jax_ref`` (tests/test_torch_device_loops.py).
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
from test_torch_graph_resolve import _FeedMaker, _fresh

torch.set_num_threads(1)

EDGE_ROWS = 2048


def captured_inputs(monkeypatch):
    """``group_scan``'s inputs in keyed plane dispatches on the plain route,
    each dispatch also equal to the reference's."""
    calls, real = [], K.group_scan

    def record(rrs, p_r):
        calls.append((rrs.clone(), p_r.clone()))
        return real(rrs, p_r)

    monkeypatch.setattr(K, "group_scan", record)
    for window in (4, 8):
        maker = _FeedMaker("shuffled", 1024, 4, 256, 256, 8, seed=1024, n_keys=64,
                           window=window)
        state = _fresh(1024, 4)
        for feed_i in range(4):
            feed = maker.next(state, feed_i)
            want = [np.asarray(x) for x in ref.resolve_graph_plane_step(
                *(jnp.array(a) for a in state), *(jnp.asarray(a) for a in feed),
                mode="keyed")]
            got = port.resolve_graph_plane_step(
                *(torch.tensor(a) for a in (*state, *feed)), mode="keyed")
            for field, g, w in zip(got._fields, got, want):
                assert np.array_equal(g.numpy(), w), (window, feed_i, field)
            state = tuple(want[:6])
    monkeypatch.setattr(K, "group_scan", real)
    return {f"captured call {i}, m = {len(c[0])}": c for i, c in enumerate(calls)}


def test_group_scan_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    cases = captured_inputs(monkeypatch)
    assert len(cases) >= 2, len(cases)
    for label, (rrs, p_r) in chip_smoke.group_scan_edge_cases(EDGE_ROWS).items():
        cases[label] = (torch.tensor(rrs), torch.tensor(p_r))
    sizes = chip_smoke.group_sizes(1500, 1, 64, 3)
    cases["2,000 rows, groups of 1-64"] = tuple(
        torch.tensor(a) for a in chip_smoke.group_scan_inputs(2000, sizes, 4))
    # the cases reach what they claim: an INT32_MAX group after a residual
    # whose first p_r falls, and a residual of every row
    tails = [int((rrs == K.INT32_MAX).sum()) for rrs, _ in cases.values()]
    assert 0 in tails and EDGE_ROWS in tails
    falls = [bool(p_r[len(p_r) - t] < p_r[len(p_r) - t - 1])
             for t, (_rrs, p_r) in zip(tails, cases.values()) if 0 < t < len(p_r)]
    assert sum(falls) >= 3, falls
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        launched.append(fn)
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    with emulated():
        for label, (rrs, p_r) in cases.items():
            want = K.group_scan_plain(rrs, p_r)
            numpy = chip_smoke.group_scan_numpy(rrs.numpy(), p_r.numpy())
            assert np.array_equal(want.numpy(), numpy), label
            for run in range(2):
                got = K.group_scan(rrs, p_r)
                assert got.dtype == want.dtype and torch.equal(got, want), (label, run)
    assert launched == ["gp_group_scan"] * 2 * len(cases), launched
