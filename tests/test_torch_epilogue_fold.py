"""The plane's epilogue folded into the launch that makes each branch's
resolved flags, on the emulated kernels, dispatch by dispatch against the
plain route and the JAX reference.

``resolve_graph_plane_step`` runs inside ``emulated()``
(``csrc/emu/emulate.py``): every wrapper launches its CUDA source on the
emulator, except the sort, which takes its plain version (its emulated
radix sort takes seconds a call; tests/test_torch_sort_kernels.py holds
it).  ``K.LOOP_BLOCK`` is lowered to 64, so a cooperative launch is at most
4 blocks of 64 threads on the mock card.  Windows of 256-1,024 rows, numpy
seeded (``_FeedMaker``), in every branch of the step:

* (a) keyed, every link verified: the epilogue's own launch;
* (b) keyed, the residual overflows: folded into the full-window
  ``pointer_doubling``;
* (c) keyed residual: folded into ``emit_scatter``'s two launches;
* (d) general fast path: the epilogue's own launch, no flags;
* (e) general, iterative: folded into ``affine_loop``, one CTA and (with
  ``K.CTA_ROWS`` = 0) cooperative;
* (f) general_resident: folded into the terminal ``peel_compact`` publish.

Before each dispatch ``executed`` is set on some occupied rows and on some
free rows, so that ``pending`` masks.  Each dispatch (all ten fields of
``GraphPlaneStep``, the state included) must equal the same dispatch on the
plain route (CPU tensors outside ``emulated()``) and the reference's
``resolve_graph_plane_step`` (``fantoch_tpu/ops/graph_resolve.py:1027``);
its branch is read from the launch counts, and the epilogue must launch on
its own only in (a) and (d), once, and be folded once elsewhere.
Tolerance: exact; the work is integers.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_device_loops.py: tolerant duration
listeners, the persistent compile cache off).
"""

import numpy as np
import torch

import jax.numpy as jnp

from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port
from test_torch_device_loops import jax_ref  # noqa: F401 (a fixture)
from test_torch_graph_resolve import _FeedMaker, _fresh

torch.set_num_threads(1)

WIDTH = 4
# (label, mode, feed kind, window rows, U, P, E, feeds, affine gate)
CASES = (
    ("keyed chains", "keyed", "chains", 512, 128, 32, 8, 3, None),
    ("keyed shuffled, windows of 8", "keyed", "shuffled", 1024, 256, 256, 8, 4, None),
    ("keyed shuffled, small residual", "keyed", "shuffled", 256, 64, 64, 8, 4, None),
    ("general chains", "general", "chains", 256, 64, 16, 8, 2, None),
    ("general random, one CTA", "general", "random", 256, 64, 16, 8, 4, None),
    ("general random, cooperative", "general", "random", 256, 64, 16, 8, 3, 0),
    ("general_resident random", "general_resident", "random", 256, 64, 16, 8, 3, None),
)
FOLDING = {"pointer_doubling": "b", "emit_scatter": "c", "affine_loop": "e",
           "peel_compact": "f"}


def _mark(rng, state):
    """``executed`` set on a few occupied rows and a few free rows."""
    occ, executed = state[4], state[5].copy()
    for rows in (np.flatnonzero(occ), np.flatnonzero(~occ)):
        if len(rows):
            executed[rng.choice(rows, max(len(rows) // 16, 1), replace=False)] = True
    return (*state[:5], executed)


def _branch(mode, before, folds_before):
    """The branch of one dispatch from the counts it raised; asserts the
    epilogue ran once, on its own or folded."""
    own = K.LAUNCHES["plane_epilogue"] - before
    folded = {name: K.EPILOGUE_FOLDS[name] - folds_before[name] for name in FOLDING}
    assert own + sum(folded.values()) == 1, (own, folded)
    if own:
        return "a" if mode == "keyed" else "d"
    return next(FOLDING[name] for name, n in folded.items() if n)


def test_epilogue_folded_on_emulated_kernels_matches_plain_and_reference(
        jax_ref, monkeypatch):
    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    monkeypatch.setattr(K, "lex_sort", K.lex_sort_plain)
    rng = np.random.default_rng(91)
    seen = {b: 0 for b in "abcdef"}
    forms = set()
    for label, mode, kind, cap, U, P, E, n_feeds, gate in CASES:
        monkeypatch.setattr(K, "CTA_ROWS", 2048 if gate is None else gate)
        maker = _FeedMaker(kind, cap, WIDTH, U, P, E, seed=cap + len(label))
        state = _fresh(cap, WIDTH)
        for feed_i in range(n_feeds):
            feed = maker.next(state, feed_i)
            state = _mark(rng, state)
            want = [np.asarray(x) for x in ref.resolve_graph_plane_step(
                *(jnp.array(a) for a in state), *(jnp.asarray(a) for a in feed),
                mode=mode)]
            plain = port.resolve_graph_plane_step(
                *(torch.tensor(a) for a in (*state, *feed)), mode=mode)
            before = K.LAUNCHES["plane_epilogue"]
            folds_before = dict(K.EPILOGUE_FOLDS)
            with emulated():
                got = port.resolve_graph_plane_step(
                    *(torch.tensor(a) for a in (*state, *feed)), mode=mode)
            branch = _branch(mode, before, folds_before)
            seen[branch] += 1
            if branch == "e":
                forms.add(gate)
            case = f"{label}, feed {feed_i}, branch ({branch})"
            for field, g, p, w in zip(got._fields, got, plain, want):
                assert g.dtype == p.dtype and torch.equal(g, p), (case, field, "plain")
                assert np.array_equal(g.numpy(), w), (case, field, "reference")
            state = tuple(want[:6])
    assert all(seen.values()), seen
    assert forms == {None, 0}, forms
