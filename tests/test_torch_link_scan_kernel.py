"""``link_scan`` as one launch (``csrc/graph_plane_step.cu`` §3) against its
plain version, a numpy walk over the rows and the JAX reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test, in both
forms: one block walking the tiles in order (the gate ``K.LINK_CTA_ROWS``
raised) and a block a tile carrying the aggregate by decoupled look-back
(the gate lowered to 0).  Every call runs twice in a row on the same
inputs, so a status flag or ticket left by the call before would show.
The numpy-seeded inputs are the cases ``chip_smoke.py`` phase 10 holds on
the card: n = 1 (a TERMINAL head, a MISSING head), 2 and 3,001 rows; the
tile's size and twice it, each +-1; every row on one key (every link
verifying, then bad links on the first rows of the second and third
tiles); every row its own key with half the heads TERMINAL; a run across
three tiles among other keys with a bad link on a tile's first row; and
the north-star workload with its arrival shuffled in windows (links that
fail, a residual).  Each output must equal ``link_scan_plain`` and a numpy
walk over the sorted rows (run heads, links, the first bad link of each
run); the reference's ``resolve_functional_keyed``
(``fantoch_tpu/ops/graph_resolve.py:210``) must equal the port's on the
emulated scan (the other stages on their plain versions) field by field.
Tolerance: exact; the work is integers.

The emulator runs the blocks of a launch that is not cooperative one after
another, so a tile's look-back always finds its predecessor's prefix
published: it cannot show a race between tiles (a flag read before its
values land, a ticket taken out of order).  ``chip_smoke.py`` phase 10
replays every call on the card for that.

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

TERMINAL, MISSING = K.TERMINAL, K.MISSING
TILE = K.LINK_TILE


def chain(rng, n, keys, missing=0.0):
    """``n`` commands on ``keys`` keys, each depending on the key's previous
    command (TERMINAL for the first), a fraction ``missing`` then MISSING."""
    key = rng.integers(0, keys, n)
    dep = np.full(n, TERMINAL)
    last = {}
    for i, k in enumerate(key.tolist()):
        dep[i] = last.get(k, TERMINAL)
        last[k] = i
    return key, np.where(rng.random(n) < missing, MISSING, dep)


def cases(rng):
    """(name, key, dep): the key and dependency column of each row."""
    out = [("n = 1, a TERMINAL head", [7], [TERMINAL]),
           ("n = 1, a MISSING head", [7], [MISSING]),
           ("n = 2, one chain", [3, 3], [TERMINAL, 0]),
           ("n = 2, a bad link", [3, 3], [TERMINAL, MISSING])]
    for n in (3001, TILE - 1, TILE, TILE + 1, 2 * TILE - 1, 2 * TILE + 1):
        out.append((f"n = {n}, 64 keys, 1% MISSING", *chain(rng, n, 64, 0.01)))
    n = 3 * TILE + 5
    links = np.arange(n) - 1
    out.append(("one key, every link verifies", np.zeros(n), links))
    broken = links.copy()
    broken[[TILE, 2 * TILE]] = MISSING
    out.append(("one key, bad links on the first rows of tiles 2 and 3", np.zeros(n),
                broken))
    n = 3 * TILE + 7
    out.append(("every row its own key, half the heads TERMINAL", rng.permutation(n),
                np.where(rng.random(n) < 0.5, TERMINAL, MISSING)))
    # key 1 holds rows [TILE - 100, 3 TILE + 100): a run across three tiles
    n = 4 * TILE
    i = np.arange(n)
    key = np.where(i < TILE - 100, 0, np.where(i < 3 * TILE + 100, 1, 2))
    dep = i - 1
    dep[[0, TILE - 100, 3 * TILE + 100]] = TERMINAL
    dep[2 * TILE] = 5  # not the previous row: tile 3's first row breaks the run
    out.append(("a run across tiles 1-3, a bad link on tile 3's first row", key, dep))
    key, dep, _src, _seq = chip_smoke.build_workload(5000, 0.5, clients=64, seed=3)
    order = chip_smoke.arrival(5000, 5000, 5000, 16, 3)
    row = np.empty(5000, np.int64)
    row[order] = np.arange(5000)
    dep = dep[order]
    out.append(("the workload, arrival shuffled in windows of 16", key[order],
                np.where(dep >= 0, row[np.maximum(dep, 0)], TERMINAL)))
    return [(name, np.asarray(k, np.int32), np.asarray(d, np.int32)) for name, k, d in out]


def walk(key, dep, pos):
    """The four outputs by a walk over the sorted rows: a run's rows are
    chain_ok up to its first bad link (a head whose dependency is not
    TERMINAL, or a row whose dependency is not the row before it)."""
    n = len(key)
    dep_s = dep[pos]
    run_start = np.zeros(n, np.int32)
    chain_ok = np.zeros(n, bool)
    head_at, broken = 0, False
    for p in range(n):
        head = p == 0 or key[pos[p]] != key[pos[p - 1]]
        if head:
            head_at, broken = p, dep_s[p] != TERMINAL
        elif dep_s[p] != pos[p - 1]:
            broken = True
        run_start[p] = head_at
        chain_ok[p] = not broken
    return dep_s, run_start, chain_ok, np.array([n - chain_ok.sum()], np.int32)


# the cases also resolved through the reference: (name, residual size)
RESOLVED = {"n = 3001, 64 keys, 1% MISSING": 512,
            "one key, bad links on the first rows of tiles 2 and 3": 8192,
            "a run across tiles 1-3, a bad link on tile 3's first row": 8192,
            "the workload, arrival shuffled in windows of 16": 1024}


def test_link_scan_kernel_matches_plain_walk_and_reference(jax_ref, monkeypatch):
    rng = np.random.default_rng(61)
    inputs = cases(rng)
    assert set(RESOLVED) <= {name for name, _k, _d in inputs}
    # the other stages of the keyed resolve on their plain versions
    for name in ("lex_sort", "residual_view", "group_scan", "pointer_doubling",
                 "emit_scatter"):
        monkeypatch.setattr(K, name, getattr(K, f"{name}_plain"))
    launched = []
    real_launch = K._launch

    def launch(fn, *args):
        if fn == "gp_link_scan":
            launched.append(args[-1])  # the one-block flag
        return real_launch(fn, *args)

    monkeypatch.setattr(K, "_launch", launch)
    residual, resolved = [], 0
    with emulated():
        for form, gate in (("one block", 1 << 30), ("tiles", 0)):
            monkeypatch.setattr(K, "LINK_CTA_ROWS", gate)
            for name, key, dep in inputs:
                what = f"{form}, {name}"
                pos = np.argsort(key, kind="stable").astype(np.int32)
                args = [torch.tensor(a) for a in (key, dep, pos)]
                want = K.link_scan_plain(*args)
                walked = walk(key, dep, pos)
                for run in range(2):
                    got = K.link_scan(*args)
                    for i, (g, w, v) in enumerate(zip(got, want, walked)):
                        assert g.dtype == w.dtype and torch.equal(g, w), (what, run, i)
                        assert np.array_equal(g.numpy(), v), (what, run, i)
                residual.append(int(want[3]))
                if name in RESOLVED and form == "tiles":
                    size = RESOLVED[name]
                    src = (1 + np.arange(len(key)) % 5).astype(np.int32)
                    seq = np.arange(len(key), dtype=np.int32)
                    got = port.resolve_functional_keyed(
                        *(torch.tensor(a) for a in (key, dep, src, seq)), residual_size=size)
                    want_ref = ref.resolve_functional_keyed(
                        *(jnp.asarray(a) for a in (key, dep, src, seq)), residual_size=size,
                        return_structure=False)
                    for field, g, w in zip(got._fields, got, want_ref):
                        assert np.array_equal(g.numpy(), np.asarray(w)), (what, field)
                    resolved += 1
    assert resolved == len(RESOLVED)
    # two calls a case and form, and one a resolve, one launch each; the
    # forms as asked
    assert launched == [1] * 2 * len(inputs) + [0] * (2 * len(inputs) + resolved), launched
    # the cases reach what they claim: chains that verify, residuals
    assert residual[:len(inputs)] == residual[len(inputs):]
    counts = dict(zip((name for name, _k, _d in inputs), residual))
    assert counts["one key, every link verifies"] == 0
    assert counts["one key, bad links on the first rows of tiles 2 and 3"] == 2 * TILE + 5
    assert counts["n = 1, a MISSING head"] == 1 and counts["n = 2, a bad link"] == 1
    assert counts["a run across tiles 1-3, a bad link on tile 3's first row"] == TILE + 100
