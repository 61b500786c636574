"""The prologue, one launch a dispatch in mode general: ``K.graph_prologue``
(``csrc/graph_general.cu`` §13) in modes general and keyed against its
plain version, and in mode general against the JAX reference's
``graph_plane_step_core``.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test.  Mode
general is one cooperative launch, run in two grid shapes: blocks of up to
``LOOP_BLOCK`` = 512 threads, and with ``LOOP_BLOCK`` lowered to 64 (at
most 4 blocks of 64 threads on the emulated card, cells walked
grid-stride, several a thread).  Mode keyed is three launches of the same
install, patch and mark steps.
Each run feeds a fresh window numpy-seeded multi-key commands in shuffled
order, so a feed installs rows whose dependencies are not installed yet
(MISSING cells), patches cells of rows installed earlier and of rows it
installs itself, and marks rows executed, some of them installed by the
same feed.  Per dispatch, in each mode: the prologue equals
``graph_prologue_plain`` exactly (the folded matrix and the bad-cell
count, or the keyed column and run keys, and the state it updates in
place), and they equal a numpy fold and compression of the reference's
lines; then the whole general port step on the emulated kernels equals
the reference's (every ``GraphPlaneStep`` field, the state included).
Windows of 150 x 4 (not a power of two) and 256 x 8; some dispatches take
``resolve_general``'s fast path (count 0), most do not.

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_device_loops.py).
"""

import numpy as np
import torch

import jax.numpy as jnp

from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port
from test_torch_device_loops import jax_ref  # noqa: F401 (a fixture)

torch.set_num_threads(1)

TERMINAL, MISSING = K.TERMINAL, K.MISSING


def fresh(cap, width):
    return [np.full((cap, width), TERMINAL, np.int32)] + [
        np.zeros(cap, np.int32) for _ in range(3)
    ] + [np.zeros(cap, bool), np.zeros(cap, bool)]


def feeds(seed, cap, width, n_feeds, n_keys):
    """The feeds of one run, padded as the plane pads them (pad index
    ``cap``).  Commands take up to ``width`` keys and depend on the latest
    command of each (some links both ways: mutual edges), and arrive
    shuffled: a dependency not yet installed is a MISSING cell, patched
    when its command installs (in the same feed or a later one).  Each feed
    also marks a few pending rows executed, one of them installed by that
    feed.  The first feed is commands in index order with no mutual link,
    so its resolve takes the fast path."""
    rng = np.random.default_rng(seed)
    n = cap - 6
    keys = rng.integers(0, n_keys, (n, width))
    first = n // 4
    deps = [[] for _ in range(n)]
    last = {}
    for i, row in enumerate(keys.tolist()):
        for k in sorted(set(row)):
            prev = last.get(k)
            if prev is not None and len(deps[i]) < width:
                deps[i].append(prev)
                if prev >= first and rng.random() < 0.1 and len(deps[prev]) < width:
                    deps[prev].append(i)
            last[k] = i
    arrival = np.concatenate([np.arange(first), first + rng.permutation(n - first)])
    cuts = np.linspace(first, n, n_feeds, dtype=int)
    # the feed columns keep one shape a run (as the plane's pow2 floors do)
    ucap, pcap = n + 4, n * width
    slot_of, waiters, out = {}, {}, []
    executed = set()
    for lo, hi in zip([0, *cuts[:-1]], cuts):
        batch = arrival[lo:hi]
        u_row = np.full(ucap, cap, np.int32)
        u_deps = np.full((ucap, width), TERMINAL, np.int32)
        u_key = np.full(ucap, -1, np.int32)  # a command's first key
        u_src = np.zeros(ucap, np.int32)
        u_seq = np.zeros(ucap, np.int32)
        patches = []
        for j, c in enumerate(batch.tolist()):
            slot = c  # a slot a command, in index order
            slot_of[c] = slot
            u_row[j], u_src[j], u_seq[j] = slot, 1 + c % 5, c + 1
            u_key[j] = keys[c, 0]
            for w, d in enumerate(deps[c]):
                if d in slot_of:
                    u_deps[j, w] = slot_of[d]
                else:
                    u_deps[j, w] = MISSING
                    waiters.setdefault(d, []).append((slot, w))
            for r, w in waiters.pop(c, []):
                patches.append((r, w, slot))
        pending = [s for s in slot_of.values() if s not in executed]
        marks = [] if lo == 0 else list(
            rng.choice(pending, min(3, len(pending)), replace=False)) + [int(batch[0])]
        executed.update(marks)
        p_row = np.full(pcap, cap, np.int32)
        p_col = np.zeros(pcap, np.int32)
        p_val = np.zeros(pcap, np.int32)
        for j, (r, w, v) in enumerate(patches):
            p_row[j], p_col[j], p_val[j] = r, w, v
        e_row = np.full(8, cap, np.int32)
        e_row[: len(marks)] = marks
        out.append((u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
                    sum(r in batch for r, _w, _v in patches)))
    return out


def numpy_fold(state):
    """The reference's fold (graph_resolve.py:938-946) and the cells that
    bar resolve_general's fast path (:512-517), in numpy."""
    deps, _key, _src, _seq, occ, executed = state
    cap = deps.shape[0]
    pending = occ & ~executed
    dmat = np.where((deps >= 0) & executed[np.clip(deps, 0, cap - 1)], TERMINAL, deps)
    dmat = np.where(pending[:, None], dmat, TERMINAL).astype(np.int32)
    idx = np.arange(cap)[:, None]
    return dmat, int(((dmat > idx) | (dmat == MISSING)).sum())


def numpy_keyed(state, dmat):
    """The reference's keyed compression of the folded matrix
    (graph_resolve.py:949-962), in numpy: the first live cell of a row,
    else MISSING if any, else TERMINAL; the run key, or the private pad
    key of a slot that is not pending."""
    _deps, key, _src, _seq, occ, executed = state
    cap = dmat.shape[0]
    live = dmat >= 0
    col = dmat[np.arange(cap), live.argmax(axis=1)]
    col = np.where(live.any(axis=1), col,
                   np.where((dmat == MISSING).any(axis=1), MISSING, TERMINAL))
    pk = np.where(occ & ~executed, key, np.iinfo(np.int32).max - np.arange(cap))
    return col.astype(np.int32), pk.astype(np.int32)


def install_patch_mark(state, feed):
    """The state after the reference's lines (1)-(3), in numpy."""
    deps, key, src, seq, occ, executed = (a.copy() for a in state)
    u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row = feed
    cap, width = deps.shape
    m = u_row < cap
    for a, v in ((deps, u_deps), (key, u_key), (src, u_src), (seq, u_seq)):
        a[u_row[m]] = v[m]
    occ[u_row[m]] = True
    executed[u_row[m]] = False
    m = (p_row < cap) & (p_col < width)
    deps[p_row[m], p_col[m]] = p_val[m]
    executed[e_row[e_row < cap]] = True
    return deps, key, src, seq, occ, executed


def test_general_prologue_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    seen = {"fast": 0, "iterative": 0, "patched own rows": 0}
    with emulated():
        for form, block in (("blocks of 512", K.LOOP_BLOCK), ("blocks of 64", 64)):
            monkeypatch.setattr(K, "LOOP_BLOCK", block)
            for cap, width, n_keys in ((150, 4, 40), (256, 8, 96)):
                state = fresh(cap, width)
                mine = [torch.tensor(a) for a in state]
                for i, feed in enumerate(feeds(cap + width, cap, width, 5, n_keys)):
                    label = f"{form}, {cap} x {width}, feed {i}"
                    feed, own = feed[:-1], feed[-1]
                    seen["patched own rows"] += own
                    tf = [torch.tensor(a) for a in feed]
                    # the prologue alone in each mode, on clones of the
                    # port's state
                    got = {}
                    for general in (True, False):
                        a = [t.clone() for t in mine]
                        b = [t.clone() for t in mine]
                        before = K.LAUNCHES["graph_prologue"]
                        got[general] = K.graph_prologue(*a, *tf, general=general)
                        assert K.LAUNCHES["graph_prologue"] == before + 1, label
                        want = K.graph_prologue_plain(*b, *tf, general=general)
                        for j, (g, w) in enumerate(zip([*got[general], *a], [*want, *b])):
                            assert g.dtype == w.dtype and torch.equal(g, w), (
                                f"{label}, general={general}: output {j} differs "
                                "from the plain version")
                    after = install_patch_mark(state, feed)
                    dmat, n_bad = numpy_fold(after)
                    assert np.array_equal(got[True][0].numpy(), dmat), f"{label}: fold"
                    assert int(got[True][1][0]) == n_bad, (label, int(got[True][1][0]), n_bad)
                    for j, w in enumerate(numpy_keyed(after, dmat)):
                        assert np.array_equal(got[False][j].numpy(), w), (
                            f"{label}: keyed output {j}")
                    seen["fast" if n_bad == 0 else "iterative"] += 1
                    # the whole step on the emulated kernels against the
                    # reference's graph_plane_step_core (compiled)
                    out = port.graph_plane_step_core(*mine, *tf, mode="general")
                    theirs = ref.resolve_graph_plane_step_xla(
                        *(jnp.array(x) for x in state), *(jnp.asarray(x) for x in feed),
                        mode="general")
                    for name, g, w in zip(out._fields, out, theirs):
                        w = np.asarray(w)
                        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), (
                            f"{label}: step field {name} differs from the reference")
                    for j, (g, w) in enumerate(zip(out[:6], after)):
                        if j == 5:  # the step also executes what it resolved
                            w = w | out.newly.numpy()
                        assert np.array_equal(g.numpy(), w), (label, j)
                    state = [np.asarray(x) for x in theirs[:6]]
                    mine = list(out[:6])
    assert all(seen.values()), seen
