"""General dispatches of the device graph plane on the emulated kernels,
dispatch by dispatch against the JAX plane.

The port's ``BatchedDependencyGraph`` on its plane (``device="cpu"``)
runs inside ``emulated()`` (``csrc/emu/emulate.py``), so the wrappers of a
general dispatch launch their CUDA sources on the emulator: the one-launch
prologue and mutual collapse, the affine loop and the epilogue.  The sort
takes its plain version here: its emulated one-block radix sort takes
seconds a call, and tests/test_torch_sort_kernels.py holds it.
The JAX package's plane takes the same feeds: multi-key commands from three
processes, a dependency on the latest command of each key in one direction
or both (mutual edges, and directed cycles with no mutual edge that the
host oracle finishes), arriving shuffled in feeds of 1-40 (MISSING cells
patched by later feeds) into a window shrunk to 256 rows, so the plane
also compacts.  Every dispatch — primary and stuck follow-up — must take
the JAX plane's mode (``general``, or ``keyed`` when a compaction left no
multi-key row) and give the same ``order``, ``newly``, ``stuck`` and
``leader``; emission, per-key order and the resident state must agree feed
by feed.  Run twice: with the collapse's and the affine loop's one-CTA
forms (the default ``CTA_ROWS``) and, with the gate lowered to 0 and
``LOOP_BLOCK`` to 64, their cooperative forms (the prologue is always
cooperative).

One collected item on purpose (ROADMAP.md Queue C); reference calls run
under ``jax_ref`` (tests/test_torch_device_loops.py).
"""

import numpy as np
import torch

import fantoch_tpu.core as jcore
import fantoch_tpu.protocol.common.graph_deps as jdeps
from fantoch_tpu.executor.base import ExecutorMetricsKind as JKind
from fantoch_tpu.executor.graph import batched as jbatched
from fantoch_tpu.executor.graph import graph_plane as jplane
import fantoch_tpu_torch.core as tcore
import fantoch_tpu_torch.protocol.common.graph_deps as tdeps
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.executor.base import ExecutorMetricsKind as TKind
from fantoch_tpu_torch.executor.graph import batched as tbatched
from fantoch_tpu_torch.executor.graph import graph_plane as tplane
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from test_torch_device_loops import jax_ref  # noqa: F401 (a fixture)
from test_torch_graph_plane_general import _compare_planes, _shrink, _Side

torch.set_num_threads(1)

WINDOW = 256


def commands(seed, n=360, n_keys=12):
    """(dot, keys, dep dots) in arrival order: two keys a command from
    ``n_keys``; consecutive commands on a key within a window of 24 are
    linked backward (60%), forward (20%) or both ways (20%); arrival
    shuffled within those windows."""
    rng = np.random.default_rng(seed)
    dots = [(1 + i % 3, 1 + i // 3) for i in range(n)]
    keys = [sorted({f"k{k}" for k in rng.integers(0, n_keys, 2)}) for _ in range(n)]
    deps = [set() for _ in range(n)]
    last = {}
    for i in range(n):
        if i % 24 == 0:  # links stay inside the shuffle windows
            last = {}
        for k in keys[i]:
            prev = last.get(k)
            if prev is not None:
                c = int(rng.choice(3, p=(0.6, 0.2, 0.2)))
                if c in (0, 2):
                    deps[i].add(dots[prev])
                if c in (1, 2):
                    deps[prev].add(dots[i])
            last[k] = i
    order = np.arange(n)
    for s in range(0, n, 24):
        rng.shuffle(order[s : s + 24])
    return [(dots[i], keys[i], deps[i]) for i in order.tolist()]


def feeds(seed):
    rng = np.random.default_rng(seed + 1)
    rows, out, at = commands(seed), [], 0
    while at < len(rows):
        size = int(rng.integers(1, 41))
        out.append(rows[at : at + size])
        at += size
    return out


def _record(monkeypatch, log):
    """Each package's dispatches: (mode, order, newly, stuck, leader)."""
    for name, mod in (("jax", jplane), ("port", tplane)):
        real = mod.DeviceGraphPlane._dispatch_raw

        def dispatch(self, *args, _real=real, _log=log[name], **kwargs):
            res = _real(self, *args, **kwargs)  # (out, mode, ...)
            out, mode = res[:2]
            _log.append((mode, *(np.array(x) for x in (
                out.order, out.newly, out.stuck, out.leader))))
            return res

        monkeypatch.setattr(mod.DeviceGraphPlane, "_dispatch_raw", dispatch)


def test_general_dispatches_on_emulated_kernels_match_jax(jax_ref, monkeypatch):
    log = {"jax": [], "port": []}
    _record(monkeypatch, log)
    seen = {"stuck": 0, "compactions": 0, "general": 0}
    monkeypatch.setattr(K, "lex_sort", K.lex_sort_plain)
    with emulated():
        for form, gate in (("one CTA", None), ("cooperative", 0)):
            if gate is not None:
                monkeypatch.setattr(K, "CTA_ROWS", gate)
                monkeypatch.setattr(K, "LOOP_BLOCK", 64)
            ref = _Side(jcore, jbatched, jdeps, JKind)
            mine = _Side(tcore, tbatched, tdeps, TKind, device="cpu")
            for side in (ref, mine):
                _shrink(side.graph._plane, WINDOW)
            for name in log:
                log[name].clear()
            K.reset_launch_counts()
            for i, feed in enumerate(feeds(17)):
                case = f"{form}, feed {i}"
                before = len(log["jax"])
                assert mine.feed(feed) == ref.feed(feed), f"{case}: emission"
                assert len(log["port"]) == len(log["jax"]) > before, case
                for j in range(before, len(log["jax"])):
                    theirs, ours = log["jax"][j], log["port"][j]
                    assert ours[0] == theirs[0], (case, ours[0], theirs[0])
                    seen["general"] += ours[0] == "general"
                    for field, g, w in zip(("order", "newly", "stuck", "leader"),
                                           ours[1:], theirs[1:]):
                        assert g.dtype == w.dtype and np.array_equal(g, w), (
                            f"{case}, dispatch {j}: {field} differs")
                    seen["stuck"] += int(ours[3].sum())
                _compare_planes(case, ref, mine)
            assert mine.order == ref.order, f"{form}: per-key order differs"
            assert sum(len(set(v)) for v in mine.order.values()) > 0
            seen["compactions"] += mine.graph._plane.stats["compactions"]
            # every dispatch one prologue launch and one epilogue launch,
            # every iterative resolve one collapse and one affine launch
            dispatches = len(log["port"])
            assert K.LAUNCHES["graph_prologue"] == dispatches == K.LAUNCHES["plane_epilogue"]
            assert K.LAUNCHES["mutual_collapse"] == K.LAUNCHES["affine_loop"] > 0
    assert all(seen.values()), seen
