#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and drive it on one H100.

    python3 chip_smoke.py        (from the repository root, on a CUDA machine)

Phases (any failure raises and exits non-zero; nothing is caught):

0. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``fantoch_tpu_torch/csrc`` (nvcc, sm_90a);
1. every kernel against its plain PyTorch version on the card, exactly,
   at the main path's shapes: the north-star workload (1M single-key
   commands, 50% on one hot key, 4096 clients, seed 42) fed to a device
   graph plane of C = 2^20 slots x W = 4 as 4 feeds of 2^18 — once in
   arrival order (every link verifies), once with commits shuffled in
   windows around the feed boundaries (MISSING cells, patches in the next
   feed, a residual) — and once at C = 2^16 shuffled throughout, so the
   residual overflows into full-window pointer doubling.  Each whole
   dispatch is also held against the plain composition on CPU tensors;
   each kernel is timed (CUDA events) beside its plain version, its
   byte bound and, for the sort, ``torch.sort`` as a yardstick — the sort
   at each of its uses (key grouping, cflag compaction, the 4-key
   overflow order, the 6-key emit order, the packed final sort);
2. the main path end to end: ``GraphExecutor(Config(batched_graph_executor
   =True, device_graph_plane=True))`` on ``cuda`` takes the same 1M
   commands as ``GraphAddBatch`` feeds of 250k, first in arrival order
   (with nothing resident and every dependency behind it, each feed takes
   the batched graph's host fast path: no dispatch, reported, not
   required), then shuffled around the feed boundaries — the run that
   reaches the plane and its kernels; every command executes exactly
   once, each key in its dependency-chain order, every dispatch went
   through the kernels (prologue launches == plane dispatches == epilogues,
   folded into the launch that makes the flags or launched alone) and the
   plane stayed healthy;
3. the general modes' kernels against their plain versions on the card,
   exactly: mode ``general`` at its largest shape on the path (C = 4096
   slots x W = 4) over a multi-key feed permuted within each feed of 1024
   and a cycle-rich feed
   (mutual collapse, affine rounds and the stuck-cycle host-oracle
   follow-up all run; each dispatch is also held against the plain
   composition on CPU tensors), and mode ``general_resident`` at full
   width (C = 2^20 x W = 4): 2^20 commands of ``bench.py``'s general
   generator (seed 7, 4 keys per command from 4096) as 4 feeds of 2^18,
   shuffled around the feed edges as in phase 1; then ``resolve_general``
   itself on 2^16 rows, above mode general's window; each kernel is timed
   beside its plain version and its byte bound (the loops as one call and
   as the mean of 100, with their rounds; the widest peel stage also run
   to its fixpoint), with the rounds per resolve and per stage (the loop
   kernels' own device counts) and the host reads inside each step; then
   the affine loop's two forms (one CTA up to ``CTA_ROWS`` = 2,048
   rows, cooperative above) on the same resolve at 256-4,096 rows;
4. the general path end to end: ``GraphExecutor`` on ``cuda`` takes the
   2^20 multi-key commands as ``GraphAddBatch`` feeds of 250k, shuffled
   around the feed edges (every command once, each key in dependency
   order; commands/s, the p50 and range of the dispatch time and the host
   reads inside each step, by mode), then EPaxos and Atlas
   (n = 5, f = 2, two keys per command, 50% conflict) through
   ``sim.runner.Runner(device="cuda")`` must equal the same seed's
   ``Runner(device="cpu")`` run in per-key orders and latency histograms;
   every general kernel must have launched in this phase, the affine loop
   once a resolve and the peel stage once a stage, an epilogue (folded or
   alone) once a dispatch; both affine forms are timed at the sims' own
   shapes;
4b. the general chain at the sims' shapes, in a process of its own: the
   sims' first dispatch at 1,024 x 4 and at 1,024 x 8 that is not the
   fast path (captured from
   ``Runner(device="cpu")``), each launch of it (the prologue's general
   fold, ``mutual_collapse``, ``affine_loop`` with the plane's epilogue
   folded in, the 4-key ``lex_sort``) and the whole dispatch held against
   the plain versions, timed single and in the loop beside the byte bound,
   and counted in operations on the card by ``torch.profiler``: one a call
   for ``mutual_collapse`` and the general prologue, one a wrapper and the
   read of the fast-path count for the dispatch, none of them the
   epilogue's; ``mutual_collapse`` also at 4,096
   x 4 and 2^16 x 4, the prologue in modes general and keyed at 4,096 and
   2^20 slots, both forms of ``mutual_collapse`` (one CTA, cooperative)
   over 256-4,096 rows (single, loop and on the card), and an empty
   kernel's launch, the one-launch floor;
5. the votes-table kernels (``csrc/table_plane.cu``) against their plain
   versions on the card, exactly, flags and counts included, each timed
   beside its plain version, its byte bound and the one PyTorch call that
   computes the same function where there is one: ``vote_runs`` and
   ``stable_rows`` at ``bench.py``'s table shape (K = 8192 key buckets,
   n = 3, V = 2^19: a round of 100,000 commands on 4,096 keys voted by
   three processes, padded), contiguous and with gaps that leave residual
   runs, and at K = 2^20, n = 5, V = 2^20; ``clock_proposal`` at
   B = 2^17 over K = 8192 with half the commands on one key;
   ``clock_bump``; the table round (``fused_table_round``) and an S = 8
   ``fused_table_rounds`` chain at ``bench.py``'s fused-round shape
   (B = 2^17, K = 8192, n = 3), the chain also against the plain
   composition on CPU tensors;
6. the Newt path on the card: ``BatchedKeyClocks.proposal_batch_arrays``
   and ``TableExecutor.handle_batch_arrays`` on the votes-table plane, as
   ``bench.py``'s steady rounds (100,000 single-key commands a round on
   4,096 keys, n = 3, one warm and three timed rounds) with scalar clock
   bumps between rounds (their detached votes ride the next round): every
   command drains once, in the same per-key order as the same rounds on
   ``cpu``; then Newt through ``Runner(device="cuda")`` equal to
   ``Runner(device="cpu")`` at n = 5, f = 2; every table kernel launched
   on this path and the 31-bit-window fallback was taken 0 times;
7. the predecessors-plane kernel (``csrc/pred_plane.cu``) against its
   plain version on the card, exactly, every dispatch of three
   ``DevicePredPlane``s held by the Checker: ``bench.py``'s
   ``bench_pred_path`` generator (one uniform key per command, up to three
   same-key lower-clock predecessors, the cross-feed residual seam) at its
   own defaults (feeds of 4,096 on 512 keys, C = 8,192), at the table
   path's round (feeds of 100,000 on 4,096 keys) and in a full window of
   2^20 slots filled by 4 feeds of 2^18, all three above the one-CTA
   form's 2,048 rows (the Caesar sim's dispatches take that form: phases
   8-9); each shape's last dispatch timed beside the plain version and its
   byte bound, with its work (rows the propagation marked, and pushed
   onto its worklist);
8. the Caesar path on the card: 2 warm and 3 timed steady feeds of
   100,000 commands through ``DevicePredPlane(device="cuda").add_arrays``,
   each key in the host ``PredecessorsGraph`` twin's order (commands/s and
   the plane's ``kernel_ms``); then Caesar through
   ``Runner(device="cuda")`` with ``device_pred_plane=True`` equal to
   ``Runner(device="cpu")`` at n = 5, f = 2, each path with the launch
   counts set to 0 just before it and read just after it;
9. the two kernels redesigned last at every shape their paths give them,
   each call held against its plain version, timed single (and
   ``vote_runs`` in the loop) beside its bound and counted in operations
   on the card by ``torch.profiler``: ``vote_runs`` at the Newt sim's
   shapes (its calls captured from ``Runner(device="cpu")``, the first at
   each row count), at phase 5's V = 2^19, on commits whose merged group
   crosses tile boundaries under a negative ``frontier[0, 0]`` (2,048 and
   2^19 rows), and in both forms (one CTA, tiles) over 256-4,096 rows;
   ``pred_plane_step`` at the Caesar sim's shapes (captured the same way),
   at phase 7's three shapes and on a hot-key feed (4,096 commands on one
   key, C = 2^16, the grid form), every dispatch of phase 7's first two
   shapes replayed 50 times against the plain version (a race between
   the grid's blocks shows in some run), and both forms of each kernel
   over a sweep of sizes; it asserts at most 3 operations on the card
   after ``vote_runs``' sort (3 in all up to 2,048 rows), one a
   ``pred_plane_step`` dispatch, and the dispatch's marked rows equal to
   its ``newly`` rows;
10. the two kernels redesigned last, in a process of its own as phase 9:
   ``link_scan`` at the sims' calls (EPaxos and Atlas through
   ``Runner(device="cpu")``, captured), at 2^20 rows (the north-star
   workload in one window) and on edge cases (n = 1, 2 and 3,001, the
   tile's size and twice it +-1, one key across tiles with bad links on
   tiles' first rows, every row its own key, a run across tiles), in both
   forms (one block, tiles) over 256-4,096 rows; ``peel_compact`` at every
   call of phase 4's ``general_resident`` dispatches (``GraphExecutor`` on
   the card, captured: init, compactions, terminal publish), at a 2^20 x 4
   resolve and on a compaction that closes the publish gate; every call held
   against its plain version and replayed 50 times, timed single and in
   the loop beside its bound and counted in operations on the card: one a
   ``link_scan`` call, an init and a publish, at most two a compaction,
   none a memset or fill (asserted).  Also the one-block ``lex_sort`` at
   4,096 rows beside ``torch.sort`` and ``stable_rows`` at the Newt sim's
   shape beside ``kthvalue``;
11. the two kernels redesigned last, in a process of its own as phases 9
   and 10: ``pointer_doubling`` at every call of phase 2's shuffled run
   (``GraphExecutor`` on the card, each dispatch's branch, fast path,
   residual or overflow, and time recorded: the keyed p50), at phase 1's
   three cases' calls, at 2^20 (the north-star window) and on edge cases
   (n = 1, 2, 3 and 3,001, every gate +-1, the functional-graph kinds:
   all TERMINAL, all MISSING, MISSING mid-chain, self-loops, 2-cycles,
   one cycle through every row, tails into short cycles, a random graph,
   chains whose ids rise and fall, a 2^19-row hot-key chain with one
   break), and in both forms (one block, cooperative) over 2^10 to 2^20
   rows; ``clock_proposal`` at phase 5's call, at phase 6's (the
   steady rounds and the fused chain, captured) and on edge cases (B = 1,
   every tile and gate size +-1, one key, a key a row, clocks that wrap,
   ``min_clock`` above and below ``prior + 1``), each call's operations
   split into its sort's and the rest, and in both forms (one block,
   tiles) over 256-8,192 rows; every call held against its plain version
   and replayed 50 times, timed single and in the loop beside its bound
   and counted in operations on the card: one a ``pointer_doubling``
   call, at most 2 after a ``clock_proposal``'s sort, none of them a
   memset or fill (asserted).
   Also the operations and device time of ``residual_view``,
   ``group_scan``, ``emit_scatter``, ``plane_epilogue`` (2^20 and the
   sims' 1,024) and ``clock_bump`` at their paths' shapes, and the Newt
   steady round and the fused chain as phase 6 times them;
12. the plane's epilogue folded into the launch that makes each branch's
   resolved flags, and ``group_scan`` as one launch, in a process of its
   own as phases 9-11: every dispatch of phase 2's shuffled run, of phase
   4's ``general_resident`` run (``GraphExecutor`` on the card) and of
   phase 4's EPaxos and Atlas sims (captured on ``cpu``) with its branch
   (a: keyed, every link verified; b: keyed overflow; c: keyed residual;
   d: the general fast path; e: general, iterative; f:
   ``general_resident``), held on the card against the plain route (the
   plain resolver, then ``plane_epilogue_plain``) on all ten fields and
   replayed 50 times; every folded launch held against its plain version
   without the fold followed by ``plane_epilogue_plain``; the folding
   wrappers' first calls timed with and without the fold; the first 3
   dispatches of each run and branch timed and counted on the card; the
   ``plane_epilogue`` launches of phases 2 and 4 counted; ``group_scan``
   at phase 2's calls, a 2^16-row residual and edge cases (one group, one
   row a group, n_residual = 0, 1, m - 1 and m, groups across the
   256-thread blocks), against its plain version and the reference's
   formula in numpy, replayed 50 times, timed beside its bound; asserted:
   no epilogue operation in a dispatch of b, c, e or f, one in a and d, 0
   standalone epilogue launches in phase 2 and at most 86 in phase 4, one
   operation a ``group_scan`` call and no memset or fill;
13. ``residual_view`` with no remap fill and ``emit_scatter`` with its
   folded epilogue streamed in vertex order, in a process of its own as
   phases 9-12: both at phase 2's residual calls (its run captured on the
   card; the emit folded and unfolded), at 2^20 rows with a residual of
   65,536 (the plane step's buffer there) and on edge cases (n_residual
   = 1, = res_n and > res_n, the last unfolded; deps leaving the residual
   and going into another tail; 4,094 rows; a window then the same keys
   with a tail healed and a dep into a row that was residual in the call
   before, so that a stale remap entry would show); every call held
   against its plain version, ``executed`` included, and replayed 50
   times, timed single and in the loop beside the bytes the function
   itself needs, and counted in operations on the card, and so is phase
   2's residual dispatch; asserted: at most 2 operations a call of either
   wrapper, none a memset or fill, and folded calls that reach unresolved
   residual vertices that are pending, executed and free;
14. the batched graph executor's host-column route (``GraphExecutor(Config(
   batched_graph_executor=True))``, the plane off, on ``cuda``), partial
   replication, in a process of its own as phases 9-13.
   The route's path, with the launch counts set to 0 just before it and
   read just after it: the north-star commands as ``GraphAddBatch``
   feeds of 250k, the first 2^18 in arrival order (each flush of more than
   4,096 the arrival-order fast path) and all 1M shuffled around the feed
   edges (phase 2's feeds), 2^16 of
   them shuffled throughout in one feed (a residual past
   ``_residual_size_for``: the overflow branch), 2^20 commands of
   ``bench.py``'s general generator through ``resolve_general_resident``,
   and 4,096
   cycle-rich ones in feeds of 1,024 (``resolve_general`` and the stuck
   residues' Python oracle); every command once, each key in its chain
   order, and every wrapper of the route launched.  Each flush's route
   (fast path, keyed verified, residual or overflow, general,
   general_resident), the wrappers it launched, its time
   and its resolve's on the card (CUDA events) and on the host, and
   commands/s are printed.
   Then six feeds at 2^16 and at 4,096 rows (the structure branch), keyed
   and multi-key, on ``cuda`` and on ``cpu``: equal execution orders and
   CHAIN_SIZE histograms, every wrapper call on the card held against its
   plain version (the Checker), and the full-width keyed run again under
   the Checker; the native route (``host_native_resolver=
   True``) against the device route at 2^16, per key; Atlas with two
   shards (n = 3, f = 1) through a message loop in the script on ``cuda``
   and ``cpu``, every process's order equal.  (FPaxos and Basic run no
   code on the card: their executors keep nothing there, so the CPU tests
   hold them.)
15. the observability plane and the device-fault injector, in a process
   of its own as phases 9-14: (d) first, ``capture_device_profile`` for
   200 ms (a ``torch.profiler`` session, CPU and CUDA) over graph-plane
   dispatches on the card, its Chrome trace naming the graph kernels;
   (a) EPaxos at phase 4's sim shape through ``Runner(device="cuda")``
   with the span log at rate 1.0, the flight recorder and the series: the
   span log, the series, the flight dumps, the critical path and the
   Perfetto JSON equal to the same seed's ``Runner(device="cpu")`` run
   (no field excluded: the sim writes no wall-clock value), its graph
   wrappers' launches counted (``launches_by_path["observed_sim"]``);
   (b) a hang and a corrupt (``plane_shadow_rate`` 1.0) at dispatch 3 of
   p1's graph, table and pred plane, each in the shortest EPaxos, Newt and
   Caesar sim (four commands a client): the typed error at that dispatch
   (``DeviceCorruptionError`` naming row 0), nothing launched after a hang
   was detected, one flight dump a process whose reason names the plane,
   the ``device-<kind>`` and ``device-failover`` nemesis lines; (c) the
   table and pred planes at 2^10 and 2^16 slots, then the build audit
   (every ``csrc`` library built at most once and loaded once in the
   process) and the device counters of the sweep (a graph plane fed
   chains too: CUDA-event device ms of every plane above 0,
   ``device_idle_frac`` in [0, 1]); the traced cuda sim's own device
   counters are printed with it.

Each phase reports its wall time.  The last lines are the
``{"kernels": [...]}`` record, the card line and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --general-chain

builds the two graph sources and runs phase 4b alone, without its asserts
(with ``--checks``, with them: the whole smoke runs phase 4b so, in a
process of its own, as phases 9-12: in the main process, after phases
1-4, its profiler sessions lost events), then prints the card line;
copied into an older checkout it times that checkout's kernels at the
same shapes.

    python3 chip_smoke.py --redesign

builds the graph-plane sort, the table and the pred sources and runs
phase 9 alone, without its asserts (with ``--checks``, with them: the
whole smoke runs phase 9 so, in a process of its own), then prints the
card line; copied into an older checkout it times that checkout's
``vote_runs`` and ``pred_plane_step`` at the same shapes.

    python3 chip_smoke.py --scans

builds the graph and table sources and runs phase 10 alone, as
``--redesign`` runs phase 9 (``--checks`` adds its asserts); copied into
an older checkout it times that checkout's ``link_scan`` and
``peel_compact`` at the same shapes.

    python3 chip_smoke.py --doubling

runs phase 11 alone in the same way; copied into an older checkout it
times that checkout's ``pointer_doubling`` and ``clock_proposal`` (and
the wrappers phase 11 counts beside them) at the same shapes.

    python3 chip_smoke.py --epilogue

runs phase 12 alone in the same way (``--checks`` adds its asserts);
copied into an older checkout, whose epilogue is a launch of its own in
every dispatch and whose ``group_scan`` is eight operations, it times
that checkout's dispatches, folding wrappers and ``group_scan`` at the
same shapes.

    python3 chip_smoke.py --host-route

runs phase 14 alone in the same way (``--checks`` adds the launch
asserts).

    python3 chip_smoke.py --observe

runs phase 15 alone in the same way (``--checks`` adds its launch
asserts).

    python3 chip_smoke.py --residual

runs phase 13 alone in the same way (``--checks`` adds its asserts);
copied into an older checkout, whose ``residual_view`` fills a
window-sized remap and whose ``emit_scatter`` fills its count and
finishes the epilogue through ``pos_s``, it times that checkout's two
wrappers and residual dispatches at the same shapes.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SEED = 42
CLIENTS = 4096
CONFLICT = 0.5
BIG = 1 << 20
FEED = 1 << 18
EXECUTOR_BATCH = 250_000
SOURCE = "fantoch_tpu_torch/csrc/graph_plane_step.cu"
GENERAL_SOURCE = "fantoch_tpu_torch/csrc/graph_general.cu"
REPLACES = "fantoch_tpu/ops/pallas_resolve.py:334"
GENERAL_C = 4096  # mode general's largest window: the kernel-size gate
GENERAL_WIDTH = 4
GENERAL_FEED = 1024
COOP_B = 1 << 16  # resolve_general above mode general's window


def log(msg):
    print(msg, flush=True)


def build_workload(batch, conflict, clients=CLIENTS, seed=SEED):
    """(key, dep, dot_src, dot_seq): conflicting commands chain on the hot
    key 0, private ones per client — latest-per-key sequential deps (the
    repository's north-star workload, ``bench.build_workload``)."""
    rng = np.random.default_rng(seed)
    hot = rng.random(batch) < conflict
    key = np.where(hot, 0, 1 + rng.integers(0, clients, size=batch)).astype(np.int32)
    dep = np.full(batch, -1, dtype=np.int32)
    last = {}
    for i, k in enumerate(key.tolist()):
        prev = last.get(k)
        if prev is not None:
            dep[i] = prev
        last[k] = i
    dot_src = (1 + rng.integers(0, 5, size=batch)).astype(np.int32)
    dot_seq = np.arange(batch, dtype=np.int32)
    return key, dep, dot_src, dot_seq


def arrival(n, feed, band, window, seed):
    """Arrival order: commits shuffled within windows inside a band around
    every feed boundary (``band`` >= n shuffles throughout)."""
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    edges = range(0, n, feed) if band >= n else range(feed, n, feed)
    for edge in edges:
        lo, hi = max(0, edge - band // 2), min(n, edge + band // 2)
        for s in range(lo, hi, window):
            rng.shuffle(order[s : min(s + window, hi)])
    return order


def columns(n, order):
    """Feed columns in arrival order: dots (src, seq = index + 1), key,
    packed dep dots."""
    key, dep, src, seq = build_workload(n, CONFLICT)
    dot_src = src.astype(np.int64)
    dot_seq = seq.astype(np.int64) + 1
    has = dep >= 0
    di = np.where(has, dep, 0)
    packed = np.where(has, (dot_src[di] << 32) | dot_seq[di], -1).reshape(-1, 1)
    return dot_src[order], dot_seq[order], key[order], packed[order], key


def check_chain_order(executed_seq, key, n):
    """Every command exactly once, each key in dependency-chain order (the
    chain of a key is its commands in index order)."""
    idx = np.asarray(executed_seq, dtype=np.int64) - 1
    assert len(idx) == n, f"executed {len(idx)} of {n}"
    assert np.array_equal(np.sort(idx), np.arange(n)), "not exactly once"
    by_key = idx[np.argsort(key[idx], kind="stable")]
    same = key[by_key[1:]] == key[by_key[:-1]]
    assert np.all(np.diff(by_key)[same] > 0), "a key left its dependency chain"


# ---------------------------------------------------------------------------
# kernel checking and timing
# ---------------------------------------------------------------------------


def tensors_of(value):
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in tensors_of(v)]
    return []


def clone_args(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, list):
        return [clone_args(v) for v in value]
    if isinstance(value, tuple):
        return tuple(clone_args(v) for v in value)
    return value


def max_abs_err(got, want, name):
    errs = [0.0]
    for g, w in zip(tensors_of(got), tensors_of(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        if g.numel():
            errs.append(float((g.long() - w.long()).abs().max().item()))
    return max(errs)


class Checker:
    """Wraps every kernel wrapper of ``graph_plane_kernels``: each call also
    runs the plain version on clones of the same inputs and must agree
    exactly (outputs and in-place updated arguments).  Keeps the largest
    call per kernel for timing."""

    def __init__(self, K):
        self.K = K
        self.real = {name: getattr(K, name) for name in K.LAUNCHES}
        self.calls = {}
        # a loop kernel's first call at its largest row count
        self.widest = {}
        self.err = {name: 0.0 for name in K.LAUNCHES}
        self.count = {name: 0 for name in K.LAUNCHES}

    def install(self):
        for name in self.real:
            setattr(self.K, name, self._wrap(name))

    def uninstall(self):
        for name, fn in self.real.items():
            setattr(self.K, name, fn)

    def variant(self, name, args, kwargs):
        """The call's use: the sort serves five, told apart by its keys;
        a resolve above mode general's window (``resolve_general`` at
        2^16 rows: its affine loop and mutual collapse), the peel
        compaction's init and publish and the stable clocks' table round
        are uses of their wrappers too."""
        if name in ("affine_loop", "mutual_collapse") and args[0].shape[0] > GENERAL_C:
            return f"{name}, above mode general's window"
        if name == "graph_prologue" and kwargs.get("general"):
            return "graph_prologue, general fold"
        if name == "peel_compact" and kwargs["mode"] != "compact":
            return f"peel_compact, {kwargs['mode']}"
        if name == "stable_rows" and len(args) > 2 and args[2] is not None:
            return "stable_rows, table round"
        if name != "lex_sort":
            return name
        keys = args[0]
        if len(keys) > 1:
            return f"lex_sort, {len(keys)} keys"
        if kwargs.get("through") is not None:
            return "lex_sort, packed final sort"
        import torch

        return "lex_sort, 1 bool key" if keys[0].dtype == torch.bool else "lex_sort, 1 key"

    def _wrap(self, name):
        kernel = self.real[name]
        plain = getattr(self.K, f"{name}_plain")

        def run(*args, **kwargs):
            saved = clone_args(args)
            plain_args = clone_args(args)
            want = plain(*plain_args, **kwargs)
            got = kernel(*args, **kwargs)
            err = max(max_abs_err(got, want, name), max_abs_err(args, plain_args, name))
            self.err[name] = max(self.err[name], err)
            self.count[name] += 1
            assert err == 0.0, f"{name}: kernel differs from its plain version"
            # the first call at the largest row count, for each use (for a
            # loop kernel, of the most rows times rounds run)
            size = tensors_of(args)[0].shape[0]
            if name in getattr(self.K, "LOOP_KERNELS", ()):
                if name not in self.widest or size > self.widest[name][0]:
                    self.widest[name] = (size, saved, kwargs, got)
                size *= int(got[-1].item())
            use = self.variant(name, args, kwargs)
            if use not in self.calls or size > self.calls[use][0]:
                self.calls[use] = (size, saved, kwargs, got)
            return got

        return run


def time_ms(fn, args, kwargs, reps=10):
    """Median CUDA-event time of ``fn`` on fresh clones of ``args``."""
    import torch

    runs = [clone_args(args) for _ in range(reps + 2)]
    fn(*runs[0], **kwargs)
    fn(*runs[1], **kwargs)
    times = []
    for r in runs[2:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*r, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


LOOP_LAUNCHES = 100


def time_loop_ms(fn, args, kwargs, reps=LOOP_LAUNCHES):
    """Mean CUDA-event time of ``reps`` back-to-back calls of ``fn``, each
    on its own clone of ``args`` made before the timing, after two warm-up
    calls: one event pair around the run, divided by its count."""
    import torch

    runs = [clone_args(args) for _ in range(reps + 2)]
    fn(*runs[0], **kwargs)
    fn(*runs[1], **kwargs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in runs[2:]:
        fn(*r, **kwargs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sort_library(torch, args, kwargs):
    """The one PyTorch call that computes a ``lex_sort`` use, where there is
    one (a yardstick, used nowhere in the port): ``torch.sort(stable=True)``
    of a single key that is not inverted (for the packed final sort, without
    the gather through ``through``); None for several keys."""
    keys = args[0]
    invert = args[1] if len(args) > 1 else kwargs.get("invert", ())
    if len(keys) != 1 or any(invert):
        return None
    name = "torch.sort(stable=True)"
    if kwargs.get("through") is not None:
        name += ", without the gather through `through`"
    return name, (lambda k: torch.sort(k, stable=True)), (keys[0],)


def moved_bytes(K, name, args, kwargs, out):
    """Bytes the function must move: each input read once, each output
    written once (in-place state rows counted where they are written); for
    a loop kernel, what its rounds need (``loop_bytes``)."""
    if name in getattr(K, "LOOP_KERNELS", ()):
        return loop_bytes(K, name, args, kwargs)
    if name == "residual_view":
        return residual_view_bytes(args)
    if name == "emit_scatter":
        return emit_scatter_bytes(args, out)
    read = sum(t.numel() * t.element_size() for t in tensors_of(args))
    written = sum(t.numel() * t.element_size() for t in tensors_of(out))
    if name == "graph_prologue":
        deps, u_row, p_row, e_row = args[0], args[6], args[11], args[14]
        row_bytes = deps.shape[1] * 4 + 3 * 4 + 2
        written += u_row.numel() * row_bytes + p_row.numel() * 4 + e_row.numel()
    if name == "plane_epilogue":
        written += args[1].numel()  # executed |= newly
    return read + written


def residual_view_bytes(args):
    """Bytes ``residual_view`` itself needs: ``p_r`` read; ``pos_s``,
    ``src`` and ``seq`` gathered at its m rows, ``dep_s`` and ``run_start``
    at the valid ones; the five m-row outputs written; a remap entry (4
    bytes) written a valid row and read a valid row whose dependency is a
    row.  Not the window-sized columns: the function reads m rows of them."""
    p_r, _pos_s, dep_s, _run_start, _src, _seq, n_residual = args
    m = p_r.numel()
    valid = min(n_residual, m)
    into = int((dep_s[p_r[:valid].long()] >= 0).sum().item())
    return 4 * m + 12 * m + 8 * valid + 20 * m + 4 * valid + 4 * into


def emit_scatter_bytes(args, out):
    """Bytes ``emit_scatter`` itself needs: ``chain_ok`` read and ``packed``
    and ``res_b`` written over the window; ``e``, ``p_r`` at ``e``,
    ``l_resolved`` and ``target`` read at the valid residual rows; the count
    written.  Folded: ``occ`` and ``executed`` read and ``newly`` written
    over the window, ``executed`` written where it changes and
    ``flag_perm`` read at the unresolved valid rows."""
    e, chain_ok, n_residual = args[0], args[4], args[5]
    window, m = chain_ok.numel(), e.numel()
    valid = min(n_residual, m)
    moved = 6 * window + 13 * valid + 4
    if len(args) > 6:
        newly, n_unres = out[3], int(out[2].item())
        moved += 3 * window + int(newly.sum().item()) + 4 * n_unres
    return moved


def loop_bytes(K, name, args, kwargs):
    """Bytes a loop kernel's rounds need, counted on its plain version's
    rounds over the same inputs (the same rounds: the Checker holds the
    round counts equal).  Round 0 reads each input once; the peel stage
    writes each output once.  Each round writes the cells that change in
    it (for the peel stage after round 0: its first writes are the
    outputs').  Each later round reads:

    * ``affine_loop``: every row's targets and floors, the adds of its
      live cells, its missing flag, leader and member count; the
      leader-indexed aggregate and composition columns are the round's own
      scratch (shared memory in the one-CTA form) and not counted;
    * ``peel_stage``: one state byte (final, missing) a row; of each row
      not final before the round, its targets and floor, and at each live
      target that target's state byte and, if it is final, its rank.

    ``affine_loop``'s fold reads targets, floors, missing flags and
    leaders and writes resolved/rank/stuck."""
    import torch

    def changed(new, old):
        return int((new != old).sum())

    if name == "affine_loop":
        tgt, add, missing, leader, member_count, max_iters = args[:6]
        batch, width = tgt.shape
        cells = batch * width
        total = 2 * cells * 4 + batch + 2 * batch * 4  # round 0: the inputs
        floor = torch.zeros_like(tgt)
        idx = torch.arange(batch, device=tgt.device)[:, None]
        rounds = 0
        while rounds < max_iters:
            if rounds:
                live = int(((tgt >= 0) & (tgt != idx)).sum())
                total += 2 * cells * 4 + live * 4 + batch + 2 * batch * 4
            new = K.affine_round_plain(tgt, add, floor, missing, leader, member_count)
            total += 4 * (changed(new[0], tgt) + changed(new[1], add)
                          + changed(new[2], floor)) + changed(new[3], missing)
            tgt, add, floor, missing, flag = new
            rounds += 1
            if not int(flag.item()):
                break
        # the fold; with the plane's epilogue folded, occ and executed read
        # and newly written a row
        total += 2 * cells * 4 + batch + batch * 4 + (1 + 4 + 1) * batch
        return total + (3 * batch if len(args) > 6 else 0)
    assert name == "peel_stage", name
    tgt, floor, miss, final, rank, live = args
    size, width = tgt.shape
    row = width * 4 + 4 + 1 + 1 + 4
    total = 2 * size * row  # the inputs read once, the outputs written once
    half = max(size // 2, 1)
    rounds, flag = 0, True
    while flag and (kwargs["run_to_fixpoint"] or live > half):
        if rounds:
            open_rows = ~final
            cells = tgt[open_rows]
            live_cells = cells >= 0
            at_final = final[torch.where(live_cells, cells, 0).long()] & live_cells
            total += (size + int(open_rows.sum()) * (width * 4 + 4)
                      + int(live_cells.sum()) + 4 * int(at_final.sum()))
        new = K.peel_round_plain(tgt, floor, miss, final, rank)
        if rounds:
            total += 4 * (changed(new[0], tgt) + changed(new[1], floor)
                          + changed(new[4], rank))
            total += int(((new[2] != miss) | (new[3] != final)).sum())
        tgt, floor, miss, final, rank, stats = new
        flag, live = stats.tolist()
        rounds += 1
    return total


SMEM_LIMIT = 232_448  # bytes of shared memory one block can use on an H100


def one_launch_forms(K, name, gate_name, args, kwargs, one_cta_smem, on_card=False):
    """The same call of a one-launch wrapper in its two forms, one CTA (the
    gate raised to the call's rows, where the block's shared memory holds
    them) and cooperative (the gate lowered to 0), each held against the
    plain version: single and loop times, and with ``on_card`` each form's
    call, timed on the card by ``forms_on_card``.  Empty where the wrapper
    has no such gate."""
    if not hasattr(K, gate_name):
        return {}
    kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
    want = plain(*clone_args(args), **kwargs)
    rows = args[0].shape[0]
    gate, out = getattr(K, gate_name), {}
    for form, value in (("one_cta", max(gate, rows)), ("cooperative", 0)):
        if form == "one_cta" and one_cta_smem > SMEM_LIMIT:
            continue
        setattr(K, gate_name, value)
        try:
            got = kernel(*clone_args(args), **kwargs)
            assert max_abs_err(got, want, form) == 0.0, f"{name}, {form}: differs"
            out[f"ms_{form}"] = time_ms(kernel, args, kwargs)
            out[f"ms_loop_{form}"] = time_loop_ms(kernel, args, kwargs)
        finally:
            setattr(K, gate_name, gate)
        if on_card:  # timed on the card later (forms_on_card)
            out[f"call_{form}"] = (gated(K, gate_name, value, kernel), clone_args(args),
                                   kwargs)
    return out


def gated(K, gate_name, value, kernel):
    """``kernel`` called with ``K.<gate_name>`` set to ``value`` for the
    call (a form's call, counted on the card later)."""
    def call(*args, **kwargs):
        gate = getattr(K, gate_name)
        setattr(K, gate_name, value)
        try:
            return kernel(*args, **kwargs)
        finally:
            setattr(K, gate_name, gate)

    return call


FORM_REPEATS = 5  # profiled calls of each form: the median is kept


def forms_on_card(torch, found):
    """Replace each form's ``call`` in ``found`` ({label: forms}) by the
    median time on the card of ``FORM_REPEATS`` profiled calls
    (``device_ms_<form>``), each one operation."""
    records = []
    for forms in found.values():
        for form in ("one_cta", "cooperative"):
            call = forms.pop(f"call_{form}", None)
            if call:
                runs = [{"call": call} for _ in range(FORM_REPEATS)]
                records += runs
                forms[f"device_runs_{form}"] = runs
    count_ops(torch, records)
    for label, forms in found.items():
        for form in ("one_cta", "cooperative"):
            runs = forms.pop(f"device_runs_{form}", None)
            if runs:
                assert all(r["device_ops"] == 1 for r in runs), (label, form, runs)
                forms[f"device_ms_{form}"] = float(np.median([r["device_ms"] for r in runs]))


def affine_forms(K, args, kwargs):
    """``one_launch_forms`` of an ``affine_loop`` call (one CTA: six
    columns of ints in shared memory)."""
    return one_launch_forms(K, "affine_loop", "CTA_ROWS", args, kwargs,
                            6 * args[0].shape[0] * 4)


def compare_affine_forms(K, calls):
    """``affine_forms`` of each ``(label, args)`` call; {label: times,
    rounds, calls}."""
    found = {}
    for label, (count, args) in calls.items():
        rounds = int(K.affine_loop_plain(*clone_args(args))[-1].item())
        found[label] = {"calls": count, "rounds": rounds, **affine_forms(K, args, {})}
    return found


AFFINE_SWEEP = (256, 512, 1024, 2048, 4096)  # rows of the forms' sweep, W = 4
# a wrapper whose kernels are in another source than its phase's
KERNEL_SOURCE = {"graph_prologue": GENERAL_SOURCE}


def describe(args):
    return " ".join("x".join(str(d) for d in t.shape) for t in tensors_of(args))


def kernel_records(torch, K, checker, names, source, phase, extra_uses=()):
    """Time each of ``names`` at its largest checked call (one record per
    wrapper; the uses of a wrapper that serves several are listed under
    ``uses``, the record's own numbers being its main use's).  The
    ``extra_uses`` of other wrappers are timed too and returned under
    ``records["uses"]`` for their own records."""
    ran = {use.split(",")[0] for use in checker.calls}
    missing = [name for name in names if name not in ran]
    assert not missing, f"{phase} never ran {missing}"
    main_use = {"lex_sort": "lex_sort, 1 key"}
    records, uses = {}, {}
    for use, (_size, args, kwargs, out) in checker.calls.items():
        name = use.split(",")[0]
        if name not in names and use not in extra_uses:
            continue
        kernel, plain = checker.real[name], getattr(K, f"{name}_plain")
        ms = time_ms(kernel, args, kwargs)
        plain_ms = time_ms(plain, args, kwargs)
        library_ms = None
        loops = {}
        if name in K.LOOP_KERNELS:
            # the loops: both timings, and the rounds of the timed call
            loops["ms_loop"] = time_loop_ms(kernel, args, kwargs)
            loops["rounds"] = int(out[-1].item())
            loops["ms_per_round"] = ms / loops["rounds"] if loops["rounds"] else None
            # and the first call at the most rows, with its rounds
            _rows, w_args, w_kwargs, w_out = checker.widest[name]
            w_ms = time_ms(kernel, w_args, w_kwargs)
            w_rounds = int(w_out[-1].item())
            loops["widest"] = {
                "shape": describe(w_args), "rounds": w_rounds, "ms": w_ms,
                "ms_per_round": w_ms / w_rounds if w_rounds else None,
                "bound_ms": moved_bytes(K, name, w_args, w_kwargs, w_out)
                / HBM_BYTES_PER_S * 1e3,
            }
        if use == "affine_loop":
            # the same call in both forms
            loops.update(affine_forms(K, args, kwargs))
        if name == "peel_stage" and not checker.widest[name][2]["run_to_fixpoint"]:
            # a stage of the widest call's rows run to its fixpoint: many
            # rounds at that size
            w_state, w_live = checker.widest[name][1][:5], checker.widest[name][1][5]
            f_kwargs = {"run_to_fixpoint": True}
            want = K.peel_stage_plain(*clone_args(w_state), w_live, **f_kwargs)
            got = kernel(*clone_args(w_state), w_live, **f_kwargs)
            assert max_abs_err(got, want, use) == 0.0, "peel_stage to the fixpoint differs"
            f_ms = time_ms(kernel, (*w_state, w_live), f_kwargs)
            f_rounds = int(got[-1].item())
            loops["widest_to_fixpoint"] = {
                "rounds": f_rounds, "ms": f_ms, "ms_per_round": f_ms / f_rounds,
                "bound_ms": moved_bytes(K, name, (*w_state, w_live), f_kwargs, got)
                / HBM_BYTES_PER_S * 1e3,
            }
        if name == "lex_sort":
            # the redesigned sort: both timings, the library call's too
            loops["ms_loop"] = time_loop_ms(kernel, args, kwargs)
            library = sort_library(torch, args, kwargs)
            loops["library"] = library[0] if library else "none"
            loops["library_ms_loop"] = None
            if library:
                library_ms = time_ms(library[1], library[2], {})
                loops["library_ms_loop"] = time_loop_ms(library[1], library[2], {})
        nbytes = moved_bytes(K, name, args, kwargs, out)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(json.dumps({
            f"{phase}_kernel": use, "launches": checker.count[name],
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "library_ms": library_ms, **loops,
            "shape": describe(args),
        }))
        uses.setdefault(name, []).append({
            "use": use, "source": KERNEL_SOURCE.get(name, source),
            "shape": describe(args), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms, **loops,
        })
        if use != main_use.get(name, name):
            continue
        records[name] = {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE.get(name, source),
            "replaces": REPLACES,
            "launches": 0,
            "max_abs_err": checker.err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
            **loops,
            "shape": describe(args),
        }
    for name, listed in uses.items():
        if name in records and len(listed) > 1:
            records[name]["uses"] = listed
    records["uses"] = [u for name, listed in uses.items() if name not in names
                       for u in listed]
    return records


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase1(torch, K, gp_module, Config, Metrics, DeviceFrontier, RunTime):
    checker = Checker(K)
    real_step = gp_module.resolve_graph_plane_step
    steps = {"dispatches": 0}

    def checked_step(*args, mode):
        cpu_args = [a.to("cpu", copy=True) for a in args]
        got = real_step(*args, mode=mode)
        checker.uninstall()
        try:
            want = real_step(*cpu_args, mode=mode)
        finally:
            checker.install()
        for field, g, w in zip(got._fields, got, want):
            assert torch.equal(g.cpu(), w), f"step field {field} differs from the CPU twin"
        steps["dispatches"] += 1
        return got

    cases = (
        ("chain C=2^20", BIG, FEED, arrival(BIG, FEED, 0, 1, SEED)),
        ("shuffled C=2^20", BIG, FEED, arrival(BIG, FEED, 8192, 128, SEED)),
        ("overflow C=2^16", 1 << 16, 1 << 15, arrival(1 << 16, 1 << 15, 1 << 16, 64, SEED)),
    )
    checker.install()
    gp_module.resolve_graph_plane_step = checked_step
    try:
        for name, n, feed, order in cases:
            src, seq, key, packed, key_of = columns(n, order)
            plane = gp_module.DeviceGraphPlane(
                1, 0, Config(5, 2, batched_graph_executor=True, device_graph_plane=True),
                DeviceFrontier([1, 2, 3, 4, 5]), Metrics(), slot_capacity=n,
            )
            assert plane._cap == n and plane._device.type == "cuda"
            t0 = time.perf_counter()
            emitted = []
            before = dict(K.LAUNCHES)
            for s in range(0, n, feed):
                cut = slice(s, s + feed)
                plane.feed(
                    src[cut], seq[cut], key[cut], np.zeros(len(src[cut])),
                    packed[cut], [None] * len(src[cut]), RunTime(),
                )
                emitted += [q for _c, _s, q in plane.take_emitted()]
            check_chain_order(np.concatenate(emitted), key_of, n)
            ran = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
            log(f"phase 1: {name}: {plane.dispatches} dispatches equal to the CPU "
                f"twin, every kernel call equal to its plain version "
                f"({time.perf_counter() - t0:.1f} s); kernel calls {ran}")
    finally:
        checker.uninstall()
        gp_module.resolve_graph_plane_step = real_step

    keyed = [name for name in K.LAUNCHES if name not in K.GENERAL_KERNELS]
    records = kernel_records(torch, K, checker, keyed, SOURCE, "phase1")
    del records["uses"]
    edge_err = sort_edge_cases(torch, K)
    records["lex_sort"]["max_abs_err"] = max(records["lex_sort"]["max_abs_err"], edge_err)
    return records


def sort_edge_cases(torch, K):
    """``lex_sort`` against ``lex_sort_plain`` on the card, exactly, at the
    full size and at the edges: keys at INT_MIN, -1, 0 and INT_MAX;
    all-equal int32 and bool keys; sorted and reverse-sorted columns;
    n = 1, 2 and sizes that are no power of two (3,000 in one block,
    1,000,003 over many tiles); 2, 4 and 6 keys (bool keys inverted); a
    packed key through a permutation.  Returns the largest error."""
    rng = np.random.default_rng(SEED + 5)
    dev = torch.device(CARD)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def flags(p, size=BIG):
        return torch.tensor(rng.random(size) < p, device=dev)

    edges = np.array([-(1 << 31), -1, 0, (1 << 31) - 1], dtype=np.int32)
    n = BIG
    cases = (
        ("INT_MIN, -1, 0, INT_MAX", [i32(rng.choice(edges, n))], (), None),
        ("all equal int32", [i32(np.full(n, 7))], (), None),
        ("all equal bool", [torch.ones(n, dtype=torch.bool, device=dev)], (), None),
        ("inverted bool", [flags(0.3)], (True,), None),
        ("sorted", [i32(np.arange(n) - n // 2)], (), None),
        ("reverse-sorted", [i32(n // 2 - np.arange(n))], (), None),
        ("n = 1", [i32([5])], (), None),
        ("n = 2", [i32([5, -5])], (), None),
        ("n = 3,000", [i32(rng.integers(-(1 << 31), 1 << 31, 3000))], (), None),
        ("n = 1,000,003", [i32(rng.integers(-(1 << 31), 1 << 31, 1_000_003))], (), None),
        ("2 keys", [i32(rng.integers(0, 4096, n)), i32(rng.integers(-50, 50, n))], (),
         None),
        ("4 keys", [i32(rng.choice(edges, n)), i32(rng.integers(0, n, n)),
                    i32(rng.integers(1, 6, n)), i32(rng.integers(0, n, n))], (), None),
        ("6 keys, invert (False, True)",
         [flags(0.5), flags(0.3)] + [i32(rng.integers(0, 9, n)) for _ in range(4)],
         (False, True), None),
        ("packed, through", [i32(rng.integers(0, 1 << 31, n))], (),
         i32(rng.permutation(n))),
    )
    worst = 0.0
    for name, keys, invert, through in cases:
        got = K.lex_sort(keys, invert, through=through)
        want = K.lex_sort_plain(keys, invert, through=through)
        err = max_abs_err(got, want, f"lex_sort, {name}")
        assert err == 0.0, f"lex_sort, {name}: kernel differs from its plain version"
        worst = max(worst, err)
    log(f"phase 1: lex_sort equal to lex_sort_plain at the edges ({len(cases)} cases: "
        f"{', '.join(c[0] for c in cases)})")
    # the two paths on either side of the one-block limit, 1 and 2 keys
    sides = {}
    for size in (K.RADIX_SMALL_N, K.RADIX_SMALL_N + 1):
        for ncols in (1, 2):
            keys = [i32(rng.integers(0, 1 << 20, size)) for _ in range(ncols)]
            sides[f"{ncols} key(s), n = {size}"] = {
                "ms": time_ms(K.lex_sort, (keys,), {}),
                "ms_loop": time_loop_ms(K.lex_sort, (keys,), {}),
            }
    log(json.dumps({"lex_sort_one_block_limit": sides}))
    return worst


def drive(executor, cols, cmds, RunTime, GraphAddBatch):
    """Feed ``GraphExecutor`` the columns as ``GraphAddBatch`` feeds of
    ``EXECUTOR_BATCH``; returns the executed sequences and the wall s."""
    import torch

    src, seq, key, packed = cols
    clock = RunTime()
    executed = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(src), EXECUTOR_BATCH):
        cut = slice(s, s + EXECUTOR_BATCH)
        executor.handle(
            GraphAddBatch(src[cut], seq[cut], key[cut], packed[cut], cmds[cut]), clock
        )
        while (r := executor.to_clients()) is not None:
            executed.append(r.rifl.sequence)
    torch.cuda.synchronize()
    return executed, time.perf_counter() - t0


def phase2(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
           GraphExecutor, GraphAddBatch):
    n = BIG
    # shuffled in windows of 64 within 4096 arrivals around each feed edge
    # (an assumed model of cross-replica commit order, not a sourced one)
    order = arrival(n, EXECUTOR_BATCH, 4096, 64, SEED + 1)
    src, seq, key, packed, key_of = columns(n, order)
    t0 = time.perf_counter()
    cmds = [
        Command.from_keys(Rifl(int(s), int(q)), 0, {f"k{k}": (KVOp.put(""),)})
        for s, q, k in zip(src.tolist(), seq.tolist(), key.tolist())
    ]
    setup_s = time.perf_counter() - t0
    config = Config(5, 2, batched_graph_executor=True, device_graph_plane=True)

    # the north-star feed in arrival order: the host fast path, no dispatch
    in_order = columns(n, np.arange(n))[:4]
    position = np.empty(n, dtype=np.int64)
    position[order] = np.arange(n)
    executor = GraphExecutor(1, 0, config)
    executed, wall_s = drive(
        executor, in_order, [cmds[i] for i in position.tolist()], RunTime, GraphAddBatch
    )
    check_chain_order(executed, key_of, n)
    in_order_dispatches = executor.graph._plane.dispatches
    log(f"phase 2: in arrival order, {n} commands executed exactly once in per-key "
        f"chain order: {in_order_dispatches} dispatches, {n / wall_s:.1f} "
        f"commands/s ({wall_s:.3f} s)")
    log(json.dumps({"in_order_path": {
        "commands": n, "dispatches": in_order_dispatches,
        "wall_s": wall_s, "commands_per_s": n / wall_s,
    }}))
    del executor, executed

    executor = GraphExecutor(1, 0, config)
    plane = executor.graph._plane
    assert plane._device.type == "cuda"
    real_step = gp_module.resolve_graph_plane_step
    dispatch_ms = []

    def timed_step(*args, mode):
        t = time.perf_counter()
        out = real_step(*args, mode=mode)
        torch.cuda.synchronize()
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        return out

    gp_module.resolve_graph_plane_step = timed_step
    K.reset_launch_counts()
    try:
        executed, wall_s = drive(
            executor, (src, seq, key, packed), cmds, RunTime, GraphAddBatch
        )
    finally:
        gp_module.resolve_graph_plane_step = real_step
    launches = dict(K.LAUNCHES)
    folded = dict(getattr(K, "EPILOGUE_FOLDS", {}))
    check_chain_order(executed, key_of, n)
    assert launches["graph_prologue"] == plane.dispatches > 0, (launches, plane.dispatches)
    # the epilogue runs folded into the launch that makes the flags where
    # one does (ops/graph_resolve.py): a folded one counts as run
    ran = {**launches, "plane_epilogue": launches["plane_epilogue"] + sum(folded.values())}
    not_run = [k for k, v in ran.items() if v == 0 and k not in K.GENERAL_KERNELS]
    assert not not_run, f"kernels of the path never launched: {not_run}"
    assert ran["plane_epilogue"] == plane.dispatches, (launches, folded)
    assert plane.health_name() == "healthy", plane.health_name()
    p50 = float(np.median(dispatch_ms))
    log(f"phase 2: {n} commands executed exactly once in per-key chain order "
        f"through GraphExecutor on cuda: {plane.dispatches} dispatches, slot "
        f"capacity {plane._cap}, p50 dispatch {p50:.3f} ms, "
        f"{n / wall_s:.1f} commands/s ({wall_s:.3f} s; {setup_s:.1f} s building "
        f"Command objects before), resident_uploads {plane.resident_uploads}, "
        f"health {plane.health_name()}")
    log(json.dumps({"main_path": {
        "commands": n, "feeds": len(range(0, n, EXECUTOR_BATCH)),
        "dispatches": plane.dispatches, "slot_capacity": plane._cap,
        "p50_dispatch_ms": p50, "dispatch_ms": dispatch_ms,
        "wall_s": wall_s, "commands_per_s": n / wall_s,
        "resident_uploads": plane.resident_uploads, "launches": launches,
        "epilogue_folds": folded,
    }}))
    return {**launches, "epilogue_folds": folded}


def general_workload(batch, width=GENERAL_WIDTH):
    """``bench.py``'s general generator (seed 7): ``width`` keys per command
    from 4096, a dependency on the latest command of each key (all
    backward); returns (keys, deps, dot_src, dot_seq)."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 4096, size=(batch, width))
    deps = np.full((batch, width), -1, dtype=np.int32)
    last = {}
    for i, row in enumerate(keys.tolist()):
        slot = 0
        for k in row:
            prev = last.get(k)
            if prev is not None and prev != i and slot < width:
                deps[i, slot] = prev
                slot += 1
            last[k] = i
    dot_src = (1 + rng.integers(0, 5, size=batch)).astype(np.int32)
    dot_seq = np.arange(batch, dtype=np.int32)
    return keys, deps, dot_src, dot_seq


def cycle_rich(n, chunk, n_keys=256, seed=SEED):
    """Two keys per command; each pair of consecutive commands on a key
    within a chunk is linked in a random direction, or both (a mutual
    edge): 2-cycles, mutual cliques and directed cycles with no mutual
    edge, which the general resolver leaves stuck for the host oracle.
    Links stay inside their chunk, so a feed of one chunk resolves whole."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=(n, 2))
    deps = [[] for _ in range(n)]
    last = {}
    for i, row in enumerate(keys.tolist()):
        if i % chunk == 0:
            last = {}
        for k in sorted(set(row)):
            prev = last.get(k)
            if prev is not None:
                c = int(rng.integers(0, 3))
                if c in (0, 2):
                    deps[i].append(prev)
                if c in (1, 2):
                    deps[prev].append(i)
            last[k] = i
    mat = np.full((n, GENERAL_WIDTH), -1, dtype=np.int32)
    for i, row in enumerate(deps):
        mat[i, : len(row)] = row
    dot_src = (1 + rng.integers(0, 5, size=n)).astype(np.int32)
    return keys, mat, dot_src, np.arange(n, dtype=np.int32)


def general_columns(deps, src, seq, order):
    """Plane feed columns in arrival order: dots (seq = index + 1), the
    multi-key marker (-1) and the packed dep dots."""
    dot_src = src.astype(np.int64)
    dot_seq = seq.astype(np.int64) + 1
    has = deps >= 0
    di = np.where(has, deps, 0)
    packed = np.where(has, (dot_src[di] << 32) | dot_seq[di], -1)
    key = np.full(len(src), -1, dtype=np.int32)
    return dot_src[order], dot_seq[order], key[order], packed[order]


def check_key_order(executed_seq, keys, n):
    """Every command exactly once; each key's commands in index order (its
    dependency chain: every command depends on the latest of each key)."""
    idx = np.asarray(executed_seq, dtype=np.int64) - 1
    assert len(idx) == n, f"executed {len(idx)} of {n}"
    assert np.array_equal(np.sort(idx), np.arange(n)), "not exactly once"
    pos = np.empty(n, dtype=np.int64)
    pos[idx] = np.arange(n)
    kk = keys.ravel()
    rr = np.repeat(np.arange(n), keys.shape[1])
    o = np.lexsort((rr, kk))
    kk, rr = kk[o], rr[o]
    same = (kk[1:] == kk[:-1]) & (rr[1:] != rr[:-1])
    assert np.all(pos[rr[1:]][same] > pos[rr[:-1]][same]), "a key left its order"


class HostReads:
    """Counts the host reads of card tensors (``item()``/``tolist()``, each a
    sync with the card; a tensor is on the card where the kernel wrappers'
    own test says so) that code of the module ``module`` makes while
    installed; the Checker's own comparisons are not counted."""

    def __init__(self, torch, K, module):
        self.torch, self.K, self.module, self.n = torch, K, module, 0

    def install(self):
        Tensor = self.torch.Tensor
        for name in ("item", "tolist"):
            fn = getattr(Tensor, name)

            def call(t, *args, _fn=fn, **kwargs):
                caller = sys._getframe(1).f_globals.get("__name__")
                if caller == self.module and self.K._on_card(t):
                    self.n += 1
                return _fn(t, *args, **kwargs)

            setattr(Tensor, name, call)

    def uninstall(self):
        # the methods live on the C base class: drop the shadowing wrappers
        del self.torch.Tensor.item, self.torch.Tensor.tolist


RESOLVE_MODULE = "fantoch_tpu_torch.ops.graph_resolve"


def phase3(torch, K, gp_module, Config, Metrics, DeviceFrontier, RunTime):
    from fantoch_tpu_torch.ops import graph_resolve

    checker = Checker(K)
    real_step = gp_module.resolve_graph_plane_step
    twin = {"on": True}
    calls = {"general": 0, "general_resident": 0, "keyed": 0}
    reads = HostReads(torch, K, RESOLVE_MODULE)

    def checked_step(*args, mode):
        calls[mode] += 1
        cpu_args = [a.to("cpu", copy=True) for a in args] if twin["on"] else None
        reads.install()
        try:
            got = real_step(*args, mode=mode)
        finally:
            reads.uninstall()
        if cpu_args is not None:
            checker.uninstall()
            try:
                want = real_step(*cpu_args, mode=mode)
            finally:
                checker.install()
            for field, g, w in zip(got._fields, got, want):
                assert torch.equal(g.cpu(), w), f"{mode} step field {field} differs"
        return got

    n3 = 4 * GENERAL_FEED
    keys_p, deps_p, src_p, seq_p = general_workload(n3)
    # bench.py's adversarial arrival (a random permutation, :620-634) within
    # each feed, so the pending window stays within the kernel-size gate
    rng13 = np.random.default_rng(13)
    perm = np.concatenate([
        s + rng13.permutation(GENERAL_FEED) for s in range(0, n3, GENERAL_FEED)
    ])
    keys_c, deps_c, src_c, seq_c = cycle_rich(n3, GENERAL_FEED)
    keys_b, deps_b, src_b, seq_b = general_workload(BIG)
    cases = (
        ("general, permuted C=4096", "general", GENERAL_C, GENERAL_FEED,
         general_columns(deps_p, src_p, seq_p, perm), None, True),
        ("general, cycle-rich C=4096", "general", GENERAL_C, GENERAL_FEED,
         general_columns(deps_c, src_c, seq_c, perm),
         None, True),
        ("general_resident C=2^20", "general_resident", BIG, FEED,
         general_columns(deps_b, src_b, seq_b, arrival(BIG, FEED, 8192, 128, SEED)),
         keys_b, False),
    )
    rounds = {}
    oracle_calls = []  # rows each stuck-cycle host-oracle follow-up closed
    real_oracle = gp_module.DeviceGraphPlane._stuck_oracle

    def counted_oracle(plane, slots, t):
        oracle_calls.append(len(slots))
        return real_oracle(plane, slots, t)

    checker.install()
    gp_module.resolve_graph_plane_step = checked_step
    gp_module.DeviceGraphPlane._stuck_oracle = counted_oracle
    try:
        for name, mode, cap, feed, cols, keys, with_twin in cases:
            twin["on"] = with_twin
            src, seq, key, packed = cols
            n = len(src)
            plane = gp_module.DeviceGraphPlane(
                1, 0, Config(5, 2, batched_graph_executor=True, device_graph_plane=True),
                DeviceFrontier([1, 2, 3, 4, 5]), Metrics(), slot_capacity=cap,
            )
            oracle_calls.clear()
            for k in calls:
                calls[k] = 0
            reads.n = 0
            K.reset_launch_counts()
            t0 = time.perf_counter()
            emitted = []
            before = dict(checker.count)
            for s in range(0, n, feed):
                cut = slice(s, s + feed)
                # distinct command objects: the host oracle maps them back
                plane.feed(
                    src[cut], seq[cut], key[cut], np.zeros(len(src[cut])),
                    packed[cut], [object() for _ in range(len(src[cut]))], RunTime(),
                )
                assert plane._mode() in (mode, "keyed"), plane._mode()
                emitted += [q for _c, _s, q in plane.take_emitted()]
            executed = np.concatenate(emitted)
            if keys is not None:
                check_key_order(executed, keys, n)
            else:
                idx = np.sort(executed.astype(np.int64) - 1)
                assert np.array_equal(idx, np.arange(n)), f"{name}: not exactly once"
            # wrapper calls, each checked against its plain version
            ran = {k: checker.count[k] - before[k] for k in K.LAUNCHES}
            assert plane._cap == cap, (name, plane._cap)
            # the rounds each loop kernel ran, summed on the card
            totals = K.round_totals()
            # stages: every peel_compact call but the init of each resolve
            stages = ran["peel_compact"] - calls["general_resident"]
            assert ran["affine_loop"] == ran["mutual_collapse"], (name, ran)
            assert ran["peel_stage"] == stages, (name, ran, calls)
            rounds[name] = {
                "dispatches": plane.dispatches,
                "dispatches_by_mode": dict(calls),
                "resolves": ran["affine_loop"],
                "affine_rounds": totals["affine_loop"],
                "affine_rounds_per_resolve": (
                    totals["affine_loop"] / ran["affine_loop"] if ran["affine_loop"]
                    else None),
                "stages": ran["peel_stage"],
                "peel_rounds": totals["peel_stage"],
                "peel_rounds_per_stage": (
                    totals["peel_stage"] / ran["peel_stage"] if ran["peel_stage"]
                    else None),
                "host_reads_in_step": reads.n,
                "host_reads_per_dispatch": reads.n / max(plane.dispatches, 1),
                "stuck_oracle_runs": len(oracle_calls),
                "stuck_rows": int(sum(oracle_calls)),
                "wall_s": time.perf_counter() - t0,
            }
            log(f"phase 3: {name}: {plane.dispatches} dispatches"
                f"{' equal to the CPU twin' if with_twin else ''}, every kernel call "
                f"equal to its plain version ({time.perf_counter() - t0:.1f} s); "
                f"kernel calls {ran}; stuck-oracle runs {len(oracle_calls)} "
                f"({sum(oracle_calls)} rows)")
            if mode == "general":
                for wrapper in ("mutual_collapse", "affine_loop"):
                    assert ran[wrapper] > 0, (name, wrapper)
            else:
                for wrapper in ("peel_stage", "peel_compact"):
                    assert ran[wrapper] > 0, (name, wrapper)
        assert rounds["general, cycle-rich C=4096"]["stuck_oracle_runs"] > 0, rounds
        # a resolve above mode general's window, cooperative:
        # resolve_general itself on 2^16 rows, every wrapper call checked
        for name, deps in (
            ("resolve_general, cooperative, rows shuffled B=2^16",
             general_workload(COOP_B)[1][np.random.default_rng(17).permutation(COOP_B)]),
            ("resolve_general, cooperative, cycle-rich B=2^16",
             cycle_rich(COOP_B, GENERAL_FEED)[1]),
        ):
            K.reset_launch_counts()
            before = dict(checker.count)
            n_bad = int(((deps > np.arange(COOP_B)[:, None]) | (deps == -2)).sum())
            t = torch.tensor(deps, device=CARD)
            src = torch.ones(COOP_B, dtype=torch.int32, device=CARD)
            seq = torch.arange(COOP_B, dtype=torch.int32, device=CARD)
            got = graph_resolve.resolve_general(t, src, seq, n_bad=n_bad)
            checker.uninstall()
            try:
                want = graph_resolve.resolve_general(t.cpu(), src.cpu(), seq.cpu(),
                                                     n_bad=n_bad)
            finally:
                checker.install()
            for field, g, w in zip(got._fields, got, want):
                assert torch.equal(g.cpu(), w), f"{name}: field {field} differs"
            ran = {k: checker.count[k] - before[k] for k in K.LAUNCHES}
            assert ran["affine_loop"] == 1 == ran["mutual_collapse"], (name, ran)
            rounds[name] = {"affine_rounds": K.round_totals()["affine_loop"],
                            "stuck_rows": int(got.stuck.sum())}
            log(f"phase 3: {name}: equal to the CPU run, every kernel call equal to "
                f"its plain version; {rounds[name]}")
    finally:
        checker.uninstall()
        gp_module.resolve_graph_plane_step = real_step
        gp_module.DeviceGraphPlane._stuck_oracle = real_oracle
    log(json.dumps({"phase3_rounds": rounds}))
    # both forms of the affine loop on one resolve each of the sweep's
    # sizes: bench.py's general generator, rows shuffled
    sweep = {}
    for rows in AFFINE_SWEEP:
        deps = general_workload(rows)[1][np.random.default_rng(rows).permutation(rows)]
        collapsed = K.mutual_collapse(torch.tensor(deps, device=CARD))
        leader, tgt, add, missing, member_count = collapsed
        max_iters = 4 * K.num_doubling_steps(rows) + 8
        sweep[f"{rows} x {deps.shape[1]}"] = (
            1, (tgt, add, missing, leader, member_count, max_iters))
    log(json.dumps({"phase3_affine_forms": compare_affine_forms(K, sweep)}))
    # the prologue in mode general is a use of the prologue (graph_general.cu §13)
    return kernel_records(torch, K, checker, list(K.GENERAL_KERNELS),
                          GENERAL_SOURCE, "phase3",
                          extra_uses=("graph_prologue, general fold",))


def sim_run(device, protocol_name):
    """EPaxos/Atlas through the simulator at n = 5, f = 2, two keys per
    command, 50% conflict (tests/harness.py's shape), seed 0; returns the
    per-process per-key orders, the latency histograms and the runner."""
    from fantoch_tpu_torch.client import ConflictRateKeyGen, Workload
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch import protocol
    from fantoch_tpu_torch.sim import Runner

    config = Config(
        5, 2, batched_graph_executor=True, device_graph_plane=True,
        executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
    )
    planet = Planet.new("gcp")
    workload = Workload(
        shard_count=1, key_gen=ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=10, payload_size=1,
    )
    regions = sorted(planet.regions())[:5]
    runner = Runner(
        getattr(protocol, protocol_name), planet, config, workload, 3,
        process_regions=list(regions), client_regions=list(regions), seed=0,
        device=device,
    )
    runner.reorder_messages()
    _metrics, monitors, latencies = runner.run(extra_sim_time_ms=10_000)
    orders = {
        pid: {k: [(r.source, r.sequence) for r in m.get_order(k)] for k in sorted(m.keys())}
        for pid, m in monitors.items()
    }
    hists = {str(r): (c, list(h.values())) for r, (c, h) in latencies.items()}
    return orders, hists, runner


def phase4(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
           GraphExecutor, GraphAddBatch):
    n = BIG
    keys, deps, src0, seq0 = general_workload(n)
    order = arrival(n, EXECUTOR_BATCH, 4096, 64, SEED + 1)
    src, seq, key, packed = general_columns(deps, src0, seq0, order)
    t0 = time.perf_counter()
    cmds = [
        Command.from_keys(Rifl(int(s), int(q)), 0,
                          {f"g{k}": (KVOp.put(""),) for k in keys[int(q) - 1].tolist()})
        for s, q in zip(src.tolist(), seq.tolist())
    ]
    setup_s = time.perf_counter() - t0
    config = Config(5, 2, batched_graph_executor=True, device_graph_plane=True)
    executor = GraphExecutor(1, 0, config)
    plane = executor.graph._plane
    assert plane._device.type == "cuda"
    real_step = gp_module.resolve_graph_plane_step
    dispatch_ms = {}
    # dispatches on the card by mode, and the host reads inside each step
    card_calls = {"general": 0, "general_resident": 0, "keyed": 0}
    reads = HostReads(torch, K, RESOLVE_MODULE)
    step_reads = {}

    def timed_step(*args, mode):
        on_card = K._on_card(args[0])
        card_calls[mode] += on_card
        reads.n = 0
        t = time.perf_counter()
        reads.install()
        try:
            out = real_step(*args, mode=mode)
        finally:
            reads.uninstall()
        torch.cuda.synchronize()
        dispatch_ms.setdefault(mode, []).append((time.perf_counter() - t) * 1e3)
        if on_card:
            step_reads.setdefault(mode, []).append(reads.n)
        return out

    K.reset_launch_counts()
    gp_module.resolve_graph_plane_step = timed_step
    try:
        executed, wall_s = drive(
            executor, (src, seq, key, packed), cmds, RunTime, GraphAddBatch
        )
        # one result per key of a command: each command once, with one
        # result for each of its distinct keys
        results = np.asarray(executed, dtype=np.int64)
        first = np.sort(np.unique(results, return_index=True)[1])
        distinct = np.array([len(set(row)) for row in keys.tolist()])
        assert np.array_equal(np.bincount(results - 1, minlength=n), distinct), (
            "a command's results are not one per key")
        check_key_order(results[first], keys, n)
        assert plane.health_name() == "healthy", plane.health_name()
        by_mode = {
            mode: {"dispatches": len(ms), "p50_dispatch_ms": float(np.median(ms)),
                   "min_dispatch_ms": float(min(ms)), "max_dispatch_ms": float(max(ms)),
                   "host_reads_per_dispatch": float(np.mean(step_reads[mode])),
                   "max_host_reads": int(max(step_reads[mode]))}
            for mode, ms in dispatch_ms.items()
        }
        executor_rounds = K.round_totals()
        log(f"phase 4: {n} multi-key commands executed exactly once in per-key "
            f"order through GraphExecutor on cuda: {plane.dispatches} dispatches, "
            f"slot capacity {plane._cap}, {n / wall_s:.1f} commands/s "
            f"({wall_s:.3f} s; {setup_s:.1f} s building Command objects before); "
            f"by mode {by_mode}")
        log(json.dumps({"general_path": {
            "commands": n, "feeds": len(range(0, n, EXECUTOR_BATCH)),
            "dispatches": plane.dispatches, "slot_capacity": plane._cap,
            "wall_s": wall_s, "commands_per_s": n / wall_s, "by_mode": by_mode,
            "dispatch_ms": dispatch_ms, "resident_uploads": plane.resident_uploads,
            "loop_rounds": executor_rounds,
            "launches": {k: K.LAUNCHES[k] for k in K.GENERAL_KERNELS},
        }}))
        del executor, cmds
        sims = {}
        # the sims' affine_loop calls by shape: a count and the first
        # call's inputs
        sim_affine = {}
        real_affine = K.affine_loop

        def captured_affine(*args):
            label = " x ".join(str(d) for d in args[0].shape)
            if label not in sim_affine:
                sim_affine[label] = (0, clone_args(args))
            count, first = sim_affine[label]
            sim_affine[label] = (count + 1, first)
            return real_affine(*args)

        for name in ("EPaxos", "Atlas"):
            t0 = time.perf_counter()
            K.affine_loop = captured_affine
            try:
                got = sim_run("cuda", name)
            finally:
                K.affine_loop = real_affine
            cuda_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = sim_run("cpu", name)
            cpu_s = time.perf_counter() - t0
            assert got[0] == want[0], f"{name}: per-key orders differ from the CPU run"
            assert got[1] == want[1], f"{name}: latency histograms differ from the CPU run"
            counters = [e.device_counters() for _p, (_x, e, _q)
                        in got[2]._simulation.processes()]
            assert all(c["graph_plane_dispatches"] > 0 for c in counters)
            sims[name] = {
                "dispatches": sum(c["graph_plane_dispatches"] for c in counters),
                "cuda_wall_s": cuda_s, "cpu_wall_s": cpu_s,
                "commands": sum(len(set().union(*o.values())) for o in got[0].values()),
            }
            log(f"phase 4: {name} through Runner(device='cuda'): per-key orders and "
                f"latency histograms equal to Runner(device='cpu'); {sims[name]}")
    finally:
        gp_module.resolve_graph_plane_step = real_step
    launches = dict(K.LAUNCHES)
    folded = dict(getattr(K, "EPILOGUE_FOLDS", {}))
    on_path = list(K.GENERAL_KERNELS) + ["graph_prologue", "lex_sort", "plane_epilogue"]
    # a folded epilogue counts as run (phase 2)
    ran = {**launches, "plane_epilogue": launches["plane_epilogue"] + sum(folded.values())}
    not_run = [k for k in on_path if ran[k] == 0]
    assert not not_run, f"kernels of the general path never launched: {not_run}"
    assert ran["plane_epilogue"] == launches["graph_prologue"], (launches, folded)
    # one affine loop a resolve, one peel stage a stage (every peel_compact
    # launch but the init of each general_resident dispatch)
    assert launches["affine_loop"] == launches["mutual_collapse"], launches
    stages = launches["peel_compact"] - card_calls["general_resident"]
    assert launches["peel_stage"] == stages, (launches, card_calls)
    totals = K.round_totals()
    loops = {
        "card_dispatches_by_mode": card_calls,
        "affine_rounds": totals["affine_loop"],
        "affine_rounds_per_resolve": totals["affine_loop"] / launches["affine_loop"],
        "peel_rounds": totals["peel_stage"],
        "peel_rounds_per_stage": totals["peel_stage"] / launches["peel_stage"],
        "host_reads_in_step_by_mode": {m: int(sum(r)) for m, r in step_reads.items()},
    }
    log(json.dumps({"general_sims": sims, "launches": launches, "epilogue_folds": folded,
                    "loops": loops}))
    # both forms of the affine loop at the sims' own shapes
    log(json.dumps({"phase4_sim_affine_forms": compare_affine_forms(K, sim_affine)}))
    return {**launches, "epilogue_folds": folded}


# ---------------------------------------------------------------------------
# the general chain at the sims' shapes (phase 4b; alone: --general-chain)
# ---------------------------------------------------------------------------

CHAIN_SWEEP = (256, 512, 1024, 2048, 4096)  # rows of the one-launch forms' sweep


SEPARATOR = "spin_kernel"  # torch.cuda._sleep's kernel, launched by nothing else here
PROFILE_TRIES = 3


def device_ops(torch, calls):
    """The operations on the card (kernels, memsets, copies) of each call
    ``(fn, args, kwargs)`` on clones of its arguments, by
    ``torch.profiler``: one session over all of them, each call warmed
    before it (library load, grid and limit queries), with a separator
    kernel (``torch.cuda._sleep``) on the same stream before the first call
    and after each.  The card's events, in the order the card ran them,
    are split at the separators, so no event is matched to a call by the
    host's clock.  A session that does not show exactly one separator more
    than there are calls lost events and is run again (at most
    ``PROFILE_TRIES`` sessions).  Returns, a call, the names and the summed
    time on the card (ms) of its operations, and each operation's name and
    time in the order the card ran them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for fn, args, kwargs in calls:
        fn(*clone_args(args), **kwargs)
        runs.append(clone_args(args))
    torch.cuda.synchronize()
    seen = []
    for _try in range(PROFILE_TRIES):
        fresh = [clone_args(run) for run in runs]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for (fn, _args, kwargs), run in zip(calls, fresh):
                fn(*run, **kwargs)
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        seen.append((sum(SEPARATOR in e.name for e in events), len(events)))
        if seen[-1][0] == len(calls) + 1:
            break
    else:
        raise AssertionError(
            f"torch.profiler lost events in {PROFILE_TRIES} sessions of {len(calls)} calls "
            f"(separators, events seen: {seen})")
    out, current = [], None
    for e in events:
        if SEPARATOR in e.name:
            if current is not None:
                out.append(current)
            current = []
        elif current is not None:
            current.append((e.name, (e.time_range.end - e.time_range.start) / 1e3))
    return [([n for n, _ms in ops], sum(ms for _n, ms in ops), ops) for ops in out]


def launch_floor(torch, K):
    """An empty kernel's launch on the same stream, single and in the loop
    (None where the library has no empty kernel)."""
    if "gg_empty" not in K._SIGNATURES:
        return None
    device = torch.device(CARD, torch.cuda.current_device())

    def empty():
        K._launch("gg_empty", device)

    return {"ms": time_ms(empty, (), {}), "ms_loop": time_loop_ms(empty, (), {}),
            "call": (empty, (), {})}


def stage_record(torch, K, name, args, kwargs=None):
    """One wrapper call checked against its plain version on the card
    (outputs and in-place arguments), timed single and in the loop beside
    the plain version and its byte bound; the record's ``call`` is counted
    in operations on the card later (``count_ops``).  Returns the record,
    the outputs and the arguments after the call."""
    kwargs = kwargs or {}
    kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
    got_args, plain_args = clone_args(args), clone_args(args)
    got = kernel(*got_args, **kwargs)
    want = plain(*plain_args, **kwargs)
    err = max(max_abs_err(got, want, name), max_abs_err(got_args, plain_args, name))
    assert err == 0.0, f"{name}: kernel differs from its plain version"
    record = {
        "shape": describe(args), "ms": time_ms(kernel, args, kwargs),
        "ms_loop": time_loop_ms(kernel, args, kwargs),
        "plain_ms": time_ms(plain, args, kwargs),
        "bound_ms": moved_bytes(K, name, args, kwargs, got) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err, "call": (kernel, clone_args(args), kwargs),
    }
    return record, got, got_args


OPS_LISTED = 48  # a call's operations listed one by one (op_ms) up to this many


def count_ops(torch, records, every_name=False):
    """Replace each record's ``call`` by its operations on the card
    (``device_ops``, one profiler session for all): ``device_ops``, the
    count, ``op_names``, ``device_ms``, their summed time on the card in
    the profiler's trace, and up to ``OPS_LISTED`` of them ``op_ms``, each
    operation's name and time in the order the card ran them (with
    ``every_name``, ``op_names_all``: every operation's name, in order).  A
    control call of one PyTorch kernel first: the profiler must see exactly
    it."""
    control = (lambda: torch.zeros(8, device=CARD), (), {})
    ops = device_ops(torch, [control] + [r.pop("call") for r in records])
    assert len(ops[0][0]) == 1, f"torch.profiler saw {ops[0][0]} for one kernel"
    for record, (names, ms, each) in zip(records, ops[1:]):
        record["device_ops"] = len(names)
        record["op_names"] = sorted(set(names))
        if every_name:
            record["op_names_all"] = names
        record["device_ms"] = ms
        if len(each) <= OPS_LISTED:
            record["op_ms"] = [[name.split("(")[0], t] for name, t in each]


def collapse_smem(rows, width):
    return (3 + -(-width // 32)) * rows * 4


def collapse_steps(K, deps):
    """Steps of the collapse's min-label loop that change a leader (None on
    a checkout whose plain collapse does not count them)."""
    count = getattr(K, "mutual_collapse_steps", None)
    return count(deps) if count else None


def prologue_inputs(torch, cap, width, seed):
    """A general dispatch into a window of ``cap`` rows: 3/4 of the rows
    resident (``general_workload``'s dependencies, a few of them MISSING), a
    quarter of those executed, the last quarter of the window installed by
    the feed, MISSING cells of resident and installed rows patched, and
    executed marks on resident and installed rows."""
    rng = np.random.default_rng(seed)
    deps = general_workload(cap, width)[1]
    deps = np.where((deps >= 0) & (rng.random(deps.shape) < 0.02), -2, deps)
    resident = 3 * cap // 4
    state_deps = np.full((cap, width), -1, np.int32)
    state_deps[:resident] = deps[:resident]
    occ = np.arange(cap) < resident
    executed = occ & (rng.random(cap) < 0.25)
    u_row = np.arange(resident, cap, dtype=np.int32)
    missing = np.argwhere(deps == -2)
    missing = missing[rng.random(len(missing)) < 0.5]
    p_row, p_col = missing[:, 0].astype(np.int32), missing[:, 1].astype(np.int32)
    p_val = rng.integers(0, np.maximum(p_row, 1)).astype(np.int32)
    e_row = rng.choice(cap, max(cap // 64, 8), replace=False).astype(np.int32)
    cols = [state_deps, np.zeros(cap, np.int32), np.ones(cap, np.int32),
            np.arange(cap, dtype=np.int32), occ, executed, u_row, deps[resident:],
            np.full(len(u_row), -1, np.int32), np.ones(len(u_row), np.int32),
            u_row + 1, p_row, p_col, p_val, e_row]
    return [torch.tensor(a, device=CARD) for a in cols]


def sims_dispatches(K, gp_module, shapes):
    """The inputs (on the host) of the first general dispatch at each of
    ``shapes`` ((slots, width)) whose resolve is not the fast path, from
    EPaxos and Atlas through ``Runner(device="cpu")`` (the sims of phase 4,
    whose dispatches on the card take the same inputs)."""
    found = {}
    real = gp_module.resolve_graph_plane_step

    def capture(*args, mode):
        shape = tuple(args[0].shape)
        if mode == "general" and shape in shapes and shape not in found:
            saved = clone_args(args)
            _dmat, n_bad = K.graph_prologue_plain(*clone_args(args), general=True)
            if int(n_bad[0]):
                found[shape] = saved
        return real(*args, mode=mode)

    gp_module.resolve_graph_plane_step = capture
    try:
        for name in ("EPaxos", "Atlas"):
            if len(found) < len(shapes):
                sim_run("cpu", name)
    finally:
        gp_module.resolve_graph_plane_step = real
    assert len(found) == len(shapes), f"the sims gave no dispatch at {set(shapes) - set(found)}"
    return found


def phase_chain(torch, K, gp_module, one_launch=True):
    """Every launch of a general dispatch (the prologue's general fold,
    ``mutual_collapse``, ``affine_loop`` with the plane's epilogue folded
    in, or on an older checkout ``plane_epilogue`` after it, ``lex_sort``
    with 4 keys) at the sims' shapes (1,024 x 4 and 1,024 x 8, each
    the sims' first dispatch that is not the fast path), each held against
    its plain version, timed single and in the loop beside its byte bound,
    and counted in operations on the card by ``torch.profiler``; the whole
    dispatch too.  Then ``mutual_collapse`` at 4,096 x 4 (mode general's
    window) and 2^16 x 4 (cooperative) on a permuted and a cycle-rich
    window, ``graph_prologue`` in modes general and keyed at 4,096 and 2^20
    slots, ``mutual_collapse`` in both forms over 256-4,096 rows, and an
    empty kernel's launch: the floor of a one-launch kernel.  With ``one_launch``
    (the whole smoke; not on an older checkout) every ``mutual_collapse``
    call and general prologue call must be one operation on the card (the
    keyed prologue is three), and a dispatch one kernel a wrapper and the
    one read of the fast-path count."""
    from fantoch_tpu_torch.ops import graph_resolve

    out = {"launch_floor": launch_floor(torch, K), "sims": {}, "collapse": {},
           "prologue": {}, "forms": {}}
    for (cap, width), args in sims_dispatches(K, gp_module, ((1024, 4), (1024, 8))).items():
        args = [a.to(CARD) for a in args]
        label = f"{cap} x {width}"
        chain = {}
        chain["graph_prologue"], (dmat, _n_bad), after = stage_record(
            torch, K, "graph_prologue", args, {"general": True})
        _deps, _key, src, seq, occ, executed = after[:6]
        chain["mutual_collapse"], collapsed, _ = stage_record(
            torch, K, "mutual_collapse", (dmat,))
        chain["mutual_collapse"]["steps_changing"] = collapse_steps(K, dmat)
        leader, tgt, add, missing, member_count = collapsed
        max_iters = 4 * K.num_doubling_steps(cap) + 8
        affine = (tgt, add, missing, leader, member_count, max_iters)
        # the epilogue folded into the affine loop where the checkout folds it
        folds = hasattr(K, "EPILOGUE_FOLDS")
        chain["affine_loop"], got, _ = stage_record(
            torch, K, "affine_loop", (*affine, occ, executed) if folds else affine)
        resolved, rank, rounds = got[0], got[1], got[-1]
        chain["affine_loop"]["rounds"] = int(rounds.item())
        chain["affine_loop"]["epilogue_folded"] = folds
        chain["lex_sort"], _order, _ = stage_record(
            torch, K, "lex_sort", ([rank, leader, src, seq],))
        if not folds:
            chain["plane_epilogue"], _newly, _ = stage_record(
                torch, K, "plane_epilogue", (occ, executed, resolved))
        step = graph_resolve.graph_plane_step_core
        chain["dispatch"] = {
            "ms": time_ms(step, args, {"mode": "general"}),
            "ms_loop": time_loop_ms(step, args, {"mode": "general"}),
            "sum_of_launches_ms": sum(r["ms"] for r in chain.values()),
            "sum_of_launches_ms_loop": sum(r["ms_loop"] for r in chain.values()),
            "call": (step, clone_args(args), {"mode": "general"}),
        }
        out["sims"][label] = chain
    # mutual_collapse at the table's shape and above mode general's window
    for rows in (GENERAL_C, COOP_B):
        perm = np.random.default_rng(rows).permutation(rows)
        for kind, deps in (("permuted", general_workload(rows)[1][perm]),
                           ("cycle-rich", cycle_rich(rows, GENERAL_FEED)[1])):
            t = torch.tensor(deps, device=CARD)
            record, _got, _ = stage_record(torch, K, "mutual_collapse", (t,))
            record["steps_changing"] = collapse_steps(K, t)
            record["steps"] = K.num_doubling_steps(rows)
            out["collapse"][f"{rows} x {GENERAL_WIDTH}, {kind}"] = record
    for cap, seed in ((GENERAL_C, 3), (BIG, 4)):
        args = prologue_inputs(torch, cap, GENERAL_WIDTH, seed)
        for mode in ("general", "keyed"):
            record, _got, _ = stage_record(torch, K, "graph_prologue", args,
                                           {"general": mode == "general"})
            out["prologue"][f"{mode}, {cap} x {GENERAL_WIDTH}"] = record
    counted = [r for chain in out["sims"].values() for r in chain.values()]
    counted += list(out["collapse"].values()) + list(out["prologue"].values())
    if out["launch_floor"]:
        counted.append(out["launch_floor"])
    count_ops(torch, counted)
    for label, chain in out["sims"].items():
        log(json.dumps({"phase4b_chain": label, **{
            k: {f: v[f] for f in ("ms", "ms_loop", "device_ops", "device_ms")}
            for k, v in chain.items()}}))
    if one_launch:
        one = [(label, c["graph_prologue"]) for label, c in out["sims"].items()]
        one += [(label, c["mutual_collapse"]) for label, c in out["sims"].items()]
        one += list(out["collapse"].items())
        one += [(label, r) for label, r in out["prologue"].items() if label.startswith("general")]
        for label, record in one:
            assert record["device_ops"] == 1, (label, record["op_names"])
        for label, chain in out["sims"].items():
            # a kernel a wrapper (the epilogue folded into the affine loop's)
            names = chain["dispatch"]["op_names"]
            kernels = [n for n in names if not n.startswith("Memcpy")]
            assert len(kernels) == len(chain) - 1, (label, names)
            assert not any("k_epilogue" in n for n in names), (label, names)
            assert chain["dispatch"]["device_ops"] == len(kernels) + 1, (label, names)
    # both forms of the mutual collapse over the sweep's rows
    for rows in CHAIN_SWEEP:
        perm = np.random.default_rng(rows).permutation(rows)
        for kind, deps in (("permuted", general_workload(rows)[1][perm]),
                           ("cycle-rich", cycle_rich(rows, min(rows, GENERAL_FEED))[1])):
            t = torch.tensor(deps, device=CARD)
            forms = one_launch_forms(K, "mutual_collapse", "CTA_ROWS", (t,), {},
                                     collapse_smem(rows, GENERAL_WIDTH), on_card=True)
            if forms:
                out["forms"][f"mutual_collapse, {rows} x 4, {kind}"] = forms
    forms_on_card(torch, out["forms"])
    log(json.dumps({"general_chain": out}))
    return out


# ---------------------------------------------------------------------------
# the votes-table plane (phases 5 and 6)
# ---------------------------------------------------------------------------

CARD = "cuda"
TABLE_SOURCE = "fantoch_tpu_torch/csrc/table_plane.cu"
TABLE_REPLACES = {
    "clock_proposal": "fantoch_tpu/ops/pallas_resolve.py:441",
    "clock_bump": "fantoch_tpu/ops/pallas_resolve.py:441",
    "vote_runs": "fantoch_tpu/ops/pallas_resolve.py:394",
    "stable_rows": "fantoch_tpu/ops/pallas_resolve.py:394",
}
TABLE_BATCH = 100_000  # bench.py bench_table_path
TABLE_KEYS = 4096
TABLE_N = 3
TABLE_KCAP = 8192  # next_pow2(4096 + 1): the pad bucket is the last
TABLE_VCAP = 1 << 19  # next_pow2(100,000 x 3)
TABLE_BIG = 1 << 20  # the grid-wide shape: K = V = 2^20, n = 5
FUSED_BATCH = 1 << 17  # bench.py _bench_fused_table_rounds
FUSED_CHAIN = 8


def table_round_votes(gap_rate=0.0, seed=11):
    """The vote columns of one ``bench_table_path`` round on a fresh table:
    100,000 single-key commands on 4,096 keys (seed 11), each voted
    ``[vote_start, clock]`` by the three processes, padded to 2^19 rows
    with invalid ones; with ``gap_rate`` that share of process 2's ranges
    is missing, so its later ranges on those keys come back residual."""
    import torch

    from fantoch_tpu_torch.ops import table_kernels as T

    rng = np.random.default_rng(seed)
    key_ids = rng.integers(0, TABLE_KEYS, TABLE_BATCH).astype(np.int32)
    prior = torch.zeros(TABLE_KCAP, dtype=torch.int32)
    clock, start = T.clock_proposal_plain(
        prior, torch.tensor(key_ids), torch.zeros(TABLE_BATCH, dtype=torch.int32)
    )
    V = TABLE_BATCH * TABLE_N
    vcap = TABLE_VCAP
    cols = np.zeros((4, vcap), dtype=np.int32)
    cols[0, :V] = np.repeat(key_ids, TABLE_N)
    cols[1, :V] = np.tile(np.arange(TABLE_N), TABLE_BATCH)
    cols[2, :V] = np.repeat(start.numpy(), TABLE_N)
    cols[3, :V] = np.repeat(clock.numpy(), TABLE_N)
    valid = np.zeros(vcap, dtype=bool)
    valid[:V] = True
    if gap_rate:
        drop = (cols[1, :V] == 1) & (rng.random(V) < gap_rate)
        valid[:V][drop] = False
    return [torch.tensor(c) for c in cols] + [torch.tensor(valid)]


def table_library_call(torch, name, args):
    """The one PyTorch call that computes the same function as a table
    wrapper's use, where there is one (a yardstick, used nowhere in the
    port): ``kthvalue`` for the stable clocks, ``scatter_reduce_`` for the
    bump; None otherwise."""
    if name == "stable_rows" and (len(args) < 3 or args[2] is None):
        frontier, threshold = args[0], args[1]
        return torch.kthvalue(frontier, frontier.shape[1] - threshold + 1, dim=1).values
    if name == "clock_bump":
        prior, idx, clock = args
        return prior.scatter_reduce_(0, idx.long(), clock, "amax")
    return None


# the table wrappers timed both ways (the redesigned stable_rows and the
# callers of the redesigned lex_sort)
LOOP_TIMED = ("stable_rows", "vote_runs", "clock_proposal")


def table_sort_uses(torch, dev, commit, prop):
    """The sorts inside ``vote_runs`` and ``clock_proposal`` on their phase 5
    inputs, each held against ``lex_sort_plain`` exactly and timed both ways
    beside its bound and the one PyTorch call that computes it:
    ``torch.sort(stable=True)`` of the key for the proposal's, and of the
    int64 column ``(gid << 32) | (vstart ^ 0x80000000)`` (built before the
    timing) for the commit's (gid, vstart).  Returns the rows for the
    ``lex_sort`` record's uses."""
    from fantoch_tpu_torch.ops import graph_plane_kernels as K

    vkey, vby, vstart, _vend, valid = commit
    gid = torch.where(valid, vkey * TABLE_N + vby, TABLE_KCAP * TABLE_N).to(torch.int32)
    packed = (gid.long() << 32) | ((vstart.long() & 0xFFFFFFFF) ^ 0x80000000)
    key = prop[1]
    sorts = (
        (f"lex_sort, 2 keys (vote_runs' gid, vstart), V={TABLE_VCAP}", [gid, vstart],
         "torch.sort(stable=True) of (gid << 32) | (vstart ^ 0x80000000)", packed),
        (f"lex_sort, 1 key (clock_proposal), B={FUSED_BATCH}", [key],
         "torch.sort(stable=True)", key),
    )
    rows = []
    for use, keys, library, column in sorts:
        got = K.lex_sort(keys)
        err = max_abs_err(got, K.lex_sort_plain(keys), use)
        assert err == 0.0, f"{use}: kernel differs from its plain version"
        indices = torch.sort(column, stable=True).indices
        assert torch.equal(indices.to(torch.int32), got), f"{use}: the yardstick differs"
        nbytes = sum(k.numel() * k.element_size() for k in keys) + got.numel() * 4
        row = {
            "use": use, "shape": describe(keys),
            "ms": time_ms(K.lex_sort, (keys,), {}),
            "ms_loop": time_loop_ms(K.lex_sort, (keys,), {}),
            "plain_ms": time_ms(K.lex_sort_plain, (keys,), {}),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "library": library,
            "library_ms": time_ms(lambda c: torch.sort(c, stable=True), (column,), {}),
            "library_ms_loop": time_loop_ms(
                lambda c: torch.sort(c, stable=True), (column,), {}),
        }
        log(json.dumps({"phase5_kernel": use, **row}))
        rows.append(row)
    return rows


def table_moved_bytes(torch, name, args, out):
    """The bytes a table wrapper's function must move: each input read once
    and each output written once, where of the resident state (prior,
    frontier) only the cells this call's data touches count, read and
    written: the distinct keys of a proposal or a bump, the distinct run
    cells of a commit (the slots that are no run share ``frontier[0, 0]``),
    and in the table-round mode the touched keys' prior cells and voter
    lanes."""
    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    if name == "clock_proposal":
        prior, key, min_clock = args
        cells = torch.unique(key).numel()
        return nbytes(key, min_clock, *out) + 2 * cells * prior.element_size()
    if name == "clock_bump":
        prior, idx, clock = args
        cells = torch.unique(idx).numel()
        return nbytes(idx, clock) + 2 * cells * prior.element_size()
    if name == "vote_runs":
        frontier, columns = args[0], args[1:]
        run_key, run_by = out[0], out[1]
        cells = torch.unique(run_key.long() * frontier.shape[1] + run_by.long()).numel()
        return nbytes(*columns, *out) + 2 * cells * frontier.element_size()
    frontier = args[0]
    if len(args) < 3 or args[2] is None:
        return nbytes(frontier, out)
    key, clock, prior_old, _new_prior, voters = args[2]
    touched = torch.unique(key).numel()
    return (nbytes(frontier, key, clock, *out)
            + 2 * touched * prior_old.element_size()
            + touched * voters * frontier.element_size())


def fused_chain_inputs(torch, dev):
    """The keys and minimum clocks of ``bench.py``'s fused table rounds:
    S = 8 rounds of B = 2^17 commands on 4,096 keys (seed 19)."""
    rng = np.random.default_rng(19)
    keys = rng.integers(0, TABLE_KEYS, (FUSED_CHAIN, FUSED_BATCH)).astype(np.int32)
    mins = torch.zeros((FUSED_CHAIN, FUSED_BATCH), dtype=torch.int32, device=dev)
    return torch.tensor(keys, device=dev), mins


def fused_chain(torch, table_ops, keys, mins, threshold):
    """``fused_table_rounds`` over ``keys``/``mins`` from a fresh table on
    their device."""
    prior = torch.zeros(TABLE_KCAP, dtype=torch.int32, device=keys.device)
    frontier = torch.zeros((TABLE_KCAP, TABLE_N), dtype=torch.int32, device=keys.device)
    return table_ops.fused_table_rounds(prior, frontier, keys, mins,
                                        threshold=threshold, voters=TABLE_N)


def table_draws(torch):
    """Phase 5's seeded inputs (CPU tensors), drawn in one order: ``big``
    (vote_runs and stable_rows grid-wide: K = V = ``TABLE_BIG``, n = 5),
    ``prop`` (clock_proposal: B = ``FUSED_BATCH`` over K = ``TABLE_KCAP``,
    ``CONFLICT`` of it on key 0) and ``bump`` (clock_bump: M = 4,096)."""
    rng = np.random.default_rng(SEED)
    big_k, big_n, big_v = TABLE_BIG, 5, TABLE_BIG
    big_start = rng.integers(1, 64, big_v)
    big = [
        torch.tensor(rng.integers(0, 16, (big_k, big_n)).astype(np.int32)),
        torch.tensor(rng.integers(0, big_k, big_v).astype(np.int32)),
        torch.tensor(rng.integers(0, big_n, big_v).astype(np.int32)),
        torch.tensor(big_start.astype(np.int32)),
        torch.tensor((big_start + rng.integers(0, 8, big_v)).astype(np.int32)),
        torch.tensor(rng.random(big_v) < 0.9),
    ]
    hot = np.where(rng.random(FUSED_BATCH) < CONFLICT, 0,
                   rng.integers(1, TABLE_KEYS, FUSED_BATCH)).astype(np.int32)
    prop = [
        torch.tensor(rng.integers(0, 50, TABLE_KCAP).astype(np.int32)),
        torch.tensor(hot),
        torch.tensor(np.where(rng.random(FUSED_BATCH) < 0.1, 60, 0).astype(np.int32)),
    ]
    bump_m = 4096
    bump = [
        torch.tensor(rng.integers(0, 100, TABLE_KCAP).astype(np.int32)),
        torch.tensor(rng.integers(0, TABLE_KCAP - 1, bump_m).astype(np.int32)),
        torch.tensor(rng.integers(0, 200, bump_m).astype(np.int32)),
    ]
    return big, prop, bump


def phase5(torch, T, table_ops):
    """The table kernels against their plain versions on the card."""
    from fantoch_tpu_torch.core import Config

    dev = torch.device(CARD)
    _fast, _write, threshold = Config(TABLE_N, 1).newt_quorum_sizes()

    def cuda(tensors):
        return [t.to(dev) for t in tensors]

    commit = cuda(table_round_votes())
    commit_gaps = cuda(table_round_votes(gap_rate=0.05))
    zeros3 = torch.zeros((TABLE_KCAP, TABLE_N), dtype=torch.int32, device=dev)
    big_k, big_n, big_v = TABLE_BIG, 5, TABLE_BIG
    big, prop, bump = (cuda(t) for t in table_draws(torch))
    bump_m = int(bump[1].numel())
    round_keys, round_mins = fused_chain_inputs(torch, dev)
    prior0 = torch.zeros(TABLE_KCAP, dtype=torch.int32, device=dev)
    # the inputs of stable_rows' round mode on the first round
    r_prior = prior0.clone()
    r_clock, _ = T.clock_proposal_plain(r_prior, round_keys[0], round_mins[0])
    round_args = (zeros3, threshold, (round_keys[0], r_clock, prior0, r_prior, TABLE_N))

    # (use, wrapper, args): every call held against the plain version and
    # timed; the first use of a wrapper is its record's own
    shape = f"K={TABLE_KCAP} n={TABLE_N}"
    uses = [
        (f"vote_runs, contiguous, {shape} V={TABLE_VCAP}", "vote_runs",
         [zeros3] + commit),
        (f"vote_runs, with gaps, {shape} V={TABLE_VCAP}", "vote_runs",
         [zeros3] + commit_gaps),
        (f"vote_runs, grid-wide, K={big_k} n={big_n} V={big_v}", "vote_runs", big),
        (f"stable_rows, {shape}", "stable_rows",
         (torch.randint(0, 1 << 20, (TABLE_KCAP, TABLE_N), dtype=torch.int32,
                        device=dev), threshold)),
        (f"stable_rows, grid-wide, K={big_k} n={big_n}", "stable_rows", (big[0], 3)),
        (f"stable_rows, table round, {shape} B={FUSED_BATCH}", "stable_rows",
         round_args),
        (f"clock_proposal, B={FUSED_BATCH} K={TABLE_KCAP}, 50% on one key",
         "clock_proposal", prop),
        (f"clock_bump, M={bump_m} K={TABLE_KCAP}", "clock_bump", bump),
    ]
    records, err = {}, {name: 0.0 for name in T.LAUNCHES}
    for use, name, args in uses:
        kernel, plain = getattr(T, name), getattr(T, f"{name}_plain")
        args = tuple(args)
        plain_args, kernel_args = clone_args(args), clone_args(args)
        want = plain(*plain_args)
        got = kernel(*kernel_args)
        e = max(max_abs_err(got, want, use), max_abs_err(kernel_args, plain_args, use))
        err[name] = max(err[name], e)
        assert e == 0.0, f"{use}: kernel differs from its plain version"
        if name == "vote_runs":
            residual = int(got[4].sum())
            assert ("gaps" in use) == (residual > 0) or "grid-wide" in use, (use, residual)
        ms = time_ms(kernel, args, {})
        plain_ms = time_ms(plain, args, {})
        library_ms = None
        library = table_library_call(torch, name, args) is not None
        if library:
            library_ms = time_ms(lambda *a: table_library_call(torch, name, a), args, {})
        loops = {}
        if name in LOOP_TIMED:
            loops["ms_loop"] = time_loop_ms(kernel, args, {})
            loops["library_ms_loop"] = None
            if library:
                loops["library_ms_loop"] = time_loop_ms(
                    lambda *a: table_library_call(torch, name, a), args, {})
        nbytes = table_moved_bytes(torch, name, args, got)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"use": use, "shape": describe(args), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "library_ms": library_ms, **loops}
        log(json.dumps({"phase5_kernel": use, "ms": ms, "plain_ms": plain_ms,
                        "bytes": nbytes, "bound_ms": bound_ms,
                        "library_ms": library_ms, **loops, "shape": describe(args)}))
        if name not in records:
            records[name] = {
                "name": name, "route": "cuda", "source": TABLE_SOURCE,
                "replaces": TABLE_REPLACES[name], "launches": 0, "max_abs_err": 0.0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": library_ms, **loops,
                "shape": row["shape"], "uses": [],
            }
        records[name]["uses"].append(row)
    records["uses"] = table_sort_uses(torch, dev, commit, prop)

    # the composed entry points, every wrapper call checked on the card
    checker = Checker(T)
    checker.install()
    try:
        out = table_ops.fused_votes_commit(zeros3.clone(), *commit_gaps, threshold=threshold)
        assert int(out[6].sum()) > 0, "the gapped round left no residual run"
        prior, frontier = prior0.clone(), zeros3.clone()
        table_ops.fused_table_round(prior, frontier, round_keys[0], round_mins[0],
                                    threshold=threshold, voters=TABLE_N)
        t0 = time.perf_counter()
        chain = fused_chain(torch, table_ops, round_keys, round_mins, threshold)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
    finally:
        checker.uninstall()
    want = fused_chain(torch, table_ops, round_keys.cpu(), round_mins.cpu(), threshold)
    for i, (g, w) in enumerate(zip(chain, want)):
        assert torch.equal(g.cpu(), w), f"fused_table_rounds output {i} differs from CPU"
    executable = chain[4]
    assert int(chain[5].sum()) == 0 and bool(executable.all()), (
        "the dense chain left gaps or unexecutable commands")
    for name in T.LAUNCHES:
        err[name] = max(err[name], checker.err[name])
        records[name]["max_abs_err"] = err[name]
    log(f"phase 5: every table kernel call equal to its plain version; the S = "
        f"{FUSED_CHAIN} fused_table_rounds chain (B = {FUSED_BATCH}) equal to its "
        f"CPU composition ({chain_s * 1e3:.3f} ms with every call checked); "
        f"checked calls {checker.count}")
    return records


def newt_steady_rounds(device, rounds=3):
    """``bench.py``'s ``steady_rounds(plane=True)`` on ``device``: a
    persistent ``BatchedKeyClocks`` and ``TableExecutor`` on the votes-table
    plane; each round proposes 100,000 single-key commands on 4,096 keys
    and commits them voted by all three processes.  Between rounds 64 keys
    take a scalar clock bump (live Newt's detached bumps), folded into the
    resident clock table by the next batch; their detached votes ride the
    next round.  Returns the per-key drain order, the round times (ms) and
    the counters."""
    from fantoch_tpu_torch.core import Config, KVOp, Rifl, RunTime
    from fantoch_tpu_torch.core.command import Command
    from fantoch_tpu_torch.executor.table import TableExecutor, TableVotesArrays
    from fantoch_tpu_torch.protocol.common.table_batched import BatchedKeyClocks
    from fantoch_tpu_torch.protocol.common.table_clocks import Votes
    import torch

    rng = np.random.default_rng(11)
    key_ids = rng.integers(0, TABLE_KEYS, TABLE_BATCH)
    key_strs = [f"t{k}" for k in key_ids.tolist()]
    mins = [0] * TABLE_BATCH
    pids = np.arange(1, TABLE_N + 1, dtype=np.int64)
    config = Config(TABLE_N, 1, newt_detached_send_interval_ms=5,
                    batched_table_executor=True, device_table_plane=True)
    executor = TableExecutor(1, 0, config, device=device)
    clocks = BatchedKeyClocks(1, 0, device=device)
    ones = np.ones(TABLE_BATCH, dtype=np.int64)
    seqs = np.arange(1, TABLE_BATCH + 1, dtype=np.int64)
    ops = [(KVOp.put(""),)] * TABLE_BATCH
    bump_rng = np.random.default_rng(5)
    order, times = {}, []
    det = ([], [], [], [])
    for r in range(rounds + 1):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck, st = clocks.proposal_batch_arrays(key_strs, mins)
        batch = TableVotesArrays(
            keys=key_strs, dot_src=ones, dot_seq=seqs + r * TABLE_BATCH, clock=ck,
            rifl_src=ones, rifl_seq=seqs + r * TABLE_BATCH, ops=ops,
            vote_row=np.repeat(np.arange(TABLE_BATCH, dtype=np.int64), TABLE_N),
            vote_by=np.tile(pids, TABLE_BATCH), vote_start=np.repeat(st, TABLE_N),
            vote_end=np.repeat(ck, TABLE_N),
            det_keys=det[0] or None,
            det_by=np.asarray(det[1], np.int64) if det[0] else None,
            det_start=np.asarray(det[2], np.int64) if det[0] else None,
            det_end=np.asarray(det[3], np.int64) if det[0] else None,
        )
        executor.handle_batch_arrays(batch, RunTime())
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        drained = 0
        while (res := executor.to_clients()) is not None:
            order.setdefault(res.key, []).append(res.rifl.sequence)
            drained += 1
        assert drained == TABLE_BATCH, f"round {r} drained {drained} of {TABLE_BATCH}"
        # scalar bumps before the next batch
        top = np.zeros(TABLE_KEYS, dtype=np.int64)
        np.maximum.at(top, key_ids, ck)
        votes = Votes()
        for i, k in enumerate(bump_rng.choice(TABLE_KEYS, 64, replace=False).tolist()):
            cmd = Command.from_single(Rifl(2, r * 64 + i + 1), 0, f"t{k}", KVOp.put(""))
            clocks.detached(cmd, int(top[k]) + 3, votes)
        det = ([], [], [], [])
        for key, ranges in votes:
            for vote in ranges:
                for p in pids.tolist():
                    det[0].append(key)
                    det[1].append(p)
                    det[2].append(vote.start)
                    det[3].append(vote.end)
    counters = {**executor.device_counters(), **clocks.device_counters()}
    return order, times[1:], counters


def newt_sim(device, n=5, f=2):
    """Newt through the simulator at ``tests/harness.py``'s shape (two keys
    per command, 50% conflict, message reordering, seed 0) on the
    votes-table plane; returns per-key orders, latency histograms, digests
    and the runner."""
    from fantoch_tpu_torch.client import ConflictRateKeyGen, Workload
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch import protocol
    from fantoch_tpu_torch.sim import Runner

    config = Config(
        n, f, newt_detached_send_interval_ms=100, batched_table_executor=True,
        device_table_plane=True, execution_digests=True,
        executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
    )
    planet = Planet.new("gcp")
    workload = Workload(
        shard_count=1, key_gen=ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=10, payload_size=1,
    )
    regions = sorted(planet.regions())[:n]
    runner = Runner(
        protocol.Newt, planet, config, workload, 3,
        process_regions=list(regions), client_regions=list(regions), seed=0,
        device=device,
    )
    runner.reorder_messages()
    _metrics, monitors, latencies = runner.run(extra_sim_time_ms=10_000)
    orders = {
        pid: {k: [(r.source, r.sequence) for r in m.get_order(k)] for k in sorted(m.keys())}
        for pid, m in monitors.items()
    }
    hists = {str(r): (c, list(h.values())) for r, (c, h) in latencies.items()}
    digests = {pid: e.digest().summary() for pid, (_p, e, _q) in runner._simulation.processes()}
    return orders, hists, digests, runner


# the paths of phase 6, each driven with the counts set to 0 just before
# it and read just after it; the kernels each path must launch; and the
# path whose count is a kernel's ``launches`` (the Newt simulator for the
# commit kernels, the steady rounds for the batched proposal's, which the
# simulator's scalar proposals never reach)
TABLE_PATHS = {
    "steady": ("clock_proposal", "clock_bump", "vote_runs", "stable_rows"),
    "sim": ("vote_runs", "stable_rows"),
    "fused_rounds": ("clock_proposal", "stable_rows"),
}
TABLE_MAIN_PATH = {"clock_proposal": "steady", "clock_bump": "steady",
                   "vote_runs": "sim", "stable_rows": "sim"}


def phase6(torch, T, K, table_ops):
    """The Newt paths on the card; returns each table kernel's launches by
    path."""
    by_path = {}

    def counted(path, fn, *args):
        T.reset_launch_counts()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[path] = {**T.LAUNCHES, "lex_sort": K.LAUNCHES["lex_sort"]}
        missing = [name for name in TABLE_PATHS[path] + ("lex_sort",)
                   if by_path[path][name] == 0]
        assert not missing, f"kernels of the {path} path never launched: {missing}"
        return out, wall

    (order, times, counters), steady_s = counted("steady", newt_steady_rounds, CARD)
    sim_got, sim_cuda_s = counted("sim", newt_sim, CARD)
    from fantoch_tpu_torch.core import Config

    _fast, _write, threshold = Config(TABLE_N, 1).newt_quorum_sizes()
    keys, mins = fused_chain_inputs(torch, torch.device(CARD))
    chain, chain_s = counted("fused_rounds", fused_chain, torch, table_ops, keys, mins,
                             threshold)
    t0 = time.perf_counter()
    cpu_order, cpu_times, _ = newt_steady_rounds("cpu")
    steady_cpu_s = time.perf_counter() - t0
    rounds = len(times) + 1
    seqs = sorted(q for qs in order.values() for q in qs)
    assert seqs == list(range(1, rounds * TABLE_BATCH + 1)), "not every command once"
    assert order == cpu_order, "per-key drain order differs from the cpu run"
    assert counters["clock_window_fallbacks"] == 0, counters
    assert counters["clock_table_resident_uploads"] == 1, counters
    assert counters["table_plane_resident_uploads"] == 1, counters
    t0 = time.perf_counter()
    sim_want = newt_sim("cpu")
    sim_cpu_s = time.perf_counter() - t0
    assert sim_got[0] == sim_want[0], "Newt: per-key orders differ from the cpu run"
    assert sim_got[1] == sim_want[1], "Newt: latency histograms differ from the cpu run"
    assert sim_got[2] == sim_want[2], "Newt: execution digests differ from the cpu run"
    sim_counters = [e.device_counters() for _p, (_x, e, _q)
                    in sim_got[3]._simulation.processes()]
    assert all(c["table_plane_dispatches"] > 0 for c in sim_counters)
    want = fused_chain(torch, table_ops, keys.cpu(), mins.cpu(), threshold)
    for i, (g, w) in enumerate(zip(chain, want)):
        assert torch.equal(g.cpu(), w), f"fused_table_rounds output {i} differs from CPU"
    p50 = float(np.median(times))
    log(f"phase 6: {rounds} steady rounds of {TABLE_BATCH} commands on cuda, every "
        f"command drained once in the cpu run's per-key order: median timed round "
        f"{p50:.3f} ms ({TABLE_BATCH / p50 * 1e3:.1f} commands/s; cpu "
        f"{float(np.median(cpu_times)):.3f} ms); counters {counters}")
    log(f"phase 6: Newt through Runner(device='cuda') equal to Runner(device='cpu') "
        f"in per-key orders, latency histograms and digests; sim wall cuda "
        f"{sim_cuda_s:.3f} s, cpu {sim_cpu_s:.3f} s; the S = {FUSED_CHAIN} "
        f"fused_table_rounds chain unchecked on cuda equal to cpu in "
        f"{chain_s * 1e3:.3f} ms; launches by path {by_path}")
    log(json.dumps({"newt_path": {
        "commands_per_round": TABLE_BATCH, "timed_rounds": len(times),
        "round_ms": times, "median_round_ms": p50,
        "commands_per_s": TABLE_BATCH / p50 * 1e3, "cpu_round_ms": cpu_times,
        "steady_wall_s": steady_s, "steady_cpu_wall_s": steady_cpu_s,
        "counters": counters, "sim_cuda_wall_s": sim_cuda_s,
        "sim_cpu_wall_s": sim_cpu_s,
        "sim_table_dispatches": sum(c["table_plane_dispatches"] for c in sim_counters),
        "fused_rounds_ms": chain_s * 1e3, "launches_by_path": by_path,
    }}))
    return by_path


# ---------------------------------------------------------------------------
# the predecessors plane (phases 7 and 8)
# ---------------------------------------------------------------------------

PRED_SOURCE = "fantoch_tpu_torch/csrc/pred_plane.cu"
PRED_REPLACES = "fantoch_tpu/ops/pallas_resolve.py:264"
PRED_WIDTH = 3  # bench.py bench_pred_path: up to 3 same-key predecessors
# (use, batch, keys, feeds, slot capacity or None for the plane's growth):
# bench_pred_path's own defaults, the table path's round on its key count
# (the steady shape), and the full window of 2^20 slots filled by 4 feeds
# of 2^18
PRED_SHAPES = (
    ("small window", 4096, 512, 3, None),
    ("steady", TABLE_BATCH, TABLE_KEYS, 3, None),
    ("full window", 1 << 18, TABLE_KEYS, 4, BIG),
)
PRED_MAIN_USE = "steady"
PRED_WARM, PRED_TIMED = 2, 3


def pred_workload(batch, keys, feeds, width=PRED_WIDTH, seed=17):
    """``bench.py``'s ``bench_pred_path`` generator, vectorized: command i
    (src 1 + i % 3, seq i // 3 + 1, clock i + 1) on one uniform key of
    ``keys``, depending on the up to ``width`` commands before it on that
    key; cut into feeds of ``batch`` in commit order, each feed's first
    command swapped with the next feed's last (the cross-feed residual
    seam: its same-key successors wait on a MISSING cell until it
    commits).  Returns ``PredExecutionArrays`` feeds whose commands are
    the command indices, and the key of every command."""
    from fantoch_tpu_torch.executor.pred import PredExecutionArrays

    rng = np.random.default_rng(seed)
    total = batch * feeds
    i = np.arange(total, dtype=np.int64)
    src, seq = 1 + i % 3, i // 3 + 1
    key = rng.integers(0, keys, total)
    order = np.lexsort((i, key))
    head = np.r_[True, key[order][1:] != key[order][:-1]]
    rank = i - np.maximum.accumulate(np.where(head, i, 0))
    deps = np.full((total, width), -1, dtype=np.int64)
    for k in range(1, width + 1):
        ok = rank >= k
        deps[order[ok], k - 1] = order[i[ok] - k]
    cuts = [list(range(b * batch, (b + 1) * batch)) for b in range(feeds)]
    for b in range(feeds - 1):
        cuts[b][0], cuts[b + 1][-1] = cuts[b + 1][-1], cuts[b][0]
    out = []
    for cut in cuts:
        idx = np.asarray(cut, dtype=np.int64)
        rows, cols = np.nonzero(deps[idx] >= 0)
        dep = deps[idx][rows, cols]
        out.append(PredExecutionArrays(
            dot_src=src[idx], dot_seq=seq[idx], clock_seq=idx + 1, clock_src=src[idx],
            cmds=idx.tolist(), dep_row=rows.astype(np.int64), dep_src=src[dep],
            dep_seq=seq[dep],
        ))
    return out, key


def pred_moved_bytes(torch, args, out):
    """The bytes a window step must move: the feed read once; the installed
    rows and patched cells written; the pending rows' dep cells and the
    clock, src and occupancy of the rows they and their targets touch
    read once; ``executed`` read and its newly set cells written;
    ``newly`` written.  Only the state cells this step touches count."""
    deps, clock, src, occ, executed = args[:5]
    u_row, p_row, p_col = args[5], args[9], args[10]
    cap, width = deps.shape
    feed = sum(t.numel() * t.element_size() for t in args[5:])
    rows = u_row[(u_row >= 0) & (u_row < cap)].long()
    cells = ((p_row >= 0) & (p_row < cap) & (p_col >= 0) & (p_col < width)).sum()
    installed = rows.numel() * (4 * width + 4 + 4 + 1 + 1) + int(cells) * 4
    # the pending rows after the install, with the installed rows' deps
    new_occ, new_exec, new_deps = occ.clone(), executed.clone(), deps.clone()
    new_occ[rows], new_exec[rows] = True, False
    new_deps[rows] = args[6][(u_row >= 0) & (u_row < cap)]
    pending = new_occ & ~new_exec
    targets = new_deps[pending]
    targets = targets[targets >= 0].clamp(max=cap - 1).long()
    touched = torch.zeros(cap, dtype=torch.bool, device=deps.device)
    touched[pending] = True
    touched[targets] = True
    newly = out[5]
    return (feed + installed + int(pending.sum()) * 4 * width
            + int(touched.sum()) * (4 + 4 + 1) + cap + int(newly.sum()) + cap)


def pred_plane_run(P, device, batch, keys, feeds, capacity, record=None):
    """One plane on ``device`` fed ``pred_workload(batch, keys, feeds)``
    through ``add_arrays``; returns the plane, the per-key drain order and
    the wall ms of each feed.  ``record`` (a list) receives, for each
    dispatch, clones of the step's arguments and its work (``pred_work``)."""
    import torch

    from fantoch_tpu_torch.core import Config
    from fantoch_tpu_torch.executor.pred_plane import DevicePredPlane

    arrays, key = pred_workload(batch, keys, feeds)
    kwargs = {"slot_capacity": capacity} if capacity else {}
    plane = DevicePredPlane(1, Config(3, 1), device=device, **kwargs)
    if record is not None:
        wrapper = P.pred_plane_step

        def recorded(*args):
            saved = clone_args(args)
            out = wrapper(*args)
            record.append((saved, pred_work(P)))
            return out

        P.pred_plane_step = recorded
    order, times = {}, []
    try:
        for batch_arrays in arrays:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane.add_arrays(batch_arrays, None)
            if device != "cpu":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            while (c := plane.command_to_execute()) is not None:
                order.setdefault(int(key[c]), []).append(c)
    finally:
        if record is not None:
            P.pred_plane_step = wrapper
    return plane, order, times


def check_pred_order(order, total):
    """Every command once, each key in commit (clock) order."""
    assert sum(len(v) for v in order.values()) == total, "not every command once"
    for k, cmds in order.items():
        assert cmds == sorted(cmds), f"key {k} out of clock order"


def phase7(torch, P):
    """The pred kernels against their plain version on the card, every
    dispatch of three planes held by the Checker; each shape's last
    dispatch timed."""
    checker = Checker(P)
    checker.install()
    records, uses = {}, []
    try:
        for use, batch, keys, feeds, capacity in PRED_SHAPES:
            calls = []
            before = dict(P.VARIANT_LAUNCHES)
            plane, order, wall = pred_plane_run(P, CARD, batch, keys, feeds, capacity,
                                                record=calls)
            check_pred_order(order, batch * feeds)
            variants = {v: P.VARIANT_LAUNCHES[v] - before[v] for v in before}
            args, _ = calls[-1]
            kernel, plain = checker.real["pred_plane_step"], P.pred_plane_step_plain
            ms = time_ms(kernel, args, {})
            got = kernel(*clone_args(args))
            work = pred_work(P)
            plain_ms = time_ms(plain, args, {})
            nbytes = pred_moved_bytes(torch, args, got)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cap, width = args[0].shape
            # the form of the last dispatch, by the wrapper's gates
            one_cta = (cap <= P.ONE_CTA_ROWS
                       and P.one_cta_smem_bytes(cap, width) <= P.ONE_CTA_SMEM_BYTES)
            row = {
                "use": f"pred_plane_step, {use}, C={cap} W={width} B={batch} keys={keys}",
                "variant": "one CTA" if one_cta else "grid",
                "variants": variants, "shape": describe(args), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
                "library_ms": None, "work": work,
                "work_by_dispatch": [w for _a, w in calls],
                "newly": int(got[5].sum()), "dispatches": plane.dispatches,
                "grows": plane.grows, "compactions": plane.stats["compactions"],
                "feed_wall_ms": wall,
            }
            assert variants["one_cta" if one_cta else "grid"] > 0, row
            log(json.dumps({"phase7_kernel": row}))
            uses.append(row)
            if use == PRED_MAIN_USE:
                records["pred_plane_step"] = {
                    "name": "pred_plane_step", "route": "cuda", "source": PRED_SOURCE,
                    "replaces": PRED_REPLACES, "launches": 0, "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": None, "shape": row["shape"],
                    "work": work,
                }
    finally:
        checker.uninstall()
    records["pred_plane_step"]["max_abs_err"] = checker.err["pred_plane_step"]
    records["pred_plane_step"]["uses"] = uses
    log(f"phase 7: every pred_plane_step call equal to its plain version "
        f"(checked calls {checker.count}); work of the timed dispatches "
        f"{[u['work'] for u in uses]}")
    return records


def pred_steady_rounds(P, device):
    """The steady rounds: a plane on ``device`` takes ``PRED_WARM`` warm and
    ``PRED_TIMED`` timed feeds of the steady shape; the host
    ``PredecessorsGraph`` twin takes the same commands.  Returns the
    plane's per-key order, the timed feeds' wall ms, the plane and the
    twin's per-key order."""
    from fantoch_tpu_torch.core import Config
    from fantoch_tpu_torch.executor.pred import PredecessorsGraph, _unpack_arrays

    _use, batch, keys, _feeds, _cap = PRED_SHAPES[1]
    feeds = PRED_WARM + PRED_TIMED
    plane, order, times = pred_plane_run(P, device, batch, keys, feeds, None)
    arrays, key = pred_workload(batch, keys, feeds)
    twin = PredecessorsGraph(1, Config(3, 1))
    twin_order = {}
    for batch_arrays in arrays:
        infos, _noops = _unpack_arrays(batch_arrays)
        for info in infos:
            twin.add(info.dot, info.cmd, info.clock, info.deps, None)
        while (c := twin.command_to_execute()) is not None:
            twin_order.setdefault(int(key[c]), []).append(c)
    return order, times[PRED_WARM:], plane, twin_order


def caesar_sim(device, n=5, f=2, seed=2):
    """Caesar through the simulator at ``tests/harness.py``'s shape (two
    keys per command, 50% conflict, message reordering) on the pred plane,
    n = 5, f = 2 with seed 2 (tests/test_caesar.py's row); returns per-key
    orders, latency histograms, digests and the runner."""
    from fantoch_tpu_torch.client import ConflictRateKeyGen, Workload
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch import protocol
    from fantoch_tpu_torch.sim import Runner

    config = Config(
        n, f, caesar_wait_condition=True, device_pred_plane=True,
        execution_digests=True, executor_monitor_execution_order=True,
        gc_interval_ms=100, executor_executed_notification_interval_ms=100,
    )
    planet = Planet.new("gcp")
    workload = Workload(
        shard_count=1, key_gen=ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=10, payload_size=1,
    )
    regions = sorted(planet.regions())[:n]
    runner = Runner(
        protocol.Caesar, planet, config, workload, 3,
        process_regions=list(regions), client_regions=list(regions), seed=seed,
        device=device,
    )
    runner.reorder_messages()
    _metrics, monitors, latencies = runner.run(extra_sim_time_ms=10_000)
    orders = {
        pid: {k: [(r.source, r.sequence) for r in m.get_order(k)] for k in sorted(m.keys())}
        for pid, m in monitors.items()
    }
    hists = {str(r): (c, list(h.values())) for r, (c, h) in latencies.items()}
    digests = {pid: e.digest().summary() for pid, (_p, e, _q) in runner._simulation.processes()}
    return orders, hists, digests, runner


# the paths of phase 8, each driven with the counts set to 0 just before it
# and read just after it; a pred kernel's ``launches`` is its count on the
# Caesar simulator's path
PRED_PATHS = ("steady", "sim")
PRED_MAIN_PATH = "sim"


def phase8(torch, P):
    """The Caesar paths on the card; returns the pred kernel's launches by
    path (and by variant)."""
    by_path = {}

    def counted(path, fn, *args):
        P.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[path] = {**P.LAUNCHES, "variants": dict(P.VARIANT_LAUNCHES)}
        assert P.LAUNCHES["pred_plane_step"] > 0, f"the {path} path never launched"
        return out, wall

    (order, times, plane, twin_order), steady_s = counted(
        "steady", pred_steady_rounds, P, CARD)
    _use, batch, _keys, _feeds, _cap = PRED_SHAPES[1]
    check_pred_order(order, batch * (PRED_WARM + PRED_TIMED))
    assert order == twin_order, "per-key orders differ from the host PredecessorsGraph"
    assert plane.health_name() == "healthy", plane.health_name()
    sim_got, sim_cuda_s = counted("sim", caesar_sim, CARD)
    t0 = time.perf_counter()
    sim_want = caesar_sim("cpu")
    sim_cpu_s = time.perf_counter() - t0
    assert sim_got[0] == sim_want[0], "Caesar: per-key orders differ from the cpu run"
    assert sim_got[1] == sim_want[1], "Caesar: latency histograms differ from the cpu run"
    assert sim_got[2] == sim_want[2], "Caesar: execution digests differ from the cpu run"
    sim_counters = [e.device_counters() for _p, (_x, e, _q)
                    in sim_got[3]._simulation.processes()]
    assert all(c["pred_plane_dispatches"] > 0 for c in sim_counters), sim_counters
    assert all(c["pred_plane_failures"] == 0 for c in sim_counters), sim_counters
    p50 = float(np.median(times))
    counters = {
        "dispatches": plane.dispatches, "grows": plane.grows,
        "compactions": plane.stats["compactions"],
        "resident_uploads": plane.resident_uploads, "slot_capacity": plane._cap,
        "width": plane._width, "kernel_ms": plane.stats["kernel_ms"],
    }
    log(f"phase 8: {PRED_WARM} warm and {PRED_TIMED} timed steady rounds of {batch} "
        f"commands on cuda, every command once in the host twin's per-key order: "
        f"median timed round {p50:.3f} ms ({batch / p50 * 1e3:.1f} commands/s); "
        f"plane {counters}")
    log(f"phase 8: Caesar through Runner(device='cuda') equal to Runner(device='cpu') "
        f"in per-key orders, latency histograms and digests; sim wall cuda "
        f"{sim_cuda_s:.3f} s, cpu {sim_cpu_s:.3f} s; launches by path {by_path}")
    log(json.dumps({"caesar_path": {
        "commands_per_round": batch, "timed_rounds": len(times), "round_ms": times,
        "median_round_ms": p50, "commands_per_s": batch / p50 * 1e3,
        "steady_wall_s": steady_s, "plane": counters,
        "sim_cuda_wall_s": sim_cuda_s, "sim_cpu_wall_s": sim_cpu_s,
        "sim_cuda_cpu_ratio": sim_cuda_s / sim_cpu_s,
        "sim_pred_dispatches": sum(c["pred_plane_dispatches"] for c in sim_counters),
        "sim_pred_kernel_ms": sum(c["pred_plane_kernel_ms"] for c in sim_counters),
        "launches_by_path": by_path,
    }}))
    return by_path


# ---------------------------------------------------------------------------
# the redesigned table and pred kernels at every path's shapes (phase 9;
# alone: --redesign)
# ---------------------------------------------------------------------------

VOTE_SWEEP = (256, 512, 1024, 2048, 4096)  # rows of vote_runs' forms sweep
HOT_KEY = 4096  # commands of the Caesar hot-key feed, all on one key
HOT_CAP = 1 << 16  # its window (the grid form)
PRED_FORM_FEEDS = (512, 1024, 2048, 4096)  # feeds of pred_plane_step's forms sweep
PRED_REPLAYS = 50  # runs of each dispatch of phase 7's small window and steady shapes
SORT_ROWS = 4096  # lex_sort's one-block path (graph_plane_step.cu RADIX_SMALL_N)


def pred_work(P):
    """The last pred dispatch's work: rows marked and pushed (the worklist
    kernels) or sweeps (an older checkout's)."""
    if hasattr(P, "last_work"):
        return P.last_work()
    return {"sweeps": P.last_sweeps()}


def captured_calls(module, name, run):
    """The arguments (clones) of every call of ``module.<name>`` while
    ``run()`` runs."""
    return [args for args, _kwargs in captured_kw(module, name, run)]


def captured_kw(module, name, run):
    """``(args, kwargs)`` (clones) of every call of ``module.<name>`` while
    ``run()`` runs."""
    calls, real = [], getattr(module, name)

    def record(*args, **kwargs):
        calls.append((clone_args(args), dict(kwargs)))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


def vote_gid(torch, args):
    """The sort keys of a ``vote_runs`` call (``tp_votes_gid``'s group, then
    vstart)."""
    frontier, vkey, vby, vstart, _vend, valid = args
    n_keys, n = frontier.shape
    return [torch.where(valid, vkey * n + vby, n_keys * n).to(torch.int32), vstart]


def vote_record(torch, T, K, label, args):
    """``stage_record`` of one ``vote_runs`` call, its bound the touched
    cells' (``table_moved_bytes``), and the call of its sort alone for
    ``count_ops`` (so the operations after the sort are known)."""
    record, got, _ = stage_record(torch, T, "vote_runs", args)
    nbytes = table_moved_bytes(torch, "vote_runs", args, got)
    record["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    record["V"] = int(args[1].numel())
    record["runs"] = int((got[3] != -(1 << 31)).sum())
    sort = {"call": (K.lex_sort, (vote_gid(torch, args),), {})}
    return record, sort


def vote_forms(torch, T, K, rows, seed):
    """``vote_runs`` on a Newt-like commit of ``rows`` rows (ranges on 4,096
    keys by 3 processes, a fifth invalid) in both forms, one CTA (the gate
    raised to the rows) and tiles (the gate lowered to 0), each held against
    the plain version and timed single and in the loop; their calls are
    counted on the card by ``count_ops`` (``FORM_REPEATS`` each).  Empty on
    a checkout without the gate."""
    if not hasattr(T, "VOTE_CTA_ROWS"):
        return {}
    rng = np.random.default_rng(seed)
    start = rng.integers(1, 200, rows)
    args = (torch.zeros((TABLE_KCAP, TABLE_N), dtype=torch.int32, device=CARD),
            *(torch.tensor(a.astype(np.int32), device=CARD) for a in (
                rng.integers(0, TABLE_KEYS, rows), rng.integers(0, TABLE_N, rows), start,
                start + rng.integers(0, 8, rows))),
            torch.tensor(rng.random(rows) < 0.8, device=CARD))
    want = T.vote_runs_plain(*clone_args(args))
    out = {}
    for form, value in (("one_cta", rows), ("tiles", 0)):
        call = gated(T, "VOTE_CTA_ROWS", value, T.vote_runs)
        got = call(*clone_args(args))
        err = max_abs_err(got, want, form)
        assert err == 0.0, f"vote_runs, {rows} rows, {form}: differs"
        out[f"ms_{form}"] = time_ms(call, args, {})
        out[f"ms_loop_{form}"] = time_loop_ms(call, args, {})
        out[f"runs_{form}"] = [{"call": (call, clone_args(args), {})}
                               for _ in range(FORM_REPEATS)]
    return out


def negative_corner_votes(torch, rows, seed):
    """A commit of ``rows`` rows where one group's 40% of the rows merge into
    one run that crosses every tile boundary it meets and extends the
    frontier, another group holds several runs (one below the frontier, one
    that extends, two residual), a fifth of the rest are invalid, and
    ``frontier[0, 0]`` starts at -7 with valid runs on cell (0, 0)."""
    rng = np.random.default_rng(seed)
    frontier = rng.integers(0, 30, (TABLE_KCAP, TABLE_N)).astype(np.int32)
    key = rng.integers(1, TABLE_KEYS, rows)
    by = rng.integers(0, TABLE_N, rows)
    start = rng.integers(1, 60, rows)
    end = start + rng.integers(0, 6, rows)
    valid = rng.random(rows) >= 0.2
    perm = rng.permutation(rows)
    merge = perm[: rows * 2 // 5]
    i = np.arange(len(merge))
    key[merge], by[merge], valid[merge] = 3, 1, True
    start[merge], end[merge] = 10 + i // 2, 12 + i // 2
    frontier[3, 1] = 12
    for at, (cell, s, e) in zip(perm[len(merge):], (
            ((5, 0), 1, 3), ((5, 0), 6, 8), ((5, 0), 20, 25), ((5, 0), 40, 41),
            ((0, 0), -8, -5), ((0, 0), -6, -2), ((0, 0), -1, 4), ((0, 0), 9, 9))):
        key[at], by[at], start[at], end[at], valid[at] = *cell, s, e, True
    frontier[5, 0], frontier[0, 0] = 5, -7
    cols = [frontier, key, by, start, end]
    return [torch.tensor(a.astype(np.int32), device=CARD) for a in cols] + [
        torch.tensor(valid, device=CARD)]


def pred_record(torch, P, label, args, reps=10):
    """One ``pred_plane_step`` call held against its plain version, timed
    (``reps`` single calls; the plain version twice where it sweeps long),
    with its work and bound; ``call`` is counted on the card later."""
    kernel, plain = P.pred_plane_step, P.pred_plane_step_plain
    got_args, plain_args = clone_args(args), clone_args(args)
    got = kernel(*got_args)
    work = pred_work(P)
    want = plain(*plain_args)
    err = max(max_abs_err(got, want, label), max_abs_err(got_args, plain_args, label))
    assert err == 0.0, f"{label}: kernel differs from its plain version"
    cap, width = args[0].shape
    return {
        "use": label, "shape": describe(args), "C": cap, "W": width,
        "ms": time_ms(kernel, args, {}, reps=reps),
        "plain_ms": time_ms(plain, args, {}, reps=min(reps, 2)),
        "bound_ms": pred_moved_bytes(torch, args, got) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err, "newly": int(got[5].sum()), "work": work,
        "call": (kernel, clone_args(args), {}),
    }


def pred_forms(torch, P, args):
    """One ``pred_plane_step`` dispatch in both forms, one CTA (the rows
    gate raised to the window's, where the working set fits the
    shared-memory gate) and the cooperative grid (the rows gate lowered to
    0), each held against the plain version and timed single; their calls
    are counted on the card by ``count_ops`` (``FORM_REPEATS`` each).
    Empty on a checkout without the rows gate."""
    if not hasattr(P, "ONE_CTA_ROWS"):
        return {}
    want = P.pred_plane_step_plain(*clone_args(args))
    cap, width = args[0].shape
    out = {}
    for form, value in (("one_cta", cap), ("grid", 0)):
        if form == "one_cta" and P.one_cta_smem_bytes(cap, width) > P.ONE_CTA_SMEM_BYTES:
            continue
        call = gated(P, "ONE_CTA_ROWS", value, P.pred_plane_step)
        got = call(*clone_args(args))
        assert max_abs_err(got, want, form) == 0.0, f"pred_plane_step, {form}: differs"
        out[f"ms_{form}"] = time_ms(call, args, {})
        out[f"runs_{form}"] = [{"call": (call, clone_args(args), {})}
                               for _ in range(FORM_REPEATS)]
    return out


def pred_replays(P, dispatches):
    """Each dispatch run ``PRED_REPLAYS`` times on clones of its arguments,
    every run equal to the plain version: a race between the blocks of the
    grid form shows in some run, not in every one (a scan whose threads
    past their chunk also wrote the CSR's last end lost a window's last
    row's waiters in most runs of one dispatch, not all).  Returns the
    runs made."""
    for i, args in enumerate(dispatches):
        want = P.pred_plane_step_plain(*clone_args(args))
        for run in range(PRED_REPLAYS):
            got = P.pred_plane_step(*clone_args(args))
            assert max_abs_err(got, want, "replay") == 0.0, (
                f"pred_plane_step differs from its plain version, dispatch {i}, run {run}")
    return len(dispatches) * PRED_REPLAYS


def phase_redesign(torch, T, P, K, checks=True):
    """``vote_runs`` and ``pred_plane_step`` at every shape their paths
    give them, each call held against its plain version, timed single and
    (``vote_runs``) in the loop beside its bound, and counted in operations
    on the card by ``torch.profiler``: ``vote_runs`` at the Newt sim's
    shapes (its calls captured from ``newt_sim("cpu")``, the first at each
    row count), at phase 5's V = 2^19, on a commit whose merged group
    crosses tile boundaries under a negative ``frontier[0, 0]`` (at 2,048
    and 2^19 rows), and in both forms over 256-4,096 rows;
    ``pred_plane_step`` at the Caesar sim's shapes (captured from
    ``caesar_sim("cpu")``: at each window shape the dispatch that executes
    the most rows), at phase 7's three shapes, and on a hot-key feed (4,096
    commands on one key in a 2^16-slot window, the grid form), and at the
    Caesar sim's shapes, phase 7's small window and windows of 1,024-8,192
    rows in both forms; every dispatch of phase 7's small window and steady
    shapes is also replayed ``PRED_REPLAYS`` times against the plain
    version.  With
    ``checks`` (the whole smoke; not on an older checkout) a ``vote_runs``
    call is at most 3 operations on the card after its sort and 3 in all at
    up to 2,048 rows, and each ``pred_plane_step`` dispatch is one."""
    out = {"vote_runs": {}, "vote_forms": {}, "pred_plane_step": {}, "pred_forms": {}}
    vote_sorts = {}
    calls = captured_calls(T, "vote_runs", lambda: newt_sim("cpu"))
    by_rows = {}
    for args in calls:
        by_rows.setdefault(int(args[1].numel()), []).append(args)
    out["newt_sim_calls_by_rows"] = {rows: len(c) for rows, c in sorted(by_rows.items())}
    for rows, same in sorted(by_rows.items()):
        label = f"vote_runs, the Newt sim's V={rows} ({len(same)} calls)"
        args = tuple(a.to(CARD) for a in same[0])
        out["vote_runs"][label], vote_sorts[label] = vote_record(torch, T, K, label, args)
    for label, args in (
        (f"vote_runs, phase 5's contiguous round, V={TABLE_VCAP}",
         [torch.zeros((TABLE_KCAP, TABLE_N), dtype=torch.int32, device=CARD)]
         + [t.to(CARD) for t in table_round_votes()]),
        ("vote_runs, a merge across tiles, frontier[0, 0] < 0, V=2048",
         negative_corner_votes(torch, 2048, 5)),
        (f"vote_runs, a merge across tiles, frontier[0, 0] < 0, V={TABLE_VCAP}",
         negative_corner_votes(torch, TABLE_VCAP, 6)),
    ):
        args = tuple(args)
        out["vote_runs"][label], vote_sorts[label] = vote_record(torch, T, K, label, args)
    for rows in VOTE_SWEEP:
        forms = vote_forms(torch, T, K, rows, rows)
        if forms:
            out["vote_forms"][rows] = forms
    # pred_plane_step at the Caesar sim's shapes: at each window shape, the
    # dispatch that executes the most rows
    sim_calls = captured_calls(P, "pred_plane_step", lambda: caesar_sim("cpu"))
    heaviest = {}
    for i, args in enumerate(sim_calls):
        shape = tuple(args[0].shape)
        newly = int(P.pred_plane_step_plain(*clone_args(args))[5].sum())
        if shape not in heaviest or newly > heaviest[shape][0]:
            heaviest[shape] = (newly, i)
    out["caesar_sim_calls_by_shape"] = {
        f"{c} x {w}": sum(tuple(a[0].shape) == (c, w) for a in sim_calls)
        for c, w in sorted(heaviest)}
    for (cap, width), (_newly, i) in sorted(heaviest.items()):
        args = tuple(a.to(CARD) for a in sim_calls[i])
        label = f"pred_plane_step, the Caesar sim's {cap} x {width}, dispatch {i}"
        out["pred_plane_step"][label] = pred_record(torch, P, label, args)
        forms = pred_forms(torch, P, args)
        if forms:
            out["pred_forms"][label] = forms
    out["pred_replays"] = {}
    for use, batch, keys, feeds, capacity in PRED_SHAPES:
        recorded = []
        pred_plane_run(P, CARD, batch, keys, feeds, capacity, record=recorded)
        if use != "full window":
            out["pred_replays"][use] = pred_replays(P, [a for a, _w in recorded])
        args = recorded[-1][0]
        label = f"pred_plane_step, phase 7's {use}, last dispatch"
        out["pred_plane_step"][label] = pred_record(torch, P, label, args)
        forms = pred_forms(torch, P, args) if use == "small window" else {}
        if forms:
            out["pred_forms"][label] = forms
    # both forms on bench_pred_path's generator at smaller feeds (3 of
    # them, a command in 8 on each key): windows of 1,024-8,192 rows
    for batch in PRED_FORM_FEEDS:
        recorded = []
        pred_plane_run(P, CARD, batch, batch // 8, 3, None, record=recorded)
        args = recorded[-1][0]
        cap, width = args[0].shape
        forms = pred_forms(torch, P, args)
        if forms:
            label = f"pred_plane_step, C={cap} W={width}, 3 feeds of {batch}"
            out["pred_forms"][label] = forms
    recorded = []
    _plane, order, _wall = pred_plane_run(P, CARD, HOT_KEY, 1, 1, HOT_CAP, record=recorded)
    check_pred_order(order, HOT_KEY)
    label = f"pred_plane_step, hot key: {HOT_KEY} commands on one key, C={HOT_CAP}"
    out["pred_plane_step"][label] = pred_record(torch, P, label, recorded[-1][0], reps=3)
    # every call counted on the card in one profiler session
    counted = list(out["vote_runs"].values()) + list(vote_sorts.values())
    counted += list(out["pred_plane_step"].values())
    all_forms = list(out["vote_forms"].values()) + list(out["pred_forms"].values())
    form_runs = [r for forms in all_forms for key in list(forms)
                 if key.startswith("runs_") for r in forms[key]]
    count_ops(torch, counted + form_runs)
    for label, record in out["vote_runs"].items():
        sort = vote_sorts[label]
        record["sort_ops"], record["sort_device_ms"] = sort["device_ops"], sort["device_ms"]
        record["ops_after_sort"] = record["device_ops"] - 1 - sort["device_ops"]
    for forms in all_forms:
        for key in [key for key in forms if key.startswith("runs_")]:
            runs, form = forms.pop(key), key[len("runs_"):]
            forms[f"device_ops_{form}"] = runs[0]["device_ops"]
            forms[f"device_ms_{form}"] = float(np.median([r["device_ms"] for r in runs]))
    if checks:
        for label, record in out["vote_runs"].items():
            assert record["ops_after_sort"] <= 3, (label, record["op_names"])
            if record["V"] <= 2048:
                assert record["device_ops"] <= 3, (label, record["op_names"])
        for label, record in out["pred_plane_step"].items():
            assert record["device_ops"] == 1, (label, record["op_names"])
            assert record["work"]["marked"] == record["newly"], (label, record["work"])
        for label, forms in out["pred_forms"].items():
            assert all(forms[k] == 1 for k in forms if k.startswith("device_ops_")), (
                label, forms)
    log(json.dumps({"redesign": out}))
    return out


def phase_apart(flag, record):
    """A phase with its asserts in a process of its own (``flag``
    ``--checks``, the libraries already built): after phases 1-8, the
    profiler sessions of the same process lost two of their separator
    kernels every time, also in sessions of 16 calls.  Its output is passed
    on; returns the record of its ``{record: ...}`` line."""
    command = [sys.executable, str(ROOT / "chip_smoke.py"), flag, "--checks"]
    proc = subprocess.run(command, cwd=ROOT, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    assert proc.returncode == 0, f"{flag} failed (rc {proc.returncode})"
    found = [line for line in proc.stdout.splitlines()
             if line.startswith('{"%s"' % record)]
    assert found, f"{flag} printed no record"
    return json.loads(found[-1])[record]


# ---------------------------------------------------------------------------
# link_scan and peel_compact at every shape their paths give them (phase
# 10; alone: --scans)
# ---------------------------------------------------------------------------

SCAN_REPLAYS = 50  # runs of each phase 10 call against the plain version
LINK_TILE_ROWS = 2048  # the link scan's tile (K.LINK_TILE), for the edge cases
LINK_SWEEP = (256, 512, 1024, 2048, 3072, 4096)  # rows of link_scan's forms sweep
GATE_ROWS = 1 << 14  # the cycle-rich resolve whose first compaction closes the gate


def to_card(value):
    """``value`` (tensors, nested in tuples and lists) on the card."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.to(CARD)
    if isinstance(value, (list, tuple)):
        return type(value)(to_card(v) for v in value)
    return value


def keyed_window(torch, key, dep, order=None):
    """``link_scan``'s inputs for a window whose row s holds command
    ``order[s]`` (the identity by default): its key, its dependency's row
    (TERMINAL where it has none), and the rows stably sorted by key."""
    n = len(key)
    order = np.arange(n) if order is None else order
    row = np.empty(n, np.int64)
    row[order] = np.arange(n)
    dep = dep[order]
    col = np.where(dep >= 0, row[np.maximum(dep, 0)], -1)
    pk = key[order]
    pos = np.argsort(pk, kind="stable")
    return [torch.tensor(a.astype(np.int32), device=CARD) for a in (pk, col, pos)]


def chain_window(torch, n, keys, seed, bad=0.0):
    """A window of ``n`` rows on ``keys`` keys in arrival order (every link
    verifies), a fraction ``bad`` of the dependencies then set MISSING."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, keys, n).astype(np.int32)
    dep = np.full(n, -1, np.int64)
    last = {}
    for i, k in enumerate(key.tolist()):
        dep[i] = last.get(k, -1)
        last[k] = i
    pk, col, pos = keyed_window(torch, key, dep)
    hit = torch.tensor(rng.random(n) < bad, device=CARD)
    return [pk, torch.where(hit, -2, col).to(torch.int32), pos]


def link_edge_cases(torch):
    """``link_scan``'s edge cases: n = 1 (a TERMINAL head, a MISSING one),
    2 and 3,001; the tile's size and twice it, each +-1; every row on one
    key (a chain across tiles; then a bad link on the first row of the
    second and third tiles); every row its own key, half the heads
    TERMINAL; a run across several tiles among other keys with a bad link
    on a tile's first row."""
    T = LINK_TILE_ROWS
    cases = {}

    def put(label, pk, col, pos=None):
        pk = np.asarray(pk, np.int64)
        if pos is None:
            pos = np.argsort(pk, kind="stable")
        cases[label] = [torch.tensor(np.asarray(a).astype(np.int32), device=CARD)
                        for a in (pk, col, pos)]

    put("n = 1, a TERMINAL head", [7], [-1])
    put("n = 1, a MISSING head", [7], [-2])
    put("n = 2, one chain", [3, 3], [-1, 0])
    for n in (3001, T - 1, T, T + 1, 2 * T - 1, 2 * T + 1):
        cases[f"n = {n}, 64 keys, 1% MISSING"] = chain_window(torch, n, 64, n, 0.01)
    n = 3 * T + 5
    chain = np.arange(n) - 1
    put(f"one key, n = {n}, every link verifies", np.zeros(n), chain)
    broken = chain.copy()
    broken[[T, 2 * T]] = -2
    put(f"one key, n = {n}, bad links on the first rows of tiles 2 and 3", np.zeros(n),
        broken)
    rng = np.random.default_rng(9)
    n = 3 * T + 7
    put(f"every row its own key, n = {n}, half the heads TERMINAL",
        rng.permutation(n), np.where(rng.random(n) < 0.5, -1, -2))
    # key 1 holds sorted rows [T - 100, 3T + 100): a run across three tiles
    n = 4 * T
    key = np.where((np.arange(n) >= T - 100) & (np.arange(n) < 3 * T + 100), 1,
                   np.where(np.arange(n) < T - 100, 0, 2))
    col = np.arange(n) - 1
    col[[0, T - 100, 3 * T + 100]] = -1
    col[2 * T] = 5  # a bad link on the third tile's first row, inside the run
    put(f"a run across tiles 1-3, a bad link on tile 3's first row, n = {n}", key, col)
    return cases


def link_forms(torch, K, rows):
    """``link_scan`` on a sim-like window of ``rows`` rows (commands on
    rows // 4 keys, arrival shuffled in windows of 64, so some links fail)
    in both forms, one block (the gate raised) and tiles (the gate at 0),
    each held against the plain version and timed single and in the loop;
    their calls are counted on the card (``FORM_REPEATS`` each).  Empty on a
    checkout without the gate."""
    if not hasattr(K, "LINK_CTA_ROWS"):
        return {}
    key, dep, _src, _seq = build_workload(rows, CONFLICT, clients=max(rows // 4, 1),
                                          seed=rows)
    args = keyed_window(torch, key, dep, arrival(rows, rows, rows, 64, rows))
    want = K.link_scan_plain(*clone_args(args))
    out = {"bound_ms": moved_bytes(K, "link_scan", args, {}, want) / HBM_BYTES_PER_S * 1e3}
    for form, value in (("one_cta", rows), ("tiles", 0)):
        call = gated(K, "LINK_CTA_ROWS", value, K.link_scan)
        assert max_abs_err(call(*clone_args(args)), want, form) == 0.0, (
            f"link_scan, {rows} rows, {form}: differs")
        out[f"ms_{form}"] = time_ms(call, args, {})
        out[f"ms_loop_{form}"] = time_loop_ms(call, args, {})
        out[f"runs_{form}"] = [{"call": (call, clone_args(args), {})}
                               for _ in range(FORM_REPEATS)]
    return out


def scan_replays(K, name, calls, times=None):
    """Each call ``(args, kwargs)`` run ``times`` (``SCAN_REPLAYS``) times on
    clones of its arguments, every run equal to the plain version (outputs
    and arguments updated in place): a race between the tiles of a
    look-back shows in some run, not in every one.  Returns the runs made."""
    kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
    times = SCAN_REPLAYS if times is None else times
    for i, (args, kwargs) in enumerate(calls):
        plain_args = clone_args(args)
        want = plain(*plain_args, **kwargs)
        for run in range(times):
            got_args = clone_args(args)
            got = kernel(*got_args, **kwargs)
            err = max(max_abs_err(got, want, name), max_abs_err(got_args, plain_args, name))
            assert err == 0.0, f"{name} differs from its plain version, call {i}, run {run}"
    return len(calls) * times


def general_path_calls(torch, K, name, Config, Command, Rifl, KVOp, RunTime,
                       GraphExecutor, GraphAddBatch):
    """The calls (clones of the arguments) of ``K.<name>`` while
    ``GraphExecutor`` on the card takes phase 4's 2^20 multi-key commands."""
    return captured_kw(K, name, general_path_run(Config, Command, Rifl, KVOp, RunTime,
                                                 GraphExecutor, GraphAddBatch))


def compact_label(args, kwargs):
    mode = kwargs["mode"]
    if mode == "init":
        return f"init, {' x '.join(map(str, args[0].shape))}"
    rows = " x ".join(map(str, args[0].shape))
    if mode == "publish":
        return f"publish (terminal), {rows} into {args[6].numel()}"
    return f"compact, {rows} to {kwargs['half']}"


def phase_scans(torch, K, T, gp_module, Config, Command, Rifl, KVOp, RunTime,
                GraphExecutor, GraphAddBatch, checks=True):
    """``link_scan`` and ``peel_compact`` at every shape their paths give
    them, each call held against its plain version, replayed
    ``SCAN_REPLAYS`` times, timed single and in the loop beside its bound
    and counted in operations on the card by ``torch.profiler``:
    ``link_scan`` at the sims' calls (EPaxos and Atlas through
    ``Runner(device="cpu")``, the first call at each row count timed, all
    replayed), at 2^20 (the north-star workload's 2^20 commands in one
    window, shuffled around the feed edges as phase 1's second case) and
    on ``link_edge_cases``, and in both forms over 256-4,096 rows;
    ``peel_compact`` at phase 4's calls (``GraphExecutor`` on the 2^20
    multi-key commands: each dispatch's init, compactions and terminal
    publish; the first call at each shape timed, all replayed), at a 2^20 x
    4 resolve and on a cycle-rich resolve of ``GATE_ROWS`` rows whose first
    compaction closes the gate.  Also
    ``lex_sort`` at ``SORT_ROWS`` (its one-block path) beside
    ``torch.sort``, and ``stable_rows`` at the Newt sim's shapes beside
    ``kthvalue``.  With ``checks`` (the whole smoke; not on an older
    checkout) a ``link_scan`` call is one operation on the card, a
    compaction at most two, an init and a publish one, none a memset or a
    fill."""
    from fantoch_tpu_torch.ops import graph_resolve

    out = {"link_scan": {}, "peel_compact": {}, "link_forms": {}, "replays": {},
           "others": {}}
    sim_calls = []
    for name in ("EPaxos", "Atlas"):
        sim_calls += captured_kw(K, "link_scan", lambda: sim_run("cpu", name))
    sim_calls = [(to_card(args), kw) for args, kw in sim_calls]
    by_rows = {}
    for args, _kw in sim_calls:
        by_rows.setdefault(int(args[0].numel()), []).append(args)
    out["sims_link_scan_calls_by_rows"] = {n: len(c) for n, c in sorted(by_rows.items())}
    link_cases = {}
    for n, same in sorted(by_rows.items()):
        link_cases[f"the sims' n = {n} ({len(same)} calls)"] = same[0]
    key, dep, _src, _seq = build_workload(BIG, CONFLICT)
    link_cases["north star, 2^20 rows, shuffled around the feed edges"] = keyed_window(
        torch, key, dep, arrival(BIG, FEED, 8192, 128, SEED))
    link_cases.update(link_edge_cases(torch))
    for label, args in link_cases.items():
        record, got, _ = stage_record(torch, K, "link_scan", tuple(args))
        record["n"] = int(args[0].numel())
        record["n_residual"] = int(got[3].item())
        out["link_scan"][label] = record
    replay = sim_calls + [(tuple(a), {}) for a in link_cases.values()]
    out["replays"]["link_scan"] = scan_replays(K, "link_scan", replay)
    for rows in LINK_SWEEP:
        forms = link_forms(torch, K, rows)
        if forms:
            out["link_forms"][rows] = forms

    path_calls = general_path_calls(torch, K, "peel_compact", Config, Command, Rifl, KVOp,
                                    RunTime, GraphExecutor, GraphAddBatch)
    out["phase4_peel_compact_calls"] = {
        "calls": len(path_calls),
        "dispatches": sum(kw["mode"] == "init" for _a, kw in path_calls),
        "shapes": sorted({compact_label(a, kw) for a, kw in path_calls})}
    # the first call at each shape; then phase 3's 2^20 x 4 resolve (bench.py's
    # general generator, shuffled around the feed edges, in one window)
    first = {}
    for args, kwargs in path_calls:
        first.setdefault(compact_label(args, kwargs), (args, kwargs))
    order = arrival(BIG, FEED, 8192, 128, SEED)
    row = np.empty(BIG, np.int64)
    row[order] = np.arange(BIG)
    deps = general_workload(BIG)[1][order]
    deps = np.where(deps >= 0, row[np.maximum(deps, 0)], deps).astype(np.int32)
    seq = torch.arange(BIG, dtype=torch.int32, device=CARD)
    big_calls = captured_kw(K, "peel_compact", lambda: graph_resolve.resolve_general_resident(
        torch.tensor(deps, device=CARD), seq, seq))
    for args, kwargs in big_calls:
        if kwargs["mode"] != "compact" or args[0].shape[0] == BIG:
            first.setdefault(compact_label(args, kwargs), (args, kwargs))
    cyc = torch.tensor(cycle_rich(GATE_ROWS, GENERAL_FEED)[1], device=CARD)
    seq = torch.arange(GATE_ROWS, dtype=torch.int32, device=CARD)
    gate_calls = captured_kw(K, "peel_compact", lambda: graph_resolve.resolve_general_resident(
        cyc, seq, seq, min_size=GATE_ROWS // 4))
    gate = [(a, kw) for a, kw in gate_calls if kw["mode"] == "compact"][0]
    plain_args = clone_args(gate[0])
    K.peel_compact_plain(*plain_args, **gate[1])
    assert int(plain_args[9][0]) == 1 and int(gate[0][9][0]) == 0, "the gate did not close"
    cases = [(label, a, kw) for label, (a, kw) in first.items()]
    cases.append((f"gate closes: {compact_label(*gate)}, cycle-rich", *gate))
    for label, args, kwargs in cases:
        record, _got, _ = stage_record(torch, K, "peel_compact", args, kwargs)
        record["mode"] = kwargs["mode"]
        out["peel_compact"][label] = record
    out["replays"]["peel_compact"] = scan_replays(
        K, "peel_compact", path_calls + big_calls + [(gate[0], gate[1])])
    del path_calls, big_calls, first

    # the one-block sort beside torch.sort, stable_rows at the Newt sim's shapes
    sort_args = ([torch.tensor(np.random.default_rng(4).integers(0, 1 << 20, SORT_ROWS)
                               .astype(np.int32), device=CARD)],)
    record, _got, _ = stage_record(torch, K, "lex_sort", sort_args)
    library = sort_library(torch, sort_args, {})
    record["library"], record["library_ms"] = library[0], time_ms(library[1], library[2], {})
    record["library_ms_loop"] = time_loop_ms(library[1], library[2], {})
    out["others"][f"lex_sort, one key, n = {SORT_ROWS}"] = record
    stable = captured_calls(T, "stable_rows", lambda: newt_sim("cpu"))
    shapes = {}
    for args in stable:
        shapes.setdefault(tuple(args[0].shape), []).append(args)
    out["newt_sim_stable_rows_by_shape"] = {
        " x ".join(map(str, s)): len(c) for s, c in sorted(shapes.items())}
    for shape, same in sorted(shapes.items()):
        args = to_card(same[0])
        record, got, _ = stage_record(torch, T, "stable_rows", args)
        record["bound_ms"] = (table_moved_bytes(torch, "stable_rows", args, got)
                              / HBM_BYTES_PER_S * 1e3)
        lib = lambda *a: table_library_call(torch, "stable_rows", a)  # noqa: E731
        record["library"] = "torch.kthvalue"
        record["library_ms"] = time_ms(lib, args, {})
        record["library_ms_loop"] = time_loop_ms(lib, args, {})
        out["others"][f"stable_rows, the Newt sim's {' x '.join(map(str, shape))} "
                      f"({len(same)} calls)"] = record

    counted = [r for group in ("link_scan", "peel_compact", "others")
               for r in out[group].values()]
    all_forms = list(out["link_forms"].values())
    form_runs = [r for forms in all_forms for key in list(forms)
                 if key.startswith("runs_") for r in forms[key]]
    count_ops(torch, counted + form_runs)
    for forms in all_forms:
        for key in [key for key in forms if key.startswith("runs_")]:
            runs, form = forms.pop(key), key[len("runs_"):]
            forms[f"device_ops_{form}"] = runs[0]["device_ops"]
            forms[f"device_ms_{form}"] = float(np.median([r["device_ms"] for r in runs]))
    if checks:
        for group in ("link_scan", "peel_compact"):
            for label, record in out[group].items():
                most = 2 if record.get("mode") == "compact" else 1
                assert record["device_ops"] <= most and record["device_ops"] >= 1, (
                    label, record["op_names"])
                if group == "link_scan" or record["mode"] != "compact":
                    assert record["device_ops"] == 1, (label, record["op_names"])
                assert not any(f in n.lower() for n in record["op_names"]
                               for f in ("memset", "fill")), (label, record["op_names"])
    log(json.dumps({"scans": out}))
    return out


# ---------------------------------------------------------------------------
# pointer_doubling and clock_proposal at every shape their paths give them,
# and the device time of the keyed and table wrappers not yet redesigned
# (phase 11; alone: --doubling)
# ---------------------------------------------------------------------------

DOUBLING_REPLAYS = 50  # runs of each phase 11 call against the plain version
DOUBLING_SWEEP = tuple(1 << k for k in range(10, 21))  # rows of the forms' sweep
PROP_SWEEP = (256, 512, 1024, 2048, 4096, 8192)  # rows of clock_proposal's forms sweep
HOT_CHAIN = 1 << 19  # the hot-key chain with one break
GRAPH_ROWS = 4096  # rows of the functional-graph kinds
SIM_EPILOGUE_ROWS = 1024  # the sims' keyed window (plane_epilogue's small shape)


def functional_graphs(n, seed):
    """Out-degree-<=1 graphs of ``n`` rows (``dep`` columns, TERMINAL -1 and
    MISSING -2 sentinels) of each kind ``pointer_doubling`` must resolve."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    chain = idx - 1  # row 0 TERMINAL, every other row on the row before it
    mid = chain.copy()
    mid[n // 2] = -2
    two = idx ^ 1
    if n % 2:
        two[-1] = -1
    # tails into short cycles: cycles of 1-8 rows, every other row on a row
    # before it or on a cycle
    tails = np.full(n, -1)
    heads = max(n // 64, 1)
    start = 0
    for _ in range(heads):
        length = int(rng.integers(1, 9))
        stop = min(start + length, n)
        tails[start:stop] = np.roll(np.arange(start, stop), -1)
        start = stop
        if start >= n:
            break
    for i in range(start, n):
        tails[i] = int(rng.integers(0, i))
    lab = rng.permutation(n)  # relabel, so ids do not follow the walk
    relabeled = np.empty(n, np.int64)
    relabeled[lab] = np.where(tails >= 0, lab[np.maximum(tails, 0)], tails)
    tails = relabeled
    rising = chain.copy()
    rising[:: max(n // 16, 1)] = -1  # 16 chains whose ids rise along the walk
    falling = idx + 1  # the walk goes to higher ids: ids fall towards the end
    falling[-1] = -1
    falling[max(n // 16, 1) - 1 :: max(n // 16, 1)] = -1
    random = rng.integers(0, n, n)
    random[rng.random(n) < 0.05] = -1
    graphs = {
        "all TERMINAL": np.full(n, -1),
        "all MISSING": np.full(n, -2),
        "MISSING mid-chain": mid,
        "self-loops": idx,
        "2-cycles": two,
        "one cycle through all rows": np.roll(idx, -1),
        "long tails into short cycles": tails,
        "a random functional graph, 5% TERMINAL": random,
        "chains whose ids rise along the walk": rising,
        "chains whose ids fall along the walk": falling,
    }
    return {label: dep.astype(np.int32) for label, dep in graphs.items()}


def doubling_edge_cases(torch, K):
    """``pointer_doubling``'s edge cases: n = 1, 2, 3 and 3,001; a block's
    threads (``K.LOOP_BLOCK``) +-1; each kind of ``functional_graphs`` at
    ``GRAPH_ROWS``; a ``HOT_CHAIN``-row hot-key chain with one break."""
    cases = {}
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 3001):
        dep = rng.integers(-2, n, n).astype(np.int32)
        cases[f"n = {n}, random"] = dep
    for n in (K.LOOP_BLOCK - 1, K.LOOP_BLOCK, K.LOOP_BLOCK + 1):
        cases[f"block {K.LOOP_BLOCK}: n = {n}, tails into short cycles"] = functional_graphs(
            n, n)["long tails into short cycles"]
    for label, dep in functional_graphs(GRAPH_ROWS, 5).items():
        cases[f"{label}, n = {GRAPH_ROWS}"] = dep
    hot = np.arange(HOT_CHAIN, dtype=np.int64) - 1
    hot[HOT_CHAIN // 3] = -2
    cases[f"hot-key chain, n = {HOT_CHAIN}, one break"] = hot.astype(np.int32)
    return {label: (torch.tensor(dep, device=CARD),) for label, dep in cases.items()}


def proposal_edge_cases(torch, T):
    """``clock_proposal``'s edge cases: B = 1; the wrapper's tile size +-1
    and twice it +1; all rows on one key; every row on its own key; priors
    at INT32_MAX - 3, so that clocks wrap (and at INT32_MAX, so that prior +
    1 wraps); ``min_clock`` above and below ``prior + 1``."""
    K_ = TABLE_KCAP
    rng = np.random.default_rng(8)
    cases = {}

    def put(label, prior, key, mins):
        cases[label] = tuple(torch.tensor(np.asarray(a).astype(np.int32), device=CARD)
                             for a in (prior, key, mins))

    def mixed(b, seed):
        r = np.random.default_rng(seed)
        key = np.where(r.random(b) < CONFLICT, 0, r.integers(1, K_, b))
        return r.integers(0, 50, K_), key, np.where(r.random(b) < 0.1, 60, 0)

    put("B = 1", [5] * K_, [3], [0])
    sizes = [T.PROP_TILE] if hasattr(T, "PROP_TILE") else []
    for size in sizes:
        for b in (size - 1, size, size + 1, 2 * size + 1):
            if b > 0:
                put(f"size {size}: B = {b}, half on one key", *mixed(b, b))
    b = 5000
    put(f"B = {b}, all rows on one key", rng.integers(0, 50, K_), np.full(b, 7),
        rng.integers(0, 80, b))
    put(f"B = {K_}, every row its own key", rng.integers(0, 50, K_),
        rng.permutation(K_), rng.integers(0, 80, K_))
    top = (1 << 31) - 1
    put(f"B = {b}, priors at INT32_MAX - 3, clocks wrap",
        np.full(K_, top - 3), np.where(rng.random(b) < 0.5, 1, rng.integers(0, 64, b)),
        np.zeros(b))
    put(f"B = {b}, priors at INT32_MAX and INT32_MIN + 2, prior + 1 wraps",
        np.where(np.arange(K_) % 2 == 0, top, -top + 1),
        np.where(rng.random(b) < 0.5, 2, rng.integers(0, 64, b)),
        np.where(rng.random(b) < 0.3, -top - 1, 0))
    put(f"B = {b}, min_clock above prior + 1", rng.integers(0, 50, K_),
        np.where(rng.random(b) < 0.5, 0, rng.integers(1, 64, b)), rng.integers(100, 200, b))
    put(f"B = {b}, min_clock below prior + 1", rng.integers(1000, 2000, K_),
        np.where(rng.random(b) < 0.5, 0, rng.integers(1, 64, b)), rng.integers(0, 900, b))
    return cases


def table_record(torch, T, name, args):
    """``stage_record`` for a table wrapper, its bound the table's bytes."""
    record, got, got_args = stage_record(torch, T, name, args)
    record["bound_ms"] = table_moved_bytes(torch, name, args, got) / HBM_BYTES_PER_S * 1e3
    return record, got, got_args


def replays(module, name, calls):
    """Each call ``(args, kwargs)`` run ``DOUBLING_REPLAYS`` times on clones
    of its arguments, every run equal to the plain version (outputs and
    arguments updated in place)."""
    kernel, plain = getattr(module, name), getattr(module, f"{name}_plain")
    for i, (args, kwargs) in enumerate(calls):
        plain_args = clone_args(args)
        want = plain(*plain_args, **kwargs)
        for run in range(DOUBLING_REPLAYS):
            got_args = clone_args(args)
            got = kernel(*got_args, **kwargs)
            err = max(max_abs_err(got, want, name), max_abs_err(got_args, plain_args, name))
            assert err == 0.0, f"{name} differs from its plain version, call {i}, run {run}"
    return len(calls) * DOUBLING_REPLAYS


def keyed_path_calls(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                     GraphExecutor, GraphAddBatch):
    """Phase 2's shuffled run (``GraphExecutor`` on the card, 1M single-key
    commands) with each dispatch timed as phase 2 times it: every dispatch's
    branch (fast path, residual, overflow) and time, and the calls (clones,
    made after the dispatch's timing) of the keyed wrappers inside it."""
    run = keyed_path_run(Config, Command, Rifl, KVOp, RunTime, GraphExecutor,
                         GraphAddBatch)
    names = ("pointer_doubling", "residual_view", "group_scan", "emit_scatter",
             "plane_epilogue")
    seen, reals = [], {name: getattr(K, name) for name in names}
    dispatches, calls = [], {name: [] for name in names}
    outside = {name: 0 for name in names}  # calls outside a plane dispatch

    def recorder(name):
        def record(*args, **kwargs):
            if seen and seen[0] is None:
                seen.append((name, args, kwargs))
            else:
                outside[name] += 1
            return reals[name](*args, **kwargs)
        return record

    real_step = gp_module.resolve_graph_plane_step

    def timed_step(*args, mode):
        seen[:] = [None]
        t = time.perf_counter()
        try:
            out = real_step(*args, mode=mode)
            torch.cuda.synchronize()
        finally:
            ms = (time.perf_counter() - t) * 1e3
            inside = seen[1:]
            seen.clear()
        cap = int(args[0].shape[0])
        names_seen = [s[0] for s in inside]
        doubling = [int(a[0].numel()) for s, a, _kw in inside if s == "pointer_doubling"]
        branch = ("overflow" if cap in doubling else
                  "residual" if "residual_view" in names_seen else "fast path")
        dispatches.append({"ms": ms, "branch": branch, "window": cap, "mode": mode,
                           "doubling_rows": doubling})
        for name, a, kw in inside:
            calls[name].append((clone_args(a), dict(kw), branch))
        return out

    gp_module.resolve_graph_plane_step = timed_step
    for name in names:
        setattr(K, name, recorder(name))
    try:
        wall_s = run()
    finally:
        gp_module.resolve_graph_plane_step = real_step
        for name, real in reals.items():
            setattr(K, name, real)
    p50 = float(np.median([d["ms"] for d in dispatches]))
    return {"dispatches": dispatches, "p50_dispatch_ms": p50,
            "commands_per_s": BIG / wall_s, "calls_outside_dispatches": outside}, calls


def phase1_doubling_calls(torch, K, gp_module, Config, Metrics, DeviceFrontier, RunTime):
    """The ``pointer_doubling`` and ``plane_epilogue`` calls (clones) of
    phase 1's three cases (device graph planes fed 4 feeds each)."""
    cases = (
        ("chain C=2^20", BIG, FEED, arrival(BIG, FEED, 0, 1, SEED)),
        ("shuffled C=2^20", BIG, FEED, arrival(BIG, FEED, 8192, 128, SEED)),
        ("overflow C=2^16", 1 << 16, 1 << 15, arrival(1 << 16, 1 << 15, 1 << 16, 64, SEED)),
    )
    out = {"pointer_doubling": [], "plane_epilogue": []}
    for label, n, feed, order in cases:
        src, seq, key, packed, _key_of = columns(n, order)
        plane = gp_module.DeviceGraphPlane(
            1, 0, Config(5, 2, batched_graph_executor=True, device_graph_plane=True),
            DeviceFrontier([1, 2, 3, 4, 5]), Metrics(), slot_capacity=n,
        )

        def run():
            for s in range(0, n, feed):
                cut = slice(s, s + feed)
                plane.feed(src[cut], seq[cut], key[cut], np.zeros(len(src[cut])),
                           packed[cut], [None] * len(src[cut]), RunTime())
                plane.take_emitted()

        epi = []
        doubling = captured_kw(K, "pointer_doubling",
                               lambda: epi.extend(captured_kw(K, "plane_epilogue", run)))
        out["pointer_doubling"] += [(f"phase 1, {label}", a, kw) for a, kw in doubling]
        out["plane_epilogue"] += [(f"phase 1, {label}", a, kw) for a, kw in epi]
    return out


def split_sort(record, sort):
    """A ``clock_proposal`` record's operations on the card split into its
    sort's and the rest, each with its count and summed device time: the
    sort's are the first ``sort["device_ops"]``, ``sort`` the record of
    ``lex_sort([key])`` alone on the same key in the same profiler session.
    ``sort_matches``: those operations have the names the sort's have, in
    its order."""
    listed = "op_ms" in record and "op_ms" in sort  # else past OPS_LISTED
    ops, mine = record.get("op_ms", []), sort.get("op_ms", [])
    head, rest = ops[:len(mine)], ops[len(mine):]
    record["sort_matches"] = listed and [n for n, _t in head] == [n for n, _t in mine]
    record["sort_ops"], record["sort_device_ms"] = len(head), sum(t for _n, t in head)
    record["sort_alone_device_ms"] = sort["device_ms"]
    record["rest_ops"], record["rest_device_ms"] = len(rest), sum(t for _n, t in rest)
    record["rest_op_names"] = sorted({name for name, _t in rest})


def phase_doubling(torch, K, T, gp_module, table_ops, Config, Command, Rifl, KVOp,
                   Metrics, DeviceFrontier, RunTime, GraphExecutor, GraphAddBatch,
                   checks=True):
    """``pointer_doubling`` and ``clock_proposal`` at every shape their
    paths give them, each call held against its plain version, replayed
    ``DOUBLING_REPLAYS`` times, timed single and in the loop beside its
    bound and counted in operations on the card by ``torch.profiler``:
    ``pointer_doubling`` at phase 2's calls (``GraphExecutor`` on the
    shuffled north-star feed, each dispatch's branch and time recorded: the
    keyed p50), at phase 1's three cases' calls, at 2^20 (the north-star
    window shuffled around the feed edges) and on ``doubling_edge_cases``,
    and in each form over ``DOUBLING_SWEEP``; ``clock_proposal`` at phase
    5's B = 2^17 hot-key call, at phase 6's calls (Newt's steady rounds
    and the S = 8 fused chain, captured) and on ``proposal_edge_cases``,
    each call's operations split into its sort's and the rest, and in both
    forms over ``PROP_SWEEP``.  Also the operations and device time of
    ``residual_view``, ``group_scan``, ``emit_scatter`` (phase 2's residual
    dispatches), ``plane_epilogue`` (2^20, and the sims' 1,024) and
    ``clock_bump`` (the steady rounds), and the Newt steady round and the
    fused chain, timed as phase 6 times them.  With ``checks`` (the whole
    smoke; not on an older checkout) a ``pointer_doubling`` call is one
    operation on the card, a ``clock_proposal`` call at most its sort's
    plus 2, none a memset or a fill."""
    out = {"pointer_doubling": {}, "clock_proposal": {}, "others": {}, "forms": {},
           "proposal_forms": {}, "replays": {}, "readings": {}}
    # phase 1's calls, then phase 2's dispatches and calls (phase 1 first, as
    # in the whole smoke, so phase 2's dispatches find the allocator warm)
    phase1 = phase1_doubling_calls(torch, K, gp_module, Config, Metrics, DeviceFrontier,
                                   RunTime)
    keyed, path_calls = keyed_path_calls(torch, K, gp_module, Config, Command, Rifl, KVOp,
                                         RunTime, GraphExecutor, GraphAddBatch)
    out["readings"]["phase2"] = keyed
    log(f"phase 11: phase 2's keyed path: p50 dispatch {keyed['p50_dispatch_ms']:.3f} "
        f"ms; dispatches (window, branch, ms) "
        f"{[(d['window'], d['branch'], round(d['ms'], 3)) for d in keyed['dispatches']]}; "
        f"calls outside a dispatch {keyed['calls_outside_dispatches']}")
    doubling_calls = []
    for i, (args, kwargs, branch) in enumerate(path_calls["pointer_doubling"]):
        doubling_calls.append((f"phase 2, dispatch call {i}, {branch}", args, kwargs))
    doubling_calls += phase1["pointer_doubling"]
    key, dep, _src, _seq = build_workload(BIG, CONFLICT)
    _pk, col, _pos = keyed_window(torch, key, dep, arrival(BIG, FEED, 8192, 128, SEED))
    doubling_calls.append(("north star, 2^20 rows, shuffled around the feed edges",
                           (col,), {}))
    doubling_calls += [(label, args, {}) for label, args in
                       doubling_edge_cases(torch, K).items()]
    for label, args, kwargs in doubling_calls:
        record, got, _ = stage_record(torch, K, "pointer_doubling", args, kwargs)
        n = int(args[0].numel())
        record["n"] = n
        record["steps"] = K.num_doubling_steps(n)
        record["on_cycle"] = int(got[3].sum().item())
        record["resolved"] = int(got[0].sum().item())
        out["pointer_doubling"][f"{label} (n = {n})"] = record
    out["replays"]["pointer_doubling"] = replays(
        K, "pointer_doubling", [(a, kw) for _l, a, kw in doubling_calls])

    # the forms over the sweep: the north-star workload in a window of n
    # rows, shuffled around feed edges a quarter of the window apart
    for n in DOUBLING_SWEEP:
        key, dep, _src, _seq = build_workload(n, CONFLICT, seed=n)
        order = arrival(n, max(n // 4, 1), min(8192, n), 128, SEED)
        args = (keyed_window(torch, key, dep, order)[1],)
        want = K.pointer_doubling_plain(*clone_args(args))
        forms = {"bound_ms": moved_bytes(K, "pointer_doubling", args, {}, want)
                 / HBM_BYTES_PER_S * 1e3}
        call = K.pointer_doubling
        assert max_abs_err(call(*clone_args(args)), want, "pointer_doubling") == 0.0, (
            f"pointer_doubling, {n} rows: differs")
        forms["ms_kernel"] = time_ms(call, args, {})
        forms["ms_loop_kernel"] = time_loop_ms(call, args, {})
        forms["runs_kernel"] = [{"call": (call, clone_args(args), {})}
                                for _ in range(FORM_REPEATS)]
        out["forms"][n] = forms

    # clock_proposal: phase 5's call, phase 6's calls, edge cases
    prop_calls = [(f"phase 5, B={FUSED_BATCH} K={TABLE_KCAP}, 50% on one key",
                   tuple(t.to(CARD) for t in table_draws(torch)[1]))]
    _fast, _write, threshold = Config(TABLE_N, 1).newt_quorum_sizes()
    bumps = []
    steady = captured_calls(T, "clock_proposal", lambda: bumps.extend(
        captured_calls(T, "clock_bump", lambda: newt_steady_rounds(CARD))))
    prop_calls += [(f"phase 6, steady round {i}", a) for i, a in enumerate(steady)]
    keys, mins = fused_chain_inputs(torch, torch.device(CARD))
    fused = captured_calls(T, "clock_proposal",
                           lambda: fused_chain(torch, table_ops, keys, mins, threshold))
    prop_calls += [(f"phase 6, fused chain round {i}", a) for i, a in enumerate(fused)]
    prop_calls += list(proposal_edge_cases(torch, T).items())
    sorts = {}  # lex_sort([key]) alone on each call's key: its operations
    for label, args in prop_calls:
        record, _got, _ = table_record(torch, T, "clock_proposal", args)
        record["keys"] = int(torch.unique(args[1]).numel())
        label = f"{label} (B = {int(args[1].numel())})"
        out["clock_proposal"][label] = record
        sorts[label] = {"call": (lambda key: K.lex_sort([key]), (args[1],), {})}
    out["replays"]["clock_proposal"] = replays(T, "clock_proposal",
                                               [(a, {}) for _l, a in prop_calls])
    for rows in PROP_SWEEP:
        r = np.random.default_rng(rows)
        args = tuple(torch.tensor(a.astype(np.int32), device=CARD) for a in (
            r.integers(0, 50, TABLE_KCAP),
            np.where(r.random(rows) < CONFLICT, 0, r.integers(1, TABLE_KEYS, rows)),
            np.where(r.random(rows) < 0.1, 60, 0)))
        want = T.clock_proposal_plain(*clone_args(args))
        forms = {"bound_ms": table_moved_bytes(torch, "clock_proposal", args, want)
                 / HBM_BYTES_PER_S * 1e3}
        call = T.clock_proposal
        got_args = clone_args(args)
        assert max_abs_err(call(*got_args), want, "clock_proposal") == 0.0, (
            f"clock_proposal, {rows} rows: differs")
        forms["ms_kernel"] = time_ms(call, args, {})
        forms["ms_loop_kernel"] = time_loop_ms(call, args, {})
        forms["runs_kernel"] = [{"call": (call, clone_args(args), {})}
                                for _ in range(FORM_REPEATS)]
        out["proposal_forms"][rows] = forms

    # the wrappers not yet redesigned, at their paths' shapes
    others = []
    for name in ("residual_view", "group_scan", "emit_scatter"):
        first = path_calls[name][:1]
        others += [(f"{name}, phase 2, {branch}", K, name, a, kw)
                   for a, kw, branch in first]
    epi = [c for c in phase1["plane_epilogue"] if int(c[1][0].numel()) == BIG][:1]
    others += [(f"plane_epilogue, {label}", K, "plane_epilogue", a, kw)
               for label, a, kw in epi]
    sims = captured_kw(K, "plane_epilogue", lambda: sim_run("cpu", "EPaxos"))
    sims = [(to_card(a), kw) for a, kw in sims if int(a[0].numel()) == SIM_EPILOGUE_ROWS]
    others += [(f"plane_epilogue, the EPaxos sim ({len(sims)} calls at "
                f"{SIM_EPILOGUE_ROWS})", K, "plane_epilogue", a, kw) for a, kw in sims[:1]]
    others += [("clock_bump, phase 6, steady", T, "clock_bump", a, {}) for a in bumps[:1]]
    for label, module, name, args, kwargs in others:
        if module is T:
            record, _got, _ = table_record(torch, T, name, args)
        else:
            record, _got, _ = stage_record(torch, K, name, args, kwargs)
        out["others"][label] = record

    # the Newt readings, timed as phase 6 times them
    _order, times, _counters = newt_steady_rounds(CARD)
    out["readings"]["newt_round_ms"] = times
    out["readings"]["newt_median_round_ms"] = float(np.median(times))
    chain_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_chain(torch, table_ops, keys, mins, threshold)
        torch.cuda.synchronize()
        chain_ms.append((time.perf_counter() - t0) * 1e3)
    out["readings"]["fused_chain_ms"] = chain_ms

    counted = [r for group in ("pointer_doubling", "clock_proposal", "others")
               for r in out[group].values()]
    all_forms = list(out["forms"].values()) + list(out["proposal_forms"].values())
    form_runs = [r for forms in all_forms for key in list(forms)
                 if key.startswith("runs_") for r in forms[key]]
    count_ops(torch, counted + form_runs + list(sorts.values()))
    for forms in all_forms:
        for key in [key for key in forms if key.startswith("runs_")]:
            runs, form = forms.pop(key), key[len("runs_"):]
            forms[f"device_ops_{form}"] = runs[0]["device_ops"]
            forms[f"device_ms_{form}"] = float(np.median([r["device_ms"] for r in runs]))
    for label, record in out["clock_proposal"].items():
        split_sort(record, sorts[label])
    if checks:
        for label, record in out["pointer_doubling"].items():
            assert record["device_ops"] == 1, (label, record["op_names"])
        for label, record in out["clock_proposal"].items():
            # the sort's operations are lex_sort's alone, in its order
            # (its memset included), and the rest one or two kernels
            assert record["sort_matches"], (label, record.get("op_ms"),
                                            sorts[label].get("op_ms"))
            assert 1 <= record["rest_ops"] <= 2, (label, record["op_names"])
        for label, record in out["pointer_doubling"].items():
            assert not any(f in n.lower() for n in record["op_names"]
                           for f in ("memset", "fill")), (label, record["op_names"])
        for label, record in out["clock_proposal"].items():
            assert not any(f in n.lower() for n in record["rest_op_names"]
                           for f in ("memset", "fill")), (label, record["rest_op_names"])
    log(json.dumps({"doubling": out}))
    return out


# ---------------------------------------------------------------------------
# the plane's epilogue folded into the launch that makes each branch's
# resolved flags, and group_scan as one launch (phase 12; alone: --epilogue)
# ---------------------------------------------------------------------------

EPILOGUE_REPLAYS = 50  # runs of each captured dispatch against the plain route
GROUP_ROWS = 1 << 16  # group_scan's synthetic residual
GROUP_EDGE_ROWS = 4096  # rows of group_scan's edge cases
PROFILED_PER_BRANCH = 3  # dispatches of each run and branch counted on the card
# the branches of the plane step (ops/graph_resolve.py graph_plane_step_core)
BRANCHES = {
    "a": "keyed, every link verified", "b": "keyed, residual overflow",
    "c": "keyed residual", "d": "general fast path", "e": "general, iterative",
    "f": "general_resident",
}
# the wrapper that makes a branch's flags, and where its fold arguments start
FOLDING = {"b": "pointer_doubling", "c": "emit_scatter", "e": "affine_loop",
           "f": "peel_compact"}
FOLD_AT = {"pointer_doubling": 1, "emit_scatter": 6, "affine_loop": 6, "peel_compact": 10}


def group_scan_inputs(m, sizes, seed):
    """``group_scan``'s inputs as ``_residual_emit`` makes them, numpy
    int32[m] each: a batch of runs (a head, a verified prefix, then a
    residual tail), the i-th residual tail ``sizes[i]`` rows (sum <= m),
    fully verified runs between them; ``p_r`` the first ``m`` positions of
    the stable sort by chain_ok, ``rrs`` their run starts and INT32_MAX
    past the residual rows."""
    rng = np.random.default_rng(seed)
    chain_ok, run_start = [], []

    def run(verified, residual):
        start = len(chain_ok)
        chain_ok.extend([True] * verified + [False] * residual)
        run_start.extend([start] * (verified + residual))

    for size in sizes:
        for _ in range(int(rng.integers(0, 3))):
            run(int(rng.integers(1, 6)), 0)
        run(int(rng.integers(1, 4)), int(size))
    while len(chain_ok) < m + 8:
        run(1, 0)
    chain_ok = np.array(chain_ok)
    p_r = np.argsort(chain_ok, kind="stable")[:m]
    n_residual = int(sum(sizes))
    rrs = np.where(np.arange(m) < n_residual, np.array(run_start)[p_r], (1 << 31) - 1)
    return rrs.astype(np.int32), p_r.astype(np.int32)


def group_sizes(total, low, high, seed):
    """Group sizes drawn from [low, high] that sum to ``total``."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < total:
        sizes.append(min(int(rng.integers(low, high + 1)), total - sum(sizes)))
    return sizes


def group_scan_edge_cases(m):
    """``group_scan``'s edge cases at ``m`` rows (numpy ``(rrs, p_r)``):
    one group; one row a group; every row INT32_MAX (n_residual = 0);
    n_residual = 1, m - 1 and m; groups across the 256-thread blocks; a
    long group before the INT32_MAX rows (m >= 1,500 for all of them to
    fit)."""
    block = 256
    cases = {
        "one group, n_residual = m": [m],
        "one row a group, n_residual = m": [1] * m,
        "all INT32_MAX, n_residual = 0": [],
        "n_residual = 1": [1],
        "n_residual = m - 1, groups of 1-9 rows": group_sizes(m - 1, 1, 9, 5),
        "n_residual = m, groups of 1-9 rows": group_sizes(m, 1, 9, 6),
        "groups across the blocks' boundaries": [block - 1, block + 2, 2 * block + 1, 1,
                                                 block - 3, 37],
        # the INT32_MAX rows start inside a warp whose other group began
        # before it
        "a long group, then the INT32_MAX rows": [3, 100],
    }
    return {f"{label} (m = {m})": group_scan_inputs(m, sizes, i)
            for i, (label, sizes) in enumerate(cases.items())}


def group_scan_numpy(rrs, p_r):
    """The reference's ``firstbad + emit_local``
    (fantoch_tpu/ops/graph_resolve.py:308-309, 335-336) in numpy."""
    r = np.arange(len(rrs))
    head = np.ones(len(rrs), bool)
    head[1:] = rrs[1:] != rrs[:-1]
    firstbad = np.maximum.accumulate(np.where(head, p_r, 0))
    return (firstbad + r - np.maximum.accumulate(np.where(head, r, 0))).astype(np.int32)


class PlainRoute:
    """Inside it every graph-plane wrapper takes its plain version, also on
    the card's tensors: the plain route of a captured dispatch, on the card."""

    def __init__(self, K):
        self.K = K

    def __enter__(self):
        self.saved = self.K._on_card
        self.K._on_card = lambda tensor: False

    def __exit__(self, *exc):
        self.K._on_card = self.saved


def epilogue_counts(K):
    """The standalone ``plane_epilogue`` launches and the folds so far."""
    return {"plane_epilogue": K.LAUNCHES["plane_epilogue"],
            "folded": dict(getattr(K, "EPILOGUE_FOLDS", {}))}


def capture_dispatches(K, gp_module, run):
    """Every plane dispatch while ``run()`` runs: its mode, its arguments
    (clones made before the call: the step updates the state in place),
    its branch, read from the wrappers called inside it, and those
    wrappers' calls (clones made before each): the folding wrapper's (with
    its fold arguments where the checkout folds), and ``group_scan``'s."""
    watched = ("pointer_doubling", "residual_view", "group_scan", "emit_scatter",
               "affine_loop", "peel_compact")
    reals = {name: getattr(K, name) for name in watched}
    current, out = [], []

    def watch(name):
        def call(*args, **kwargs):
            if current:
                if name != "peel_compact" or kwargs.get("mode") == "publish":
                    current[-1]["calls"].setdefault(name, []).append(
                        (clone_args(args), dict(kwargs)))
            return reals[name](*args, **kwargs)
        return call

    real_step = gp_module.resolve_graph_plane_step

    def step(*args, mode):
        current.append({"mode": mode, "args": clone_args(args), "calls": {}})
        try:
            return real_step(*args, mode=mode)
        finally:
            d = current.pop()
            called = d["calls"]
            if mode == "keyed":
                d["branch"] = ("c" if "residual_view" in called else
                               "b" if "pointer_doubling" in called else "a")
            elif mode == "general":
                d["branch"] = "e" if "affine_loop" in called else "d"
            else:
                d["branch"] = "f"
            out.append(d)

    gp_module.resolve_graph_plane_step = step
    for name in watched:
        setattr(K, name, watch(name))
    try:
        run()
    finally:
        gp_module.resolve_graph_plane_step = real_step
        for name, real in reals.items():
            setattr(K, name, real)
    return out


def keyed_path_run(Config, Command, Rifl, KVOp, RunTime, GraphExecutor, GraphAddBatch):
    """Phase 2's shuffled run: ``GraphExecutor`` on the card, the north-star
    feed shuffled around the feed edges; returns the callable, which checks
    the executed order and returns the run's wall seconds."""
    n = BIG
    order = arrival(n, EXECUTOR_BATCH, 4096, 64, SEED + 1)
    src, seq, key, packed, key_of = columns(n, order)
    cmds = [Command.from_keys(Rifl(int(s), int(q)), 0, {f"k{k}": (KVOp.put(""),)})
            for s, q, k in zip(src.tolist(), seq.tolist(), key.tolist())]

    def run():
        executor = GraphExecutor(1, 0, Config(5, 2, batched_graph_executor=True,
                                              device_graph_plane=True))
        executed, wall_s = drive(executor, (src, seq, key, packed), cmds, RunTime,
                                 GraphAddBatch)
        check_chain_order(executed, key_of, n)
        return wall_s

    return run


def general_path_run(Config, Command, Rifl, KVOp, RunTime, GraphExecutor, GraphAddBatch):
    """Phase 4's ``GraphExecutor`` run on the card (2^20 multi-key
    commands); returns the callable."""
    n = BIG
    keys, deps, src0, seq0 = general_workload(n)
    cols = general_columns(deps, src0, seq0, arrival(n, EXECUTOR_BATCH, 4096, 64, SEED + 1))
    cmds = [Command.from_keys(Rifl(int(s), int(q)), 0,
                              {f"g{k}": (KVOp.put(""),) for k in keys[int(q) - 1].tolist()})
            for s, q in zip(cols[0].tolist(), cols[1].tolist())]

    def run():
        executor = GraphExecutor(1, 0, Config(5, 2, batched_graph_executor=True,
                                              device_graph_plane=True))
        drive(executor, cols, cmds, RunTime, GraphAddBatch)

    return run


def as_bytes(value):
    """Every tensor of ``value`` in one byte column, and their shapes and
    types: a replay is compared with two launches and no read."""
    import torch

    tensors = tensors_of(value)
    layout = [(tuple(t.shape), t.dtype) for t in tensors]
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]), layout


def replay_dispatches(torch, K, step, dispatches):
    """Each captured dispatch on the card held against the plain route on
    the card's tensors (every wrapper's plain version: the resolver's,
    then ``plane_epilogue_plain``) at max_abs_err 0 on all ten fields of
    the step (``newly``, ``executed``, ``order``, ``stuck``, ``leader``
    among them), then run ``EPILOGUE_REPLAYS`` times more, every run equal.
    The first run of each is counted (``epilogue_counts``): the
    dispatches' own launches.  Returns (largest error, runs, counts)."""
    worst, runs, wants = 0.0, 0, []
    K.reset_launch_counts()
    for i, d in enumerate(dispatches):
        with PlainRoute(K):
            want = step(*clone_args(d["args"]), mode=d["mode"])
        got = step(*clone_args(d["args"]), mode=d["mode"])
        err = max_abs_err(got, want, "step")
        worst = max(worst, err)
        assert err == 0.0, f"dispatch {i} ({d['mode']}, branch {d['branch']}) differs"
        d["newly"] = int(got.newly.sum().item())
        wants.append(want)
    counts = epilogue_counts(K)
    for i, (d, want) in enumerate(zip(dispatches, wants)):
        feed = d["args"][6:]  # read only: the step updates the state in place
        want, layout = as_bytes(want)
        differ = torch.zeros((), dtype=torch.bool, device=want.device)
        for run in range(EPILOGUE_REPLAYS):
            got, got_layout = as_bytes(
                step(*clone_args(d["args"][:6]), *feed, mode=d["mode"]))
            assert got_layout == layout, f"dispatch {i}, replay {run}: {got_layout}"
            differ |= (got != want).any()
            runs += 1
        assert not bool(differ.item()), f"dispatch {i}: a replay differs"
    return worst, runs, counts


def split_fold(name, out):
    """A folding wrapper's outputs without ``newly``, and ``newly``."""
    if name == "affine_loop":  # newly before the rounds
        return (*out[:3], out[4]), out[3]
    if name == "peel_compact":
        return out[0], out[1]
    return tuple(out[:-1]), out[-1]


def fold_check(K, name, args, kwargs):
    """One folded launch against the plain version without the fold, then
    ``plane_epilogue_plain`` on its flags (outputs, ``newly``, the state
    updated in place and ``executed``); returns the largest error."""
    at = FOLD_AT[name]
    base = clone_args(args[:at])
    occ, executed = clone_args(args[at:at + 2])
    perm = args[at + 2] if name == "emit_scatter" else None
    out = getattr(K, f"{name}_plain")(*base, **kwargs)
    flags = {"pointer_doubling": lambda: out[0], "emit_scatter": lambda: out[1],
             "affine_loop": lambda: out[0], "peel_compact": lambda: base[6]}[name]()
    newly = K.plane_epilogue_plain(occ, executed, flags, perm)
    got_args = clone_args(args)
    got, got_newly = split_fold(name, getattr(K, name)(*got_args, **kwargs))
    return max(max_abs_err(got, out, name), max_abs_err(got_newly, newly, name),
               max_abs_err(got_args[at + 1], executed, name),
               max_abs_err(got_args[:at], base, name))


def phase_epilogue(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                   GraphExecutor, GraphAddBatch, checks=True):
    """The plane's epilogue folded into the launch that makes each branch's
    resolved flags (``graph_resolve.graph_plane_step_core``), and
    ``group_scan`` as one launch.  Every dispatch of phase 2's shuffled run
    and of phase 4's ``general_resident`` run (``GraphExecutor`` on the
    card) and of phase 4's EPaxos and Atlas sims (``Runner(device="cpu")``,
    whose dispatches on the card take the same inputs) is captured with its
    branch (``BRANCHES``), held on the card against the plain route (the
    plain resolver, then ``plane_epilogue_plain``) and replayed
    ``EPILOGUE_REPLAYS`` times; every folded launch is held against its
    plain version without the fold followed by ``plane_epilogue_plain``;
    the first ``PROFILED_PER_BRANCH`` dispatches of each run and branch,
    and each folding wrapper's first call with and without the fold, are
    timed and counted in operations on the card.  ``group_scan`` at phase
    2's calls, at a ``GROUP_ROWS``-row residual and on
    ``group_scan_edge_cases``, each call against its plain version and the
    reference's numpy formula, replayed, timed single and in the loop
    beside its bound and counted on the card.  With ``checks`` (the whole
    smoke; not on an older checkout): no epilogue operation of its own in a
    dispatch of branches (b), (c), (e) and (f), one in (a) and (d); none
    in phase 2 and at most 86 in phase 4; one operation a ``group_scan``
    call, no memset or fill."""
    from fantoch_tpu_torch.ops import graph_resolve

    step = graph_resolve.graph_plane_step_core
    folds = hasattr(K, "EPILOGUE_FOLDS")
    out = {"branches": BRANCHES, "runs": {}, "dispatches": {}, "folded_launches": {},
           "group_scan": {}, "replays": {}, "walls_s": {}}
    walls, t_part = out["walls_s"], time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        walls[name] = now - t_part
        t_part = now

    runs = {
        "phase 2": keyed_path_run(Config, Command, Rifl, KVOp, RunTime, GraphExecutor,
                                  GraphAddBatch),
        "phase 4, general_resident run": general_path_run(
            Config, Command, Rifl, KVOp, RunTime, GraphExecutor, GraphAddBatch),
        "phase 4, EPaxos sim": lambda: sim_run("cpu", "EPaxos"),
        "phase 4, Atlas sim": lambda: sim_run("cpu", "Atlas"),
    }
    captured, worst, replayed = {}, 0.0, 0
    for label, run in runs.items():
        t0 = time.perf_counter()
        dispatches = capture_dispatches(K, gp_module, run)
        capture_s = time.perf_counter() - t0
        dispatches = [{**d, "args": to_card(d["args"]),
                       "calls": {n: [(to_card(a), kw) for a, kw in c]
                                 for n, c in d["calls"].items()}} for d in dispatches]
        t0 = time.perf_counter()
        err, n_runs, counts = replay_dispatches(torch, K, step, dispatches)
        worst, replayed = max(worst, err), replayed + n_runs
        branches = {}
        for d in dispatches:
            branches[d["branch"]] = branches.get(d["branch"], 0) + 1
        out["runs"][label] = {
            "dispatches": len(dispatches), "branches": branches, "epilogue": counts,
            "capture_s": capture_s, "replay_s": time.perf_counter() - t0,
            "rows": sorted({int(d["args"][0].shape[0]) for d in dispatches}),
        }
        log(f"phase 12: {label}: {len(dispatches)} dispatches by branch {branches}, "
            f"each equal to the plain route and replayed {EPILOGUE_REPLAYS} times; "
            f"epilogue on the card {counts}")
        captured[label] = dispatches
    out["replays"]["dispatches"] = replayed
    out["max_abs_err"] = worst
    phase4 = [v for k, v in out["runs"].items() if k.startswith("phase 4")]
    out["epilogue_launches"] = {
        "phase 2": out["runs"]["phase 2"]["epilogue"]["plane_epilogue"],
        "phase 4": sum(r["epilogue"]["plane_epilogue"] for r in phase4),
        "phase 2 folded": sum(out["runs"]["phase 2"]["epilogue"]["folded"].values()),
        "phase 4 folded": sum(sum(r["epilogue"]["folded"].values()) for r in phase4),
    }
    log(f"phase 12: plane_epilogue launches: {out['epilogue_launches']}")
    part("captures and replays")

    # every folded launch against its plain version and plane_epilogue_plain
    fold_calls, fold_err = 0, 0.0
    firsts = {}  # (branch, rows): the folding wrapper's first call
    for label, dispatches in captured.items():
        for d in dispatches:
            name = FOLDING.get(d["branch"])
            if name is None:
                continue
            for args, kwargs in d["calls"][name]:
                folded = len(args) > FOLD_AT[name]
                if folded:
                    err = fold_check(K, name, args, kwargs)
                    assert err == 0.0, f"{label}: {name}'s folded launch differs"
                    fold_err, fold_calls = max(fold_err, err), fold_calls + 1
                key = (d["branch"], int(args[0].shape[0]), label.split(",")[0])
                firsts.setdefault(key, (name, args, kwargs, folded))
    out["replays"]["folded_launches"] = fold_calls
    out["fold_max_abs_err"] = fold_err
    part("folded launches held")
    assert not folds or fold_calls, "no folded launch was captured"
    records = []
    for (branch, rows, where), (name, args, kwargs, folded) in sorted(firsts.items()):
        entry = {}
        at = FOLD_AT[name]
        forms = {"unfolded": args[:at]}
        if folded:
            forms["folded"] = args
        for form, a in forms.items():
            record, _got, _ = stage_record(torch, K, name, a, kwargs)
            entry[form] = record
            records.append(record)
        out["folded_launches"][f"{name}, branch ({branch}), {rows} rows, {where}"] = entry

    # dispatches on the card, the first few of each run and branch
    for label, dispatches in captured.items():
        seen = {}
        for i, d in enumerate(dispatches):
            if seen.get(d["branch"], 0) >= PROFILED_PER_BRANCH:
                continue
            seen[d["branch"]] = seen.get(d["branch"], 0) + 1
            call = (step, clone_args(d["args"]), {"mode": d["mode"]})
            record = {"branch": d["branch"], "mode": d["mode"],
                      "rows": int(d["args"][0].shape[0]), "newly": d["newly"],
                      "ms": time_ms(step, d["args"], {"mode": d["mode"]}),
                      "ms_loop": time_loop_ms(step, d["args"], {"mode": d["mode"]}),
                      "call": call}
            out["dispatches"][f"{label}, dispatch {i}, branch ({d['branch']})"] = record
            records.append(record)
    part("folded launches and dispatches timed")

    # group_scan: phase 2's calls, a 2^16-row residual, edge cases
    gs_calls = {}
    for i, d in enumerate(captured["phase 2"]):
        for args, _kw in d["calls"].get("group_scan", []):
            gs_calls[f"phase 2, dispatch {i}, branch ({d['branch']})"] = args
    del captured
    sizes = group_sizes(3 * GROUP_ROWS // 4, 1, 64, 7)
    cases = {f"a residual of {GROUP_ROWS} rows, {len(sizes)} groups of 1-64 rows":
             group_scan_inputs(GROUP_ROWS, sizes, 8)}
    cases.update(group_scan_edge_cases(GROUP_EDGE_ROWS))
    for label, (rrs, p_r) in cases.items():
        gs_calls[label] = (torch.tensor(rrs, device=CARD), torch.tensor(p_r, device=CARD))
    gs_err = 0.0
    for label, args in gs_calls.items():
        record, got, _ = stage_record(torch, K, "group_scan", args)
        numpy = group_scan_numpy(*(a.cpu().numpy() for a in args))
        assert np.array_equal(got.cpu().numpy(), numpy), f"group_scan, {label}: != numpy"
        record["m"] = int(args[0].numel())
        gs_err = max(gs_err, record["max_abs_err"])
        out["group_scan"][label] = record
        records.append(record)
    out["replays"]["group_scan"] = scan_replays(
        K, "group_scan", [(a, {}) for a in gs_calls.values()], EPILOGUE_REPLAYS)
    out["group_scan_max_abs_err"] = gs_err
    part("group_scan")

    count_ops(torch, records, every_name=True)
    part("operations counted")
    for record in out["dispatches"].values():
        record["epilogue_ops"] = sum("k_epilogue" in n for n in record["op_names_all"])
    for record in records:
        record.pop("op_names_all")
    if checks:
        for label, record in out["dispatches"].items():
            want = 1 if record["branch"] in "ad" else 0
            assert record["epilogue_ops"] == want, (label, record["op_names"])
        assert out["epilogue_launches"]["phase 2"] == 0, out["epilogue_launches"]
        assert out["epilogue_launches"]["phase 4"] <= 86, out["epilogue_launches"]
        for label, record in out["group_scan"].items():
            assert record["device_ops"] == 1, (label, record["op_names"])
            assert not any(f in n.lower() for n in record["op_names"]
                           for f in ("memset", "fill")), (label, record["op_names"])
    log(json.dumps({"epilogue": out}))
    return out


# ---------------------------------------------------------------------------
# emit_scatter with its folded epilogue streamed in vertex order and
# residual_view with no remap fill (phase 13; alone: --residual)
# ---------------------------------------------------------------------------

RESIDUAL_REPLAYS = 50  # runs of each phase 13 call against the plain version
RESIDUAL_BIG_KEYS = 4096  # keys of the 2^20-row window (runs of 256 rows)
RESIDUAL_EDGE_ROWS = 4096  # the edge cases' window
RESIDUAL_EDGE_KEYS = 64  # its keys (runs of 64 rows)
RESIDUAL_EDGE_RES = 256  # its residual buffer (res_n)
# how a residual tail's first row breaks its run (residual_window)
TAIL_KINDS = ("missing", "leaves", "into", "cycle")


def residual_window(n, keys, tails):
    """A keyed window of ``n`` rows (``keys`` divides it): row i on key
    i % keys, depending on the key's row before it (TERMINAL for the
    first), so every link verifies; then ``tails[k]``, ``(rows, kind)`` or
    None, breaks run k at its ``rows``-th row from the end (fewer rows
    than the run), so ``n_residual`` is the sum of the tails' rows.  The
    tail's first row then depends on: ``missing``, MISSING (the tail stays
    unresolved); ``leaves``, the last row of the nearest run before k
    without a tail, a chain_ok row (the dep leaves the residual: the tail
    resolves); ``into``, the last row of the nearest run before k with a
    tail (it stays in the residual and resolves as that tail does);
    ``cycle``, the run's last row (a cycle through the tail).  Returns
    numpy int32 ``(key, dep)``."""
    runs = n // keys
    assert runs * keys == n
    i = np.arange(n)
    key = (i % keys).astype(np.int32)
    dep = np.where(i < keys, -1, i - keys)
    last = (runs - 1) * keys  # + k: run k's last row
    has_tail = [bool(t and t[0]) for t in tails] + [False] * (keys - len(tails))
    for k, tail in enumerate(tails):
        if not (tail and tail[0]):
            continue
        rows, kind = tail
        assert 0 < rows < runs, rows
        first = (runs - rows) * keys + k
        before = [(k - j) % keys for j in range(1, keys)]
        if kind == "missing":
            dep[first] = -2
        elif kind == "leaves":
            dep[first] = last + next(r for r in before if not has_tail[r])
        elif kind == "into":
            dep[first] = last + next(r for r in before if has_tail[r])
        else:
            dep[first] = last + k
    return key, dep.astype(np.int32)


def window_state(n, seed):
    """``occ`` and ``executed`` for a window of ``n`` rows: 3/4 occupied, a
    quarter of those already executed, and a tenth of the free rows marked
    executed too (so that ``pending`` masks both ways)."""
    rng = np.random.default_rng(seed)
    occ = rng.random(n) < 0.75
    executed = np.where(occ, rng.random(n) < 0.25, rng.random(n) < 0.1)
    return occ, executed


def mixed_tails(total, high, seed, kinds=TAIL_KINDS):
    """Tails of 1-``high`` rows that sum to ``total``, each of a kind drawn
    from ``kinds``, one a run from run 0 on."""
    rng = np.random.default_rng(seed)
    return [(rows, kinds[int(rng.integers(0, len(kinds)))])
            for rows in group_sizes(total, 1, high, seed)]


def residual_stage_calls(torch, K, key, dep, res_n, occ, executed, device):
    """The arguments (clones, on ``device``) of ``residual_view`` and
    ``emit_scatter`` in the keyed resolve of a window
    (``graph_resolve.resolve_functional_keyed``, on whatever route ``K``
    takes there), and the folded emit's: its own followed by ``occ``,
    ``executed`` and ``pos_s`` (the keyed plane step's fold), None where
    the residual overflows ``res_n``.  Returns (view, emit, folded)."""
    from fantoch_tpu_torch.ops import graph_resolve

    n = len(key)
    cols = [torch.tensor(a, device=device) for a in
            (key, dep, (1 + np.arange(n) % 5).astype(np.int32), np.arange(n, dtype=np.int32))]

    def resolve():
        graph_resolve.resolve_functional_keyed(*cols, residual_size=res_n)

    emits = []
    views = captured_calls(K, "residual_view",
                           lambda: emits.extend(captured_calls(K, "emit_scatter", resolve)))
    (view,), (emit,) = views, emits
    folded = None
    if emit[5] <= res_n:
        state = [torch.tensor(a, device=device) for a in (occ, executed)]
        folded = (*emit, *state, view[1])
    return view, emit, folded


def residual_edge_cases(torch, K, device):
    """Phase 13's windows beyond phase 2's: 2^20 rows with a residual of
    exactly 65,536 (the plane step's buffer there), then at
    ``RESIDUAL_EDGE_ROWS`` rows with a buffer of ``RESIDUAL_EDGE_RES``:
    n_residual = 1 (an unresolved row; a row whose dep leaves the
    residual), = res_n, > res_n (unfolded only), every tail's dep leaving
    the residual or going into another tail, a window of 4,094 rows (not
    a multiple of the emit init's 4 rows a thread), and a window then the same
    keys with a tail healed and a dep leaving into a row that was residual
    in the window before (an entry of the earlier call's epoch, which must
    read as TERMINAL).  Returns {label: (view, emit, folded)}."""
    big = BIG
    res_big = big // 16  # the keyed plane step's residual buffer at 2^20
    cases = {}

    def put(label, n, keys, tails, res_n, seed):
        key, dep = residual_window(n, keys, tails)
        occ, executed = window_state(n, seed)
        cases[label] = residual_stage_calls(torch, K, key, dep, res_n, occ, executed, device)

    high = big // RESIDUAL_BIG_KEYS - 1
    put(f"{big} rows, n_residual = {res_big} = res_n, tails of 1-{high} rows", big,
        RESIDUAL_BIG_KEYS, mixed_tails(res_big, high, 21), res_big, 22)
    n, keys, res_n = RESIDUAL_EDGE_ROWS, RESIDUAL_EDGE_KEYS, RESIDUAL_EDGE_RES
    put("n_residual = 1, unresolved", n, keys, [(1, "missing")], res_n, 23)
    put("n_residual = 1, its dep leaving the residual", n, keys, [(1, "leaves")], res_n, 24)
    put(f"n_residual = res_n = {res_n}", n, keys, mixed_tails(res_n, 63, 25), res_n, 26)
    put(f"n_residual = res_n + 40 = {res_n + 40} (overflow, unfolded)", n, keys,
        mixed_tails(res_n + 40, 63, 27), res_n, 28)
    put("deps leaving the residual or going into another tail", n, keys,
        mixed_tails(200, 63, 29, ("leaves", "into")), res_n, 30)
    # 4,094 = 46 runs of 89 rows: the init's last thread takes 2 rows
    put(f"{n - 2} rows, not a multiple of 4", n - 2, 46, mixed_tails(res_n, 88, 32),
        res_n, 33)
    # runs 0-1 broken, then run 0 healed and run 1's dep into run 0's last
    # row, residual in the call before
    put("a window with tails on runs 0 and 1", n, keys, [(8, "missing"), (8, "missing")],
        res_n, 31)
    put("then run 0 healed, run 1's dep into run 0's former tail", n, keys,
        [None, (4, "leaves")], res_n, 31)
    return cases


def unresolved_kinds(folded, out):
    """How many unresolved residual vertices of a folded emit call are
    occupied and pending, already executed, free: ``(pending, executed,
    free)``."""
    occ, executed, pos_s = folded[6], folded[7], folded[8]
    res_b = out[1]
    vertex = pos_s[~res_b].long()
    o, x = occ[vertex], executed[vertex]
    return (int((o & ~x).sum().item()), int(x.sum().item()), int((~o).sum().item()))


def phase_residual(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                   GraphExecutor, GraphAddBatch, checks=True):
    """``residual_view`` and ``emit_scatter`` (``csrc/graph_plane_step.cu`` §4
    and §7) at phase 2's residual calls (its run captured on the card, the
    emit folded and unfolded), at 2^20 rows with a 65,536-row residual and
    on ``residual_edge_cases``: every call held against its plain version
    (outputs and ``executed``, updated in place) and replayed
    ``RESIDUAL_REPLAYS`` times, timed single and in the loop beside its
    bound (the bytes the function itself needs) and counted in operations
    on the card, and phase 2's residual dispatches too.  With ``checks``
    (the whole smoke; not on an older checkout): at most 2 operations a
    call of either wrapper, none a memset or fill, and the folded calls
    reach unresolved residual vertices that are pending, executed and
    free."""
    from fantoch_tpu_torch.ops import graph_resolve

    step = graph_resolve.graph_plane_step_core
    out = {"residual_view": {}, "emit_scatter": {}, "dispatches": {}, "replays": {},
           "unresolved_vertices": {}, "walls_s": {}}
    walls, t_part = out["walls_s"], time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        walls[name] = now - t_part
        t_part = now

    run = keyed_path_run(Config, Command, Rifl, KVOp, RunTime, GraphExecutor, GraphAddBatch)
    dispatches = [d for d in capture_dispatches(K, gp_module, run) if d["branch"] == "c"]
    assert dispatches, "phase 2's run made no residual dispatch"
    part("phase 2 captured")
    cases = {}
    for i, d in enumerate(dispatches):
        (view, _kw), = d["calls"]["residual_view"]
        (emit, _kw), = d["calls"]["emit_scatter"]
        label = f"phase 2, dispatch {i}, {view[0].numel()} rows of {view[1].numel()}"
        cases[label] = (view, emit[:6], emit if len(emit) > 6 else None)
    cases.update(residual_edge_cases(torch, K, CARD))
    part("edge cases built")
    records, kinds = [], [0, 0, 0]
    calls = {"residual_view": [], "emit_scatter": []}
    worst = 0.0
    for label, (view, emit, folded) in cases.items():
        forms = [("residual_view", label, view), ("emit_scatter", f"{label}, unfolded", emit)]
        if folded is not None:
            forms.append(("emit_scatter", f"{label}, folded", folded))
        for name, what, args in forms:
            record, got, _ = stage_record(torch, K, name, args)
            record["n_residual"] = int(args[6] if name == "residual_view" else args[5])
            worst = max(worst, record["max_abs_err"])
            out[name][what] = record
            records.append(record)
            calls[name].append((args, {}))
            if args is folded:
                counts = unresolved_kinds(folded, got)
                out["unresolved_vertices"][what] = counts
                kinds = [a + b for a, b in zip(kinds, counts)]
    out["max_abs_err"] = worst
    log(f"phase 13: {len(cases)} windows, every call equal to its plain version; "
        f"unresolved residual vertices pending, executed, free: {kinds}")
    part("held and timed")
    for name, name_calls in calls.items():
        out["replays"][name] = scan_replays(K, name, name_calls, RESIDUAL_REPLAYS)
    part("replays")
    for i, d in enumerate(dispatches[:PROFILED_PER_BRANCH]):
        record = {"rows": int(d["args"][0].shape[0]),
                  "ms": time_ms(step, d["args"], {"mode": d["mode"]}),
                  "ms_loop": time_loop_ms(step, d["args"], {"mode": d["mode"]}),
                  "call": (step, clone_args(d["args"]), {"mode": d["mode"]})}
        out["dispatches"][f"phase 2, dispatch {i}, branch (c)"] = record
        records.append(record)
    count_ops(torch, records)
    part("operations counted")
    if checks:
        for name in ("residual_view", "emit_scatter"):
            for label, record in out[name].items():
                assert record["device_ops"] <= 2, (name, label, record["op_names"])
                assert not any(f in n.lower() for n in record["op_names"]
                               for f in ("memset", "fill")), (name, label, record["op_names"])
        assert all(kinds), f"unresolved residual vertices pending, executed, free: {kinds}"
    log(json.dumps({"residual": out}))
    return out


# ---------------------------------------------------------------------------
# the host-column route and partial replication (phase 14; alone:
# --host-route)
# ---------------------------------------------------------------------------

# the arrival-order run: 2^18 of the 1M (the whole smoke went past 900 s
# with all 1M there; its flushes take the fast path either way)
IN_ORDER = 1 << 18
HOST_MID = 1 << 16  # the CPU comparisons' and the native route's batch
HOST_MID_FEED = 1 << 14
HOST_SMALL = 4096  # the structure branch: every flush at most the threshold
HOST_SMALL_FEED = 1024
# the wrappers the host-column route reaches (the plane's prologue and its
# standalone epilogue are the plane's own)
# the resolvers the host-column route calls (executor/graph/batched.py),
# each timed alone in a flush on the card
RESOLVERS = ("resolve_keyed_auto", "resolve_general_resident", "resolve_general")
HOST_ROUTE_KERNELS = ("lex_sort", "link_scan", "residual_view", "group_scan",
                      "pointer_doubling", "emit_scatter", "mutual_collapse",
                      "affine_loop", "peel_stage", "peel_compact")


def host_config(Config, **knobs):
    """The JAX package's default batched executor: the plane off."""
    return Config(5, 2, batched_graph_executor=True, **knobs)


def keyed_cmds(Command, Rifl, KVOp, cols):
    put = (KVOp.put(""),)  # one immutable op tuple shared by every command
    return [Command.from_keys(Rifl(s, q), 0, {f"k{k}": put})
            for s, q, k in zip(cols[0].tolist(), cols[1].tolist(), cols[2].tolist())]


def general_cmds(Command, Rifl, KVOp, cols, keys):
    put, rows = (KVOp.put(""),), keys.tolist()
    return [Command.from_keys(Rifl(s, q), 0, {f"g{k}": put for k in rows[q - 1]})
            for s, q in zip(cols[0].tolist(), cols[1].tolist())]


def host_drive(torch, K, executor, cols, cmds, RunTime, GraphAddBatch, feed, timed=True):
    """Feed ``executor`` the columns as ``GraphAddBatch`` feeds of ``feed``
    (one flush a feed); returns the executed sequences, the wall seconds
    and each flush's route, keyed branch (told by the calls it made: the
    full doubling of an overflow, the residual's ``group_scan``), wrappers
    launched and, with ``timed`` (on the card), its host and CUDA-event
    milliseconds."""
    from collections import Counter

    from fantoch_tpu_torch.executor.graph import batched
    from fantoch_tpu_torch.ops import graph_resolve

    src, seq, key, packed = cols
    graph = executor.graph
    clock = RunTime()
    executed, flushes, calls, resolves = [], [], Counter(), []
    spied = [(graph_resolve, "resolve_functional"), (K, "group_scan")]
    spied += [(batched, name) for name in RESOLVERS]
    real = [getattr(module, name) for module, name in spied]
    for (module, name), fn in zip(spied, real):
        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            if _name not in RESOLVERS or not timed:
                return _fn(*args, **kwargs)
            # the resolve alone: uploaded columns in, results on the card
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            resolves.append(((time.perf_counter() - t) * 1e3, start.elapsed_time(end)))
            return out

        setattr(module, name, counted)
    try:
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, len(src), feed):
            cut = slice(s, s + feed)
            routes, launches, made = Counter(graph.routes), dict(K.LAUNCHES), Counter(calls)
            resolves.clear()
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t = time.perf_counter()
            executor.handle(GraphAddBatch(src[cut], seq[cut], key[cut], packed[cut],
                                          cmds[cut]), clock)
            flush = {"rows": len(src[cut])}
            if timed:
                end.record()
                torch.cuda.synchronize()
                flush["host_ms"] = (time.perf_counter() - t) * 1e3
                flush["card_ms"] = start.elapsed_time(end)
                if resolves:
                    (flush["resolve_host_ms"], flush["resolve_card_ms"]), = resolves
            route, = (graph.routes - routes).keys() or ("none",)
            made = calls - made
            if route == "keyed":
                route = ("keyed overflow" if made["resolve_functional"] else
                         "keyed residual" if made["group_scan"] else "keyed verified")
            flush["route"] = route
            flush["launches"] = {k: v - launches[k] for k, v in K.LAUNCHES.items()
                                 if v != launches[k]}
            flushes.append(flush)
            while (r := executor.to_clients()) is not None:
                executed.append(r.rifl.sequence)
        if timed:
            torch.cuda.synchronize()
    finally:
        for (module, name), fn in zip(spied, real):
            setattr(module, name, fn)
    return executed, time.perf_counter() - t0, flushes


def flush_summary(flushes, n, wall_s):
    """Routes, p50 and range of a flush on the card and on the host,
    commands/s."""
    from collections import Counter

    by_route = {}
    for f in flushes:
        by_route.setdefault(f["route"], Counter()).update(f["launches"])
    out = {"commands": n, "wall_s": wall_s, "commands_per_s": n / wall_s,
           "routes": dict(Counter(f["route"] for f in flushes)),
           "launches_by_route": {r: dict(c) for r, c in by_route.items()},
           "flushes": flushes}
    for side in ("card_ms", "host_ms", "resolve_card_ms", "resolve_host_ms"):
        values = [f[side] for f in flushes if side in f]
        if values:
            out[f"p50_{side}"] = float(np.median(values))
            out[f"range_{side}"] = [min(values), max(values)]
    return out


def routes_above(summary):
    """The routes of a run's flushes of more than ``HOST_SMALL`` rows (a
    feed at most the structure threshold takes the small routes)."""
    return {f["route"] for f in summary["flushes"] if f["rows"] > HOST_SMALL}


def command_order(results, keys):
    """The command order of a multi-key run's results (one a distinct key
    of a command, asserted), as sequences."""
    results = np.asarray(results, dtype=np.int64)
    distinct = np.array([len(set(row)) for row in keys.tolist()])
    assert np.array_equal(np.bincount(results - 1, minlength=len(keys)), distinct), (
        "a command's results are not one per key")
    return results[np.sort(np.unique(results, return_index=True)[1])].tolist()


def per_key(executed, keys):
    """{key: executed sequences in order} (``keys`` by command index)."""
    out = {}
    for q in executed:
        for k in np.atleast_1d(keys[q - 1]).tolist():
            out.setdefault(k, []).append(q)
    return out


class Shards:
    """Atlas with ``shard_count`` 2, n = 3, f = 1, the batched graph
    executor on ``device``, driven by a message loop in the script
    (``tests/test_partial.py``'s harness)."""

    def __init__(self, device, **knobs):
        from collections import deque

        from fantoch_tpu_torch.core import Config, RunTime, process_ids
        from fantoch_tpu_torch.executor.graph.executor import GraphRequest
        from fantoch_tpu_torch.protocol.graph_protocol import Atlas

        self.request_type, self.time = GraphRequest, RunTime()
        config = Config(n=3, f=1, shard_count=2, gc_interval_ms=100,
                        batched_graph_executor=True, **knobs)
        self.protocols, self.executors, self.shard_of = {}, {}, {}
        self.queue = deque()
        for shard in range(2):
            ids = list(process_ids(shard, 3))
            for pid in ids:
                proto = Atlas(pid, shard, config)
                other = list(process_ids(1 - shard, 3))[pid - ids[0]]
                ok, _ = proto.discover([(pid, shard)] + [(p, shard) for p in ids if p != pid]
                                       + [(other, 1 - shard)])
                assert ok
                executor = Atlas.Executor(pid, shard, config, device=device)
                executor.set_executor_index(0)
                self.protocols[pid], self.executors[pid] = proto, executor
                self.shard_of[pid] = shard

    def submit(self, pid, cmd):
        self.protocols[pid].submit(None, cmd, self.time)
        self.drain(pid)

    def drain(self, pid):
        import copy

        from fantoch_tpu_torch.protocol.base import ToForward, ToSend

        for action in self.protocols[pid].to_processes_iter():
            if isinstance(action, ToSend):
                targets = sorted(action.target)
                msgs = [action.msg] + [copy.deepcopy(action.msg) for _ in targets[1:]]
                self.queue.extend((pid, self.shard_of[pid], t, m)
                                  for t, m in zip(targets, msgs))
            elif isinstance(action, ToForward):
                self.queue.append((pid, self.shard_of[pid], pid, action.msg))
        for info in self.protocols[pid].to_executors_iter():
            self.executors[pid].handle(info, self.time)
            self.drain_executor(pid)

    def drain_executor(self, pid):
        while (out := self.executors[pid].to_executors()) is not None:
            to_shard, info = out
            target = (pid if to_shard == self.shard_of[pid]
                      else self.protocols[pid].bp.closest_process(to_shard))
            peer = self.executors[target]
            if isinstance(info, self.request_type):
                peer.set_executor_index(1)
                peer.handle(info, self.time)
                peer.graph.cleanup(self.time)
                peer.set_executor_index(0)
            else:
                peer.handle(info, self.time)
            self.drain_executor(target)

    def run(self):
        steps = 0
        while self.queue:
            steps += 1
            assert steps < 200_000, "message storm"
            from_pid, from_shard, to_pid, msg = self.queue.popleft()
            self.protocols[to_pid].handle(from_pid, from_shard, msg, self.time)
            self.drain(to_pid)

    def executed(self):
        out = {}
        for pid, executor in self.executors.items():
            rifls = out.setdefault(pid, [])
            while (r := executor.to_clients()) is not None:
                rifls.append((r.rifl.source, r.rifl.sequence))
        return out


def partial_run(device, commands=48, seed=SEED):
    """Multi-shard and single-shard commands on a few shared keys, one or
    two keys a shard, submitted in rounds at every process; returns each
    process's executed rifls and the graphs' routes."""
    from collections import Counter

    from fantoch_tpu_torch.core import Command, KVOp, Rifl

    rng = np.random.default_rng(seed)
    cluster = Shards(device)
    for i in range(commands):
        shards = [0, 1] if rng.random() < 0.6 else [int(rng.integers(0, 2))]
        by_shard = {s: {f"s{s}k{int(k)}": (KVOp.put(f"v{i}"),)
                        for k in rng.choice(6, int(rng.integers(1, 3)), replace=False)}
                    for s in shards}
        pid = int(rng.integers(1, 7))
        if cluster.shard_of[pid] != min(shards):
            pid = 1 + 3 * min(shards) + pid % 3
        cluster.submit(pid, Command(Rifl(1 + i % 4, 1 + i // 4), by_shard))
        if i % 6 == 5:
            cluster.run()
    cluster.run()
    routes = Counter()
    for executor in cluster.executors.values():
        routes.update(executor.graph.routes)
    return cluster.executed(), dict(routes)


def phase_host(torch, K, Config, Command, Rifl, KVOp, RunTime, GraphExecutor,
               GraphAddBatch, checks=True):
    """The batched graph executor's host-column route on the card and
    partial replication (phase 14): see the module docstring.
    Every check raises; with ``checks``, every wrapper of the route must
    have launched on its path."""
    from fantoch_tpu_torch.executor.base import ExecutorMetricsKind

    out = {"runs": {}, "cpu_equal": {}, "walls_s": {}}
    walls, t_part = out["walls_s"], time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        walls[name] = now - t_part
        t_part = now

    def run(label, cols, cmds, feed, device=CARD, **knobs):
        """One executor run; returns (executed, summary, CHAIN_SIZE)."""
        executor = GraphExecutor(1, 0, host_config(Config, **knobs), device=device)
        assert executor.graph._plane is None
        executed, wall_s, flushes = host_drive(
            torch, K, executor, cols, cmds, RunTime, GraphAddBatch, feed,
            timed=torch.device(device).type == "cuda")
        chain = executor.metrics().get_collected(ExecutorMetricsKind.CHAIN_SIZE)
        summary = flush_summary(flushes, len(set(executed)), wall_s)
        if label:
            out["runs"][label] = summary
            log(f"phase 14: {label}: {summary['commands']} commands, routes {summary['routes']}, "
                f"p50 flush {summary.get('p50_card_ms', 0):.3f} ms on the card "
                f"(CUDA events), {summary.get('p50_host_ms', 0):.3f} ms on the host, "
                f"its resolve {summary.get('p50_resolve_card_ms', 0):.3f} ms on the card, "
                f"{summary['commands_per_s']:.1f} commands/s ({wall_s:.3f} s); "
                f"launches by route {summary['launches_by_route']}")
        return executed, summary, (list(chain.values()) if chain else None)

    # --- the route's path: full width, counts set to 0 just before
    n = BIG
    order = arrival(n, EXECUTOR_BATCH, 4096, 64, SEED + 1)
    shuffled = columns(n, order)
    key_of = shuffled[4]
    keyed_all = keyed_cmds(Command, Rifl, KVOp, shuffled)
    # the first IN_ORDER commands in arrival order (their dependencies all
    # point behind them), taken from the shuffled feed's columns
    position = np.empty(n, dtype=np.int64)
    position[order] = np.arange(n)
    head = position[:IN_ORDER]
    in_order = tuple(c[head] for c in shuffled[:4])
    in_order_cmds = [keyed_all[i] for i in head.tolist()]
    mid_order = arrival(HOST_MID, HOST_MID, 2 * HOST_MID, 64, SEED + 2)
    overflow = columns(HOST_MID, mid_order)
    overflow_cmds = keyed_cmds(Command, Rifl, KVOp, overflow)
    gkeys, gdeps, gsrc, gseq = general_workload(n)
    general = general_columns(gdeps, gsrc, gseq, arrival(n, EXECUTOR_BATCH, 4096, 64,
                                                         SEED + 1))
    general_all = general_cmds(Command, Rifl, KVOp, general, gkeys)
    ckeys, cdeps, csrc, cseq = cycle_rich(HOST_SMALL, 64)
    small = general_columns(cdeps, csrc, cseq, np.arange(HOST_SMALL))
    small_cmds = general_cmds(Command, Rifl, KVOp, small, ckeys)
    part("feeds built")

    K.reset_launch_counts()
    executed, summary, _ = run("keyed, in arrival order", in_order, in_order_cmds,
                               EXECUTOR_BATCH)
    check_chain_order(executed, key_of[:IN_ORDER], IN_ORDER)
    # with nothing pending and every dependency behind it, a flush above the
    # structure threshold takes the arrival-order fast path: no resolve
    assert routes_above(summary) == {"fast"}, summary["routes"]
    executed, summary, _ = run("keyed, shuffled", shuffled[:4], keyed_all, EXECUTOR_BATCH)
    check_chain_order(executed, key_of, n)
    keyed_order = executed
    executed, summary, _ = run(f"keyed, {HOST_MID} shuffled throughout", overflow[:4],
                               overflow_cmds, HOST_MID)
    check_chain_order(executed, overflow[4], HOST_MID)
    overflowed = sum(s["routes"].get("keyed overflow", 0) for s in out["runs"].values())
    assert overflowed, {k: s["routes"] for k, s in out["runs"].items()}
    resident, summary, _ = run("multi-key, resident", general, general_all, EXECUTOR_BATCH)
    check_key_order(command_order(resident, gkeys), gkeys, n)
    assert routes_above(summary) <= {"general_resident", "fast"}, summary["routes"]
    executed, summary, _ = run(f"multi-key, {HOST_SMALL} cycle-rich", small, small_cmds,
                               HOST_SMALL_FEED)
    # links run either way inside a chunk (cycles): every command once
    assert sorted(command_order(executed, ckeys)) == list(range(1, HOST_SMALL + 1))
    out["launches"] = dict(K.LAUNCHES)
    not_run = [k for k in HOST_ROUTE_KERNELS if not out["launches"][k]]
    log(f"phase 14: the route's path launched {out['launches']}")
    if checks:
        assert not not_run, f"kernels of the route never launched: {not_run}"
        assert not out["launches"]["graph_prologue"], out["launches"]
    part("route's path")

    # --- the same feeds on the card and on the CPU; the card's wrappers
    # held against their plain versions call by call (the Checker)
    checker = Checker(K)
    mid_keys, mid_deps, mid_src, mid_seq = general_workload(HOST_MID)
    mid_general = general_columns(mid_deps, mid_src, mid_seq,
                                  arrival(HOST_MID, HOST_MID_FEED, 1024, 64, SEED + 3))
    keyed_edges = columns(HOST_MID, arrival(HOST_MID, HOST_MID_FEED, 1024, 64, SEED + 4))
    keyed_small = columns(HOST_SMALL, arrival(HOST_SMALL, HOST_SMALL_FEED, 512, 16, SEED + 5))
    cases = [
        ("keyed, 2^16 shuffled throughout", overflow[:4], overflow_cmds, HOST_MID),
        ("keyed, 2^16 in feeds of 2^14", keyed_edges[:4],
         keyed_cmds(Command, Rifl, KVOp, keyed_edges), HOST_MID_FEED),
        ("keyed, 4096 in feeds of 1024", keyed_small[:4],
         keyed_cmds(Command, Rifl, KVOp, keyed_small), HOST_SMALL_FEED),
        ("multi-key, 2^16 resident", mid_general,
         general_cmds(Command, Rifl, KVOp, mid_general, mid_keys), HOST_MID_FEED),
        ("multi-key, 4096 cycle-rich", small, small_cmds, HOST_SMALL_FEED),
    ]
    checker.install()
    try:
        for label, cols, cmds, feed in cases:
            got, gsum, gchain = run(None, cols, cmds, feed)
            want, wsum, wchain = run(None, cols, cmds, feed, device="cpu")
            assert got == want, f"{label}: the card's and the CPU's orders differ"
            assert gchain == wchain, f"{label}: CHAIN_SIZE histograms differ"
            out["cpu_equal"][label] = {"commands": len(got), "routes": gsum["routes"],
                                       "chain_size_bins": len(gchain or [])}
        # the keyed chain at the full-width run's padded shapes, held the
        # same way (the resident route's stages are the halving schedule's
        # sizes, held by phases 3 and 10)
        executed, _s, _c = run(None, shuffled[:4], keyed_all, EXECUTOR_BATCH)
        assert executed == keyed_order
    finally:
        checker.uninstall()
    out["checked_calls"] = {k: v for k, v in checker.count.items() if v}
    out["max_abs_err"] = max(checker.err.values())
    log(f"phase 14: card equal to CPU (orders, CHAIN_SIZE) on {len(cases)} feeds; "
        f"wrapper calls held against their plain versions: {out['checked_calls']}")
    part("card against CPU")

    # --- the native route against the device route, per key
    for label, cols, cmds, feed, keys in (
        ("keyed", keyed_edges[:4], keyed_cmds(Command, Rifl, KVOp, keyed_edges),
         HOST_MID_FEED, keyed_edges[4]),
        ("multi-key", mid_general, general_cmds(Command, Rifl, KVOp, mid_general, mid_keys),
         HOST_MID_FEED, mid_keys),
    ):
        native, nsum, _ = run(None, cols, cmds, feed, host_native_resolver=True)
        device, _dsum, _ = run(None, cols, cmds, feed)
        if label == "multi-key":
            native, device = command_order(native, keys), command_order(device, keys)
        assert set(nsum["routes"]) <= {"native", "fast"}, nsum["routes"]
        assert sorted(native) == sorted(device) == list(range(1, HOST_MID + 1)), label
        assert per_key(native, keys) == per_key(device, keys), f"native {label}: per key"
        out["runs"][f"native, {label} 2^16"] = {k: v for k, v in nsum.items()
                                                if k != "flushes"}
    log("phase 14: the native route's per-key orders equal the device route's at 2^16")
    part("native")

    # --- partial replication: the card against the CPU
    K.reset_launch_counts()
    got, routes = partial_run(CARD)
    out["partial_launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
    want, _ = partial_run("cpu")
    assert got == want, "partial replication: the shards' orders differ"
    assert all(got.values()) and routes, routes
    out["partial"] = {"executed": {pid: len(r) for pid, r in got.items()}, "routes": routes}
    log(f"phase 14: partial replication (Atlas, 2 shards, n = 3): every process's "
        f"order equal on cuda and cpu; routes {routes}, launches {out['partial_launches']}")
    part("partial")
    log(json.dumps({"host_route": out}))
    return out


# ---------------------------------------------------------------------------
# the observability plane and the device-fault injector (phase 15; alone:
# --observe)
# ---------------------------------------------------------------------------

OBSERVE_FAULT_AT = 3  # the dispatch the injected faults hit (each plane's k)
OBSERVE_COMMANDS = 4  # commands a client in the fault sims (the shortest runs)
PROFILE_MS = 200  # the profile capture's length
# the sweep of (c): a plane at two capacities, fed the same votes and rows
SWEEP_CAPACITIES = (1 << 10, 1 << 16)
# the plane each fault sim targets: its protocol, config knobs and seed (the
# sims of phases 4, 6 and 8)
FAULT_SIMS = {
    "graph": ("EPaxos", dict(batched_graph_executor=True, device_graph_plane=True), 0),
    "table": ("Newt", dict(newt_detached_send_interval_ms=100, batched_table_executor=True,
                           device_table_plane=True), 0),
    "pred": ("Caesar", dict(caesar_wait_condition=True, device_pred_plane=True), 2),
}


def observed_sim(device, out_dir, protocol_name="EPaxos", knobs=None, seed=0,
                 commands=10, fault=None, shadow=0.0, telemetry=True):
    """A sim at phase 4's shape (n = 5, f = 2, two keys a command, 50%
    conflict, three clients a process, reordering) with the span log at
    rate 1.0, the flight recorder and the series under ``out_dir``, and a
    fault plan carrying ``fault`` (``DeviceFault`` keywords) when given;
    returns the runner and the typed failure that ended the run (None)."""
    from fantoch_tpu_torch import protocol
    from fantoch_tpu_torch.client import ConflictRateKeyGen, Workload
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.errors import FaultToleranceError
    from fantoch_tpu_torch.sim import Runner
    from fantoch_tpu_torch.sim.faults import FaultPlan

    knobs = knobs if knobs is not None else FAULT_SIMS["graph"][1]
    config = Config(
        5, 2, executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100, trace_sample_rate=1.0,
        telemetry_interval_ms=50, plane_shadow_rate=shadow, **knobs,
    )
    planet = Planet.new("gcp")
    workload = Workload(
        shard_count=1, key_gen=ConflictRateKeyGen(50), keys_per_command=2,
        commands_per_client=commands, payload_size=1,
    )
    regions = sorted(planet.regions())[:5]
    plan = FaultPlan(seed=3).with_device_fault(**fault) if fault else None
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    runner = Runner(
        getattr(protocol, protocol_name), planet, config, workload, 3,
        process_regions=list(regions), client_regions=list(regions), seed=seed,
        device=device, trace_path=f"{out_dir}/trace.jsonl",
        flight_dir=f"{out_dir}/flight",
        telemetry_path=f"{out_dir}/series.jsonl" if telemetry else None,
        fault_plan=plan,
    )
    runner.reorder_messages()
    try:
        runner.run(extra_sim_time_ms=10_000)
    except FaultToleranceError as exc:
        return runner, exc
    runner.dump_flight("end of run")
    return runner, None


def observed_outputs(out_dir):
    """The files an observed sim wrote, its critical path and its Perfetto
    JSON (each from its own span log)."""
    from fantoch_tpu_torch.observability.critpath import critpath_report
    from fantoch_tpu_torch.observability.perfetto import to_perfetto, validate_perfetto
    from fantoch_tpu_torch.observability.tracer import read_trace

    files = {str(p.relative_to(out_dir)): p.read_bytes()
             for p in sorted(Path(out_dir).rglob("*")) if p.is_file()}
    events = read_trace(f"{out_dir}/trace.jsonl")
    perfetto = to_perfetto(events)
    validate_perfetto(perfetto)
    return files, critpath_report(events), json.dumps(perfetto, sort_keys=True)


def all_launches(K, T, P):
    return sum(K.LAUNCHES.values()) + sum(T.LAUNCHES.values()) + sum(P.LAUNCHES.values())


def fault_case(torch, K, T, P, plane, kind, tmp):
    """The shortest sim of ``plane``'s protocol on the card whose plan
    faults p1's plane at dispatch ``OBSERVE_FAULT_AT``: the typed error at
    that dispatch, nothing launched once a hang or raise was detected, one
    flight dump a process whose reason names the plane, and the nemesis'
    ``device-*`` lines."""
    from fantoch_tpu_torch.errors import DeviceCorruptionError, DeviceFailedError
    from fantoch_tpu_torch.executor.device_plane import DevicePlane

    protocol_name, knobs, seed = FAULT_SIMS[plane]
    at_failure = {}
    real_fail = DevicePlane._fail

    def fail(self, exc):
        torch.cuda.synchronize()
        at_failure["launches"] = all_launches(K, T, P)
        return real_fail(self, exc)

    DevicePlane._fail = fail
    try:
        K.reset_launch_counts(), T.reset_launch_counts(), P.reset_launch_counts()
        t0 = time.perf_counter()
        out_dir = f"{tmp}/{plane}-{kind}"
        runner, exc = observed_sim(
            CARD, out_dir, protocol_name, knobs, seed, commands=OBSERVE_COMMANDS,
            fault=dict(process_id=1, plane=plane, kind=kind,
                       at_dispatch=OBSERVE_FAULT_AT, down_dispatches=2),
            shadow=1.0 if kind == "corrupt" else 0.0, telemetry=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DevicePlane._fail = real_fail
    label = f"{plane} {kind}"
    if kind == "corrupt":
        assert isinstance(exc, DeviceCorruptionError), (label, exc)
        assert (exc.array_index, exc.row) == (0, 0), (label, str(exc))
    else:
        assert isinstance(exc, DeviceFailedError) and exc.kind == kind, (label, exc)
        # detected before the dispatch's kernels: nothing launched after
        assert all_launches(K, T, P) == at_failure["launches"], (label, at_failure)
    assert exc.plane == plane and exc.process_id == 1, (label, str(exc))
    assert exc.dispatch == OBSERVE_FAULT_AT, (label, str(exc))
    assert at_failure["launches"] > 0, (label, "no kernel ran before the fault")
    dumps = sorted(Path(out_dir, "flight").glob("flight_p*.json"))
    assert [p.name for p in dumps] == [f"flight_p{p}.json" for p in range(1, 6)], dumps
    reasons = {json.loads(p.read_text())["reason"] for p in dumps}
    assert len(reasons) == 1 and f"{plane} plane" in reasons.pop(), label
    lines = [line for line in runner.nemesis.trace_lines() if " device-" in line]
    assert [line.split()[1] for line in lines] == [f"device-{kind}", "device-failover"], lines
    log(f"phase 15: {plane} plane, {kind} at dispatch {OBSERVE_FAULT_AT} ({protocol_name} "
        f"on {CARD}, {wall:.1f} s): {type(exc).__name__}, {at_failure['launches']} "
        f"launches before it, {len(dumps)} flight dumps; {lines}")
    return {"error": str(exc), "launches_before": at_failure["launches"],
            "wall_s": wall, "nemesis": lines}


def chain_graph(Config):
    """A graph on its plane on the card, for ``feed_chain``."""
    from fantoch_tpu_torch.executor.graph.batched import BatchedDependencyGraph

    return BatchedDependencyGraph(
        1, 0, Config(3, 1, batched_graph_executor=True, device_graph_plane=True),
        device=CARD)


def feed_chain(graph, Command, Rifl, KVOp, RunTime, seq):
    """One feed of 64 single-key commands on 8 keys, each after the one 8
    before it, in reverse arrival order (one keyed plane dispatch); all 64
    execute.  Returns the last sequence number fed."""
    from fantoch_tpu_torch.core import Dot
    from fantoch_tpu_torch.protocol.common.graph_deps import Dependency

    adds = []
    for _ in range(64):
        seq += 1
        cmd = Command.from_keys(Rifl(1, seq), 0, {f"k{seq % 8}": (KVOp.put(""),)})
        deps = [Dependency(Dot(1, seq - 8), frozenset({0}))] if seq > 8 else []
        adds.append((Dot(1, seq), cmd, deps))
    graph.handle_add_batch(list(reversed(adds)), RunTime())
    assert len(graph.commands_to_execute()) == 64
    return seq


def capacity_sweep(torch, T, P, Config, Command, Rifl, KVOp, RunTime):
    """(c): the table plane and the pred plane at each of
    ``SWEEP_CAPACITIES``, fed the same votes and feeds on the card, and a
    graph plane fed chains."""
    from fantoch_tpu_torch.executor.table_plane import DeviceTablePlane

    rng = np.random.default_rng(SEED)
    graph, seq = chain_graph(Config), 0
    for _ in range(8):
        seq = feed_chain(graph, Command, Rifl, KVOp, RunTime, seq)
    for cap in SWEEP_CAPACITIES:
        plane = DeviceTablePlane(3, stability_threshold=2, key_buckets=cap, device=CARD)
        for k in range(64):
            plane.bucket(f"k{k}")
        for _ in range(4):
            keys = rng.integers(0, 64, 256).astype(np.int64)
            start = rng.integers(1, 40, 256).astype(np.int64)
            plane.commit_votes(keys, rng.integers(1, 4, 256).astype(np.int64), start,
                               start + rng.integers(0, 6, 256).astype(np.int64))
        assert plane._device.type == torch.device(CARD).type and plane._cap == cap
        pred_plane_run(P, CARD, 256, 32, 4, cap)


def profile_capture(torch, K, Config, Command, Rifl, KVOp, RunTime, tmp):
    """(d): ``capture_device_profile`` for ``PROFILE_MS`` over graph-plane
    dispatches (a graph on the card fed single-key chains until the
    capture ends); returns the capture's result and the graph kernels its
    trace names."""
    import asyncio

    from fantoch_tpu_torch.observability.exposition import capture_device_profile

    graph = chain_graph(Config)
    feeds = {"dispatches": 0}

    async def dispatches(done):
        seq = 0
        while not done.is_set():
            seq = feed_chain(graph, Command, Rifl, KVOp, RunTime, seq)
            feeds["dispatches"] = graph._plane.dispatches
            await asyncio.sleep(0)

    async def scenario():
        done = asyncio.Event()
        work = asyncio.ensure_future(dispatches(done))
        await asyncio.sleep(0)
        result = await capture_device_profile(tmp, PROFILE_MS)
        done.set()
        await work
        return result

    result = asyncio.run(scenario())
    assert "path" in result and result["activities"] == ["CPU", "CUDA"], result
    trace = json.loads(Path(result["path"]).read_text())
    names = set()
    for source in (SOURCE, GENERAL_SOURCE):
        text = (ROOT / source).read_text()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                text))
    seen = sorted({name for ev in trace.get("traceEvents", [])
                   if ev.get("cat") == "kernel"
                   for name in names if name in ev.get("name", "")})
    assert seen, f"the capture's trace names no graph kernel ({len(names)} looked for)"
    assert feeds["dispatches"] > 0
    return {"ms": result["ms"], "activities": result["activities"],
            "graph_kernels": seen, "plane_dispatches": feeds["dispatches"],
            "trace_events": len(trace.get("traceEvents", []))}


def phase_observe(torch, K, T, P, Config, Command, Rifl, KVOp, RunTime, checks=True):
    """Phase 15: the observability plane and the device-fault injector on
    the card (module docstring, item 15); prints the ``{"observe": ...}``
    record."""
    import tempfile

    from fantoch_tpu_torch.core import compile_cache
    from fantoch_tpu_torch.observability import device as obs_device
    from fantoch_tpu_torch.ops import _build  # noqa: F401  (registers every source)

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as tmp:
        # (d) first: a profiler session in a fresh process
        t0 = time.perf_counter()
        out["profile"] = profile_capture(torch, K, Config, Command, Rifl, KVOp, RunTime, tmp)
        log(f"phase 15: capture_device_profile({PROFILE_MS} ms) over "
            f"{out['profile']['plane_dispatches']} graph-plane dispatches: a Chrome "
            f"trace of {out['profile']['trace_events']} events naming "
            f"{out['profile']['graph_kernels']} ({time.perf_counter() - t0:.1f} s)")
        # (a) a traced sim on the card against the same seed on the cpu
        K.reset_launch_counts(), T.reset_launch_counts(), P.reset_launch_counts()
        obs_device.reset_dispatch_counters()
        t0 = time.perf_counter()
        runner, exc = observed_sim(CARD, f"{tmp}/sim-cuda")
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        sim_counters = obs_device.dispatch_counters()
        assert exc is None, exc
        t0 = time.perf_counter()
        _cpu_runner, cpu_exc = observed_sim("cpu", f"{tmp}/sim-cpu")
        cpu_s = time.perf_counter() - t0
        assert cpu_exc is None, cpu_exc
        got, got_report, got_trace = observed_outputs(f"{tmp}/sim-cuda")
        want, want_report, want_trace = observed_outputs(f"{tmp}/sim-cpu")
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        assert {"trace.jsonl", "series.jsonl", "flight/flight_p1.json"} <= set(got)
        # no field is excluded: the sim writes no wall-clock value
        for name in want:
            assert got[name] == want[name], f"{name} differs between cuda and cpu"
        assert got_report == want_report, "critical paths differ"
        assert got_trace == want_trace, "Perfetto JSON differs"
        assert got_report["stitch_rate"] == 1.0 and got_report["telescoping_violations"] == 0
        if checks:
            ran = [name for name, count in launches.items() if count]
            assert ran and launches["graph_prologue"] > 0, launches
        out["sim"] = {"cuda_s": cuda_s, "cpu_s": cpu_s, "launches": launches,
                      "device_counters": sim_counters,
                      "files": {name: len(data) for name, data in got.items()},
                      "spans": got_report["spans"]}
        log(f"phase 15: EPaxos traced through Runner(device='cuda') ({cuda_s:.1f} s; "
            f"cpu {cpu_s:.1f} s): span log, series, flight dumps, critical path "
            f"({got_report['spans']} spans) and Perfetto JSON equal to the cpu run's; "
            f"launches {launches}; device counters {sim_counters}")
        # (b) device faults on the card, one sim each
        out["faults"] = {f"{plane} {kind}": fault_case(torch, K, T, P, plane, kind, tmp)
                         for plane in FAULT_SIMS for kind in ("hang", "corrupt")}
        # (c) the build audit and the device counters after a capacity sweep
        t0 = time.perf_counter()
        obs_device.reset_dispatch_counters()
        capacity_sweep(torch, T, P, Config, Command, Rifl, KVOp, RunTime)
        counts = compile_cache.library_counts()
        csrc = sorted(p.stem for p in (ROOT / "fantoch_tpu_torch" / "csrc").glob("*.cu"))
        for name in csrc:
            assert counts[name]["builds"] <= 1 and counts[name]["loads"] == 1, (name, counts)
        counters = obs_device.device_counters()
        for plane in ("graph", "table", "pred"):
            assert counters[f"{plane}_plane_device_ms"] > 0, counters
        assert 0.0 <= counters["device_idle_frac"] <= 1.0, counters
        out["build_audit"] = {name: counts[name] for name in csrc}
        out["device_counters"] = counters
        log(f"phase 15: capacities {SWEEP_CAPACITIES} swept ({time.perf_counter() - t0:.1f} "
            f"s): libraries {out['build_audit']}; device counters {counters}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['wall_s']:.1f} s in its process")
    log(json.dumps({"observe": out}))
    return out


# the kernels redesigned since the first slices, named in phase 0
REDESIGNED = ("k_radix_", "k_stable_select", "k_affine_", "k_peel_stage", "k_mc_",
              "k_prologue_", "k_vr_", "k_one_cta", "k_grid", "k_link_scan", "k_pc_",
              "k_dbl", "k_prop", "k_group_scan", "k_emit_", "k_residual_")


def ptxas_kernels(text):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill load
    bytes)} from ``-Xptxas -v`` output."""
    found, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (_Z(\d+)\w+)", line)
        if m:
            length = int(m.group(2))
            current = m.group(1)[2 + len(m.group(2)):][:length]
            found[current] = [None, None, None, None]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current:
            found[current][1:] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            found[current][0] = int(m.group(1))
            current = None
    return {k: tuple(v) for k, v in found.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "fantoch_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    from fantoch_tpu_torch.core import Command, Config, KVOp, Metrics, Rifl, RunTime
    from fantoch_tpu_torch.executor.graph import graph_plane as gp_module
    from fantoch_tpu_torch.executor.graph.executor import GraphAddBatch, GraphExecutor
    from fantoch_tpu_torch.ops import _build
    from fantoch_tpu_torch.ops import graph_plane_kernels as K
    from fantoch_tpu_torch.ops import pred_kernels as P
    from fantoch_tpu_torch.ops import table_kernels as T
    from fantoch_tpu_torch.ops import table_ops
    from fantoch_tpu_torch.ops.frontier import DeviceFrontier

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in (ROOT / "fantoch_tpu_torch" / "csrc").glob("*.cu"))
    chain_only = "--general-chain" in sys.argv[1:]
    redesign_only = "--redesign" in sys.argv[1:]
    scans_only = "--scans" in sys.argv[1:]
    doubling_only = "--doubling" in sys.argv[1:]
    epilogue_only = "--epilogue" in sys.argv[1:]
    residual_only = "--residual" in sys.argv[1:]
    host_only = "--host-route" in sys.argv[1:]
    observe_only = "--observe" in sys.argv[1:]
    if chain_only:  # the general chain alone (also on an older checkout)
        sources = ["graph_general", "graph_plane_step"]
    if redesign_only:  # phase 9 alone (also on an older checkout)
        sources = ["graph_plane_step", "pred_plane", "table_plane"]
    if scans_only or doubling_only:  # phase 10 or 11 alone (also on an older checkout)
        sources = ["graph_general", "graph_plane_step", "table_plane"]
    if epilogue_only or residual_only or host_only:  # phase 12, 13 or 14 alone
        sources = ["graph_general", "graph_plane_step"]
    if observe_only:  # phase 15 alone: every source (its fault sims run all planes)
        sources = ["graph_general", "graph_plane_step", "pred_plane", "table_plane"]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.load, sources))
    log(f"phase 0: built {sources} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", text))
        if regs:
            log(f"phase 0: ptxas {name}: {len(regs)} kernels, at most {max(regs)} "
                f"registers a thread, {spills} bytes of spills")
        for kernel, (reg, frame, spill_st, spill_ld) in ptxas_kernels(text).items():
            if kernel.startswith(REDESIGNED):
                log(f"phase 0: ptxas {name}: {kernel}: {reg} registers, {frame} bytes "
                    f"stack frame, {spill_st} bytes spill stores, {spill_ld} bytes "
                    f"spill loads")
                assert frame == 0 or not kernel.startswith("k_stable_select"), kernel

    walls = {"phase 0": time.perf_counter() - t0}
    if chain_only:
        phase_chain(torch, K, gp_module, one_launch="--checks" in sys.argv[1:])
        log(card)
        return 0
    if redesign_only:
        phase_redesign(torch, T, P, K, checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if scans_only:
        phase_scans(torch, K, T, gp_module, Config, Command, Rifl, KVOp, RunTime,
                    GraphExecutor, GraphAddBatch, checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if doubling_only:
        phase_doubling(torch, K, T, gp_module, table_ops, Config, Command, Rifl, KVOp,
                       Metrics, DeviceFrontier, RunTime, GraphExecutor, GraphAddBatch,
                       checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if epilogue_only:
        phase_epilogue(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                       GraphExecutor, GraphAddBatch, checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if residual_only:
        phase_residual(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                       GraphExecutor, GraphAddBatch, checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if host_only:
        phase_host(torch, K, Config, Command, Rifl, KVOp, RunTime, GraphExecutor,
                   GraphAddBatch, checks="--checks" in sys.argv[1:])
        log(card)
        return 0
    if observe_only:
        phase_observe(torch, K, T, P, Config, Command, Rifl, KVOp, RunTime,
                      checks="--checks" in sys.argv[1:])
        log(card)
        return 0

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        log(f"{name}: {walls[name]:.1f} s wall")
        return out

    records = timed("phase 1", phase1, torch, K, gp_module, Config, Metrics,
                    DeviceFrontier, RunTime)
    keyed = timed("phase 2", phase2, torch, K, gp_module, Config, Command, Rifl,
                  KVOp, RunTime, GraphExecutor, GraphAddBatch)
    general_records = timed("phase 3", phase3, torch, K, gp_module, Config, Metrics,
                            DeviceFrontier, RunTime)
    for use in general_records.pop("uses"):
        records["graph_prologue"].setdefault("uses", []).append(use)
    records.update(general_records)
    general = timed("phase 4", phase4, torch, K, gp_module, Config, Command, Rifl,
                    KVOp, RunTime, GraphExecutor, GraphAddBatch)
    chain = timed("phase 4b", phase_apart, "--general-chain", "general_chain")
    # the one-launch wrappers at the sims' shapes, the table's and above it
    records["mutual_collapse"]["at_sims_shapes"] = {
        label: c["mutual_collapse"] for label, c in chain["sims"].items()}
    records["mutual_collapse"]["collapse_shapes"] = chain["collapse"]
    records["graph_prologue"]["general_at_sims_shapes"] = {
        label: c["graph_prologue"] for label, c in chain["sims"].items()}
    records["graph_prologue"]["prologue_shapes"] = chain["prologue"]
    for name in ("mutual_collapse", "graph_prologue"):
        records[name]["launch_floor"] = chain["launch_floor"]
    # launches: each kernel's count on the main path of its slice, the
    # keyed path (phase 2) or the general path (phase 4), both listed; the
    # epilogue's own launches are on the general path's (phase 4: its
    # sims' keyed windows whose links all verify, and the fast path), the
    # keyed path's all folded (phase 12 counts them)
    for name, record in records.items():
        path = general if name in K.GENERAL_KERNELS or name == "plane_epilogue" else keyed
        record["launches"] = path[name]
        record["launches_by_path"] = {"keyed": keyed[name], "general": general[name]}
    records["plane_epilogue"]["folded_by_path"] = {
        "keyed": keyed["epilogue_folds"], "general": general["epilogue_folds"]}
    table_records = timed("phase 5", phase5, torch, T, table_ops)
    records["lex_sort"]["uses"] += table_records.pop("uses")
    table_paths = timed("phase 6", phase6, torch, T, K, table_ops)
    for name, record in table_records.items():
        record["launches"] = table_paths[TABLE_MAIN_PATH[name]][name]
        record["launches_path"] = TABLE_MAIN_PATH[name]
        record["launches_by_path"] = {path: table_paths[path][name] for path in TABLE_PATHS}
    records.update(table_records)
    pred_records = timed("phase 7", phase7, torch, P)
    pred_paths = timed("phase 8", phase8, torch, P)
    for name, record in pred_records.items():
        record["launches"] = pred_paths[PRED_MAIN_PATH][name]
        record["launches_path"] = PRED_MAIN_PATH
        record["launches_by_path"] = {path: pred_paths[path][name] for path in PRED_PATHS}
        record["variant_launches_by_path"] = {
            path: pred_paths[path]["variants"] for path in PRED_PATHS
        }
    records.update(pred_records)
    redesign = timed("phase 9", phase_apart, "--redesign", "redesign")
    records["vote_runs"]["at_paths_shapes"] = redesign["vote_runs"]
    records["vote_runs"]["forms"] = redesign["vote_forms"]
    records["vote_runs"]["newt_sim_calls_by_rows"] = redesign["newt_sim_calls_by_rows"]
    records["pred_plane_step"]["at_paths_shapes"] = redesign["pred_plane_step"]
    scans = timed("phase 10", phase_apart, "--scans", "scans")
    for name in ("link_scan", "peel_compact"):
        records[name]["at_paths_shapes"] = scans[name]
        records[name]["replays"] = scans["replays"][name]
    records["link_scan"]["forms"] = scans["link_forms"]
    records["link_scan"]["sims_calls_by_rows"] = scans["sims_link_scan_calls_by_rows"]
    records["peel_compact"]["phase4_calls"] = scans["phase4_peel_compact_calls"]
    for label, record in scans["others"].items():
        name = label.split(",")[0]
        records[name].setdefault("other_shapes", {})[label] = record
    records["stable_rows"]["newt_sim_calls_by_shape"] = scans["newt_sim_stable_rows_by_shape"]
    doubling = timed("phase 11", phase_apart, "--doubling", "doubling")
    for name, forms in (("pointer_doubling", "forms"), ("clock_proposal", "proposal_forms")):
        records[name]["at_paths_shapes"] = doubling[name]
        records[name]["replays"] = doubling["replays"][name]
        records[name]["forms"] = doubling[forms]
    records["pointer_doubling"]["phase2_dispatches"] = doubling["readings"]["phase2"]
    records["clock_proposal"]["newt_readings"] = {
        k: v for k, v in doubling["readings"].items() if k != "phase2"}
    for label, record in doubling["others"].items():
        name = label.split(",")[0]
        records[name].setdefault("device_at_paths_shapes", {})[label] = record
    epilogue = timed("phase 12", phase_apart, "--epilogue", "epilogue")
    records["plane_epilogue"]["phase12"] = {
        k: epilogue[k] for k in ("runs", "epilogue_launches", "max_abs_err",
                                 "fold_max_abs_err", "replays")}
    records["plane_epilogue"]["folded_launches"] = epilogue["folded_launches"]
    records["plane_epilogue"]["dispatches_on_card"] = epilogue["dispatches"]
    records["group_scan"]["at_paths_shapes"] = epilogue["group_scan"]
    records["group_scan"]["replays"] = epilogue["replays"]["group_scan"]
    for name in ("plane_epilogue", "group_scan"):
        err = epilogue["group_scan_max_abs_err" if name == "group_scan" else "max_abs_err"]
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    residual = timed("phase 13", phase_apart, "--residual", "residual")
    for name in ("residual_view", "emit_scatter"):
        records[name]["at_paths_shapes"] = residual[name]
        records[name]["replays"] = residual["replays"][name]
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           residual["max_abs_err"])
    records["emit_scatter"]["unresolved_vertices"] = residual["unresolved_vertices"]
    records["emit_scatter"]["residual_dispatches_on_card"] = residual["dispatches"]
    host = timed("phase 14", phase_apart, "--host-route", "host_route")
    # the host-column route's path: its own counts, and every call of the
    # card-against-CPU feeds held against the plain versions
    for name, record in records.items():
        record["launches_by_path"]["host_route"] = host["launches"].get(name, 0)
    for name in K.LAUNCHES:
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           host["max_abs_err"])
        records[name]["host_route_checked_calls"] = host["checked_calls"].get(name, 0)
    observe = timed("phase 15", phase_apart, "--observe", "observe")
    # the traced sim's path: the graph wrappers' counts, read just after it
    for name, record in records.items():
        record["launches_by_path"]["observed_sim"] = observe["sim"]["launches"].get(name, 0)
    log(json.dumps({"phase_wall_s": walls}))
    log(json.dumps({"kernels": list(records.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
