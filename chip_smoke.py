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
   through the kernels (prologue launches == plane dispatches) and the
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
   once a resolve and the peel stage once a stage; both affine forms are
   timed at the sims' own shapes;
4b. the general chain at the sims' shapes: the sims' first dispatch at
   1,024 x 4 and at 1,024 x 8 that is not the fast path (captured from
   ``Runner(device="cpu")``), each launch of it (the prologue's general
   fold, ``mutual_collapse``, ``affine_loop``, the 4-key ``lex_sort``,
   ``plane_epilogue``) and the whole dispatch held against the plain
   versions, timed single and in the loop beside the byte bound, and
   counted in operations on the card by ``torch.profiler``: one a call
   for ``mutual_collapse`` and the general prologue, one a wrapper and the read of
   the fast-path count for the dispatch; ``mutual_collapse`` also at 4,096
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
   own defaults (feeds of 4,096 on 512 keys: the one-CTA variant), at the
   table path's round (feeds of 100,000 on 4,096 keys: the grid-wide
   variant) and in a full window of 2^20 slots filled by 4 feeds of 2^18;
   each shape's last dispatch timed beside the plain version and its byte
   bound, with its sweeps;
8. the Caesar path on the card: 2 warm and 3 timed steady feeds of
   100,000 commands through ``DevicePredPlane(device="cuda").add_arrays``,
   each key in the host ``PredecessorsGraph`` twin's order (commands/s and
   the plane's ``kernel_ms``); then Caesar through
   ``Runner(device="cuda")`` with ``device_pred_plane=True`` equal to
   ``Runner(device="cpu")`` at n = 5, f = 2, each path with the launch
   counts set to 0 just before it and read just after it.

Each phase reports its wall time.  The last lines are the
``{"kernels": [...]}`` record, the card line and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --general-chain

builds the two graph sources and runs phase 4b alone, then prints the
card line; copied into an older checkout it times that checkout's kernels
at the same shapes.
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
    read = sum(t.numel() * t.element_size() for t in tensors_of(args))
    written = sum(t.numel() * t.element_size() for t in tensors_of(out))
    if name == "graph_prologue":
        deps, u_row, p_row, e_row = args[0], args[6], args[11], args[14]
        row_bytes = deps.shape[1] * 4 + 3 * 4 + 2
        written += u_row.numel() * row_bytes + p_row.numel() * 4 + e_row.numel()
    if name == "plane_epilogue":
        written += args[1].numel()  # executed |= newly
    return read + written


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
        tgt, add, missing, leader, member_count, max_iters = args
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
        return total + 2 * cells * 4 + batch + batch * 4 + (1 + 4 + 1) * batch
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
    check_chain_order(executed, key_of, n)
    assert launches["graph_prologue"] == plane.dispatches > 0, (launches, plane.dispatches)
    not_run = [k for k, v in launches.items() if v == 0 and k not in K.GENERAL_KERNELS]
    assert not not_run, f"kernels of the path never launched: {not_run}"
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
    }}))
    return launches


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
    on_path = list(K.GENERAL_KERNELS) + ["graph_prologue", "lex_sort", "plane_epilogue"]
    not_run = [k for k in on_path if launches[k] == 0]
    assert not not_run, f"kernels of the general path never launched: {not_run}"
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
    log(json.dumps({"general_sims": sims, "launches": launches, "loops": loops}))
    # both forms of the affine loop at the sims' own shapes
    log(json.dumps({"phase4_sim_affine_forms": compare_affine_forms(K, sim_affine)}))
    return launches


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
    time on the card (ms) of its operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for fn, args, kwargs in calls:
        fn(*clone_args(args), **kwargs)
        runs.append(clone_args(args))
    torch.cuda.synchronize()
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
        if sum(SEPARATOR in e.name for e in events) == len(calls) + 1:
            break
    else:
        raise AssertionError(f"torch.profiler lost events in {PROFILE_TRIES} sessions")
    out, current = [], None
    for e in events:
        if SEPARATOR in e.name:
            if current is not None:
                out.append(current)
            current = ([], 0.0)
        elif current is not None:
            names, us = current
            current = (names + [e.name], us + e.time_range.end - e.time_range.start)
    return [(names, us / 1e3) for names, us in out]


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


def count_ops(torch, records):
    """Replace each record's ``call`` by its operations on the card
    (``device_ops``, one profiler session for all): ``device_ops``, the
    count, ``op_names``, and ``device_ms``, their summed time on the card
    in the profiler's trace.  A control call of one PyTorch kernel first:
    the profiler must see exactly it."""
    control = (lambda: torch.zeros(8, device=CARD), (), {})
    ops = device_ops(torch, [control] + [r.pop("call") for r in records])
    assert len(ops[0][0]) == 1, f"torch.profiler saw {ops[0][0]} for one kernel"
    for record, (names, ms) in zip(records, ops[1:]):
        record["device_ops"] = len(names)
        record["op_names"] = sorted(set(names))
        record["device_ms"] = ms


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
    ``mutual_collapse``, ``affine_loop``, ``lex_sort`` with 4 keys,
    ``plane_epilogue``) at the sims' shapes (1,024 x 4 and 1,024 x 8, each
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
        chain["affine_loop"], (resolved, rank, _stuck, rounds), _ = stage_record(
            torch, K, "affine_loop", (tgt, add, missing, leader, member_count, max_iters))
        chain["affine_loop"]["rounds"] = int(rounds.item())
        chain["lex_sort"], _order, _ = stage_record(
            torch, K, "lex_sort", ([rank, leader, src, seq],))
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
            names = chain["dispatch"]["op_names"]
            kernels = [n for n in names if not n.startswith("Memcpy")]
            assert len(kernels) == len(chain) - 1, (label, names)  # a kernel a wrapper
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


def phase5(torch, T, table_ops):
    """The table kernels against their plain versions on the card."""
    from fantoch_tpu_torch.core import Config

    dev = torch.device(CARD)
    rng = np.random.default_rng(SEED)
    _fast, _write, threshold = Config(TABLE_N, 1).newt_quorum_sizes()

    def cuda(tensors):
        return [t.to(dev) for t in tensors]

    commit = cuda(table_round_votes())
    commit_gaps = cuda(table_round_votes(gap_rate=0.05))
    zeros3 = torch.zeros((TABLE_KCAP, TABLE_N), dtype=torch.int32, device=dev)
    big_k, big_n, big_v = TABLE_BIG, 5, TABLE_BIG
    big_start = rng.integers(1, 64, big_v)
    big = cuda([
        torch.tensor(rng.integers(0, 16, (big_k, big_n)).astype(np.int32)),
        torch.tensor(rng.integers(0, big_k, big_v).astype(np.int32)),
        torch.tensor(rng.integers(0, big_n, big_v).astype(np.int32)),
        torch.tensor(big_start.astype(np.int32)),
        torch.tensor((big_start + rng.integers(0, 8, big_v)).astype(np.int32)),
        torch.tensor(rng.random(big_v) < 0.9),
    ])
    hot = np.where(rng.random(FUSED_BATCH) < CONFLICT, 0,
                   rng.integers(1, TABLE_KEYS, FUSED_BATCH)).astype(np.int32)
    prop = cuda([
        torch.tensor(rng.integers(0, 50, TABLE_KCAP).astype(np.int32)),
        torch.tensor(hot),
        torch.tensor(np.where(rng.random(FUSED_BATCH) < 0.1, 60, 0).astype(np.int32)),
    ])
    bump_m = 4096
    bump = cuda([
        torch.tensor(rng.integers(0, 100, TABLE_KCAP).astype(np.int32)),
        torch.tensor(rng.integers(0, TABLE_KCAP - 1, bump_m).astype(np.int32)),
        torch.tensor(rng.integers(0, 200, bump_m).astype(np.int32)),
    ])
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
# bench_pred_path's own defaults (the one-CTA variant), the table path's
# round on its key count (the steady shape, grid-wide), and the full
# window of 2^20 slots filled by 4 feeds of 2^18
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
    dispatch, clones of the step's arguments and its sweep count."""
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
            record.append((saved, P.last_sweeps()))
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
            sweeps = P.last_sweeps()
            plain_ms = time_ms(plain, args, {})
            nbytes = pred_moved_bytes(torch, args, got)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cap, width = args[0].shape
            row = {
                "use": f"pred_plane_step, {use}, C={cap} W={width} B={batch} keys={keys}",
                "variant": "one CTA" if variants["one_cta"] else "grid-wide",
                "variants": variants, "shape": describe(args), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
                "library_ms": None, "sweeps": sweeps,
                "sweeps_by_dispatch": [s for _a, s in calls],
                "newly": int(got[5].sum()), "dispatches": plane.dispatches,
                "grows": plane.grows, "compactions": plane.stats["compactions"],
                "feed_wall_ms": wall,
            }
            assert (row["variant"] == "one CTA") == (use == "small window"), row
            log(json.dumps({"phase7_kernel": row}))
            uses.append(row)
            if use == PRED_MAIN_USE:
                records["pred_plane_step"] = {
                    "name": "pred_plane_step", "route": "cuda", "source": PRED_SOURCE,
                    "replaces": PRED_REPLACES, "launches": 0, "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": None, "shape": row["shape"],
                    "sweeps": sweeps,
                }
    finally:
        checker.uninstall()
    records["pred_plane_step"]["max_abs_err"] = checker.err["pred_plane_step"]
    records["pred_plane_step"]["uses"] = uses
    log(f"phase 7: every pred_plane_step call equal to its plain version "
        f"(checked calls {checker.count}); sweeps of the timed dispatches "
        f"{[u['sweeps'] for u in uses]}")
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


# the kernels redesigned since the first slices, named in phase 0
REDESIGNED = ("k_radix_", "k_stable_select", "k_affine_", "k_peel_stage", "k_mc_",
              "k_prologue_")


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
    if chain_only:  # the general chain alone (also on an older checkout)
        sources = ["graph_general", "graph_plane_step"]
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
        phase_chain(torch, K, gp_module, one_launch=False)
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
    chain = timed("phase 4b", phase_chain, torch, K, gp_module, True)
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
    # keyed path (phase 2) or the general path (phase 4), both listed
    for name, record in records.items():
        path = general if name in K.GENERAL_KERNELS else keyed
        record["launches"] = path[name]
        record["launches_by_path"] = {"keyed": keyed[name], "general": general[name]}
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
