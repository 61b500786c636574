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
   shuffled around the feed edges as in phase 1; each kernel is timed
   beside its plain version and its byte bound, with the affine and peel
   round counts;
4. the general path end to end: ``GraphExecutor`` on ``cuda`` takes the
   2^20 multi-key commands as ``GraphAddBatch`` feeds of 250k, shuffled
   around the feed edges (every command once, each key in dependency
   order; commands/s and p50 dispatch by mode), then EPaxos and Atlas
   (n = 5, f = 2, two keys per command, 50% conflict) through
   ``sim.runner.Runner(device="cuda")`` must equal the same seed's
   ``Runner(device="cpu")`` run in per-key orders and latency histograms;
   every general kernel must have launched in this phase.

Each phase reports its wall time.  The last lines are the
``{"kernels": [...]}`` record, the card line and
``{"ok": true, "device": {...}}``.
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
        self.err = {name: 0.0 for name in K.LAUNCHES}
        self.count = {name: 0 for name in K.LAUNCHES}

    def install(self):
        for name in self.real:
            setattr(self.K, name, self._wrap(name))

    def uninstall(self):
        for name, fn in self.real.items():
            setattr(self.K, name, fn)

    @staticmethod
    def variant(name, args, kwargs):
        """The call's use: the sort serves five, told apart by its keys;
        the affine round's final fold and the peel compaction's init and
        publish are uses of their wrappers too."""
        if name == "affine_round" and kwargs.get("final"):
            return "affine_round, final fold"
        if name == "graph_prologue" and kwargs.get("general"):
            return "graph_prologue, general fold"
        if name == "peel_compact" and kwargs["mode"] != "compact":
            return f"peel_compact, {kwargs['mode']}"
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
            # the first call at the largest row count, for each use
            size = tensors_of(args)[0].shape[0]
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


def moved_bytes(name, args, out):
    """Bytes the function must move: each input read once, each output
    written once (in-place state rows counted where they are written)."""
    read = sum(t.numel() * t.element_size() for t in tensors_of(args))
    written = sum(t.numel() * t.element_size() for t in tensors_of(out))
    if name == "graph_prologue":
        deps, u_row, p_row, e_row = args[0], args[6], args[11], args[14]
        row_bytes = deps.shape[1] * 4 + 3 * 4 + 2
        written += u_row.numel() * row_bytes + p_row.numel() * 4 + e_row.numel()
    if name == "plane_epilogue":
        written += args[1].numel()  # executed |= newly
    return read + written


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
        if name == "lex_sort" and len(args[0]) == 1 and args[0][0].dtype == torch.int32:
            library_ms = time_ms(
                lambda k: torch.sort(k, stable=True), (args[0][0],), {}
            )
        nbytes = moved_bytes(name, args, out)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(json.dumps({
            f"{phase}_kernel": use, "launches": checker.count[name],
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "library_ms": library_ms,
            "shape": describe(args),
        }))
        uses.setdefault(name, []).append({
            "use": use, "shape": describe(args), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms,
        })
        if use != main_use.get(name, name):
            continue
        records[name] = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": REPLACES,
            "launches": 0,
            "max_abs_err": checker.err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
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
    return records


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


def phase3(torch, K, gp_module, Config, Metrics, DeviceFrontier, RunTime):
    checker = Checker(K)
    real_step = gp_module.resolve_graph_plane_step
    twin = {"on": True}

    def checked_step(*args, mode):
        cpu_args = [a.to("cpu", copy=True) for a in args] if twin["on"] else None
        got = real_step(*args, mode=mode)
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
            rounds[name] = {
                "dispatches": plane.dispatches,
                # one final fold per resolve (one mutual collapse each)
                "affine_rounds": ran["affine_round"] - ran["mutual_collapse"],
                "peel_rounds": ran["peel_round"],
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
                for wrapper in ("mutual_collapse", "affine_round"):
                    assert ran[wrapper] > 0, (name, wrapper)
            else:
                for wrapper in ("peel_round", "peel_compact"):
                    assert ran[wrapper] > 0, (name, wrapper)
        assert rounds["general, cycle-rich C=4096"]["stuck_oracle_runs"] > 0, rounds
    finally:
        checker.uninstall()
        gp_module.resolve_graph_plane_step = real_step
        gp_module.DeviceGraphPlane._stuck_oracle = real_oracle
    log(json.dumps({"phase3_rounds": rounds}))
    # the prologue's general fold is a use of the prologue (graph_plane_step.cu)
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

    def timed_step(*args, mode):
        t = time.perf_counter()
        out = real_step(*args, mode=mode)
        torch.cuda.synchronize()
        dispatch_ms.setdefault(mode, []).append((time.perf_counter() - t) * 1e3)
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
            mode: {"dispatches": len(ms), "p50_dispatch_ms": float(np.median(ms))}
            for mode, ms in dispatch_ms.items()
        }
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
        }}))
        del executor, cmds
        sims = {}
        for name in ("EPaxos", "Atlas"):
            t0 = time.perf_counter()
            got = sim_run("cuda", name)
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
    log(json.dumps({"general_sims": sims, "launches": launches}))
    return launches


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
    from fantoch_tpu_torch.ops.frontier import DeviceFrontier

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in (ROOT / "fantoch_tpu_torch" / "csrc").glob("*.cu"))
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

    walls = {"phase 0": time.perf_counter() - t0}

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
    # launches: each kernel's count on the main path of its slice, the
    # keyed path (phase 2) or the general path (phase 4), both listed
    for name, record in records.items():
        path = general if name in K.GENERAL_KERNELS else keyed
        record["launches"] = path[name]
        record["launches_by_path"] = {"keyed": keyed[name], "general": general[name]}
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
