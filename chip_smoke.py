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
   plane stayed healthy.

The last lines are the ``{"kernels": [...]}`` record, the card line and
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
REPLACES = "fantoch_tpu/ops/pallas_resolve.py:334"


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
        """The call's use: the sort serves five, told apart by its keys."""
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

    ran = {use.split(",")[0] for use in checker.calls}
    missing = [name for name in K.LAUNCHES if name not in ran]
    assert not missing, f"phase 1 never ran {missing}"
    records, sort_uses = {}, []
    for use, (_size, args, kwargs, out) in checker.calls.items():
        name = use.split(",")[0]
        kernel, plain = checker.real[name], getattr(K, f"{name}_plain")
        ms = time_ms(kernel, args, kwargs)
        plain_ms = time_ms(plain, args, kwargs)
        library_ms = None
        if name == "lex_sort" and len(args[0]) == 1 and args[0][0].dtype == torch.int32:
            library_ms = time_ms(
                lambda k: torch.sort(k, stable=True), (args[0][0],), {}
            )
        nbytes = moved_bytes(name, args, out)
        log(json.dumps({
            "phase1_kernel": use, "launches": checker.count[name],
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "library_ms": library_ms,
            "shape": describe(args),
        }))
        if name == "lex_sort":
            sort_uses.append({
                "use": use, "shape": describe(args), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "library_ms": library_ms,
            })
            if use != "lex_sort, 1 key":
                continue  # the record's own numbers are the key grouping's
        records[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": 0,
            "max_abs_err": checker.err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": describe(args),
        }
    records["lex_sort"]["uses"] = sort_uses
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
    not_run = [k for k, v in launches.items() if v == 0]
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

    records = phase1(torch, K, gp_module, Config, Metrics, DeviceFrontier, RunTime)
    launches = phase2(torch, K, gp_module, Config, Command, Rifl, KVOp, RunTime,
                      GraphExecutor, GraphAddBatch)
    for name, count in launches.items():
        records[name]["launches"] = count
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
