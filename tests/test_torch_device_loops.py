"""The general resolvers' round loops on the device: ``affine_loop`` and
``peel_stage`` against the JAX reference and against their plain versions.

(a) On the CPU, the port's ``resolve_general`` and
``resolve_general_resident`` — built on the plain ``affine_loop`` /
``peel_stage``, loops over ``affine_round_plain`` / ``peel_round_plain``
with the reference's stop rules — against ``fantoch_tpu.ops.graph_resolve``
on numpy-seeded inputs: a permuted DAG, a cycle-rich feed, MISSING-blocked
chains, a resolve that hits ``max_iters``, stages stopped by
``live <= half``, a fixpoint that closes the publish gate, and batches that
are not powers of two.  Every ``GeneralResolution`` field must be exactly
equal.

(b) The CUDA sources of both loops (``csrc/graph_general.cu`` §10-11) run
on the CPU through the emulator (``csrc/emu/emulate.py``), behind the
wrappers' own device test, against the plain versions: ``affine_loop`` as
one CTA and, with ``CTA_ROWS`` lowered, as a cooperative launch;
``peel_stage`` (always cooperative) to its fixpoint, stopped by half, with
no round at all, and over more rows than threads.  ``LOOP_BLOCK`` is
lowered to 64 and the emulated card holds 4 blocks, so the cooperative
launches cross a real four-block grid barrier with at most 256 threads.
Outputs and round counts must be equal, one launch a call, and the device
round totals must add up.  The emulator cannot show what nvcc refuses or
memory-ordering faults across SMs; the card run does.

One collected item on purpose (ROADMAP.md Queue C).  Reference calls run
under ``jax_ref``: jax's duration listeners wrapped to drop keywords they
do not take, and the persistent compile cache off for the test's span.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

from fantoch_tpu.ops import graph_resolve as ref
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import graph_resolve as port

torch.set_num_threads(1)

TERMINAL, MISSING = port.TERMINAL, port.MISSING
WIDTH = 4


def _tolerant(listener):
    """``listener`` called with only the keyword arguments it accepts."""
    try:
        params = inspect.signature(listener).parameters
    except (TypeError, ValueError):
        return listener
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return listener
    names = set(params)

    def call(event, duration, **kwargs):
        return listener(
            event, duration, **{k: v for k, v in kwargs.items() if k in names}
        )

    return call


@pytest.fixture
def jax_ref(monkeypatch):
    """Tolerant duration listeners and no persistent compile cache for the
    test's span; both restored after."""
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        jax_cache.reset_cache()


# ---------------------------------------------------------------------------
# dependency matrices (int32[n, WIDTH], TERMINAL/MISSING sentinels)
# ---------------------------------------------------------------------------


def permuted_dag(rng, n, n_keys):
    """``bench.py``'s general generator (each command on 4 keys, a
    dependency on the latest command of each) with its rows relabelled by a
    random permutation, so dependencies point forward and backward."""
    keys = rng.integers(0, n_keys, size=(n, WIDTH))
    deps = np.full((n, WIDTH), TERMINAL, np.int64)
    last = {}
    for i, row in enumerate(keys.tolist()):
        slot = 0
        for k in row:
            prev = last.get(k)
            if prev is not None and prev != i and slot < WIDTH:
                deps[i, slot] = prev
                slot += 1
            last[k] = i
    perm = rng.permutation(n)
    out = np.full((n, WIDTH), TERMINAL, np.int64)
    out[perm] = np.where(deps >= 0, perm[np.maximum(deps, 0)], deps)
    return out.astype(np.int32)


def cycle_rich(rng, n, chunk=64, n_keys=24):
    """Two keys a command; consecutive commands on a key within a chunk are
    linked in a random direction or both: 2-cycles, mutual cliques and
    directed cycles with no mutual edge (stuck for the host oracle)."""
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
                if c in (0, 2) and len(deps[i]) < WIDTH:
                    deps[i].append(prev)
                if c in (1, 2) and len(deps[prev]) < WIDTH:
                    deps[prev].append(i)
            last[k] = i
    mat = np.full((n, WIDTH), TERMINAL, np.int32)
    for i, row in enumerate(deps):
        mat[i, : len(row)] = row
    return mat


def missing_chains(rng, n, length=25):
    """Chains of ``length`` in shuffled rows; every other chain's head waits
    on a MISSING dot, and some rows of later chains also depend on a row of
    an earlier chain (blocked or not), so the block spreads."""
    order = rng.permutation(n)
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    for c, start in enumerate(range(0, n, length)):
        rows = order[start : start + length]
        if c % 2:
            deps[rows[0], 0] = MISSING
        for a, b in zip(rows[:-1], rows[1:]):
            deps[b, 0] = a
        if start:
            for row in rows[rng.integers(0, len(rows), 3)]:
                deps[row, 1] = order[int(rng.integers(0, start))]
    return deps


def long_chain(n):
    """One chain through all rows in reverse index order."""
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    deps[: n - 1, 0] = np.arange(1, n)
    return deps


def dead_gate(n_cycles=24, n_chain=16):
    """Directed 3-cycles with no mutual edge (never peel: more than half of
    the window stays live at the first fixpoint, which closes the publish
    gate) beside a short chain that does peel."""
    n = 3 * n_cycles + n_chain
    deps = np.full((n, WIDTH), TERMINAL, np.int32)
    for c in range(n_cycles):
        for i in range(3):
            deps[3 * c + i, 0] = 3 * c + (i + 1) % 3
    for i in range(1, n_chain):
        deps[3 * n_cycles + i, 0] = 3 * n_cycles + i - 1
    return deps


def widened(rng, deps, width):
    """``deps`` cut or padded to ``width`` columns (padding: random extra
    dependencies on a third of the cells, TERMINAL elsewhere), so the
    kernels' cells-in-fours loops see a row that is not a multiple of four."""
    n = deps.shape[0]
    if width <= deps.shape[1]:
        return np.ascontiguousarray(deps[:, :width])
    extra = rng.integers(0, n, (n, width - deps.shape[1]))
    extra = np.where(rng.random(extra.shape) < 1 / 3, extra, TERMINAL)
    return np.concatenate([deps, extra], axis=1).astype(np.int32)


def dots(n, seed):
    rng = np.random.default_rng(seed)
    return (1 + rng.integers(0, 5, n)).astype(np.int32), rng.permutation(n).astype(
        np.int32
    )


# ---------------------------------------------------------------------------
# (a) the resolvers on the plain loops against the reference
# ---------------------------------------------------------------------------


def _equal(case, got, want):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{case}: field {name} differs"


def _resolver_cases(rng):
    # (name, deps, max_iters for resolve_general (0: auto), min_sizes)
    yield "permuted DAG", permuted_dag(rng, 512, 48), 0, (4096, 64)
    yield "cycle-rich", cycle_rich(rng, 384), 0, (4096, 32)
    yield "MISSING-blocked chains", missing_chains(rng, 300), 0, (4096, 16)
    yield "max_iters hit", long_chain(200), 3, (4096,)
    yield "publish gate closed", dead_gate(), 0, (4,)
    yield "not a power of two", permuted_dag(rng, 97, 12), 0, (4096, 8)


def _check_resolvers(seen):
    rng = np.random.default_rng(101)
    for case, deps, max_iters, min_sizes in _resolver_cases(rng):
        n = deps.shape[0]
        src, seq = dots(n, n)
        t = [torch.tensor(a) for a in (deps, src, seq)]
        j = [jnp.asarray(a) for a in (deps, src, seq)]
        n_bad = int(((deps > np.arange(n)[:, None]) | (deps == MISSING)).sum())
        assert n_bad, case  # every case takes the iterative path
        loops = len(seen["affine_rounds"])
        got = port.resolve_general(*t, n_bad=n_bad, max_iters=max_iters)
        _equal(f"{case}: resolve_general", got,
               ref.resolve_general(*j, max_iters=max_iters))
        assert len(seen["affine_rounds"]) == loops + 1, case
        if max_iters:
            assert seen["affine_rounds"][-1] == max_iters, (case, seen["affine_rounds"])
        for min_size in min_sizes:
            got = port.resolve_general_resident(*t, min_size=min_size)
            _equal(f"{case}: resolve_general_resident min_size={min_size}", got,
                   ref.resolve_general_resident(*j, min_size=min_size))


def _spy(monkeypatch, seen):
    """Record each loop's rounds, the stages stopped by ``live <= half``
    while a round would still change something, and closed publish gates."""
    real_loop, real_stage, real_compact = K.affine_loop, K.peel_stage, K.peel_compact

    def affine_loop(*args, **kwargs):
        out = real_loop(*args, **kwargs)
        seen["affine_rounds"].append(int(out[3].item()))
        return out

    def peel_stage(tgt, floor, miss, final, rank, live, *, run_to_fixpoint):
        out = real_stage(tgt, floor, miss, final, rank, live,
                         run_to_fixpoint=run_to_fixpoint)
        seen["stage_rounds"].append(int(out[5].item()))
        if not run_to_fixpoint:
            stats = K.peel_round_plain(*out[:5])[5].tolist()
            left = int((~out[3] & ~out[2]).sum())
            if stats[0] and left <= max(tgt.shape[0] // 2, 1):
                seen["stopped_by_half"] += 1
        return out

    def peel_compact(*args, mode, half=0):
        out = real_compact(*args, mode=mode, half=half)
        if mode == "compact" and int(args[9][0]):
            seen["gate_closed"] += 1
        return out

    monkeypatch.setattr(K, "affine_loop", affine_loop)
    monkeypatch.setattr(K, "peel_stage", peel_stage)
    monkeypatch.setattr(K, "peel_compact", peel_compact)


# ---------------------------------------------------------------------------
# (b) the kernels under the emulator against their plain versions
# ---------------------------------------------------------------------------


def _same(case, got, want):
    assert len(got) == len(want), case
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (case, i, g.dtype, w.dtype)
        assert torch.equal(g, w), f"{case}: output {i} differs from the plain version"


def _affine_inputs(deps):
    leader, tgt, add, missing, member_count = K.mutual_collapse_plain(torch.tensor(deps))
    return tgt, add, missing, leader, member_count


def _peel_inputs(deps):
    """The stage-0 state of ``deps`` as ``resolve_general_resident`` builds
    it (padded to a power of two) and its live count."""
    state, _outs, live = K.peel_compact_plain(torch.tensor(deps), mode="init")
    return state[:5], int(live.item())


def _raw_peel_inputs(deps):
    """An unpadded stage of ``len(deps)`` rows (no power of two)."""
    tgt = torch.tensor(np.where(deps == np.arange(len(deps))[:, None], TERMINAL, deps))
    miss = (tgt == MISSING).any(dim=1)
    final = torch.zeros(len(deps), dtype=torch.bool)
    zeros = torch.zeros(len(deps), dtype=torch.int32)
    return (tgt, zeros, miss, final, zeros.clone()), int((~miss).sum())


def _check_kernels(monkeypatch):
    rng = np.random.default_rng(202)
    affine = [
        # (case, deps, max_iters, cta_rows): one CTA of at most 256 threads,
        # or cooperative (4 blocks of 64 threads, rows walked grid-stride)
        ("one CTA, permuted DAG", permuted_dag(rng, 256, 24), 40, K.CTA_ROWS),
        ("one CTA, cycle-rich", cycle_rich(rng, 200), 40, K.CTA_ROWS),
        ("one CTA, max_iters hit", long_chain(150), 2, K.CTA_ROWS),
        ("cooperative, MISSING chains", missing_chains(rng, 300), 40, 0),
        ("cooperative, cycle-rich", cycle_rich(rng, 520), 44, 0),
        ("cooperative, max_iters hit", long_chain(300), 3, 0),
        ("one CTA, W = 6", widened(rng, permuted_dag(rng, 200, 20), 6), 40,
         K.CTA_ROWS),
        ("cooperative, W = 3", widened(rng, missing_chains(rng, 260), 3), 40, 0),
    ]
    dag = _peel_inputs(permuted_dag(rng, 400, 40))
    # a stage that starts with at most half its rows live, as after a
    # compaction: the state a stage stopped by half leaves
    halved = K.peel_stage_plain(*dag[0], dag[1], run_to_fixpoint=False)
    halved_live = int((~halved[3] & ~halved[2]).sum())
    peel = [
        # (case, (state, live), run_to_fixpoint)
        ("fixpoint, 512 rows", dag, True),
        ("stopped by half, 512 rows", dag, False),
        ("fixpoint, cycles and MISSING", _peel_inputs(
            np.concatenate([cycle_rich(rng, 128), missing_chains(rng, 120)])), True),
        ("no round (live <= half)", (halved[:5], halved_live), False),
        ("fixpoint, 300 rows, no power of two", _raw_peel_inputs(
            missing_chains(rng, 300)), True),
        ("fixpoint, W = 6", _peel_inputs(widened(rng, permuted_dag(rng, 200, 20), 6)),
         True),
        ("stopped by half, W = 2",
         _peel_inputs(widened(rng, permuted_dag(rng, 300, 30), 2)), False),
    ]
    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    K.reset_launch_counts()
    rounds = {"affine_loop": 0, "peel_stage": 0}
    stopped_by_half = 0
    with emulated():
        for case, deps, max_iters, cta_rows in affine:
            monkeypatch.setattr(K, "CTA_ROWS", cta_rows)
            args = _affine_inputs(deps)
            saved = [a.clone() for a in args]
            want = K.affine_loop_plain(*args, max_iters)
            before = K.LAUNCHES["affine_loop"]
            got = K.affine_loop(*args, max_iters)
            assert K.LAUNCHES["affine_loop"] == before + 1, case
            _same(f"affine_loop, {case}", got, want)
            _same(f"affine_loop, {case}: inputs", args, saved)
            rounds["affine_loop"] += int(got[3].item())
            if "max_iters" in case:
                assert int(got[3].item()) == max_iters, case
        for case, (state, live), fixpoint in peel:
            saved = [a.clone() for a in state]
            want = K.peel_stage_plain(*state, live, run_to_fixpoint=fixpoint)
            before = K.LAUNCHES["peel_stage"]
            got = K.peel_stage(*state, live, run_to_fixpoint=fixpoint)
            assert K.LAUNCHES["peel_stage"] == before + 1, case
            _same(f"peel_stage, {case}", got, want)
            _same(f"peel_stage, {case}: inputs", state, saved)
            n = int(got[5].item())
            rounds["peel_stage"] += n
            assert (n == 0) == case.startswith("no round"), (case, n)
            if not fixpoint and n:
                stats = K.peel_round_plain(*got[:5])[5].tolist()
                stopped_by_half += stats[0] > 0
        assert K.round_totals() == rounds, (K.round_totals(), rounds)
    assert stopped_by_half, "no emulated stage stopped by live <= half"


def test_device_loops_match_reference_and_plain(jax_ref, monkeypatch):
    seen = {"affine_rounds": [], "stage_rounds": [], "stopped_by_half": 0,
            "gate_closed": 0}
    with monkeypatch.context() as patch:
        _spy(patch, seen)
        _check_resolvers(seen)
    assert seen["stopped_by_half"], "no stage stopped by live <= half"
    assert seen["gate_closed"], "no fixpoint closed the publish gate"
    assert max(seen["stage_rounds"]) > 1 and min(seen["affine_rounds"]) >= 1, seen
    _check_kernels(monkeypatch)
