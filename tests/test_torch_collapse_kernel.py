"""The mutual collapse as one launch a resolve: ``K.mutual_collapse``
(``csrc/graph_general.cu`` §9) against its plain version and the JAX
reference.

The CUDA source runs on the CPU through the emulator
(``csrc/emu/emulate.py``), behind the wrapper's own device test, in both
forms: one CTA (up to ``CTA_ROWS`` rows) and, with the gate
lowered to 0, a cooperative launch (``LOOP_BLOCK`` lowered to 64, so at
most 4 blocks of 64 threads on the emulated card cross a real grid
barrier, rows walked grid-stride).  On numpy-seeded inputs — mutual pairs,
long mutual chains whose leaders do not converge within the step count,
mutual cliques and directed cycles, MISSING cells and self-dependencies,
a DAG whose first step changes nothing, W = 4, 8 and 40 (two mask words),
row counts that are not powers of two — every output equals
``mutual_collapse_plain`` exactly, the inputs are left as they were, and
each call is one launch.  Then ``resolve_general`` on the emulated
kernels (collapse, affine loop, sort) equals the reference's
``resolve_general`` field by field, its SCC leaders included.

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
from test_torch_device_loops import (  # noqa: F401 (jax_ref is a fixture)
    cycle_rich,
    dots,
    jax_ref,
    missing_chains,
    permuted_dag,
    widened,
)

torch.set_num_threads(1)

TERMINAL, MISSING = K.TERMINAL, K.MISSING


def mutual_pairs(rng, n, width=4):
    """Rows paired at random, each pair mutually dependent, plus one-way
    dependencies between pairs (some forward, some backward)."""
    deps = np.full((n, width), TERMINAL, np.int32)
    perm = rng.permutation(n)
    for a, b in zip(perm[0::2], perm[1::2]):
        deps[a, 0], deps[b, 0] = b, a
    deps[:, 1] = np.where(rng.random(n) < 0.4, rng.integers(0, n, n), TERMINAL)
    return deps


def mutual_chains(rng, n, length, width=4):
    """Chains of ``length`` rows in random order, each link a mutual edge:
    min-label propagation with pointer jumping needs more than
    ``num_doubling_steps(n)`` steps to settle such a chain."""
    deps = np.full((n, width), TERMINAL, np.int32)
    perm = rng.permutation(n)
    for s in range(0, n, length):
        chain = perm[s : s + length]
        for a, b in zip(chain[:-1], chain[1:]):
            deps[a, 0], deps[b, 1] = b, a
    return deps


def with_missing_and_self(rng, deps):
    """``deps`` with MISSING cells and self-dependencies in free slots."""
    deps = deps.copy()
    n, width = deps.shape
    free = np.argwhere(deps == TERMINAL)
    pick = free[rng.random(len(free)) < 0.15]
    half = len(pick) // 2
    deps[pick[:half, 0], pick[:half, 1]] = MISSING
    deps[pick[half:, 0], pick[half:, 1]] = pick[half:, 0]
    return deps


def _cases(rng):
    yield "mutual pairs, 150 rows", mutual_pairs(rng, 150)
    yield "long mutual chains, 333 rows", mutual_chains(rng, 333, 111)
    yield "cycle-rich, 256 rows", cycle_rich(rng, 256)
    yield "MISSING and self-deps, 300 rows", with_missing_and_self(
        rng, np.concatenate([missing_chains(rng, 200), mutual_pairs(rng, 100)]))
    yield "W = 8, 201 rows", widened(rng, mutual_chains(rng, 201, 67), 8)
    yield "permuted DAG (no mutual edge), 257 rows", permuted_dag(rng, 257, 24)
    yield "W = 40, 96 rows", widened(rng, with_missing_and_self(rng, cycle_rich(rng, 96)), 40)


def _same(case, got, want):
    assert len(got) == len(want), case
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (case, i, g.dtype, w.dtype)
        assert torch.equal(g, w), f"{case}: output {i} differs from the plain version"


def test_mutual_collapse_kernel_matches_plain_and_reference(jax_ref, monkeypatch):
    rng = np.random.default_rng(303)
    cases = list(_cases(rng))
    # the steps of the reference's min-label loop that change a leader
    steps = {case: (K.mutual_collapse_steps(torch.tensor(d)),
                    K.num_doubling_steps(len(d))) for case, d in cases}
    # the early stop and the full step count are both exercised
    assert any(c == 0 for c, _s in steps.values()), steps
    assert any(c == s for c, s in steps.values()), steps
    monkeypatch.setattr(K, "LOOP_BLOCK", 64)
    with emulated():
        for form, gate in (("one CTA", K.CTA_ROWS), ("cooperative", 0)):
            monkeypatch.setattr(K, "CTA_ROWS", gate)
            for case, deps in cases:
                label = f"{form}, {case}"
                t = torch.tensor(deps)
                want = K.mutual_collapse_plain(t.clone())
                before = K.LAUNCHES["mutual_collapse"]
                got = K.mutual_collapse(t)
                assert K.LAUNCHES["mutual_collapse"] == before + 1, label
                _same(label, got, want)
                assert torch.equal(t, torch.tensor(deps)), f"{label}: input changed"
                # the whole resolution on the emulated kernels against the
                # reference (every case takes the iterative path)
                n = len(deps)
                n_bad = int(((deps > np.arange(n)[:, None]) | (deps == MISSING)).sum())
                assert n_bad, label
                src, seq = dots(n, n)
                mine = port.resolve_general(t, torch.tensor(src), torch.tensor(seq),
                                            n_bad=n_bad)
                theirs = ref.resolve_general(*(jnp.asarray(a) for a in (deps, src, seq)))
                for name, g, w in zip(mine._fields, mine, theirs):
                    w = np.asarray(w)
                    assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), (
                        f"{label}: resolve_general field {name} differs from the reference")
