"""The redesigned sort kernels' CUDA source against three references.

``lex_sort`` (``csrc/graph_plane_step.cu``: the LSD radix sort, its
one-block path up to ``RADIX_SMALL_N`` rows and its three-launch digit
passes above, which skip the digits a column's keys share) and
``stable_rows`` (``csrc/table_plane.cu``: ``k_stable_select``, both
launchers) run on the CPU through the emulator
(``csrc/emu/emulate.py``: g++, one OS thread per CUDA thread, barriers for
``__syncthreads`` and the warp collectives), behind the wrappers' own
device test.  Every call is held, exactly, against the wrapper's plain
PyTorch version, against numpy (``numpy.lexsort``; ``numpy.sort`` for the
stable clocks) and against the JAX reference: ``jnp.lexsort`` as
``fantoch_tpu/ops/table_ops.py:281`` and ``graph_resolve.py:412`` call it
(the latter through ``_order_from_ranks`` itself) and
``table_ops.stable_clocks``.  The inputs reach every key signature the
port sorts (1 int32 key, 1 bool key, 1 inverted bool key, 2, 4 and 6 keys,
a packed key through a permutation) at n = 1, 2, a size that is no power
of two (one block) and one over several tiles, with keys at INT_MIN, -1,
0 and INT_MAX, all-equal keys, sorted and reverse-sorted columns and
columns whose keys share all digits but one; and
the stable clocks at n = 1..MAX_VOTERS with every threshold, ties,
negative and INT_MAX cells, in both modes.  The emulator cannot show what
nvcc refuses or races between blocks; the card run does.

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

from fantoch_tpu.ops import table_ops as ref_table
from fantoch_tpu.ops.graph_resolve import _order_from_ranks
from fantoch_tpu_torch.csrc.emu.emulate import emulated
from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops import table_kernels as T

torch.set_num_threads(1)

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
EDGES = np.array([INT32_MIN, -1, 0, INT32_MAX], dtype=np.int32)
# n = 1, 2, no power of two in one block, several tiles of the digit passes
SIZES = (1, 2, 3001, K.RADIX_SMALL_N + 2 * K.RADIX_TILE + 7)


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


def same(got, want, what):
    """Exact equality of a port tensor and a reference array, dtype too."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert np.array_equal(got, want), f"{what}: {got[:20].tolist()} != {want[:20].tolist()}"


# ---------------------------------------------------------------------------
# lex_sort
# ---------------------------------------------------------------------------


def int_column(rng, n, style):
    if style == "edges":
        return rng.choice(EDGES, n)
    if style == "equal":
        return np.full(n, -7, dtype=np.int32)
    if style == "sorted":
        return (np.arange(n) - n // 2).astype(np.int32)
    if style == "reverse":
        return (n // 2 - np.arange(n)).astype(np.int32)
    if style == "narrow":
        return rng.integers(-3, 4, n).astype(np.int32)
    if style == "digit 1":  # only the second of four digit passes moves
        return (rng.integers(0, 256, n) << 8).astype(np.int32)
    if style == "digit 2":  # passes 0, 1 and 3 skipped
        return (rng.integers(0, 50, n) << 16).astype(np.int32)
    return rng.integers(INT32_MIN, INT32_MAX, n, endpoint=True).astype(np.int32)


def signatures(rng, n):
    """(name, columns most significant first, invert, through): every key
    signature the port sorts."""
    col = lambda style: int_column(rng, n, style)  # noqa: E731
    flag = lambda p: rng.random(n) < p  # noqa: E731
    return (
        ("1 int32 key", [col("full")], (), None),
        ("1 int32 key at the edges", [col("edges")], (), None),
        ("1 int32 key, all equal", [col("equal")], (), None),
        ("1 int32 key, sorted", [col("sorted")], (), None),
        ("1 int32 key, reverse-sorted", [col("reverse")], (), None),
        ("1 int32 key, one moving digit", [col("digit 1")], (), None),
        ("1 bool key", [flag(0.4)], (), None),
        ("1 bool key, all equal", [np.ones(n, dtype=bool)], (), None),
        ("1 inverted bool key", [flag(0.4)], (True,), None),
        ("2 keys (gid, vstart)", [rng.integers(0, 9, n).astype(np.int32),
                                  col("edges")], (), None),
        ("2 keys, constant digits", [col("digit 2"), col("digit 1")], (), None),
        ("4 keys (rank, leader, dot_src, dot_seq)",
         [np.where(flag(0.2), INT32_MAX, rng.integers(0, 5, n)).astype(np.int32),
          col("narrow"), rng.integers(1, 6, n).astype(np.int32), col("reverse")],
         (), None),
        ("6 keys, invert (False, True)",
         [flag(0.5), flag(0.5), col("narrow"), col("edges"), col("narrow"), col("sorted")],
         (False, True), None),
        ("packed key through a permutation", [col("full")], (),
         rng.permutation(n).astype(np.int32)),
    )


def numpy_lexsort(columns, invert):
    flips = list(invert) + [False] * (len(columns) - len(invert))
    cols = [~c if flip else c for c, flip in zip(columns, flips)]
    return np.lexsort(cols[::-1]).astype(np.int32)


def jax_lexsort(name, columns, invert):
    """The reference's sort: ``_order_from_ranks`` for its 4 keys,
    ``jnp.lexsort`` (last key first, as the reference passes them)."""
    flips = list(invert) + [False] * (len(columns) - len(invert))
    cols = [jnp.asarray(~c if flip else c) for c, flip in zip(columns, flips)]
    if name.startswith("4 keys"):
        return _order_from_ranks(*cols)
    return jnp.lexsort(tuple(cols[::-1])).astype(jnp.int32)


def case_lex_sort(rng):
    calls = 0
    for n in SIZES:
        for name, columns, invert, through in signatures(rng, n):
            what = f"lex_sort, {name}, n = {n}"
            keys = [torch.tensor(c) for c in columns]
            thr = None if through is None else torch.tensor(through)
            got = K.lex_sort(keys, invert, through=thr)
            calls += 1
            same(got, K.lex_sort_plain(keys, invert, through=thr).numpy(), f"{what} (plain)")
            order = numpy_lexsort(columns, invert)
            want = order if through is None else through[order]
            same(got, want, f"{what} (numpy.lexsort)")
            order = np.asarray(jax_lexsort(name, columns, invert))
            same(got, order if through is None else through[order], f"{what} (jnp)")
    return calls


# ---------------------------------------------------------------------------
# stable_rows
# ---------------------------------------------------------------------------


def frontier_rows(rng, kcap, n):
    """Rows of few distinct values (ties), negatives and INT_MAX cells;
    ``kcap`` is no multiple of the 256-row block."""
    cells = rng.choice(np.array([-9, -1, 0, 3, 3, 8, INT32_MAX], dtype=np.int32), (kcap, n))
    cells[: kcap // 3] = rng.integers(-50, 50, (kcap // 3, n))
    return cells


def case_stable_rows(rng):
    calls = 0
    for n in range(1, T.MAX_VOTERS + 1):
        cells = frontier_rows(rng, 261, n)
        frontier = torch.tensor(cells)
        for threshold in range(1, n + 1):
            what = f"stable_rows, n = {n}, threshold = {threshold}"
            got = T.stable_rows(frontier, threshold)
            calls += 1
            same(got, T.stable_rows_plain(frontier, threshold).numpy(), f"{what} (plain)")
            same(got, np.sort(cells, axis=1)[:, n - threshold], f"{what} (numpy)")
            want = ref_table.stable_clocks(jnp.asarray(cells), threshold=threshold)
            same(got, want, f"{what} (jax)")
    return calls


def case_stable_rows_round(rng):
    """The table-round mode: lagging voters leave gaps, fewer voters than
    processes; the updated frontier, stable clocks, executable and gaps
    against the plain version, the stable clocks also against the
    reference's on the updated frontier."""
    calls = 0
    for n, threshold, voters, batch in ((3, 2, 3, 300), (7, 4, 5, 700), (16, 9, 16, 40)):
        kcap = 300
        cells = rng.integers(0, 6, (kcap, n)).astype(np.int32)
        prior_old = rng.integers(0, 5, kcap).astype(np.int32)
        new_prior = (prior_old + rng.integers(0, 4, kcap)).astype(np.int32)
        key = rng.integers(0, kcap - 1, batch).astype(np.int32)
        clock = rng.integers(0, 8, batch).astype(np.int32)
        rnd = [torch.tensor(a) for a in (key, clock, prior_old, new_prior)] + [voters]
        got_f, want_f = torch.tensor(cells), torch.tensor(cells)
        got = T.stable_rows(got_f, threshold, tuple(rnd))
        calls += 1
        want = T.stable_rows_plain(want_f, threshold, tuple(rnd))
        what = f"stable_rows, table round, n = {n}, voters = {voters}"
        same(got_f, want_f.numpy(), f"{what}: frontier")
        for field, g, w in zip(("stable", "executable", "gaps"), got, want):
            same(g, w.numpy(), f"{what}: {field}")
        assert int(got[2]) > 0, f"{what}: no lagging voter"
        ref = ref_table.stable_clocks(jnp.asarray(want_f.numpy()), threshold=threshold)
        same(got[0], ref, f"{what}: stable (jax)")
    return calls


def test_sort_kernels_match_references(jax_ref):
    rng = np.random.default_rng(31)
    K.reset_launch_counts()
    T.reset_launch_counts()
    calls = {}
    with emulated():
        for name, case in (("lex_sort", case_lex_sort), ("stable_rows", case_stable_rows),
                           ("stable_rows round", case_stable_rows_round)):
            try:
                calls[name] = case(rng)
            except AssertionError as exc:
                raise AssertionError(f"case {name!r}: {exc}") from exc
    # every wrapper call launched its kernels (the counts the chip run reads)
    assert K.LAUNCHES["lex_sort"] == calls["lex_sort"], (K.LAUNCHES, calls)
    assert T.LAUNCHES["stable_rows"] == calls["stable_rows"] + calls["stable_rows round"]
