"""Port parity: Caesar's predecessor resolves on tensors.

* ``fantoch_tpu_torch.ops.pred_resolve.resolve_pred`` (the batched
  executor's one-batch fixpoint and its (clock, src, seq) order) against
  the JAX package's ``resolve_pred`` on random batches: in-batch, TERMINAL
  and MISSING dep cells, uncommitted rows, tied clocks told apart by src
  and seq.
* The port's ``resolve_pred_plane_step`` on CPU tensors (the plain version
  of the pred kernels) against both JAX routes of the resident window
  step — the composed ``resolve_pred_plane_step_xla`` and the Pallas
  kernel ``pred_plane_step_pallas`` in interpret mode (forced as
  tests/test_pallas_resolve.py does, with a fresh probe verdict, and
  checked to have run) — each route threading its own state
  across dispatches: random multi-dispatch feeds (unique install rows and
  patch cells, pad rows, a non-pow2 window), a long same-key chain
  installed in one dispatch in both slot orders, and MISSING-blocked rows
  woken by a later dispatch's patch.  All six outputs after every
  dispatch.

Exact equality throughout.  One collected item on purpose (ROADMAP.md
Queue C); reference calls run under ``jax_ref``: tolerant duration
listeners and no persistent compile cache for the test's span.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring

from fantoch_tpu.ops import pallas_resolve as jpallas
from fantoch_tpu.ops import pred_resolve as jpred
from fantoch_tpu_torch.ops import pred_resolve as tpred

torch.set_num_threads(1)

TERMINAL, MISSING = -1, -2


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


def case_resolve_pred(rng):
    for batch, width in ((1, 1), (8, 2), (64, 4), (256, 8)):
        for _trial in range(4):
            deps = rng.integers(0, batch, (batch, width))
            kind = rng.random((batch, width))
            deps = np.where(kind < 0.2, TERMINAL, deps)
            deps = np.where((kind >= 0.2) & (kind < 0.3), MISSING, deps).astype(np.int32)
            clock = rng.integers(0, max(batch // 2, 1), batch).astype(np.int32)
            src = rng.integers(1, 4, batch).astype(np.int32)
            seq = rng.integers(0, 3, batch).astype(np.int32)
            committed = rng.random(batch) < 0.9
            cols = (deps, clock, src, seq, committed)
            want = jpred.resolve_pred(*(jnp.asarray(c) for c in cols))
            got = tpred.resolve_pred(*(torch.tensor(c) for c in cols))
            assert np.array_equal(got.executed.numpy(), np.asarray(want.executed))
            assert np.array_equal(got.order.numpy(), np.asarray(want.order))
            assert got.order.dtype == torch.int32


def fresh_state(cap, width):
    return (
        np.full((cap, width), TERMINAL, np.int32),
        np.zeros(cap, np.int32),
        np.zeros(cap, np.int32),
        np.zeros(cap, bool),
        np.zeros(cap, bool),
    )


class Routes:
    """The port and the two JAX routes, each threading its own state."""

    def __init__(self, cap, width):
        state = fresh_state(cap, width)
        self.port = tuple(torch.tensor(a) for a in state)
        self.xla = tuple(jnp.asarray(a) for a in state)
        self.pallas = tuple(jnp.asarray(a) for a in state)

    def step(self, feed, case):
        out_x = jpred.resolve_pred_plane_step_xla(
            *self.xla, *(jnp.asarray(c) for c in feed)
        )
        jpallas.set_pallas_kernels(True)
        try:
            out_p = jpred.resolve_pred_plane_step(
                *self.pallas, *(jnp.asarray(c) for c in feed)
            )
        finally:
            jpallas.set_pallas_kernels(None)
        # the Pallas route ran (a failed probe would fall back silently)
        assert jpallas.pallas_status()["families"].get("pred_plane_step") is True
        got = tpred.resolve_pred_plane_step(*self.port, *(torch.tensor(c) for c in feed))
        for name, g, x, p in zip(got._fields, got, out_x, out_p):
            assert np.array_equal(np.asarray(x), np.asarray(p)), f"{case}: JAX routes, {name}"
            assert np.array_equal(g.numpy(), np.asarray(x)), f"{case}: {name}"
        self.port, self.xla, self.pallas = got[:5], tuple(out_x[:5]), tuple(out_p[:5])
        return got.newly.numpy()


def pad_feed(cap, width, rows=(), deps=None, clock=(), src=(), patches=(), ucap=8, pcap=8):
    """Padded feed columns: install rows and (row, col, val) patches, pads
    at row ``cap``."""
    u_row = np.full(ucap, cap, np.int32)
    u_deps = np.full((ucap, width), TERMINAL, np.int32)
    u_clock = np.zeros(ucap, np.int32)
    u_src = np.zeros(ucap, np.int32)
    n = len(rows)
    u_row[:n] = rows
    if n:
        u_deps[:n] = deps
        u_clock[:n] = clock
        u_src[:n] = src
    p_row = np.full(pcap, cap, np.int32)
    p_col = np.zeros(pcap, np.int32)
    p_val = np.zeros(pcap, np.int32)
    for i, (r, c, v) in enumerate(patches):
        p_row[i], p_col[i], p_val[i] = r, c, v
    return (u_row, u_deps, u_clock, u_src, p_row, p_col, p_val)


def case_random_dispatches(rng):
    """Random multi-dispatch feeds: deps on installed rows, TERMINAL or
    MISSING; unique patch cells re-pointing earlier rows' cells."""
    for cap, width in ((24, 4), (37, 2), (64, 8)):
        routes = Routes(cap, width)
        installed = 0
        for dispatch in range(6):
            n = min(int(rng.integers(1, 7)), cap - installed)
            rows = np.arange(installed, installed + n)
            deps = np.full((n, width), TERMINAL, np.int32)
            for i, row in enumerate(rows):
                for w in range(int(rng.integers(0, width + 1))):
                    choice = rng.random()
                    if choice < 0.3:
                        deps[i, w] = MISSING
                    elif row > 0 and choice < 0.8:
                        deps[i, w] = rng.integers(0, row)
            clock = rng.integers(1, 1000, n)
            src = rng.integers(1, 4, n)
            cells = {}
            for _ in range(int(rng.integers(0, 6))):
                if installed == 0:
                    break
                cell = (int(rng.integers(0, installed)), int(rng.integers(0, width)))
                cells[cell] = TERMINAL if rng.random() < 0.5 else int(rng.integers(0, installed))
            patches = [(r, c, v) for (r, c), v in cells.items()]
            feed = pad_feed(cap, width, rows, deps, clock, src, patches)
            routes.step(feed, f"random C={cap} W={width} dispatch {dispatch}")
            installed += n


def case_long_chain():
    """One key's chain of 96 commands installed in one dispatch, each on
    its two predecessors, in ascending and descending slot order: one link
    a Jacobi round."""
    cap, width, n = 128, 2, 96
    for descending in (False, True):
        routes = Routes(cap, width)
        slots = np.arange(n)[::-1] if descending else np.arange(n)
        deps = np.full((n, width), TERMINAL, np.int32)
        for i in range(1, n):
            deps[i, 0] = slots[i - 1]
            if i > 1:
                deps[i, 1] = slots[i - 2]
        clock = np.arange(1, n + 1)
        feed = pad_feed(cap, width, slots, deps, clock, np.ones(n), ucap=128)
        newly = routes.step(feed, f"chain, descending={descending}")
        assert newly.sum() == n


def case_missing_woken_by_patch():
    """Rows blocked on a MISSING cell stay resident across dispatches and
    run once a later dispatch patches the cell: to a row it installs
    (lower clock, so it runs first) or to TERMINAL (a recovered noop)."""
    cap, width = 16, 2
    routes = Routes(cap, width)
    # rows 0-2: a chain whose head waits on a missing dot
    deps = np.array([[MISSING, TERMINAL], [0, TERMINAL], [1, 0]], np.int32)
    newly = routes.step(pad_feed(cap, width, [0, 1, 2], deps, [5, 6, 7], [1, 1, 1]), "blocked")
    assert not newly.any()
    # row 3 waits on another missing dot; an unrelated row 4 runs
    deps = np.array([[MISSING, TERMINAL], [TERMINAL, TERMINAL]], np.int32)
    newly = routes.step(pad_feed(cap, width, [3, 4], deps, [9, 3], [2, 2]), "still blocked")
    assert newly.nonzero()[0].tolist() == [4]
    # the first missing dot commits as row 5 (clock 1): rows 5, 0, 1, 2
    newly = routes.step(
        pad_feed(cap, width, [5], np.full((1, width), TERMINAL), [1], [3],
                 patches=[(0, 0, 5)]),
        "woken by an install",
    )
    assert newly.nonzero()[0].tolist() == [0, 1, 2, 5]
    # the second resolves as a noop: row 3
    newly = routes.step(pad_feed(cap, width, patches=[(3, 0, TERMINAL)]), "woken by a noop")
    assert newly.nonzero()[0].tolist() == [3]


def test_pred_resolves_match_jax(jax_ref, monkeypatch):
    # a fresh Pallas probe: the reference keeps each family's probe verdict
    # for the life of the process, and a compile that failed earlier in
    # this worker (under the untolerant duration listeners) would leave
    # the family on the composed route
    monkeypatch.setattr(jpallas, "_supported", {})
    rng = np.random.default_rng(29)
    for name, case in (
        ("resolve_pred", lambda: case_resolve_pred(rng)),
        ("random dispatches", lambda: case_random_dispatches(rng)),
        ("long chain", case_long_chain),
        ("missing woken by a patch", case_missing_woken_by_patch),
    ):
        try:
            case()
        except AssertionError as exc:
            raise AssertionError(f"case {name!r}: {exc}") from exc
