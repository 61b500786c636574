"""Hopper kernels of the Newt votes-table plane, with their plain versions.

These replace the TPU kernels ``votes_commit_pallas``
(fantoch_tpu/ops/pallas_resolve.py:394, tracing
``table_ops._votes_commit_core`` :260) and ``table_round_pallas``
(pallas_resolve.py:441, tracing ``table_ops._fused_round_core`` :369 and
``_proposal_core`` :148).  On the TPU each is one program resident in VMEM;
on an H100 ``ops/table_ops.py`` composes them from four wrappers over
``csrc/table_plane.cu`` and the graph plane's ``lex_sort``:

* ``clock_proposal`` — ``_proposal_core``: clocks and vote starts of a
  batch of single-key commands, the key-clock table updated in place;
* ``clock_bump`` — ``prior.at[idx].max(clock)`` in place;
* ``vote_runs`` — ``_votes_commit_core`` up to the frontier update: the
  merged vote runs, their residual flags, the frontier updated in place;
* ``stable_rows`` — the ``(n - threshold)``-th smallest frontier of each
  key; in its table-round mode the round's dense vote update comes first
  and ``executable`` after.

As in ``ops/graph_plane_kernels.py`` every wrapper has a plain PyTorch
version (``<wrapper>_plain``) that it runs for CPU tensors and that
``chip_smoke.py`` holds the kernel against on the card, a launch counter
(``LAUNCHES``) raised where the wrapper launches its kernels and nowhere
else, and a note on what bounds it.  A wrapper given CUDA tensors launches
its kernels or raises; it never falls back to the plain version.  All work
is int32/bool with two's-complement wrap, as XLA's, so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fantoch_tpu_torch.ops import graph_plane_kernels as K

INT32_MIN = -(1 << 31)
# stable_rows ranks a key's frontier row in registers
MAX_VOTERS = 16

LAUNCHES: Dict[str, int] = {
    "clock_proposal": 0,
    "clock_bump": 0,
    "vote_runs": 0,
    "stable_rows": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def seg_running_max_plain(seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Running max of ``values`` within runs of equal ``seg`` (contiguous):
    the combiner of ``table_ops._seg_max_combiner`` applied as a
    Hillis-Steele scan, one vectorised step per power of two (the plain
    versions' scan; the kernels scan inside ``clock_proposal`` and
    ``vote_runs``)."""
    out = values.clone()
    n = out.shape[0]
    off = 1
    while off < n:
        take = seg[off:] == seg[:-off]
        nxt = out.clone()
        nxt[off:] = torch.where(take, torch.maximum(out[off:], out[:-off]), out[off:])
        out = nxt
        off <<= 1
    return out


# ---------------------------------------------------------------------------
# 1. clock_proposal: _proposal_core (fantoch_tpu/ops/table_ops.py:148)
# ---------------------------------------------------------------------------
# Bound: bytes — key and min_clock read, clock and vote_start written, one
# prior cell read and written a distinct key.  Design: the stable argsort
# by key is lex_sort (the key, then the index); then one launch, one pass
# over tiles of ``PROP_TILE`` sorted rows (``csrc/table_plane.cu``
# §clock_proposal): a tile carries the last run's head, last row, running
# max of base - rank (as base - i, exact in 64 bits) and max clock, so no
# binary search finds a row's run and no segmented-scan launches follow;
# the run's last row writes prior[k] = max(prior[k], the run's max clock),
# one writer a key, after every read of prior[k] (the argument is in the
# source).  A block a tile, the prefix carried by decoupled look-back on
# the status buffer the graph plane's link scan keeps (``K.lookback``).  No
# memset, no scratch, no atomic on prior.

PROP_TILE = 1024  # rows a tile (csrc PROP_TILE)


def clock_proposal_plain(prior, key, min_clock) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(clock[B], vote_start[B])`` and updates ``prior`` in place
    to ``prior.at[key].max(clock)`` (the reference's ``new_prior``)."""
    batch = key.shape[0]
    device = key.device
    idx = _arange(batch, device)
    perm = torch.sort(key, stable=True).indices
    ks = key[perm]
    seg_start = torch.ones(batch, dtype=torch.bool, device=device)
    seg_start[1:] = ks[1:] != ks[:-1]
    group_first = torch.cummax(torch.where(seg_start, idx, 0), 0).values
    rank = (idx - group_first).to(torch.int32)
    base = torch.maximum(prior[ks.long()] + 1, min_clock[perm])
    running = seg_running_max_plain(ks, base - rank)
    clock_sorted = rank + running
    clock = torch.zeros(batch, dtype=torch.int32, device=device)
    clock[perm] = clock_sorted
    prev = torch.where(seg_start, prior[ks.long()], torch.roll(clock_sorted, 1))
    vote_start = torch.zeros(batch, dtype=torch.int32, device=device)
    vote_start[perm] = prev + 1
    prior.scatter_reduce_(0, key.long(), clock, "amax")
    return clock, vote_start


def clock_proposal(prior, key, min_clock):
    if not K._on_card(key):
        return clock_proposal_plain(prior, key, min_clock)
    batch = key.numel()
    device = key.device
    K._check(prior, torch.int32, "prior")
    K._check(key, torch.int32, "key", batch)
    K._check(min_clock, torch.int32, "min_clock", batch)
    clock, vote_start = K._i32(batch, device), K._i32(batch, device)
    if batch == 0:
        return clock, vote_start
    perm = K.lex_sort([key])
    status, epoch = K.lookback(device, -(-batch // PROP_TILE))
    K._launch(
        "tp_clock_proposal", device, key, min_clock, perm, prior, clock,
        vote_start, status, batch, epoch,
    )
    LAUNCHES["clock_proposal"] += 1
    return clock, vote_start


# ---------------------------------------------------------------------------
# 2. clock_bump: resident_clock_bump (fantoch_tpu/ops/table_ops.py:217)
# ---------------------------------------------------------------------------
# Bound: bytes — idx and clock read, M cells of prior read and written.
# Design: one atomicMax per bump (max is order-free, so duplicates and the
# pad rows' 0 into the pad bucket are harmless, as in the reference).


def clock_bump_plain(prior, idx, clock) -> None:
    """``prior.at[idx].max(clock)`` in place."""
    prior.scatter_reduce_(0, idx.long(), clock, "amax")


def clock_bump(prior, idx, clock):
    if not K._on_card(idx):
        return clock_bump_plain(prior, idx, clock)
    m = idx.numel()
    K._check(prior, torch.int32, "prior")
    K._check(idx, torch.int32, "idx", m)
    K._check(clock, torch.int32, "clock", m)
    if m == 0:
        return None
    K._launch("tp_clock_bump", idx.device, idx, clock, prior, m)
    LAUNCHES["clock_bump"] += 1
    return None


# ---------------------------------------------------------------------------
# 3. vote_runs: _votes_commit_core up to the frontier update
#    (fantoch_tpu/ops/table_ops.py:260-345)
# ---------------------------------------------------------------------------
# Bound: bytes — the five vote columns read, the five run columns written,
# a gather and a write of one frontier cell per run.  Design: one launch
# forms the sort group key * n + by (invalid rows share K * n); lex_sort
# orders (group, start, index); then three stages, each a scan of four rows
# a thread (``csrc/table_plane.cu`` §vote_runs): the gather of the sorted
# groups, starts and ends (three random reads a row; key, process and
# validity are read at run heads alone) with each tile's aggregate of the
# group-segmented running max end; the run heads and one scan of (heads,
# max end since the last head, last head), whose run-last rows write the
# run columns, residual and the frontier value f0 their run read; the slots past the last run, and the
# frontier, each cell written once by its last run (a max scan over the
# runs segmented by cell) and frontier[0, 0] raised to at least 0 in one
# write where some slot is not a valid run.  No same-address atomic.  Up to
# :data:`VOTE_CTA_ROWS` rows one block runs the three stages with block
# barriers between them: one launch.  Above, each stage is a launch of
# tiles of :data:`VOTE_BLOCK` threads, the scans carried across tiles by
# decoupled look-back; one scratch allocation a call, no memset.

# one CTA wherever it fits (1,024 threads of four rows): on an H100 it was
# ahead of the tiles at every row count it takes, 256 to 4,096
# (chip_smoke.py phase 9)
VOTE_CTA_ROWS = 4096
# threads a tile of the multi-block form (a multiple of 32, at most 1,024)
VOTE_BLOCK = 1024
VOTE_ROWS = 4  # rows a thread (csrc/table_plane.cu VR_ROWS)


def vote_runs_plain(frontier, vkey, vby, vstart, vend, valid):
    """Returns ``(run_key, run_by, run_start, run_end, residual)`` (one slot
    per row, merged runs first) and advances ``frontier`` in place."""
    n_keys, n = frontier.shape
    V = vkey.shape[0]
    if V < 1:
        raise ValueError("vote_runs needs at least one row (num_runs = rid[V-1] + 1)")
    device = vkey.device
    slot = _arange(V, device)
    gid = torch.where(valid, vkey * n + vby, n_keys * n).to(torch.int32)
    by_start = torch.sort(vstart, stable=True).indices
    order = by_start[torch.sort(gid[by_start], stable=True).indices]
    g, s, e, valid_s = gid[order], vstart[order], vend[order], valid[order]
    grp_start = torch.ones(V, dtype=torch.bool, device=device)
    grp_start[1:] = g[1:] != g[:-1]
    run_max_end = seg_running_max_plain(g, e)
    prev_max = torch.roll(run_max_end, 1)
    new_run = grp_start | (s > prev_max + 1)
    rid = (torch.cumsum(new_run.to(torch.int32), 0) - 1).long()
    run_end = torch.full((V,), INT32_MIN, dtype=torch.int32, device=device)
    run_end.scatter_reduce_(0, rid, e, "amax")
    run_head = torch.zeros(V, dtype=torch.int32, device=device)
    run_head.scatter_reduce_(0, rid, torch.where(new_run, slot, 0), "amax")
    head = run_head.long()
    num_runs = rid[V - 1] + 1
    run_valid = (slot < num_runs) & valid_s[head]
    run_key = torch.where(run_valid, vkey[order][head], 0).to(torch.int32)
    run_by = torch.where(run_valid, vby[order][head], 0).to(torch.int32)
    run_start = s[head]
    cell = run_key.long() * n + run_by.long()
    f0 = frontier.view(-1)[cell]
    extends = run_valid & (run_start <= f0 + 1) & (run_end > f0)
    residual = run_valid & (run_start > f0 + 1) & (run_end > f0)
    frontier.view(-1).scatter_reduce_(
        0, cell, torch.where(extends, run_end, 0).to(torch.int32), "amax"
    )
    return run_key, run_by, run_start, run_end, residual


def vote_runs(frontier, vkey, vby, vstart, vend, valid):
    if not K._on_card(vkey):
        return vote_runs_plain(frontier, vkey, vby, vstart, vend, valid)
    n_keys, n = frontier.shape
    V = vkey.numel()
    if V < 1:
        raise ValueError("vote_runs needs at least one row")
    device = vkey.device
    K._check(frontier, torch.int32, "frontier")
    for name, t in (("vkey", vkey), ("vby", vby), ("vstart", vstart), ("vend", vend)):
        K._check(t, torch.int32, name, V)
    K._check(valid, torch.bool, "valid", V)
    gid = K._i32(V, device)
    K._launch("tp_votes_gid", device, vkey, vby, valid, gid, V, n, n_keys)
    order = K.lex_sort([gid, vstart])
    run_key, run_by, run_start, run_end = (K._i32(V, device) for _ in range(4))
    residual = K._b(V, device)
    cta = V <= VOTE_CTA_ROWS
    tile = VOTE_BLOCK * VOTE_ROWS
    tiles = 1 if cta else -(-V // tile)
    scratch = K._i32(4 * V + 18 * tiles + 3 + (V + 3) // 4, device)
    K._launch(
        "tp_vote_runs", device, order, gid, vkey, vby, vstart, vend, valid,
        frontier, run_key, run_by, run_start, run_end, residual, scratch, V, n,
        int(cta), VOTE_BLOCK,
    )
    LAUNCHES["vote_runs"] += 1
    return run_key, run_by, run_start, run_end, residual


# ---------------------------------------------------------------------------
# 4. stable_rows: the stable clock per key (table_ops.stable_clocks :234,
#    the tail of _votes_commit_core), and in its table-round mode the rest
#    of _fused_round_core (:369-390)
# ---------------------------------------------------------------------------
# Bound: bytes — the int32[K, n] frontier read once and stable[K] written
# (the round mode reads prior_old/new_prior, key and clock once more and
# writes the frontier and executable).  Design: a block loads its 256 rows'
# cells into shared memory coalesced, each row at an odd stride (no bank
# conflicts), then one thread a row takes the cell of rank n - threshold,
# ranking by a count unrolled for each n in 1..MAX_VOTERS (the cells below
# plus the equal cells before), so every index is known at compile time
# and nothing goes to local memory.  The stable-only mode is one
# allocation and one launch (``tp_stable_only``).  The round mode first
# scatters ``touched`` from key, then one thread per (key, process) lane
# advances contiguous voters (frontier >= the OLD prior) to new_prior and
# counts the others as gaps — a warp sum, a block sum and one atomicAdd
# per block — then selects as above, and finally one thread per command
# sets executable = clock <= stable[key].


def _check_threshold(n: int, threshold: int) -> int:
    if not 1 <= threshold <= n:
        raise ValueError(f"threshold {threshold} must lie in [1, n = {n}]")
    return n - threshold


def stable_rows_plain(frontier, threshold: int, round=None):
    """``stable int32[K]``; with ``round = (key, clock, prior_old,
    new_prior, voters)`` it first applies the round's dense votes to
    ``frontier`` in place and returns ``(stable, executable bool[B], gaps
    int32[])``."""
    n_keys, n = frontier.shape
    col = _check_threshold(n, threshold)
    if round is None:
        return torch.sort(frontier, dim=1).values[:, col]
    key, clock, prior_old, new_prior, voters = round
    device = frontier.device
    touched = torch.zeros(n_keys, dtype=torch.bool, device=device)
    touched[key.long()] = True
    voter = _arange(n, device) < voters
    contiguous = frontier >= prior_old[:, None]
    lane = touched[:, None] & voter[None, :]
    frontier.copy_(torch.where(
        lane & contiguous, torch.maximum(frontier, new_prior[:, None]), frontier
    ))
    gaps = (lane & ~contiguous).sum().to(torch.int32)
    stable = torch.sort(frontier, dim=1).values[:, col]
    return stable, clock <= stable[key.long()], gaps


def stable_rows(frontier, threshold: int, round=None):
    if not K._on_card(frontier):
        return stable_rows_plain(frontier, threshold, round)
    n_keys, n = frontier.shape
    col = _check_threshold(n, threshold)
    if n > MAX_VOTERS:
        raise ValueError(f"stable_rows ranks at most {MAX_VOTERS} voters (n = {n})")
    device = frontier.device
    K._check(frontier, torch.int32, "frontier")
    stable = K._i32(n_keys, device)
    if round is None:
        K._launch("tp_stable_only", device, frontier, stable, n_keys, n, col)
        LAUNCHES["stable_rows"] += 1
        return stable
    key, clock, prior_old, new_prior, voters = round
    batch = key.numel()
    K._check(key, torch.int32, "key", batch)
    K._check(clock, torch.int32, "clock", batch)
    K._check(prior_old, torch.int32, "prior_old", n_keys)
    K._check(new_prior, torch.int32, "new_prior", n_keys)
    touched = torch.zeros(n_keys, dtype=torch.bool, device=device)
    executable = K._b(batch, device)
    gaps = K._i32(1, device, 0)
    K._launch(
        "tp_stable_rows", device, frontier, stable, key, clock, prior_old,
        new_prior, touched, executable, gaps, n_keys, n, col, batch, int(voters),
    )
    LAUNCHES["stable_rows"] += 1
    return stable, executable, gaps.reshape(())

