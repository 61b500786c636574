"""Batched dependency-graph resolution, on PyTorch.

The port of fantoch_tpu/ops/graph_resolve.py: the keyed path (single-key
commands: every row has at most one live dependency) and the general
paths (multi-key commands: out-degree up to W).  The output contract is
the reference's: members of one SCC execute contiguously in dot order,
an SCC executes after every SCC it depends on, and independent SCCs may
interleave.

Representation: ``dep[B]`` holds the batch index of each command's single
dependency, or ``TERMINAL = -1`` (none / executed) or ``MISSING = -2`` (not
committed here yet: the vertex and everything reaching it stays
unresolved); dots ride along as ``(dot_src, dot_seq)`` int32 columns.

Every stage is a wrapper from ``ops/graph_plane_kernels.py``: CPU tensors
run its plain PyTorch version, CUDA tensors its hand-written Hopper kernel.
The two ``lax.cond``s of the reference (``n_residual == 0`` at
fantoch_tpu/ops/graph_resolve.py:366 and the overflow fallback at :994)
become one host read of the ``n_residual`` scalar per call — the one
device sync of a dispatch; the overflow flag follows from it on the host.

The general modes keep the reference's loops on the host: each
``while_loop`` round of ``resolve_general`` and of the resident peeler is
one wrapper call followed by one host read of its device flag (and, for
the peeler, its live count), so the loops stop at the round the
reference's stop; ``resolve_general``'s fast-path ``lax.cond`` is one host
read of the prologue's bad-cell count.  ``resolve_general_staged`` (the
host-column route's resolver) is not ported: ROADMAP.md Queue A3.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fantoch_tpu_torch.ops import graph_plane_kernels as K
from fantoch_tpu_torch.ops.graph_plane_kernels import (
    FROZEN,
    INT32_MAX,
    MISSING,
    TERMINAL,
)

# rank assigned to unresolved vertices so they sort after all resolved ones
_UNRESOLVED_RANK = INT32_MAX
# slot sentinel internal to resolve_general_resident's compaction: a dep
# whose target was cut at a fixpoint compaction — only ever created after
# the publish gate closed, so it is never read into a published result
_FROZEN = FROZEN


class Resolution(NamedTuple):
    """Result of one batched resolve: ``order`` is a permutation with the
    resolved vertices first in execution order."""

    order: torch.Tensor  # int32[B]
    resolved: torch.Tensor  # bool[B]
    rank: torch.Tensor  # int32[B] topological level (condensation)
    leader: torch.Tensor  # int32[B] SCC leader (batch index)
    on_cycle: torch.Tensor  # bool[B]


class KeyedResolution(NamedTuple):
    """Result of ``resolve_functional_keyed(return_structure=False)``:
    ``resolved`` is a permutation of the per-vertex flags (valid for
    counting only) and rank/leader/on_cycle are zeros; ``overflow`` means
    the residual exceeded its buffer and the result must be discarded."""

    order: torch.Tensor
    resolved: torch.Tensor
    rank: torch.Tensor
    leader: torch.Tensor
    on_cycle: torch.Tensor
    n_resolved: torch.Tensor  # int32 scalar
    overflow: torch.Tensor  # bool scalar


class GraphPlaneStep(NamedTuple):
    """One resident dispatch: the backlog state (updated in place, the
    same tensors that went in) plus the emitted order."""

    deps: torch.Tensor  # int32[C, W] dep-slot matrix
    key: torch.Tensor  # int32[C] conflict-key hash (-1 = multi-key)
    src: torch.Tensor  # int32[C]
    seq: torch.Tensor  # int32[C]
    occ: torch.Tensor  # bool[C] slot holds a committed command
    executed: torch.Tensor  # bool[C]
    order: torch.Tensor  # int32[C] permutation; emitted = rows with newly
    newly: torch.Tensor  # bool[C] executed by this dispatch
    stuck: torch.Tensor  # bool[C] general modes: cycles for the host oracle
    leader: torch.Tensor  # int32[C] general modes: SCC leader (CHAIN_SIZE)


class GeneralResolution(NamedTuple):
    order: torch.Tensor  # int32[B]
    resolved: torch.Tensor  # bool[B]
    rank: torch.Tensor  # int32[B]
    leader: torch.Tensor  # int32[B]
    stuck: torch.Tensor  # bool[B] — not resolved and not missing-blocked:
    # cycles the device pass could not collapse; host oracle finishes them.


def _num_doubling_steps(batch: int) -> int:
    return K.num_doubling_steps(batch)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _doubling_core(dep: torch.Tensor):
    """(resolved, rank, leader, on_cycle) of an out-degree-<=1 graph."""
    return K.pointer_doubling(dep)


def resolve_functional(
    dep: torch.Tensor,
    dot_src: torch.Tensor,
    dot_seq: torch.Tensor,
) -> Resolution:
    """Exact batched resolution of an out-degree-<=1 dependency graph:
    pointer doubling, then the (rank, SCC leader, dot) lexicographic order
    (unresolved vertices carry the top rank and sink to the tail)."""
    resolved, rank, leader, on_cycle = K.pointer_doubling(dep)
    order = K.lex_sort([rank, leader, dot_src, dot_seq])
    return Resolution(order, resolved, rank, leader, on_cycle)


def _group_and_verify(key, dep):
    """Stages 1-2: one stable sort groups each key's commands into a run in
    batch order; a link is verified when it points at the previous run
    member (or the run head is TERMINAL).  Returns the sorted positions,
    the link-scan columns and ``n_residual`` read back to the host."""
    pos_s = K.lex_sort([key])
    dep_s, run_start, chain_ok, n_res = K.link_scan(key, dep, pos_s)
    # the one device->host sync of the step (replaces the lax.conds)
    return pos_s, dep_s, run_start, chain_ok, int(n_res.item())


def _residual_emit(pos_s, dep_s, run_start, chain_ok, src, seq, n_residual, res_n):
    """Stages 3-4: compact everything downstream of a run's first
    unverified link into ``res_n`` rows, finish it exactly by pointer
    doubling, and re-emit it at its run's tail positions in (resolved,
    rank, SCC leader, dot) order.  Returns the packed final-sort key, the
    resolved flags in sorted space and the unresolved count."""
    p_r = K.lex_sort([chain_ok])[:res_n]  # stable by cflag keeps run order
    _rpos, rrs, rsrc, rseq, rdep_local = K.residual_view(
        p_r, pos_s, dep_s, run_start, src, seq, n_residual
    )
    target_r = K.group_scan(rrs, p_r)
    l_resolved, l_rank, l_leader, _ = K.pointer_doubling(rdep_local)
    e = K.lex_sort(
        [rrs, l_resolved, l_rank, l_leader, rsrc, rseq],
        invert=(False, True),  # unresolved after resolved
    )
    return K.emit_scatter(e, p_r, l_resolved, target_r, chain_ok, n_residual)


def resolve_functional_keyed(
    key: torch.Tensor,
    dep: torch.Tensor,
    dot_src: torch.Tensor,
    dot_seq: torch.Tensor,
    *,
    residual_size: int,
    return_structure: bool = False,
) -> KeyedResolution:
    """Sort-based exact resolution of an out-degree-<=1 dependency graph
    (the reference's latency entry, ``return_structure=False``): group by
    key, verify chains, finish the residual by pointer doubling at
    residual scale.  On overflow the residual path still runs over the
    first ``residual_size`` rows, as the reference does; the caller
    discards the result."""
    if return_structure:
        raise NotImplementedError(
            "resolve_functional_keyed(return_structure=True) is the host-column "
            "route's structure entry: ROADMAP.md Queue A"
        )
    batch = dep.shape[0]
    assert batch < (1 << 30), "the packed emit key needs batch < 2^30"
    device = dep.device
    res_n = min(residual_size, batch)
    pos_s, dep_s, run_start, chain_ok, n_residual = _group_and_verify(key, dep)
    overflow = n_residual > res_n
    if n_residual == 0:
        order = pos_s
        resolved = torch.ones(batch, dtype=torch.bool, device=device)
        n_resolved = batch
    else:
        packed, resolved, n_unres = _residual_emit(
            pos_s, dep_s, run_start, chain_ok, dot_src, dot_seq, n_residual, res_n
        )
        order = K.lex_sort([packed], through=pos_s)
        n_resolved = batch - int(n_unres.item())
    zeros = torch.zeros(batch, dtype=torch.int32, device=device)
    return KeyedResolution(
        order,
        resolved,
        zeros,
        zeros,
        torch.zeros(batch, dtype=torch.bool, device=device),
        torch.full((), n_resolved, dtype=torch.int32, device=device),
        torch.full((), overflow, dtype=torch.bool, device=device),
    )


def _order_from_ranks(rank, leader, dot_src, dot_seq) -> torch.Tensor:
    """Execution order: (rank, SCC leader, dot) lexicographic.

    Same-SCC members share (rank, leader) and are therefore contiguous and
    dot-sorted (the reference's BTreeSet<Dot> order, tarjan.rs:15).  The
    rank key makes every SCC follow all SCCs it depends on.  Unresolved
    vertices carry rank INT32_MAX and sink to the tail.
    """
    return K.lex_sort([rank, leader, dot_src, dot_seq])


def resolve_general(
    deps: torch.Tensor,  # int32[B, D]
    dot_src: torch.Tensor,
    dot_seq: torch.Tensor,
    *,
    n_bad: int,
    max_iters: int = 0,  # 0 -> auto: 4 * log2(B) + 8
) -> GeneralResolution:
    """Batched resolution for out-degree-D graphs (the reference's
    ``resolve_general``, fantoch_tpu/ops/graph_resolve.py:467).

    Self-dependencies are pruned (a command never waits on itself).  When
    every remaining dependency points backward in batch order and none is
    MISSING, batch order is a topological order of singleton SCCs (the
    fast path).  Otherwise mutual-edge SCCs are collapsed exactly and
    affine-max pointer doubling resolves the rest; cycles with no mutual
    edges surface as ``stuck`` for the host Tarjan oracle.  ``n_bad``
    decides the fast path: the number of cells that bar it, a forward
    dependency or a MISSING one (self-dependencies aside).  The plane's
    general prologue counts it on the device (``K.graph_prologue``).
    """
    batch = deps.shape[0]
    device = deps.device
    if max_iters == 0:
        max_iters = 4 * _num_doubling_steps(batch) + 8
    if n_bad == 0:
        idx = torch.arange(batch, dtype=torch.int32, device=device)
        return GeneralResolution(
            idx,
            torch.ones(batch, dtype=torch.bool, device=device),
            idx,
            idx,
            torch.zeros(batch, dtype=torch.bool, device=device),
        )
    return GeneralResolution(
        *_resolve_general_iterative(deps, dot_src, dot_seq, max_iters)
    )


def _resolve_general_iterative(deps, dot_src, dot_seq, max_iters):
    """The exact fallback: mutual-edge SCC collapse + affine-max doubling
    (see resolve_general).  Returns the GeneralResolution fields.  The
    reference's ``while_loop`` is a host loop over ``affine_round``: it
    stops after the first round that changed nothing (whose outputs equal
    its inputs) or after ``max_iters`` rounds."""
    leader, tgt, add, missing, member_count = K.mutual_collapse(deps)
    floor = torch.zeros_like(tgt)
    for _ in range(max_iters):
        tgt, add, floor, missing, changed = K.affine_round(
            tgt, add, floor, missing, leader, member_count
        )
        if not int(changed.item()):
            break
    resolved, rank, stuck = K.affine_round(
        tgt, add, floor, missing, leader, member_count, final=True
    )
    order = _order_from_ranks(rank, leader, dot_src, dot_seq)
    return order, resolved, rank, leader, stuck


def _peel_stage(tgt, floor, miss, final, rank, live: int, *, run_to_fixpoint: bool):
    """One stage of the staged peeler: frontier peeling (absorption only,
    one dependency level per round) until progress stops or — unless
    ``run_to_fixpoint`` — the live set halves.  ``live`` is the stage's
    initial ``(~final & ~miss).sum()``: the reference's ``while_loop``
    tests its condition before the first round too."""
    half = max(tgt.shape[0] // 2, 1)
    changed = True
    while changed and (run_to_fixpoint or live > half):
        tgt, floor, miss, final, rank, stats = K.peel_round(
            tgt, floor, miss, final, rank
        )
        changed, live = stats.tolist()
    return tgt, floor, miss, final, rank


def _resident_schedule(batch: int, min_size: int) -> Tuple[int, ...]:
    """Static pow2 halving schedule from the padded batch down to the
    terminal stage size (inclusive)."""
    sizes = []
    size = _pow2_at_least(max(batch, 1))
    floor_size = _pow2_at_least(max(min_size, 1))
    while size > floor_size:
        sizes.append(size)
        size //= 2
    sizes.append(size)
    return tuple(sizes)


def resolve_general_resident(
    deps: torch.Tensor,  # int32[B, W] — TERMINAL/MISSING sentinels
    dot_src: torch.Tensor,
    dot_seq: torch.Tensor,
    *,
    min_size: int = 4096,
) -> GeneralResolution:
    """The peel-and-compact resolver kept resident on the card (the
    reference's ``resolve_general_resident``, graph_resolve.py:746):
    frontier peeling until the live set halves, compaction to half
    capacity, repeat down to ``min_size``, then a terminal fixpoint.  DAG
    rows finalize with frontier-proportional total cost, missing-blocked
    rows and their dependents come back unresolved-not-stuck, cycles never
    peel and return ``stuck`` (leader = self) for the host Tarjan oracle.
    A fixpoint reached while the live set still exceeds the next stage's
    capacity closes the publish gate: results are final there, so later
    stages (whose cut rows dangle as ``FROZEN``) cannot corrupt them."""
    batch = deps.shape[0]
    # the schedule's last stage must be the terminal one (the reference's
    # callers all pass the default)
    assert min_size & (min_size - 1) == 0, "min_size must be a power of two"
    state, outs, live = K.peel_compact(deps, mode="init")
    live = int(live.item())
    schedule = _resident_schedule(batch, min_size)
    for size in schedule:
        state = _peel_stage(*state[:5], live, run_to_fixpoint=size <= min_size) + (
            state[5],
        )
        if size <= min_size:
            stuck = K.peel_compact(*state, *outs, mode="publish")
            break  # terminal stage ran to its fixpoint
        state, live = K.peel_compact(*state, *outs, mode="compact", half=size // 2)
        live = int(live.item())
    out_rank = outs[2]
    # (rank, idx) order: the index is unique, so the dots never decide
    order = K.lex_sort([out_rank])
    idx = torch.arange(batch, dtype=torch.int32, device=deps.device)
    return GeneralResolution(order, outs[0], out_rank, idx, stuck)


def graph_plane_step_core(
    deps, key, src, seq, occ, executed,
    u_row, u_deps, u_key, u_src, u_seq,
    p_row, p_col, p_val, e_row,
    *,
    mode: str,
) -> GraphPlaneStep:
    """One resident dispatch of the device graph plane
    (executor/graph/graph_plane.py): install the feed's rows, patch the
    MISSING cells whose dots just committed, apply host-oracle executed
    marks, fold deps on executed slots to TERMINAL, mask non-pending rows
    inert, and resolve the whole pending window.  The state tensors are
    updated in place (what JAX's buffer donation did)."""
    cap = deps.shape[0]
    assert cap < (1 << 30), "the packed emit key needs C < 2^30"
    if mode != "keyed":
        return _general_plane_step(
            deps, key, src, seq, occ, executed,
            u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
            mode=mode,
        )
    col, pk = K.graph_prologue(
        deps, key, src, seq, occ, executed,
        u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
    )
    # a SMALL residual, deliberately: the window is mostly chain-verified
    # rows plus a thin blocked residue; overflow reruns the exact
    # full-window doubling.  When the residual covers the window there is
    # no overflow branch.
    residual_size = min(_pow2_at_least(max(64, cap // 16)), cap)
    pos_s, dep_s, run_start, chain_ok, n_residual = _group_and_verify(pk, col)
    if n_residual == 0:
        # every link verified: the grouped order is the execution order
        order = pos_s
        newly = K.plane_epilogue(occ, executed)
    elif n_residual > residual_size:
        full = resolve_functional(col, src, seq)
        order = full.order
        newly = K.plane_epilogue(occ, executed, full.resolved)
    else:
        packed, res_b, _n_unres = _residual_emit(
            pos_s, dep_s, run_start, chain_ok, src, seq, n_residual, residual_size
        )
        order = K.lex_sort([packed], through=pos_s)
        newly = K.plane_epilogue(occ, executed, res_b, pos_s)
    stuck = torch.zeros(cap, dtype=torch.bool, device=deps.device)
    leader = torch.zeros(cap, dtype=torch.int32, device=deps.device)
    return GraphPlaneStep(
        deps, key, src, seq, occ, executed, order, newly, stuck, leader
    )


def _general_plane_step(
    deps, key, src, seq, occ, executed,
    u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
    *,
    mode: str,
) -> GraphPlaneStep:
    """The ``general`` and ``general_resident`` branches of
    ``graph_plane_step_core`` (graph_resolve.py:997-1007).  The reference
    masks ``stuck`` with ``pending``; every stuck row is pending here
    already, since the prologue masks non-pending rows to all-TERMINAL
    rows, which both resolvers always finalize."""
    dmat, n_bad = K.graph_prologue(
        deps, key, src, seq, occ, executed,
        u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
        general=True,
    )
    if mode == "general":
        res = resolve_general(dmat, src, seq, n_bad=int(n_bad.item()))
    else:
        assert mode == "general_resident", mode
        res = resolve_general_resident(dmat, src, seq)
    newly = K.plane_epilogue(occ, executed, res.resolved)
    return GraphPlaneStep(
        deps, key, src, seq, occ, executed, res.order, newly, res.stuck, res.leader
    )


def resolve_graph_plane_step(
    deps, key, src, seq, occ, executed,
    u_row, u_deps, u_key, u_src, u_seq,
    p_row, p_col, p_val, e_row,
    *,
    mode: str,
) -> GraphPlaneStep:
    """The plane's dispatch entry (``mode``: "keyed" | "general" |
    "general_resident"): CPU tensors run every stage's plain version,
    CUDA tensors the Hopper kernels (each wrapper routes on the device of
    its inputs; there is no fallback from one to the other)."""
    return graph_plane_step_core(
        deps, key, src, seq, occ, executed,
        u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
        mode=mode,
    )
