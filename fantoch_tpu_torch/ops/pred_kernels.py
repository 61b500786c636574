"""Hopper kernels of the Caesar predecessors plane, with their plain version.

These replace the TPU kernel ``pred_plane_step_pallas``
(fantoch_tpu/ops/pallas_resolve.py:264, body ``_pred_step_kernel`` :201,
the Pallas twin of ``resolve_pred_plane_step_xla`` in
fantoch_tpu/ops/pred_resolve.py:123).  On the TPU it is one program whose
whole window sits in VMEM; on an H100 ``pred_plane_step`` runs
``csrc/pred_plane.cu`` as one launch a dispatch, in one of two forms of
the same phases:

* **one CTA** up to :data:`ONE_CTA_ROWS` rows, where its working set
  (:func:`one_cta_smem_bytes`: the counts, the reverse-edge CSR, the
  worklist and the state bytes) fits :data:`ONE_CTA_SMEM_BYTES` of shared
  memory (each row's packed clock, src, occupancy and state, and each
  cell's edge target, kept between two passes, in device memory);
* **grid** above that: one cooperative launch of :data:`GRID_BLOCK`-thread
  blocks clamped to the co-resident grid, a grid barrier between phases,
  the working set in one scratch allocation a dispatch.

As in ``ops/graph_plane_kernels.py`` the wrapper has a plain PyTorch
version (``pred_plane_step_plain``) that it runs for CPU tensors and that
``chip_smoke.py`` holds the kernels against on the card, and a launch
counter (``LAUNCHES``) raised where it launches its kernels and nowhere
else.  Given CUDA tensors it launches its kernels or raises; it never
falls back to the plain version.  All work is int32/bool, so kernels and
plain version agree bit for bit.

Preconditions the plane guarantees (``DevicePredPlane.add_arrays``): the
non-pad install rows of one dispatch are distinct, and so are the non-pad
patch cells — a waiter cell is popped once, and in-feed deps resolve to
slots, never to patches.  A patch may land on a row the same dispatch
installs (install first, then patch).  Install rows and patch cells
outside ``[0, C)`` (x ``[0, W)``) are pads and dropped, never written (the
reference's ``mode="drop"``; the reference would wrap a negative index,
which the plane never sends).  A dep index at or past ``C`` reads row
``C - 1``, as the reference's clamped gather does.

Bound: bytes.  The step must read the feed, write the installed rows and
patched cells, read every pending row's dep cells and its targets' clock,
src and occupancy, read ``executed`` and write ``executed`` and
``newly``.  Design: the least fixpoint as propagation along reverse
edges instead of sweeps of the whole window.  Each pending row counts its
wait cells whose target is not done; the cells whose target is pending
are the reverse edges, built as a CSR (a degree a target, a scan, a fill).
Rows with a count of 0 are the seeds; a thread marking a row done takes
one from each waiter's count, marks the first waiter it takes to 0 itself
and carries on down the chain, and pushes the others onto a worklist all
threads drain.  A same-key chain is thus walked at memory latency, one
link after another, where a sweep advanced it by about a link over the
whole window.  ``last_work`` reports the rows the propagation marked (the
dispatch's ``newly`` rows) and the rows it pushed onto the worklist.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fantoch_tpu_torch.ops import graph_plane_kernels as K

TERMINAL = K.TERMINAL
MISSING = K.MISSING

LAUNCHES: Dict[str, int] = {"pred_plane_step": 0}
# launches by form (a breakdown of LAUNCHES["pred_plane_step"])
VARIANT_LAUNCHES: Dict[str, int] = {"one_cta": 0, "grid": 0}

# the one-CTA form's gates: its working set within this much shared memory
# (the card allows 227 KB of dynamic shared memory a block; the rest is
# slack), and at most ONE_CTA_ROWS rows, the crossover chip_smoke.py phase 9
# measures (both forms on the same dispatches, on an H100: one CTA ahead
# at 1,024 and 2,048 rows; at 4,096 ahead by 3% in one run and behind by
# 17% in two; the grid ahead at 8,192)
ONE_CTA_SMEM_BYTES = 200 * 1024
ONE_CTA_ROWS = 2048
# threads a block of the grid form (a multiple of 32)
GRID_BLOCK = 256
# most blocks of the grid form (csrc/pred_plane.cu PP_PARTS): the scratch
# holds a partial sum for each
_GRID_PARTS = 4096

# the last dispatch's device counter (marked, pushed), read on demand by
# last_work so the launch stays asynchronous
_last_work = {"value": (0, 0)}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, VARIANT_LAUNCHES):
        for name in table:
            table[name] = 0


def last_work() -> Dict[str, int]:
    """The last kernel dispatch's propagation: ``marked``, the rows it marked
    done (the dispatch's ``newly`` rows), and ``pushed``, the rows of those
    that went through the worklist rather than being walked on from the
    row that readied them (0 along a chain)."""
    value = _last_work["value"]
    if isinstance(value, torch.Tensor):
        value = tuple(int(x) for x in value.tolist())
        _last_work["value"] = value
    return {"marked": value[0], "pushed": value[1]}


def one_cta_smem_bytes(cap: int, width: int) -> int:
    """Shared memory of the one-CTA form (``csrc/pred_plane.cu``
    ``one_cta_smem``): 64 ints for reductions, the CSR ends (C + 1), the
    counts (C), head and tail as ints; the 16-bit adjacency (C * W) and
    worklist (C); a state byte a row."""
    return 4 * (64 + 2 * cap + 1 + 2) + 2 * (cap * width + cap) + cap


def pred_plane_step_plain(
    deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src, p_row, p_col, p_val
) -> Tuple[torch.Tensor, ...]:
    """The composed body of ``resolve_pred_plane_step_xla``: install,
    patch, then the reference's Jacobi rounds to the least fixpoint.
    Updates the five state tensors in place and returns them with
    ``newly``."""
    cap, width = deps.shape
    keep = (u_row >= 0) & (u_row < cap)
    rows = u_row[keep].long()
    deps[rows] = u_deps[keep]
    clock[rows] = u_clock[keep]
    src[rows] = u_src[keep]
    occ[rows] = True
    executed[rows] = False
    keep = (p_row >= 0) & (p_row < cap) & (p_col >= 0) & (p_col < width)
    deps[p_row[keep].long(), p_col[keep].long()] = p_val[keep]

    in_res = deps >= 0
    safe = deps.clamp(0, max(cap - 1, 0)).long()
    dep_clock, dep_src = clock[safe], src[safe]
    my_clock, my_src = clock[:, None], src[:, None]
    dep_higher = (dep_clock > my_clock) | ((dep_clock == my_clock) & (dep_src > my_src))
    never_blocks = (deps == TERMINAL) | (in_res & occ[safe] & dep_higher)
    executed0 = executed.clone()
    done = executed0
    while True:
        dep_ok = never_blocks | (in_res & done[safe])
        new = occ & dep_ok.all(dim=1)
        changed = bool((new & ~done).any())
        done = new | done
        if not changed:
            break
    executed.copy_(done)
    return deps, clock, src, occ, executed, done & ~executed0


def pred_plane_step(
    deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src, p_row, p_col, p_val
) -> Tuple[torch.Tensor, ...]:
    """One resident window step: state ``deps int32[C, W]``, ``clock``/``src
    int32[C]``, ``occ``/``executed bool[C]`` updated in place; feed
    ``u_row int32[U]``, ``u_deps int32[U, W]``, ``u_clock``/``u_src
    int32[U]``, ``p_row``/``p_col``/``p_val int32[P]``.  Returns the state
    and ``newly bool[C]`` (executed by this step).  See the module
    docstring for the preconditions on the feed."""
    if not K._on_card(deps):
        return pred_plane_step_plain(
            deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src,
            p_row, p_col, p_val,
        )
    cap, width = deps.shape
    device = deps.device
    U, P = u_row.numel(), p_row.numel()
    K._check(deps, torch.int32, "deps")
    for t, name in ((clock, "clock"), (src, "src")):
        K._check(t, torch.int32, name, cap)
    for t, name in ((occ, "occ"), (executed, "executed")):
        K._check(t, torch.bool, name, cap)
    K._check(u_row, torch.int32, "u_row", U)
    K._check(u_deps, torch.int32, "u_deps", U * width)
    for t, name in ((u_clock, "u_clock"), (u_src, "u_src")):
        K._check(t, torch.int32, name, U)
    for t, name in ((p_row, "p_row"), (p_col, "p_col"), (p_val, "p_val")):
        K._check(t, torch.int32, name, P)
    newly = K._b(cap, device)
    work = K._i32(2, device)
    state = (deps, clock, src, occ, executed)
    feed = (u_row, u_deps, u_clock, u_src, p_row, p_col, p_val)
    if cap <= ONE_CTA_ROWS and one_cta_smem_bytes(cap, width) <= ONE_CTA_SMEM_BYTES:
        scratch = K._i32(4 * cap + cap * width, device)
        K._launch("pp_one_cta", device, *state, *feed, newly, work, scratch, cap, width,
                  U, P)
        VARIANT_LAUNCHES["one_cta"] += 1
    else:
        if GRID_BLOCK <= 0 or GRID_BLOCK % 32:
            raise ValueError(
                f"GRID_BLOCK must be a positive multiple of 32 (got {GRID_BLOCK})")
        scratch = K._i32(
            7 * cap + 1 + 2 * cap * width + 2 + _GRID_PARTS + (cap + 3) // 4, device)
        K._launch("pp_grid", device, *state, *feed, newly, work, scratch, cap, width,
                  U, P, GRID_BLOCK)
        VARIANT_LAUNCHES["grid"] += 1
    _last_work["value"] = work
    LAUNCHES["pred_plane_step"] += 1
    return deps, clock, src, occ, executed, newly
