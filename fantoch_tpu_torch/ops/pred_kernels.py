"""Hopper kernels of the Caesar predecessors plane, with their plain version.

These replace the TPU kernel ``pred_plane_step_pallas``
(fantoch_tpu/ops/pallas_resolve.py:264, body ``_pred_step_kernel`` :201,
the Pallas twin of ``resolve_pred_plane_step_xla`` in
fantoch_tpu/ops/pred_resolve.py:123).  On the TPU it is one program whose
whole window sits in VMEM; on an H100 ``pred_plane_step`` runs
``csrc/pred_plane.cu`` in one of two variants:

* **one CTA** when the fixpoint's working set (a wait target per dep cell
  and a state byte per row) fits :data:`ONE_CTA_SMEM_BYTES` of shared
  memory: one launch installs, patches, prepares and sweeps to the
  fixpoint inside the block;
* **grid-wide** above that: install, patch and prepare as three launches,
  then sweeps of one thread a row, :data:`SWEEPS_PER_READ` enqueued
  between host reads of their change flags (each returns at once once a
  sweep changed nothing), then the finish.

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
``newly``; with ``never_blocks`` computed once a dispatch, each further
sweep costs a pending row's wait targets and their state bytes.  The
number of sweeps grows with the longest dependency chain the dispatch
completes (a same-key chain finishes up to one link a sweep where the
blocks run side by side, several where one thread walks the chain's rows
in order), so a hot-key feed costs many sweeps: ``last_sweeps`` reports
them.  Design: the wait targets are computed once (``never_blocks``
folded into a -1 target); the one-CTA variant keeps them and the state
bytes in shared memory and needs one launch and no host read; the
grid-wide variant keeps them in device memory, skips non-pending rows
with one byte read, and pays one host read every
:data:`SWEEPS_PER_READ` sweeps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fantoch_tpu_torch.ops import graph_plane_kernels as K

TERMINAL = K.TERMINAL
MISSING = K.MISSING

LAUNCHES: Dict[str, int] = {"pred_plane_step": 0}
# launches by variant (a breakdown of LAUNCHES["pred_plane_step"])
VARIANT_LAUNCHES: Dict[str, int] = {"one_cta": 0, "grid": 0}

# the one-CTA variant's shared-memory gate (the card allows 227 KB of
# dynamic shared memory a block; the rest is slack)
ONE_CTA_SMEM_BYTES = 200 * 1024
# grid-wide sweeps enqueued between two host reads of their flags
SWEEPS_PER_READ = 16

# the last dispatch's sweep count: an int, or the one-CTA variant's device
# counter (read on demand by last_sweeps, so the launch stays asynchronous)
_last_sweeps = {"value": 0}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, VARIANT_LAUNCHES):
        for name in table:
            table[name] = 0


def last_sweeps() -> int:
    """Sweeps the last kernel dispatch ran, the last (unchanging) one
    included."""
    value = _last_sweeps["value"]
    if isinstance(value, torch.Tensor):
        value = int(value.item())
        _last_sweeps["value"] = value
    return value


def one_cta_smem_bytes(cap: int, width: int) -> int:
    """Shared memory of the one-CTA variant: a wait target per dep cell and
    a state byte per row."""
    return cap * width * 4 + cap


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
    state = (deps, clock, src, occ, executed)
    feed = (u_row, u_deps, u_clock, u_src, p_row, p_col, p_val)
    if one_cta_smem_bytes(cap, width) <= ONE_CTA_SMEM_BYTES:
        sweeps = K._i32(1, device, 0)
        K._launch("pp_one_cta", device, *state, *feed, newly, sweeps, cap, width, U, P)
        _last_sweeps["value"] = sweeps
        VARIANT_LAUNCHES["one_cta"] += 1
    else:
        wait = K._i32(cap * width, device)
        st = torch.empty(cap, dtype=torch.uint8, device=device)
        K._launch("pp_grid_prepare", device, *state, *feed, wait, st, cap, width, U, P)
        flags = K._i32(SWEEPS_PER_READ + 1, device)
        total = 0
        while True:
            K._launch("pp_grid_sweeps", device, wait, st, flags, cap, width,
                      SWEEPS_PER_READ)
            host = flags.to("cpu").tolist()
            total += sum(1 for f in host[:SWEEPS_PER_READ] if f)
            if not host[SWEEPS_PER_READ]:
                break
        K._launch("pp_grid_finish", device, st, executed, newly, cap)
        _last_sweeps["value"] = total
        VARIANT_LAUNCHES["grid"] += 1
    LAUNCHES["pred_plane_step"] += 1
    return deps, clock, src, occ, executed, newly
