"""Caesar's two-phase predecessor ordering on tensors.

The port of fantoch_tpu/ops/pred_resolve.py.  A committed command executes
after (phase 1) every dependency is committed and (phase 2) every
LOWER-clock dependency is executed (fantoch_ps/src/executor/pred/
mod.rs:132-186).  Timestamps are unique and totally ordered, so there are
no cycles to collapse.

* :func:`resolve_pred` — one batch, uploaded whole: dependencies are an
  ``int32[B, W]`` row matrix (row indices into the batch, ``TERMINAL`` for
  executed/absent deps, ``MISSING`` for uncommitted ones) and a loop runs
  the monotone fixpoint

      executable(v) = committed(v) and for every dep cell d of v:
                        d is TERMINAL, or executed(d), or clock(d) > clock(v)

  until a round makes no progress; the order is the executed rows sorted
  by (clock, src, seq).  In the reference this is an XLA program, not a
  Pallas kernel: its port is plain torch on the tensors' device.
* :func:`resolve_pred_plane_step` — the resident window step of
  ``executor/pred_plane.DevicePredPlane``: on CUDA tensors the Hopper
  kernels of ``ops/pred_kernels.py``, on CPU tensors their plain version
  :func:`resolve_pred_plane_step_plain`; the same state updated in place
  either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fantoch_tpu_torch.ops import pred_kernels as P
from fantoch_tpu_torch.ops.graph_plane_kernels import MISSING, TERMINAL

__all__ = [
    "MISSING",
    "PredPlaneStep",
    "PredResolution",
    "TERMINAL",
    "resolve_pred",
    "resolve_pred_plane_step",
    "resolve_pred_plane_step_plain",
]

_INT32_MAX = (1 << 31) - 1


class PredResolution(NamedTuple):
    order: torch.Tensor  # int32[B] — executed rows first, (clock, dot) sorted
    executed: torch.Tensor  # bool[B]


def _stable_argsort(keys) -> torch.Tensor:
    """``numpy.lexsort`` order of ``keys`` (the last key primary), by
    successive stable sorts from the least significant key."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def resolve_pred(
    deps: torch.Tensor,  # int32[B, W] row indices / TERMINAL / MISSING
    clock: torch.Tensor,  # int32[B] — committed timestamp (unique with dot)
    dot_src: torch.Tensor,  # int32[B]
    dot_seq: torch.Tensor,  # int32[B]
    committed: torch.Tensor,  # bool[B] — False rows are pads / uncommitted
) -> PredResolution:
    batch = deps.shape[0]
    safe = deps.clamp(0, max(batch - 1, 0)).long()

    # phase 2's lower-clock comparison, precomputed per cell: a dep with a
    # HIGHER (clock, src, seq) never blocks (it executes after us)
    dc, ds, dq = clock[safe], dot_src[safe], dot_seq[safe]
    mc, ms, mq = clock[:, None], dot_src[:, None], dot_seq[:, None]
    dep_higher = (dc > mc) | ((dc == mc) & (ds > ms)) | ((dc == mc) & (ds == ms) & (dq > mq))
    # a dep cell never blocks iff it is TERMINAL or a COMMITTED in-batch dep
    # with a higher key; MISSING and in-batch-uncommitted deps block phase 1
    in_batch = deps >= 0
    dep_committed = in_batch & committed[safe]
    never_blocks = (deps == TERMINAL) | (dep_committed & dep_higher)

    executed = torch.zeros(batch, dtype=torch.bool, device=deps.device)
    while True:
        dep_ok = never_blocks | (dep_committed & executed[safe])
        new = committed & dep_ok.all(dim=1)
        changed = bool((new & ~executed).any())
        executed = new | executed
        if not changed:
            break
    sort_clock = torch.where(executed, clock, torch.full_like(clock, _INT32_MAX))
    order = _stable_argsort((dot_seq, dot_src, sort_clock)).to(torch.int32)
    return PredResolution(order, executed)


class PredPlaneStep(NamedTuple):
    """One resident dispatch's output: the state (updated in place) plus
    which slots executed THIS dispatch.  Execution order among the newly
    executed is (clock, src), computed host-side from the plane's slot
    columns."""

    deps: torch.Tensor  # int32[C, W] — resident slot matrix
    clock: torch.Tensor  # int32[C]
    src: torch.Tensor  # int32[C]
    occ: torch.Tensor  # bool[C] — slot holds a committed command
    executed: torch.Tensor  # bool[C]
    newly: torch.Tensor  # bool[C] — executed by this dispatch


def resolve_pred_plane_step_plain(
    deps, clock, src, occ, executed,
    u_row, u_deps, u_clock, u_src, p_row, p_col, p_val,
) -> PredPlaneStep:
    """The composed body of the reference's ``resolve_pred_plane_step_xla``
    on any device: (1) full-row install of the feed's rows (pad row ``C``
    dropped), (2) dep-cell patches (pad row ``C`` dropped), (3) the
    monotone two-phase fixpoint over the whole window.  The plain version
    of the Hopper kernels."""
    return PredPlaneStep(*P.pred_plane_step_plain(
        deps, clock, src, occ, executed,
        u_row, u_deps, u_clock, u_src, p_row, p_col, p_val,
    ))


def resolve_pred_plane_step(
    deps, clock, src, occ, executed,
    u_row, u_deps, u_clock, u_src, p_row, p_col, p_val,
) -> PredPlaneStep:
    """Route one resident pred-plane dispatch by the tensors' device: CUDA
    tensors launch the kernels of ``ops/pred_kernels.py`` (or raise), CPU
    tensors run the plain version.  The executors and the twin replay all
    call through here."""
    return PredPlaneStep(*P.pred_plane_step(
        deps, clock, src, occ, executed,
        u_row, u_deps, u_clock, u_src, p_row, p_col, p_val,
    ))
