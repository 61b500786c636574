"""Hopper kernels of the graph-plane step, with their plain versions.

These replace the TPU kernel ``graph_plane_step_pallas``
(fantoch_tpu/ops/pallas_resolve.py:334, body ``_graph_step_kernel`` :297,
tracing ``graph_plane_step_core`` in fantoch_tpu/ops/graph_resolve.py:883)
in all three of its modes.  On the TPU that kernel is one program resident
in VMEM; on an H100 the step is a chain of launches composed by
``ops/graph_resolve.py``: the ``keyed`` mode's stages (2-8) from
``csrc/graph_plane_step.cu``; the prologue of every mode (1, §13 there)
and the ``general`` and ``general_resident`` modes' stages (9-12) from
``csrc/graph_general.cu``.

Every stage below is one wrapper with three things beside it:

* a plain PyTorch version (``<stage>_plain``) of the same function, which
  the wrapper runs for CPU tensors and ``chip_smoke.py`` holds the kernel
  against on the card;
* a launch counter (``LAUNCHES[<stage>]``), raised by one where the wrapper
  launches its kernels and nowhere else;
* a note naming what bounds the kernel on this card and what its design
  does about that.

A wrapper given CUDA tensors launches its kernels or raises; it never falls
back to the plain version.  All work is int32/bool, so kernel and plain
version agree bit for bit.

Preconditions the plane guarantees (and the plain prologue asserts): the
non-pad install rows of one dispatch are distinct, and so are the non-pad
patch cells — scatter order with duplicate indices is undefined in the
reference too.  Pad index ``C`` (or any index outside ``[0, C)``) is
masked, never written: the reference's ``mode="drop"``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

TERMINAL = -1
MISSING = -2
INT32_MAX = (1 << 31) - 1
# packed emit key of the final sort: (unresolved << 30) | target position
EMIT_UNRESOLVED_BIT = 1 << 30

LAUNCHES: Dict[str, int] = {
    "graph_prologue": 0,
    "lex_sort": 0,
    "link_scan": 0,
    "residual_view": 0,
    "group_scan": 0,
    "pointer_doubling": 0,
    "emit_scatter": 0,
    "plane_epilogue": 0,
    "mutual_collapse": 0,
    "affine_loop": 0,
    "peel_stage": 0,
    "peel_compact": 0,
}
# the wrappers of the general modes, each in csrc/graph_general.cu
GENERAL_KERNELS = ("mutual_collapse", "affine_loop", "peel_stage", "peel_compact")
# the loop kernels, each raising a device int by the rounds it runs
LOOP_KERNELS = ("affine_loop", "peel_stage")
_round_totals: Dict[Tuple[str, str], torch.Tensor] = {}
# slot sentinel of resolve_general_resident's compaction: a dep whose
# target was cut at a fixpoint compaction (fantoch_tpu/ops/graph_resolve.py
# :729); only ever created after the publish gate closed
FROZEN = -3


def reset_launch_counts() -> None:
    """Zero the launch counts and the loop kernels' round totals."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    _round_totals.clear()


def num_doubling_steps(batch: int) -> int:
    """Steps so that 2^L >= 2*batch: a walk of 2^L hops from any vertex of a
    non-terminating component has fully wrapped its cycle at least once."""
    steps = 1
    while (1 << steps) < 2 * max(batch, 2):
        steps += 1
    return steps


# ---------------------------------------------------------------------------
# ctypes plumbing
# ---------------------------------------------------------------------------


# the C launchers: library (csrc/<library>.cu) and signature, "p" a device
# pointer, "i" an int; every launcher takes the stream last and returns
# cudaError_t
_SIGNATURES = {
    "gp_lex_sort": ("graph_plane_step", "p" * 11 + "i" * 10),
    "gp_link_scan": ("graph_plane_step", "p" * 8 + "i"),
    "gp_residual_view": ("graph_plane_step", "p" * 13 + "iii"),
    "gp_group_scan": ("graph_plane_step", "pppp" + "i"),
    "gp_pointer_doubling": ("graph_plane_step", "p" * 7 + "ii"),
    "gp_emit_scatter": ("graph_plane_step", "p" * 8 + "iii"),
    "gp_epilogue": ("graph_plane_step", "p" * 5 + "i"),
    "gg_prologue": ("graph_general", "p" * 17 + "i" * 7),
    "gg_mutual_collapse": ("graph_general", "p" * 7 + "i" * 5),
    "gg_affine_loop": ("graph_general", "p" * 12 + "i" * 5),
    "gg_peel_stage": ("graph_general", "p" * 14 + "i" * 5),
    "gg_peel_compact": ("graph_general", "p" * 19 + "iiiii"),
    # an empty kernel: the launch floor chip_smoke.py times
    "gg_empty": ("graph_general", ""),
    # the votes-table plane's launchers (wrappers in ops/table_kernels.py)
    "tp_clock_proposal": ("table_plane", "p" * 7 + "i"),
    "tp_clock_bump": ("table_plane", "ppp" + "i"),
    "tp_votes_gid": ("table_plane", "pppp" + "iii"),
    "tp_vote_runs": ("table_plane", "p" * 14 + "ii"),
    "tp_stable_only": ("table_plane", "pp" + "iii"),
    "tp_stable_rows": ("table_plane", "p" * 9 + "i" * 5),
    # the predecessors plane's launchers (wrapper in ops/pred_kernels.py)
    "pp_one_cta": ("pred_plane", "p" * 14 + "iiii"),
    "pp_grid_prepare": ("pred_plane", "p" * 14 + "iiii"),
    "pp_grid_sweeps": ("pred_plane", "ppp" + "iii"),
    "pp_grid_finish": ("pred_plane", "ppp" + "i"),
}
_lib_handles: Dict[str, ctypes.CDLL] = {}


def _lib(name: str):
    lib = _lib_handles.get(name)
    if lib is None:
        from fantoch_tpu_torch.ops import _build

        lib = _build.load(name)
        for fn_name, (lib_name, sig) in _SIGNATURES.items():
            if lib_name == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = [
                    ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig
                ] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _lib_handles[name] = lib
    return lib


def _on_card(tensor: torch.Tensor) -> bool:
    """Whether a wrapper given ``tensor`` takes its kernel route."""
    return tensor.is_cuda


def _stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``: the raw handle
    PyTorch's generated kernels launch on (``torch.cuda.current_stream``
    would build a Stream object a call, most of a small launch's host
    time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call one C launcher on the current stream; it returns
    ``cudaGetLastError()`` after its launches, and a refused launch raises
    here (``torch.cuda.synchronize`` would never report it)."""
    lib_name, sig = _SIGNATURES[fn]
    assert len(args) == len(sig), (fn, len(args), len(sig))
    stream = _stream(device)
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(_lib(lib_name), fn)(*values, stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed with error {err}")


def _check(tensor: torch.Tensor, dtype: torch.dtype, name: str, numel=None) -> None:
    if not _on_card(tensor):
        raise ValueError(f"{name} must be a CUDA tensor (got {tensor.device})")
    if tensor.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {tensor.dtype})")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and tensor.numel() != numel:
        raise ValueError(f"{name} must hold {numel} elements (got {tensor.numel()})")


def _i32(n: int, device, fill: Optional[int] = None) -> torch.Tensor:
    if fill is None:
        return torch.empty(n, dtype=torch.int32, device=device)
    return torch.full((n,), fill, dtype=torch.int32, device=device)


def _b(n: int, device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# 1. prologue: install + patch + executed marks, then fold + keyed compress
#    (or, for the general modes, fold + the backward-only fast-path count)
# ---------------------------------------------------------------------------
# Bound: bytes.  One pass over the int32[C, W] dep matrix (read for the
# fold) plus the key/occ/executed columns and the col/pk outputs (the
# dmat matrix and one count in the general variant); installs and patches
# are scattered writes of U and P cells.  Order: install, then patches and
# marks, then the per-row fold that reads ``executed`` of the dep targets
# once every mark has landed (the reference's order when a dispatch patches
# or marks a row it also installs).  Design (``csrc/graph_general.cu``
# §13): each step one device function both modes share, installs a cell a
# thread.  General: one cooperative launch a dispatch, the steps split by
# grid barriers, the fold a cell a thread; the count of cells that bar
# ``resolve_general``'s fast path is a warp sum and a shared-memory sum a
# block, added once a block into the device int the host reads once per
# dispatch; no zero-fill launch.  Keyed: three launches (install, patches
# and marks, fold and compression a row a thread), which beat one
# cooperative launch at the keyed path's 2^20 slots (the source's §13 has
# the numbers).


def graph_prologue_plain(
    deps, key, src, seq, occ, executed,
    u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
    general: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Updates the resident state in place.  ``keyed``: returns the keyed
    dependency column ``col[C]`` and the run keys ``pk[C]`` (pending rows
    keep their key, non-pending rows get the private pad key
    ``INT32_MAX - idx``).  ``general``: returns the folded, masked
    ``dmat[C, W]`` (graph_resolve.py:941-946) and ``n_bad int32[1]``, the
    cells that bar ``resolve_general``'s fast path once self-dependencies
    are pruned: a forward dependency or a MISSING one."""
    cap, width = deps.shape
    m = (u_row >= 0) & (u_row < cap)
    rows = u_row[m].long()
    assert torch.unique(rows).numel() == rows.numel(), "duplicate install row"
    deps[rows] = u_deps[m]
    key[rows] = u_key[m]
    src[rows] = u_src[m]
    seq[rows] = u_seq[m]
    occ[rows] = True
    executed[rows] = False
    m = (p_row >= 0) & (p_row < cap) & (p_col >= 0) & (p_col < width)
    cells = p_row[m].long() * width + p_col[m].long()
    assert torch.unique(cells).numel() == cells.numel(), "duplicate patch cell"
    deps.view(-1)[cells] = p_val[m]
    m = (e_row >= 0) & (e_row < cap)
    executed[e_row[m].long()] = True

    pending = occ & ~executed
    safe = deps.clamp(0, cap - 1).long()
    dmat = torch.where((deps >= 0) & executed[safe], TERMINAL, deps)
    dmat = torch.where(pending[:, None], dmat, TERMINAL).to(torch.int32)
    idx = torch.arange(cap, dtype=torch.int32, device=deps.device)
    if general:
        bad = (dmat > idx[:, None]) | (dmat == MISSING)
        return dmat, bad.sum().to(torch.int32).reshape(1)
    live = dmat >= 0
    first = live.to(torch.int32).argmax(dim=1, keepdim=True)
    col = dmat.gather(1, first)[:, 0]
    col = torch.where(
        live.any(dim=1),
        col,
        torch.where((dmat == MISSING).any(dim=1), MISSING, TERMINAL),
    ).to(torch.int32)
    pk = torch.where(pending, key, INT32_MAX - idx).to(torch.int32)
    return col, pk


def graph_prologue(
    deps, key, src, seq, occ, executed,
    u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
    general: bool = False,
):
    if not _on_card(deps):
        return graph_prologue_plain(
            deps, key, src, seq, occ, executed,
            u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row,
            general,
        )
    cap, width = deps.shape
    U, P, E = u_row.numel(), p_row.numel(), e_row.numel()
    _check(deps, torch.int32, "deps")
    for name, t in (("key", key), ("src", src), ("seq", seq)):
        _check(t, torch.int32, name, cap)
    _check(occ, torch.bool, "occ", cap)
    _check(executed, torch.bool, "executed", cap)
    _check(u_deps, torch.int32, "u_deps", U * width)
    for name, t in (("u_row", u_row), ("u_key", u_key), ("u_src", u_src),
                    ("u_seq", u_seq)):
        _check(t, torch.int32, name, U)
    for name, t in (("p_row", p_row), ("p_col", p_col), ("p_val", p_val)):
        _check(t, torch.int32, name, P)
    _check(e_row, torch.int32, "e_row", E)
    state = (deps, key, src, seq, occ, executed,
             u_row, u_deps, u_key, u_src, u_seq, p_row, p_col, p_val, e_row)
    if general:  # the folded matrix and the bad-cell count
        out = (torch.empty((cap, width), dtype=torch.int32, device=deps.device),
               _i32(1, deps.device))
    else:  # the keyed column and the run keys
        out = (_i32(cap, deps.device), _i32(cap, deps.device))
    _launch("gg_prologue", deps.device, *state, *out, cap, width, U, P, E, int(general),
            _loop_block(cap))
    LAUNCHES["graph_prologue"] += 1
    return out


# ---------------------------------------------------------------------------
# 2. stable lexicographic sort over up to 8 int32/bool columns
# ---------------------------------------------------------------------------
# Bound: bytes — each key column read once and the permutation written
# once.  Design: an LSD radix sort of (key digit, position) pairs, columns
# from the last key to the first, replacing the first version's bitonic
# network (55 launches over padded 64-bit words at 2^20, each moving the
# whole array).
# A column's first digit pass reads its key through the running
# permutation; int32 keys are biased to sort as signed and take four 8-bit
# passes, a bool key one 1-bit pass.  A pass is stable by construction, so
# the index is the last key without being stored, and nothing is padded.
# Above ``RADIX_SMALL_N`` elements a pass is three launches (tile
# histograms, the digit-major scan of the counts, the stable scatter: warp
# ballots rank a tile, which is sorted in shared memory and written out in
# order), so 1 int32 key is 12 launches moving ~20 bytes an element a
# pass; the first pass of a column also ORs its keys, and the later passes
# whose digit every key shares return at once (no host read), which skips
# one to three passes of the small keys most columns hold.  Up to
# ``RADIX_SMALL_N`` elements one block sorts every column in shared memory
# in one launch.  No block waits on another.

# mirror csrc/graph_plane_step.cu
RADIX_TILE = 2048
RADIX_BINS = 256
RADIX_SMALL_N = 4096
LEX_MAX_KEYS = 8
_LEX_KIND = {torch.int32: 0, torch.bool: 1}


def lex_sort_plain(
    keys: Sequence[torch.Tensor],
    invert: Sequence[bool] = (),
    through: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The stable lexicographic argsort (``keys[0]`` most significant, the
    index last) as int32; bool keys may be ``invert``-ed (sort ``~k``);
    with ``through`` the result is ``through[perm]``."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    flips = list(invert) + [False] * (len(keys) - len(invert))
    for k, flip in zip(reversed(list(keys)), reversed(flips)):
        kk = k[perm]
        if kk.dtype == torch.bool:
            kk = (~kk if flip else kk).to(torch.int32)
        perm = perm[torch.sort(kk, stable=True).indices]
    if through is not None:
        return through[perm].to(torch.int32)
    return perm.to(torch.int32)


def lex_sort(
    keys: Sequence[torch.Tensor],
    invert: Sequence[bool] = (),
    through: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if not _on_card(keys[0]):
        return lex_sort_plain(keys, invert, through)
    if not 1 <= len(keys) <= LEX_MAX_KEYS:
        raise ValueError(f"lex_sort takes 1..{LEX_MAX_KEYS} key columns")
    n = keys[0].numel()
    device = keys[0].device
    kinds = []
    for i, k in enumerate(keys):
        if k.dtype not in _LEX_KIND:
            raise ValueError(f"lex_sort keys must be int32 or bool, got {k.dtype}")
        _check(k, k.dtype, "sort key", n)
        flip = i < len(invert) and invert[i]
        kinds.append(_LEX_KIND[k.dtype] + (1 if flip and k.dtype == torch.bool else 0))
    if through is not None:
        _check(through, torch.int32, "through", n)
    out = _i32(n, device)
    scratch = None
    if n > RADIX_SMALL_N:
        tiles = -(-n // RADIX_TILE)
        scratch = _i32(6 * n + RADIX_BINS * (tiles + 1) + 2 * LEX_MAX_KEYS, device)
    pad = LEX_MAX_KEYS - len(keys)
    _launch(
        "gp_lex_sort", device, *keys, *([None] * pad), through, out, scratch,
        *kinds, *([0] * pad), len(keys), n,
    )
    LAUNCHES["lex_sort"] += 1
    return out


# ---------------------------------------------------------------------------
# 3. link scan: run heads, link check, run_start/lastbad cummax, chain_ok
# ---------------------------------------------------------------------------
# Bound: bytes (gathers of pk/col through the sort permutation, then two
# streaming scans).  Design: block-wide Hillis-Steele max scans in shared
# memory with carried block totals (reduce, one-block carry scan, apply);
# the residual count is a warp-reduced atomicAdd, exact for integers.


def link_scan_plain(pk, col, pos_s):
    """Returns (dep_s, run_start, chain_ok, n_residual int32[1])."""
    n = pk.shape[0]
    pl = pos_s.long()
    k_s = pk[pl]
    dep_s = col[pl]
    p = torch.arange(n, dtype=torch.int32, device=pk.device)
    head = torch.ones(n, dtype=torch.bool, device=pk.device)
    head[1:] = k_s[1:] != k_s[:-1]
    prev_pos = torch.roll(pos_s, 1)
    ok = torch.where(head, dep_s == TERMINAL, dep_s == prev_pos)
    run_start = torch.cummax(torch.where(head, p, 0), 0).values.to(torch.int32)
    lastbad = torch.cummax(torch.where(~ok, p, -1), 0).values
    chain_ok = lastbad < run_start
    n_residual = (n - chain_ok.sum()).to(torch.int32).reshape(1)
    return dep_s.to(torch.int32), run_start, chain_ok, n_residual


def link_scan(pk, col, pos_s):
    if not _on_card(pk):
        return link_scan_plain(pk, col, pos_s)
    n = pk.numel()
    for name, t in (("pk", pk), ("col", col), ("pos_s", pos_s)):
        _check(t, torch.int32, name, n)
    device = pk.device
    dep_s = _i32(n, device)
    run_start = _i32(n, device)
    chain_ok = _b(n, device)
    n_residual = _i32(1, device, 0)
    scratch = _i32(2 * n + 4 * _blocks(n), device)
    _launch(
        "gp_link_scan", device, pk, col, pos_s, dep_s, run_start, chain_ok,
        n_residual, scratch, n,
    )
    LAUNCHES["link_scan"] += 1
    return dep_s, run_start, chain_ok, n_residual


def _blocks(n: int) -> int:
    return max(1, (n + 1023) // 1024)


# ---------------------------------------------------------------------------
# 4. residual view: gathers of the compacted residual + local dep remap
# ---------------------------------------------------------------------------
# Bound: bytes (res_n-row gathers, a C-row remap fill).  Design: one
# gather launch that also scatters ``remap[rpos] = r`` (residual positions
# are distinct), then one launch for the local deps once the remap landed.


def residual_view_plain(p_r, pos_s, dep_s, run_start, src, seq, n_residual: int):
    """Returns (rpos, rrs, rsrc, rseq, rdep_local) over the res_n rows."""
    batch = pos_s.shape[0]
    res_n = p_r.shape[0]
    device = p_r.device
    r_iota = torch.arange(res_n, dtype=torch.int32, device=device)
    valid = r_iota < n_residual
    prl = p_r.long()
    rpos = pos_s[prl]
    rdep = dep_s[prl]
    rrs = torch.where(valid, run_start[prl], INT32_MAX).to(torch.int32)
    rsrc = src[rpos.long()]
    rseq = seq[rpos.long()]
    remap = torch.full((batch,), TERMINAL, dtype=torch.int32, device=device)
    remap[rpos[valid].long()] = r_iota[valid]
    local = torch.where(rdep >= 0, remap[rdep.clamp(0, batch - 1).long()], rdep)
    rdep_local = torch.where(valid, local, TERMINAL).to(torch.int32)
    return rpos, rrs, rsrc, rseq, rdep_local


def residual_view(p_r, pos_s, dep_s, run_start, src, seq, n_residual: int):
    if not _on_card(p_r):
        return residual_view_plain(p_r, pos_s, dep_s, run_start, src, seq, n_residual)
    batch, res_n = pos_s.numel(), p_r.numel()
    device = p_r.device
    _check(p_r, torch.int32, "p_r", res_n)
    for name, t in (("pos_s", pos_s), ("dep_s", dep_s), ("run_start", run_start),
                    ("src", src), ("seq", seq)):
        _check(t, torch.int32, name, batch)
    rpos, rrs, rsrc, rseq, rdep_local = (_i32(res_n, device) for _ in range(5))
    scratch = _i32(res_n, device)
    remap = _i32(batch, device, TERMINAL)
    _launch(
        "gp_residual_view", device, p_r, pos_s, dep_s, run_start, src, seq,
        rpos, rrs, rsrc, rseq, rdep_local, scratch, remap, res_n, batch,
        min(n_residual, INT32_MAX),
    )
    LAUNCHES["residual_view"] += 1
    return rpos, rrs, rsrc, rseq, rdep_local


# ---------------------------------------------------------------------------
# 5. group scan: residual groups, firstbad cummax, emit targets
# ---------------------------------------------------------------------------
# Bound: bytes (three res_n-row int32 streams in, one out).  Design: the
# link scan's block max-scan machinery at residual scale.


def group_scan_plain(rrs, p_r):
    """target_r = firstbad + emit_local over the residual rows."""
    m = rrs.shape[0]
    r = torch.arange(m, dtype=torch.int32, device=rrs.device)
    g_head = torch.ones(m, dtype=torch.bool, device=rrs.device)
    g_head[1:] = rrs[1:] != rrs[:-1]
    firstbad = torch.cummax(torch.where(g_head, p_r, 0), 0).values
    emit_local = r - torch.cummax(torch.where(g_head, r, 0), 0).values
    return (firstbad + emit_local).to(torch.int32)


def group_scan(rrs, p_r):
    if not _on_card(rrs):
        return group_scan_plain(rrs, p_r)
    m = rrs.numel()
    _check(rrs, torch.int32, "rrs", m)
    _check(p_r, torch.int32, "p_r", m)
    target = _i32(m, rrs.device)
    scratch = _i32(2 * m + 4 * _blocks(m), rrs.device)
    _launch("gp_group_scan", rrs.device, rrs, p_r, target, scratch, m)
    LAUNCHES["group_scan"] += 1
    return target


# ---------------------------------------------------------------------------
# 6. pointer doubling: _doubling_core (fantoch_tpu/ops/graph_resolve.py:96)
# ---------------------------------------------------------------------------
# Bound: bytes — but the gathers are random, so it runs at the card's
# gather rate, not its streaming rate.  Design: one ping-pong launch per
# doubling step (pointer jumping in place within one launch races), the
# jump of every step kept for the cycle closure, whose scatter
# ``.at[hop].max`` is an atomicOr into a zeroed flag column merged by a
# second launch.  About 4 * log2(2n) launches.


def pointer_doubling_plain(dep):
    """(resolved, rank, leader, on_cycle): exact for any out-degree-<=1
    graph over ``dep[n]`` (TERMINAL/MISSING sentinels)."""
    n = dep.shape[0]
    device = dep.device
    idx = torch.arange(n, dtype=torch.int32, device=device)
    steps = num_doubling_steps(n)
    is_term = dep == TERMINAL
    is_miss = dep == MISSING
    absorbing = is_term | is_miss
    jump = torch.where(absorbing, idx, dep)
    acc = torch.where(absorbing, n, jump).to(torch.int32)
    jumps_log = []
    for _ in range(steps):
        jumps_log.append(jump)
        jl = jump.long()
        acc = torch.minimum(acc, acc[jl])
        jump = jump[jl]
    end = jump.long()
    nonterminating = ~(is_term[end] | is_miss[end])
    cyc_leader = acc[end]
    on_cycle = nonterminating & (idx == cyc_leader)
    for hop in jumps_log:
        contrib = torch.zeros(n, dtype=torch.int32, device=device)
        contrib.index_add_(0, hop.long(), on_cycle.to(torch.int32))
        on_cycle = on_cycle | ((contrib > 0) & nonterminating)
    absorbing2 = absorbing | on_cycle
    jump2 = torch.where(absorbing2, idx, dep)
    dist2 = torch.where(absorbing2, 0, 1).to(torch.int32)
    for _ in range(steps):
        jl = jump2.long()
        dist2 = dist2 + dist2[jl]
        jump2 = jump2[jl]
    j2 = jump2.long()
    resolved = on_cycle | is_term[j2] | on_cycle[j2]
    rank = torch.where(resolved, dist2, INT32_MAX).to(torch.int32)
    leader = torch.where(on_cycle, cyc_leader, idx).to(torch.int32)
    return resolved, rank, leader, on_cycle


def pointer_doubling(dep):
    if not _on_card(dep):
        return pointer_doubling_plain(dep)
    n = dep.numel()
    _check(dep, torch.int32, "dep", n)
    device = dep.device
    steps = num_doubling_steps(n)
    resolved, on_cycle = _b(n, device), _b(n, device)
    rank, leader = _i32(n, device), _i32(n, device)
    # jumps of every step (the closure's hops) + 8 work columns
    scratch = _i32((steps + 1) * n + 8 * n, device)
    flags = torch.zeros(2 * n, dtype=torch.int32, device=device)
    _launch(
        "gp_pointer_doubling", device, dep, resolved, rank, leader, on_cycle,
        scratch, flags, n, steps,
    )
    LAUNCHES["pointer_doubling"] += 1
    return resolved, rank, leader, on_cycle


# ---------------------------------------------------------------------------
# 7. emit scatter: residual emit data back over the batch, packed sort key
# ---------------------------------------------------------------------------
# Bound: bytes (one C-row stream for the packed key, res_n-row scatter).
# Design: an init launch over C, then the residual scatter (the emit
# targets of one group are a permutation of its positions, so no two
# threads write one cell).


def emit_scatter_plain(e, p_r, l_resolved, target_r, chain_ok, n_residual: int):
    """Returns (packed int32[C], resolved_b bool[C], n_unresolved int32[1])
    in sorted space."""
    batch = chain_ok.shape[0]
    res_n = e.shape[0]
    device = e.device
    el = e.long()
    e_p_r = p_r[el]
    e_res = l_resolved[el]
    valid = torch.arange(res_n, device=device) < n_residual
    tgt_b = torch.arange(batch, dtype=torch.int32, device=device)
    tgt_b[e_p_r[valid].long()] = target_r[valid]
    res_b = chain_ok.clone()
    res_b[e_p_r[valid].long()] = e_res[valid]
    packed = torch.where(res_b, 0, EMIT_UNRESOLVED_BIT).to(torch.int32) | tgt_b
    n_unres = (batch - res_b.sum()).to(torch.int32).reshape(1)
    return packed, res_b, n_unres


def emit_scatter(e, p_r, l_resolved, target_r, chain_ok, n_residual: int):
    if not _on_card(e):
        return emit_scatter_plain(e, p_r, l_resolved, target_r, chain_ok, n_residual)
    batch, res_n = chain_ok.numel(), e.numel()
    device = e.device
    for name, t in (("e", e), ("p_r", p_r), ("target_r", target_r)):
        _check(t, torch.int32, name, res_n)
    _check(l_resolved, torch.bool, "l_resolved", res_n)
    _check(chain_ok, torch.bool, "chain_ok", batch)
    packed = _i32(batch, device)
    res_b = _b(batch, device)
    n_unres = _i32(1, device, 0)
    _launch(
        "gp_emit_scatter", device, e, p_r, l_resolved, target_r, chain_ok,
        packed, res_b, n_unres, res_n, batch, min(n_residual, INT32_MAX),
    )
    LAUNCHES["emit_scatter"] += 1
    return packed, res_b, n_unres


# ---------------------------------------------------------------------------
# 8. epilogue: per-vertex resolved flag, newly, executed |= newly
# ---------------------------------------------------------------------------
# Bound: bytes (one C-row pass).  Design: ``flag_perm`` is a permutation,
# so each vertex is written by exactly one thread and one launch suffices.


def plane_epilogue_plain(occ, executed, flags=None, flag_perm=None):
    """``resolved_v[flag_perm[p]] = flags[p]`` (identity perm when None,
    all resolved when ``flags`` is None); returns ``newly`` and sets
    ``executed |= newly`` in place."""
    if flags is None:
        resolved_v = torch.ones_like(occ)
    elif flag_perm is None:
        resolved_v = flags
    else:
        resolved_v = torch.empty_like(occ)
        resolved_v[flag_perm.long()] = flags
    newly = resolved_v & occ & ~executed
    executed |= newly
    return newly


def plane_epilogue(occ, executed, flags=None, flag_perm=None):
    if not _on_card(occ):
        return plane_epilogue_plain(occ, executed, flags, flag_perm)
    n = occ.numel()
    _check(occ, torch.bool, "occ", n)
    _check(executed, torch.bool, "executed", n)
    if flags is not None:
        _check(flags, torch.bool, "flags", n)
    if flag_perm is not None:
        _check(flag_perm, torch.int32, "flag_perm", n)
    newly = _b(n, occ.device)
    _launch("gp_epilogue", occ.device, occ, executed, flags, flag_perm, newly, n)
    LAUNCHES["plane_epilogue"] += 1
    return newly


# ---------------------------------------------------------------------------
# the general modes (csrc/graph_general.cu): resolve_general's mutual-edge
# collapse and affine-max rounds, resolve_general_resident's peel rounds
# and compactions (fantoch_tpu/ops/graph_resolve.py:467-1177)
# ---------------------------------------------------------------------------


def _amax_into(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[index].max(values)``: a scatter-max into zeros."""
    out = torch.zeros(n, dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(0, index.long(), values.to(torch.int32), "amax")


# ---------------------------------------------------------------------------
# 9. mutual collapse: SCCs joined by mutual edges (graph_resolve.py:1058-1077)
# ---------------------------------------------------------------------------
# Bound: bytes — the back test reads each live target's W cells, then each
# step gathers the leader of every mutual neighbour; the gathers are
# random, and at the sims' windows (1,024 rows) the launch, not the bytes,
# bounds it.  Design (``csrc/graph_general.cu`` §9): one launch a resolve,
# three phases — the back test as a bitmask a row, then
# ``num_doubling_steps(B)`` steps of ``leader = min(leader, nbr_min)`` and
# ``leader = min(leader, leader[leader])``, each line reading the whole
# column the line before wrote, as the reference's lines do (an in-place
# asynchronous update converges differently within a fixed number of
# steps), a barrier after each line; then the retarget through the
# leaders, which drops intra-SCC edges, seeds the affine state (add,
# missing) and counts members with atomics.  A step is a function of the
# leader column alone, so the steps stop after the first that changes no
# leader.  Up to ``CTA_ROWS`` rows one CTA runs it, the two leader
# columns, the counts and the masks in dynamic shared memory (32 KB at
# 2,048 rows, W <= 32) and the changed flag a ``__syncthreads_or``; above,
# a cooperative launch with grid barriers and the changed flag in a
# three-slot ring, as the affine loop's.  No memset, no host read.

def _mutual_leaders(deps, count_steps=False):
    """The min-label loop of the collapse: ``(deps with self-deps pruned,
    valid, safe targets, leader, steps)``, where ``steps`` is how many of the
    ``num_doubling_steps(B)`` steps changed a leader (counted with a host
    read a step only when ``count_steps``, else 0)."""
    batch = deps.shape[0]
    idx = torch.arange(batch, dtype=torch.int32, device=deps.device)
    deps = torch.where(deps == idx[:, None], TERMINAL, deps)
    valid = deps >= 0
    safe = torch.where(valid, deps, 0).long()
    back = (deps[safe] == idx[:, None, None]).any(dim=-1) & valid
    leader, steps = idx, 0
    for _ in range(num_doubling_steps(batch)):
        nbr_min = torch.where(back, leader[safe], batch).min(dim=-1).values
        new = torch.minimum(leader, nbr_min.to(torch.int32))
        new = torch.minimum(new, new[new.long()])
        if count_steps:
            steps += bool((new != leader).any())
        leader = new
    return deps, valid, safe, leader, steps


def mutual_collapse_steps(deps) -> int:
    """How many steps of the collapse's min-label loop change a leader, of
    the ``num_doubling_steps(B)`` the reference runs: the kernel stops after
    the first that changes none (for ``chip_smoke.py`` and the tests)."""
    return _mutual_leaders(deps, count_steps=True)[-1]


def mutual_collapse_plain(deps):
    """``deps int32[B, W]`` (TERMINAL/MISSING sentinels, self-deps not yet
    pruned) -> ``(leader int32[B], tgt int32[B, W], add int32[B, W],
    missing bool[B], member_count int32[B])``: the mutual-edge SCC
    leaders, the deps retargeted through them with intra-SCC edges
    dropped, and the affine rounds' initial ``add``/``missing``."""
    batch = deps.shape[0]
    device = deps.device
    deps, valid, safe, leader, _steps = _mutual_leaders(deps)
    tgt = torch.where(valid, leader[safe], deps)
    tgt = torch.where(valid & (tgt == leader[:, None]), TERMINAL, tgt).to(torch.int32)
    add = (tgt >= 0).to(torch.int32)
    missing = (tgt == MISSING).any(dim=-1)
    member_count = torch.zeros(batch, dtype=torch.int32, device=device)
    member_count.index_add_(0, leader.long(), torch.ones_like(leader))
    return leader, tgt, add, missing, member_count


def mutual_collapse(deps):
    if not _on_card(deps):
        return mutual_collapse_plain(deps)
    batch, width = deps.shape
    device = deps.device
    _check(deps, torch.int32, "deps", batch * width)
    leader = _i32(batch, device)
    tgt = torch.empty_like(deps)
    add = torch.empty_like(deps)
    missing = _b(batch, device)
    member_count = _i32(batch, device)
    # cooperative: the second leader column, three changed slots and the
    # back masks (one word per 32 slots a row)
    scratch = None
    if batch > CTA_ROWS:
        scratch = _i32(batch + 3 + batch * -(-width // 32), device)
    _launch(
        "gg_mutual_collapse", device, deps, leader, tgt, add, missing,
        member_count, scratch, batch, width, num_doubling_steps(batch),
        CTA_ROWS, _loop_block(batch),
    )
    LAUNCHES["mutual_collapse"] += 1
    return leader, tgt, add, missing, member_count


# ---------------------------------------------------------------------------
# 10. affine loop: every round of resolve_general's while_loop
#     (graph_resolve.py:1089-1164) and the SCC fold (:1166-1176), one launch
#     a resolve
# ---------------------------------------------------------------------------
# Replaces the reference's ``while_loop`` and fold as mode ``general`` of
# graph_plane_step_pallas (fantoch_tpu/ops/pallas_resolve.py:334) runs them,
# with no host round-trip inside the loop.  Bound: bytes at 3.35 TB/s of
# what the rounds need — the inputs read once; each later round reads every
# row's targets and floors, the adds of live cells and the
# missing/leader/member columns; each round writes the cells that change
# (the aggregate and composition columns are the round's own scratch); the
# fold reads tgt/floor/missing/leader and writes resolved/rank/stuck
# (``chip_smoke.py`` counts it on the plain rounds).  Design: the whole loop
# in one launch.  A round is three phases with a barrier between them: zero
# the four leader-indexed aggregate columns; build them (integer
# atomicMax/Add/Or, exact in any order) and the composition columns (a
# singleton SCC's one live slot); update each row.  The update reads other
# rows only through those columns, so the state is updated in place (a row's
# cells loaded four at a time before any is stored; after round 0, only the
# cells that change are written) and each round still sees the whole state
# the round before it left.  Up to ``CTA_ROWS`` rows one CTA of up to
# 1,024 threads runs it, the six columns in dynamic shared memory (48 KB at
# 2,048 rows) and the changed flag a ``__syncthreads_or``.  Above, a
# cooperative launch clamped to the co-resident grid runs the same rounds
# with the columns in global scratch, grid barriers, and the changed flag an
# atomicOr into a slot rotated by round.  Scratch is allocated once a
# resolve; there is no memset and no host read; the rounds run land in a
# device int.

# the one-CTA gate of the mutual collapse and the affine loop, at the
# crossover chip_smoke.py measures (both forms on the same calls): one CTA
# was faster at 1,024 and 2,048 rows, the cooperative form (more SMs) at
# mode general's 4,096-row window
CTA_ROWS = 2048
# threads a block of the cooperative launches (a multiple of 32)
LOOP_BLOCK = 512


def _round_total(name: str, device) -> torch.Tensor:
    """The int32[1] on ``device`` that ``name``'s kernel raises by the rounds
    it runs."""
    key = (name, str(device))
    total = _round_totals.get(key)
    if total is None:
        total = _round_totals[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return total


def round_totals() -> Dict[str, int]:
    """Rounds the loop kernels ran since the last ``reset_launch_counts``, by
    wrapper: a host read, for ``chip_smoke.py`` and the tests only."""
    out = {name: 0 for name in LOOP_KERNELS}
    for (name, _device), total in _round_totals.items():
        out[name] += int(total.item())
    return out


def _loop_block(rows: int) -> int:
    """Threads a block of a cooperative loop over ``rows`` rows: LOOP_BLOCK,
    or the least power of two (at least a warp) that holds every row."""
    if LOOP_BLOCK <= 0 or LOOP_BLOCK % 32:
        raise ValueError(f"LOOP_BLOCK must be a positive multiple of 32 (got {LOOP_BLOCK})")
    block = 32
    while block < rows and block < LOOP_BLOCK:
        block *= 2
    return min(block, LOOP_BLOCK)


def affine_round_plain(tgt, add, floor, missing, leader, member_count, *, final=False):
    """One round (the loop's body): returns ``(tgt, add, floor, missing,
    changed int32[1])`` as new tensors.  ``final=True``: the fold, returns
    ``(resolved bool[B], rank int32[B], stuck bool[B])``."""
    batch = tgt.shape[0]
    device = tgt.device
    lead = leader.long()
    if final:
        live = tgt >= 0
        fin = (live.sum(dim=-1) == 0) & ~missing
        vrank = floor.max(dim=-1).values
        scc_rank = _amax_into(batch, lead, torch.where(fin, vrank, 0))
        scc_final = _amax_into(batch, lead, ~fin) == 0
        scc_missing = _amax_into(batch, lead, missing) > 0
        resolved = scc_final[lead] & ~scc_missing[lead]
        rank = torch.where(resolved, scc_rank[lead], INT32_MAX).to(torch.int32)
        stuck = ~resolved & ~(missing | scc_missing[lead])
        return resolved, rank, stuck
    idx = torch.arange(batch, dtype=torch.int32, device=device)
    frozen = tgt == idx[:, None]
    live = (tgt >= 0) & ~frozen
    safe = torch.where(live, tgt, 0).long()
    n_live = live.sum(dim=-1).to(torch.int32)
    vfloor = floor.max(dim=-1).values
    agg_floor = _amax_into(batch, lead, vfloor)
    agg_live = torch.zeros(batch, dtype=torch.int32, device=device)
    agg_live.index_add_(0, lead, n_live)
    agg_miss = _amax_into(batch, lead, missing) > 0
    agg_frozen = _amax_into(batch, lead, frozen.any(dim=-1)) > 0
    agg_final = (agg_live == 0) & ~agg_miss & ~agg_frozen
    t_final = agg_final[safe]
    t_miss = agg_miss[safe]
    t_vfloor = agg_floor[safe]
    lf = live & t_final
    new_floor = torch.where(lf, torch.maximum(floor, add + t_vfloor), floor)
    new_tgt = torch.where(lf, TERMINAL, tgt)
    new_missing = missing | (live & t_miss).any(dim=-1)
    still = live & ~t_final & ~t_miss
    new_floor = torch.where(still, torch.maximum(new_floor, add + t_vfloor), new_floor)
    single = still & (agg_live[safe] == 1) & (member_count[safe] == 1) & (add < batch)
    # first live slot (argmax of a bool row: the first True, else 0)
    live_slot = live.to(torch.int32).argmax(dim=-1, keepdim=True)
    comp_tgt = tgt.gather(1, live_slot)[:, 0]
    comp_add = add.gather(1, live_slot)[:, 0]
    new_tgt = torch.where(single, comp_tgt[safe], new_tgt).to(torch.int32)
    new_add = torch.where(single, add + comp_add[safe], add)
    new_floor = torch.clamp(new_floor, max=batch).to(torch.int32)
    new_add = torch.clamp(new_add, max=batch).to(torch.int32)
    changed = (
        (new_tgt != tgt).any() | (new_floor != floor).any()
        | (new_missing != missing).any()
    )
    return new_tgt, new_add, new_floor, new_missing, changed.to(torch.int32).reshape(1)


def affine_loop_plain(tgt, add, missing, leader, member_count, max_iters):
    """Rounds from ``floor = 0`` until one changes nothing or ``max_iters``
    ran, then the fold: ``(resolved bool[B], rank int32[B], stuck bool[B],
    rounds int32[1])``."""
    floor = torch.zeros_like(tgt)
    rounds = 0
    while rounds < max_iters:
        tgt, add, floor, missing, changed = affine_round_plain(
            tgt, add, floor, missing, leader, member_count
        )
        rounds += 1
        if not int(changed.item()):
            break
    resolved, rank, stuck = affine_round_plain(
        tgt, add, floor, missing, leader, member_count, final=True
    )
    return resolved, rank, stuck, _rounds(rounds, tgt.device)


def _rounds(n: int, device) -> torch.Tensor:
    return torch.tensor([n], dtype=torch.int32, device=device)


def affine_loop(tgt, add, missing, leader, member_count, max_iters):
    if not _on_card(tgt):
        return affine_loop_plain(tgt, add, missing, leader, member_count, max_iters)
    batch, width = tgt.shape
    device = tgt.device
    _check(tgt, torch.int32, "tgt", batch * width)
    _check(add, torch.int32, "add", batch * width)
    _check(missing, torch.bool, "missing", batch)
    _check(leader, torch.int32, "leader", batch)
    _check(member_count, torch.int32, "member_count", batch)
    block = _loop_block(batch)
    # the working tgt/add/floor, then (cooperative) the six columns and the
    # three changed slots
    cta = batch <= CTA_ROWS
    scratch = _i32(3 * batch * width + (0 if cta else 6 * batch + 3), device)
    miss = _b(batch, device)
    resolved, stuck = _b(batch, device), _b(batch, device)
    rank = _i32(batch, device)
    rounds = _i32(1, device)
    _launch(
        "gg_affine_loop", device, tgt, add, missing, leader, member_count, scratch,
        miss, resolved, rank, stuck, rounds, _round_total("affine_loop", device),
        batch, width, max_iters, CTA_ROWS, block,
    )
    LAUNCHES["affine_loop"] += 1
    return resolved, rank, stuck, rounds


# ---------------------------------------------------------------------------
# 11. peel stage: every round of _peel_stage's while_loop (graph_resolve.py
#     :528-566), one cooperative launch a stage
# ---------------------------------------------------------------------------
# Replaces the reference's stage loop as mode ``general_resident`` of
# graph_plane_step_pallas (fantoch_tpu/ops/pallas_resolve.py:334) runs it,
# with no host round-trip inside the stage.  Bound: bytes at 3.35 TB/s of
# what the rounds need — the inputs read and the outputs written once; each
# later round reads one state byte (final, missing) a row and, of each row
# not yet final, its targets and floor and, at each live target, that
# target's state byte and, if it is final, its rank; and writes the cells
# that change (``chip_smoke.py`` counts it on the plain rounds).  Design:
# one cooperative launch, its grid clamped to the co-resident limit (the
# occupancy query times the SM count), rows walked grid-stride, rounds
# separated by a grid barrier.  A row reads of other rows only their
# final/miss flags and the rank of a target final before the round, which
# the round cannot change; so tgt/floor/rank are updated in place and only
# the flags (one state byte a row) ping-pong between two buffers.  Every
# round is round-synchronous, so the round counts and stage cuts are the
# reference's.  Rows final before a round are skipped, and a row's cells are
# loaded four at a time before any is stored.  The changed flag and live
# count: a warp sum, a shared-memory sum a block, one atomic a block into
# slot r % 3 of a three-slot ring (block 0 zeroes slot r + 1, which every
# block last read two barriers before), read after the barrier by every
# block, so all take the same stop decision: nothing changed or, unless
# ``run_to_fixpoint``, ``live <= half``.  Before the first round the stage's
# initial ``live`` (a host int) is tested the same way.  A refused
# cooperative launch raises; it never falls back.


def peel_round_plain(tgt, floor, miss, final, rank):
    """One round (the loop's body): returns the new ``(tgt, floor, miss,
    final, rank)`` and ``stats int32[2] = [changed, live]``."""
    live = tgt >= 0
    safe = torch.where(live, tgt, 0).long()
    fold = live & final[safe]
    lift = torch.where(fold, rank[safe] + 1, 0).max(dim=-1).values
    new_floor = torch.maximum(floor, lift).to(torch.int32)
    new_tgt = torch.where(fold, TERMINAL, tgt).to(torch.int32)
    new_miss = miss | (live & miss[safe]).any(dim=-1)
    open_slots = (new_tgt >= 0).sum(dim=-1)
    newly_final = ~final & ~new_miss & (open_slots == 0)
    new_rank = torch.where(newly_final, new_floor, rank).to(torch.int32)
    new_final = final | newly_final
    changed = newly_final.any() | (new_miss != miss).any()
    n_live = (~new_final & ~new_miss).sum()
    stats = torch.stack([changed.to(torch.int32), n_live.to(torch.int32)])
    return new_tgt, new_floor, new_miss, new_final, new_rank, stats


def peel_stage_plain(tgt, floor, miss, final, rank, live, *, run_to_fixpoint):
    """Peel rounds until one changes nothing or, unless ``run_to_fixpoint``,
    the live set is at most half the stage.  ``live`` is the stage's initial
    ``(~final & ~miss).sum()``, tested before the first round as the
    reference's ``while_loop`` tests its condition.  Returns the new
    ``(tgt, floor, miss, final, rank)`` and ``rounds int32[1]``."""
    half = max(tgt.shape[0] // 2, 1)
    rounds, changed = 0, True
    while changed and (run_to_fixpoint or live > half):
        tgt, floor, miss, final, rank, stats = peel_round_plain(
            tgt, floor, miss, final, rank
        )
        changed, live = stats.tolist()
        rounds += 1
    return tgt, floor, miss, final, rank, _rounds(rounds, tgt.device)


def peel_stage(tgt, floor, miss, final, rank, live, *, run_to_fixpoint):
    if not _on_card(tgt):
        return peel_stage_plain(
            tgt, floor, miss, final, rank, live, run_to_fixpoint=run_to_fixpoint
        )
    size, width = tgt.shape
    device = tgt.device
    _check(tgt, torch.int32, "tgt", size * width)
    _check(floor, torch.int32, "floor", size)
    _check(rank, torch.int32, "rank", size)
    _check(miss, torch.bool, "miss", size)
    _check(final, torch.bool, "final", size)
    block = _loop_block(size)
    out = (torch.empty_like(tgt), _i32(size, device), _b(size, device),
           _b(size, device), _i32(size, device))
    state = torch.empty(2 * size, dtype=torch.uint8, device=device)
    slots, rounds = _i32(6, device), _i32(1, device)
    _launch(
        "gg_peel_stage", device, tgt, floor, miss, final, rank, *out, state, slots,
        rounds, _round_total("peel_stage", device), size, width,
        min(int(live), INT32_MAX), int(run_to_fixpoint), block,
    )
    LAUNCHES["peel_stage"] += 1
    return (*out, rounds)


# ---------------------------------------------------------------------------
# 12. peel compact: the resident peeler's init, publish and compaction
#     (graph_resolve.py:772-846)
# ---------------------------------------------------------------------------
# Bound: bytes — the stage's [S, W] matrix and columns read once, the
# half-size state and the published rows written once.  Design:
# ``init`` pads the window to a power of two (pad rows start final) with
# self-dependencies pruned; ``publish`` scatters the stage's rows into
# the full-batch outputs unless the device ``dead`` gate is closed
# (``orig == batch`` pads dropped; orig values are distinct, so no two
# threads write one cell) and, for the terminal stage, writes ``stuck``;
# ``compact`` publishes, then partitions live rows to the front stably —
# a block scan of the live flags (per-block counts, one block scanning
# the block totals, then the per-row positions), as link_scan's max-scan
# — closes the gate when more than ``half`` rows are live, and gathers
# the kept rows with their targets remapped (``FROZEN`` for cut rows),
# finalized targets folded into the floor, and the new live count.


def peel_compact_plain(*arrays, mode, half=0):
    """``mode="init"``: ``peel_compact(deps)`` -> ``(state, outs, live)``
    with ``state = (tgt, floor, miss, final, rank, orig)`` at the padded
    size and ``outs = (out_final, out_miss, out_rank, dead int32[1])``.
    ``mode="publish"``: ``peel_compact(*state, *outs)`` publishes into
    ``outs`` in place and returns ``stuck bool[B]``.  ``mode="compact"``:
    the same publish, then returns ``(state at half, live int32[1])`` and
    updates ``dead`` in place."""
    if mode == "init":
        (deps,) = arrays
        batch, width = deps.shape
        device = deps.device
        size = 1
        while size < batch:
            size *= 2
        idx = torch.arange(batch, dtype=torch.int32, device=device)
        pruned = torch.where(deps == idx[:, None], TERMINAL, deps).to(torch.int32)
        tgt = torch.full((size, width), TERMINAL, dtype=torch.int32, device=device)
        tgt[:batch] = pruned
        miss = torch.zeros(size, dtype=torch.bool, device=device)
        miss[:batch] = (pruned == MISSING).any(dim=1)
        iota = torch.arange(size, dtype=torch.int32, device=device)
        final = iota >= batch
        state = (
            tgt,
            torch.zeros(size, dtype=torch.int32, device=device),
            miss,
            final,
            torch.zeros(size, dtype=torch.int32, device=device),
            torch.where(iota < batch, iota, batch).to(torch.int32),
        )
        outs = (
            torch.zeros(batch, dtype=torch.bool, device=device),
            torch.zeros(batch, dtype=torch.bool, device=device),
            torch.full((batch,), INT32_MAX, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
        )
        live = (~final & ~miss).sum().to(torch.int32).reshape(1)
        return state, outs, live
    tgt, floor, miss, final, rank, orig, out_final, out_miss, out_rank, dead = arrays
    batch = out_final.shape[0]
    # publish, gated by dead; orig == batch (pads) is dropped
    keep_old = dead[0] != 0
    m = orig < batch
    rows = orig[m].long()
    for out, value in (
        (out_final, final),
        (out_miss, miss),
        (out_rank, torch.where(final, rank, INT32_MAX).to(torch.int32)),
    ):
        pub = out.clone()
        pub[rows] = value[m]
        out.copy_(torch.where(keep_old, out, pub))
    if mode == "publish":
        return ~out_final & ~out_miss
    assert mode == "compact", mode
    size = tgt.shape[0]
    device = tgt.device
    live = ~final & ~miss
    dead |= (live.sum() > half).to(torch.int32)
    perm = torch.sort((~live).to(torch.int32), stable=True).indices
    keep = perm[:half]
    remap = torch.full((size,), FROZEN, dtype=torch.int32, device=device)
    remap[keep] = torch.arange(half, dtype=torch.int32, device=device)
    tgt_k = tgt[keep]
    valid = tgt_k >= 0
    t_rows = torch.where(valid, tgt_k, 0).long()
    t_final = final[t_rows] & valid
    t_miss = miss[t_rows] & valid
    new_floor = torch.maximum(
        floor[keep], torch.where(t_final, rank[t_rows] + 1, 0).max(dim=1).values
    ).to(torch.int32)
    new_miss = miss[keep] | t_miss.any(dim=1)
    new_tgt = torch.where(
        t_final, TERMINAL, torch.where(valid, remap[t_rows], tgt_k)
    ).to(torch.int32)
    new_final = final[keep]
    state = (new_tgt, new_floor, new_miss, new_final, rank[keep], orig[keep])
    n_live = (~new_final & ~new_miss).sum().to(torch.int32).reshape(1)
    return state, n_live


def peel_compact(*arrays, mode, half=0):
    if not _on_card(arrays[0]):
        return peel_compact_plain(*arrays, mode=mode, half=half)
    device = arrays[0].device
    if mode == "init":
        (deps,) = arrays
        batch, width = deps.shape
        _check(deps, torch.int32, "deps", batch * width)
        size = 1
        while size < batch:
            size *= 2
        state = (torch.empty((size, width), dtype=torch.int32, device=device),
                 _i32(size, device), _b(size, device), _b(size, device),
                 _i32(size, device), _i32(size, device))
        outs = (_b(batch, device), _b(batch, device), _i32(batch, device),
                _i32(1, device))
        live = _i32(1, device)
        _launch(
            "gg_peel_compact", device, deps, None, None, None, None, None,
            *outs, *state, live, None, None,
            0, batch, size, width, 0,
        )
        LAUNCHES["peel_compact"] += 1
        return state, outs, live
    tgt, floor, miss, final, rank, orig, out_final, out_miss, out_rank, dead = arrays
    size, width = tgt.shape
    batch = out_final.numel()
    _check(tgt, torch.int32, "tgt", size * width)
    for name, t in (("floor", floor), ("rank", rank), ("orig", orig)):
        _check(t, torch.int32, name, size)
    _check(miss, torch.bool, "miss", size)
    _check(final, torch.bool, "final", size)
    _check(out_final, torch.bool, "out_final", batch)
    _check(out_miss, torch.bool, "out_miss", batch)
    _check(out_rank, torch.int32, "out_rank", batch)
    _check(dead, torch.int32, "dead", 1)
    if mode == "publish":
        stuck = _b(batch, device)
        _launch(
            "gg_peel_compact", device, tgt, floor, miss, final, rank, orig,
            out_final, out_miss, out_rank, dead,
            None, None, None, None, None, None, None, stuck, None,
            1, batch, size, width, 0,
        )
        LAUNCHES["peel_compact"] += 1
        return stuck
    assert mode == "compact", mode
    state = (torch.empty((half, width), dtype=torch.int32, device=device),
             _i32(half, device), _b(half, device), _b(half, device),
             _i32(half, device), _i32(half, device))
    live = _i32(1, device)
    # remap + per-block live counts + their scan + keep
    nb = _blocks(size)
    scratch = _i32(2 * size + 2 * nb + 1, device)
    _launch(
        "gg_peel_compact", device, tgt, floor, miss, final, rank, orig,
        out_final, out_miss, out_rank, dead,
        *state, live, None, scratch,
        2, batch, size, width, half,
    )
    LAUNCHES["peel_compact"] += 1
    return state, live
