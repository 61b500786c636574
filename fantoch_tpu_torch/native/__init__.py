"""The native (C++) batch SCC resolver, loaded through ctypes.

The port's copy of fantoch_tpu/native: ``tarjan.cpp`` is the C++ twin of
the host Tarjan oracle (executor/graph/tarjan.py; reference
tarjan.rs:99-319).  It is host code and stays C++.

``g++`` builds it on first use into ``fantoch_tpu_torch/build/`` (listed
in ``.gitignore``), named after the source's content hash so an edited
source never loads a stale library; the JAX package builds its library
inside its own package directory instead.

No probe and no fallback: the batched graph executor takes this route only
when ``Config.host_native_resolver`` is True, and then a library that
cannot be built raises ``NativeBuildError``.  ``None`` and ``False`` order
on the graph's device with the port's kernels, and finish stuck residues
on the Python oracle.  (The JAX package's ``None`` picks native by backend
and degrades to the Python oracle when the build fails.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fantoch_tpu_torch.core import compile_cache

SOURCE = Path(__file__).resolve().parent / "tarjan.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# the library's entry in the build audit (core/compile_cache.py)
LIBRARY = "tarjan"
compile_cache.register_library(LIBRARY)


class NativeBuildError(RuntimeError):
    """The native resolver was asked for and its library cannot be built
    or loaded."""


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libfantoch_native-{digest}.so"


def _build(output: Path) -> None:
    # compile to a temp path and atomically rename: a concurrent process
    # must never dlopen a partially written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = output.with_name(f"{output.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeBuildError(f"cannot run {' '.join(cmd)}: {exc!r}") from exc
    finally:
        compile_cache.note_build(LIBRARY, t0)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed for tarjan.cpp (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, output)


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises ``NativeBuildError``
    when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            output = library_path()
            if not output.exists():
                _build(output)
            try:
                lib = ctypes.CDLL(str(output))
            except OSError as exc:
                raise NativeBuildError(f"cannot load {output}: {exc}") from exc
            compile_cache.note_load(LIBRARY)
            fn = lib.fantoch_resolve_sccs
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            _lib = lib
    return _lib


def resolve_sccs(
    offsets: np.ndarray,  # int32[n + 1] CSR row offsets
    targets: np.ndarray,  # int32[nnz] dep slots; -1 executed/none, -2 missing
    dot_key: np.ndarray,  # int64[n] packed dots (intra-SCC order)
) -> Tuple[np.ndarray, np.ndarray]:
    """(order, scc_size_per_position) for the emittable prefix.  Same
    contract as the host Tarjan oracle: SCCs contiguous and dot-sorted,
    dependencies before dependents, missing-blocked components omitted."""
    lib = load()
    n = len(offsets) - 1
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    targets = np.ascontiguousarray(targets, dtype=np.int32)
    dot_key = np.ascontiguousarray(dot_key, dtype=np.int64)
    out_order = np.empty(n, dtype=np.int32)
    out_size = np.empty(n, dtype=np.int32)
    if len(targets) == 0:
        targets = np.zeros(1, dtype=np.int32)  # ndpointer rejects size-0 reuse
    emitted = lib.fantoch_resolve_sccs(
        n, offsets, targets, dot_key, out_order, out_size
    )
    if emitted < 0:
        raise ValueError("native resolver rejected the input CSR")
    return out_order[:emitted], out_size[:emitted]
