"""Build control: the build-directory resolution and the per-library audit.

The port of fantoch_tpu/core/compile_cache.py.  The JAX package compiles
XLA programs and keeps them in a persistent compilation cache; the port
compiles each ``csrc/*.cu`` source once with ``nvcc`` (and
``native/tarjan.cpp`` with ``g++``) into a shared library named after the
source's content hash, and loads it with ``ctypes``.  The build directory
is the port's compilation cache, and this module is the seam for both of
its halves:

* **Build directory** — :func:`ensure_compile_cache` resolves it
  (``Config.compile_cache_dir`` > ``FANTOCH_COMPILE_CACHE_DIR`` env >
  ``build`` under the obs dir when the caller has one > the package's
  ``fantoch_tpu_torch/build/``) and points the loaders
  (ops/_build.py, native/) at it.  With the directory warm, a "compile"
  is a ``dlopen`` of the hashed library.

* **Per-library audit** — every library the loaders can build has one
  entry here (:func:`register_library`), counting its builds (a compiler
  run) and its loads (a ``dlopen``).  :func:`library_counts` reads them,
  so a sweep can assert that each library was built at most once and
  loaded once in a process, whatever the shapes it was given (the
  kernels take their shapes as arguments: a new shape never rebuilds).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional

ENV_CACHE_DIR = "FANTOCH_COMPILE_CACHE_DIR"

# the default build directory (listed in .gitignore)
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# library name -> {"builds", "loads", "build_ms"}; module-level like the
# device counters: the loaders register at import, so the audit sees
# every library the process can load
_libraries: Dict[str, Dict[str, float]] = {}

_enabled_dir: Optional[str] = None


def register_library(name: str) -> None:
    """One audit entry for library ``name`` (idempotent)."""
    _libraries.setdefault(name, {"builds": 0, "loads": 0, "build_ms": 0.0})


def note_build(name: str, t0: float) -> None:
    """One compiler run for ``name``, started at ``time.perf_counter()``
    value ``t0``."""
    register_library(name)
    entry = _libraries[name]
    entry["builds"] += 1
    entry["build_ms"] += (time.perf_counter() - t0) * 1000.0


def note_load(name: str) -> None:
    """One ``dlopen`` of ``name``'s library."""
    register_library(name)
    _libraries[name]["loads"] += 1


def library_counts() -> Dict[str, Dict[str, int]]:
    """Builds and loads per registered library (0 = never built here /
    never loaded)."""
    return {
        name: {"builds": int(e["builds"]), "loads": int(e["loads"])}
        for name, e in sorted(_libraries.items())
    }


def build_ms() -> float:
    """Cumulative compiler wall milliseconds across every library."""
    return round(sum(e["build_ms"] for e in _libraries.values()), 1)


def clear_library_counts() -> None:
    """Test hook: zero every entry (the entries stay registered)."""
    for entry in _libraries.values():
        entry.update(builds=0, loads=0, build_ms=0.0)


def resolve_cache_dir(config=None, obs_dir: Optional[str] = None) -> Optional[str]:
    """The build-directory precedence: explicit config > env > obs-dir
    default > ``None`` (meaning: the package's ``build/``)."""
    value = getattr(config, "compile_cache_dir", None) if config else None
    if value:
        return str(value)
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return env
    if obs_dir:
        return os.path.join(obs_dir, "build")
    return None


def ensure_compile_cache(config=None, obs_dir: Optional[str] = None) -> str:
    """Point the loaders at the resolved build directory; returns it.
    Idempotent: a library already loaded stays loaded, and the next one
    builds into (or loads from) the directory in effect."""
    global _enabled_dir
    from fantoch_tpu_torch import native
    from fantoch_tpu_torch.ops import _build

    cache_dir = resolve_cache_dir(config, obs_dir) or str(DEFAULT_BUILD_DIR)
    if _enabled_dir == cache_dir:
        return cache_dir
    _build.BUILD_DIR = Path(cache_dir)
    native.BUILD_DIR = Path(cache_dir)
    _enabled_dir = cache_dir
    return cache_dir
