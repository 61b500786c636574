"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launchers
taking raw pointers and a stream), is compiled on first use into a shared
library for ``sm_90a`` and loaded with ``ctypes``.  No PyTorch header is
compiled, so a build takes seconds.

The library lands in ``fantoch_tpu_torch/build/`` (listed in
``.gitignore``), named after the source's content hash so an edited source
never loads a stale library.  A failed build raises with nvcc's output.
Each build and each load is counted per source in the build audit
(core/compile_cache.py), which can also point ``BUILD_DIR`` elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

from fantoch_tpu_torch.core import compile_cache

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (with ``-Xptxas -v``: registers, shared memory, spills)
# per source, for the chip smoke to print
build_logs: Dict[str, str] = {}

for _source in sorted(CSRC_DIR.glob("*.cu")):
    compile_cache.register_library(_source.stem)


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(source: Path, output: Path) -> List[str]:
    """The nvcc command line for one source (also read by the tests)."""
    return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    output = library_path(name)
    if output.exists():
        return output
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = output.with_name(f"{output.stem}.{os.getpid()}.tmp.so")
    cmd = build_command(CSRC_DIR / f"{name}.cu", tmp)
    if not os.path.exists(cmd[0]):
        raise RuntimeError(f"nvcc not found ({cmd[0]}): cannot build {name}.cu")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    compile_cache.note_build(name, t0)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, output)
    return output


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        compile_cache.note_load(name)
        _loaded[name] = lib
    return lib
