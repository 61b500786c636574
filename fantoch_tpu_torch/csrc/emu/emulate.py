"""Run the port's CUDA sources on the CPU, for rehearsing kernel logic
where there is no card and no ``nvcc``.

Each ``csrc/<name>.cu`` is translated to C++ over ``cuda_mock.h`` and
compiled with ``g++`` into ``fantoch_tpu_torch/build/emu/``.  Every
``k<<<grid, block, smem, stream>>>(...)`` becomes a loop over the blocks in
order, each block's threads real OS threads meeting at a barrier for
``__syncthreads``.  A cooperative launch
(``cudaLaunchCooperativeKernel((const void*)k, ...)``) starts every block's
threads at once, each block with its own barrier, collective slots and
dynamic shared memory, and ``cooperative_groups::this_grid().sync()`` is a
barrier over all of them; the card it reports is small (2 SMs holding 2
blocks each), so a kernel that clamps its grid to the co-resident limit
crosses a real multi-block barrier with few threads.  A kernel launched
cooperatively must keep its shared memory dynamic: a static ``__shared__``
array becomes one C++ static for every block.  Atomics are
``std::atomic_ref``; warp collectives are emulated with barriers:
``__reduce_add_sync`` and ``__syncthreads_or`` on the block's, ballots,
shuffles, ``__reduce_or_sync`` and ``__syncwarp`` on one per warp.  Inside
``with emulated():`` every kernel wrapper of ``ops/graph_plane_kernels.py``,
``ops/table_kernels.py`` and ``ops/pred_kernels.py`` takes its CUDA route on
CPU tensors and launches the emulated kernels, so a wrapper can be held
against its plain version — ``chip_smoke.Checker`` does it per call:

    from fantoch_tpu_torch.csrc.emu.emulate import emulated
    with emulated():
        out = graph_resolve.resolve_general_resident(deps, src, seq)

The switch is the wrappers' own device test and stream handle
(``graph_plane_kernels._on_card`` and ``_stream``) and their library
loader; ``torch`` itself is left as it is.

What it cannot show: that ``nvcc`` accepts the source, races between
blocks of a launch that is not cooperative (its blocks run one after
another), memory-ordering faults across SMs, and anything about speed.  A
launch starts one OS thread per thread of the block (of the grid, when
cooperative), so keep the shapes small.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

EMU_DIR = Path(__file__).resolve().parent
CSRC_DIR = EMU_DIR.parent
BUILD_DIR = CSRC_DIR.parent / "build" / "emu"


def translate(source: str) -> str:
    """C++ over cuda_mock.h for one CUDA source."""
    text = source.replace("#include <cuda_runtime.h>", '#include "cuda_mock.h"')
    text = text.replace("#include <cooperative_groups.h>", "")
    text = re.sub(
        r"cudaLaunchCooperativeKernel\(\(const void\*\)(\w+),",
        r"mock_launch_cooperative(\1,",
        text,
    )
    text = re.sub(
        r"extern __shared__ (\w[\w ]*?) (\w+)\[\];",
        r"\1* \2 = (\1*)mock_dyn_smem();",
        text,
    )
    text = text.replace("__shared__ ", "static ")
    text = re.sub(
        r"(\w+)<<<(.*?)>>>\(", r"mock_cfg(\2), mock_launch(\1, ", text, flags=re.S
    )
    return text.replace(", )", ")")  # a launch with no arguments


def build(name: str) -> Path:
    """Compile the emulation of ``csrc/<name>.cu`` unless the library of
    the same translation and mock exists; returns the library.  The
    library is named after their content hash and written under a
    per-process name, then renamed into place, so processes that build at
    once (test workers) never load a half-written or stale library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = translate((CSRC_DIR / f"{name}.cu").read_text())
    mock = (EMU_DIR / "cuda_mock.h").read_bytes()
    digest = hashlib.sha1(text.encode() + mock).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    cpp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.cpp"
    tmp = BUILD_DIR / f"lib{name}-{digest}.{os.getpid()}.tmp.so"
    cpp.write_text(text)
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-I", str(EMU_DIR), "-o", str(tmp), str(cpp)],
        check=True,
    )
    os.replace(tmp, lib)
    os.replace(cpp, BUILD_DIR / f"{name}.cpp")
    return lib


@contextlib.contextmanager
def emulated():
    """Route the kernel wrappers to the emulated kernels on CPU tensors."""
    from fantoch_tpu_torch.ops import _build
    from fantoch_tpu_torch.ops import graph_plane_kernels as K

    libs = {
        name: build(name)
        for name in ("graph_plane_step", "graph_general", "table_plane", "pred_plane")
    }
    saved = (K._on_card, K._stream, _build.load)
    K._on_card = lambda tensor: True
    K._stream = lambda device: 0
    _build.load = lambda name: ctypes.CDLL(str(libs[name]))
    K._lib_handles.clear()
    try:
        yield
    finally:
        K._on_card, K._stream, _build.load = saved
        K._lib_handles.clear()
