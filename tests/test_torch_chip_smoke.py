"""``chip_smoke.py`` refuses to run where it cannot drive the port.

Two cases, each a fresh interpreter that runs the script as ``__main__``
with ``torch.cuda.is_available`` pinned, so the outcome does not depend on
the machine:

* ``no_cuda``: from the checkout, with no CUDA device;
* ``lone_copy``: with a CUDA device claimed, from a directory that holds
  ``chip_smoke.py`` and nothing else of the repository.

Either way the script exits with a code other than 0 before it asks
``nvidia-smi`` or builds a kernel, says why on standard error, and prints
no result line.  One collected item (ROADMAP.md Queue C).
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import runpy, sys, torch
torch.cuda.is_available = lambda: {available}
sys.argv = [{script!r}]
runpy.run_path({script!r}, run_name="__main__")
"""


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    cases = (
        ("no_cuda", ROOT / "chip_smoke.py", False, "no CUDA device"),
        ("lone_copy", lone, True, "run it from a checkout"),
    )
    for case, script, available, reason in cases:
        out = subprocess.run(
            [sys.executable, "-c", RUN.format(available=available, script=str(script))],
            cwd=script.parent, capture_output=True, text=True, timeout=120,
        )
        assert out.returncode not in (0, None), (case, out.returncode, out.stdout,
                                                 out.stderr)
        assert reason in out.stderr, (case, out.stderr)
        assert out.stdout.strip() == "", (case, out.stdout)
