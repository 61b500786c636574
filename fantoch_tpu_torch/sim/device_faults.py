"""Device faults as a fault plan describes them.

A :class:`DeviceFault` names one accelerator failure against one
process's plane — a dispatch that hangs, a runtime raise, or a silent
bit-flip of a resident column — windowed in **dispatch counts**, not
wall or virtual time: the plane's ``dispatches`` counter advances
identically on every same-seed run, so a window replays bit-identically.
``sim/faults.py``'s ``FaultPlan`` carries these faults and round-trips
them through its dict form.

The port has no injector yet: the simulator refuses a plan that carries
device faults (``sim/runner.py``, ROADMAP A4's injector hook).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

PLANES = ("table", "pred", "graph")
KINDS = ("hang", "raise", "corrupt")

# corrupt flips this bit of resident state array 0, flat element 0:
# high enough that monotone kernels (frontier max, dep pass-through)
# keep the larger value instead of washing the flip out
DEFAULT_CORRUPT_BIT = 20


@dataclass(frozen=True)
class DeviceFault:
    """One deterministic accelerator failure.

    ``process_id`` None targets every process's matching plane; the sim
    plans always pin one.
    ``at_dispatch`` is the plane's ``dispatches`` counter value the
    fault first fires at; ``down_dispatches`` is how many subsequent
    dispatches the device stays broken for (hang/raise re-fire inside
    the window; rebuild is vetoed until the window closes).  ``corrupt``
    fires exactly once at ``at_dispatch`` — the bit-flip is the event —
    but the window still vetoes rebuild, modeling a device that keeps
    flipping bits until "repaired"."""

    plane: str
    kind: str
    at_dispatch: int
    down_dispatches: int = 4
    process_id: Optional[int] = None
    bit: int = DEFAULT_CORRUPT_BIT

    def __post_init__(self) -> None:
        if self.plane not in PLANES:
            raise ValueError(f"plane {self.plane!r} not in {PLANES}")
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} not in {KINDS}")
        if self.at_dispatch < 0:
            raise ValueError("at_dispatch must be >= 0")
        if self.down_dispatches < 1:
            raise ValueError("down_dispatches must be >= 1")
