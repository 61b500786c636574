"""Seeded device-fault nemesis: deterministic accelerator failures.

The port of fantoch_tpu/sim/device_faults.py.  A :class:`DeviceFault`
describes one accelerator failure against one process's plane — a
dispatch that hangs, a runtime raise, or a silent bit-flip of a resident
column — and a :class:`DeviceFaultInjector` fires it deterministically.

Determinism is the whole design: faults are windowed in **dispatch
counts**, not wall or virtual time.  The plane's ``dispatches`` counter
advances identically on every same-seed run (it is driven purely by the
deterministic batch schedule), so "hang dispatch 12 of p2's pred plane"
replays bit-identically in the sim and on a live rig — where a time-based
window would race the scheduler.  ``sim/faults.py``'s ``FaultPlan``
carries these faults and round-trips them through its dict form.

The injector is *passive*: it never touches device state itself.  The
plane (executor/device_plane.py) asks ``on_dispatch(plane, n)`` before
each fused dispatch and applies the verdict — a hung dispatch
short-circuits into its deadline and a ``raise`` raises, both as a typed
``DeviceFailedError`` before the dispatch's kernels launch; a ``corrupt``
fault flips one high bit of the first element of resident state array 0
on the card after the kernels ran, so the shadow check sees it.  The
port's planes never fail over: either error fails the plane and goes to
the caller.  So the JAX package's ``rebuild_allowed`` (the veto of its
cutback re-upload while a window is open) has no caller here and is not
ported; a window still bounds how long hang/raise re-fire.

Live runtimes arm the same injector from the environment
(:func:`install_env_faults`, ``FANTOCH_DEVICE_FAULT=plane:kind:at[:down
[:pid]]``) so a real rig can rehearse a device failure without a sim.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PLANES = ("table", "pred", "graph")
KINDS = ("hang", "raise", "corrupt")

# corrupt flips this bit of resident state array 0, flat element 0:
# high enough that monotone kernels (frontier max, dep pass-through)
# keep the larger value instead of washing the flip out
DEFAULT_CORRUPT_BIT = 20

ENV_DEVICE_FAULT = "FANTOCH_DEVICE_FAULT"


@dataclass(frozen=True)
class DeviceFault:
    """One deterministic accelerator failure.

    ``process_id`` None targets every process's matching plane (the env
    install on a single live runtime); the sim plans always pin one.
    ``at_dispatch`` is the plane's ``dispatches`` counter value the
    fault first fires at; ``down_dispatches`` is how many subsequent
    dispatches the device stays broken for (hang/raise re-fire inside
    the window).  ``corrupt`` fires exactly once at ``at_dispatch`` —
    the bit-flip is the event."""

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

    def covers(self, dispatch: int) -> bool:
        return (
            self.at_dispatch
            <= dispatch
            < self.at_dispatch + self.down_dispatches
        )

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "DeviceFault":
        return cls(**data)


class DeviceFaultInjector:
    """The per-process injector a plane consults on every dispatch.

    ``record`` (optional) is called ``record(plane, kind, dispatch,
    detail)`` the moment a fault fires — the sim runner wires it into
    the nemesis trace so fault firings are part of the deterministic
    trace digest, and a live runtime can wire it to its logger."""

    def __init__(
        self,
        faults: Sequence[DeviceFault],
        process_id: Optional[int] = None,
        record: Optional[Callable[[str, str, int, str], None]] = None,
    ):
        self.process_id = process_id
        self.record = record
        self._faults: List[DeviceFault] = [
            f
            for f in faults
            if f.process_id is None
            or process_id is None
            or f.process_id == process_id
        ]
        # corrupt faults fire exactly once; keyed by identity in the list
        self._corrupted: set = set()
        self.fired: int = 0

    def faults_for(self, plane: str) -> List[DeviceFault]:
        return [f for f in self._faults if f.plane == plane]

    def on_dispatch(self, plane: str, dispatch: int) -> Optional[DeviceFault]:
        """The fault this dispatch suffers, or None.  hang/raise fire on
        every dispatch inside their window; corrupt fires once at its
        window's first covered dispatch."""
        for index, fault in enumerate(self._faults):
            if fault.plane != plane or not fault.covers(dispatch):
                continue
            if fault.kind == "corrupt":
                if index in self._corrupted:
                    continue
                self._corrupted.add(index)
            self.fired += 1
            if self.record is not None:
                self.record(
                    plane,
                    fault.kind,
                    dispatch,
                    f"window [{fault.at_dispatch}, "
                    f"{fault.at_dispatch + fault.down_dispatches})",
                )
            return fault
        return None


def faults_from_env(env: Optional[str] = None) -> Tuple[DeviceFault, ...]:
    """Parse ``FANTOCH_DEVICE_FAULT`` — one or more comma-separated
    ``plane:kind:at[:down[:pid]]`` specs — into :class:`DeviceFault`
    tuples (empty when unset), so live runtimes rehearse the same
    deterministic failures the sim injects."""
    raw = os.environ.get(ENV_DEVICE_FAULT) if env is None else env
    if not raw:
        return ()
    faults = []
    for spec in raw.split(","):
        parts = spec.strip().split(":")
        if len(parts) < 3:
            raise ValueError(
                f"bad {ENV_DEVICE_FAULT} spec {spec!r}: want "
                "plane:kind:at[:down[:pid]]"
            )
        fault = DeviceFault(
            plane=parts[0], kind=parts[1], at_dispatch=int(parts[2])
        )
        if len(parts) > 3:
            fault = replace(fault, down_dispatches=int(parts[3]))
        if len(parts) > 4:
            fault = replace(fault, process_id=int(parts[4]))
        faults.append(fault)
    return tuple(faults)


def install_env_faults(
    planes: Sequence,
    process_id: Optional[int] = None,
    record: Optional[Callable[[str, str, int, str], None]] = None,
) -> Optional[DeviceFaultInjector]:
    """Attach one env-configured injector to every device plane of a
    live runtime (its executor pools).  No-op (returns None) when
    ``FANTOCH_DEVICE_FAULT`` is unset or no plane exists."""
    faults = faults_from_env()
    if not faults:
        return None
    planes = [p for p in planes if p is not None]
    if not planes:
        return None
    injector = DeviceFaultInjector(faults, process_id, record=record)
    for plane in planes:
        plane.attach_injector(injector)
    return injector
