"""Typed errors of the port's executor and simulator layers: a command
stalled on dependencies that never commit, a simulation past its
virtual-time bound, a device plane that failed or whose resident state
diverged, and a clock past the device window.  (The JAX package's
``errors.py`` also carries the run layer's errors; the port copies them
with the slice that raises them.)
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional


class FaultToleranceError(Exception):
    """Base class for every typed fault-tolerance failure."""


class StalledExecutionError(FaultToleranceError):
    """A committed command waited past the bounded-wait threshold on
    dependencies that never commit (e.g. dots owned by a crashed replica).

    ``missing`` maps each stuck dot to the dependency dots it is blocked
    on — the executor surfaces *what* it is waiting for instead of
    silently hanging the ordering engine.
    """

    def __init__(
        self,
        process_id: int,
        missing: Dict,
        waited_ms: int,
        recovery_delay_ms: Optional[int] = None,
    ):
        self.process_id = process_id
        self.missing = missing
        self.waited_ms = waited_ms
        if recovery_delay_ms is None:
            self.recovery_note = "recovery disabled (Config.recovery_delay_ms unset)"
        else:
            self.recovery_note = (
                f"recovery was attempted every {recovery_delay_ms}ms but "
                "could not commit these dots — likely no n-f promise "
                "quorum among the survivors"
            )
        detail = ", ".join(
            f"{dot} <- missing {sorted(map(str, deps))}"
            for dot, deps in sorted(missing.items(), key=lambda kv: str(kv[0]))
        )
        super().__init__(
            f"p{process_id}: execution stalled > {waited_ms}ms on "
            f"dependencies that never commit: {detail} [{self.recovery_note}]"
        )


class SimStalledError(FaultToleranceError):
    """The simulation passed its virtual-time bound with clients still
    waiting — the whole-system analog of :class:`StalledExecutionError`
    (e.g. every quorum of an in-flight command crashed)."""

    def __init__(self, time_ms: int, bound_ms: int, waiting_clients: Iterable[int]):
        self.time_ms = time_ms
        self.bound_ms = bound_ms
        self.waiting_clients = sorted(waiting_clients)
        super().__init__(
            f"simulation stalled: virtual time {time_ms}ms exceeded the "
            f"{bound_ms}ms bound with clients {self.waiting_clients} still "
            "waiting for results"
        )


class DeviceFailedError(FaultToleranceError):
    """A device plane's dispatch overran the per-dispatch deadline
    (``Config.device_dispatch_timeout_ms``) — the accelerator failed, not
    the protocol.

    The plane marks itself failed and raises this to the caller; nothing
    serves the round in the card's place.  ``kind`` names the channel:
    ``"timeout"`` (a dispatch that overran the deadline, measured at its
    blocking fetch) or ``"failed"`` (a dispatch asked of a plane that
    has already failed; ``cause`` is the first failure)."""

    def __init__(
        self,
        plane: str,
        process_id: Optional[int],
        kind: str,
        dispatch: int,
        timeout_ms: Optional[float] = None,
        cause: Optional[BaseException] = None,
    ):
        self.plane = plane
        self.process_id = process_id
        self.kind = kind
        self.dispatch = dispatch
        self.timeout_ms = timeout_ms
        self.cause = cause
        deadline = (
            f" (deadline {timeout_ms:.0f}ms)" if timeout_ms is not None else ""
        )
        cause_note = f": {cause!r}" if cause is not None else ""
        super().__init__(
            f"p{process_id}: {plane} plane dispatch #{dispatch} failed "
            f"[{kind}]{deadline}{cause_note}"
        )


class DeviceCorruptionError(FaultToleranceError):
    """A device plane's resident state or outputs silently diverged from
    the host twin — caught by the sampled shadow-check
    (``Config.plane_shadow_rate`` replays a dispatch's inputs through the
    plain version of the step on host-owned state and compares bit for
    bit), named with the first diverging row.

    Like :class:`DeviceFailedError` this fails the plane and goes to the
    caller before the dispatch's outputs reach any host bookkeeping.
    """

    def __init__(
        self,
        plane: str,
        process_id: Optional[int],
        dispatch: int,
        array_index: int,
        row: int,
        key=None,
    ):
        self.plane = plane
        self.process_id = process_id
        self.dispatch = dispatch
        self.array_index = array_index
        self.row = row
        self.key = key
        key_note = f" (key {key!r})" if key is not None else ""
        super().__init__(
            f"p{process_id}: {plane} plane resident state diverged from the "
            f"host twin at dispatch #{dispatch}: array "
            f"{array_index}, first diverging row {row}{key_note}"
        )


class ClockOverflowError(ValueError):
    """A clock or vote endpoint exceeds the plane's 31-bit device window.

    (The JAX package defines it in ``executor/table_plane.py``; the port
    keeps it here until the table plane is ported.)"""
