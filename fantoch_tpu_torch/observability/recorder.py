"""Failure flight recorder: a bounded in-memory ring of *unsampled*

The port of fantoch_tpu/observability/recorder.py (jax-free: only its imports
are re-pointed).
trace events, dumped as a black box when something goes wrong.

The sampled tracer (observability/tracer.py) answers "where does the
p99 go" for commands that hashed into the sample; when a typed failure
fires (``DivergenceError``, ``StalledExecutionError``, an auditor
``Violation``, a WAL-restart boot) the evidence that matters is
whatever happened *just before it* — usually commands that did NOT
sample in.  The :class:`FlightRecorder` closes that gap: it implements
the tracer protocol (span / counter / edge / offset), records EVERY
event into a lock-light bounded ring (`collections.deque(maxlen=...)`
— appends are atomic under both the GIL and cooperative asyncio), and
forwards to the real sampled tracer underneath, so hook sites keep one
``self.tracer`` seam and pay one extra dict append per event.

On a trigger the ring dumps to ``flight_p<pid>.json`` (one file per
process; a shared sim ring splits by the events' ``pid``).  Dumps are
self-describing JSON readable by :func:`read_flight`, and
:func:`flight_events` re-synthesizes the stream (header included) so
the critical-path correlator (observability/critpath.py) stitches
flight dumps exactly like live span logs — every failure ships a
replayable black box.

Triggers: any fatal runtime failure (run/process_runner.py ``_fail``),
typed sim stalls (sim/runner.py), a WAL-restart boot (the new life's
replay + rejoin events), ``SIGUSR1`` (:func:`install_flight_signal`),
and fuzz findings (sim/fuzz.py attaches dumps to repro artifacts).
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from fantoch_tpu_torch.observability.tracer import (
    NOOP_TRACER,
    counter_event,
    edge_event,
    offset_event,
    span_event,
)

FLIGHT_FORMAT = "fantoch-flight-v1"

# ring bound: ~last N events per process (the "last few seconds" at
# serving rates; env-overridable for long-window rigs)
DEFAULT_FLIGHT_EVENTS = 1 << 16


def flight_capacity(explicit: Optional[int] = None) -> int:
    """config > FANTOCH_FLIGHT_EVENTS env > built-in default."""
    if explicit is not None:
        return int(explicit)
    env = os.environ.get("FANTOCH_FLIGHT_EVENTS")
    return int(env) if env else DEFAULT_FLIGHT_EVENTS


class FlightRecorder:
    """Tracer-protocol tee: ring-record everything, forward to the
    (sampling) inner tracer.  ``enabled`` is True so hook sites build
    event payloads; ``sample`` answers True so meta-bearing sites (the
    commit deps stamp) build their meta for the ring — the inner tracer
    still applies its own deterministic sampling on forward."""

    enabled = True

    def __init__(
        self,
        time,
        pid: Optional[int] = None,
        inner=NOOP_TRACER,
        capacity: Optional[int] = None,
        clock: str = "wall",
    ):
        self._time = time
        self.pid = pid
        self.inner = inner
        self.clock = getattr(inner, "clock", None) or clock
        self._ring: deque = deque(maxlen=flight_capacity(capacity))
        self.dumps: List[str] = []

    # --- tracer protocol ---

    @property
    def sample_rate(self) -> float:
        return getattr(self.inner, "sample_rate", 0.0)

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    def sample(self, rifl) -> bool:
        return True

    def span(self, stage, rifl, dot=None, pid=None, cid=None, meta=None) -> None:
        self._ring.append(
            span_event(
                self._time.micros(), stage, rifl,
                dot=dot, pid=pid, cid=cid, meta=meta,
            )
        )
        self.inner.span(stage, rifl, dot=dot, pid=pid, cid=cid, meta=meta)

    def counter(self, name, value, pid=None, meta=None) -> None:
        self._ring.append(
            counter_event(self._time.micros(), name, value, pid=pid, meta=meta)
        )
        self.inner.counter(name, value, pid=pid, meta=meta)

    def edge(self, io, mtype, src, dst, seq, dot=None, rifl=None) -> None:
        self._ring.append(
            edge_event(
                self._time.micros(), io, mtype, src, dst, seq,
                dot=dot, rifl=rifl,
            )
        )
        self.inner.edge(io, mtype, src, dst, seq, dot=dot, rifl=rifl)

    def offset(self, pid, peer, offset_us, rtt_us) -> None:
        self._ring.append(
            offset_event(self._time.micros(), pid, peer, offset_us, rtt_us)
        )
        self.inner.offset(pid, peer, offset_us, rtt_us)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    # --- the black box ---

    def events(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def dump(self, path: str, reason: str) -> str:
        """Write the whole ring as one self-describing JSON black box."""
        _write_blob(
            path, self.pid, self.clock, reason,
            self._time.micros(), self.events(),
        )
        self.dumps.append(path)
        return path

    def dump_all(self, out_dir: str, reason: str) -> List[str]:
        """Split the ring by owning process and write one
        ``flight_p<pid>.json`` per process (+ ``flight_clients.json``
        for client-plane events) — the shape a shared sim ring dumps in,
        and what a per-runtime ring with a known pid degrades to."""
        if self.pid is not None:
            return [self.dump(f"{out_dir}/flight_p{self.pid}.json", reason)]
        by_owner: Dict[Any, List[Dict[str, Any]]] = {}
        for ev in self._ring:
            by_owner.setdefault(_event_owner(ev), []).append(ev)
        t_us = self._time.micros()
        paths = []
        for owner in sorted(by_owner, key=str):
            name = (
                "flight_clients.json" if owner is None
                else f"flight_p{owner}.json"
            )
            paths.append(
                _write_blob(
                    f"{out_dir}/{name}", owner, self.clock, reason,
                    t_us, by_owner[owner],
                )
            )
        self.dumps.extend(paths)
        return paths


def _write_blob(
    path: str,
    pid: Any,
    clock: str,
    reason: str,
    t_us: int,
    events: List[Dict[str, Any]],
) -> str:
    """The one flight-dump shape — every dump path writes through here."""
    blob = {
        "format": FLIGHT_FORMAT,
        "pid": pid,
        "clock": clock,
        "reason": reason,
        "dumped_at_us": t_us,
        "events": events,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(blob, fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")
    return path


def _event_owner(ev: Dict[str, Any]):
    """Which process's black box an event belongs in: its ``pid``, the
    emitting side of an edge (sender for ``"s"``, receiver for ``"r"``),
    or None for client-plane events (``cid`` only)."""
    pid = ev.get("pid")
    if pid is not None:
        return pid
    if ev.get("k") == "edge":
        owner = ev["src"] if ev.get("io") == "s" else ev["dst"]
        # client-plane hops mark their client side as 0 (the perfetto
        # CLIENT_PID convention): those belong to the process side
        return owner if owner != 0 else (
            ev["dst"] if ev.get("io") == "s" else ev["src"]
        )
    return None


def read_flight(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Load one flight dump; returns (meta, events)."""
    with open(path) as fh:
        blob = json.load(fh)
    assert blob.get("format") == FLIGHT_FORMAT, f"not a flight dump: {path}"
    events = blob.pop("events")
    return blob, events


def flight_events(paths: List[str]) -> List[Dict[str, Any]]:
    """Merge flight dumps back into one trace-shaped event stream (a
    synthesized ``hdr`` per dump carries the clock domain), so the
    critical-path correlator consumes black boxes exactly like live
    span logs."""
    events: List[Dict[str, Any]] = []
    for path in paths:
        meta, evs = read_flight(path)
        events.append({"k": "hdr", "clock": meta.get("clock", "wall"), "v": 1})
        events.extend(evs)
    return events


def install_flight_signal(recorder: FlightRecorder, out_dir: str) -> bool:
    """Arm SIGUSR1 to dump the flight ring on demand (``kill -USR1``
    against a live server: a black box without killing the run).
    Returns False where signals can't be installed."""
    import asyncio
    import signal

    def _dump() -> None:
        if recorder.pid is not None:
            recorder.dump(
                f"{out_dir}/flight_p{recorder.pid}.json", "SIGUSR1"
            )
        else:
            recorder.dump_all(out_dir, "SIGUSR1")

    try:
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGUSR1, _dump)
        return True
    except (NotImplementedError, RuntimeError, ValueError):
        return False
