"""Sampled per-dot span tracing: one schema across sim and run.

Every traced command leaves a sequence of *span events* — one JSON line
per lifecycle stage — keyed by its rifl (the id that exists from client
submit to client reply; the dot joins at the ``payload`` stage, once the
coordinator assigns it).  The same schema is emitted by the sim runner
(virtual timestamps from :class:`fantoch_tpu_torch.core.timing.SimTime`) and
the run layer (wall clock), so a same-seed sim trace and a localhost
trace are directly diffable: the PR-2 deterministic-trace property
extended from message order to latency structure.

Canonical stage chain (monotonic within a span)::

    submit -> payload -> path -> commit -> ready -> executed -> reply

- ``submit``/``reply`` are client-side (events carry ``cid``);
- ``payload`` is the coordinator assigning the dot and owning the
  payload; ``path`` is the fast/slow decision; ``commit`` the commit;
- ``ready`` is the executor's stable/resolved point, ``executed`` the
  KVStore execution (events carry ``pid``; the report keeps the
  coordinator's timeline — ``pid == dot.source`` — so replicated stages
  do not overlap).

``recovery`` is an extra out-of-chain stage stamped when a dot enters
recovery consensus.  *Counter events* (``k == "ctr"``) carry device-plane
tallies (dispatch counts, batch occupancy, recompiles, kernel wall-ms)
attached to the trace timeline.

Beyond spans and counters the schema carries three more event kinds,
added for cross-process critical-path attribution
(:mod:`fantoch_tpu_torch.observability.critpath`):

- ``k == "hdr"``: one header line per log naming the clock domain —
  ``"virtual"`` (sim: one shared clock, no skew) or ``"wall"`` (run
  layer: every process stamps its own wall clock, so the correlator
  must resolve per-peer offsets before cross-process math);
- ``k == "edge"``: one *message-edge* event per side of a cross-process
  hop (``io == "s"`` at the sender, ``"r"`` at the receiver), paired by
  ``(src, seq)`` — a per-sender monotone sequence carried on the wire —
  so a send stitches to its delivery causally, Dapper-style.  Edges are
  sampled by the same deterministic hash as spans (by rifl for
  client<->server hops, by dot for peer protocol messages), so a
  sampled span's edges are present whenever its dot/rifl hashes in;
- ``k == "off"``: a clock-offset estimate for one peer pair
  (``off`` = peer clock minus local clock in us, ``rtt`` the probe
  round-trip that bounds its error), emitted by the run layer whenever
  a heartbeat RTT sample improves the estimate (run/links.py).

Sampling is a deterministic hash of the span id (:func:`span_hash` over
``(rifl.source, rifl.sequence)``) against ``Config.trace_sample_rate``:
the same seed yields the same sampled dot set, with no RNG state touched
(the sim's determinism contract).  With the rate at 0 the tracer is the
:data:`NOOP_TRACER` singleton — one attribute check per hook site.

The log is crash-consistent JSONL: every line is a self-contained event
written with sorted keys and compact separators (same-seed sim runs are
byte-identical); a reader tolerates a truncated final line.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

# canonical per-command stage chain, in lifecycle order
STAGES = (
    "submit",
    "payload",
    # batch release: stamped when the adaptive ingest batcher
    # (run/ingest.py) releases the command's round toward dispatch —
    # payload->ingest IS the ingest-queue + batching wait, so the
    # deadline budget is attributed, never hidden in a merged segment
    "ingest",
    "path",
    "commit",
    "ready",
    "executed",
    "reply",
)
# out-of-chain stages (do not participate in the stage-latency breakdown)
EXTRA_STAGES = ("recovery",)

_MASK64 = (1 << 64) - 1
_SAMPLE_SPACE = 1 << 32


def span_hash(source: int, sequence: int) -> int:
    """Deterministic 32-bit mix of a (source, sequence) id pair
    (splitmix64 finalizer over a golden-ratio combine).  Used for
    sampling: stable across processes and runs, independent of
    PYTHONHASHSEED and of any RNG state."""
    x = (source * 0x9E3779B97F4A7C15 + sequence * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 29
    return x & (_SAMPLE_SPACE - 1)


# --- canonical event builders ---
#
# ONE place constructs each event kind: the live Tracer serializes
# these to JSONL, and the flight recorder (observability/recorder.py)
# rings the same dicts unsampled — so the correlator can never see two
# schemas drift apart.


def span_event(t_us, stage, rifl, dot=None, pid=None, cid=None, meta=None):
    ev: Dict[str, Any] = {
        "k": "span", "stage": stage, "rifl": [rifl[0], rifl[1]], "t": t_us,
    }
    if dot is not None:
        ev["dot"] = [dot[0], dot[1]]
    if pid is not None:
        ev["pid"] = pid
    if cid is not None:
        ev["cid"] = cid
    if meta:
        ev["m"] = meta
    return ev


def counter_event(t_us, name, value, pid=None, meta=None):
    ev: Dict[str, Any] = {"k": "ctr", "name": name, "v": value, "t": t_us}
    if pid is not None:
        ev["pid"] = pid
    if meta:
        ev["m"] = meta
    return ev


def edge_event(t_us, io, mtype, src, dst, seq, dot=None, rifl=None):
    ev: Dict[str, Any] = {
        "k": "edge", "io": io, "mt": mtype, "src": src, "dst": dst,
        "seq": seq, "t": t_us,
    }
    if dot is not None:
        ev["dot"] = [dot[0], dot[1]]
    if rifl is not None:
        ev["rifl"] = [rifl[0], rifl[1]]
    return ev


def offset_event(t_us, pid, peer, offset_us, rtt_us):
    return {
        "k": "off", "pid": pid, "peer": peer, "off": offset_us,
        "rtt": rtt_us, "t": t_us,
    }


def edge_dot(msg: Any):
    """The dot a protocol message's trace edges key on: a single
    ``.dot`` field (MCollect/MCollectAck/MCommit/... across the
    leaderless protocols).  Batched array messages and slot-keyed
    (leader-based) frames carry no single dot — their spans stitch via
    the client edges alone."""
    dot = getattr(msg, "dot", None)
    if isinstance(dot, tuple) and len(dot) == 2:
        return dot
    return None


def _noop() -> "_NoopTracer":
    return NOOP_TRACER


class _NoopTracer:
    """Zero-cost disabled tracer: hook sites guard on ``.enabled`` and
    never build event payloads.  Pickles (and deep-copies) back to the
    module singleton so protocol state holding it stays picklable (the
    model checker pickles whole protocol instances)."""

    enabled = False
    sample_rate = 0.0

    def sample(self, rifl) -> bool:
        return False

    def span(self, stage, rifl, dot=None, pid=None, cid=None, meta=None) -> None:
        pass

    def counter(self, name, value, pid=None, meta=None) -> None:
        pass

    def edge(self, io, mtype, src, dst, seq, dot=None, rifl=None) -> None:
        pass

    def offset(self, pid, peer, offset_us, rtt_us) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __reduce__(self):
        return (_noop, ())


NOOP_TRACER = _NoopTracer()


class Tracer:
    """Lock-light span emitter over a monotonic time source.

    ``time`` is any :class:`fantoch_tpu_torch.core.timing.SysTime` — the sim
    passes its virtual clock, the run layer its wall clock — so emission
    sites never thread timestamps through.  Writes are buffered complete
    lines; ``flush()`` is cheap and the run layer calls it periodically
    (crash consistency = the on-disk prefix is always parseable).
    """

    enabled = True

    def __init__(self, time, path: str, sample_rate: float = 1.0,
                 flush_every: int = 512, clock: str = "virtual"):
        assert clock in ("virtual", "wall"), clock
        self._time = time
        self.path = path
        self.clock = clock
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self._threshold = int(self.sample_rate * _SAMPLE_SPACE)
        self._fh = open(path, "w", buffering=1 << 16)
        self._flush_every = flush_every
        self._pending = 0
        self._closed = False
        # one header line names the clock domain: "wall" logs need the
        # correlator's offset resolution before cross-process math,
        # "virtual" logs share one clock by construction
        self._write({"k": "hdr", "clock": clock, "v": 1})

    # --- sampling ---

    def sample(self, rifl) -> bool:
        """Deterministic verdict for a span id (a Rifl or any
        (source, sequence) pair)."""
        return span_hash(rifl[0], rifl[1]) < self._threshold

    # --- emission ---

    def span(
        self,
        stage: str,
        rifl,
        dot=None,
        pid: Optional[int] = None,
        cid: Optional[int] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        if span_hash(rifl[0], rifl[1]) >= self._threshold:
            return
        self._write(
            span_event(
                self._time.micros(), stage, rifl,
                dot=dot, pid=pid, cid=cid, meta=meta,
            )
        )

    def counter(
        self,
        name: str,
        value,
        pid: Optional[int] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._write(
            counter_event(self._time.micros(), name, value, pid=pid, meta=meta)
        )

    def edge(
        self,
        io: str,
        mtype: str,
        src: int,
        dst: int,
        seq: int,
        dot=None,
        rifl=None,
    ) -> None:
        """One side of a cross-process message hop (``io`` = ``"s"`` at
        the sender, ``"r"`` at the receiver), paired by ``(src, seq)``.
        Sampled by the rifl when given (client<->server hops), else by
        the dot (peer protocol messages) — both through the same hash,
        so a rate-1.0 trace stitches every span."""
        key = rifl if rifl is not None else dot
        if key is None or span_hash(key[0], key[1]) >= self._threshold:
            return
        self._write(
            edge_event(
                self._time.micros(), io, mtype, src, dst, seq,
                dot=dot, rifl=rifl,
            )
        )

    def offset(self, pid: int, peer: int, offset_us: int, rtt_us: int) -> None:
        """A per-peer clock-offset estimate (peer clock minus ``pid``'s,
        microseconds) with the probe RTT that bounds its error — emitted
        whenever a better (lower-RTT) heartbeat sample lands."""
        self._write(
            offset_event(self._time.micros(), pid, peer, offset_us, rtt_us)
        )

    def _write(self, ev: Dict[str, Any]) -> None:
        if self._closed:
            return
        # sorted keys + compact separators: same-seed sim traces must be
        # byte-identical, so serialization is fully canonical
        self._fh.write(json.dumps(ev, sort_keys=True, separators=(",", ":")))
        self._fh.write("\n")
        self._pending += 1
        if self._pending >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._closed:
            self._fh.flush()
            self._pending = 0

    def close(self) -> None:
        if not self._closed:
            self._fh.flush()
            self._fh.close()
            self._closed = True


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL span log; a truncated final line (crash mid-write) is
    dropped, everything before it is returned."""
    out: List[Dict[str, Any]] = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail — the crash-consistent prefix ends here
    return out
