"""Deterministic fault-injection plane for the discrete-event simulator.

The protocols fantoch reproduces (EPaxos, Atlas, Newt, Caesar) claim
liveness and linearizability with up to ``f`` crashed replicas over a
lossy, partitionable network — yet the simulator delivers every message
exactly once over fixed planet latencies.  This module closes that gap in
the spirit of the reference's stateright exploration (``fantoch_mc``): a
:class:`FaultPlan` describes *what* goes wrong and *when* (virtual time),
a :class:`Nemesis` executes the plan with a dedicated seeded RNG, and the
runner (sim/runner.py) consults it at message send/delivery time.  Same
plan + same seed => byte-identical fault trace and committed-command
trace, so every chaos test is replayable.

Fault model (see README "Fault model" for the contract):

* **Link faults** — per-(src, dst) message drop, duplication, and extra
  delay inside a virtual-time window.  Drops default to
  ``retransmit=True``: the underlying channel is lossy but the connection
  layer retries with exponential backoff + jitter, exactly the TCP
  semantics the protocols assume (quasi-reliable links between correct
  processes).  The geometric retry sequence is collapsed into one
  deterministic delivery delay at send time, so retransmission costs no
  extra heap traffic.  ``retransmit=False`` models true message loss
  (protocol liveness is then *not* guaranteed — pair it with the bounded
  wait below).
* **Partitions** — symmetric cuts between process groups from
  ``start_ms`` until ``heal_ms``; crossing messages are deferred until
  just after heal (connection-retry semantics) or dropped forever when
  the partition never heals.
* **Crash** — a process stops at ``at_ms``: inbound messages are dropped,
  its periodic events stop, and clients attached to it are abandoned
  (the runner stops waiting for them).  With ``restart_at_ms`` set the
  crash is a crash-*restart* instead: the process returns to service
  from its durable image (snapshot/restore seam + MSync rejoin; see the
  :class:`Crash` docstring) and its clients are deferred, not abandoned.
* **Pause** — a transient freeze ``[at_ms, until_ms)``: inbound traffic
  and periodic events are deferred and replayed at resume, modelling a
  stop-the-world (GC pause, VM migration) rather than a crash.
* **SlowProcess** — a degraded consumer: deliveries into the process pick
  up a per-message handling delay inside a window, modelling an executor
  draining at a fraction of line rate (the overload plane's seeded
  slow-executor scenario) without being dead or paused.
* **Bounded wait** — ``max_sim_time_ms`` turns a stalled run (e.g. more
  than ``f`` members of an in-flight command's quorum crashed, so even the
  per-dot recovery consensus of ``protocol/recovery.py`` cannot gather an
  n-f promise quorum) into a typed
  :class:`~fantoch_tpu_torch.errors.SimStalledError` instead of an infinite
  loop.  With ``Config.recovery_delay_ms`` set and at most ``f`` crashes,
  stalls *heal* instead: overdue dots go through prepare/promise recovery
  and commit (possibly as noops).
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from fantoch_tpu_torch.errors import SimStalledError  # noqa: F401  (re-export)
from fantoch_tpu_torch.sim.device_faults import DeviceFault

# endpoint keys as used by sim/runner.py: ("process", pid) | ("client", cid)
EndpointKey = Tuple[str, int]


@dataclass(frozen=True)
class LinkFault:
    """Lossy-link behavior for messages src -> dst inside a time window.

    ``src``/``dst`` of None match any endpoint (including clients); an
    integer matches that *process* id.  ``msg_types`` optionally restricts
    the fault to payload class names (e.g. ``("MCommit",)``) — the
    targeted-drop primitive chaos tests use to strand dependencies.
    """

    src: Optional[int] = None
    dst: Optional[int] = None
    drop: float = 0.0
    duplicate: float = 0.0
    extra_delay_ms: int = 0
    # extra delay budget for the DUPLICATED copy only: a large value
    # models a late retransmit — the sender re-sent after losing the ack,
    # and the copy lands long after the original (possibly after the
    # commit went stable-everywhere and was GC'd: the straggler schedules
    # the GC-straggler guards exist for, and the one that reaches a
    # commit-replay bug when those guards are off)
    duplicate_delay_ms: int = 0
    from_ms: int = 0
    until_ms: Optional[int] = None
    retransmit: bool = True
    msg_types: Optional[Tuple[str, ...]] = None

    def matches(self, now: int, src: Optional[int], dst: Optional[int], msg: Any) -> bool:
        if now < self.from_ms:
            return False
        if self.until_ms is not None and now >= self.until_ms:
            return False
        if self.src is not None and self.src != src:
            return False
        if self.dst is not None and self.dst != dst:
            return False
        if self.msg_types is not None and type(msg).__name__ not in self.msg_types:
            return False
        return True


@dataclass(frozen=True)
class Partition:
    """Symmetric cut between process groups during [start_ms, heal_ms).

    Processes in different groups cannot exchange messages while the
    partition is active; ``heal_ms=None`` never heals.  Processes in no
    group are unaffected (reachable from everyone).
    """

    groups: Tuple[Tuple[int, ...], ...]
    start_ms: int
    heal_ms: Optional[int] = None

    def active(self, now: int) -> bool:
        return now >= self.start_ms and (self.heal_ms is None or now < self.heal_ms)

    def separates(self, a: int, b: int) -> bool:
        ga = gb = None
        for index, group in enumerate(self.groups):
            if a in group:
                ga = index
            if b in group:
                gb = index
        return ga is not None and gb is not None and ga != gb


@dataclass(frozen=True)
class Crash:
    """A process failure at ``at_ms``, in one of two modes:

    * **Crash-forever** (``restart_at_ms=None``, the original behavior):
      the process stops for good — inbound messages are dropped, its
      periodic events stop, and clients attached to it are abandoned.
      Every such crash permanently burns one unit of the ``n - f``
      budget.
    * **Crash-restart** (``restart_at_ms`` set): the process loses all
      volatile state at ``at_ms`` and returns to service at
      ``restart_at_ms``.  The runner captures a *durable image* at the
      crash instant — the ``snapshot()`` seam on Protocol and Executor,
      modelling a synchronous WAL (``wal_sync=always``: every input
      applied before the crash was logged and is replayed; messages in
      flight at the crash are lost) — and at restart rebuilds the
      process from that image via ``restore()``, reschedules its
      periodic events, and runs the rejoin protocol
      (``Protocol.rejoin`` -> MSync catch-up from live peers, bounded by
      the executed-everywhere GC retention).  While the process is down,
      process-to-process messages to it are dropped (peers declared it
      dead); *client* messages are deferred past the restart with
      retransmit jitter (the client-reconnect-and-resubmit semantics of
      the run layer's reliable links), so its clients are NOT abandoned.
      A restarted process restores the full ``n - f`` tolerance budget —
      the chaos matrix asserts a *subsequent* crash of a different
      process still completes.
    """

    process_id: int
    at_ms: int
    restart_at_ms: Optional[int] = None

    def __post_init__(self) -> None:
        assert self.restart_at_ms is None or self.restart_at_ms > self.at_ms


@dataclass(frozen=True)
class Pause:
    process_id: int
    at_ms: int
    until_ms: int


@dataclass(frozen=True)
class SlowProcess:
    """Degraded-consumer nemesis (the overload plane's seeded scenario):
    while active, every message INTO ``process_id`` picks up ``slow_ms``
    of extra delivery delay (plus ``jitter_ms`` drawn from the nemesis
    RNG) — modelling an executor that drains its queues at a fraction of
    line rate (a wedged device, a GC-thrashing host) without being dead.
    Applied once per message at send time, so liveness is preserved and
    the slowdown is deterministic under the plan seed.  ``until_ms=None``
    never recovers."""

    process_id: int
    slow_ms: int
    from_ms: int = 0
    until_ms: Optional[int] = None
    jitter_ms: int = 0

    def active(self, now: int) -> bool:
        return now >= self.from_ms and (
            self.until_ms is None or now < self.until_ms
        )


@dataclass(frozen=True)
class ReorderJitter:
    """Seeded message-reorder nemesis: while active, every scheduled
    delivery's latency is multiplied by U(0, ``factor``) drawn from the
    nemesis RNG — the adversity the reference's sim applies globally
    (runner.rs:192-198, delivery delay x U(0, 10)), promoted from the
    runner's ad-hoc ``reorder_messages()`` knob to a first-class,
    windowable member of the fault plan so the chaos fuzzer can compose
    it with every other nemesis.  ``factor`` below 1 never happens for
    the whole window (a draw of 0 collapses latency to 0, maximally
    reordering against in-flight messages)."""

    factor: float = 10.0
    from_ms: int = 0
    until_ms: Optional[int] = None

    def active(self, now: int) -> bool:
        return now >= self.from_ms and (
            self.until_ms is None or now < self.until_ms
        )


@dataclass(frozen=True)
class FaultPlan:
    """Declarative, immutable fault schedule (builder-style constructors).

    The plan owns the determinism contract: every random decision the
    nemesis makes is drawn from ``random.Random(seed)`` in simulation
    order, so two runs of the same (plan, workload, sim seed) produce
    byte-identical traces.
    """

    seed: int = 0
    link_faults: Tuple[LinkFault, ...] = ()
    partitions: Tuple[Partition, ...] = ()
    crashes: Tuple[Crash, ...] = ()
    pauses: Tuple[Pause, ...] = ()
    slow_processes: Tuple[SlowProcess, ...] = ()
    # accelerator faults (sim/device_faults.py): deterministic dispatch
    # hangs / XLA raises / resident bit-flips against a process's device
    # plane, windowed in dispatch counts (not time) so same-seed runs
    # replay bit-identically.  Only meaningful on plane-enabled configs;
    # the runner attaches one injector per targeted process
    device_faults: Tuple["DeviceFault", ...] = ()
    reorder: Optional[ReorderJitter] = None
    # failure-detector model: when set, every crash-FOREVER is announced
    # to all live processes ``detector_delay_ms`` after the crash via
    # ``Protocol.on_peer_down`` — the sim analog of the run layer's
    # silence-based heartbeat detector (run/process_runner.py).  FPaxos
    # needs it to route accept rounds around a dead write-quorum member;
    # the leaderless protocols' hook is a no-op.  None (the default)
    # keeps the detector-less legacy model and byte-identical old traces
    detector_delay_ms: Optional[int] = None
    # base RTO for the collapsed retransmission sequence
    retransmit_base_ms: int = 25
    # bounded wait: virtual-time budget before a stalled run raises
    max_sim_time_ms: Optional[int] = None

    # --- builders ---

    def with_link_fault(self, **kwargs) -> "FaultPlan":
        return dataclasses.replace(
            self, link_faults=self.link_faults + (LinkFault(**kwargs),)
        )

    def with_loss(self, drop: float, **kwargs) -> "FaultPlan":
        """Uniform loss on every link (retransmitted by default)."""
        return self.with_link_fault(drop=drop, **kwargs)

    def with_crash(
        self, process_id: int, at_ms: int, restart_at_ms: Optional[int] = None
    ) -> "FaultPlan":
        """Crash-forever by default; pass ``restart_at_ms`` for a
        deterministic crash-and-restart (see :class:`Crash`)."""
        return dataclasses.replace(
            self, crashes=self.crashes + (Crash(process_id, at_ms, restart_at_ms),)
        )

    def with_pause(self, process_id: int, at_ms: int, until_ms: int) -> "FaultPlan":
        assert until_ms > at_ms
        return dataclasses.replace(
            self, pauses=self.pauses + (Pause(process_id, at_ms, until_ms),)
        )

    def with_slow_process(
        self,
        process_id: int,
        slow_ms: int,
        from_ms: int = 0,
        until_ms: Optional[int] = None,
        jitter_ms: int = 0,
    ) -> "FaultPlan":
        """Degraded-consumer window: the seeded slow-executor scenario
        the overload chaos rows are built on (see :class:`SlowProcess`)."""
        assert slow_ms > 0
        return dataclasses.replace(
            self,
            slow_processes=self.slow_processes
            + (SlowProcess(process_id, slow_ms, from_ms, until_ms, jitter_ms),),
        )

    def with_partition(
        self, groups, start_ms: int, heal_ms: Optional[int] = None
    ) -> "FaultPlan":
        part = Partition(tuple(tuple(g) for g in groups), start_ms, heal_ms)
        return dataclasses.replace(self, partitions=self.partitions + (part,))

    def with_reorder(
        self,
        factor: float = 10.0,
        from_ms: int = 0,
        until_ms: Optional[int] = None,
    ) -> "FaultPlan":
        """Seeded delivery-reorder jitter (see :class:`ReorderJitter`)."""
        assert factor > 0
        return dataclasses.replace(
            self, reorder=ReorderJitter(factor, from_ms, until_ms)
        )

    def with_device_fault(
        self,
        process_id: int,
        plane: str,
        kind: str,
        at_dispatch: int,
        down_dispatches: int = 4,
    ) -> "FaultPlan":
        """Deterministic accelerator failure against one process's
        device plane (see :class:`~fantoch_tpu_torch.sim.device_faults
        .DeviceFault`): windowed in dispatch counts so the firing point
        is schedule-exact across same-seed runs."""
        fault = DeviceFault(
            plane=plane,
            kind=kind,
            at_dispatch=at_dispatch,
            down_dispatches=down_dispatches,
            process_id=process_id,
        )
        return dataclasses.replace(
            self, device_faults=self.device_faults + (fault,)
        )

    def crashed_ids(self) -> Tuple[int, ...]:
        return tuple(sorted({c.process_id for c in self.crashes}))

    # --- repro serialization (sim/fuzz.py artifacts) ---

    def to_dict(self) -> dict:
        """JSON-safe representation; round-trips via :meth:`from_dict`
        (the fuzzer's repro artifacts serialize plans this way)."""
        out = dataclasses.asdict(self)
        # asdict turns nested dataclasses into dicts but leaves tuples;
        # JSON round-trips tuples as lists, so from_dict re-tuples
        return out

    @staticmethod
    def from_dict(data: dict) -> "FaultPlan":
        return FaultPlan(
            seed=data.get("seed", 0),
            link_faults=tuple(
                LinkFault(**{**f, "msg_types": (
                    tuple(f["msg_types"]) if f.get("msg_types") else None
                )})
                for f in data.get("link_faults", ())
            ),
            partitions=tuple(
                Partition(
                    tuple(tuple(g) for g in p["groups"]),
                    p["start_ms"],
                    p.get("heal_ms"),
                )
                for p in data.get("partitions", ())
            ),
            crashes=tuple(
                Crash(**c) for c in data.get("crashes", ())
            ),
            pauses=tuple(Pause(**p) for p in data.get("pauses", ())),
            slow_processes=tuple(
                SlowProcess(**s) for s in data.get("slow_processes", ())
            ),
            device_faults=tuple(
                DeviceFault(**d) for d in data.get("device_faults", ())
            ),
            reorder=(
                ReorderJitter(**data["reorder"])
                if data.get("reorder") is not None
                else None
            ),
            detector_delay_ms=data.get("detector_delay_ms"),
            retransmit_base_ms=data.get("retransmit_base_ms", 25),
            max_sim_time_ms=data.get("max_sim_time_ms"),
        )


@dataclass
class NemesisMark:
    """Trace/bookkeeping marker the runner schedules at plan timestamps
    (crash / pause / resume / partition / heal) so state transitions are
    visible in the event trace and crash-time client accounting runs at
    the right virtual instant."""

    kind: str
    detail: str
    process_id: Optional[int] = None


# delivery verdicts for Nemesis.on_deliver
DELIVER = "deliver"
DROP = "drop"
DEFER = "defer"

_MAX_RETRANSMITS = 64


class Nemesis:
    """Executes a :class:`FaultPlan` over the simulator's message flow."""

    def __init__(self, plan: FaultPlan):
        import random

        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.trace: List[Tuple[int, str, str]] = []
        # pid -> [(at_ms, restart_at_ms | None)] downtime windows; None
        # restart = crash-forever (a pid may crash again after a restart)
        self._crash_windows: dict = {}
        for crash in plan.crashes:
            self._crash_windows.setdefault(crash.process_id, []).append(
                (crash.at_ms, crash.restart_at_ms)
            )

    # --- trace ---

    def record(self, now: int, kind: str, detail: str) -> None:
        self.trace.append((now, kind, detail))

    def trace_lines(self) -> List[str]:
        return [f"t={t}ms {kind} {detail}" for t, kind, detail in self.trace]

    def trace_digest(self) -> str:
        digest = hashlib.sha256()
        for line in self.trace_lines():
            digest.update(line.encode())
            digest.update(b"\n")
        return digest.hexdigest()

    # --- fault state (pure functions of virtual time) ---

    def is_dead(self, process_id: int, now: int) -> bool:
        for at, restart in self._crash_windows.get(process_id, ()):
            if now >= at and (restart is None or now < restart):
                return True
        return False

    def restart_pending(self, process_id: int, now: int) -> Optional[int]:
        """The restart time of the downtime window covering ``now``, or
        None when the process is alive or crashed forever."""
        for at, restart in self._crash_windows.get(process_id, ()):
            if now >= at and restart is not None and now < restart:
                return restart
        return None

    def paused_until(self, process_id: int, now: int) -> Optional[int]:
        for pause in self.plan.pauses:
            if pause.process_id == process_id and pause.at_ms <= now < pause.until_ms:
                return pause.until_ms
        return None

    def marks(self) -> List[Tuple[int, NemesisMark]]:
        """(at_ms, mark) pairs the runner schedules up front."""
        out: List[Tuple[int, NemesisMark]] = []
        for crash in self.plan.crashes:
            out.append(
                (crash.at_ms, NemesisMark("crash", f"p{crash.process_id}", crash.process_id))
            )
            if crash.restart_at_ms is not None:
                out.append(
                    (
                        crash.restart_at_ms,
                        NemesisMark("restart", f"p{crash.process_id}", crash.process_id),
                    )
                )
        for pause in self.plan.pauses:
            out.append((pause.at_ms, NemesisMark("pause", f"p{pause.process_id}")))
            out.append((pause.until_ms, NemesisMark("resume", f"p{pause.process_id}")))
        for slow in self.plan.slow_processes:
            out.append(
                (
                    slow.from_ms,
                    NemesisMark("slow", f"p{slow.process_id} +{slow.slow_ms}ms"),
                )
            )
            if slow.until_ms is not None:
                out.append(
                    (slow.until_ms, NemesisMark("slow-end", f"p{slow.process_id}"))
                )
        for part in self.plan.partitions:
            groups = "|".join(",".join(map(str, g)) for g in part.groups)
            out.append((part.start_ms, NemesisMark("partition", groups)))
            if part.heal_ms is not None:
                out.append((part.heal_ms, NemesisMark("heal", groups)))
        reorder = self.plan.reorder
        if reorder is not None:
            out.append(
                (reorder.from_ms, NemesisMark("reorder", f"x{reorder.factor}"))
            )
            if reorder.until_ms is not None:
                out.append((reorder.until_ms, NemesisMark("reorder-end", "")))
        return out

    # --- send path ---

    @staticmethod
    def _pid(key: EndpointKey) -> Optional[int]:
        kind, id_ = key
        return id_ if kind == "process" else None

    def on_send(
        self,
        now: int,
        from_key: EndpointKey,
        to_key: EndpointKey,
        base_delay_ms: int,
        msg: Any,
    ) -> List[int]:
        """Delivery delays for one message: ``[]`` = dropped forever,
        one entry = normal (possibly retransmission-delayed) delivery,
        two entries = delivered + duplicated."""
        src, dst = self._pid(from_key), self._pid(to_key)
        reorder = self.plan.reorder
        if reorder is not None and reorder.active(now):
            # seeded reorder jitter: scale the base latency by U(0, factor)
            # BEFORE any fault branch, so deferred/retransmitted deliveries
            # compound on the reordered latency like real adversity would
            base_delay_ms = int(
                base_delay_ms * self.rng.uniform(0.0, reorder.factor)
            )
        label = f"{from_key[0]}{from_key[1]}->{to_key[0]}{to_key[1]} {type(msg).__name__}"
        if dst is not None and self.is_dead(dst, now):
            restart = self.restart_pending(dst, now)
            if restart is not None and from_key[0] == "client":
                # client traffic to a down-but-restarting process defers
                # past the restart (the client reconnects and resubmits —
                # the run layer's reliable-link semantics); peer traffic
                # still drops: peers declared the process dead and the
                # rejoin protocol, not the network, replays history
                delay = (
                    (restart - now)
                    + base_delay_ms
                    + self.rng.randint(1, self.plan.retransmit_base_ms)
                )
                self.record(now, "defer-restart", f"{label} +{delay}ms")
                return [delay]
            self.record(now, "drop-dead", label)
            return []
        delay = base_delay_ms
        if src is not None and dst is not None:
            for part in self.plan.partitions:
                if part.active(now) and part.separates(src, dst):
                    if part.heal_ms is None:
                        self.record(now, "drop-partition", label)
                        return []
                    # connection-level retry: delivered just after heal
                    delay = (
                        (part.heal_ms - now)
                        + base_delay_ms
                        + self.rng.randint(1, self.plan.retransmit_base_ms)
                    )
                    self.record(now, "defer-partition", f"{label} +{delay}ms")
                    break
        if dst is not None:
            # degraded-consumer nemesis: deliveries into a slowed process
            # pick up its handling delay (once, at send time — liveness
            # preserved, determinism via the plan RNG)
            for slow in self.plan.slow_processes:
                if slow.process_id == dst and slow.active(now):
                    extra = slow.slow_ms
                    if slow.jitter_ms:
                        extra += self.rng.randint(0, slow.jitter_ms)
                    delay += extra
                    break
        # EVERY matching fault composes (drop-with-retransmit delays,
        # extra delays, then duplication).  First-match-only semantics —
        # the original behavior — silently disabled a plan's targeted
        # dup/delay faults whenever a catch-all loss fault preceded them,
        # which is exactly how fuzzed schedules compose them
        matching = [
            f for f in self.plan.link_faults if f.matches(now, src, dst, msg)
        ]
        if not matching:
            return [delay]
        for fault in matching:
            if fault.drop and self.rng.random() < fault.drop:
                if not fault.retransmit:
                    self.record(now, "drop", label)
                    return []
                # collapse the geometric retry sequence (exponential
                # backoff, full jitter, capped) into one deterministic
                # extra delay
                rto = self.plan.retransmit_base_ms
                extra = 0
                attempts = 1
                while attempts < _MAX_RETRANSMITS:
                    extra += rto + self.rng.randint(0, rto)
                    rto = min(rto * 2, 8 * self.plan.retransmit_base_ms)
                    attempts += 1
                    if self.rng.random() >= fault.drop:
                        break
                delay += extra
                self.record(now, "retransmit", f"{label} x{attempts} +{extra}ms")
            if fault.extra_delay_ms:
                jitter = self.rng.randint(0, fault.extra_delay_ms)
                delay += jitter
                if jitter:
                    self.record(now, "delay", f"{label} +{jitter}ms")
        delays = [delay]
        # duplication only applies between processes: client channels carry
        # submit/result frames the client layer does not dedup (the run
        # layer's seq-numbered peer links are the real-world analog).  At
        # most one duplicate copy is produced (the first fault to roll it)
        for fault in matching:
            if (
                fault.duplicate
                and src is not None
                and dst is not None
                and self.rng.random() < fault.duplicate
            ):
                dup = delay + self.rng.randint(
                    1,
                    max(1, self.plan.retransmit_base_ms)
                    + fault.duplicate_delay_ms,
                )
                delays.append(dup)
                self.record(now, "duplicate", f"{label} +{dup}ms")
                break
        return delays

    # --- delivery path ---

    def on_deliver(self, now: int, process_id: int) -> Tuple[str, Optional[int]]:
        """Verdict for an action about to be handled by ``process_id``:
        (DELIVER, None) | (DROP, None) | (DEFER, resume_at_ms)."""
        if self.is_dead(process_id, now):
            return DROP, None
        until = self.paused_until(process_id, now)
        if until is not None:
            return DEFER, until
        return DELIVER, None
