"""Deterministic discrete-event simulator over Planet latencies.

Reference: fantoch/src/sim/runner.rs:33-700.  Processes live in regions;
message delivery takes half the ping latency between regions; periodic
events (protocol events + executor executed-notifications) are rescheduled
forever, so the loop ends when clients finish (plus optional extra time).
Optional adversity: symmetric distances, and random message reordering
(delivery delay multiplied by U(0, 10)) to stress executor ordering.

The port of fantoch_tpu/sim/runner.py.  ``Runner(..., device=...)`` names
the card each process's executor orders its commits on (default
``"cuda"``; the tests pass ``"cpu"``, where every kernel runs its plain
version).  A device fault from the fault plan fails its plane with a
typed error that ends the run (after the nemesis records it and the
flight ring is dumped): the port's planes never fail over to their host
twin as the JAX package's do.
"""

from __future__ import annotations

import copy
import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from fantoch_tpu_torch.client.client import Client
from fantoch_tpu_torch.client.workload import Workload
from fantoch_tpu_torch.core.command import Command, CommandResult
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import ClientId, ProcessId, ShardId, process_ids
from fantoch_tpu_torch.core.metrics import Histogram, Metrics
from fantoch_tpu_torch.core.planet import Planet, Region
from fantoch_tpu_torch.errors import FaultToleranceError, SimStalledError
from fantoch_tpu_torch.executor.monitor import ExecutionOrderMonitor
from fantoch_tpu_torch.observability.tracer import NOOP_TRACER, Tracer, edge_dot
from fantoch_tpu_torch.protocol.base import Protocol, ToForward, ToSend
from fantoch_tpu_torch.run.ingest import (
    AdaptiveIngestBatcher,
    requested_ingest_deadline_ms,
    resolve_ingest_target,
)
from fantoch_tpu_torch.sim.faults import DEFER, DELIVER, DROP, FaultPlan, Nemesis, NemesisMark
from fantoch_tpu_torch.sim.schedule import Schedule
from fantoch_tpu_torch.sim.simulation import Simulation
from fantoch_tpu_torch.utils import closest_process_per_shard, sort_processes_by_distance


# schedule actions (runner.rs:20-26)
@dataclass
class SubmitToProc:
    process_id: ProcessId
    cmd: Command


@dataclass
class SendToProc:
    from_: ProcessId
    from_shard_id: ShardId
    to: ProcessId
    msg: Any
    # message-edge sequence for cross-process span stitching (set when
    # the message's dot is trace-sampled): the delivery emits the recv
    # half pairing with the send event stamped at schedule time.  A
    # nemesis-duplicated delivery shares the seq — the correlator keeps
    # the earliest receive, which is what unblocks the receiver
    edge_seq: Optional[int] = None


@dataclass
class SendToClient:
    client_id: ClientId
    cmd_result: CommandResult


@dataclass
class PeriodicProcessEvent:
    process_id: ProcessId
    event: Any
    delay_ms: int


@dataclass
class PeriodicExecutedNotification:
    process_id: ProcessId
    delay_ms: int


@dataclass
class OpenLoopArrival:
    """One open-loop client's next arrival tick: at handling time the
    client generates its next command (submitted regardless of
    completions) and the following arrival is scheduled at a seeded
    exponential gap — the virtual-time Poisson analog of the run layer's
    ``arrival_rate_per_s`` pacing (run/backpressure.OpenLoopPacer).  The
    overload plane's load instrument: closed-loop sim clients
    self-throttle and can never push the system past saturation."""

    client_id: ClientId


@dataclass
class IngestRelease:
    """Deadline tick of one process's adaptive ingest buffer
    (run/ingest.py wired into the sim): when it fires, the buffered
    submissions release toward the protocol unless a size-triggered
    release already emptied the buffer — then the tick re-polls and
    either stands down or rearms for the freshly opened window.  Riding
    the schedule keeps the batcher on virtual time: same seed, same
    release instants, byte-identical traces."""

    process_id: ProcessId


@dataclass
class TelemetryTick:
    """Virtual-time telemetry window boundary: every
    ``Config.telemetry_interval_ms`` (default 1 s) the runner emits one
    window line per process plus one for the client plane into the
    telemetry series (observability/timeseries.py).  Ticks only *read*
    state and their schedule is seed-independent, so same-seed runs emit
    byte-identical series — the determinism contract extended from
    traces to telemetry."""

    delay_ms: int


@dataclass
class PeerDownNotification:
    """Failure-detector tick (FaultPlan.detector_delay_ms): announce a
    crashed-forever process to every live protocol via
    ``Protocol.on_peer_down`` — the sim analog of the run layer's
    heartbeat detector (FPaxos reroutes accept rounds around dead
    write-quorum members on it; leaderless protocols no-op)."""

    dead: ProcessId


@dataclass
class PeriodicExecutorWatchdog:
    """Bounded-wait liveness check: under a fault plan, every executor's
    ``monitor_pending`` runs on this tick so a command stuck on
    dependencies from a dead replica surfaces a typed error instead of
    hanging the run (Config.executor_pending_fail_ms)."""

    process_id: ProcessId
    delay_ms: int


class Runner:
    def __init__(
        self,
        protocol_cls: type,
        planet: Planet,
        config: Config,
        workload: Workload,
        clients_per_process: int,
        process_regions: List[Region],
        client_regions: List[Region],
        seed: Optional[int] = None,
        fault_plan: Optional[FaultPlan] = None,
        trace_path: Optional[str] = None,
        open_loop_rate_per_s: Optional[float] = None,
        telemetry_path: Optional[str] = None,
        flight_dir: Optional[str] = None,
        device="cuda",
    ):
        assert len(process_regions) == config.n, "one region per process"
        assert config.gc_interval_ms is not None, "sim requires gc running"
        assert open_loop_rate_per_s is None or open_loop_rate_per_s > 0
        # open-loop mode: seeded Poisson arrivals at this per-client rate
        # drive submissions (closed loop submits on completion otherwise)
        self._open_loop_rate = open_loop_rate_per_s
        self._protocol_cls = protocol_cls
        # the card every executor's device plane (graph or table) lives on
        self._device = device
        self._planet = planet
        self._config = config
        self._simulation = Simulation()
        self._schedule: Schedule = Schedule()
        self._rng = random.Random(seed)
        # deterministic seed for the device-plane shadow sampler (the
        # fault plane hashes seed:plane:dispatch, so same-seed runs make
        # identical shadow decisions)
        self._seed = seed if seed is not None else 0
        self._make_distances_symmetric = False
        self._reorder_messages = False
        self._nemesis: Optional[Nemesis] = (
            Nemesis(fault_plan) if fault_plan is not None else None
        )
        # lifecycle tracing (fantoch_tpu/observability): virtual-clock
        # spans over the shared sim time source — same seed, same virtual
        # timestamps, byte-identical span log
        self._tracer = NOOP_TRACER
        if trace_path is not None and config.trace_sample_rate > 0:
            self._tracer = Tracer(
                self._simulation.time, trace_path, config.trace_sample_rate
            )
        # failure flight recorder (observability/recorder.py): one shared
        # ring for the whole sim (events carry their pid), dumped split
        # into flight_p<pid>.json files when a typed stall/violation
        # escapes the loop — the sim twin of the run layer's per-process
        # black boxes, correlated by the same critpath stitching
        self._flight = None
        self._flight_dir = flight_dir
        if flight_dir is not None or config.flight_recorder:
            from fantoch_tpu_torch.observability.recorder import FlightRecorder

            self._flight_dir = flight_dir if flight_dir is not None else "."
            self._flight = FlightRecorder(
                self._simulation.time, inner=self._tracer, clock="virtual"
            )
            self._tracer = self._flight
        # per-sender message-edge sequences (cross-process stitching)
        self._edge_seqs: Dict[ProcessId, int] = {}
        # black boxes written by this runner (filled on typed failures,
        # or by an explicit dump_flight call)
        self.flight_dumps: List[str] = []
        # live telemetry (observability/timeseries.py): windowed series on
        # the virtual timeline — one window line per process + one for the
        # client plane per tick, byte-identical for same-seed runs
        self._telemetry = None
        self._telemetry_interval_ms = 0
        if telemetry_path is not None:
            from fantoch_tpu_torch.observability.timeseries import (
                DEFAULT_WINDOW_MS,
                SeriesWriter,
            )

            self._telemetry_interval_ms = (
                config.telemetry_interval_ms or DEFAULT_WINDOW_MS
            )
            self._telemetry = SeriesWriter(
                telemetry_path,
                self._simulation.time,
                window_ms=self._telemetry_interval_ms,
            )
        # telemetry tallies: client submissions/replies (cluster level)
        # and per-process submit deliveries; the latency histogram is
        # maintained incrementally via the client observer seam (O(1)
        # per completion — never re-walked per window)
        self._client_submits = 0
        self._client_replies = 0
        self._submit_counts: Dict[ProcessId, int] = {}
        self._client_latency = Histogram()
        # adaptive ingest batching (run/ingest.py), opt-in: engages only
        # when a channel *requested* a deadline (Config field or env) and
        # it is positive — 0 and unset both mean the legacy
        # submit-immediately path, so the existing sim matrix is
        # bit-for-bit unchanged.  One batcher + buffer per process, all
        # on the virtual clock.
        deadline = requested_ingest_deadline_ms(None, config)
        self._ingest_deadline_ms = (
            deadline if deadline is not None and deadline > 0 else None
        )
        self._ingest_batchers: Dict[ProcessId, AdaptiveIngestBatcher] = {}
        self._ingest_buffers: Dict[ProcessId, List[Command]] = {}
        self._ingest_tick_armed: Dict[ProcessId, bool] = {}

        # a single shard in simulation
        shard_id = 0
        to_discover: List[Tuple[ProcessId, ShardId, Region]] = []
        processes: List[Tuple[Region, Protocol]] = []
        periodic_events: List[Tuple[ProcessId, Any, int]] = []
        periodic_executed: List[Tuple[ProcessId, int]] = []
        for region, process_id in zip(process_regions, process_ids(shard_id, config.n)):
            process, events = protocol_cls.new(process_id, shard_id, config)
            processes.append((region, process))
            periodic_events.extend((process_id, ev, delay) for ev, delay in events)
            interval = config.executor_executed_notification_interval_ms
            if interval is not None:
                periodic_executed.append((process_id, interval))
            to_discover.append((process_id, shard_id, region))

        self._process_to_region: Dict[ProcessId, Region] = {
            pid: region for pid, _, region in to_discover
        }
        # crash-restart plane: durable images captured at crash instants
        # (pid -> (protocol snapshot, executor snapshot, pending copy))
        # and the periodic-event actions dropped while a restarting
        # process was down (rescheduled at restart — each periodic stream
        # has exactly one live action, so a dropped one must come back)
        self._durable_images: Dict[ProcessId, Tuple[bytes, bytes, Any]] = {}
        self._stalled_periodics: Dict[ProcessId, List[Any]] = {}

        # register processes (discover with distance-sorted lists)
        for region, process in processes:
            sorted_processes = sort_processes_by_distance(region, planet, to_discover)
            connect_ok, _ = process.discover(sorted_processes)
            assert connect_ok
            executor = protocol_cls.Executor(
                process.id, process.shard_id, config, device=device
            )
            process.set_device(device)
            process.set_tracer(self._tracer)
            executor.set_tracer(self._tracer)
            self._arm_device_faults(executor, process.id)
            self._simulation.register_process(process, executor)

        # register clients
        client_id = 0
        self._client_to_region: Dict[ClientId, Region] = {}
        for region in client_regions:
            for _ in range(clients_per_process):
                client_id += 1
                client = Client(client_id, workload, rng=random.Random(self._rng.random()))
                closest = closest_process_per_shard(region, planet, to_discover)
                client.connect(closest)
                if self._telemetry is not None:
                    client.set_latency_observer(
                        lambda latency_us: self._client_latency.increment(
                            latency_us // 1000
                        )
                    )
                self._simulation.register_client(client)
                self._client_to_region[client_id] = region
        self._client_count = client_id
        # clients still owed results; crashes remove the ones attached to
        # dead processes so the loop does not wait for them forever
        self._active_clients = set(self._client_to_region)

        # schedule periodic events
        for process_id, event, delay in periodic_events:
            self._schedule.schedule(
                self._simulation.time, delay, PeriodicProcessEvent(process_id, event, delay)
            )
        for process_id, delay in periodic_executed:
            self._schedule.schedule(
                self._simulation.time, delay, PeriodicExecutedNotification(process_id, delay)
            )

        # telemetry windows ride the schedule like any periodic stream
        if self._telemetry is not None:
            self._schedule.schedule(
                self._simulation.time,
                self._telemetry_interval_ms,
                TelemetryTick(self._telemetry_interval_ms),
            )

        # fault plan: schedule state-transition marks at their virtual
        # timestamps, plus the executor bounded-wait watchdog
        if self._nemesis is not None:
            for at_ms, mark in self._nemesis.marks():
                self._schedule.schedule(self._simulation.time, at_ms, mark)
            watchdog = config.executor_monitor_pending_interval_ms
            if watchdog is not None:
                for pid in self._process_to_region:
                    self._schedule.schedule(
                        self._simulation.time,
                        watchdog,
                        PeriodicExecutorWatchdog(pid, watchdog),
                    )

    def _arm_device_faults(self, executor, process_id: ProcessId) -> None:
        """Wire the accelerator fault plane into this executor's device
        planes (no-op when it drives none): re-seed the shadow sampler
        from the sim seed, attach the FaultPlan's DeviceFault injector
        (per-process — every replica counts its own dispatches), and a
        failure listener that records each failure in the nemesis trace
        (under the JAX package's ``device-failover`` name) and dumps the
        flight ring (the black box for device failures).  The typed
        error then ends the run."""
        planes = executor.device_planes()
        if not planes:
            return
        for plane in planes:
            plane.configure_faults(
                self._config, seed=self._seed, process_id=process_id
            )
        device_faults = (
            self._nemesis.plan.device_faults
            if self._nemesis is not None
            else ()
        )
        if device_faults:
            from fantoch_tpu_torch.sim.device_faults import DeviceFaultInjector

            def record(plane_name, kind, dispatch, detail, _pid=process_id):
                self._nemesis.record(
                    self._simulation.time.millis(),
                    f"device-{kind}",
                    f"p{_pid}:{plane_name}@{dispatch} {detail}",
                )

            injector = DeviceFaultInjector(
                device_faults, process_id=process_id, record=record
            )
            for plane in planes:
                plane.attach_injector(injector)

        def on_failure(plane, exc, _pid=process_id):
            if self._nemesis is not None:
                self._nemesis.record(
                    self._simulation.time.millis(),
                    "device-failover",
                    f"p{_pid}:{plane.plane_name} {type(exc).__name__}",
                )
            self.dump_flight(f"device-failover-p{_pid}-{plane.plane_name}")

        for plane in planes:
            plane.attach_failure_listener(on_failure)

    # --- adversity knobs (runner.rs:192-198) ---

    def make_distances_symmetric(self) -> None:
        self._make_distances_symmetric = True

    def reorder_messages(self) -> None:
        self._reorder_messages = True

    @property
    def tracer(self):
        return self._tracer

    def dump_flight(self, reason: str) -> List[str]:
        """Dump the flight ring on demand (no-op without a recorder):
        the post-run trigger for failures that do not raise — an
        auditor ``Violation`` classifies a *completed* run as unsafe,
        and its black box is this ring."""
        if self._flight is None:
            return []
        paths = self._flight.dump_all(self._flight_dir, reason)
        self.flight_dumps = paths
        return paths

    @property
    def nemesis(self) -> Optional[Nemesis]:
        return self._nemesis

    # --- main loop ---

    def run(
        self, extra_sim_time_ms: Optional[int] = None
    ) -> Tuple[
        Dict[ProcessId, Metrics],
        Dict[ProcessId, Optional[ExecutionOrderMonitor]],
        Dict[Region, Tuple[int, Histogram]],
    ]:
        """Run to completion; returns (process metrics, executor monitors,
        per-region (issued commands, latency histogram ms))."""
        tracer = self._tracer
        self.flight_dumps = []
        if self._open_loop_rate is not None:
            # open loop: arrivals drive submissions; the first arrival of
            # each client is itself an exponential gap from t=0
            for client_id in sorted(self._client_to_region):
                self._schedule_arrival(client_id)
        else:
            for client_id, process_id, cmd in self._simulation.start_clients():
                if tracer.enabled:
                    tracer.span("submit", cmd.rifl, cid=client_id)
                self._schedule_submit(("client", client_id), process_id, cmd)
        try:
            self._simulation_loop(extra_sim_time_ms)
        except (FaultToleranceError, AssertionError) as exc:
            # typed stalls (StalledExecutionError / SimStalledError /
            # divergence) and internal safety assertions are the flight
            # recorder's trigger: dump every live process's black box
            # before the error propagates (fuzz attaches these to repro
            # artifacts)
            if self._flight is not None:
                self.flight_dumps = self._flight.dump_all(
                    self._flight_dir, f"{type(exc).__name__}: {exc}"
                )
            raise
        finally:
            # flush+close so the span log is complete (and readable) even
            # when the loop raises a typed stall error
            tracer.close()
            if self._telemetry is not None:
                self._telemetry.close()
        return (
            {pid: p.metrics() for pid, (p, _, _) in self._simulation.processes()},
            {pid: e.monitor() for pid, (_, e, _) in self._simulation.processes()},
            self._clients_latencies(),
        )

    def _simulation_loop(self, extra_sim_time_ms: Optional[int]) -> None:
        extra_phase = False
        final_time = 0
        while True:
            action = self._schedule.next_action(self._simulation.time)
            if action is None:
                # only reachable under a fault plan: without one periodics
                # reschedule forever.  An empty schedule means the nemesis
                # dropped every remaining event (e.g. all processes
                # crashed) — clean exit if nobody is owed a result
                assert self._nemesis is not None, (
                    "there should be a next action (periodics always run)"
                )
                if not self._active_clients:
                    return
                now = self._simulation.time.millis()
                raise SimStalledError(now, now, self._active_clients)
            now = self._simulation.time.millis()
            if self._nemesis is not None:
                bound = self._nemesis.plan.max_sim_time_ms
                if bound is not None and now > bound and self._active_clients:
                    raise SimStalledError(now, bound, self._active_clients)
                action = self._apply_faults(action, now)
                if action is None:
                    continue
            if isinstance(action, TelemetryTick):
                self._handle_telemetry_tick(action)
            elif isinstance(action, PeriodicProcessEvent):
                self._handle_periodic_process_event(action)
            elif isinstance(action, PeriodicExecutedNotification):
                self._handle_periodic_executed_notification(action)
            elif isinstance(action, PeriodicExecutorWatchdog):
                self._handle_executor_watchdog(action)
            elif isinstance(action, SubmitToProc):
                self._handle_submit_to_proc(action.process_id, action.cmd)
            elif isinstance(action, SendToProc):
                if action.edge_seq is not None and self._tracer.enabled:
                    # recv half of the stitched hop (the send half was
                    # stamped at schedule time); duplicates share the
                    # seq and the correlator keeps the earliest
                    dot = edge_dot(action.msg)
                    if dot is not None:
                        self._tracer.edge(
                            "r", type(action.msg).__name__, action.from_,
                            action.to, action.edge_seq, dot=dot,
                        )
                self._handle_send_to_proc(action.from_, action.from_shard_id, action.to, action.msg)
            elif isinstance(action, OpenLoopArrival):
                self._handle_open_loop_arrival(action.client_id)
            elif isinstance(action, IngestRelease):
                self._handle_ingest_release(action.process_id)
            elif isinstance(action, PeerDownNotification):
                self._handle_peer_down_notification(action.dead)
            elif isinstance(action, SendToClient):
                if action.client_id not in self._active_clients:
                    continue  # abandoned (attached to a crashed process)
                self._client_replies += 1
                if self._tracer.enabled:
                    self._tracer.span(
                        "reply", action.cmd_result.rifl, cid=action.client_id
                    )
                if self._open_loop_rate is not None:
                    # open loop: record the completion only — arrivals,
                    # not completions, drive submissions
                    if self._simulation.record_result(action.cmd_result):
                        self._active_clients.discard(action.client_id)
                    continue
                submit = self._simulation.forward_to_client(action.cmd_result)
                if submit is not None:
                    process_id, cmd = submit
                    if self._tracer.enabled:
                        self._tracer.span(
                            "submit", cmd.rifl, cid=action.client_id
                        )
                    self._schedule_submit(("client", action.client_id), process_id, cmd)
                else:
                    self._active_clients.discard(action.client_id)
            else:
                raise AssertionError(f"unknown action {action}")
            if not extra_phase and not self._active_clients:
                if extra_sim_time_ms is None:
                    return
                extra_phase = True
                final_time = self._simulation.time.millis() + extra_sim_time_ms
            if extra_phase and self._simulation.time.millis() > final_time:
                return

    # --- fault plane (sim/faults.py) ---

    def _apply_faults(self, action: Any, now: int):
        """Nemesis delivery-time verdict for one popped action; returns the
        action to handle, or None when it was dropped, deferred, or was a
        nemesis bookkeeping mark."""
        if isinstance(action, NemesisMark):
            self._handle_nemesis_mark(action, now)
            return None
        if isinstance(action, PeerDownNotification):
            return action  # fans out to every live process itself
        process_id = None
        periodic = False
        if isinstance(
            action,
            (PeriodicProcessEvent, PeriodicExecutedNotification, PeriodicExecutorWatchdog),
        ):
            process_id, periodic = action.process_id, True
        elif isinstance(action, SubmitToProc):
            process_id = action.process_id
        elif isinstance(action, SendToProc):
            process_id = action.to
        if process_id is None:
            return action
        verdict, resume_ms = self._nemesis.on_deliver(now, process_id)
        if verdict == DELIVER:
            return action
        if verdict == DROP:
            restart_at = self._nemesis.restart_pending(process_id, now)
            if restart_at is not None:
                if isinstance(action, SubmitToProc):
                    # in-flight client submit at the crash: the client
                    # reconnects and resubmits after the restart (the
                    # reliable-link semantics; same policy as send-time
                    # defer in Nemesis.on_send)
                    delay = (restart_at - now) + self._nemesis.rng.randint(
                        1, self._nemesis.plan.retransmit_base_ms
                    )
                    self._nemesis.record(
                        now, "defer-restart", f"SubmitToProc->p{process_id} +{delay}ms"
                    )
                    self._schedule.schedule(self._simulation.time, delay, action)
                    return None
                if periodic:
                    # stash the stream's one live action; the restart
                    # handler reschedules it
                    self._stalled_periodics.setdefault(process_id, []).append(action)
                    return None
            # dead process: periodic events stop for good (never
            # rescheduled); in-flight messages evaporate
            if not periodic:
                self._nemesis.record(now, "drop-dead", f"{type(action).__name__}->p{process_id}")
            return None
        assert verdict == DEFER and resume_ms is not None
        self._schedule.schedule(self._simulation.time, resume_ms - now, action)
        return None

    def _handle_nemesis_mark(self, mark: NemesisMark, now: int) -> None:
        self._nemesis.record(now, mark.kind, mark.detail)
        if mark.kind == "crash" and mark.process_id is not None:
            if self._nemesis.restart_pending(mark.process_id, now) is not None:
                # crash-restart: capture the durable image at the crash
                # instant — the snapshot()/restore() seam, modelling a
                # synchronous WAL (wal_sync=always: every input applied
                # before the crash was logged; in-flight messages are
                # lost).  Clients stay active: their traffic defers past
                # the restart instead of evaporating.
                protocol, executor, pending = self._simulation.get_process(
                    mark.process_id
                )
                self._durable_images[mark.process_id] = (
                    protocol.snapshot(),
                    executor.snapshot(),
                    copy.deepcopy(pending),
                )
                self._nemesis.record(now, "durable-image", mark.detail)
                return
            # failure-detector model: announce the crash-forever to the
            # survivors after the detection delay (FaultPlan knob)
            if self._nemesis.plan.detector_delay_ms is not None:
                self._schedule.schedule(
                    self._simulation.time,
                    self._nemesis.plan.detector_delay_ms,
                    PeerDownNotification(mark.process_id),
                )
            # abandon clients attached to the dead process: their commands
            # can no longer complete, so the loop must not wait for them
            doomed = {
                client_id
                for client_id in self._active_clients
                if mark.process_id in self._simulation.get_client(client_id).targets()
            }
            if doomed:
                self._active_clients -= doomed
                self._nemesis.record(
                    now, "clients-abandoned", ",".join(map(str, sorted(doomed)))
                )
        elif mark.kind == "restart" and mark.process_id is not None:
            self._restart_process(mark.process_id)

    def _restart_process(self, process_id: ProcessId) -> None:
        """Bring a crashed process back: restore protocol + executor from
        the durable image, re-register, reschedule the periodic streams
        that died with it, then run the rejoin protocol (MSync catch-up
        from live peers past the restored commit horizon)."""
        proto_blob, exec_blob, pending = self._durable_images.pop(process_id)
        protocol = self._protocol_cls.restore(proto_blob)
        executor = self._protocol_cls.Executor.restore(exec_blob)
        protocol.set_tracer(self._tracer)
        executor.set_tracer(self._tracer)
        # device planes drop their injector/listener on pickling (live
        # handles): re-arm the fault plane exactly as at first boot
        self._arm_device_faults(executor, process_id)
        self._simulation.replace_process(protocol, executor, pending)
        for action in self._stalled_periodics.pop(process_id, []):
            self._schedule.schedule(self._simulation.time, action.delay_ms, action)
        protocol.rejoin(self._simulation.time)
        self._send_to_processes_and_executors(process_id)

    # --- handlers ---

    def _handle_peer_down_notification(self, dead: ProcessId) -> None:
        self._nemesis.record(
            self._simulation.time.millis(), "detect-down", f"p{dead}"
        )
        for pid in sorted(self._process_to_region):
            if pid == dead or self._nemesis.is_dead(
                pid, self._simulation.time.millis()
            ):
                continue
            process, _, _ = self._simulation.get_process(pid)
            process.on_peer_down(dead, self._simulation.time)
            self._send_to_processes_and_executors(pid)

    def _handle_periodic_process_event(self, ev: PeriodicProcessEvent) -> None:
        process, _, _ = self._simulation.get_process(ev.process_id)
        process.handle_event(ev.event, self._simulation.time)
        self._send_to_processes_and_executors(ev.process_id)
        self._schedule.schedule(self._simulation.time, ev.delay_ms, ev)

    def _handle_periodic_executed_notification(self, ev: PeriodicExecutedNotification) -> None:
        process, executor, _ = self._simulation.get_process(ev.process_id)
        executed = executor.executed(self._simulation.time)
        if executed is not None:
            process.handle_executed(executed, self._simulation.time)
            self._send_to_processes_and_executors(ev.process_id)
        self._schedule.schedule(self._simulation.time, ev.delay_ms, ev)

    def _handle_telemetry_tick(self, ev: TelemetryTick) -> None:
        """Emit one telemetry window per process + one for the client
        plane, then reschedule — unless the tick is the only pending
        stream left (everything else crashed/drained), in which case it
        stands down so the loop's empty-schedule logic (clean exit, or a
        typed SimStalledError when clients are still owed) keeps working
        exactly as it does without telemetry."""
        self._emit_telemetry()
        if any(
            not isinstance(action, TelemetryTick)
            for action in self._schedule.actions()
        ):
            self._schedule.schedule(self._simulation.time, ev.delay_ms, ev)

    def _emit_telemetry(self) -> None:
        """One window line per source, in deterministic (sorted) order:
        per-process protocol/executor counters + histograms, then the
        cluster-level client plane (submit/reply totals + a windowed
        client-latency histogram in ms)."""
        writer = self._telemetry
        for pid in sorted(self._process_to_region):
            process, executor, _ = self._simulation.get_process(pid)
            counters: Dict[str, float] = {
                "submitted": self._submit_counts.get(pid, 0),
            }
            hists: Dict[str, Histogram] = {}
            for prefix, metrics in (
                ("protocol", process.metrics()),
                ("executor", executor.metrics()),
            ):
                if metrics is None:
                    # an executor that keeps no metrics (Newt's table
                    # executor) adds nothing to its window
                    continue
                for kind, value in metrics.aggregated.items():
                    name = getattr(kind, "value", str(kind))
                    counters[f"{prefix}_{name}"] = value
                for kind, hist in metrics.collected.items():
                    name = getattr(kind, "value", str(kind))
                    hists[f"{prefix}_{name}"] = hist
            writer.emit(f"p{pid}", counters, hists=hists)
        latency = self._client_latency
        writer.emit(
            "clients",
            {
                "submitted": self._client_submits,
                "replied": self._client_replies,
            },
            hists={"latency_ms": latency},
        )

    def _handle_executor_watchdog(self, ev: PeriodicExecutorWatchdog) -> None:
        """Bounded-wait check: raises a typed StalledExecutionError (via
        Config.executor_pending_fail_ms) when a committed command has been
        waiting on never-committing dependencies past the bound.  Below the
        bound, the missing dots feed the protocol's recovery plane
        (Protocol.nudge_recovery): with Config.recovery_delay_ms set, a dot
        the executor is starving on is recovered by consensus — as a noop
        when its payload never reached any live process — instead of ever
        reaching the typed error."""
        process, executor, _ = self._simulation.get_process(ev.process_id)
        missing = executor.monitor_pending(self._simulation.time)
        if missing:
            process.nudge_recovery(missing, self._simulation.time)
        self._schedule.schedule(self._simulation.time, ev.delay_ms, ev)

    def _schedule_arrival(self, client_id: ClientId) -> None:
        """Schedule the client's next open-loop arrival at a seeded
        exponential gap (Poisson at ``open_loop_rate_per_s``); draws come
        from the runner RNG, so same-seed runs arrive identically.
        Gaps are rounded (not truncated) to the sim's ms granularity so
        the realized rate matches the configured one; the 1ms floor caps
        a single client at 1000 arrivals/s — spread higher offered rates
        over more clients."""
        gap_ms = max(1, round(self._rng.expovariate(self._open_loop_rate) * 1000))
        self._schedule.schedule(
            self._simulation.time, gap_ms, OpenLoopArrival(client_id)
        )

    def _handle_open_loop_arrival(self, client_id: ClientId) -> None:
        if client_id not in self._active_clients:
            return  # abandoned (attached to a crashed process)
        client = self._simulation.get_client(client_id)
        nxt = client.next_cmd(self._simulation.time)
        if nxt is None:
            # workload exhausted: no further arrivals; done once the
            # in-flight tail drains (record_result discards it then)
            if client.done:
                self._active_clients.discard(client_id)
            return
        target_shard, cmd = nxt
        if self._tracer.enabled:
            self._tracer.span("submit", cmd.rifl, cid=client_id)
        self._schedule_submit(
            ("client", client_id), client.shard_process(target_shard), cmd
        )
        self._schedule_arrival(client_id)

    def _handle_submit_to_proc(self, process_id: ProcessId, cmd: Command) -> None:
        self._submit_counts[process_id] = (
            self._submit_counts.get(process_id, 0) + 1
        )
        if self._tracer.enabled:
            # ingress edge: the client->coordinator hop's receive half
            # (the client's own `submit` span event is the send half)
            self._tracer.edge("r", "Submit", 0, process_id, 0, rifl=cmd.rifl)
        process, _, pending = self._simulation.get_process(process_id)
        pending.wait_for(cmd)
        if self._ingest_deadline_ms is None:
            process.submit(None, cmd, self._simulation.time)
            if self._tracer.enabled:
                # no batching gate: ingest coincides with the protocol's
                # payload stamp (a zero-width payload->ingest segment),
                # keeping the canonical stage chain complete
                self._tracer.span("ingest", cmd.rifl, pid=process_id)
            self._send_to_processes_and_executors(process_id)
            return
        # adaptive ingest plane: the coordinator owns the payload the
        # moment it arrives — stamped here so the hold until release is
        # the payload->ingest segment, attributed to batching instead of
        # hidden in a merged wait (this runner stamp precedes the
        # protocol's own payload stamp at submit, so it is the first
        # coordinator observation and wins canonical selection)
        if self._tracer.enabled:
            self._tracer.span("payload", cmd.rifl, pid=process_id)
        batcher = self._ingest_batchers.get(process_id)
        if batcher is None:
            batcher = AdaptiveIngestBatcher(
                self._ingest_deadline_ms,
                # a full protocol round has no device capacity bound here;
                # 1024 caps a release at the batched-executor sweet spot
                max_target=1024,
                fixed_target=resolve_ingest_target(None, self._config),
            )
            self._ingest_batchers[process_id] = batcher
        self._ingest_buffers.setdefault(process_id, []).append(cmd)
        batcher.note_arrivals(float(self._simulation.time.millis()), 1)
        self._ingest_poll(process_id)

    def _ingest_poll(self, process_id: ProcessId) -> None:
        """Release the process's ingest buffer if the batcher says so,
        else arm (at most) one deadline tick for the open window."""
        buf = self._ingest_buffers.get(process_id)
        if not buf:
            return
        batcher = self._ingest_batchers[process_id]
        release, wait_ms = batcher.poll(
            float(self._simulation.time.millis()), len(buf)
        )
        if release:
            self._ingest_release(process_id)
        elif wait_ms is not None and not self._ingest_tick_armed.get(process_id):
            self._ingest_tick_armed[process_id] = True
            self._schedule.schedule(
                self._simulation.time,
                # schedule granularity is whole virtual ms; never 0 so
                # the tick cannot livelock the loop at one instant
                max(1, math.ceil(wait_ms)),
                IngestRelease(process_id),
            )

    def _handle_ingest_release(self, process_id: ProcessId) -> None:
        self._ingest_tick_armed[process_id] = False
        if self._nemesis is not None and self._nemesis.is_dead(
            process_id, self._simulation.time.millis()
        ):
            # buffered-at-the-crash submissions evaporate like any other
            # in-flight input (the durable image excludes them); a
            # restart-deferred SubmitToProc re-buffers after the restart
            self._ingest_buffers[process_id] = []
            return
        # a size-triggered release may have emptied (and new arrivals
        # partially refilled) the buffer since this tick was armed:
        # re-poll so a freshly opened window keeps its full deadline
        self._ingest_poll(process_id)

    def _ingest_release(self, process_id: ProcessId) -> None:
        buf = self._ingest_buffers.get(process_id)
        if not buf:
            return
        self._ingest_buffers[process_id] = []
        self._ingest_batchers[process_id].note_release(
            float(self._simulation.time.millis()), len(buf)
        )
        process, _, _ = self._simulation.get_process(process_id)
        tracer = self._tracer
        for cmd in buf:
            if tracer.enabled:
                tracer.span("ingest", cmd.rifl, pid=process_id)
            process.submit(None, cmd, self._simulation.time)
        # one drain for the whole release: the executor sees the round's
        # infos as a batch, which is the throughput point of batching
        self._send_to_processes_and_executors(process_id)

    def _handle_send_to_proc(
        self, from_: ProcessId, from_shard_id: ShardId, to: ProcessId, msg: Any
    ) -> None:
        process, _, _ = self._simulation.get_process(to)
        process.handle(from_, from_shard_id, msg, self._simulation.time)
        self._send_to_processes_and_executors(to)

    def _send_to_processes_and_executors(self, process_id: ProcessId) -> None:
        """Drain a process's outputs: schedule network actions, feed execution
        infos to the executor, complete pending commands
        (runner.rs:396-435)."""
        process, executor, pending = self._simulation.get_process(process_id)
        shard_id = process.shard_id
        protocol_actions = list(process.to_processes_iter())
        ready: List[CommandResult] = []
        infos = list(process.to_executors_iter())
        if infos:
            # one protocol step's infos are handled as a batch so the
            # batched graph executor amortizes a device resolve over them
            executor.handle_batch(infos, self._simulation.time)
            for executor_result in executor.to_clients_iter():
                cmd_result = pending.add_executor_result(executor_result)
                if cmd_result is not None:
                    ready.append(cmd_result)
        self._schedule_protocol_actions(process_id, shard_id, protocol_actions)
        for cmd_result in ready:
            self._schedule_to_client(("process", process_id), cmd_result)

    def _schedule_protocol_actions(
        self, process_id: ProcessId, shard_id: ShardId, actions: List[Any]
    ) -> None:
        for action in actions:
            if isinstance(action, ToSend):
                # each target gets its own deep copy, matching the real
                # runner's serialize-per-connection semantics: receivers may
                # freely mutate payloads (Newt merges/strips Votes in place),
                # and aliasing one object across simulated processes would
                # silently leak state between them
                targets = sorted(action.target)
                copies = [action.msg] + [
                    copy.deepcopy(action.msg) for _ in range(len(targets) - 1)
                ]
                for to, msg in zip(targets, copies):
                    if to == process_id:
                        # message to self: deliver immediately
                        self._handle_send_to_proc(process_id, shard_id, process_id, msg)
                    else:
                        self._schedule_message(
                            ("process", process_id),
                            ("process", to),
                            SendToProc(process_id, shard_id, to, msg),
                        )
            elif isinstance(action, ToForward):
                # forwards are worker-to-worker: deliver immediately
                self._handle_send_to_proc(process_id, shard_id, process_id, action.msg)
            else:
                raise AssertionError(f"unknown action {action}")

    def _schedule_submit(self, from_region_key, process_id: ProcessId, cmd: Command) -> None:
        self._client_submits += 1
        self._schedule_message(
            from_region_key, ("process", process_id), SubmitToProc(process_id, cmd)
        )

    def _schedule_to_client(self, from_region_key, cmd_result: CommandResult) -> None:
        client_id = cmd_result.rifl.source
        if self._tracer.enabled and from_region_key[0] == "process":
            # reply edge: the coordinator->client hop's send half (the
            # client's `reply` span event is the receive half)
            self._tracer.edge(
                "s", "Reply", from_region_key[1], 0, 0, rifl=cmd_result.rifl
            )
        self._schedule_message(
            from_region_key, ("client", client_id), SendToClient(client_id, cmd_result)
        )

    def _schedule_message(self, from_key, to_key, action: Any) -> None:
        if isinstance(action, SendToProc) and self._tracer.enabled:
            # send half of a stitched peer hop, stamped at schedule time
            # (= the sender's "now"); the delivery emits the recv half
            dot = edge_dot(action.msg)
            if dot is not None and self._tracer.sample(dot):
                seq = self._edge_seqs.get(action.from_, 0) + 1
                self._edge_seqs[action.from_] = seq
                action.edge_seq = seq
                self._tracer.edge(
                    "s", type(action.msg).__name__, action.from_, action.to,
                    seq, dot=dot,
                )
        distance = self._distance(self._region_of(from_key), self._region_of(to_key))
        if self._reorder_messages:
            distance = int(distance * self._rng.uniform(0.0, 10.0))
        if self._nemesis is None:
            self._schedule.schedule(self._simulation.time, distance, action)
            return
        now = self._simulation.time.millis()
        msg = getattr(action, "msg", None) or getattr(action, "cmd", None) or action
        delays = self._nemesis.on_send(now, from_key, to_key, distance, msg)
        for index, delay in enumerate(delays):
            # a duplicated delivery gets its own deep copy: receivers may
            # mutate payloads in place (same reason ToSend fans out copies)
            copy_ = action if index == 0 else copy.deepcopy(action)
            self._schedule.schedule(self._simulation.time, delay, copy_)

    def _region_of(self, key) -> Region:
        kind, id_ = key
        if kind == "process":
            return self._process_to_region[id_]
        return self._client_to_region[id_]

    def _distance(self, from_: Region, to: Region) -> int:
        """Distance = half the ping latency (runner.rs:568-589)."""
        ping = self._planet.ping_latency(from_, to)
        assert ping is not None, "both regions should exist on the planet"
        if self._make_distances_symmetric:
            back = self._planet.ping_latency(to, from_)
            assert back is not None
            ping = (ping + back) // 2
        return ping // 2

    def _clients_latencies(self) -> Dict[Region, Tuple[int, Histogram]]:
        out: Dict[Region, Tuple[int, Histogram]] = {}
        for client_id, region in self._client_to_region.items():
            client = self._simulation.get_client(client_id)
            commands, histogram = out.setdefault(region, (0, Histogram()))
            commands += client.issued_commands
            for latency_micros in client.data().latency_data():
                histogram.increment(latency_micros // 1000)  # ms precision (WAN)
            out[region] = (commands, histogram)
        return out

    def serving_summary(self) -> Dict[str, object]:
        """Post-run serving view for the scenario observatory: completed
        commands, the cluster-wide serving span (first submit -> last
        completion, virtual ms — the goodput denominator, same
        reconstruction as run/harness.run_overload_phase), the pooled
        sorted µs latency list, and the device fault counters folded
        across every process's device planes (failures detected)."""
        completed = 0
        latencies: List[int] = []
        first_start: Optional[float] = None
        last_end = 0
        for client_id in self._client_to_region:
            client = self._simulation.get_client(client_id)
            data = client.data()
            micros = list(data.latency_data())
            if not micros:
                continue
            completed += len(micros)
            latencies.extend(micros)
            start, end = data.span_millis()
            first_start = start if first_start is None else min(first_start, start)
            last_end = max(last_end, end)
        latencies.sort()
        device: Dict[str, float] = {"failures": 0}
        for _pid, (_process, executor, _pending) in self._simulation.processes():
            for plane in executor.device_planes():
                device["failures"] += plane.fault_counters()["failures"]
        span_ms = (last_end - first_start) if first_start is not None else 0.0
        return {
            "completed": completed,
            "span_ms": span_ms,
            "latencies_us": latencies,
            "device": device,
        }
