"""Closed-loop client state machine.

Reference: fantoch/src/client/mod.rs:27-170.  A client generates commands
from its workload, targets the closest process of the target shard, and
records end-to-end latency per command.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Set, Tuple

from fantoch_tpu_torch.client.data import ClientData
from fantoch_tpu_torch.client.pending import Pending
from fantoch_tpu_torch.client.workload import Workload
from fantoch_tpu_torch.core.command import Command, CommandResult
from fantoch_tpu_torch.core.ids import ClientId, ProcessId, RiflGen, ShardId
from fantoch_tpu_torch.core.timing import SysTime
from fantoch_tpu_torch.utils import logger


class Client:
    def __init__(
        self,
        client_id: ClientId,
        workload: Workload,
        status_frequency: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ):
        self._client_id = client_id
        self._processes: Dict[ShardId, ProcessId] = {}
        self._rifl_gen = RiflGen(client_id)
        # each client gets its own copy of the workload progress counter
        self._workload = dataclasses.replace(workload)
        self._key_gen_state = workload.initial_key_gen_state(client_id, rng)
        self._pending = Pending()
        self._data = ClientData()
        self._status_frequency = status_frequency
        # overload-plane tallies (run/backpressure.py): submissions the
        # server shed (typed Overloaded replies retried with backoff)
        # and commands this client itself abandoned past their deadline
        # budget — goodput accounting for the latency-under-load plots
        self.overload_retries = 0
        self.shed_commands = 0
        # live-telemetry seam (observability/timeseries.py): an optional
        # per-completion callback fed each latency sample (µs) as it is
        # recorded, so the telemetry writers maintain their cumulative
        # latency histogram at O(1) per reply instead of re-walking
        # every recorded sample per window
        self._latency_observer = None

    @property
    def id(self) -> ClientId:
        return self._client_id

    def connect(self, processes: Dict[ShardId, ProcessId]) -> None:
        """Learn the closest process of each shard."""
        self._processes = processes

    def shard_process(self, shard_id: ShardId) -> ProcessId:
        return self._processes[shard_id]

    def targets(self) -> Set[ProcessId]:
        """Every process this client submits to (one per shard) — the sim's
        nemesis abandons clients whose target crashed."""
        return set(self._processes.values())

    def next_cmd(self, time: SysTime) -> Optional[Tuple[ShardId, Command]]:
        nxt = self._workload.next_cmd(self._rifl_gen, self._key_gen_state)
        if nxt is not None:
            _, cmd = nxt
            self._pending.start(cmd.rifl, time)
        return nxt

    def handle(self, cmd_results: List[CommandResult], time: SysTime) -> bool:
        """Record completion of one command (possibly split over shards);
        returns True once the whole workload is generated and completed."""
        rifls = {r.rifl for r in cmd_results}
        assert len(rifls) == 1, "all results must belong to the same rifl"
        rifl = rifls.pop()
        latency, end_time = self._pending.end(rifl, time)
        self._data.record(latency, end_time)
        if self._latency_observer is not None:
            self._latency_observer(latency)
        if self._status_frequency and self._workload.issued_commands % self._status_frequency == 0:
            logger.info(
                "c%s: %s of %s",
                self._client_id,
                self._workload.issued_commands,
                self._workload.commands_per_client,
            )
        return self.done

    def shed(self, rifl) -> None:
        """Abandon an in-flight command (deadline budget expired while
        the server kept shedding it): no latency sample is recorded —
        shed work is *not* executed late — and the shed is tallied for
        the goodput accounting."""
        self._pending.cancel(rifl)
        self.shed_commands += 1

    @property
    def done(self) -> bool:
        """Workload fully generated and nothing in flight (completed or
        shed) — the drivers' shared termination predicate."""
        return self._workload.finished() and self._pending.is_empty()

    def set_latency_observer(self, observer) -> None:
        """``observer(latency_micros)`` fires on every completion
        (telemetry's incremental latency fold); None disables."""
        self._latency_observer = observer

    def data(self) -> ClientData:
        return self._data

    @property
    def issued_commands(self) -> int:
        return self._workload.issued_commands
