"""Single-threaded holder of processes (protocol, executor, pending) and
clients, with synchronous message forwarding.

Reference: fantoch/src/sim/simulation.rs:10-190.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from fantoch_tpu_torch.client.client import Client
from fantoch_tpu_torch.core.command import Command, CommandResult
from fantoch_tpu_torch.core.ids import ClientId, ProcessId
from fantoch_tpu_torch.core.timing import SimTime
from fantoch_tpu_torch.executor.aggregate import AggregatePending
from fantoch_tpu_torch.executor.base import Executor
from fantoch_tpu_torch.protocol.base import Protocol, ToSend


class Simulation:
    def __init__(self) -> None:
        self.time = SimTime()
        self._processes: Dict[ProcessId, Tuple[Protocol, Executor, AggregatePending]] = {}
        self._clients: Dict[ClientId, Client] = {}

    def register_process(self, process: Protocol, executor: Executor) -> None:
        process_id = process.id
        assert process_id not in self._processes, "process registered twice"
        pending = AggregatePending(process_id, process.shard_id)
        self._processes[process_id] = (process, executor, pending)

    def replace_process(
        self, process: Protocol, executor: Executor, pending: AggregatePending
    ) -> None:
        """Swap in a restarted process (restored from its durable image):
        the restart plane's re-registration seam (sim/runner.py)."""
        process_id = process.id
        assert process_id in self._processes, "restart requires a registered process"
        self._processes[process_id] = (process, executor, pending)

    def register_client(self, client: Client) -> None:
        assert client.id not in self._clients, "client registered twice"
        self._clients[client.id] = client

    def start_clients(self) -> List[Tuple[ClientId, ProcessId, Command]]:
        out = []
        for client in self._clients.values():
            nxt = client.next_cmd(self.time)
            assert nxt is not None, "clients should submit at least one command"
            target_shard, cmd = nxt
            out.append((client.id, client.shard_process(target_shard), cmd))
        return out

    def forward_to_processes(
        self, process_id: ProcessId, action: ToSend
    ) -> List[Tuple[ProcessId, object]]:
        """Deliver a ToSend action synchronously to all targets (self first);
        returns the newly produced actions of every touched process."""
        assert isinstance(action, ToSend), f"non supported action: {action}"
        process, _, _ = self._processes[process_id]
        shard_id = process.shard_id
        actions: List[Tuple[ProcessId, object]] = []
        if process_id in action.target:
            process.handle(process_id, shard_id, action.msg, self.time)
        # the first to_send entries are the ones from self
        actions.extend((process_id, a) for a in process.to_processes_iter())
        for to in action.target:
            if to == process_id:
                continue
            to_process, _, _ = self._processes[to]
            to_process.handle(process_id, shard_id, action.msg, self.time)
            actions.extend((to, a) for a in to_process.to_processes_iter())
        return actions

    def forward_to_client(self, cmd_result: CommandResult) -> Optional[Tuple[ProcessId, Command]]:
        """Deliver a command result; returns the client's next submission."""
        client = self._clients[cmd_result.rifl.source]
        client.handle([cmd_result], self.time)
        nxt = client.next_cmd(self.time)
        if nxt is None:
            return None
        target_shard, cmd = nxt
        return client.shard_process(target_shard), cmd

    def record_result(self, cmd_result: CommandResult) -> bool:
        """Open-loop result delivery: record the completion WITHOUT
        generating the next submission (arrivals are driven by the
        open-loop schedule, sim/runner.py); returns True once the client
        is done (workload generated and nothing in flight)."""
        client = self._clients[cmd_result.rifl.source]
        return client.handle([cmd_result], self.time)

    def get_process(self, process_id: ProcessId) -> Tuple[Protocol, Executor, AggregatePending]:
        return self._processes[process_id]

    def get_client(self, client_id: ClientId) -> Client:
        return self._clients[client_id]

    def processes(self):
        return self._processes.items()

    def clients(self):
        return self._clients.items()
