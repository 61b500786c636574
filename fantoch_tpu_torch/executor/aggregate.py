"""Aggregation of per-key executor results into full command results.

Reference: fantoch/src/executor/aggregate.rs:9-98.  The server side of the
client plane: a command touching k keys produces k partial results (possibly
from different key-parallel executors); the pending tracker releases one
``CommandResult`` once all partials arrive.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from fantoch_tpu_torch.core.command import Command, CommandResult
from fantoch_tpu_torch.core.ids import ProcessId, Rifl, ShardId
from fantoch_tpu_torch.executor.base import ExecutorResult
from fantoch_tpu_torch.utils import logger


class AggregatePending:
    """``buffer_early``: stash partials whose ``wait_for`` has not arrived
    yet instead of dropping them.  The runner's per-client session needs
    this (results are routed to the session by owning client id, so every
    partial seen here belongs to one of its clients): on a NON-target
    shard of a multi-shard command, the server-side MForwardSubmit can
    commit and execute before the client's own Register message arrives
    over its connection, and dropping that early partial deadlocks the
    client.  The simulator/test drivers keep the default drop behavior —
    there, every process executes every command including those of clients
    attached elsewhere, and foreign partials must be ignored, not held.
    """

    # bound on buffered early *partials* (total across rifls): a rifl
    # whose Register/Submit never arrives (client died after ClientHi, or
    # a stream of misrouted results for one dead rifl) must not leak for
    # the life of the session.  Oldest-rifl eviction; the cap is
    # per-session so a small bound suffices.
    EARLY_CAP = 1024

    def __init__(
        self, process_id: ProcessId, shard_id: ShardId, buffer_early: bool = False
    ):
        self._process_id = process_id
        self._shard_id = shard_id
        self._pending: Dict[Rifl, CommandResult] = {}
        self._buffer_early = buffer_early
        self._early: Dict[Rifl, List[ExecutorResult]] = {}
        self._early_count = 0

    def wait_for(self, cmd: Command) -> bool:
        """Track a command submitted by a connected client."""
        rifl = cmd.rifl
        key_count = cmd.key_count(self._shard_id)
        existed = rifl in self._pending
        self._pending[rifl] = CommandResult(rifl, key_count)
        return not existed

    def wait_for_rifl(self, rifl: Rifl) -> None:
        """Increase expected partials for `rifl` by one (used by executors
        that produce one notification per key without seeing the command)."""
        result = self._pending.get(rifl)
        if result is None:
            result = CommandResult(rifl, 0)
            self._pending[rifl] = result
        result.increment_key_count()

    def cancel(self, rifl: Rifl) -> None:
        """Withdraw a tracked command (the overload plane's deadline-shed
        path: the client will never resubmit, so the aggregation entry —
        and any buffered early partials — must not outlive it)."""
        self._pending.pop(rifl, None)
        dropped = self._early.pop(rifl, None)
        if dropped:
            self._early_count -= len(dropped)

    def drain_early(self, rifl: Rifl) -> Optional[CommandResult]:
        """Apply partials that raced ahead of ``wait_for(rifl)``; returns
        the CommandResult if they already complete it."""
        partials = self._early.pop(rifl, [])
        self._early_count -= len(partials)
        for partial in partials:
            done = self.add_executor_result(partial)
            if done is not None:
                return done
        return None

    def add_executor_result(self, executor_result: ExecutorResult) -> Optional[CommandResult]:
        """Add one partial; returns the CommandResult once complete.
        Partials for unknown rifls are buffered (``buffer_early``) or
        ignored (clients of other processes)."""
        cmd_result = self._pending.get(executor_result.rifl)
        if cmd_result is None:
            if self._buffer_early:
                self._early.setdefault(executor_result.rifl, []).append(
                    executor_result
                )
                self._early_count += 1
                while self._early_count > self.EARLY_CAP:
                    # dicts iterate in insertion order: drop the oldest rifl
                    evicted = next(iter(self._early))
                    self._early_count -= len(self._early.pop(evicted))
                    # if the evicted rifl's wait_for was merely racing (not
                    # dead), its command will now hang silently — leave a
                    # trail so a wedged client is diagnosable
                    logger.warning(
                        "early-partial cap: evicting partials for rifl %s",
                        evicted,
                    )
            return None
        if cmd_result.add_partial(executor_result.key, executor_result.op_results):
            return self._pending.pop(executor_result.rifl)
        return None
