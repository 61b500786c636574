"""Partial-replication (multi-shard) commit glue.

Reference: fantoch_ps/src/protocol/partial.rs:8-246.  A multi-shard command
runs the protocol *independently in each shard it touches* under the same
dot; commits are then aggregated:

  1. the shard the client targeted forwards the submit to the closest
     process of every other shard the command touches (MForwardSubmit);
  2. when a shard's instance decides (fast or slow path), instead of
     broadcasting MCommit it sends its decided data to the dot owner (the
     coordinator process in the target shard) as MShardCommit;
  3. the owner aggregates one MShardCommit per shard; once all shards
     reported it answers every participant with MShardAggregatedCommit;
  4. each participant then broadcasts the final MCommit *within its own
     shard* (BaseProcess.all() is shard-local).

``PartialCommitMixin`` owns the per-dot aggregation state and exposes the
four hooks; the protocol supplies three small adapters describing what its
commit data looks like (join for the aggregate, message constructors).
Used by Atlas (deps union) and Newt (clock max, with the Votes riding the
``local`` channel); EPaxos does not support partial replication (mirroring
the reference, fantoch_ps/src/protocol/epaxos.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Set

from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import Dot, ProcessId
from fantoch_tpu_torch.protocol.base import ToSend


@dataclass
class MForwardSubmit:
    """Submit forwarded to the closest process of a non-target shard."""

    dot: Dot
    cmd: Command


@dataclass
class MShardCommit:
    """One shard's decided data, sent to the dot owner for aggregation."""

    dot: Dot
    data: Any


@dataclass
class MShardAggregatedCommit:
    """The joined decision, sent back to every participant shard."""

    dot: Dot
    data: Any


class ShardsCommits:
    """Aggregation of one commit notification per shard (partial.rs:206-246)."""

    __slots__ = ("shard_count", "participants", "data")

    def __init__(self, shard_count: int, initial: Any):
        self.shard_count = shard_count
        self.participants: Set[ProcessId] = set()
        self.data = initial

    def add(self, from_: ProcessId, data: Any, join: Callable[[Any, Any], Any]) -> bool:
        assert from_ not in self.participants, (
            f"duplicate MShardCommit from {from_}"
        )
        self.participants.add(from_)
        self.data = join(self.data, data)
        return len(self.participants) == self.shard_count


class PartialCommitMixin:
    """Protocol mixin owning the multi-shard commit aggregation.

    Requirements on the host protocol class:
      * ``self.bp`` — a BaseProcess (shard-local all(), closest_process);
      * ``self._to_processes`` — the action deque;
      * ``_partial_initial_data()`` — bottom element of the commit-data
        join (e.g. an empty Dependency set for Atlas);
      * ``_partial_join(acc, data)`` — commutative join of per-shard data
        (deps union for Atlas; max clock for a timestamp protocol);
      * ``_partial_final_mcommit(dot, data, local)`` — the protocol's
        MCommit message carrying the aggregated data plus whatever the
        participant stashed as ``local`` at ``partial_mcommit_actions``
        time (the reference's data2 channel — e.g. Newt's Votes, which
        never cross shards; None when nothing was stashed).
    """

    _shards_commits: Dict[Dot, ShardsCommits]

    def _init_partial(self) -> None:
        self._shards_commits = {}
        # per-dot data that stays at the participant and rejoins the final
        # MCommit after aggregation (the reference's D2 / set_votes channel:
        # Newt's Votes never cross shards, partial.rs:37-102 data2)
        self._partial_local: Dict[Dot, Any] = {}

    # --- hook 1: submit-side forwarding (partial.rs:8-35) ---

    def partial_submit_actions(self, dot: Dot, cmd: Command, target_shard: bool) -> None:
        if not target_shard:
            return
        for shard_id in cmd.shards():
            if shard_id != self.bp.shard_id:
                self._to_processes.append(
                    ToSend(
                        {self.bp.closest_process(shard_id)},
                        MForwardSubmit(dot, cmd),
                    )
                )

    # --- hook 2: at a shard's commit decision (partial.rs:37-102) ---

    def partial_mcommit_actions(
        self, dot: Dot, cmd: Command, data: Any, local: Any = None
    ) -> bool:
        """Returns True if the commit was routed through shard aggregation
        (multi-shard); False means the caller should broadcast its own
        MCommit (single-shard command).  ``local`` stays here and is handed
        back to ``_partial_final_mcommit`` when the aggregate returns."""
        shard_count = cmd.shard_count
        if shard_count == 1:
            return False
        if local is not None:
            self._partial_local[dot] = local
        # our own data flows through the MShardCommit to the owner (which
        # may be ourselves — self-delivery) and comes back aggregated
        self._to_processes.append(ToSend({dot.source}, MShardCommit(dot, data)))
        return True

    # --- hook 3: at the dot owner (partial.rs:104-142) ---

    def partial_handle_mshard_commit(
        self, from_: ProcessId, dot: Dot, data: Any, shard_count: int
    ) -> None:
        agg = self._shards_commits.get(dot)
        if agg is None:
            agg = ShardsCommits(shard_count, self._partial_initial_data())
            self._shards_commits[dot] = agg
        done = agg.add(from_, data, self._partial_join)
        if done:
            self._to_processes.append(
                ToSend(
                    set(agg.participants),
                    MShardAggregatedCommit(dot, agg.data),
                )
            )
            del self._shards_commits[dot]

    # --- hook 4: back at each participant (partial.rs:144-177) ---

    def partial_handle_mshard_aggregated_commit(self, dot: Dot, data: Any) -> None:
        local = self._partial_local.pop(dot, None)
        self._to_processes.append(
            ToSend(self.bp.all(), self._partial_final_mcommit(dot, data, local))
        )

    # --- shared message dispatch (the handle() tail both protocols share) ---

    def handle_partial_message(self, from_: ProcessId, msg) -> bool:
        """Dispatch the partial-replication message set; False when ``msg``
        is none of them (caller continues its chain)."""
        if isinstance(msg, MForwardSubmit):
            self._handle_submit(msg.dot, msg.cmd, target_shard=False)
        elif isinstance(msg, MShardCommit):
            info = self._cmds.get(msg.dot)
            assert info.cmd is not None, (
                "the dot owner submits before any shard can commit"
            )
            self.partial_handle_mshard_commit(
                from_, msg.dot, msg.data, info.cmd.shard_count
            )
        elif isinstance(msg, MShardAggregatedCommit):
            self.partial_handle_mshard_aggregated_commit(msg.dot, msg.data)
        else:
            return False
        return True

    # --- adapters the protocol must provide ---

    def _partial_initial_data(self) -> Any:
        raise NotImplementedError

    def _partial_join(self, acc: Any, data: Any) -> Any:
        raise NotImplementedError

    def _partial_final_mcommit(self, dot: Dot, data: Any, local: Any):
        raise NotImplementedError
