"""Consistency auditing: one reusable invariant engine for cross-replica
safety, plus the per-key chained execution digests the run layer exchanges
for online divergence detection.

Every chaos/restart test before this module asserted *completion*; the
actual safety claim of the protocols — replicas execute conflicting
commands in the same order, exactly once, and never lose a committed
command — lived as scattered per-test assertions (tests/harness.py
``check_monitors`` plus ad-hoc checks).  The reference leans on stateright
+ quickcheck for this class of bug; our exhaustive checker (mc/checker.py)
is capped at n=3/f=1 and cannot reach WAL/overload/SlowProcess
interleavings.  This module is the scalable instrument:

* :class:`ConsistencyAuditor` — protocol-agnostic post-run verdict over
  the executors' :class:`~fantoch_tpu_torch.executor.monitor.ExecutionOrderMonitor`
  histories and (optionally) the protocols' audit commit logs
  (``Config.audit_log_commits``): per-key total-order agreement of
  conflicting writes, exactly-once execution per rifl, committed-then-lost
  detection, and per-dot commit-value agreement (Newt timestamp / graph
  deps / Caesar (clock, deps) / FPaxos slot->command).  Returns typed
  :class:`Violation` records carrying a *minimal counterexample* (the
  first diverging position, not whole histories).  The chaos fuzzer
  (sim/fuzz.py) runs it after every case; tests/harness.py delegates its
  agreement checks here so every existing sim test rides the same engine.

* :class:`ExecutionDigest` — a per-key hash chain over executed *writes*
  (reads commute and are excluded, mirroring the monitor's write-order
  rule), maintained inside every executor's KVStore when
  ``Config.execution_digests`` is on.  Summaries (count, digest-at-count)
  are cheap to ship; a replica that is at least as far along on a key can
  verify the peer's whole prefix from its own chain.  The run layer
  piggybacks summaries on the heartbeat path and resolves a mismatch to
  the *first* diverging entry with one follow-up exchange
  (run/process_runner.py -> :class:`~fantoch_tpu_torch.errors.DivergenceError`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

from fantoch_tpu_torch.core.ids import Rifl
from fantoch_tpu_torch.core.kvs import Key

# --- violation kinds ---

ORDER_DIVERGENCE = "order-divergence"
DUPLICATE_EXECUTION = "duplicate-execution"
MULTISET_DIVERGENCE = "multiset-divergence"
KEYSET_DIVERGENCE = "keyset-divergence"
COMMITTED_LOST = "committed-then-lost"
COMMIT_DIVERGENCE = "commit-divergence"


@dataclass(frozen=True)
class Violation:
    """One typed safety violation with its minimal counterexample.

    ``entries`` carries only the evidence needed to understand the
    failure (e.g. the first diverging position and the two rifls there),
    never whole histories — the shrinker (sim/fuzz.py) minimizes the
    *schedule*, this minimizes the *witness*."""

    kind: str
    detail: str
    key: Optional[Key] = None
    pids: Tuple[int, ...] = ()
    entries: Tuple[Any, ...] = ()

    def __str__(self) -> str:
        where = f" key={self.key!r}" if self.key is not None else ""
        who = f" pids={list(self.pids)}" if self.pids else ""
        return f"[{self.kind}]{where}{who} {self.detail}"


@dataclass
class AuditVerdict:
    """The auditor's answer: ``ok`` iff no violation survived."""

    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def counterexample(self) -> Optional[Violation]:
        """The first (most load-bearing) violation, if any."""
        return self.violations[0] if self.violations else None

    def describe(self) -> str:
        if self.ok:
            return "audit clean"
        lines = [f"{len(self.violations)} consistency violation(s):"]
        lines.extend(f"  {v}" for v in self.violations)
        return "\n".join(lines)


class ConsistencyAuditor:
    """Protocol-agnostic safety checks over per-process execution
    histories (and optional commit logs).

    ``expected_ops_per_key`` bounds how many times one rifl may legally
    touch one key (our workloads issue one op per (command, key); pass
    None to disable the absolute duplicate check and rely on cross-replica
    asymmetry alone)."""

    def __init__(self, expected_ops_per_key: Optional[int] = 1):
        self.expected_ops_per_key = expected_ops_per_key

    # --- the one entry point ---

    def audit(
        self,
        monitors: Dict[int, Any],
        commit_logs: Optional[Dict[int, Dict[Any, Tuple[Optional[Rifl], Any]]]] = None,
    ) -> AuditVerdict:
        """Audit the execution-order monitors of a set of (surviving)
        replicas, plus their commit logs when available.  ``monitors``
        maps pid -> ExecutionOrderMonitor (all non-None)."""
        verdict = AuditVerdict()
        items = sorted(monitors.items())
        assert items, "audit requires at least one monitor"
        self._check_duplicates(items, verdict)
        self._check_keysets(items, verdict)
        self._check_write_orders(items, verdict)
        self._check_multisets(items, verdict, commit_logs)
        if commit_logs:
            self._check_commit_logs(commit_logs, verdict)
        return verdict

    # --- per-process checks ---

    def _check_duplicates(self, items, verdict: AuditVerdict) -> None:
        """Exactly-once execution: one rifl must not touch one key more
        often than the workload's op multiplicity allows (a GC-straggler
        commit replay once executed commands twice)."""
        if self.expected_ops_per_key is None:
            return
        from collections import Counter

        for pid, monitor in items:
            for key in monitor.keys():
                counts = Counter(monitor.get_order(key))
                for rifl, count in counts.items():
                    if count > self.expected_ops_per_key:
                        verdict.violations.append(
                            Violation(
                                DUPLICATE_EXECUTION,
                                f"{rifl} executed {count}x on p{pid} "
                                f"(expected <= {self.expected_ops_per_key})",
                                key=key,
                                pids=(pid,),
                                entries=(rifl, count),
                            )
                        )

    # --- cross-process checks ---

    def _check_keysets(self, items, verdict: AuditVerdict) -> None:
        all_keys = set()
        for _pid, monitor in items:
            all_keys.update(monitor.keys())
        for key in sorted(all_keys):
            missing = tuple(
                pid for pid, monitor in items if monitor.get_order(key) is None
            )
            if missing:
                holders = tuple(
                    pid for pid, monitor in items if monitor.get_order(key) is not None
                )
                verdict.violations.append(
                    Violation(
                        KEYSET_DIVERGENCE,
                        f"key executed on p{list(holders)} but never on "
                        f"p{list(missing)}",
                        key=key,
                        pids=missing + holders,
                    )
                )

    def _check_write_orders(self, items, verdict: AuditVerdict) -> None:
        """Per-key total-order agreement of conflicting *writes* (reads
        commute; the monitor's read/write split mirrors the KeyDeps
        split).  The counterexample is the first diverging position."""
        pid_a, monitor_a = items[0]
        for pid_b, monitor_b in items[1:]:
            for key in monitor_a.keys():
                order_a = monitor_a.get_write_order(key)
                order_b = monitor_b.get_write_order(key)
                if order_a is None or order_b is None or order_a == order_b:
                    continue
                position, mine, theirs = first_divergence_index(order_a, order_b)
                verdict.violations.append(
                    Violation(
                        ORDER_DIVERGENCE,
                        f"write orders diverge at position {position}: "
                        f"p{pid_a} executed {mine}, p{pid_b} executed {theirs}",
                        key=key,
                        pids=(pid_a, pid_b),
                        entries=(position, mine, theirs),
                    )
                )

    def _check_multisets(self, items, verdict: AuditVerdict, commit_logs) -> None:
        """Executed-command multiset agreement per key.  A rifl executed
        at one replica but missing at another is classified
        committed-then-lost when the missing replica's own commit log
        proves it committed the command (it accepted the commit, then
        lost it) — else plain multiset divergence (which may also be an
        unsettled tail; the write-order check above is the sharp one)."""
        from collections import Counter

        pid_a, monitor_a = items[0]
        committed_rifls: Dict[int, set] = {}
        for pid, log in (commit_logs or {}).items():
            committed_rifls[pid] = {
                rifl for rifl, _value in log.values() if rifl is not None
            }
        for pid_b, monitor_b in items[1:]:
            for key in monitor_a.keys():
                full_a = Counter(monitor_a.get_order(key) or ())
                full_b = Counter(monitor_b.get_order(key) or ())
                if full_a == full_b:
                    continue
                only_a = full_a - full_b
                only_b = full_b - full_a
                for rifl in sorted(only_a):
                    missing_at = pid_b
                    if rifl in committed_rifls.get(missing_at, ()):
                        verdict.violations.append(
                            Violation(
                                COMMITTED_LOST,
                                f"{rifl} executed on p{pid_a} and committed "
                                f"on p{missing_at}, but never executed there",
                                key=key,
                                pids=(pid_a, missing_at),
                                entries=(rifl,),
                            )
                        )
                    else:
                        verdict.violations.append(
                            Violation(
                                MULTISET_DIVERGENCE,
                                f"{rifl} executed on p{pid_a} but not on "
                                f"p{missing_at}",
                                key=key,
                                pids=(pid_a, missing_at),
                                entries=(rifl,),
                            )
                        )
                for rifl in sorted(only_b):
                    verdict.violations.append(
                        Violation(
                            MULTISET_DIVERGENCE,
                            f"{rifl} executed on p{pid_b} but not on p{pid_a}",
                            key=key,
                            pids=(pid_b, pid_a),
                            entries=(rifl,),
                        )
                    )

    def _check_commit_logs(self, commit_logs, verdict: AuditVerdict) -> None:
        """Per-dot commit-value agreement: the same identifier (a dot for
        leaderless protocols, a slot for FPaxos) must commit the same
        (rifl, value) everywhere — Newt timestamp agreement, graph deps
        agreement, Caesar (clock, deps) agreement, FPaxos slot-order
        agreement, all as one check."""
        idents: Dict[Any, Dict[int, Tuple[Optional[Rifl], Any]]] = {}
        for pid, log in sorted(commit_logs.items()):
            for ident, record in log.items():
                idents.setdefault(ident, {})[pid] = record
        for ident, per_pid in sorted(idents.items(), key=lambda kv: str(kv[0])):
            if len(per_pid) < 2:
                continue
            records = sorted(per_pid.items())
            pid_a, record_a = records[0]
            for pid_b, record_b in records[1:]:
                if record_a != record_b:
                    verdict.violations.append(
                        Violation(
                            COMMIT_DIVERGENCE,
                            f"{ident} committed as {record_a} on p{pid_a} "
                            f"but {record_b} on p{pid_b}",
                            pids=(pid_a, pid_b),
                            entries=(ident, record_a, record_b),
                        )
                    )
                    break  # one witness per ident


def first_divergence_index(order_a, order_b) -> Tuple[int, Any, Any]:
    """First position where two sequences disagree; missing entries
    (one sequence shorter) report None on that side."""
    for index, (a, b) in enumerate(zip(order_a, order_b)):
        if a != b:
            return index, a, b
    shorter = min(len(order_a), len(order_b))
    return (
        shorter,
        order_a[shorter] if len(order_a) > shorter else None,
        order_b[shorter] if len(order_b) > shorter else None,
    )


# --- chained execution digests (the run layer's online instrument) ---


class DigestEntry(NamedTuple):
    """One executed write in a key's hash chain."""

    src: int
    seq: int
    digest: str


class ExecutionDigest:
    """Per-key hash chain over executed writes.

    ``record`` extends the chain with H(prev || rifl || op || value);
    position ``i`` of a chain therefore authenticates the whole write
    prefix up to and including write ``i``.  Two replicas agree on a
    key's first ``k`` writes iff their chains' entry ``k-1`` digests are
    equal, so a summary of (count, digest-at-count) lets any replica at
    least as far along verify a peer's entire prefix — the property the
    run layer's heartbeat piggyback rides.  Whole chains are kept (audit
    mode is opt-in and workload-bounded) so a mismatch resolves to the
    *first* diverging entry, not just "somewhere before count"."""

    def __init__(self) -> None:
        self._chains: Dict[Key, List[DigestEntry]] = {}

    def record(self, key: Key, rifl: Rifl, op_kind: str, value: Optional[str]) -> None:
        chain = self._chains.setdefault(key, [])
        prev = chain[-1].digest if chain else ""
        payload = f"{prev}|{key}|{rifl.source}.{rifl.sequence}|{op_kind}|{value}"
        digest = hashlib.sha256(payload.encode()).hexdigest()[:32]
        chain.append(DigestEntry(rifl.source, rifl.sequence, digest))

    def summary(self) -> Dict[Key, Tuple[int, str]]:
        """{key: (write count, digest at that count)} — what the
        heartbeat ships."""
        return {
            key: (len(chain), chain[-1].digest)
            for key, chain in self._chains.items()
            if chain
        }

    def entries(self, key: Key) -> List[DigestEntry]:
        return list(self._chains.get(key, ()))

    def mismatched_keys(
        self, peer_summary: Dict[Key, Tuple[int, str]]
    ) -> List[Key]:
        """Keys where WE can prove divergence: our chain reaches the
        peer's count and our digest at that position differs.  Keys where
        the peer is ahead are its responsibility (it runs the same check
        on our summary)."""
        out = []
        for key, (peer_count, peer_digest) in peer_summary.items():
            chain = self._chains.get(key)
            if chain is None or len(chain) < peer_count or peer_count == 0:
                continue
            if chain[peer_count - 1].digest != peer_digest:
                out.append(key)
        return sorted(out)

    @staticmethod
    def first_divergence(
        mine: Iterable[DigestEntry], theirs: Iterable[DigestEntry]
    ) -> Optional[Tuple[int, Optional[DigestEntry], Optional[DigestEntry]]]:
        """First position where two chains disagree (by digest), or None
        when one is a prefix of the other."""
        mine, theirs = list(mine), list(theirs)
        for index, (a, b) in enumerate(zip(mine, theirs)):
            if a.digest != b.digest:
                return index, a, b
        return None

    def merge_summary_into(self, out: Dict[Key, Tuple[int, str]]) -> None:
        """Fold this digest's summary into ``out`` (executor pools route
        disjoint key sets, so plain update is exact)."""
        out.update(self.summary())
