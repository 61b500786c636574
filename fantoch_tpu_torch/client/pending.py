"""Client-side latency tracking of in-flight commands.

Reference: fantoch/src/client/pending.rs:6-51.  Times are microseconds.
"""

from __future__ import annotations

from typing import Dict, Tuple

from fantoch_tpu_torch.core.ids import Rifl
from fantoch_tpu_torch.core.timing import SysTime


class Pending:
    def __init__(self) -> None:
        self._pending: Dict[Rifl, int] = {}

    def start(self, rifl: Rifl, time: SysTime) -> None:
        assert rifl not in self._pending, "the same rifl can't be started twice"
        self._pending[rifl] = time.micros()

    def end(self, rifl: Rifl, time: SysTime) -> Tuple[int, int]:
        """Returns (latency_micros, end_time_millis)."""
        start_time = self._pending.pop(rifl, None)
        assert start_time is not None, "can't end a command that has not started"
        end_time = time.micros()
        assert start_time <= end_time, "time must be monotonic"
        return end_time - start_time, end_time // 1000

    def cancel(self, rifl: Rifl) -> None:
        """Drop an in-flight command without recording a latency — the
        shed path of the overload plane (a command abandoned past its
        deadline budget must not pollute the latency data)."""
        self._pending.pop(rifl, None)

    def is_empty(self) -> bool:
        return not self._pending
