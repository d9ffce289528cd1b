"""Per-entry deadline budgets (port of
``sentinel_tpu/resilience/budget.py``): bound the total latency a remote
dependency may add to one data-path operation.

``entry()``'s cluster token check would otherwise pay up to ``request_timeout_s``
PER cluster rule plus unbounded ``SHOULD_WAIT`` sleeps; a budget caps
the AGGREGATE. Reads the freezable ``utils/time_util`` clock, so budget
math is exact under the chaos suite's pinned clock.
"""

from __future__ import annotations

from sentinel_tpu_torch.utils import time_util


class DeadlineBudget:
    """A fixed spend of milliseconds, started at construction."""

    __slots__ = ("total_ms", "_deadline_ms")

    def __init__(self, total_ms: int):
        self.total_ms = int(total_ms)
        self._deadline_ms = time_util.current_time_millis() + self.total_ms

    def remaining_ms(self) -> int:
        return max(0, self._deadline_ms - time_util.current_time_millis())

    @property
    def expired(self) -> bool:
        return self.remaining_ms() <= 0

    def clamp_wait_ms(self, wait_ms: float) -> int:
        """Largest sleep ≤ ``wait_ms`` the budget still affords."""
        return int(min(max(0, wait_ms), self.remaining_ms()))
