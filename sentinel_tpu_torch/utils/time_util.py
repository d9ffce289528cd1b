"""Host clock with a test override (port of
``sentinel_tpu/utils/time_util.py``).

Reference: ``core:util/TimeUtil.java``. ``time.time_ns()`` is a vDSO call,
so no cache thread is needed; what this keeps is one choke point so tests
can pin time, and so the device step receives time as an explicit
argument. The clock is this package's own: freezing it does not freeze
the JAX package's clock, and the other way round.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

_frozen_ms: Optional[int] = None

# Pre-advance hooks: async machinery (the token-lease stats committer)
# registers here so pending work stamped "now" lands BEFORE the frozen
# clock moves; otherwise a test's advance_time() would move commits into
# the wrong second. Never invoked under the real clock.
_pre_advance_hooks: List[Callable[[], None]] = []


def on_advance(hook: Callable[[], None]) -> Callable[[], None]:
    """Register a hook run before every frozen-clock advance; returns an
    unregister callable."""
    _pre_advance_hooks.append(hook)

    def off():
        try:
            _pre_advance_hooks.remove(hook)
        except ValueError:
            pass

    return off


def current_time_millis() -> int:
    if _frozen_ms is not None:
        return _frozen_ms
    return time.time_ns() // 1_000_000


def freeze_time(ms: int) -> None:
    """Pin the clock (tests and the smoke's parity script)."""
    global _frozen_ms
    _frozen_ms = int(ms)


def advance_time(delta_ms: int) -> None:
    global _frozen_ms
    if _frozen_ms is None:
        raise RuntimeError("advance_time requires freeze_time first")
    for hook in list(_pre_advance_hooks):
        hook()
    _frozen_ms += int(delta_ms)


def unfreeze_time() -> None:
    global _frozen_ms
    _frozen_ms = None
