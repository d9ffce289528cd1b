"""The simulator's program-advanced clock (port of
``sentinel_tpu/simulator/clock.py``).

Replay determinism starts here: a ``SimClock`` is the ONLY time source a
replayed engine sees (injected through the ``SentinelEngine(clock=)``
seam), it never reads the wall clock, and it moves only when the replay
program says so — so two runs of the same trace execute the identical
sequence of (state, batch, now) step calls whatever the host is doing.

The epoch is deliberately far from the process wall clock (default one
day past 0) so an accidental ambient wall-clock read anywhere in the
driven path produces instantly-wrong seconds instead of subtly-plausible
ones — this canary keeps the replay honest by construction.
"""

from __future__ import annotations


class SimClock:
    """Millisecond clock that advances only under program control."""

    __slots__ = ("_now_ms",)

    def __init__(self, epoch_ms: int):
        self._now_ms = int(epoch_ms)

    def now_ms(self) -> int:
        return self._now_ms

    def advance(self, delta_ms: int) -> int:
        """Move time forward; returns the new now. Backward movement is
        a programming error in a replay (the engine's cursors assume a
        run's timebase is monotone — ``set_clock`` exists for swapping
        timebases, not mid-run reversal)."""
        delta_ms = int(delta_ms)
        if delta_ms < 0:
            raise ValueError(f"SimClock cannot run backward ({delta_ms}ms)")
        self._now_ms += delta_ms
        return self._now_ms
