"""Host-side circuit breaker (port of
``sentinel_tpu/resilience/breaker.py``): the repo's own
CLOSED/OPEN/HALF_OPEN semantics (``models/degrade.py``) on its remote
clients.

The device breaker is a vectorized per-rule state machine; remote
touchpoints (one token client, one heartbeat target) need the same
three-state contract as a tiny lock-guarded host object instead:

* CLOSED passes and counts consecutive failures; ``failure_threshold``
  consecutive failures trip OPEN.
* OPEN rejects without touching the wire until ``open_ms`` elapses, then
  the FIRST caller through becomes the HALF_OPEN probe (same
  first-arrival-wins stance as the device machine's segmented probe
  flag).
* HALF_OPEN admits at most ``half_open_probes`` in-flight probes; one
  success closes the breaker (stats reset), one failure re-opens it
  with a fresh retry window.

Time comes from ``utils/time_util`` so tests drive transitions with the
frozen clock. State numbering matches ``models/degrade.py``
(CLOSED=0 / OPEN=1 / HALF_OPEN=2) so ops dashboards read one legend.
"""

from __future__ import annotations

import threading

from sentinel_tpu_torch.utils import time_util

STATE_CLOSED = 0
STATE_OPEN = 1
STATE_HALF_OPEN = 2

_STATE_NAMES = {STATE_CLOSED: "CLOSED", STATE_OPEN: "OPEN",
                STATE_HALF_OPEN: "HALF_OPEN"}


class HealthGate:
    """Client-side breaker guarding one remote dependency."""

    def __init__(self, failure_threshold: int = 3, open_ms: int = 5_000,
                 half_open_probes: int = 1):
        if failure_threshold <= 0 or open_ms < 0 or half_open_probes <= 0:
            raise ValueError(
                f"invalid gate: threshold={failure_threshold} "
                f"open_ms={open_ms} probes={half_open_probes}")
        self.failure_threshold = int(failure_threshold)
        self.open_ms = int(open_ms)
        self.half_open_probes = int(half_open_probes)
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._next_retry_ms = 0
        self._probes_in_flight = 0
        # Ops counters (monotonic for the gate's lifetime).
        self.open_count = 0
        self.rejected_count = 0
        self._state_since_ms = time_util.current_time_millis()

    # -- queries ----------------------------------------------------------

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": _STATE_NAMES[self._state],
                "consecutiveFailures": self._consecutive_failures,
                "openCount": self.open_count,
                "rejectedCount": self.rejected_count,
                "stateSinceMs": self._state_since_ms,
            }

    # -- transitions ------------------------------------------------------

    def allow(self) -> bool:
        """May a call touch the wire right now? OPEN past its window
        flips to HALF_OPEN and admits the caller as the probe."""
        now = time_util.current_time_millis()
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN:
                if now >= self._next_retry_ms:
                    self._set_state(STATE_HALF_OPEN, now)
                    self._probes_in_flight = 1
                    return True
                self.rejected_count += 1
                return False
            # HALF_OPEN: bounded concurrent probes.
            if self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                return True
            self.rejected_count += 1
            return False

    def record_success(self) -> None:
        now = time_util.current_time_millis()
        with self._lock:
            self._consecutive_failures = 0
            if self._state != STATE_CLOSED:
                self._set_state(STATE_CLOSED, now)
            self._probes_in_flight = 0

    def record_failure(self) -> None:
        now = time_util.current_time_millis()
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._trip(now)  # failed probe: re-open, fresh window
                return
            self._consecutive_failures += 1
            if (self._state == STATE_CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._trip(now)

    def _trip(self, now: int) -> None:
        self._set_state(STATE_OPEN, now)
        self._next_retry_ms = now + self.open_ms
        self._probes_in_flight = 0
        self._consecutive_failures = 0
        self.open_count += 1

    def _set_state(self, state: int, now: int) -> None:
        self._state = state
        self._state_since_ms = now

    @classmethod
    def from_config(cls) -> "HealthGate":
        """Thresholds from ``csp.sentinel.resilience.breaker.*``."""
        from sentinel_tpu_torch.core.config import (
            DEFAULT_RESILIENCE_BREAKER_FAILURES,
            DEFAULT_RESILIENCE_BREAKER_OPEN_MS,
            DEFAULT_RESILIENCE_BREAKER_PROBES,
            RESILIENCE_BREAKER_FAILURES,
            RESILIENCE_BREAKER_OPEN_MS,
            RESILIENCE_BREAKER_PROBES,
            config,
        )

        try:
            return cls(
                failure_threshold=config.get_int(
                    RESILIENCE_BREAKER_FAILURES,
                    DEFAULT_RESILIENCE_BREAKER_FAILURES),
                open_ms=config.get_int(
                    RESILIENCE_BREAKER_OPEN_MS,
                    DEFAULT_RESILIENCE_BREAKER_OPEN_MS),
                half_open_probes=config.get_int(
                    RESILIENCE_BREAKER_PROBES,
                    DEFAULT_RESILIENCE_BREAKER_PROBES),
            )
        except ValueError as ex:
            # Config typo -> warn and run with defaults, never a
            # client-startup crash.
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn("invalid resilience breaker config (%s); "
                            "using defaults", ex)
            return cls(
                failure_threshold=DEFAULT_RESILIENCE_BREAKER_FAILURES,
                open_ms=DEFAULT_RESILIENCE_BREAKER_OPEN_MS,
                half_open_probes=DEFAULT_RESILIENCE_BREAKER_PROBES)
