"""Unified resilience layer for every remote touchpoint (port of
``sentinel_tpu/resilience/__init__.py``).

The framework exists to keep OTHER services degrading gracefully; this
package applies the same discipline to its own remote dependencies
(token server, datasources, dashboard):

* :class:`RetryPolicy` / :class:`RetrySession` — seedable exponential
  backoff with decorrelated jitter, shared by the token-client
  reconnect loop, the datasource poll loop, and the heartbeat rotation.
* :class:`HealthGate` — the repo's CLOSED/OPEN/HALF_OPEN breaker
  semantics as a host-side gate for remote clients.
* :class:`DeadlineBudget` — aggregate latency bound for the remote work
  one ``entry()`` may perform.
* :mod:`faults` — deterministic fault injection at named remote seams,
  zero-overhead when disabled.
* a process-wide health-probe registry, so long-lived remote loops
  (datasource pollers, heartbeat) surface liveness through
  ``engine.resilience_stats()`` next to ``fail_open_count``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Tuple

from sentinel_tpu_torch.resilience import faults
from sentinel_tpu_torch.resilience.breaker import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    HealthGate,
)
from sentinel_tpu_torch.resilience.budget import DeadlineBudget
from sentinel_tpu_torch.resilience.faults import FaultInjected, FaultInjector
from sentinel_tpu_torch.resilience.retry import RetryPolicy, RetrySession

__all__ = [
    "DeadlineBudget", "FaultInjected", "FaultInjector", "HealthGate",
    "RetryPolicy", "RetrySession", "STATE_CLOSED", "STATE_HALF_OPEN",
    "STATE_OPEN", "faults", "health_probes", "health_snapshot",
    "register_probe",
]

# -- health-probe registry ----------------------------------------------------
# Remote loops register a zero-arg callable returning a small dict of
# liveness facts (e.g. {"lastSuccessMs": ..., "consecutiveFailures": ...}).
# The engine's resilience_stats() walks this to report datasource /
# heartbeat health without owning those objects.

_probe_lock = threading.Lock()
_probes: Dict[str, Callable[[], dict]] = {}


def register_probe(name: str, probe: Callable[[], dict]) -> Callable[[], None]:
    """Register a named liveness probe; returns an unregister callable.
    A re-registered name replaces the old probe (restart-friendly).

    Bound methods are held via ``weakref.WeakMethod``: a source that is
    started and then dropped without ``close()`` must not be pinned alive
    by this process-global registry forever — its entry self-prunes on
    the next snapshot once the owner is collected."""
    if hasattr(probe, "__self__"):
        probe = weakref.WeakMethod(probe)
    else:
        strong = probe
        probe = lambda: strong  # noqa: E731 — uniform deref shape
    with _probe_lock:
        _probes[name] = probe

    def off() -> None:
        with _probe_lock:
            if _probes.get(name) is probe:
                del _probes[name]

    return off


def health_probes() -> List[Tuple[str, Callable[[], dict]]]:
    """Live probes, deref'd; entries whose owner died are pruned."""
    out, dead = [], []
    with _probe_lock:
        for name, ref in sorted(_probes.items()):
            fn = ref()
            if fn is None:
                dead.append(name)
            else:
                out.append((name, fn))
        for name in dead:
            del _probes[name]
    return out


def health_snapshot() -> Dict[str, dict]:
    """Evaluate every probe; a broken probe reports its error rather than
    hiding the rest."""
    out: Dict[str, dict] = {}
    for name, probe in health_probes():
        try:
            out[name] = dict(probe())
        except Exception as ex:  # noqa: BLE001 — ops surface, never raises
            out[name] = {"error": repr(ex)}
    return out
