"""Declarative SLO objectives + multi-window burn-rate rules (port of
``sentinel_tpu/slo/objectives.py``).

An objective names a resource, an SLI, and a target good-fraction; each
objective carries a list of (long window, short window, burn threshold,
severity) rules — the SRE workbook's multiwindow multi-burn-rate alert
pairs, scaled to this system's second-granular retention (the classic
1h/5m + 6h/30m pairs assume month-long windows; here the flight
recorder retains ~17 minutes by default, so the shipped defaults are a
60s/5s fast-burn page and a 300s/60s slow-burn ticket).

SLI vocabulary (all derived from one flight-recorder second, exactly):

* ``availability`` — good = admitted entries; ``bad = block``,
  ``total = pass + block`` (acquire-count weighted, like the recorder).
* ``latency`` — good = successful completions with RT <= the objective's
  ``latency_ms``; derived from the per-second RT histogram, so the
  threshold SNAPS UP to the nearest log2 bucket edge
  (``attribution.RT_BUCKET_EDGES_MS``) — the snapped value is what the
  objective actually enforces and what :func:`snap_latency_ms` reports.

Burn rate over a window W ending at the newest complete second:

    error_rate(W) = sum(bad) / sum(total)        (0 when total == 0)
    burn(W)       = error_rate(W) / (1 - objective)

A rule FIRES while ``burn(long) >= threshold AND burn(short) >=
threshold`` and the long window saw at least ``min_events`` total
events; it RESOLVES as soon as either side drops. Idle seconds are
zeros by construction (stamp arithmetic — a missing second contributes
to neither numerator nor denominator).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from sentinel_tpu_torch.telemetry.attribution import RT_BUCKET_EDGES_MS

SLI_AVAILABILITY = "availability"
SLI_LATENCY = "latency"
SLIS = (SLI_AVAILABILITY, SLI_LATENCY)

SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"
SEVERITIES = (SEVERITY_PAGE, SEVERITY_TICKET)


@dataclass(frozen=True)
class BurnWindow:
    """One fast/slow-burn rule: both windows must exceed ``burn``."""

    long_s: int
    short_s: int
    burn: float
    severity: str = SEVERITY_PAGE

    def validate(self) -> "BurnWindow":
        if self.long_s <= 0 or self.short_s <= 0 \
                or self.short_s > self.long_s:
            raise ValueError(
                f"burn window needs 0 < shortSeconds <= longSeconds, got "
                f"{self.short_s}/{self.long_s}")
        if self.burn <= 0:
            raise ValueError(f"burn threshold must be > 0, got {self.burn}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got "
                f"{self.severity!r}")
        return self


# Fast-burn page + slow-burn ticket, scaled to second-level retention.
DEFAULT_BURN_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=60, short_s=5, burn=14.4, severity=SEVERITY_PAGE),
    BurnWindow(long_s=300, short_s=60, burn=6.0, severity=SEVERITY_TICKET),
)

DEFAULT_MIN_EVENTS = 10


def snap_latency_ms(latency_ms: int) -> int:
    """The latency threshold the RT histogram can enforce exactly: the
    smallest bucket edge >= the requested value (requests above the top
    edge land in the +Inf bucket, so anything past it means "good =
    every finite bucket")."""
    for edge in RT_BUCKET_EDGES_MS:
        if latency_ms <= edge:
            return int(edge)
    return int(RT_BUCKET_EDGES_MS[-1])


@dataclass(frozen=True)
class SloObjective:
    """One resource's target: ``objective`` is the good-fraction target
    (e.g. 0.99 = at most 1% bad), strictly inside (0, 1) so the error
    budget ``1 - objective`` is never zero."""

    resource: str
    sli: str = SLI_AVAILABILITY
    objective: float = 0.99
    latency_ms: int = 256          # latency SLI only; snapped to an edge
    min_events: int = DEFAULT_MIN_EVENTS
    windows: Tuple[BurnWindow, ...] = DEFAULT_BURN_WINDOWS
    name: str = ""

    def validate(self) -> "SloObjective":
        if not self.resource:
            raise ValueError("objective needs a resource")
        if self.sli not in SLIS:
            raise ValueError(f"sli must be one of {SLIS}, got {self.sli!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.sli == SLI_LATENCY and self.latency_ms <= 0:
            raise ValueError(
                f"latency objective needs latencyMs > 0, got "
                f"{self.latency_ms}")
        if self.min_events < 0:
            raise ValueError(f"minEvents must be >= 0, got {self.min_events}")
        if not self.windows:
            raise ValueError("objective needs at least one burn window")
        for w in self.windows:
            w.validate()
        return self

    @property
    def key(self) -> str:
        return self.name or f"{self.resource}:{self.sli}"

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @property
    def snapped_latency_ms(self) -> int:
        return snap_latency_ms(self.latency_ms)

    def bad_total(self, second: Dict) -> Tuple[int, int]:
        """(bad, total) events of this SLI in one rendered recorder
        second (the ``second_to_dict`` per-resource cell). The ONE
        derivation both the live evaluator and the test oracle share the
        definition of — the oracle reimplements it in numpy."""
        if self.sli == SLI_AVAILABILITY:
            bad = int(second.get("block", 0))
            total = bad + int(second.get("pass", 0))
            return bad, total
        buckets = second.get("rtBuckets") or []
        total = int(sum(buckets))
        edge = self.snapped_latency_ms
        good = sum(int(buckets[b]) for b in range(len(buckets))
                   if b < len(RT_BUCKET_EDGES_MS)
                   and RT_BUCKET_EDGES_MS[b] <= edge)
        return total - good, total


def max_window_seconds(objectives) -> int:
    """Retention the evaluator needs: the widest long window in play."""
    return max((w.long_s for o in objectives for w in o.windows), default=0)
