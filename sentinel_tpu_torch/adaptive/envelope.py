"""Hard safety envelope for autonomous rule actuation (port of
``sentinel_tpu/adaptive/envelope.py``).

"Designing Scalable Rate Limiting Systems" (PAPERS.md) warns that
adaptive limiters without bounded actuation oscillate; this module is
the bound. Every invariant lives here, first-class and separately
testable, so the controller/policy layer (``controller.py``) can be
swapped for a learned model without re-litigating safety:

* **Floor/ceiling clamps** — a proposed threshold never leaves the
  target's ``[floor, ceiling]`` band, whatever the policy says.
* **Bounded step size** — one actuation moves a threshold by at most
  ``step_pct`` of its current value (with a 1.0 absolute minimum so
  small integer-ish thresholds can still move at all).
* **Per-resource cooldown** — after a promoted change, the resource is
  untouchable for ``cooldown_ms``: the new setting's effect must show
  up in the flight recorder before it may be re-judged.
* **Hysteresis (no flapping across the target)** — a proposal that
  REVERSES the direction of the previous promoted change is rejected
  for ``flip_cooldown_ms`` (2x the plain cooldown by default): one
  boundary-straddling sense can never ping-pong a threshold.
* **Global freeze** (:class:`FreezeGate`) — stale or faulted telemetry,
  a manual ops freeze, or the post-abort backoff window turn the whole
  loop read-only: a controller must never actuate on senses it cannot
  trust, and never re-propose into the blast crater of an abort.

The envelope never talks to the engine or the rollout manager — it is
pure host arithmetic over explicit inputs, which is what makes the
invariants testable in isolation (tests/test_adaptive.py drives every
clause without a device).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

# EnvelopeDecision.reason values (stable strings — the decision log and
# the ops command surface them verbatim).
REASON_OK = "ok"
REASON_FLOOR = "floor"
REASON_CEILING = "ceiling"
REASON_STEP = "step"
REASON_COOLDOWN = "cooldown"
REASON_FLIP = "hysteresis"
REASON_NOOP = "no-op"

# FreezeGate reasons, in precedence order (manual beats everything:
# an operator's freeze must not be re-labelled by a coincident fault).
FREEZE_MANUAL = "manual"
FREEZE_DISABLED = "recorder-disabled"
FREEZE_STALE = "telemetry-stale"
FREEZE_FAULTED = "telemetry-faulted"
FREEZE_BACKOFF = "abort-backoff"
FREEZE_DEGRADED = "degraded-leader"


class CooldownLedger:
    """Per-key cooldown + direction-flip hysteresis — the shared
    actuation-pacing primitive (extracted from
    :class:`SafetyEnvelope` so the shard rebalancer paces per-SLICE
    moves with the same clauses the adaptive loop paces per-resource
    threshold changes, instead of a second copy of the arithmetic).

    A key is whatever the caller actuates on (a resource name, a slice
    index); ``direction`` is any equality-comparable token (+1/-1 for
    thresholds, the destination leader for a slice move). After a
    :meth:`stamp`, the key is untouchable for ``cooldown_ms``, and a
    DIFFERENT direction stays rejected for ``flip_cooldown_ms`` (2x by
    default) — crossing back is where oscillation lives."""

    def __init__(self, cooldown_ms: int,
                 flip_cooldown_ms: Optional[int] = None):
        self.cooldown_ms = int(cooldown_ms)
        self.flip_cooldown_ms = (int(flip_cooldown_ms)
                                 if flip_cooldown_ms is not None
                                 else 2 * int(cooldown_ms))
        self._lock = threading.Lock()
        self._last: Dict = {}  # key -> (last stamped ms, direction)

    def check(self, key, direction, now_ms: int) -> Optional[str]:
        """REASON_COOLDOWN / REASON_FLIP when the key may not move
        (in that precedence), None when it may."""
        with self._lock:
            last = self._last.get(key)
        if last is None:
            return None
        last_ms, last_dir = last
        if now_ms - last_ms < self.cooldown_ms:
            return REASON_COOLDOWN
        if direction != last_dir \
                and now_ms - last_ms < self.flip_cooldown_ms:
            return REASON_FLIP
        return None

    def stamp(self, key, direction, now_ms: int) -> None:
        with self._lock:
            self._last[key] = (int(now_ms), direction)

    def state(self, now_ms: int) -> Dict:
        """Ops view: per-key cooldown remaining (keys inside only the
        longer flip window have served their plain cooldown and drop
        out, matching the adaptive ``cooldown_state`` shape)."""
        with self._lock:
            items = dict(self._last)
        out = {}
        for key, (last_ms, direction) in items.items():
            remaining = max(0, self.cooldown_ms - (now_ms - last_ms))
            if remaining > 0:
                out[key] = {"remainingMs": remaining,
                            "direction": direction}
        return out

    def reset(self) -> None:
        with self._lock:
            self._last.clear()


@dataclass(frozen=True)
class EnvelopeDecision:
    """Outcome of one :meth:`SafetyEnvelope.admit` call.

    ``allowed`` — the (possibly clamped) proposal may proceed;
    ``value`` — the threshold to actually stage (== ``current`` when
    rejected); ``clamped`` — a clamp changed the policy's ask;
    ``reason`` — which clause decided (one of the REASON_* constants).
    """

    allowed: bool
    value: float
    clamped: bool
    reason: str


class SafetyEnvelope:
    """Clamp + cooldown + hysteresis state for one adaptive loop."""

    def __init__(self, step_pct: float, cooldown_ms: int,
                 flip_cooldown_ms: Optional[int] = None):
        self.step_pct = float(step_pct)
        # Cooldown + direction-flip hysteresis live in the shared
        # ledger (the rebalancer paces slice moves through the same
        # primitive); direction here is +1/-1 relative to current.
        self._ledger = CooldownLedger(cooldown_ms, flip_cooldown_ms)

    @property
    def cooldown_ms(self) -> int:
        return self._ledger.cooldown_ms

    @property
    def flip_cooldown_ms(self) -> int:
        return self._ledger.flip_cooldown_ms

    def admit(self, resource: str, current: float, proposed: float,
              floor: float, ceiling: float, now_ms: int) -> EnvelopeDecision:
        """Run one proposal through every clause. Order matters and is
        part of the contract: cooldown/hysteresis (is actuation allowed
        AT ALL right now?) before clamps (how far may it go?), so a
        rejected resource never reports a misleading clamp reason."""
        direction = 1 if proposed > current else -1
        paced = self._ledger.check(resource, direction, now_ms)
        if paced is not None:
            return EnvelopeDecision(False, current, False, paced)
        if not floor <= current <= ceiling:
            # The LIVE value sits outside the band (an operator put it
            # there — e.g. an emergency clamp below the target's floor).
            # Admitting anything would either invert the ask's direction
            # (a congestion DECREASE clamped up to the floor is a limit
            # INCREASE) or stage a value the band forbids; both are
            # wrong, so the envelope refuses until the operator
            # reconciles the rule with the target (docs/OPERATIONS.md
            # "How to pin a resource static").
            return EnvelopeDecision(
                False, current, True,
                REASON_FLOOR if current < floor else REASON_CEILING)
        value, clamped, reason = proposed, False, REASON_OK
        # Bounded step first, band second: the band is the HARD invariant
        # (a floor/ceiling is never exceeded even when the step allows it).
        max_step = max(abs(current) * self.step_pct, 1.0)
        if abs(value - current) > max_step:
            value = current + max_step * direction
            clamped, reason = True, REASON_STEP
        if value < floor:
            value, clamped, reason = floor, True, REASON_FLOOR
        elif value > ceiling:
            value, clamped, reason = ceiling, True, REASON_CEILING
        if value == current:
            # Fully clamped back to where we already are (pinned at a
            # band edge, typically): not an actuation.
            return EnvelopeDecision(False, current, True, REASON_NOOP)
        return EnvelopeDecision(True, value, clamped, reason)

    def record_actuation(self, resource: str, current: float,
                         promoted: float, now_ms: int) -> None:
        """Stamp a PROMOTED change (cooldown + flip guard input).
        Proposals that die in shadow/canary don't stamp — the post-abort
        backoff (FreezeGate) covers that quiet period instead."""
        direction = 1 if promoted > current else -1
        self._ledger.stamp(resource, direction, now_ms)

    def cooldown_state(self, now_ms: int) -> Dict[str, Dict]:
        """Ops view: per-resource cooldown remaining."""
        return self._ledger.state(now_ms)

    def reset(self) -> None:
        self._ledger.reset()


@dataclass(frozen=True)
class FreezeState:
    frozen: bool
    reason: Optional[str]  # FREEZE_* constant, None when thawed


class FreezeGate:
    """Global actuation freeze: pure predicate over explicit inputs.

    The loop feeds it what it observed this tick; the gate only decides.
    Keeping it stateless (beyond nothing at all) means every clause is a
    one-line truth-table test.
    """

    def __init__(self, stale_after_ms: int):
        self.stale_after_ms = int(stale_after_ms)

    def evaluate(self, now_ms: int, *,
                 manual_frozen: bool,
                 recorder_enabled: bool,
                 last_second_ms: int,
                 fault_delta: int,
                 backoff_until_ms: int) -> FreezeState:
        """Precedence: manual > recorder-disabled > stale > faulted >
        backoff. ``last_second_ms`` is the newest COMPLETE second the
        flight recorder spilled (<= 0 means none yet — stale by
        definition); ``fault_delta`` counts fail-open / cluster-fallback
        events since the previous tick (any > 0 means the telemetry this
        tick judged may be missing the traffic that mattered most)."""
        if manual_frozen:
            return FreezeState(True, FREEZE_MANUAL)
        if not recorder_enabled:
            return FreezeState(True, FREEZE_DISABLED)
        if last_second_ms <= 0 \
                or now_ms - last_second_ms > self.stale_after_ms:
            return FreezeState(True, FREEZE_STALE)
        if fault_delta > 0:
            return FreezeState(True, FREEZE_FAULTED)
        if now_ms < backoff_until_ms:
            return FreezeState(True, FREEZE_BACKOFF)
        return FreezeState(False, None)


class RebalanceFreezeGate:
    """The shard rebalancer's freeze: same stateless-
    predicate discipline as :class:`FreezeGate`, with the clauses a
    PLACEMENT controller needs. Precedence: manual > stale-telemetry >
    degraded-leader > abort-backoff — an operator's freeze is never
    re-labelled, a skew computed from stale fleet series is never
    trusted, and nothing moves while any leader is degraded (moving
    slices around a sick leader amplifies the outage; fold-OUT plans
    evaluate with ``degraded_leaders=()`` because the sick leader is
    the reason to move, see cluster/rebalance.py)."""

    def __init__(self, stale_after_ms: int):
        self.stale_after_ms = int(stale_after_ms)

    def evaluate(self, now_ms: int, *,
                 manual_frozen: bool,
                 settled_through_ms: int,
                 degraded_leaders=(),
                 backoff_until_ms: int = 0) -> FreezeState:
        """``settled_through_ms`` is the newest second the fleet view
        has settled federation-wide (<= 0 means none — stale by
        definition); ``degraded_leaders`` the machine ids currently
        stale/regressed/unhealthy."""
        if manual_frozen:
            return FreezeState(True, FREEZE_MANUAL)
        if settled_through_ms <= 0 \
                or now_ms - settled_through_ms > self.stale_after_ms:
            return FreezeState(True, FREEZE_STALE)
        if degraded_leaders:
            return FreezeState(True, FREEZE_DEGRADED)
        if now_ms < backoff_until_ms:
            return FreezeState(True, FREEZE_BACKOFF)
        return FreezeState(False, None)
