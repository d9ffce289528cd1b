"""Sensing + policy layer of the closed adaptive loop (port of
``sentinel_tpu/adaptive/controller.py``).

"Multi-Objective Adaptive Rate Limiting in Microservices Using Deep
Reinforcement Learning" (PAPERS.md) motivates limits that track load
instead of static QPS. This module is the half that DECIDES what a
better limit would be; it never touches the engine's rules — the loop
(``loop.py``) carries every decision through the staged-rollout
lifecycle, and the envelope (``envelope.py``) bounds it first.

Pieces:

* :class:`AdaptiveTarget` — the per-resource objective an operator
  declares: keep the block rate at/below ``max_block_rate`` (and,
  optionally, RT p99 at/below ``rt_p99_ms``) by tuning the resource's
  simple QPS flow rule within ``[floor, ceiling]``.
* :class:`ResourceSense` — what one evaluation window actually saw:
  pass/block totals and the RT p99 estimate, folded from the flight
  recorder's exact per-second series (``engine.timeseries_view``).
* :class:`Policy` — the narrow protocol a controller implements:
  ``propose(sense, target, current) -> new threshold | None``. One
  pure function of explicit inputs, so learned controllers (the DRL
  direction) plug in without touching loop or envelope code.
* :class:`AimdPolicy` — the shipped default: additive-flavored
  multiplicative increase while blocking exceeds the target with
  healthy RT, multiplicative decrease when RT p99 breaches (the
  congestion signal), deadband around both targets so an on-target
  resource proposes nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol

from sentinel_tpu_torch.telemetry.attribution import histogram_quantile

DEFAULT_MIN_ENTRIES = 32


@dataclass(frozen=True)
class AdaptiveTarget:
    """One resource's adaptive objective + hard actuation band."""

    resource: str
    max_block_rate: float = 0.05   # keep block/(pass+block) at/below this
    rt_p99_ms: float = 0.0         # 0 = no RT target (availability only)
    floor: float = 1.0             # hard band: tuned count never leaves
    ceiling: float = 1_000_000.0   # [floor, ceiling], whatever the policy
    min_entries: int = DEFAULT_MIN_ENTRIES  # quieter windows don't vote

    def validate(self) -> "AdaptiveTarget":
        if not self.resource:
            raise ValueError("adaptive target needs a resource")
        if not 0.0 <= self.max_block_rate < 1.0:
            raise ValueError(
                f"maxBlockRate {self.max_block_rate} not in [0, 1)")
        if self.rt_p99_ms < 0:
            raise ValueError(f"rtP99Ms {self.rt_p99_ms} negative")
        if self.floor <= 0:
            raise ValueError(f"floor {self.floor} must be positive")
        if self.ceiling < self.floor:
            raise ValueError(
                f"ceiling {self.ceiling} below floor {self.floor}")
        if self.min_entries < 0:
            raise ValueError(f"minEntries {self.min_entries} negative")
        return self


@dataclass(frozen=True)
class ResourceSense:
    """One sense window's exact observation for one resource."""

    resource: str
    seconds: int         # complete seconds with traffic in the window
    passed: int
    blocked: int
    completions: int     # successful exits (RT histogram mass)
    block_rate: float    # blocked / (passed + blocked), 0 when idle
    rt_p99_ms: float     # histogram-estimated p99, 0 when no completions

    @property
    def entries(self) -> int:
        return self.passed + self.blocked


class Policy(Protocol):
    """The pluggable brain: desired new threshold for ONE resource.

    Implementations must be pure (no engine access, no clock reads —
    everything arrives in the arguments) and return ``None`` when no
    change is warranted. The envelope clamps whatever comes back, so a
    policy cannot escape the floor/ceiling/step bounds however wrong
    its output is.
    """

    name: str

    def propose(self, sense: ResourceSense, target: AdaptiveTarget,
                current: float) -> Optional[float]:
        ...  # pragma: no cover - protocol signature


class AimdPolicy:
    """AIMD on the block-rate target, gated by the RT-p99 target.

    * RT p99 above target (outside the deadband) -> multiplicative
      DECREASE (``x (1 - decrease_pct)``): the resource is congested;
      admitting less is the only lever a limiter has.
    * Block rate above target (outside the deadband) with RT healthy ->
      increase (``x (1 + increase_pct)``): demand exceeds the limit and
      the backend has headroom, so the limit is what's hurting.
    * Inside both deadbands -> ``None``. The deadband is the policy half
      of the no-flapping story (the envelope's flip cooldown is the
      other): a sense sitting ON the target proposes nothing in either
      direction.

    Block rate never triggers a decrease: blocking BELOW target means
    the limit is simply not binding, and shrinking an idle resource's
    limit buys nothing but a worse cold start when traffic returns
    (documented in docs/OPERATIONS.md "Adaptive limiting").
    """

    name = "aimd"

    def __init__(self, increase_pct: float, decrease_pct: float,
                 hysteresis_pct: float):
        self.increase_pct = float(increase_pct)
        self.decrease_pct = float(decrease_pct)
        self.hysteresis_pct = float(hysteresis_pct)

    def propose(self, sense: ResourceSense, target: AdaptiveTarget,
                current: float) -> Optional[float]:
        if sense.entries < max(target.min_entries, 1):
            return None
        if target.rt_p99_ms > 0 and sense.completions > 0 \
                and sense.rt_p99_ms \
                > target.rt_p99_ms * (1.0 + self.hysteresis_pct):
            return current * (1.0 - self.decrease_pct)
        # Deadband floor of 0.01 absolute: a 0-target (block nothing,
        # ever) still needs a non-empty band to not flap on a single
        # blocked entry in a million.
        band = max(target.max_block_rate * self.hysteresis_pct, 0.01)
        if sense.block_rate > target.max_block_rate + band:
            return current * (1.0 + self.increase_pct)
        return None


class AdaptiveController:
    """Targets + policy + sense folding for one engine's loop."""

    def __init__(self, policy):
        self.policy = policy
        self._targets: Dict[str, AdaptiveTarget] = {}

    # -- targets (wholesale load, the same §3.2 stance as rule families) --

    def load_targets(self, targets: List[AdaptiveTarget]) -> None:
        validated = [t.validate() for t in targets]
        new: Dict[str, AdaptiveTarget] = {}
        for t in validated:
            if t.resource in new:
                raise ValueError(
                    f"duplicate adaptive target for {t.resource!r}")
            new[t.resource] = t
        self._targets = new

    def targets(self) -> List[AdaptiveTarget]:
        return list(self._targets.values())

    def target_for(self, resource: str) -> Optional[AdaptiveTarget]:
        return self._targets.get(resource)

    # -- sensing -----------------------------------------------------------

    def fold_senses(self, seconds: List[Dict]) -> Dict[str, ResourceSense]:
        """Fold a ``timeseries_view`` page (chronological ``seconds``
        list, ``second_to_dict`` shape) into one sense per targeted
        resource. Host arithmetic over already-rendered dicts — the
        sense window costs zero device work beyond the spill that
        already rode the once-per-second fold."""
        out: Dict[str, ResourceSense] = {}
        for res in self._targets:
            passed = blocked = secs = 0
            buckets: Optional[List[int]] = None
            for sec in seconds:
                cell = sec["resources"].get(res)
                if not cell:
                    continue
                secs += 1
                passed += int(cell.get("pass", 0))
                blocked += int(cell.get("block", 0))
                rtb = cell.get("rtBuckets")
                if rtb:
                    if buckets is None:
                        buckets = [0] * len(rtb)
                    for i, v in enumerate(rtb):
                        buckets[i] += int(v)
            completions = int(sum(buckets)) if buckets else 0
            entries = passed + blocked
            out[res] = ResourceSense(
                resource=res, seconds=secs, passed=passed, blocked=blocked,
                completions=completions,
                block_rate=(blocked / float(entries) if entries else 0.0),
                rt_p99_ms=(float(histogram_quantile(buckets, 0.99))
                           if completions else 0.0),
            )
        return out

    # -- deciding ----------------------------------------------------------

    def desired(self, senses: Dict[str, ResourceSense],
                currents: Dict[str, float]) -> List[Dict]:
        """Raw policy asks, BEFORE the envelope: one dict per resource
        whose policy wants a change and which has a live simple-QPS rule
        to tune (``currents``: resource -> live rule count)."""
        out = []
        for res, target in self._targets.items():
            current = currents.get(res)
            if current is None:
                continue  # nothing to tune (documented: adaptive tunes
                # EXISTING simple QPS rules, it never creates rules)
            sense = senses.get(res)
            if sense is None:
                continue
            proposed = self.policy.propose(sense, target, current)
            if proposed is None:
                continue
            out.append({
                "resource": res,
                "current": float(current),
                "proposed": float(proposed),
                "sense": sense,
                "target": target,
            })
        return out
