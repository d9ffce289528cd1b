"""Slot-table eviction-storm chaos campaign (port of
``sentinel_tpu/chaos/slot_storm.py``).

The mesh campaign (``campaign.py``) certifies the SHARDED control
plane; this one certifies the single-engine SLOT TABLE: a real
``SentinelEngine`` in slot mode (bounded device hot set,
evict/rehydrate, cold-tail lease degradation) driven single-threaded
on a :class:`SimClock`, with the two ``slots.*`` fault seams armed:

* ``slots.evict.storm`` — the once-per-second rebalance tick evicts
  EVERY unpinned occupant (worst-case churn, fired above the freeze
  gate exactly like an operator drill);
* ``slots.spill.torn`` — a victim's spill record is torn in flight;
  it must rehydrate COLD, loudly counted, never half-grafted.

Every admit/evict/rehydrate/verdict transition the table emits lands
in a :class:`~sentinel_tpu_torch.chaos.invariants.History`, checked by
``check_slot_conservation`` after each episode: admits/evicts
alternate per slot at strictly increasing generations, every verdict
attributes to exactly one live (resource, generation), and each
evict→rehydrate round trip conserves window state.

An episode is a pure function of ``(campaign_seed, index)``: seeded
Zipf-ish workload over a namespace several times the slot budget,
leaseable-only flow rules (host-exact verdicts — no device timing in
the oracle), program-advanced clock, thread-scoped injector. The
verdict stream and the tenancy transition stream each hash to a
sha256 that replays BIT-IDENTICALLY, on every device and in the JAX
package alike.

Device: the episode's engine runs on the campaign's ``device`` (``cuda``
by default, which raises with no card).
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional

from sentinel_tpu_torch import chaos as _pkg
from sentinel_tpu_torch.chaos.campaign import _sha
from sentinel_tpu_torch.chaos.invariants import History, Violation, check_all
from sentinel_tpu_torch.chaos.scheduler import episode_seed
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.core.exceptions import BlockException
from sentinel_tpu_torch.resilience import FaultInjector
from sentinel_tpu_torch.simulator.clock import SimClock


class SlotStormResult(NamedTuple):
    index: int
    seed: int
    verdict_sha256: str
    tenancy_sha256: str
    violations: List[Violation]
    entries: int
    status: Dict

    def to_dict(self) -> dict:
        return {
            "episode": self.index, "episodeSeed": self.seed,
            "verdictSha256": self.verdict_sha256,
            "tenancySha256": self.tenancy_sha256,
            "violations": [v.to_dict() for v in self.violations],
            "entries": self.entries,
            "evictions": self.status.get("evictionsTotal"),
            "rehydrations": self.status.get("rehydrationsTotal"),
            "storms": self.status.get("stormsTotal"),
            "spillTorn": self.status.get("spillTornTotal"),
        }


class SlotStormCampaign:
    """N seed-replayable eviction-storm episodes over one slot table."""

    def __init__(self, campaign_seed: int = 0, episodes: int = 100,
                 seconds: int = 10, per_second: int = 12,
                 slot_budget: int = 8, resources: int = 30,
                 ruled_every: int = 10, ruled_count: int = 4,
                 storm_after: int = 3, torn_probability: float = 0.35,
                 device=None):
        from sentinel_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.campaign_seed = int(campaign_seed)
        self.episodes = int(episodes)
        self.seconds = int(seconds)
        self.per_second = max(1, int(per_second))
        self.slot_budget = int(slot_budget)
        self.resources = int(resources)
        self.ruled_every = max(1, int(ruled_every))
        self.ruled_count = int(ruled_count)
        self.storm_after = int(storm_after)
        self.torn_probability = float(torn_probability)
        self.epoch_ms = config.chaos_epoch_ms()

    # -- one episode -------------------------------------------------------

    def run_episode(self, index: int) -> SlotStormResult:
        from sentinel_tpu_torch.core.engine import SentinelEngine
        from sentinel_tpu_torch.models.flow import FlowRule

        seed = episode_seed(self.campaign_seed, index)
        clock = SimClock(self.epoch_ms)
        history = History()
        rng = random.Random(seed)
        names = [f"storm-res-{i}" for i in range(self.resources)]
        # Zipf-ish popularity: deterministic weights, seeded draws — the
        # hot head churns with the cold tail exactly as the telescope
        # expects, and two runs of one seed draw the identical stream.
        weights = [1.0 / (i + 1) ** 1.2 for i in range(self.resources)]
        eng = None
        entries = 0
        try:
            # scope_thread: the storm/torn seams fire ONLY on this
            # episode thread — a live host engine in the same process
            # neither eats the episode's fault budget nor suffers it.
            with FaultInjector(seed=seed, scope_thread=True) as injector:
                injector.arm("slots.evict.storm", mode="error",
                             after=self.storm_after, times=2)
                injector.arm("slots.spill.torn", mode="error",
                             probability=self.torn_probability)
                eng = SentinelEngine(clock=clock.now_ms, journal_path="",
                                     slot_budget=self.slot_budget,
                                     device=self.device)
                eng.slots.event_sink = history.events.append
                # Leaseable-only rules: host-exact verdicts, so the
                # oracle stream is a pure function of the draw sequence.
                eng.flow_rules.load_rules([
                    FlowRule(resource=names[i], count=self.ruled_count)
                    for i in range(0, self.resources, self.ruled_every)])
                for _ in range(self.seconds):
                    for _ in range(self.per_second):
                        res = rng.choices(names, weights=weights)[0]
                        entries += 1
                        try:
                            eng.entry(res).exit()
                        except BlockException:
                            pass
                    clock.advance(1000)
                    # Land leased commits + run the rebalance tick (the
                    # storm seam fires inside on_spill).
                    eng.slo_refresh(clock.now_ms())
                status = eng.slots.status()
        finally:
            if eng is not None:
                eng.close()
        violations = check_all(history, {}, 1)
        verdict_sha = _sha(
            f"{ev['sec']}:{ev['resource']}:{ev['verdict']}:{ev['reason']}"
            for ev in history.of("slotVerdict"))
        tenancy_sha = _sha(
            f"{ev['e']}:{ev['resource']}:{ev['slot']}:{ev['gen']}"
            for ev in history.events
            if ev["e"] in ("slotAdmit", "slotEvict", "slotRehydrate"))
        _pkg._count(episodes=1, violations=len(violations),
                    faultsFired=int(status.get("stormsTotal", 0))
                    + int(status.get("spillTornTotal", 0)))
        return SlotStormResult(index, seed, verdict_sha, tenancy_sha,
                               violations, entries, status)

    # -- the campaign ------------------------------------------------------

    def run(self) -> dict:
        import time

        t0 = time.perf_counter()  # duration only, never a timestamp
        results: List[SlotStormResult] = []
        first_violation: Optional[dict] = None
        for index in range(self.episodes):
            result = self.run_episode(index)
            results.append(result)
            if result.violations and first_violation is None:
                first_violation = result.to_dict()
        wall = max(time.perf_counter() - t0, 1e-9)
        return {
            "campaignSeed": self.campaign_seed,
            "episodes": len(results),
            "entries": sum(r.entries for r in results),
            "evictions": sum(int(r.status.get("evictionsTotal", 0))
                             for r in results),
            "rehydrations": sum(int(r.status.get("rehydrationsTotal", 0))
                                for r in results),
            "storms": sum(int(r.status.get("stormsTotal", 0))
                          for r in results),
            "spillTorn": sum(int(r.status.get("spillTornTotal", 0))
                             for r in results),
            "violations": sum(len(r.violations) for r in results),
            "firstViolation": first_violation,
            "episodesPerSec": round(len(results) / wall, 3),
            "verdictSha256": _sha(r.verdict_sha256 for r in results),
            "tenancySha256": _sha(r.tenancy_sha256 for r in results),
        }
