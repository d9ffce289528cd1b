"""The closed loop: sense -> propose -> shadow -> canary -> promote (port
of ``sentinel_tpu/adaptive/loop.py``).

``AdaptiveLoop`` is the only actuator in ``sentinel_tpu_torch/adaptive/``
and it owns exactly ZERO rule-mutation paths of its own: every candidate
it emits goes through
:class:`~sentinel_tpu_torch.rollout.manager.RolloutManager`
(``load_candidate`` -> shadow would-verdict evaluation in the fused
step's shadow lanes -> canary -> ``promote``), so the rollout's
block-rate guardrail and the SLO-breach auto-abort are the blast shield
for every autonomous change (``tests/test_torch_adaptive.py`` pins that
no code in this package calls ``load_rules``). The safety invariants — floor/ceiling, bounded step,
cooldown, hysteresis, global freeze, post-abort backoff — live in
``envelope.py``; the policy brain in ``controller.py``.

Cadence contract (the SLO engine's stance): the loop rides the engine's
once-per-second flight-recorder spill (``engine._spill_flight`` calls
:meth:`on_spill`), gated to one evaluation per
``csp.sentinel.adaptive.interval.seconds``, so a disabled or idle loop
adds zero per-step device work and no background thread. The
``adaptive`` ops command's ``op=tick`` forces an evaluation for drills
and tests.

Last-known-good: the loop snapshots the live flow rules at every
promotion (and at ``enable()``). Because candidates are never applied
directly, an abort at ANY stage leaves the live rules exactly at that
snapshot — the loop additionally verifies this (``lkgIntact`` on the
abort decision) and re-proposes nothing for the configured backoff.

Decision log: every propose/escalate/promote/abort/freeze/clamp is one
seq-numbered entry in a bounded deque — the ``adaptive`` command's
``history`` cursor space (same shape as the SLO transition log).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional

from sentinel_tpu_torch.adaptive.controller import (
    AdaptiveController,
    AdaptiveTarget,
    AimdPolicy,
)
from sentinel_tpu_torch.adaptive.envelope import (
    FreezeGate,
    SafetyEnvelope,
)
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.log.record_log import record_log
from sentinel_tpu_torch.rollout.manager import (
    ACTIVE_STAGES,
    STAGE_ABORTED,
    STAGE_CANARY,
    STAGE_PROMOTED,
    STAGE_SHADOW,
)
CANDIDATE_PREFIX = "adaptive-"


def _tunable(rule) -> bool:
    """Only plain direct-strategy QPS rules with the default limit-app
    and default control behavior are adaptive-tunable: every other shape
    (warm-up ramps, rate limiters, per-origin carve-outs, cluster-mode
    global budgets) encodes operator intent the loop must not rewrite."""
    return (rule.grade == C.FLOW_GRADE_QPS
            and rule.strategy == C.FLOW_STRATEGY_DIRECT
            and rule.control_behavior == C.CONTROL_BEHAVIOR_DEFAULT
            and rule.limit_app == C.LIMIT_APP_DEFAULT
            and not rule.cluster_mode)


class AdaptiveLoop:
    """Owns the propose->rollout lifecycle + decision log for one engine."""

    def __init__(self, engine):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.engine = engine
        self._lock = threading.RLock()
        # Non-reentrant tick gate: the tick itself refreshes judgement
        # (slo_refresh -> _spill_flight -> on_spill), which would recurse
        # back into tick(); acquire(blocking=False) turns that recursion
        # (and any concurrent ops-plane tick) into a cheap no-op.
        self._tick_gate = threading.Lock()
        self.interval_s = _cfg.adaptive_interval_seconds()
        self.shadow_soak_s = _cfg.adaptive_shadow_seconds()
        self.canary_soak_s = _cfg.adaptive_canary_seconds()
        self.canary_bps = _cfg.adaptive_canary_bps()
        self.backoff_s = _cfg.adaptive_abort_backoff_seconds()
        self.controller = AdaptiveController(AimdPolicy(
            increase_pct=_cfg.adaptive_increase_pct(),
            decrease_pct=_cfg.adaptive_decrease_pct(),
            hysteresis_pct=_cfg.adaptive_hysteresis_pct()))
        self.envelope = SafetyEnvelope(
            step_pct=_cfg.adaptive_step_pct(),
            cooldown_ms=_cfg.adaptive_cooldown_seconds() * 1000)
        self.freeze_gate = FreezeGate(
            stale_after_ms=_cfg.adaptive_freeze_stale_seconds() * 1000)
        self._enabled = _cfg.adaptive_enabled()
        self._manual_frozen = False
        self._freeze_reason: Optional[str] = None
        self._backoff_until_ms = 0
        # In-flight adaptive candidate + the changes it carries.
        self._inflight: Optional[str] = None
        self._inflight_changes: List[Dict] = []
        self._healthy_windows = 0
        self._candidate_seq = 0
        # Monotone counters (exporter families).
        self.proposal_count = 0
        self.promotion_count = 0
        self.abort_count = 0
        self.clamp_count = 0
        # Decision log: bounded, seq-cursored (`adaptive` command history).
        self._events: deque = deque(maxlen=_cfg.adaptive_history_capacity())
        self._seq = 0
        # Control-plane audit journal: every decision mirrors
        # into it with causality back-pointers (canary -> its propose,
        # promote -> its canary, abort -> the freeze that killed it),
        # and — the restart fix — a file-backed journal re-seeds the
        # decision log + seq cursor here so `history sinceSeq=` cursors
        # survive a process restart.
        self._journal = getattr(engine, "journal", None)
        self._jseq: Dict[str, int] = {}  # decision kind -> journal seq
        if self._journal is not None:
            for rec in self._journal.replay(kind="adaptiveDecision"):
                ev = rec.get("event")
                if isinstance(ev, dict) and "seq" in ev:
                    self._events.append(ev)
                    self._seq = max(self._seq, int(ev["seq"]))
        # Freeze inputs: fault-channel baseline (deltas, not absolutes —
        # a long-lived engine's historical fallbacks must not freeze the
        # loop forever) and envelope-rejection dedup for the log.
        self._fault_baseline: Optional[int] = None
        self._last_reject: Dict[str, str] = {}
        self._last_senses: Dict = {}
        # Last-known-good: {family: [rules]} snapshot + stamp.
        self._lkg: Optional[Dict[str, list]] = None
        self._lkg_ms = 0
        self._last_tick_ms = 0
        # Aborts/promotions landing OUTSIDE a tick (operator `rollout
        # abort`, a dashboard-driven guardrail tick) arrive through the
        # rollout lifecycle listener; appended lock-free (the listener
        # fires under the engine config lock — taking self._lock there
        # would invert the tick's lock order), drained by the next tick.
        self._rollout_events: deque = deque(maxlen=16)
        engine.rollout.add_lifecycle_listener(self._on_rollout_event)
        if self._enabled:
            self._capture_lkg()

    # -- rollout lifecycle listener (runs under the engine config lock) --

    def _on_rollout_event(self, event: str, cand, reason) -> None:
        if cand.name.startswith(CANDIDATE_PREFIX):
            self._rollout_events.append(
                (event, cand.name, reason,
                 self.engine.now_ms()))

    # -- ops controls ------------------------------------------------------

    def enable(self) -> Dict:
        with self._lock:
            if not self._enabled:
                self._enabled = True
                self._capture_lkg()
                self._log("enabled")
            return {"enabled": True}

    def disable(self) -> Dict:
        """Disable aborts any in-flight adaptive candidate: a canary
        left enforcing with nobody watching the guardrail results would
        be an unsupervised autonomous change — exactly what this
        subsystem exists to prevent."""
        with self._lock:
            inflight = self._inflight
            if self._enabled:
                self._enabled = False
                self._log("disabled")
        if inflight is not None:
            self._abort_inflight("adaptive disabled")
        return {"enabled": False}

    def freeze(self, reason: str = "ops") -> Dict:
        from sentinel_tpu_torch.adaptive.envelope import FREEZE_MANUAL

        with self._lock:
            if not self._manual_frozen:
                self._manual_frozen = True
                # Surface immediately (status must not wait a tick);
                # subsequent ticks recompute and agree (manual has top
                # precedence in the gate).
                self._freeze_reason = FREEZE_MANUAL
                self._log("freeze", reason=f"manual: {reason}")
            inflight = self._inflight
        if inflight is not None:
            self._abort_inflight(f"adaptive freeze: manual ({reason})")
        return {"frozen": True}

    def unfreeze(self) -> Dict:
        from sentinel_tpu_torch.adaptive.envelope import FREEZE_MANUAL

        with self._lock:
            if self._manual_frozen:
                self._manual_frozen = False
                if self._freeze_reason == FREEZE_MANUAL:
                    self._freeze_reason = None
                self._log("unfreeze")
            return {"frozen": False}

    def reset_timebase(self) -> None:
        """Forget absolute-stamp state (the engine's ``set_clock``
        seam): the abort backoff and the envelope's per-resource
        cooldown stamps are wall-clock absolutes — after a backward
        timebase swap `now < backoff_until_ms` would hold for (simulated)
        decades and the loop would report frozen-in-backoff forever.
        An in-flight candidate is aborted FIRST (the freeze stance: its
        ``stage_since_ms`` soak age is meaningless across timebases, so
        it would otherwise sit "soaking" forever and block proposals);
        the backoff that abort arms is then cleared with the rest.
        Counters, targets, and the decision log survive; the LKG
        snapshot's rules survive too (only its stamp is refreshed)."""
        self._abort_inflight("timebase swap")
        now = self.engine.now_ms()
        with self._lock:
            self._backoff_until_ms = 0
            self._last_tick_ms = 0
            self._fault_baseline = None
            if self._lkg is not None:
                self._lkg_ms = now
        self.envelope.reset()

    def load_targets(self, targets: List[AdaptiveTarget]) -> None:
        from sentinel_tpu_torch.datasource.converters import adaptive_target_to_dict
        from sentinel_tpu_torch.telemetry.journal import MAX_RULES_PER_RECORD

        with self._lock:
            self.controller.load_targets(targets)
            # Target dicts ride the decision event into the journal, so
            # a propose's causeSeq walk lands on the exact objective set
            # (with datasource provenance) that shaped it — capped like
            # every other load record (the count stays exact).
            self._log("targets", count=len(targets),
                      targets=[adaptive_target_to_dict(t)
                               for t in targets[:MAX_RULES_PER_RECORD]],
                      targetsTruncated=len(targets) > MAX_RULES_PER_RECORD)

    # -- the loop ----------------------------------------------------------

    def on_spill(self, now_ms: int) -> None:
        """Ride the once-per-second fold: evaluate at most once per
        configured interval. Zero work while disabled beyond two reads.

        The interval gate must survive a clock that stepped BACKWARD
        (NTP slew, a test re-freezing to an earlier epoch, a simulator
        timebase installed on a live engine): with the old stamp ahead
        of ``now_ms`` the subtraction stays negative and the loop would
        silently never tick again — the latent real-time-monotonicity
        assumption the clock-injection seam flushed out. A backward jump
        re-arms the gate at the new timebase instead."""
        if not self._enabled:
            return
        if now_ms < self._last_tick_ms:
            self._last_tick_ms = now_ms  # clock stepped back: re-arm
        if now_ms - self._last_tick_ms < self.interval_s * 1000:
            return
        self.tick(now_ms)

    def tick(self, now_ms: Optional[int] = None, force: bool = False) -> Dict:
        """One closed-loop evaluation. Reentry-safe (the judgement
        refresh below recurses into on_spill) and concurrency-safe (a
        second caller gets ``busy`` instead of a double actuation)."""
        if not self._tick_gate.acquire(blocking=False):
            return {"status": "busy"}
        try:
            now = (now_ms if now_ms is not None
                   else self.engine.now_ms())
            if force:
                # Ops/test-driven ticks bring judgement current first;
                # spill-driven ticks ride a spill that just did.
                self.engine.slo_refresh(now_ms=now)
            return self._tick(now)
        finally:
            self._tick_gate.release()

    def _tick(self, now: int) -> Dict:
        with self._lock:
            self._last_tick_ms = now
            self._drain_rollout_events()
            if not self._enabled:
                return {"status": "disabled"}
            fault_delta = self._fault_delta()
            freeze = self.freeze_gate.evaluate(
                now,
                manual_frozen=self._manual_frozen,
                recorder_enabled=self.engine.flight_seconds > 0,
                last_second_ms=self.engine.timeseries.last_stamp_ms,
                fault_delta=fault_delta,
                backoff_until_ms=self._backoff_until_ms)
            if freeze.reason != self._freeze_reason:
                self._freeze_reason = freeze.reason
                if freeze.frozen:
                    self._log("freeze", reason=freeze.reason)
                else:
                    self._log("thaw")
            inflight = self._inflight
        if freeze.frozen:
            # Frozen senses cannot be trusted to graduate a candidate
            # either — tear any in-flight one down. Like EVERY abort,
            # this arms the backoff (OPERATIONS: "quiet period after ANY
            # abort"), so a transient freeze that killed a candidate is
            # followed by the full quiet window after the thaw.
            if inflight is not None:
                self._abort_inflight(f"adaptive freeze: {freeze.reason}")
            return {"status": "frozen", "reason": freeze.reason,
                    "timestamp": now}
        if inflight is not None:
            return self._drive_inflight(now)
        return self._propose(now)

    # -- freeze inputs -----------------------------------------------------

    def _fault_delta(self) -> int:
        """Fail-open + cluster-degradation events since the previous
        tick: any of them means entries passed (or degraded) OUTSIDE the
        recorded device path this window, so the series the controller
        would judge is missing exactly the traffic that misbehaved."""
        eng = self.engine
        total = (eng.fail_open_count + eng.cluster_fallback_count
                 + eng.cluster_budget_exhausted_count
                 + eng.cluster_overload_count)
        last, self._fault_baseline = self._fault_baseline, total
        if last is None:
            return 0
        return max(0, total - last)

    # -- in-flight candidate driving ---------------------------------------

    def _drive_inflight(self, now: int) -> Dict:
        rollout = self.engine.rollout
        with self._lock:
            name = self._inflight
        if name is None:
            # disable()/freeze() settled the books between _tick's
            # locked capture and here — nothing left to drive.
            return {"status": "settled", "candidate": None}
        cand = rollout.candidate(name)
        if cand is None or cand.stage not in ACTIVE_STAGES:
            # Ended outside this tick (operator promote/abort, source
            # removal) — the listener queued it; settle the books now.
            self._settle_ended(name, cand, now)
            return {"status": "settled", "candidate": name}
        result = rollout.tick(now_ms=now)
        cand = rollout.candidate(name)
        if cand is None or cand.stage == STAGE_ABORTED:
            self._note_abort(name, cand.ended_reason if cand else "gone", now)
            return {"status": "aborted", "candidate": name,
                    "rollout": result}
        with self._lock:
            if result.get("status") == "ok" and not result.get("breach"):
                self._healthy_windows += 1
            elif result.get("breach"):
                self._healthy_windows = 0
            age_ms = now - cand.stage_since_ms
            healthy = self._healthy_windows >= 1 \
                and rollout.guardrail_state()["breachStreak"] == 0
        if cand.stage == STAGE_SHADOW \
                and age_ms >= self.shadow_soak_s * 1000 and healthy:
            rollout.set_stage(name, STAGE_CANARY, canary_bps=self.canary_bps)
            with self._lock:
                self._healthy_windows = 0
                self._log("canary", candidate=name,
                          canaryBps=self.canary_bps)
            return {"status": "canary", "candidate": name}
        if cand.stage == STAGE_CANARY \
                and age_ms >= self.canary_soak_s * 1000 and healthy:
            rollout.promote(name)
            self._note_promotion(name, now)
            return {"status": "promoted", "candidate": name}
        return {"status": "soaking", "candidate": name,
                "stage": cand.stage, "ageMs": age_ms,
                "rollout": result}

    def _settle_ended(self, name: str, cand, now: int) -> None:
        """The in-flight candidate ended without us driving it."""
        if cand is not None and cand.stage == STAGE_PROMOTED:
            self._note_promotion(name, now)
        else:
            self._note_abort(
                name, cand.ended_reason if cand else "gone", now)

    def _drain_rollout_events(self) -> None:
        """Caller holds self._lock. Listener-queued endings matter only
        when they concern a candidate we still think is in flight —
        everything else was settled by the tick that drove it."""
        while self._rollout_events:
            event, name, reason, _ms = self._rollout_events.popleft()
            if name != self._inflight:
                continue
            now = self.engine.now_ms()
            if event == "promoted":
                self._note_promotion(name, now)
            else:
                self._note_abort(name, reason, now)

    def _note_promotion(self, name: str, now: int) -> None:
        with self._lock:
            if self._inflight != name:
                return  # books already settled (racing settle paths)
            changes = self._inflight_changes
            for ch in changes:
                self.envelope.record_actuation(
                    ch["resource"], ch["from"], ch["to"], now)
            self.promotion_count += 1
            self._inflight = None
            self._inflight_changes = []
            self._healthy_windows = 0
            self._log("promote", candidate=name, changes=[
                {k: ch[k] for k in ("resource", "from", "to")}
                for ch in changes])
            # Next cycle's decisions must not link back to THIS
            # candidate's lifecycle records.
            self._jseq.pop("propose", None)
            self._jseq.pop("canary", None)
        self._capture_lkg()

    def _note_abort(self, name: str, reason, now: int) -> None:
        with self._lock:
            if self._inflight != name:
                return  # books already settled (racing settle paths)
            self.abort_count += 1
            self._backoff_until_ms = now + self.backoff_s * 1000
            self._inflight = None
            self._inflight_changes = []
            self._healthy_windows = 0
            self._log("abort", candidate=name, reason=str(reason),
                      backoffUntilMs=self._backoff_until_ms,
                      lkgIntact=self._lkg_intact())
            self._jseq.pop("propose", None)
            self._jseq.pop("canary", None)
        record_log.warn("adaptive candidate %s aborted: %s (backoff %ss)",
                        name, reason, self.backoff_s)

    def _abort_inflight(self, reason: str) -> None:
        """Abort our in-flight candidate through the rollout manager
        (never any other path). Benign if someone else already ended it."""
        name = self._inflight
        if name is None:
            return
        try:
            self.engine.rollout.abort(name, reason=reason)
        except ValueError:
            pass  # already ended; the listener/queue settles the books
        cand = self.engine.rollout.candidate(name)
        self._note_abort(
            name, cand.ended_reason if cand else reason,
            self.engine.now_ms())

    # -- proposing ---------------------------------------------------------

    def _propose(self, now: int) -> Dict:
        eng = self.engine
        targets = self.controller.targets()
        if not targets:
            return {"status": "no-targets"}
        view = eng.timeseries_view(limit=self.interval_s, now_ms=now)
        with self._lock:
            senses = self.controller.fold_senses(view["seconds"])
            self._last_senses = senses
            currents = self._tunable_counts(
                {t.resource for t in targets})
            desires = self.controller.desired(senses, currents)
            # An active alert on a resource (ANY severity — anomalies
            # vote here even though they don't vote on rollout aborts: a
            # PROPOSAL has no canary blast shield yet) gates it out.
            alerted = {a["resource"] for a in eng.slo.active_alerts_on(
                {d["resource"] for d in desires})} if desires else set()
            changes = []
            for d in desires:
                res = d["resource"]
                if res in alerted:
                    self._log_reject(res, "alert-active", d)
                    continue
                t = d["target"]
                env = self.envelope.admit(
                    res, d["current"], d["proposed"],
                    t.floor, t.ceiling, now)
                if env.clamped:
                    self.clamp_count += 1
                if not env.allowed:
                    self._log_reject(res, env.reason, d)
                    continue
                self._last_reject.pop(res, None)
                changes.append({
                    "resource": res, "from": d["current"],
                    "to": env.value, "clamped": env.clamped,
                    "why": self._why(d),
                })
            if not changes:
                return {"status": "steady", "timestamp": now,
                        "sensedResources": len(senses)}
            self._candidate_seq += 1
            name = f"{CANDIDATE_PREFIX}{self._candidate_seq}"
        rules = self._candidate_rules(changes)
        try:
            eng.rollout.load_candidate(
                name, {"flow": rules}, stage=STAGE_SHADOW, source="adaptive")
        except ValueError as ex:
            # Another candidate (an operator's) holds the device: the
            # human rollout wins, the loop stays out of the way.
            with self._lock:
                self._log("skip", reason=str(ex))
            return {"status": "skipped", "reason": str(ex)}
        with self._lock:
            # disable()/freeze() racing this staging saw no in-flight
            # candidate to abort — if either landed while we were
            # installing, the candidate must not be left stranded in
            # shadow with nobody driving it (the lease fast path stands
            # down while ANY candidate holds the device).
            stranded = not self._enabled or self._manual_frozen
            if not stranded:
                self._inflight = name
                self._inflight_changes = changes
                self._healthy_windows = 0
                self.proposal_count += len(changes)
                self._log("propose", candidate=name, changes=[
                    {k: ch[k] for k in ("resource", "from", "to", "why")}
                    for ch in changes])
        if stranded:
            try:
                eng.rollout.abort(
                    name, reason="adaptive disabled/frozen during staging")
            except ValueError:
                pass  # someone already ended it
            with self._lock:
                self._log("skip", reason="disabled/frozen during staging")
            return {"status": "skipped",
                    "reason": "disabled/frozen during staging"}
        return {"status": "proposed", "candidate": name,
                "changes": len(changes)}

    def _why(self, desire: Dict) -> str:
        s, t = desire["sense"], desire["target"]
        if desire["proposed"] < desire["current"]:
            return (f"rtP99 {s.rt_p99_ms:.1f}ms > target "
                    f"{t.rt_p99_ms:.1f}ms")
        return (f"blockRate {s.block_rate:.4f} > target "
                f"{t.max_block_rate:.4f}")

    def _log_reject(self, resource: str, reason: str, desire: Dict) -> None:
        """Caller holds self._lock. A pinned/cooling resource would
        otherwise re-log the identical rejection every interval — log
        transitions only."""
        if self._last_reject.get(resource) == reason:
            return
        self._last_reject[resource] = reason
        self._log("reject", resource=resource, reason=reason,
                  proposed=round(desire["proposed"], 4),
                  current=desire["current"])

    def _tunable_counts(self, resources) -> Dict[str, float]:
        """resource -> live count of its ONE tunable QPS rule. Resources
        with zero or several tunable rules are skipped (ambiguous —
        which one encodes 'the limit'?); docs/OPERATIONS.md documents
        pinning via target removal or a second rule shape."""
        by_res: Dict[str, list] = {}
        for r in self.engine.flow_rules.get_rules():
            if r.resource in resources and _tunable(r):
                by_res.setdefault(r.resource, []).append(r)
        return {res: float(rules[0].count)
                for res, rules in by_res.items() if len(rules) == 1}

    def _candidate_rules(self, changes: List[Dict]) -> List:
        """The changed rules only: rollout merge semantics keep every
        untouched live rule in force, and a candidate touching ONLY the
        tuned resources keeps the SLO-abort blast radius tight."""
        targeted = {ch["resource"]: ch["to"] for ch in changes}
        out = []
        for r in self.engine.flow_rules.get_rules():
            if r.resource in targeted and _tunable(r):
                out.append(dc_replace(r, count=targeted[r.resource]))
        return out

    # -- last-known-good ---------------------------------------------------

    def _capture_lkg(self) -> None:
        rules = list(self.engine.flow_rules.get_rules())
        with self._lock:
            self._lkg = {"flow": rules}
            self._lkg_ms = self.engine.now_ms()

    def _lkg_intact(self) -> bool:
        """Live rules byte-equal the retained snapshot (rules are frozen
        dataclasses — equality is field-wise). False does NOT trigger
        any actuation: a datasource push is allowed to move the world
        under the loop; this is the abort log's honesty bit."""
        if self._lkg is None:
            return False
        return list(self.engine.flow_rules.get_rules()) == self._lkg["flow"]

    def last_known_good(self) -> Optional[Dict[str, list]]:
        with self._lock:
            return ({fam: list(rs) for fam, rs in self._lkg.items()}
                    if self._lkg is not None else None)

    # -- log + read surfaces -----------------------------------------------

    def _log(self, kind: str, **fields) -> None:
        """Caller holds self._lock."""
        self._seq += 1
        event = {"seq": self._seq, "kind": kind,
                 "timestamp": self.engine.now_ms(), **fields}
        self._events.append(event)
        if self._journal is not None:
            self._jseq[kind] = self._journal.record(
                "adaptiveDecision", cause_seq=self._decision_cause(kind),
                event=dict(event))

    def _decision_cause(self, kind: str) -> Optional[int]:
        """The journal seq that SHAPED this decision: a canary links to
        its propose, a promote to the canary it graduated from, an
        abort to the freeze that killed it (else the stage it died in),
        a propose to the target load it serves. Caller holds _lock."""
        j = self._jseq
        if kind == "canary":
            return j.get("propose")
        if kind == "promote":
            return j.get("canary") or j.get("propose")
        if kind == "abort":
            return j.get("freeze") or j.get("canary") or j.get("propose")
        if kind == "thaw":
            return j.get("freeze")
        if kind == "propose":
            return j.get("targets")
        return None

    def history(self, since_seq: int = 0,
                limit: Optional[int] = None) -> Dict:
        with self._lock:
            events = [dict(e) for e in self._events
                      if e["seq"] > since_seq]
            if limit is not None and limit >= 0:
                # events[-0:] would be the whole log (the SLO alerts
                # lesson): limit=0 means "cursor only".
                events = events[-limit:] if limit > 0 else []
            return {"events": events, "nextSeq": self._seq}

    def status(self) -> Dict:
        from sentinel_tpu_torch.datasource.converters import adaptive_target_to_dict

        now = self.engine.now_ms()
        with self._lock:
            cand = self.engine.rollout.candidate(self._inflight) \
                if self._inflight else None
            return {
                "enabled": self._enabled,
                "frozen": self._freeze_reason is not None,
                "freezeReason": self._freeze_reason,
                "policy": self.controller.policy.name,
                "intervalSeconds": self.interval_s,
                "backoffUntilMs": self._backoff_until_ms,
                "inflight": ({
                    "candidate": self._inflight,
                    "stage": cand.stage if cand else None,
                    "changes": [
                        {k: ch[k] for k in ("resource", "from", "to")}
                        for ch in self._inflight_changes],
                } if self._inflight else None),
                "targets": [adaptive_target_to_dict(t)
                            for t in self.controller.targets()],
                "senses": {
                    res: {"blockRate": round(s.block_rate, 6),
                          "rtP99Ms": round(s.rt_p99_ms, 2),
                          "entries": s.entries, "seconds": s.seconds}
                    for res, s in sorted(self._last_senses.items())},
                "cooldowns": self.envelope.cooldown_state(now),
                "lastKnownGood": ({
                    "capturedMs": self._lkg_ms,
                    "families": {fam: len(rs)
                                 for fam, rs in self._lkg.items()},
                } if self._lkg is not None else None),
                "counters": self._counters(),
            }

    def _counters(self) -> Dict:
        return {
            "proposals": self.proposal_count,
            "promotions": self.promotion_count,
            "aborts": self.abort_count,
            "clamped": self.clamp_count,
        }

    def guardrail_state(self) -> Dict:
        """Compact slice for ``resilience_stats()["adaptive"]``."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "frozen": self._freeze_reason is not None,
                "freezeReason": self._freeze_reason,
                "inflightCandidate": self._inflight,
                "backoffUntilMs": self._backoff_until_ms,
                "targets": len(self.controller.targets()),
                **self._counters(),
            }

    def target_deltas(self) -> Dict[str, float]:
        """Latest sensed block-rate minus target per targeted resource
        (the ``sentinel_tpu_adaptive_target_delta`` gauge): positive =
        still blocking above target, the loop has work left."""
        with self._lock:
            out = {}
            for res, sense in self._last_senses.items():
                t = self.controller.target_for(res)
                if t is not None:
                    out[res] = round(sense.block_rate - t.max_block_rate, 6)
            return out
