"""Staged-rollout orchestration: shadow -> canary -> promote / abort (port
of ``sentinel_tpu/rollout/manager.py``).

Three stages per named candidate ruleset:

  * **shadow** — the candidate is compiled beside the live pack and
    evaluated in extra non-enforcing lanes of the fused step
    (``ops/step.py``); would-pass / would-block counts accumulate per
    resource and per family with no effect on verdicts.
  * **canary** — a deterministic hash of each request's (origin, context)
    key (``rollout/canary.py``) selects a stable ``canary_bps`` / 10000
    slice of traffic that the candidate's verdict ENFORCES; everyone else
    stays on the live rules. Shadow counting continues for every lane.
  * **promote / abort** — promote loads the MERGED rules into the live
    rule managers through the ``load_rules`` path every datasource push
    takes (one swap at the next compile) and bumps the promotion epoch;
    abort tears the shadow world down and keeps the live rules.

Guardrail: every :meth:`tick` diffs the cumulative shadow counters against
the previous tick and compares the candidate's block rate with the live
one; ``abort_windows`` consecutive windows with ``shadow_rate - live_rate
> max_block_delta`` abort the rollout.

Merging: a candidate overrides the live ruleset per RESOURCE for the
families it touches (live rules on resources it does not mention stay in
force), except system rules, which it replaces wholesale when it carries
any. The shadow pack compiles from this merged view, so shadow counts
answer "what would the world after promote have done".

Concurrency: every mutation runs under the engine's config lock (the
rule-push plane); the manager never takes the engine's dispatch lock, so
staging a rollout cannot stall admissions behind a compile. ``tick`` and
``diff`` read ``engine.shadow_counts()``, which takes the dispatch lock
for its one copy. Lifecycle listeners fire under the config lock.

Every transition records into the engine's journal (staging, stage
flips, promote, abort, each linked to the staging record), and a
promote's rule loads run under ``journal.causing(promote_seq)``, so their
``ruleLoad`` records link back to it. ``tick`` runs the SLO abort gate:
an active page-severity burn alert on a touched resource aborts the
candidate (``csp.sentinel.slo.rollout.abort`` turns it off).
"""

from __future__ import annotations

import contextlib
import zlib
from collections import deque
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional

from sentinel_tpu_torch.datasource import converters as CV
from sentinel_tpu_torch.telemetry import journal as journal_mod
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.rollout.canary import CANARY_BPS_MAX

STAGE_SHADOW = "shadow"
STAGE_CANARY = "canary"
STAGE_PROMOTED = "promoted"
STAGE_ABORTED = "aborted"
ACTIVE_STAGES = (STAGE_SHADOW, STAGE_CANARY)

FAMILIES = ("flow", "degrade", "authority", "system", "param")

# family -> (engine manager attribute, dict-parser)
_FAMILY_BIND = {
    "flow": ("flow_rules", CV.flow_rule_from_dict),
    "degrade": ("degrade_rules", CV.degrade_rule_from_dict),
    "authority": ("authority_rules", CV.authority_rule_from_dict),
    "system": ("system_rules", CV.system_rule_from_dict),
    "param": ("param_rules", CV.param_rule_from_dict),
}
# Wire aliases accepted in rollout payloads (the command plane's
# ``paramFlow`` naming vs the model package's ``param``).
_FAMILY_ALIAS = {"paramFlow": "param"}

DEFAULT_MAX_BLOCK_DELTA = 0.05   # candidate may block ≤ 5pp more than live
DEFAULT_ABORT_WINDOWS = 3        # consecutive breached ticks before abort
DEFAULT_MIN_WINDOW_ENTRIES = 64  # ticks with less traffic don't vote
DEFAULT_CANARY_BPS = 100         # 1% of traffic when unspecified


def _salt_for(name: str) -> int:
    """Stable per-candidate canary salt: different candidates sample
    different traffic slices, reruns of one candidate sample the same."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


@dataclass
class CandidateSet:
    """One named candidate ruleset moving through the rollout stages."""

    name: str
    stage: str = STAGE_SHADOW
    rules: Dict[str, list] = field(default_factory=dict)  # family -> rules
    canary_bps: int = 0
    source: str = "ops"  # "ops" (rollout command) | "datasource" (tagged)
    created_ms: int = 0
    stage_since_ms: int = 0
    ended_reason: Optional[str] = None
    # For datasource-tagged candidates: the stage the source's
    # ``rolloutStage`` tags last requested. Re-publishes with unchanged
    # tags must not clobber an ops-side escalation (see refresh_staged).
    source_stage: Optional[str] = None
    # Audit-journal seq of this candidate's staging record: later
    # transitions (stage flips, promote, abort) carry it as their
    # causeSeq, so the journal shows one linked lifecycle per candidate.
    journal_seq: Optional[int] = None

    def families(self) -> List[str]:
        return [f for f in FAMILIES if self.rules.get(f)]


class RolloutManager:
    """Owns candidate sets + the rollout guardrail for one engine."""

    def __init__(self, engine):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.engine = engine
        self._sets: Dict[str, CandidateSet] = {}
        self._active: Optional[str] = None
        self.promotion_epoch = 0
        self.max_block_delta = self._cfg_float(
            _cfg, "csp.sentinel.rollout.max.block.delta",
            DEFAULT_MAX_BLOCK_DELTA)
        self.abort_windows = _cfg.get_int(
            "csp.sentinel.rollout.abort.windows", DEFAULT_ABORT_WINDOWS)
        self.min_window_entries = _cfg.get_int(
            "csp.sentinel.rollout.min.window.entries",
            DEFAULT_MIN_WINDOW_ENTRIES)
        self._breach_streak = 0
        self._last_sample = None  # np.int64[NUM_SHADOW_COUNTERS] totals
        self._history: deque = deque(maxlen=60)
        # Lifecycle listeners: fn(event, candidate, reason) fired on
        # every promote ("promoted") and abort ("aborted") — the
        # adaptive loop's channel for endings it didn't drive itself.
        # Fired under the engine config lock: listeners must be
        # lock-light and NEVER call back into this manager.
        self._listeners: List = []

    @staticmethod
    def _cfg_float(cfg, key: str, default: float) -> float:
        v = cfg.get(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    # -- introspection -----------------------------------------------------

    @property
    def active_name(self) -> Optional[str]:
        return self._active

    def active_set(self) -> Optional[CandidateSet]:
        return self._sets.get(self._active) if self._active else None

    def candidate(self, name: Optional[str]) -> Optional[CandidateSet]:
        """Any known candidate set by name, active or ended (the
        adaptive loop reads ended stages/reasons through this)."""
        return self._sets.get(name) if name else None

    def add_lifecycle_listener(self, fn) -> None:
        self._listeners.append(fn)

    def _fire(self, event: str, cand: CandidateSet,
              reason: Optional[str]) -> None:
        for fn in self._listeners:
            try:
                fn(event, cand, reason)
            except Exception as ex:  # noqa: BLE001 — a buggy listener
                # must not break promote/abort (the rule plane).
                from sentinel_tpu_torch.log.record_log import record_log

                record_log.warn("rollout lifecycle listener failed: %r", ex)

    def device_active(self) -> bool:
        """True while a candidate is installed on device (shadow/canary) —
        the lease fast path stands down so every entry reaches the step
        the shadow lanes ride (core/lease.py gating)."""
        cand = self.active_set()
        return cand is not None and cand.stage in ACTIVE_STAGES

    def canary_config(self):
        """(canary_bps | None, salt) for the engine's dispatch plumbing."""
        cand = self.active_set()
        if cand is None or cand.stage != STAGE_CANARY:
            return None, 0
        return cand.canary_bps, _salt_for(cand.name)

    # -- candidate lifecycle (all under the engine config lock) ------------

    def _lock(self):
        return self.engine._config_lock

    def load_candidate(self, name: str, rules, stage: str = STAGE_SHADOW,
                       canary_bps: Optional[int] = None,
                       source: str = "ops") -> CandidateSet:
        """Register (or replace) a candidate set and install its shadow.

        ``rules``: {family: [rule dicts or rule objects]} — family keys
        accept the command plane's aliases (``paramFlow``). Only one
        candidate may hold the device at a time: staging a second while
        another is in shadow/canary raises (promote or abort first).
        """
        if stage not in ACTIVE_STAGES:
            raise ValueError(f"initial stage must be one of {ACTIVE_STAGES}")
        parsed = self._parse_rules(rules)
        if not any(parsed.values()):
            raise ValueError("candidate set carries no valid rules")
        with self._lock():
            cur = self.active_set()
            if cur is not None and cur.stage in ACTIVE_STAGES \
                    and cur.name != name:
                raise ValueError(
                    f"candidate {cur.name!r} is already {cur.stage}; "
                    "promote or abort it first")
            now = self.engine.now_ms()
            cand = CandidateSet(
                name=name, stage=stage, rules=parsed, source=source,
                created_ms=now, stage_since_ms=now,
                canary_bps=self._clamp_bps(
                    canary_bps if canary_bps is not None
                    else (DEFAULT_CANARY_BPS if stage == STAGE_CANARY else 0)))
            self._sets[name] = cand
            self._active = name
            self._reset_guardrail()
            self._notify()
            j = getattr(self.engine, "journal", None)
            if j is not None:
                cand.journal_seq = j.record(
                    "rolloutStage", name=name, stage=stage, source=source,
                    canaryBps=cand.canary_bps,
                    families={f: len(cand.rules[f])
                              for f in cand.families()})
            return cand

    @staticmethod
    def _clamp_bps(bps) -> int:
        # CANARY_BPS_MAX is the hash bucket modulus (canary.py): clamping
        # to the same constant keeps every clamped value selectable.
        return max(0, min(CANARY_BPS_MAX, int(bps)))

    def _parse_rules(self, rules) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for fam_raw, items in (rules or {}).items():
            fam = _FAMILY_ALIAS.get(fam_raw, fam_raw)
            if fam not in _FAMILY_BIND:
                raise ValueError(f"unknown rule family {fam_raw!r}")
            _, from_dict = _FAMILY_BIND[fam]
            parsed = [from_dict(r) if isinstance(r, dict) else r
                      for r in (items or [])]
            out[fam] = [r for r in parsed if r.is_valid()]
        return out

    def set_stage(self, name: str, stage: str,
                  canary_bps: Optional[int] = None) -> CandidateSet:
        """shadow ↔ canary transitions (+ canary percentage tuning)."""
        if stage not in ACTIVE_STAGES:
            raise ValueError(
                f"set_stage handles {ACTIVE_STAGES}; use promote()/abort()")
        with self._lock():
            cand = self._require_active(name)
            cand.stage = stage
            cand.stage_since_ms = self.engine.now_ms()
            if stage == STAGE_CANARY:
                cand.canary_bps = self._clamp_bps(
                    canary_bps if canary_bps is not None
                    else (cand.canary_bps or DEFAULT_CANARY_BPS))
            # Stage flips tune the traced canary scalars only — the
            # shadow world (counters, controller state) carries over.
            self.engine._set_canary(*self.canary_config())
            j = getattr(self.engine, "journal", None)
            if j is not None:
                j.record("rolloutStage", name=cand.name, stage=stage,
                         canaryBps=cand.canary_bps,
                         cause_seq=cand.journal_seq)
            return cand

    def promote(self, name: str) -> Dict:
        """Atomic swap into the live rule tensors: for every family the
        candidate touches, load the MERGED ruleset through the family
        manager (the same property path datasources push through), then
        tear the shadow world down."""
        with self._lock():
            cand = self._require_active(name)
            # The promote record lands BEFORE the rule loads it fires,
            # and the loads run under causing(seq): the resulting
            # ruleLoad records carry causeSeq -> this promote.
            j = getattr(self.engine, "journal", None)
            jseq = j.record("rolloutPromote", name=cand.name,
                            cause_seq=cand.journal_seq) if j else None
            loaded = {}
            with (journal_mod.causing(jseq) if j is not None
                  else contextlib.nullcontext()):
                for fam in cand.families():
                    merged = self.merged_rules(fam, cand)
                    detagged = [self._detag(r) for r in merged]
                    attr, _ = _FAMILY_BIND[fam]
                    getattr(self.engine, attr).load_rules(detagged)
                    loaded[fam] = len(detagged)
            cand.stage = STAGE_PROMOTED
            cand.stage_since_ms = self.engine.now_ms()
            cand.ended_reason = "promoted"
            self._active = None
            self.promotion_epoch += 1
            self._reset_guardrail()
            self._notify()
            self._fire("promoted", cand, None)
            return {"promoted": name, "epoch": self.promotion_epoch,
                    "rulesLoaded": loaded}

    def abort(self, name: Optional[str] = None,
              reason: str = "manual") -> Dict:
        """Tear the candidate down; live rules were never touched."""
        with self._lock():
            cand = self._require_active(name)
            cand.stage = STAGE_ABORTED
            cand.stage_since_ms = self.engine.now_ms()
            cand.ended_reason = reason
            self._active = None
            self._reset_guardrail()
            self._notify()
            j = getattr(self.engine, "journal", None)
            if j is not None:
                j.record("rolloutAbort", name=cand.name, reason=reason,
                         cause_seq=cand.journal_seq)
            self._fire("aborted", cand, reason)
            return {"aborted": cand.name, "reason": reason}

    def _require_active(self, name: Optional[str]) -> CandidateSet:
        cand = self.active_set()
        if cand is None:
            raise ValueError("no active candidate set")
        if name is not None and name != cand.name:
            raise ValueError(
                f"candidate {name!r} is not active ({cand.name!r} is)")
        return cand

    @staticmethod
    def _detag(rule):
        if getattr(rule, "candidate_set", None) or \
                getattr(rule, "rollout_stage", None):
            return dc_replace(rule, candidate_set=None, rollout_stage=None)
        return rule

    def _reset_guardrail(self) -> None:
        self._breach_streak = 0
        self._last_sample = None
        self._history.clear()

    def _notify(self) -> None:
        """Mark the device-side rollout artifacts dirty (compiled shadow
        pack + shadow state + lease gating). Caller holds the config lock."""
        eng = self.engine
        eng._dirty["rollout"] = True
        eng._set_canary(*self.canary_config())
        eng._rebuild_leases()

    # -- staged sources (datasource-tagged rules) --------------------------

    def refresh_staged(self) -> None:
        """Adopt rules that arrived through the normal datasource path
        carrying a ``candidateSet`` tag (core/rule_manager.py splits them
        out of the live partition). Called from the engine's rule-change
        listeners, under the config lock.

        One datasource-defined set becomes/updates the active candidate
        only when no OTHER candidate holds the device (first writer
        wins); its initial stage honors the rules' ``rolloutStage``.
        """
        staged: Dict[str, Dict[str, list]] = {}
        for fam, (attr, _) in _FAMILY_BIND.items():
            mgr = getattr(self.engine, attr)
            get_staged = getattr(mgr, "get_staged", None)
            if get_staged is None:
                continue
            for set_name, rules in get_staged().items():
                staged.setdefault(set_name, {})[fam] = rules
        cand = self.active_set()
        if cand is not None and cand.source == "datasource" \
                and cand.name not in staged:
            # The source dropped the tagged rules: the candidate is gone.
            self.abort(cand.name, reason="staged rules removed at source")
            cand = None
        for set_name, fam_rules in staged.items():
            if cand is None or cand.name == set_name:
                stage = STAGE_SHADOW
                for rules in fam_rules.values():
                    for r in rules:
                        rs = getattr(r, "rollout_stage", None)
                        if rs in ACTIVE_STAGES:
                            stage = rs
                if cand is not None:
                    cand.rules = {f: list(rs) for f, rs in fam_rules.items()}
                    # The tag-derived stage applies only when the SOURCE
                    # changed it since the last refresh: a re-publish with
                    # unchanged tags (or any unrelated rule push firing
                    # this listener) must not demote an ops-escalated
                    # canary back to the tags' stage.
                    if stage != cand.source_stage:
                        cand.source_stage = stage
                        if stage != cand.stage:
                            # set_stage: canary flips pick up the default
                            # slice when the bps was never configured.
                            self.set_stage(cand.name, stage)
                else:
                    adopted = self.load_candidate(
                        set_name, fam_rules, stage=stage,
                        source="datasource")
                    adopted.source_stage = stage
                break  # only one candidate may hold the device

    # -- merged view / device spec -----------------------------------------

    def merged_rules(self, family: str,
                     cand: Optional[CandidateSet] = None) -> list:
        """Live rules with the candidate's per-resource overrides applied
        — the ruleset the world would run after promote."""
        if cand is None:
            cand = self.active_set()
        attr, _ = _FAMILY_BIND[family]
        live = getattr(self.engine, attr).get_rules()
        crules = list((cand.rules if cand else {}).get(family, ()))
        if not crules:
            return live
        if family == "system":
            return crules  # resource-less: wholesale replacement
        covered = {r.resource for r in crules}
        return [r for r in live if r.resource not in covered] + crules

    def device_spec(self) -> Optional[Dict[str, list]]:
        """{family: merged rules} for the shadow pack compile, or None
        when nothing should be on device."""
        cand = self.active_set()
        if cand is None or cand.stage not in ACTIVE_STAGES:
            return None
        return {fam: self.merged_rules(fam, cand) for fam in FAMILIES}

    # -- guardrail ----------------------------------------------------------

    def tick(self, now_ms: Optional[int] = None) -> Dict:
        """One guardrail window: diff cumulative shadow counters against
        the previous tick, compare block rates, auto-abort on a streak.

        Drive it from any ops-plane cadence (the ``rollout`` command's
        ``op=tick``, a dashboard fetch loop, or a cron); tests call it
        directly with a pinned clock. Idempotence is per-call: each call
        IS one window.
        """
        now = now_ms if now_ms is not None else self.engine.now_ms()
        cand = self.active_set()
        if cand is None or cand.stage not in ACTIVE_STAGES:
            return {"active": None}
        # SLO breach gate (the reference's ``slo/``): an active PAGE-severity
        # burn alert on a resource the candidate touches aborts
        # IMMEDIATELY — no streak. The block-rate-delta guardrail below
        # compares candidate vs live on the same traffic; this one
        # catches the live world burning its error budget WHILE a canary
        # is enforcing (whatever the cause, a rollout must not ride
        # through a page). Opt out via csp.sentinel.slo.rollout.abort.
        slo = getattr(self.engine, "slo", None)
        if slo is not None and slo.rollout_abort_enabled:
            # Judgement only advances on reads (the spill ride) — a tick
            # driven from a cron with no scraper attached must refresh
            # itself, or a live page never transitions to active (and a
            # long-resolved one never transitions out).
            self.engine.slo_refresh(now_ms=now)
            touched = {r.resource for fam, rules in cand.rules.items()
                       if fam != "system" for r in rules}
            breaches = slo.abort_signal(touched or None)
            if breaches:
                worst = breaches[0]
                reason = (f"slo: {worst['objective']} burning at "
                          f"{worst['burnLong']}x over "
                          f"{worst['windowLongS']}s")
                if len(breaches) > 1:
                    reason += f" (+{len(breaches) - 1} more)"
                self.abort(cand.name, reason=reason)
                return {"active": cand.name, "stage": cand.stage,
                        "status": "aborted", "timestamp": now,
                        "sloBreaches": breaches}
        counts = self.engine.shadow_counts()
        if counts is None:
            return {"active": cand.name, "status": "no-device-state"}
        totals = counts.sum(axis=1)
        last, self._last_sample = self._last_sample, totals
        if last is None or bool((totals < last).any()):
            # First window after install, or the counters were reset
            # under us (rule push re-created the shadow world): baseline.
            return {"active": cand.name, "status": "baseline"}
        delta = totals - last
        live_total = int(delta[S.SH_LIVE_PASS] + delta[S.SH_LIVE_BLOCK])
        shadow_total = int(delta[S.SH_WOULD_PASS] + delta[S.SH_WOULD_BLOCK])
        if live_total < self.min_window_entries:
            return {"active": cand.name, "status": "idle",
                    "entries": live_total}
        # max(..., 1): min_window_entries may legitimately be configured
        # to 0, and an idle window must read as rate 0, not divide by it.
        live_rate = float(delta[S.SH_LIVE_BLOCK]) / max(live_total, 1)
        shadow_rate = float(delta[S.SH_WOULD_BLOCK]) / max(shadow_total, 1)
        block_delta = shadow_rate - live_rate
        breach = block_delta > self.max_block_delta
        self._breach_streak = self._breach_streak + 1 if breach else 0
        out = {
            "active": cand.name, "stage": cand.stage, "status": "ok",
            "timestamp": now, "entries": live_total,
            "liveBlockRate": round(live_rate, 6),
            "shadowBlockRate": round(shadow_rate, 6),
            "blockRateDelta": round(block_delta, 6),
            "breach": breach,
            "breachStreak": self._breach_streak,
            "windowsToAbort": max(0, self.abort_windows - self._breach_streak),
        }
        self._history.append(out)
        if breach and self._breach_streak >= self.abort_windows:
            self.abort(cand.name, reason=(
                f"guardrail: block-rate delta {block_delta:.4f} > "
                f"{self.max_block_delta} for {self._breach_streak} windows"))
            out["status"] = "aborted"
        return out

    # -- ops snapshots -------------------------------------------------------

    def guardrail_state(self) -> Dict:
        """Compact slice for ``resilience_stats()`` — one unified
        degradation picture beside the breaker/fallback channels."""
        cand = self.active_set()
        return {
            "activeCandidateSet": cand.name if cand else None,
            "stage": cand.stage if cand else None,
            "canaryBps": cand.canary_bps if cand else 0,
            "breachStreak": self._breach_streak,
            "windowsToAbort": (max(0, self.abort_windows - self._breach_streak)
                               if cand else None),
            "maxBlockRateDelta": self.max_block_delta,
            "promotionEpoch": self.promotion_epoch,
        }

    def snapshot(self) -> Dict:
        cand = self.active_set()
        return {
            "active": cand.name if cand else None,
            "stage": cand.stage if cand else None,
            "canaryBps": cand.canary_bps if cand else 0,
            "promotionEpoch": self.promotion_epoch,
            "guardrail": {
                "maxBlockRateDelta": self.max_block_delta,
                "abortWindows": self.abort_windows,
                "minWindowEntries": self.min_window_entries,
                "breachStreak": self._breach_streak,
                "history": list(self._history)[-10:],
            },
            "sets": {
                name: {
                    "stage": c.stage,
                    "families": {f: len(c.rules.get(f, ()))
                                 for f in c.families()},
                    "canaryBps": c.canary_bps,
                    "source": c.source,
                    "createdMs": c.created_ms,
                    "stageSinceMs": c.stage_since_ms,
                    "endedReason": c.ended_reason,
                }
                for name, c in self._sets.items()
            },
        }

    def diff(self) -> Dict:
        """Per-resource shadow-vs-live outcome deltas (dashboard view)."""
        counts = self.engine.shadow_counts()
        cand = self.active_set()
        if counts is None or cand is None:
            return {"active": cand.name if cand else None, "resources": {}}
        rows = self.engine._device_resources()
        out = {}
        for res, row in rows.items():
            c = counts[:, row]
            live_total = int(c[S.SH_LIVE_PASS] + c[S.SH_LIVE_BLOCK])
            shadow_total = int(c[S.SH_WOULD_PASS] + c[S.SH_WOULD_BLOCK])
            if live_total == 0 and shadow_total == 0:
                continue
            out[res] = {
                "wouldPass": int(c[S.SH_WOULD_PASS]),
                "wouldBlock": int(c[S.SH_WOULD_BLOCK]),
                "livePass": int(c[S.SH_LIVE_PASS]),
                "liveBlock": int(c[S.SH_LIVE_BLOCK]),
                "wouldBlockByFamily": {
                    "authority": int(c[S.SH_WB_AUTHORITY]),
                    "system": int(c[S.SH_WB_SYSTEM]),
                    "paramFlow": int(c[S.SH_WB_PARAM]),
                    "flow": int(c[S.SH_WB_FLOW]),
                    "degrade": int(c[S.SH_WB_DEGRADE]),
                },
                "blockRateDelta": round(
                    (int(c[S.SH_WOULD_BLOCK]) / max(shadow_total, 1))
                    - (int(c[S.SH_LIVE_BLOCK]) / max(live_total, 1)), 6),
            }
        return {"active": cand.name, "stage": cand.stage, "resources": out}
