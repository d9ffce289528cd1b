"""SLO manager: per-second evaluation, alert store, health scoring (port
of ``sentinel_tpu/slo/manager.py``).

One :class:`SloManager` rides each engine. It consumes the flight
recorder's COMPLETE seconds exactly as the host history renders them
(``second_to_dict`` — the same JSON every other surface shares) and
turns them into judgement:

* **Burn-rate rules** — every objective keeps a bounded per-second
  series of (bad, total) events; ``evaluate(now)`` computes each rule's
  long/short-window burn rates at the newest complete second boundary
  and drives the alert state machine. Idle seconds are implicit zeros
  (stamp arithmetic), so burn decays exactly as traffic stops.
* **Anomaly baselines** — resources with NO explicit objective get one
  :class:`~sentinel_tpu_torch.slo.baseline.EwmaBaseline` per signal (per-
  second block rate, per-second RT p99 from the device histogram);
  z-score breaches fire ``anomaly`` alerts through the same machinery.
* **Health scores** — active alerts and the overload batcher's shed
  rate compose into a 0-100 score per resource and per instance
  (formula in docs/OPERATIONS.md; deliberately simple and monotone:
  page -40, ticket -20, anomaly -15, shed-rate up to -50 instance-wide).

Cadence contract: ``ingest``/``evaluate`` are driven by the engine's
flight-recorder spill (``engine._spill_flight`` — the once-per-second
fold's read side), so SLO evaluation adds ZERO per-step device work and
no background thread. Readers (the ``alerts``/``slo`` commands, the
exporter, the dashboard SSE pump) refresh it at their own cadence.

All mutation runs under one manager lock; alert fan-out (webhook) is
queue-decoupled and never blocks evaluation.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Set, Tuple

from sentinel_tpu_torch.slo.baseline import EwmaBaseline
from sentinel_tpu_torch.slo.objectives import (
    SEVERITY_PAGE,
    SloObjective,
    max_window_seconds,
)
from sentinel_tpu_torch.slo.webhook import AlertWebhook
from sentinel_tpu_torch.telemetry.attribution import histogram_quantile

# Health-score penalties per active alert (docs/OPERATIONS.md).
PENALTY = {"page": 40, "ticket": 20, "anomaly": 15}
SHED_PENALTY_CAP = 50

BASELINE_SIGNALS = ("blockRate", "rtP99Ms")


class SloManager:
    """Objectives + baselines + alert store for one engine."""

    def __init__(self, engine=None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.engine = engine
        self._lock = threading.RLock()
        self._objectives: "OrderedDict[str, SloObjective]" = OrderedDict()
        # objective key -> deque[(stamp_ms, bad, total)] of traffic
        # seconds inside the widest window (idle seconds are implicit).
        self._series: Dict[str, Deque[Tuple[int, int, int]]] = {}
        self._retain_ms = 0
        # resource -> {signal: EwmaBaseline} for objective-less resources.
        self._baselines: Dict[str, Dict[str, EwmaBaseline]] = {}
        self.baseline_alpha = _cfg.slo_baseline_alpha()
        self.baseline_zscore = _cfg.slo_baseline_zscore()
        self.baseline_warmup = _cfg.slo_baseline_warmup_seconds()
        self.baseline_min_events = _cfg.slo_baseline_min_events()
        self.rollout_abort_enabled = _cfg.slo_rollout_abort()
        # Alert store: active alerts by key + a bounded transition log
        # (each fired/resolved transition is one seq-numbered event —
        # the SSE pump's and webhook's shared cursor space).
        self._active: "OrderedDict[str, Dict]" = OrderedDict()
        self._events: Deque[Dict] = deque(maxlen=_cfg.alert_history_capacity())
        self._seq = 0
        self.fired_count = 0
        self.resolved_count = 0
        # Control-plane audit journal: every transition
        # mirrors into it (a resolve carries causeSeq -> its fire), and
        # — the restart fix — a file-backed journal re-seeds the
        # transition log + seq cursor here, so `alerts sinceSeq=`
        # cursors held by external consumers survive a process restart
        # instead of silently replaying from 1.
        self.journal = getattr(engine, "journal", None) \
            if engine is not None else None
        self._fired_jseq: Dict[str, int] = {}
        if self.journal is not None:
            for rec in self.journal.replay(kind="sloTransition"):
                ev = rec.get("event")
                if isinstance(ev, dict) and "seq" in ev:
                    self._events.append(ev)
                    self._seq = max(self._seq, int(ev["seq"]))
        self.webhook = AlertWebhook()
        # Evaluation cursors + last burn snapshot per objective.
        self._last_ingest_ms = -1
        self._eval_end_ms = -1
        self._burn: Dict[str, Dict] = {}
        # Overload shed-rate (health input): deltas of the batcher's
        # cumulative counters, windowed per NEW complete second (not per
        # evaluate() call — concurrent readers would otherwise shrink
        # the delta window to milliseconds and hide real shedding).
        self._shed_last: Optional[Tuple[int, int]] = None
        self._shed_end_ms = -1
        self.shed_rate = 0.0

    # -- objectives --------------------------------------------------------

    def load_objectives(self, objectives: List[SloObjective]) -> None:
        """Wholesale replacement (the same §3.2 semantics every rule
        family uses — datasource pushes and the ``slo`` command both land
        here). Series survive for objectives whose definition is
        unchanged; removed objectives resolve their alerts."""
        validated = [o.validate() for o in objectives]
        with self._lock:
            new: "OrderedDict[str, SloObjective]" = OrderedDict()
            for o in validated:
                if o.key in new:
                    raise ValueError(f"duplicate objective key {o.key!r}")
                new[o.key] = o
            old = self._objectives
            self._objectives = new
            self._retain_ms = max_window_seconds(new.values()) * 1000
            self._series = {
                k: (self._series.get(k, deque())
                    if old.get(k) == new[k] else deque())
                for k in new
            }
            self._burn = {k: v for k, v in self._burn.items() if k in new}
            # Resources that now carry an objective leave baseline
            # jurisdiction; their anomaly alerts resolve.
            covered = {o.resource for o in new.values()}
            for res in list(self._baselines):
                if res in covered:
                    del self._baselines[res]
            now = self._now_ms()
            for key, alert in list(self._active.items()):
                gone = (alert["kind"] == "burn_rate"
                        and alert["objective"] not in new) or \
                       (alert["kind"] == "anomaly"
                        and alert["resource"] in covered)
                if gone:
                    self._transition(key, False, now, alert)
        if self.journal is not None:
            from sentinel_tpu_torch.datasource.converters import (
                slo_objective_to_dict)
            from sentinel_tpu_torch.telemetry.journal import MAX_RULES_PER_RECORD

            self.journal.record(
                "sloLoad", count=len(validated),
                objectives=[slo_objective_to_dict(o)
                            for o in validated[:MAX_RULES_PER_RECORD]])

    def objectives(self) -> List[SloObjective]:
        with self._lock:
            return list(self._objectives.values())

    # -- ingestion (flight-recorder spill feed) ----------------------------

    def ingest(self, stamp_ms: int, resources: Dict[str, Dict]) -> None:
        """Feed one rendered COMPLETE second (``second_to_dict`` shape).
        Stamps must arrive monotonically (the spill guarantees it);
        replays are ignored, first wins."""
        with self._lock:
            if stamp_ms <= self._last_ingest_ms:
                return
            self._last_ingest_ms = stamp_ms
            for key, obj in self._objectives.items():
                cell = resources.get(obj.resource)
                if not cell:
                    continue
                bad, total = obj.bad_total(cell)
                if total <= 0 and bad <= 0:
                    continue
                series = self._series[key]
                series.append((stamp_ms, bad, total))
                floor = stamp_ms - self._retain_ms
                while series and series[0][0] < floor:
                    series.popleft()
            covered = {o.resource for o in self._objectives.values()}
            for res, cell in resources.items():
                if res in covered:
                    continue
                self._ingest_baseline(res, cell, stamp_ms)

    def _ingest_baseline(self, res: str, cell: Dict, stamp_ms: int) -> None:
        bls = self._baselines.get(res)
        if bls is None:
            bls = self._baselines[res] = {
                sig: EwmaBaseline(self.baseline_alpha, self.baseline_zscore,
                                  self.baseline_warmup)
                for sig in BASELINE_SIGNALS
            }
        events = int(cell.get("pass", 0)) + int(cell.get("block", 0))
        if events > 0:
            x = float(cell.get("block", 0)) / float(events)
            breach = bls["blockRate"].update(x) \
                and events >= self.baseline_min_events
            self._anomaly_transition(res, "blockRate", breach,
                                     bls["blockRate"], x, stamp_ms)
        buckets = cell.get("rtBuckets") or []
        completions = int(sum(buckets))
        if completions > 0:
            x = float(histogram_quantile(buckets, 0.99))
            breach = bls["rtP99Ms"].update(x) \
                and completions >= self.baseline_min_events
            self._anomaly_transition(res, "rtP99Ms", breach,
                                     bls["rtP99Ms"], x, stamp_ms)

    def _anomaly_transition(self, res: str, signal: str, firing: bool,
                            bl: EwmaBaseline, value: float,
                            stamp_ms: int) -> None:
        key = f"anomaly:{res}:{signal}"
        self._transition(key, firing, stamp_ms, {
            "key": key,
            "kind": "anomaly",
            "severity": "anomaly",
            "resource": res,
            "signal": signal,
            "value": round(value, 6),
            "zscore": round(bl.last_z, 4),
            "threshold": self.baseline_zscore,
            "baselineMean": round(bl.mean, 6),
        })

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now_ms: int) -> None:
        """Run every burn rule at the newest complete second boundary
        (``end = now - now % 1000``; the window is the ``long_s`` /
        ``short_s`` seconds strictly before it). Idempotent per
        boundary; host arithmetic only."""
        end = int(now_ms) - int(now_ms) % 1000
        with self._lock:
            if end < self._eval_end_ms:
                return
            self._eval_end_ms = end
            for key, obj in self._objectives.items():
                series = self._series[key]
                rules_out = []
                for w in obj.windows:
                    bad_l, tot_l = _window_sums(series, end, w.long_s)
                    bad_s, tot_s = _window_sums(series, end, w.short_s)
                    burn_l = _burn(bad_l, tot_l, obj.budget)
                    burn_s = _burn(bad_s, tot_s, obj.budget)
                    firing = (tot_l >= obj.min_events
                              and burn_l >= w.burn and burn_s >= w.burn)
                    rule_key = (f"burn:{key}:{w.long_s}s/{w.short_s}s"
                                f":{w.severity}")
                    self._transition(rule_key, firing, end, {
                        "key": rule_key,
                        "kind": "burn_rate",
                        "severity": w.severity,
                        "resource": obj.resource,
                        "sli": obj.sli,
                        "objective": key,
                        "target": obj.objective,
                        "windowLongS": w.long_s,
                        "windowShortS": w.short_s,
                        "burnThreshold": w.burn,
                        "burnLong": round(burn_l, 6),
                        "burnShort": round(burn_s, 6),
                        "eventsLong": tot_l,
                    })
                    rules_out.append({
                        "longSeconds": w.long_s,
                        "shortSeconds": w.short_s,
                        "severity": w.severity,
                        "burnThreshold": w.burn,
                        "burnLong": burn_l,
                        "burnShort": burn_s,
                        "badLong": bad_l,
                        "totalLong": tot_l,
                        "firing": firing,
                    })
                self._burn[key] = {
                    "resource": obj.resource,
                    "sli": obj.sli,
                    "target": obj.objective,
                    "rules": rules_out,
                    "evaluatedAtMs": end,
                }
            if end > self._shed_end_ms:
                self._shed_end_ms = end
                self._update_shed_rate()

    def _update_shed_rate(self) -> None:
        """Instance health input: the overload batcher's shed fraction
        since the previous evaluation (the batcher's counters feed the
        health score). None while this
        instance is not a token server."""
        stats = None
        if self.engine is not None:
            cluster = getattr(self.engine, "cluster", None)
            if cluster is not None:
                stats = cluster.overload_stats()
        if not stats:
            self._shed_last = None
            self.shed_rate = 0.0
            return
        shed = int(stats.get("shedRequests", 0))
        admitted = int(stats.get("admittedRequests", 0))
        last, self._shed_last = self._shed_last, (shed, admitted)
        if last is None or shed < last[0] or admitted < last[1]:
            self.shed_rate = 0.0  # first read / server restarted
            return
        shed_d = shed - last[0]
        adm_d = admitted - last[1]
        self.shed_rate = (shed_d / float(shed_d + adm_d)
                          if shed_d + adm_d > 0 else 0.0)

    # -- alert state machine -----------------------------------------------

    def external_transition(self, key: str, firing: bool, now_ms: int,
                            fields: Dict) -> None:
        """Public fire/refresh/resolve seam for sibling evaluators (the
        waterfall regression sentry): alerts they judge land in
        the SAME store, transition log, journal mirror, and webhook as
        burn-rate rules — a wire-path budget breach pages exactly like an
        availability breach. ``fields`` must carry the burn-alert keys
        the read surfaces index (``key``/``kind``/``severity``/
        ``resource``)."""
        with self._lock:
            self._transition(key, firing, int(now_ms), fields)

    def _transition(self, key: str, firing: bool, now_ms: int,
                    fields: Dict) -> None:
        """Caller holds the lock. Fire/refresh/resolve one alert key;
        transitions append to the bounded event log and fan out."""
        active = self._active.get(key)
        if firing:
            if active is None:
                alert = dict(fields, sinceMs=now_ms, lastMs=now_ms)
                self._active[key] = alert
                self.fired_count += 1
                self._emit("fired", alert, now_ms)
            else:
                active.update(fields)
                active["lastMs"] = now_ms
        elif active is not None:
            del self._active[key]
            self.resolved_count += 1
            resolved = dict(active, resolvedMs=now_ms)
            self._emit("resolved", resolved, now_ms)

    def _emit(self, kind: str, alert: Dict, now_ms: int) -> None:
        self._seq += 1
        event = {"seq": self._seq, "type": kind, "timestamp": now_ms,
                 "alert": dict(alert)}
        self._events.append(event)
        if self.journal is not None:
            # A resolve is CAUSED by its fire: the back-pointer lets the
            # why-query's chain walk show an alert's full arc.
            key = alert.get("key")
            cause = self._fired_jseq.get(key) if kind == "resolved" else None
            jseq = self.journal.record("sloTransition", cause_seq=cause,
                                       event=dict(event))
            if kind == "fired":
                self._fired_jseq[key] = jseq
            else:
                self._fired_jseq.pop(key, None)
        if self.webhook.enabled:
            from sentinel_tpu_torch.core.config import config as _cfg

            self.webhook.submit(dict(event, source=_cfg.app_name()))

    # -- read surfaces ------------------------------------------------------

    def alerts_snapshot(self, since_seq: int = 0,
                        resource: Optional[str] = None,
                        limit: Optional[int] = None) -> Dict:
        """Active alerts + the transition log after ``since_seq`` (the
        SSE pump's cursor; 0 = everything retained)."""
        with self._lock:
            active = [dict(a) for a in self._active.values()]
            events = [e for e in self._events if e["seq"] > since_seq]
            if resource is not None:
                active = [a for a in active if a["resource"] == resource]
                events = [e for e in events
                          if e["alert"]["resource"] == resource]
            if limit is not None and limit >= 0:
                # events[-0:] would be the WHOLE list — limit=0 means
                # "no transitions, just the active set and counters"
                # (the exporter's cheap read).
                events = events[-limit:] if limit > 0 else []
            return {
                "active": active,
                "events": events,
                "nextSeq": self._seq,
                "counters": {
                    "fired": self.fired_count,
                    "resolved": self.resolved_count,
                },
                "webhook": self.webhook.stats(),
                "health": self.health_scores(),
            }

    def status(self) -> Dict:
        """The ``slo`` command's view: objectives, burn snapshots,
        baselines, health."""
        from sentinel_tpu_torch.datasource.converters import slo_objective_to_dict

        with self._lock:
            return {
                "objectives": [slo_objective_to_dict(o)
                               for o in self._objectives.values()],
                "burn": {k: dict(v) for k, v in self._burn.items()},
                "baselines": {
                    res: {sig: bl.snapshot() for sig, bl in bls.items()}
                    for res, bls in sorted(self._baselines.items())
                },
                "health": self.health_scores(),
                "evaluatedThroughMs": self._eval_end_ms,
                "activeAlerts": len(self._active),
                "rolloutAbortEnabled": self.rollout_abort_enabled,
            }

    def health_scores(self) -> Dict:
        """Composite 0-100 health per resource and per instance.

        Resource: 100 minus a penalty per active alert on it (page 40,
        ticket 20, anomaly 15), floored at 0. Instance: the worst
        resource score minus an overload penalty proportional to the
        batcher's recent shed fraction (capped at 50), floored at 0."""
        with self._lock:
            resources: Dict[str, int] = {}
            for o in self._objectives.values():
                resources.setdefault(o.resource, 100)
            for res in self._baselines:
                resources.setdefault(res, 100)
            for alert in self._active.values():
                res = alert["resource"]
                pen = PENALTY.get(alert["severity"], PENALTY["anomaly"])
                resources[res] = max(0, resources.get(res, 100) - pen)
            shed_penalty = min(SHED_PENALTY_CAP,
                               int(round(100 * self.shed_rate)))
            worst = min(resources.values(), default=100)
            return {
                "resources": resources,
                "instance": max(0, worst - shed_penalty),
                "shedRate": round(self.shed_rate, 6),
                "shedPenalty": shed_penalty,
            }

    def abort_signal(self, resources: Optional[Set[str]] = None) -> List[Dict]:
        """Active PAGE-severity burn alerts (optionally restricted to a
        resource set) — the rollout guardrail's additional auto-abort
        input. Anomaly alerts deliberately do not vote: a candidate
        ruleset CHANGES behavior, which is exactly what a self-baseline
        flags."""
        with self._lock:
            return [dict(a) for a in self._active.values()
                    if a["kind"] == "burn_rate"
                    and a["severity"] == SEVERITY_PAGE
                    and (resources is None or a["resource"] in resources)]

    def active_alerts_on(self, resources: Set[str]) -> List[Dict]:
        """EVERY active alert (any kind, any severity) touching the
        given resources — the adaptive loop's proposal gate. Unlike
        :meth:`abort_signal`, anomalies DO vote here: a proposal has no
        canary blast shield yet, so any sign the resource is behaving
        unusually is reason enough not to start retuning it."""
        with self._lock:
            return [dict(a) for a in self._active.values()
                    if a["resource"] in resources]

    def reset_timebase(self) -> None:
        """Forget every stamp-bearing cursor and series (the engine's
        ``set_clock`` seam): ingest/eval cursors, objective series,
        baselines, burn snapshots, and active alerts all carry absolute
        stamps of the OLD timebase — after a backward swap the ingest
        cursor would silently drop every new second as "already seen"
        and judgement would go dead with no error. Objectives and the
        seq-numbered transition LOG survive (config and history are not
        statistics); active alerts clear without transitions — their
        fire stamps belong to a timebase that no longer exists."""
        with self._lock:
            self._last_ingest_ms = -1
            self._eval_end_ms = -1
            self._series = {k: deque() for k in self._objectives}
            self._baselines.clear()
            self._burn.clear()
            self._active.clear()
            self._shed_end_ms = -1
            self._shed_last = None

    def stop(self) -> None:
        self.webhook.stop()

    def _now_ms(self) -> int:
        # Ride the owning engine's timebase (the clock-injection seam) so
        # in-sim judgement stamps with simulated time; an engine-less
        # manager (unit tests) keeps the process clock.
        engine = self.engine
        if engine is not None:
            return engine.now_ms()
        from sentinel_tpu_torch.utils import time_util

        return time_util.current_time_millis()


def _window_sums(series, end_ms: int, window_s: int) -> Tuple[int, int]:
    """Exact (bad, total) over stamps in [end - window_s*1000, end).
    The deque holds only retained traffic seconds; idle seconds are
    implicit zeros."""
    floor = end_ms - window_s * 1000
    bad = total = 0
    for stamp, b, t in reversed(series):
        if stamp < floor:
            break
        if stamp < end_ms:
            bad += b
            total += t
    return bad, total


def _burn(bad: int, total: int, budget: float) -> float:
    if total <= 0:
        return 0.0
    return (bad / float(total)) / budget
