"""Wire-to-device latency waterfall (port of
``sentinel_tpu/telemetry/waterfall.py``).

Every admitted wire request carries a compact stage-stamp record —
``perf_counter`` marks taken at seams that already exist in the reactor,
the batcher, and the pipeline — and the deltas land here as one
8-stage budget per request:

========  ==============================================================
stage     interval
========  ==============================================================
read      socket readable -> frame parsed + staged (reactor thread)
coalesce  staged -> coalesced submit into the batcher queue
queue     submit -> batcher drain (``_Batcher._run``'s ``queue.get``)
dispatch  drain -> device dispatch (linger + flatten + pad + enqueue)
device    dispatch -> harvest materialization (device wall, amortized)
harvest   harvest -> reply slot filled + encoded (``_resolve``)
reply     slot filled -> flush picks the slot (head-of-line wait)
flush     flush pick -> reply bytes handed to the socket layer
========  ==============================================================

The eight deltas chain: their sum is EXACTLY the request's arrival ->
flush RTT (no gaps, no overlaps), which is the reconciliation invariant
the ``waterfall`` command reports. The pipeline lane (``queue`` /
``device`` from :meth:`Pipeline wait split <record_pipeline>`) rides the
same geometry so wire and in-process stages share one histogram family.

Fold cadence: observations accumulate into per-second staging cells
stamped with the ENGINE timebase (``engine.now_ms()`` — inert under
injected clocks) and are sealed once per second by
``roll(now)`` riding the flight recorder's ``_spill_flight`` fold —
zero new per-step device work, zero background threads. ``perf_counter``
appears in this module ONLY as a duration/speed source (deltas, probe
windows), never as a timestamp; ``tests/test_torch_waterfall.py`` pins
that.

Exactness contract (docs/SEMANTICS.md): sealed per-second stage
histograms and sums are EXACT over the requests whose flush landed in
that second. Exemplars are SAMPLED (top-of-histogram outliers plus an
every-Nth cadence among traced requests) — forensic pointers, not
statistics.

The :class:`RegressionSentry` turns committed per-stage budgets (the
reference's, derived from its saturated loopback capture) into burn-rate alerts through the SLO
machinery's own window pairs: a wire-path regression pages exactly like
an availability breach.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.telemetry.attribution import (
    NUM_WF_BUCKETS,
    WF_BUCKET_EDGES_MS,
    bucket_index_of,
    histogram_quantile_edges,
)

WIRE_STAGES: Tuple[str, ...] = (
    "read", "coalesce", "queue", "dispatch", "device", "harvest", "reply",
    "flush")
PIPELINE_STAGES: Tuple[str, ...] = ("queue", "device")
LANE_STAGES: Dict[str, Tuple[str, ...]] = {
    "wire": WIRE_STAGES,
    "pipeline": PIPELINE_STAGES,
}

# Exemplars retained per second (the slowest traced requests win).
_EXEMPLARS_PER_SECOND = 4

# Allowed over-budget fraction per stage: the sentry's objective is
# "99% of requests inside the stage budget", so burn 1.0 == 1% breaching.
SENTRY_ALLOWED_BREACH = 0.01

# Committed per-stage budgets in ms, the reference's (its saturated
# loopback capture: each stage's p99 rounded up to the next log2 edge,
# then one extra doubling on the stages that breathe with host load).
# They are not re-derived for the H100 host.
DEFAULT_STAGE_BUDGETS_MS: Dict[str, float] = {
    "wire.queue": 16.0,
    "wire.dispatch": 16.0,
    "wire.device": 32.0,
    "wire.reply": 64.0,
}

_LOG2_LO = -6  # WF_BUCKET_EDGES_MS[0] == 2^-6


def _fast_bucket(value_ms: float) -> int:
    """O(1) log2 bucket index (``le`` semantics, +Inf overflow). The
    differential test pins this against the linear-scan oracle in
    :mod:`~sentinel_tpu_torch.telemetry.attribution`."""
    if value_ms <= WF_BUCKET_EDGES_MS[0]:
        return 0
    b = max(0, int(math.ceil(math.log2(value_ms))) - _LOG2_LO)
    # Float fuzz at an exact edge can land one bucket high/low; settle
    # against the real edges (at most one step either way).
    if b >= NUM_WF_BUCKETS - 1:
        return NUM_WF_BUCKETS - 1
    if b > 0 and value_ms <= WF_BUCKET_EDGES_MS[b - 1]:
        return b - 1
    if value_ms > WF_BUCKET_EDGES_MS[b]:
        return b + 1 if b + 1 < NUM_WF_BUCKETS else NUM_WF_BUCKETS - 1
    return b


class _SecondAcc:
    """One staged (not yet sealed) second of observations."""

    __slots__ = ("counts", "sums", "rtt_counts", "rtt_sum", "busy_ms",
                 "batches", "batch_requests", "exemplars", "max_total")

    def __init__(self) -> None:
        self.counts: Dict[str, List[List[int]]] = {}
        self.sums: Dict[str, List[float]] = {}
        self.rtt_counts: List[int] = [0] * NUM_WF_BUCKETS
        self.rtt_sum = 0.0
        self.busy_ms = 0.0
        self.batches = 0
        self.batch_requests = 0
        # [(total_ms, trace_id, bucket)] — bounded, slowest retained.
        self.exemplars: List[Tuple[float, str, int]] = []
        self.max_total = 0.0

    def lane(self, name: str) -> Tuple[List[List[int]], List[float]]:
        counts = self.counts.get(name)
        if counts is None:
            n = len(LANE_STAGES[name])
            counts = self.counts[name] = [
                [0] * NUM_WF_BUCKETS for _ in range(n)]
            self.sums[name] = [0.0] * n
        return counts, self.sums[name]


class WaterfallRecorder:
    """Per-second per-stage latency histograms + exemplars + sentry.

    One rides each engine (``engine.waterfall``); engine-less instances
    (unit tests, oracles) inject ``now_ms`` — with neither, timestamps
    ride a ``perf_counter``-derived millisecond counter so the module
    never reads the wall clock.
    """

    def __init__(self, engine=None, now_ms: Optional[Callable[[], int]] = None,
                 transition: Optional[Callable] = None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self._engine = engine
        if engine is not None:
            self._now_ms: Callable[[], int] = engine.now_ms
        elif now_ms is not None:
            self._now_ms = now_ms
        else:
            self._now_ms = lambda: int(time.perf_counter() * 1000)
        self.enabled = _cfg.waterfall_enabled()
        self.exemplar_every = _cfg.waterfall_exemplar_every()
        self._lock = threading.Lock()
        self._staged: Dict[int, _SecondAcc] = {}
        self._sealed: Deque[Dict] = deque(
            maxlen=max(1, _cfg.waterfall_history_seconds()))
        self._sealed_floor = -1
        # Cumulative (since construction / timebase reset survives):
        self._cum_counts: Dict[str, List[List[int]]] = {
            lane: [[0] * NUM_WF_BUCKETS for _ in stages]
            for lane, stages in LANE_STAGES.items()}
        self._cum_sums: Dict[str, List[float]] = {
            lane: [0.0] * len(stages)
            for lane, stages in LANE_STAGES.items()}
        self._cum_rtt: List[int] = [0] * NUM_WF_BUCKETS
        self._cum_rtt_sum = 0.0
        # rtt bucket -> latest exemplar {"traceId","valueMs","timestampMs"}.
        self._rtt_exemplars: Dict[int, Dict] = {}
        self._n_traced = 0
        self.sealed_seconds = 0
        self.late_drops = 0
        self.observed_requests = 0
        self.exemplars_captured = 0
        self.sentry = RegressionSentry(self, engine=engine,
                                       transition=transition)

    # -- write side (hot paths) ---------------------------------------------

    def observe_wire(self, durations_ms: Sequence[float],
                     trace_id: Optional[str] = None) -> None:
        """One admitted wire request's eight stage deltas (ms), in
        :data:`WIRE_STAGES` order. Their sum is the request RTT."""
        if not self.enabled:
            return
        sec = self._now_ms() // 1000 * 1000
        total = 0.0
        with self._lock:
            if sec <= self._sealed_floor - 1000:
                self.late_drops += 1
                return
            acc = self._staged.get(sec)
            if acc is None:
                acc = self._staged[sec] = _SecondAcc()
            counts, sums = acc.lane("wire")
            for i, d in enumerate(durations_ms):
                d = d if d > 0.0 else 0.0
                counts[i][_fast_bucket(d)] += 1
                sums[i] += d
                total += d
            acc.rtt_counts[_fast_bucket(total)] += 1
            acc.rtt_sum += total
            self.observed_requests += 1
            if trace_id:
                self._n_traced += 1
                if (total >= acc.max_total
                        or self._n_traced % self.exemplar_every == 0):
                    acc.max_total = max(acc.max_total, total)
                    ex = acc.exemplars
                    ex.append((total, trace_id, _fast_bucket(total)))
                    if len(ex) > _EXEMPLARS_PER_SECOND:
                        ex.remove(min(ex, key=lambda e: e[0]))

    def observe_pipeline(self, queue_wait_ms: float,
                         device_wait_ms: float) -> None:
        """One pipeline harvest's queue/device wait split (ms)."""
        if not self.enabled:
            return
        sec = self._now_ms() // 1000 * 1000
        with self._lock:
            if sec <= self._sealed_floor - 1000:
                self.late_drops += 1
                return
            acc = self._staged.get(sec)
            if acc is None:
                acc = self._staged[sec] = _SecondAcc()
            counts, sums = acc.lane("pipeline")
            for i, d in enumerate((queue_wait_ms, device_wait_ms)):
                d = d if d > 0.0 else 0.0
                counts[i][_fast_bucket(d)] += 1
                sums[i] += d

    def observe_batch(self, device_busy_ms: float, n_requests: int) -> None:
        """One fused device batch: device wall (ms) + coalesced width —
        the utilization / coalesce-efficiency denominators."""
        if not self.enabled:
            return
        sec = self._now_ms() // 1000 * 1000
        with self._lock:
            acc = self._staged.get(sec)
            if acc is None:
                acc = self._staged[sec] = _SecondAcc()
            acc.busy_ms += device_busy_ms if device_busy_ms > 0.0 else 0.0
            acc.batches += 1
            acc.batch_requests += int(n_requests)

    # -- fold (rides _spill_flight) -----------------------------------------

    def roll(self, now_ms: int) -> None:
        """Seal every staged second strictly before the current one.
        Idempotent; host arithmetic only. Sentry evaluation rides the
        same call, outside the recorder lock."""
        cur = int(now_ms) - int(now_ms) % 1000
        new_recs: List[Dict] = []
        with self._lock:
            for sec in sorted(s for s in self._staged if s < cur):
                rec = self._seal(sec, self._staged.pop(sec))
                self._sealed.append(rec)
                self.sealed_seconds += 1
                new_recs.append(rec)
            if new_recs:
                self._sealed_floor = max(self._sealed_floor, cur)
        for rec in new_recs:
            self.sentry.ingest(rec)
        self.sentry.evaluate(now_ms)

    def _seal(self, sec: int, acc: _SecondAcc) -> Dict:
        # Caller holds the lock.
        lanes: Dict[str, Dict] = {}
        for lane, counts in acc.counts.items():
            sums = acc.sums[lane]
            cum_c, cum_s = self._cum_counts[lane], self._cum_sums[lane]
            stages: Dict[str, Dict] = {}
            for i, name in enumerate(LANE_STAGES[lane]):
                row, s = counts[i], sums[i]
                n = sum(row)
                for b in range(NUM_WF_BUCKETS):
                    cum_c[i][b] += row[b]
                cum_s[i] += s
                stages[name] = {
                    "count": n,
                    "sumMs": round(s, 4),
                    "p50Ms": round(histogram_quantile_edges(
                        row, 0.5, WF_BUCKET_EDGES_MS), 4),
                    "p99Ms": round(histogram_quantile_edges(
                        row, 0.99, WF_BUCKET_EDGES_MS), 4),
                    # Little's law at a 1s window: L = (sum of time
                    # spent in stage) / window — inferred concurrency.
                    "concurrency": round(s / 1000.0, 4),
                    "buckets": list(row),
                }
            lanes[lane] = stages
        for b in range(NUM_WF_BUCKETS):
            self._cum_rtt[b] += acc.rtt_counts[b]
        self._cum_rtt_sum += acc.rtt_sum
        exemplars = []
        # Ascending, so within one second the SLOWEST same-bucket
        # exemplar is the one the cumulative per-bucket map retains.
        for total, trace_id, bucket in sorted(acc.exemplars):
            ex = {"traceId": trace_id, "valueMs": round(total, 4),
                  "bucket": bucket, "timestampMs": sec}
            exemplars.append(ex)
            self._rtt_exemplars[bucket] = ex
            self.exemplars_captured += 1
        exemplars.reverse()  # slowest first for display
        n_rtt = sum(acc.rtt_counts)
        return {
            "timestamp": sec,
            "lanes": lanes,
            "rtt": {
                "count": n_rtt,
                "sumMs": round(acc.rtt_sum, 4),
                "p50Ms": round(histogram_quantile_edges(
                    acc.rtt_counts, 0.5, WF_BUCKET_EDGES_MS), 4),
                "p99Ms": round(histogram_quantile_edges(
                    acc.rtt_counts, 0.99, WF_BUCKET_EDGES_MS), 4),
                "buckets": list(acc.rtt_counts),
            },
            "coalesce": {
                "batches": acc.batches,
                "requests": acc.batch_requests,
                "efficiency": round(acc.batch_requests / acc.batches, 4)
                if acc.batches else 0.0,
            },
            "deviceUtilization": round(min(1.0, acc.busy_ms / 1000.0), 4),
            "exemplars": exemplars,
        }

    def reset_timebase(self) -> None:
        """The engine's ``set_clock`` seam: staged cells, history, and
        cursors carry absolute stamps of the OLD timebase — drop them so
        in-sim seconds start clean (cumulative totals survive: they are
        counters, not stamps)."""
        with self._lock:
            self._staged.clear()
            self._sealed.clear()
            self._sealed_floor = -1
        self.sentry.reset_timebase()

    # -- read surfaces ------------------------------------------------------

    def snapshot(self, limit: int = 60) -> Dict:
        """The ``waterfall`` command / dashboard view."""
        with self._lock:
            recent = list(self._sealed)[-max(0, int(limit)):]
            cumulative: Dict[str, Dict] = {}
            wire_stage_total = 0.0
            for lane, stages in LANE_STAGES.items():
                out: Dict[str, Dict] = {}
                for i, name in enumerate(stages):
                    row = self._cum_counts[lane][i]
                    s = self._cum_sums[lane][i]
                    if lane == "wire":
                        wire_stage_total += s
                    out[name] = {
                        "count": sum(row),
                        "sumMs": round(s, 4),
                        "p50Ms": round(histogram_quantile_edges(
                            row, 0.5, WF_BUCKET_EDGES_MS), 4),
                        "p99Ms": round(histogram_quantile_edges(
                            row, 0.99, WF_BUCKET_EDGES_MS), 4),
                    }
                cumulative[lane] = out
            rtt_sum = self._cum_rtt_sum
            snap = {
                "enabled": self.enabled,
                "stages": {k: list(v) for k, v in LANE_STAGES.items()},
                "edgesMs": list(WF_BUCKET_EDGES_MS),
                "sealedSeconds": self.sealed_seconds,
                "stagedSeconds": len(self._staged),
                "observedRequests": self.observed_requests,
                "lateDrops": self.late_drops,
                "exemplarsCaptured": self.exemplars_captured,
                "cumulative": cumulative,
                "rtt": {
                    "count": sum(self._cum_rtt),
                    "sumMs": round(rtt_sum, 4),
                    "p50Ms": round(histogram_quantile_edges(
                        self._cum_rtt, 0.5, WF_BUCKET_EDGES_MS), 4),
                    "p99Ms": round(histogram_quantile_edges(
                        self._cum_rtt, 0.99, WF_BUCKET_EDGES_MS), 4),
                },
                # The exactness invariant: the eight wire stages chain,
                # so their summed time equals the summed RTT (both over
                # SEALED seconds only; staged cells are excluded from
                # both sides, so the delta is float fuzz, not sampling).
                "reconciliation": {
                    "wireStageSumMs": round(wire_stage_total, 4),
                    "rttSumMs": round(rtt_sum, 4),
                    "relativeError": round(
                        abs(wire_stage_total - rtt_sum) / rtt_sum, 9)
                    if rtt_sum > 0 else 0.0,
                },
                "exemplars": [dict(self._rtt_exemplars[b])
                              for b in sorted(self._rtt_exemplars)],
                "recent": recent,
            }
        snap["sentry"] = self.sentry.snapshot()
        return snap

    def export_state(self) -> Dict:
        """The OpenMetrics exporter's read: cumulative histograms +
        per-bucket exemplars + last sealed second's derived gauges."""
        with self._lock:
            hist = {
                lane: {
                    name: (list(self._cum_counts[lane][i]),
                           self._cum_sums[lane][i])
                    for i, name in enumerate(stages)}
                for lane, stages in LANE_STAGES.items()}
            last = self._sealed[-1] if self._sealed else None
            return {
                "hist": hist,
                "rtt": (list(self._cum_rtt), self._cum_rtt_sum),
                "rttExemplars": {b: dict(ex)
                                 for b, ex in self._rtt_exemplars.items()},
                "last": last,
                "sealedSeconds": self.sealed_seconds,
                "exemplarsCaptured": self.exemplars_captured,
                "budgetsMs": dict(self.sentry.budgets),
            }


class RegressionSentry:
    """Committed per-stage budgets judged by the SLO burn-window pairs.

    Each sealed second contributes one (bad, total) sample per budgeted
    stage — ``bad`` counted EXACTLY from the sealed histogram with the
    budget snapped UP to its log2 edge (same convention as
    ``snap_latency_ms``). Alerts land through
    :meth:`SloManager.external_transition`, so a wire-path regression
    shares the availability machinery's store, journal, and webhook.
    """

    def __init__(self, recorder: WaterfallRecorder, engine=None,
                 transition: Optional[Callable] = None):
        from sentinel_tpu_torch.core.config import config as _cfg
        from sentinel_tpu_torch.slo.objectives import DEFAULT_BURN_WINDOWS

        self._recorder = recorder
        self._engine = engine
        self._transition = transition
        self.enabled = _cfg.waterfall_sentry_enabled()
        self.min_events = _cfg.waterfall_sentry_min_events()
        self.windows = DEFAULT_BURN_WINDOWS
        self.budgets: Dict[str, float] = dict(DEFAULT_STAGE_BUDGETS_MS)
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[Tuple[int, int, int]]] = {}
        self._retain_ms = (max(w.long_s for w in self.windows) + 60) * 1000
        self._eval_end = -1
        self._burn: Dict[str, List[Dict]] = {}

    def _sink(self) -> Optional[Callable]:
        if self._transition is not None:
            return self._transition
        slo = getattr(self._engine, "slo", None) \
            if self._engine is not None else None
        return slo.external_transition if slo is not None else None

    def set_budgets(self, budgets: Dict[str, float]) -> Dict[str, float]:
        """Merge operator overrides (``{"lane.stage": ms}``); a budget
        <= 0 removes the key. Unknown stages are rejected. Removing a
        budget resolves any alert it fired — ``evaluate`` stops
        iterating the key, so without an explicit resolve here a fired
        alert would sit active in the SLO store forever."""
        resolves = []
        with self._lock:
            for key, val in budgets.items():
                lane, _, stage = str(key).partition(".")
                if stage not in LANE_STAGES.get(lane, ()):
                    raise ValueError(f"unknown waterfall stage: {key!r}")
                val = float(val)
                if val <= 0:
                    removed = self.budgets.pop(key, None)
                    self._series.pop(key, None)
                    self._burn.pop(key, None)
                    if removed is not None:
                        resolves.extend(
                            f"waterfall:{key}:{w.long_s}s/{w.short_s}s"
                            f":{w.severity}" for w in self.windows)
                else:
                    self.budgets[key] = val
            out = dict(self.budgets)
            end = max(self._eval_end, 0)
        sink = self._sink()
        if sink is not None:
            for rule_key in resolves:
                sink(rule_key, False, end, {"key": rule_key,
                                            "kind": "waterfall_budget"})
        return out

    def ingest(self, rec: Dict) -> None:
        if not self.enabled:
            return
        stamp = rec["timestamp"]
        with self._lock:
            for key, budget in self.budgets.items():
                lane, _, stage = key.partition(".")
                cell = rec["lanes"].get(lane, {}).get(stage)
                if not cell or not cell["count"]:
                    continue
                buckets = cell["buckets"]
                edge_b = bucket_index_of(budget)
                good = sum(buckets[:edge_b + 1])
                total = cell["count"]
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = deque()
                series.append((stamp, total - good, total))
                floor = stamp - self._retain_ms
                while series and series[0][0] < floor:
                    series.popleft()

    def evaluate(self, now_ms: int) -> None:
        if not self.enabled:
            return
        sink = self._sink()
        if sink is None:
            return
        from sentinel_tpu_torch.slo.manager import _burn, _window_sums

        end = int(now_ms) - int(now_ms) % 1000
        transitions = []
        with self._lock:
            if end < self._eval_end:
                return
            self._eval_end = end
            for key, budget in self.budgets.items():
                series = self._series.get(key)
                if series is None:
                    continue
                rules_out = []
                for w in self.windows:
                    bad_l, tot_l = _window_sums(series, end, w.long_s)
                    bad_s, tot_s = _window_sums(series, end, w.short_s)
                    burn_l = _burn(bad_l, tot_l, SENTRY_ALLOWED_BREACH)
                    burn_s = _burn(bad_s, tot_s, SENTRY_ALLOWED_BREACH)
                    firing = (tot_l >= self.min_events
                              and burn_l >= w.burn and burn_s >= w.burn)
                    rule_key = (f"waterfall:{key}:{w.long_s}s/{w.short_s}s"
                                f":{w.severity}")
                    rules_out.append({
                        "window": f"{w.long_s}s/{w.short_s}s",
                        "severity": w.severity,
                        "burnLong": round(burn_l, 4),
                        "burnShort": round(burn_s, 4),
                        "events": tot_l,
                        "firing": firing,
                    })
                    transitions.append((rule_key, firing, {
                        "key": rule_key,
                        "kind": "waterfall_budget",
                        "severity": w.severity,
                        "resource": f"waterfall:{key}",
                        "stage": key,
                        "budgetMs": budget,
                        "burnLong": round(burn_l, 4),
                        "burnShort": round(burn_s, 4),
                        "windowLongS": w.long_s,
                        "windowShortS": w.short_s,
                        "allowedBreachFraction": SENTRY_ALLOWED_BREACH,
                    }))
                self._burn[key] = rules_out
        for rule_key, firing, fields in transitions:
            sink(rule_key, firing, end, fields)

    def reset_timebase(self) -> None:
        with self._lock:
            self._series.clear()
            self._burn.clear()
            self._eval_end = -1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "minEvents": self.min_events,
                "allowedBreachFraction": SENTRY_ALLOWED_BREACH,
                "budgetsMs": dict(self.budgets),
                "burn": {k: [dict(r) for r in v]
                         for k, v in self._burn.items()},
            }


# ---------------------------------------------------------------------------
# Saturation probe: drive the in-process loopback mesh across a
# (pipeline depth x connection count) grid and record the acquires/s
# curve. perf_counter is used for window timing only (speed, not
# timestamps).
# ---------------------------------------------------------------------------

def saturation_probe(depths: Sequence[int] = (1, 2, 4),
                     conns_grid: Sequence[int] = (2, 8, 32),
                     window_s: float = 2.0,
                     settle_s: float = 1.0,
                     burst: int = 64,
                     n_flows: int = 32,
                     max_cells: int = 16,
                     device=None) -> Dict:
    """Measure acquires/s per (inflight depth, connection count) cell on
    a fresh loopback :class:`ClusterTokenServer` per depth, its token
    service on ``device`` (None: the card, or raise). Returns the raw
    grid plus, per depth, the peak rate and the FIRST connection count
    reaching >= 90% of it (the saturation knee)."""
    import socket as _socket

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.cluster import codec
    from sentinel_tpu_torch.cluster.constants import MSG_FLOW
    from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    grid = [(d, c) for d in depths for c in conns_grid][:max(1, max_cells)]
    cells: List[Dict] = []
    for depth in sorted({d for d, _ in grid}):
        rules = ClusterFlowRuleManager()
        rules.load_rules("default", [
            st.FlowRule(resource=f"wf{i}", count=1e9, cluster_mode=True,
                        cluster_config={"flowId": 6000 + i,
                                        "thresholdType": 1})
            for i in range(n_flows)
        ])
        svc = DefaultTokenService(rules, max_allowed_qps=1e12,
                                  device=device)
        for w in (burst, 256, 1024, 4096):  # warm each coalesce width
            svc.request_tokens([(6000, 1, False)] * w)
        server = ClusterTokenServer(svc, host="127.0.0.1", port=0)
        server.batcher.inflight_depth = depth
        server.start()
        try:
            for d, n_conns in grid:
                if d != depth:
                    continue
                rate = _drive_cell(_socket, codec, MSG_FLOW,
                                   server.bound_port, n_conns, burst,
                                   n_flows, window_s, settle_s)
                cells.append({"depth": depth, "connections": n_conns,
                              "acquiresPerSec": round(rate, 1)})
        finally:
            server.stop()
    per_depth: Dict[str, Dict] = {}
    for depth in sorted({d for d, _ in grid}):
        row = [c for c in cells if c["depth"] == depth]
        peak = max((c["acquiresPerSec"] for c in row), default=0.0)
        knee = next((c["connections"] for c in row
                     if peak > 0 and c["acquiresPerSec"] >= 0.9 * peak), 0)
        per_depth[str(depth)] = {"peakAcquiresPerSec": peak,
                                 "saturationConnections": knee}
    return {"grid": cells, "perDepth": per_depth,
            "pipelinedPerConn": burst, "windowS": window_s}


def _drive_cell(_socket, codec, msg_flow: int, port: int, n_conns: int,
                burst: int, n_flows: int, window_s: float,
                settle_s: float) -> float:
    """One probe cell: ``n_conns`` pipelined TLV connections, each
    keeping ``burst`` requests in flight; returns replies/s over the
    measurement window (frames pre-encoded — server cost only)."""
    n_threads = min(8, n_conns)
    stop = threading.Event()
    replies = [0] * n_threads
    barrier = threading.Barrier(n_threads + 1)
    per_thread = [n_conns // n_threads + (1 if t < n_conns % n_threads else 0)
                  for t in range(n_threads)]

    def worker(tid: int) -> None:
        conns = []
        try:
            for _ in range(per_thread[tid]):
                s = _socket.create_connection(("127.0.0.1", port), timeout=10)
                s.settimeout(10)
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                conns.append((s, codec.FrameReader()))
            frames = b"".join(
                codec.encode_request(
                    xid + 1, msg_flow,
                    codec.encode_flow_request(
                        6000 + (tid + xid) % n_flows, 1, False))
                for xid in range(burst))
            barrier.wait()
            while not stop.is_set():
                for s, _ in conns:
                    s.sendall(frames)
                for s, reader in conns:
                    got = 0
                    while got < burst:
                        data = s.recv(65536)
                        if not data:
                            return
                        for body in reader.feed(data):
                            codec.decode_response(body)
                            got += 1
                            replies[tid] += 1
        except (OSError, threading.BrokenBarrierError):
            pass
        finally:
            for s, _ in conns:
                try:
                    s.close()
                except OSError:
                    pass

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(n_threads)]
    for t in threads:
        t.start()
    try:
        barrier.wait(timeout=30)
    except threading.BrokenBarrierError:
        stop.set()
        return 0.0
    time.sleep(max(0.0, settle_s))
    base = sum(replies)
    t0 = time.perf_counter()
    time.sleep(max(0.1, window_s))
    dt = time.perf_counter() - t0
    got = sum(replies) - base
    stop.set()
    for t in threads:
        t.join(timeout=15)
    return got / dt if dt > 0 else 0.0
