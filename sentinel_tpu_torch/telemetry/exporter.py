"""Render one engine's full telemetry as OpenMetrics text (port of
``sentinel_tpu/telemetry/exporter.py``).

Everything an operator would otherwise collect from four surfaces (the
metric log files, the ``resilience`` / ``rollout`` / ``profile`` JSON
ops commands) plus the device-resident attribution counters and RT
histograms, under stable ``sentinel_tpu_*`` names any Prometheus scraper
ingests: the same names and the same bytes as the JAX package's exporter
for the same engine state. Served by the ``metrics`` command (``GET
/metrics`` on the command center); the ``telemetry`` command is the
JSON-parity view of the same numbers.

Per-resource series cover ClusterNode rows with any recorded traffic
(cardinality = active resources, the same set the metric log writes).
The render reads the engine's counters to the host: on the card that is
a device-to-host copy of the telemetry tensors under the engine lock.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.telemetry.attribution import (
    ATTR_REASON_NAMES,
    RT_BUCKET_EDGES_MS,
    SLOT_BIN_LABELS,
)
from sentinel_tpu_torch.telemetry.openmetrics import OpenMetricsBuilder

_EVENT_FAMILIES = (
    # (family name, MetricEvent, help)
    ("sentinel_tpu_pass", C.MetricEvent.PASS,
     "Admitted entries per resource since engine start"),
    ("sentinel_tpu_block", C.MetricEvent.BLOCK,
     "Blocked entries per resource since engine start"),
    ("sentinel_tpu_success", C.MetricEvent.SUCCESS,
     "Successful completions per resource since engine start"),
    ("sentinel_tpu_exception", C.MetricEvent.EXCEPTION,
     "Business-exception completions per resource since engine start"),
)


def _active_rows(engine, counts: Dict[str, np.ndarray]) -> Dict[str, int]:
    """resource -> ClusterNode row, for rows with any telemetry signal."""
    from sentinel_tpu_torch.core.registry import KIND_CLUSTER

    totals = counts["totals"]
    by_reason = counts["blockByReason"]
    active = (totals.any(axis=0) | by_reason.any(axis=0))
    out: Dict[str, int] = {}
    for row, meta in enumerate(engine._device_metas()):
        if meta.kind == KIND_CLUSTER and row < active.shape[0] \
                and active[row]:
            out[meta.resource] = row
    return out


def render_engine_metrics(engine) -> str:
    counts = engine.telemetry_counts()
    rows = _active_rows(engine, counts)
    totals = counts["totals"]
    by_reason = counts["blockByReason"]
    rt_hist = counts["rtHist"]

    b = OpenMetricsBuilder()

    for name, ev, help_text in _EVENT_FAMILIES:
        b.family(name, "counter", help_text)
        for res, row in rows.items():
            b.sample(name + "_total", {"resource": res},
                     int(totals[int(ev), row]))

    b.family("sentinel_tpu_block_reason", "counter",
             "Blocked entries per (resource, first-blocking rule family) "
             "— device-exact attribution from the fused step")
    for res, row in rows.items():
        for ch, reason in enumerate(ATTR_REASON_NAMES):
            v = int(by_reason[ch, row])
            if v:
                b.sample("sentinel_tpu_block_reason_total",
                         {"resource": res, "reason": reason}, v)

    b.family("sentinel_tpu_block_slot", "counter",
             "Blocked entries per (rule family, first-blocking rule-slot "
             "bin) — engine-global; 'unknown' = remote/pre-decided "
             "verdicts with no local rule identity")
    by_slot = counts["blockBySlot"]
    for ch, reason in enumerate(ATTR_REASON_NAMES):
        for bin_i, label in enumerate(SLOT_BIN_LABELS):
            v = int(by_slot[ch, bin_i])
            if v:
                b.sample("sentinel_tpu_block_slot_total",
                         {"reason": reason, "slot": label}, v)

    b.family("sentinel_tpu_rt_ms", "histogram",
             "Response time of successful completions, device-bucketed "
             "(log2 edges, ms)")
    for res, row in rows.items():
        buckets = rt_hist[:, row]
        if not buckets.any():
            continue
        b.histogram("sentinel_tpu_rt_ms", {"resource": res},
                    [float(e) for e in RT_BUCKET_EDGES_MS],
                    [float(x) for x in buckets],
                    float(totals[int(C.MetricEvent.RT), row]))

    # -- degradation channels (resilience_stats parity) --------------------
    res_stats = engine.resilience_stats()
    b.counter("sentinel_tpu_fail_open",
              "Entries passed unguarded because no verdict could be "
              "produced", res_stats["failOpenCount"])
    b.counter("sentinel_tpu_cluster_fallback",
              "Cluster-mode rule evaluations degraded to the local check",
              res_stats["clusterFallbackCount"])
    b.counter("sentinel_tpu_cluster_budget_exhausted",
              "Entries whose remote-wait deadline budget ran out",
              res_stats["clusterBudgetExhaustedCount"])
    breaker = res_stats.get("tokenClientBreaker")
    b.family("sentinel_tpu_token_client_breaker_state", "gauge",
             "Token client health gate: 0=closed 1=open 2=half-open "
             "(-1: no client)")
    _BRK = {"CLOSED": 0, "OPEN": 1, "HALF_OPEN": 2}
    b.sample("sentinel_tpu_token_client_breaker_state", None,
             _BRK.get((breaker or {}).get("state"), -1))
    b.family("sentinel_tpu_probe_last_success_age_ms", "gauge",
             "Age of each registered health probe's last success")
    for probe, snap in sorted(res_stats.get("probes", {}).items()):
        age = snap.get("lastSuccessAgeMs")
        if age is not None:
            b.sample("sentinel_tpu_probe_last_success_age_ms",
                     {"probe": probe}, age)

    # -- cluster HA (cluster/ha.py) ----------------------------------------
    ha = res_stats.get("clusterHA") or {}
    b.family("sentinel_tpu_cluster_ha_role", "gauge",
             "Cluster role of this instance: -1=not started 0=token "
             "client 1=token server")
    b.sample("sentinel_tpu_cluster_ha_role", None, ha.get("role", -1))
    b.family("sentinel_tpu_cluster_ha_epoch", "gauge",
             "Highest leadership epoch this instance has applied or "
             "observed (0: pre-HA / never clustered)")
    b.sample("sentinel_tpu_cluster_ha_epoch", None, ha.get("epoch", 0))
    b.counter("sentinel_tpu_cluster_ha_failovers",
              "Token-client failovers to a different server in the map "
              "order", ha.get("failoverCount", 0))
    b.counter("sentinel_tpu_cluster_ha_stale_epoch_rejected",
              "Responses rejected by the epoch fence (deposed-leader "
              "replies)", ha.get("staleEpochRejected", 0))
    b.family("sentinel_tpu_cluster_ha_degraded", "gauge",
             "1 while the token client serves per-client-share degraded "
             "verdicts (no leader reachable)")
    b.sample("sentinel_tpu_cluster_ha_degraded", None,
             1 if ha.get("degraded") else 0)
    b.counter("sentinel_tpu_cluster_ha_degraded_seconds",
              "Cumulative seconds spent in degraded-quota mode",
              ha.get("degradedSeconds", 0.0))

    # -- sharded multi-leader cluster (cluster/sharding.py) ----------------
    # One family set for both roles: a LEADER reports slice ownership
    # and per-slice epochs; a routing CLIENT reports the degraded blast
    # radius. Absent (unsharded) instances render zeros so one scrape
    # config fits every role.
    shard = ha.get("shard") or {}
    mgr = ha.get("manager") or {}
    b.family("sentinel_tpu_shard_slices_owned", "gauge",
             "Hash slices this leader currently owns (0: not a sharded "
             "leader)")
    b.sample("sentinel_tpu_shard_slices_owned", None,
             shard.get("slicesOwned", 0))
    b.family("sentinel_tpu_shard_slice_epoch", "gauge",
             "Per-slice leadership epoch of each OWNED slice (the fence "
             "term stamped into that slice's verdicts)")
    for sl, ep in sorted(shard.get("sliceEpochs", {}).items(),
                         key=lambda kv: int(kv[0])):
        b.sample("sentinel_tpu_shard_slice_epoch", {"slice": str(sl)}, ep)
    b.counter("sentinel_tpu_shard_wrong_slice_rejected",
              "Requests answered (server) or observed (client) "
              "WRONG_SLICE: the flow hashed outside the reached "
              "leader's owned slices",
              shard.get("wrongSliceRejected", 0))
    b.counter("sentinel_tpu_shard_handoffs",
              "Slice handoffs this seat completed (donor publishes + "
              "recipient warm-starts through the checkpoint graft)",
              mgr.get("handoffs", 0))
    b.family("sentinel_tpu_shard_degraded_slices", "gauge",
             "Slices currently served from the per-client degraded "
             "share because their owning leader is unreachable")
    b.sample("sentinel_tpu_shard_degraded_slices", None,
             shard.get("degradedSlices", 0))

    # -- frontend overload (bounded ingestion) -----------------------------
    # Server-side families render -1 / nothing while this instance is
    # not a token server, so one scrape config fits every role.
    ov = res_stats.get("overload")
    b.counter("sentinel_tpu_overload_client_shed",
              "Entries whose cluster acquire came back OVERLOADED and "
              "were served via the local lease/fallback path",
              res_stats.get("clusterOverloadCount", 0))
    b.counter("sentinel_tpu_overload_client_responses",
              "OVERLOADED responses the failover token client observed "
              "(each opens a per-target retry-after backoff window)",
              ha.get("overloadedCount", 0))
    b.family("sentinel_tpu_overload_targets_backed_off", "gauge",
             "Token-server targets currently inside an overload-backoff "
             "window")
    b.sample("sentinel_tpu_overload_targets_backed_off", None,
             ha.get("targetsBackedOff", 0))
    b.family("sentinel_tpu_overload_queue_depth", "gauge",
             "Token-server admission queue depth in groups (-1: not a "
             "server)")
    b.sample("sentinel_tpu_overload_queue_depth", None,
             ov["queueDepth"] if ov else -1)
    b.family("sentinel_tpu_overload_queue_limit", "gauge",
             "Configured admission queue bound in groups (-1: not a "
             "server)")
    b.sample("sentinel_tpu_overload_queue_limit", None,
             ov["queueLimitGroups"] if ov else -1)
    b.family("sentinel_tpu_overload_queue_depth_max", "gauge",
             "High-water mark of the admission queue since server start "
             "(-1: not a server)")
    b.sample("sentinel_tpu_overload_queue_depth_max", None,
             ov["queueDepthMax"] if ov else -1)
    b.family("sentinel_tpu_overload_shed", "counter",
             "Request groups shed by the token-server frontend, by cause "
             "(watermark / queue_full / deadline_expired)")
    if ov:
        for cause, key in (("watermark", "shedWatermark"),
                           ("queue_full", "shedQueueFull"),
                           ("deadline_expired", "shedDeadlineExpired")):
            b.sample("sentinel_tpu_overload_shed_total", {"cause": cause},
                     ov[key])
    b.family("sentinel_tpu_overload_shed_requests", "counter",
             "Individual requests inside shed groups (every one received "
             "an explicit OVERLOADED reply)")
    if ov:
        b.sample("sentinel_tpu_overload_shed_requests_total", None,
                 ov["shedRequests"])

    # -- wire path (reactor ingestion) -------------------------------------
    # Families render -1 / nothing while this instance is not a reactor
    # token server, so one scrape config fits every role.
    wire = res_stats.get("wire")
    b.family("sentinel_tpu_wire_connections", "gauge",
             "Live connections multiplexed by the wire reactor (-1: not "
             "a reactor server)")
    b.sample("sentinel_tpu_wire_connections", None,
             wire["connections"] if wire else -1)
    b.family("sentinel_tpu_wire_coalesced_batch", "gauge",
             "Requests folded per fused wire batch (p50 over the recent "
             "window; -1: not a reactor server)")
    b.sample("sentinel_tpu_wire_coalesced_batch", None,
             wire["coalescedBatchP50"] if wire else -1)
    b.family("sentinel_tpu_wire_rtt_ms", "gauge",
             "Server-side request RTT (arrival to reply built), recent "
             "percentiles in ms")
    if wire:
        b.sample("sentinel_tpu_wire_rtt_ms", {"quantile": "0.50"},
                 wire["rttP50Ms"])
        b.sample("sentinel_tpu_wire_rtt_ms", {"quantile": "0.99"},
                 wire["rttP99Ms"])
    b.family("sentinel_tpu_wire_outbuf_shed", "counter",
             "Requests shed OVERLOADED because the connection's bounded "
             "reply backlog was full (slow consumer)")
    if wire:
        b.sample("sentinel_tpu_wire_outbuf_shed_total", None,
                 wire["outbufShed"])

    # -- staged rollout guardrail ------------------------------------------
    guard = res_stats.get("rollout") or {}
    b.family("sentinel_tpu_rollout_active", "gauge",
             "1 while a candidate ruleset holds the device")
    active = guard.get("activeCandidateSet")
    b.sample("sentinel_tpu_rollout_active", None, 1 if active else 0)
    if active:
        b.family("sentinel_tpu_rollout", "info",
                 "Active candidate set and stage")
        b.sample("sentinel_tpu_rollout_info",
                 {"name": active, "stage": guard.get("stage") or ""}, 1)
    b.family("sentinel_tpu_rollout_breach_streak", "gauge",
             "Consecutive guardrail windows over the block-rate delta")
    b.sample("sentinel_tpu_rollout_breach_streak", None,
             guard.get("breachStreak", 0))
    b.family("sentinel_tpu_rollout_promotion_epoch", "gauge",
             "Promotions since engine start")
    b.sample("sentinel_tpu_rollout_promotion_epoch", None,
             guard.get("promotionEpoch", 0))

    # -- step timing (profile parity) --------------------------------------
    timer = engine.step_timer.snapshot()
    b.family("sentinel_tpu_step_dispatches", "counter",
             "Device step dispatches per kind")
    for kind, row in sorted(timer.items()):
        b.sample("sentinel_tpu_step_dispatches_total", {"kind": kind},
                 row["dispatches"])
    b.family("sentinel_tpu_step_entries", "counter",
             "Entries carried by device dispatches per kind")
    for kind, row in sorted(timer.items()):
        b.sample("sentinel_tpu_step_entries_total", {"kind": kind},
                 row["entries"])
    b.family("sentinel_tpu_step_ms", "gauge",
             "Sampled synchronous step wall time percentiles (ms)")
    for kind, row in sorted(timer.items()):
        for q in ("50", "95", "99"):
            v = row.get(f"stepP{q}Ms")
            if v is not None:
                b.sample("sentinel_tpu_step_ms",
                         {"kind": kind, "quantile": f"0.{q}"}, v)
    b.family("sentinel_tpu_enqueue_ms", "gauge",
             "Dispatch enqueue wall time percentiles (ms)")
    for kind, row in sorted(timer.items()):
        for q in ("50", "95", "99"):
            v = row.get(f"enqueueP{q}Ms")
            if v is not None:
                b.sample("sentinel_tpu_enqueue_ms",
                         {"kind": kind, "quantile": f"0.{q}"}, v)

    # -- pipelined admission (core/pipeline.py) ----------------------------
    # Cycle/entry counters are monotone across pipeline start/stop
    # generations (engine._pipeline_totals); depth + wait splits answer
    # "is pipelined latency queue wait or device wait" at a glance.
    pl = engine.pipeline_stats()
    b.family("sentinel_tpu_pipeline_active", "gauge",
             "1 while the micro-batch collector owns admission")
    b.sample("sentinel_tpu_pipeline_active", None, 1 if pl["active"] else 0)
    b.family("sentinel_tpu_pipeline_inflight_depth", "gauge",
             "Entry cycles currently in flight on the device stream")
    b.sample("sentinel_tpu_pipeline_inflight_depth", None,
             pl["inflightDepth"])
    b.family("sentinel_tpu_pipeline_inflight_depth_max", "gauge",
             "High-water mark of overlapped entry cycles since engine "
             "start (2+ = double buffering engaged)")
    b.sample("sentinel_tpu_pipeline_inflight_depth_max", None,
             pl["inflightDepthMax"])
    b.counter("sentinel_tpu_pipeline_cycles",
              "Dispatched pipelined entry cycles", pl["cycles"])
    b.counter("sentinel_tpu_pipeline_entries",
              "Entries batched through the pipeline", pl["batched"])
    b.counter("sentinel_tpu_pipeline_fail_open_cycles",
              "Pipeline cycles whose tickets failed open (dispatch or "
              "harvest death)", pl["failOpenCycles"])
    b.counter("sentinel_tpu_pipeline_pool_allocated",
              "Staging buffers the pipeline pool allocated fresh",
              pl["poolAllocated"])
    b.counter("sentinel_tpu_pipeline_pool_reused",
              "Staging-buffer acquisitions served from the pool",
              pl["poolReused"])
    b.family("sentinel_tpu_pipeline_queue_wait_ms", "gauge",
             "Oldest-ticket submit-to-dispatch wait per harvested cycle "
             "(rolling percentiles, ms)")
    for q in ("50", "95"):
        b.sample("sentinel_tpu_pipeline_queue_wait_ms",
                 {"quantile": f"0.{q}"}, pl[f"queueWaitP{q}Ms"])
    b.family("sentinel_tpu_pipeline_device_wait_ms", "gauge",
             "Harvest block on the materialized verdicts per cycle "
             "(rolling percentiles, ms)")
    for q in ("50", "95"):
        b.sample("sentinel_tpu_pipeline_device_wait_ms",
                 {"quantile": f"0.{q}"}, pl[f"deviceWaitP{q}Ms"])

    # -- step duration (continuous, SLO-targetable) ------------------------
    # Cumulative histogram of the sampled synchronous step walls: unlike
    # the rolling sentinel_tpu_step_ms quantile gauges above (post-hoc,
    # cleared on profile reset), these counters are monotone for the
    # engine's lifetime, so a scraper can rate() them and a step-latency
    # SLO can burn against them.
    from sentinel_tpu_torch.metrics.profiling import STEP_DURATION_EDGES_MS

    b.family("sentinel_tpu_step_duration_ms", "histogram",
             "Sampled synchronous device step wall time (ms, log2 "
             "buckets, cumulative since engine start)")
    for kind, row in sorted(engine.step_timer.duration_histogram().items()):
        b.histogram("sentinel_tpu_step_duration_ms", {"kind": kind},
                    [float(e) for e in STEP_DURATION_EDGES_MS],
                    [float(x) for x in row["buckets"]], row["sumMs"])

    # -- latency waterfall (telemetry/waterfall.py) ------------------------
    # Per-stage wire/pipeline latency on the shared log2 ladder
    # (cumulative since engine start), the end-to-end RTT histogram with
    # OpenMetrics exemplars joining slow buckets to stitched trace ids,
    # the last sealed second's derived queueing gauges (-1 = no sealed
    # second yet, the exporter's absent convention), and the regression
    # sentry's committed stage budgets.
    wf = getattr(engine, "waterfall", None)
    if wf is not None:
        from sentinel_tpu_torch.telemetry.attribution import WF_BUCKET_EDGES_MS

        wstate = wf.export_state()
        wf_edges = [float(e) for e in WF_BUCKET_EDGES_MS]
        b.family("sentinel_tpu_waterfall_stage_ms", "histogram",
                 "Per-stage wire/pipeline latency (ms, shared log2 "
                 "buckets, cumulative since engine start)")
        for lane in sorted(wstate["hist"]):
            for stage, (buckets, total) in wstate["hist"][lane].items():
                b.histogram("sentinel_tpu_waterfall_stage_ms",
                            {"lane": lane, "stage": stage}, wf_edges,
                            [float(x) for x in buckets], total)
        rtt_buckets, rtt_sum = wstate["rtt"]
        wf_exemplars = {
            bi: ({"trace_id": ex["traceId"]}, ex["valueMs"],
                 ex["timestampMs"] / 1000.0)
            for bi, ex in wstate["rttExemplars"].items()}
        b.family("sentinel_tpu_waterfall_rtt_ms", "histogram",
                 "End-to-end wire RTT, arrival to flush (ms, log2 "
                 "buckets) with trace-id exemplars on sampled slow "
                 "requests")
        b.histogram("sentinel_tpu_waterfall_rtt_ms", {}, wf_edges,
                    [float(x) for x in rtt_buckets], rtt_sum,
                    exemplars=wf_exemplars)
        last_wf = wstate["last"]
        b.family("sentinel_tpu_waterfall_stage_concurrency", "gauge",
                 "Little's-law inferred in-stage concurrency over the "
                 "last sealed second, per lane/stage")
        if last_wf is not None:
            for lane, stages in sorted(last_wf["lanes"].items()):
                for stage, cell in stages.items():
                    b.sample("sentinel_tpu_waterfall_stage_concurrency",
                             {"lane": lane, "stage": stage},
                             cell["concurrency"])
        b.family("sentinel_tpu_waterfall_device_utilization", "gauge",
                 "Fused-batch device busy fraction of the last sealed "
                 "second (-1 = none sealed yet)")
        b.sample("sentinel_tpu_waterfall_device_utilization", None,
                 last_wf["deviceUtilization"] if last_wf is not None else -1)
        b.family("sentinel_tpu_waterfall_coalesce_efficiency", "gauge",
                 "Requests per fused batch in the last sealed second "
                 "(-1 = none sealed yet)")
        b.sample("sentinel_tpu_waterfall_coalesce_efficiency", None,
                 last_wf["coalesce"]["efficiency"]
                 if last_wf is not None else -1)
        b.counter("sentinel_tpu_waterfall_seconds",
                  "Sealed waterfall seconds", wstate["sealedSeconds"])
        b.counter("sentinel_tpu_waterfall_exemplars",
                  "Exemplars captured from traced slow requests",
                  wstate["exemplarsCaptured"])
        b.family("sentinel_tpu_waterfall_budget_ms", "gauge",
                 "Committed per-stage latency budget the regression "
                 "sentry burns against (ms)")
        for key, budget in sorted(wstate["budgetsMs"].items()):
            b.sample("sentinel_tpu_waterfall_budget_ms", {"stage": key},
                     budget)

    # -- flight recorder (per-second series) -------------------------------
    # The LAST complete second per resource as gauges: scrapers that
    # cannot ingest the `timeseries` command still get a per-second
    # trajectory at 1 Hz scrape cadence (cumulative counters above give
    # totals; these give the derivative, device-exact).
    ts = engine.timeseries_view(limit=1)
    last = ts["seconds"][-1] if ts["seconds"] else None
    b.family("sentinel_tpu_second_pass", "gauge",
             "Admitted entries in the last complete flight-recorder "
             "second, per resource")
    if last is not None:
        for res, vals in sorted(last["resources"].items()):
            b.sample("sentinel_tpu_second_pass", {"resource": res},
                     vals["pass"])
    b.family("sentinel_tpu_second_block", "gauge",
             "Blocked entries in the last complete flight-recorder "
             "second, per resource")
    if last is not None:
        for res, vals in sorted(last["resources"].items()):
            b.sample("sentinel_tpu_second_block", {"resource": res},
                     vals["block"])
    b.family("sentinel_tpu_timeseries_last_second", "gauge",
             "Stamp (ms) of the newest complete flight-recorder second "
             "(-1: none recorded yet)")
    b.sample("sentinel_tpu_timeseries_last_second", None,
             last["timestamp"] if last is not None else -1)
    b.family("sentinel_tpu_timeseries_retained_seconds", "gauge",
             "Complete seconds retained in the host-side history")
    b.sample("sentinel_tpu_timeseries_retained_seconds", None,
             ts["retainedSeconds"])

    # -- namespace telescope (telemetry/population.py) ---------------------
    # (AFTER the timeseries_view read: its fold rolled the tracker,
    # so the snapshot is current through the newest complete second.)
    # Population sensing as gauges/counters: cardinality (global HLL),
    # hot-set mass and the Space-Saving floor (the exact-vs-bounded
    # seam), churn turnover, the cardinality-growth alarm, and the
    # fold-overhead self-measurement the bench phase trends.
    population = getattr(engine, "population", None)
    if population is not None:
        pstate = population.snapshot(windows=1)
        b.family("sentinel_tpu_population_enabled", "gauge",
                 "Namespace telescope enabled (0/1)")
        b.sample("sentinel_tpu_population_enabled", None,
                 1 if pstate["enabled"] else 0)
        b.counter("sentinel_tpu_population_observed",
                  "Total (key, count) traffic folded into the "
                  "population sketches", pstate["observed"])
        b.family("sentinel_tpu_population_distinct", "gauge",
                 "HyperLogLog distinct-key estimate since engine start "
                 "(stderr 1.04/sqrt(2^p))")
        b.sample("sentinel_tpu_population_distinct", None,
                 pstate["distinct"])
        b.family("sentinel_tpu_population_window_distinct", "gauge",
                 "Distinct-key estimate of the last sealed churn "
                 "window (-1 = none sealed yet)")
        b.sample("sentinel_tpu_population_window_distinct", None,
                 pstate["churn"][-1]["distinct"] if pstate["churn"] else -1)
        b.family("sentinel_tpu_population_ss_floor", "gauge",
                 "Space-Saving eviction floor: upper bound on any "
                 "absent key's true count (0 = summary unsaturated, "
                 "every entry exact)")
        b.sample("sentinel_tpu_population_ss_floor", None,
                 pstate["ssFloor"])
        b.family("sentinel_tpu_population_hot_mass", "gauge",
                 "Fraction of observed traffic held by the top-k "
                 "summary (upper estimates)")
        total_obs = pstate["observed"]
        hot = sum(e["count"] for e in pstate["topk"])
        b.sample("sentinel_tpu_population_hot_mass", None,
                 round(hot / total_obs, 6) if total_obs else 0.0)
        b.counter("sentinel_tpu_population_churn_entered",
                  "Cumulative top-k ring entries across sealed churn "
                  "windows", pstate["enteredTotal"])
        b.counter("sentinel_tpu_population_churn_exited",
                  "Cumulative top-k ring exits across sealed churn "
                  "windows", pstate["exitedTotal"])
        b.family("sentinel_tpu_population_cardinality_z", "gauge",
                 "Last churn window's cardinality z-score against the "
                 "EWMA baseline")
        b.sample("sentinel_tpu_population_cardinality_z", None,
                 pstate["baseline"]["lastZ"])
        b.family("sentinel_tpu_population_cardinality_alarm", "gauge",
                 "Cardinality-growth alarm firing (0/1)")
        b.sample("sentinel_tpu_population_cardinality_alarm", None,
                 1 if pstate["alarm"] else 0)
        b.counter("sentinel_tpu_population_fold_ms",
                  "Cumulative host milliseconds spent folding staged "
                  "pairs into the sketches", pstate["foldMsTotal"])

    # -- slot-table admission (core/slots.py) ------------------------------
    # Registry overflow is loud in BOTH modes (classic interning can
    # saturate too); the slot families render only in slot mode.
    b.counter("sentinel_tpu_registry_overflow",
              "Node registrations refused at registry capacity and "
              "degraded to pass-through rows", engine.registry.overflow_count)
    slots = getattr(engine, "slots", None)
    if slots is not None:
        sstate = slots.status()
        b.family("sentinel_tpu_slots_budget", "gauge",
                 "Device slot-table budget (rows, incl. the 2 reserved)")
        b.sample("sentinel_tpu_slots_budget", None, sstate["budget"])
        b.family("sentinel_tpu_slots_hot", "gauge",
                 "Resources currently holding a device slot")
        b.sample("sentinel_tpu_slots_hot", None, sstate["hot"])
        b.family("sentinel_tpu_slots_free", "gauge",
                 "Unoccupied device slots")
        b.sample("sentinel_tpu_slots_free", None, sstate["free"])
        b.family("sentinel_tpu_slots_pinned", "gauge",
                 "Resources pinned hot by compiled rules (never stolen)")
        b.sample("sentinel_tpu_slots_pinned", None, sstate["pinnedNow"])
        b.family("sentinel_tpu_slots_frozen", "gauge",
                 "Manual steal freeze in force (0/1; churn-alarm and "
                 "telemetry-stale freezes are visible in `slots` status)")
        b.sample("sentinel_tpu_slots_frozen", None,
                 1 if sstate["frozen"] else 0)
        b.counter("sentinel_tpu_slots_admits",
                  "Resources admitted into a device slot",
                  sstate["admitsTotal"])
        b.counter("sentinel_tpu_slots_evictions",
                  "Occupants evicted from a device slot (spilled "
                  "host-side)", sstate["evictionsTotal"])
        b.counter("sentinel_tpu_slots_rehydrations",
                  "Admissions that grafted (or cold-started) a "
                  "previously spilled resource", sstate["rehydrationsTotal"])
        b.counter("sentinel_tpu_slots_rehydrations_cold",
                  "Rehydrations with NO usable spill record (torn, "
                  "dropped, or first touch)", sstate["rehydrationsColdTotal"])
        b.counter("sentinel_tpu_slots_steals",
                  "Slots stolen from a colder occupant by a "
                  "telescope-ranked challenger", sstate["stealsTotal"])
        b.counter("sentinel_tpu_slots_storms",
                  "Chaos eviction storms executed (slots.evict.storm)",
                  sstate["stormsTotal"])
        b.counter("sentinel_tpu_slots_hot_hits",
                  "Entries admitted through a device slot or hot lease",
                  sstate["hotHitsTotal"])
        b.counter("sentinel_tpu_slots_cold_pass",
                  "Cold-tail entries passed on the host lease path",
                  sstate["coldPassTotal"])
        b.counter("sentinel_tpu_slots_cold_block",
                  "Cold-tail entries blocked host-exact by their lease",
                  sstate["coldBlockTotal"])
        b.counter("sentinel_tpu_slots_cold_unenforced",
                  "Cold-tail passes whose GUARDED rules could not be "
                  "enforced off-device (the loud degradation)",
                  sstate["coldUnenforcedTotal"])
        b.counter("sentinel_tpu_slots_spill_torn",
                  "Spill records torn in flight (victim rehydrates cold)",
                  sstate["spillTornTotal"])
        b.counter("sentinel_tpu_slots_spill_dropped",
                  "Spill records dropped at the LRU retention cap",
                  sstate["spillDroppedTotal"])
        b.counter("sentinel_tpu_slots_late_exits",
                  "Exits landing after their slot tenancy was evicted "
                  "(reconciled host-side)", sstate["lateExitsTotal"])
        b.counter("sentinel_tpu_slots_pin_overflow",
                  "Rule-pinned resources that exceeded the slot budget "
                  "(rule enforced cold, loudly)", sstate["pinOverflowTotal"])
        b.family("sentinel_tpu_slots_hit_rate", "gauge",
                 "Hot-set hit rate since start: hot admissions over all "
                 "admissions")
        b.sample("sentinel_tpu_slots_hit_rate", None, sstate["hitRate"])
        b.family("sentinel_tpu_slots_spill_records", "gauge",
                 "Spill records currently retained host-side")
        b.sample("sentinel_tpu_slots_spill_records", None,
                 sstate["spillRecords"])

    # -- SLO engine + alerting (slo/) --------------------------------------
    # The timeseries_view read above already refreshed judgement (spill
    # feeds the SLO manager and re-evaluates burn rules), so these render
    # current through the newest complete second.
    slo = engine.slo
    slo_status = slo.status()
    health = slo_status["health"]
    b.family("sentinel_tpu_slo_objectives", "gauge",
             "Configured SLO objectives")
    b.sample("sentinel_tpu_slo_objectives", None,
             len(slo_status["objectives"]))
    b.family("sentinel_tpu_slo_burn_rate", "gauge",
             "Multi-window burn rate per (objective, window side): "
             "error rate over the window divided by the error budget; "
             ">= the rule's threshold on BOTH sides fires the alert")
    for key, snap in sorted(slo_status["burn"].items()):
        for rule in snap["rules"]:
            labels = {"objective": key, "resource": snap["resource"],
                      "sli": snap["sli"], "severity": rule["severity"]}
            b.sample("sentinel_tpu_slo_burn_rate",
                     {**labels, "window": f"{rule['longSeconds']}s"},
                     round(rule["burnLong"], 6))
            b.sample("sentinel_tpu_slo_burn_rate",
                     {**labels, "window": f"{rule['shortSeconds']}s"},
                     round(rule["burnShort"], 6))
    b.family("sentinel_tpu_slo_baseline_zscore", "gauge",
             "Latest z-score of each objective-less resource's signal "
             "against its own EWMA baseline")
    for res, signals in sorted(slo_status["baselines"].items()):
        for sig, snap in sorted(signals.items()):
            if snap["warmedUp"]:
                b.sample("sentinel_tpu_slo_baseline_zscore",
                         {"resource": res, "signal": sig}, snap["lastZ"])
    b.family("sentinel_tpu_slo_health_score", "gauge",
             "Composite health per resource (100 = healthy; page -40, "
             "ticket -20, anomaly -15 per active alert)")
    for res, score in sorted(health["resources"].items()):
        b.sample("sentinel_tpu_slo_health_score", {"resource": res}, score)
    b.family("sentinel_tpu_slo_instance_health", "gauge",
             "Composite instance health: worst resource score minus the "
             "overload shed-rate penalty")
    b.sample("sentinel_tpu_slo_instance_health", None, health["instance"])
    b.family("sentinel_tpu_slo_shed_rate", "gauge",
             "Token-server admission shed fraction since the previous "
             "evaluation (health-score input; 0 while not a server)")
    b.sample("sentinel_tpu_slo_shed_rate", None, health["shedRate"])
    alerts = slo.alerts_snapshot(limit=0)
    by_sev: Dict[str, int] = {}
    for a in alerts["active"]:
        by_sev[a["severity"]] = by_sev.get(a["severity"], 0) + 1
    b.family("sentinel_tpu_alert_active", "gauge",
             "Currently firing alerts per severity")
    for sev in ("page", "ticket", "anomaly"):
        b.sample("sentinel_tpu_alert_active", {"severity": sev},
                 by_sev.get(sev, 0))
    b.counter("sentinel_tpu_alert_fired",
              "Alert fire transitions since engine start",
              alerts["counters"]["fired"])
    b.counter("sentinel_tpu_alert_resolved",
              "Alert resolve transitions since engine start",
              alerts["counters"]["resolved"])
    wh = alerts["webhook"]
    b.counter("sentinel_tpu_alert_webhook_delivered",
              "Alert events delivered to a webhook endpoint (2xx)",
              wh["delivered"])
    b.counter("sentinel_tpu_alert_webhook_failed",
              "Alert events that exhausted their webhook retry budget",
              wh["failed"])
    b.counter("sentinel_tpu_alert_webhook_dropped",
              "Alert events dropped from the full webhook queue",
              wh["dropped"])

    # -- closed-loop adaptive limiting (adaptive/) -------------------------
    ad = engine.adaptive.guardrail_state()
    b.family("sentinel_tpu_adaptive_enabled", "gauge",
             "1 while the adaptive loop may propose rule retunes")
    b.sample("sentinel_tpu_adaptive_enabled", None,
             1 if ad["enabled"] else 0)
    b.family("sentinel_tpu_adaptive_frozen", "gauge",
             "1 while the safety envelope holds the loop read-only "
             "(manual freeze, stale/faulted telemetry, abort backoff)")
    b.sample("sentinel_tpu_adaptive_frozen", None, 1 if ad["frozen"] else 0)
    b.counter("sentinel_tpu_adaptive_proposals",
              "Per-resource rule retunes proposed into a rollout "
              "candidate since engine start",
              ad["proposals"])
    b.counter("sentinel_tpu_adaptive_promotions",
              "Adaptive candidates promoted into the live rules "
              "(always through the rollout manager)",
              ad["promotions"])
    b.counter("sentinel_tpu_adaptive_aborts",
              "Adaptive candidates aborted (guardrail, SLO breach, "
              "freeze, or operator) — each starts the backoff window",
              ad["aborts"])
    b.counter("sentinel_tpu_adaptive_clamped",
              "Policy asks the envelope clamped (step/floor/ceiling) "
              "or rejected as band-edge no-ops",
              ad["clamped"])
    b.family("sentinel_tpu_adaptive_target_delta", "gauge",
             "Latest sensed block rate minus the target per adaptive "
             "resource (positive = still blocking above target)")
    for res, delta in sorted(engine.adaptive.target_deltas().items()):
        b.sample("sentinel_tpu_adaptive_target_delta",
                 {"resource": res}, delta)

    # -- LLM admission & streaming reservations (llm/) ---------------------
    st = engine.streams.stats()
    b.family("sentinel_tpu_llm_rules", "gauge",
             "Live TPS rules (per-model token budgets lowered onto the "
             "flow family)")
    b.sample("sentinel_tpu_llm_rules", None,
             len(engine.tps_rules.get_rules()))
    b.family("sentinel_tpu_llm_streams_active", "gauge",
             "Streaming reservations currently open in the ledger")
    b.sample("sentinel_tpu_llm_streams_active", None, st["active"])
    b.counter("sentinel_tpu_llm_streams_opened",
              "Streaming reservations admitted since engine start",
              st["opened"])
    b.counter("sentinel_tpu_llm_streams_blocked",
              "Stream opens rejected (window, concurrency cap, or "
              "ledger capacity)",
              st["openBlocked"])
    b.counter("sentinel_tpu_llm_streams_aborted",
              "Streams closed by abort (the remainder returned as "
              "expiring credit)",
              st["aborted"])
    b.counter("sentinel_tpu_llm_streams_evicted",
              "Idle streams evicted by the spill-cadence sweep "
              "(abandoned generations)",
              st["evicted"])
    b.counter("sentinel_tpu_llm_tokens_debited",
              "Tokens debited into TPS windows (reservations + "
              "overflow ticks)",
              st["tokensDebited"])
    b.counter("sentinel_tpu_llm_tokens_streamed",
              "Actual output tokens reconciled through stream ticks",
              st["tokensStreamed"])
    b.counter("sentinel_tpu_llm_tokens_released",
              "Unconsumed reservation tokens released at "
              "close/abort/evict",
              st["tokensReleased"])
    b.family("sentinel_tpu_llm_reservation_outstanding", "gauge",
             "Reserved-but-unstreamed tokens across open leases (the "
             "reconciliation backlog; drains to zero when idle)")
    b.sample("sentinel_tpu_llm_reservation_outstanding", None,
             st["outstandingTokens"])
    b.family("sentinel_tpu_llm_credit_tokens", "gauge",
             "Released tokens still reusable before their window "
             "rolls off")
    b.sample("sentinel_tpu_llm_credit_tokens", None, st["creditTokens"])

    # -- trace-replay simulator (simulator/) -------------------------------
    # Process-wide, not per-engine: the offline lab runs on its own sim
    # engines; this exposition is where its last verdict lands for
    # scrapers and the dashboard Simulator panel.
    from sentinel_tpu_torch.simulator.lab import counters as sim_counters
    from sentinel_tpu_torch.simulator.lab import last_report as sim_last_report

    simc = sim_counters()
    b.counter("sentinel_tpu_sim_lab_runs",
              "Policy-lab comparison runs completed in this process",
              simc["labRuns"])
    b.counter("sentinel_tpu_sim_replayed_seconds",
              "Simulated seconds replayed through the policy lab",
              simc["replayedSeconds"])
    report = sim_last_report()
    b.family("sentinel_tpu_sim_replay_rate", "gauge",
             "Last lab run's simulated seconds per wall second "
             "(accelerated-clock speedup; 0 until a lab run completes)")
    b.sample("sentinel_tpu_sim_replay_rate", None,
             (report or {}).get("secondsPerWallSecond", 0))
    b.family("sentinel_tpu_sim_policy_score", "gauge",
             "Last lab run's scalarized objective score per "
             "(scenario, policy) — higher is better; see the `sim` "
             "command for the full objective vectors")
    for scen, cell in sorted((report or {}).get("results", {}).items()):
        for pol, run in sorted(cell.items()):
            b.sample("sentinel_tpu_sim_policy_score",
                     {"scenario": scen, "policy": pol}, run["score"])

    # -- chaos campaign engine (chaos/) ------------------------------------
    # Process-wide like the simulator's: campaigns run on their own
    # throwaway meshes; the counters land here for scrapers and CI. A
    # deployment that strips the chaos tooling (the mode cluster/ha.py's
    # regression guard supports) reports zeroed families, never a dead
    # /metrics surface.
    try:
        from sentinel_tpu_torch.chaos import counters as chaos_counters

        chc = chaos_counters()
    except ImportError:
        chc = {"episodes": 0, "violations": 0, "faultsFired": 0,
               "shrinkSteps": 0}
    b.counter("sentinel_tpu_chaos_episodes",
              "Chaos-campaign episodes completed in this process",
              chc["episodes"])
    b.counter("sentinel_tpu_chaos_violations",
              "Invariant violations detected by chaos campaigns "
              "(any growth is a finding, not noise)",
              chc["violations"])
    b.counter("sentinel_tpu_chaos_faults_fired",
              "Faults fired / chaos actions executed across campaigns",
              chc["faultsFired"])
    b.counter("sentinel_tpu_chaos_shrink_steps",
              "Delta-debugging re-runs spent minimizing violating "
              "fault schedules",
              chc["shrinkSteps"])

    # -- control-plane audit journal (telemetry/journal.py) ----------------
    jstats = engine.journal.stats()
    b.family("sentinel_tpu_journal_last_seq", "gauge",
             "Highest audit-journal seq (monotone across restarts when "
             "a file backs the journal)")
    b.sample("sentinel_tpu_journal_last_seq", None, jstats["lastSeq"])
    b.counter("sentinel_tpu_journal_records",
              "Audit records appended by this process",
              jstats["appended"])
    b.counter("sentinel_tpu_journal_dropped_partial",
              "Torn tail records dropped (loudly) during crash recovery",
              jstats["droppedPartial"])
    b.counter("sentinel_tpu_journal_rotations",
              "Journal file segment rotations", jstats["rotations"])
    b.family("sentinel_tpu_journal_durable", "gauge",
             "1 while a file backs the journal (0: in-memory tail only)")
    b.sample("sentinel_tpu_journal_durable", None,
             1 if jstats["durable"] else 0)

    # -- fleet federation (telemetry/fleet.py) -----------------------------
    # Families render -1 / nothing while no FleetView collector is
    # attached, so one scrape config fits every role.
    fleet = engine.fleet
    fstatus = fleet.status() if fleet is not None else None
    b.family("sentinel_tpu_fleet_leaders", "gauge",
             "Leaders the attached FleetView federates (-1: no "
             "collector attached)")
    b.sample("sentinel_tpu_fleet_leaders", None,
             fstatus["leaderCount"] if fstatus else -1)
    b.family("sentinel_tpu_fleet_stale_leaders", "gauge",
             "Leaders whose newest complete second is older than the "
             "staleness bound")
    b.sample("sentinel_tpu_fleet_stale_leaders", None,
             fstatus["staleLeaders"] if fstatus else -1)
    b.family("sentinel_tpu_fleet_health", "gauge",
             "Fleet health: min of the federated leaders' instance "
             "health scores (-1: no collector / no data)")
    fh = (fstatus or {}).get("fleetHealth")
    b.sample("sentinel_tpu_fleet_health", None, fh if fh is not None else -1)
    b.family("sentinel_tpu_fleet_retained_seconds", "gauge",
             "Fleet-wide per-second records the collector retains")
    b.sample("sentinel_tpu_fleet_retained_seconds", None,
             fstatus["retainedSeconds"] if fstatus else -1)
    b.family("sentinel_tpu_fleet_skew_ms", "gauge",
             "Signed clock skew per federated leader (leader nowMs "
             "minus collector clock at receive)")
    if fstatus:
        for name, row in sorted(fstatus["leaders"].items()):
            if row["skewMs"] is not None:
                b.sample("sentinel_tpu_fleet_skew_ms", {"leader": name},
                         row["skewMs"])
    b.counter("sentinel_tpu_fleet_polls",
              "FleetView scrape cycles completed",
              fstatus["polls"] if fstatus else 0)
    b.counter("sentinel_tpu_fleet_poll_errors",
              "Leader page pulls that returned no payload",
              fstatus["pollErrors"] if fstatus else 0)

    # -- governed shard rebalancing (cluster/rebalance.py) -----------------
    rb = getattr(engine, "rebalancer", None)
    rstate = rb.metrics_state() if rb is not None else None
    b.counter("sentinel_tpu_rebalance_plans",
              "Rebalance plans proposed (skew / join / leave)",
              rstate["plans"] if rstate else 0)
    b.counter("sentinel_tpu_rebalance_applies",
              "Certified plans applied through the HA map path",
              rstate["applies"] if rstate else 0)
    b.counter("sentinel_tpu_rebalance_rollbacks",
              "Last-known-good ownership restores",
              rstate["rollbacks"] if rstate else 0)
    b.counter("sentinel_tpu_rebalance_vetoes",
              "Plans/applies refused by the safety envelope (freeze, "
              "cooldown, certification, stale plan)",
              rstate["vetoes"] if rstate else 0)
    b.counter("sentinel_tpu_rebalance_slices_moved",
              "Slices whose owner changed via applied rebalance plans",
              rstate["slices_moved"] if rstate else 0)
    b.family("sentinel_tpu_rebalance_frozen", "gauge",
             "1 while the freeze gate blocks new plans (manual, stale "
             "telemetry, degraded leader, or abort backoff)")
    b.sample("sentinel_tpu_rebalance_frozen", None,
             rstate["frozen"] if rstate else 0)
    b.family("sentinel_tpu_rebalance_skew", "gauge",
             "Last sensed leader-load skew ((max-min)/mean over the "
             "slice-granular fleet fold)")
    b.sample("sentinel_tpu_rebalance_skew", None,
             rstate["skew"] if rstate else 0)

    # -- span sampling health ----------------------------------------------
    ssnap = engine.spans.snapshot(limit=0)
    b.counter("sentinel_tpu_spans_seen",
              "Cluster-checked entries observed by the span sampler",
              ssnap["seen"])
    b.counter("sentinel_tpu_spans_recorded",
              "Cross-process spans retained in the host ring",
              ssnap["recorded"])

    # -- trace sampling health ---------------------------------------------
    tsnap = engine.traces.snapshot(limit=0)
    b.counter("sentinel_tpu_traces_seen_blocked",
              "Blocked entries observed by the trace sampler",
              tsnap["seenBlocked"])
    b.counter("sentinel_tpu_traces_recorded",
              "Decision traces retained in the host ring",
              tsnap["recorded"])
    b.counter("sentinel_tpu_traces_dropped_batches",
              "Dispatched batches the sampler dropped (hand-off queue "
              "full) — sampling degradation signal",
              tsnap["droppedBatches"])
    b.counter("sentinel_tpu_traces_errors",
              "Queued batches the trace worker failed to process",
              tsnap["errors"])

    return b.render()


def render_dashboard_metrics(dashboard) -> str:
    """Dashboard-side aggregates (its repository + discovery state) as
    OpenMetrics — the fleet view beside each engine's own ``/metrics``."""
    import time as _time

    b = OpenMetricsBuilder()
    apps = dashboard.apps
    b.family("sentinel_tpu_dashboard_machines", "gauge",
             "Machines registered per app (healthy only)")
    for app in sorted(apps.app_names()):
        b.sample("sentinel_tpu_dashboard_machines", {"app": app},
                 len(apps.healthy_machines(app)))
    now_ms = int(_time.time() * 1000)
    rows = []
    for app in dashboard.repository.apps():
        for res in dashboard.repository.resources_of(app):
            series = dashboard.repository.query(
                app, res, now_ms - 120_000, now_ms)
            if series:
                rows.append((app, res, series[-1]))
    b.family("sentinel_tpu_dashboard_resource_pass_qps", "gauge",
             "Latest aggregated pass QPS per (app, resource)")
    for app, res, latest in rows:
        b.sample("sentinel_tpu_dashboard_resource_pass_qps",
                 {"app": app, "resource": res}, latest["passQps"])
    b.family("sentinel_tpu_dashboard_resource_block_qps", "gauge",
             "Latest aggregated block QPS per (app, resource)")
    for app, res, latest in rows:
        b.sample("sentinel_tpu_dashboard_resource_block_qps",
                 {"app": app, "resource": res}, latest["blockQps"])
    b.family("sentinel_tpu_dashboard_sse_clients", "gauge",
             "Live /telemetry/stream consumers currently connected")
    b.sample("sentinel_tpu_dashboard_sse_clients", None,
             getattr(dashboard, "sse_clients", 0))
    return b.render()
