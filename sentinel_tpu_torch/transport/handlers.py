"""The default command handler set (port of
``sentinel_tpu/transport/handlers.py``; reference:
``transport-common:command/handler/*CommandHandler``, SURVEY.md §2.3).

Command names, parameter names, and response shapes follow the reference so
the dashboard's ``SentinelApiClient`` calls work unchanged:
``getRules?type=...`` / ``setRules`` / ``metric`` / ``cnode`` /
``clusterNode`` / ``jsonTree`` / ``tree`` / ``version`` / ``basicInfo`` /
``systemStatus`` / ``getSwitch`` / ``setSwitch`` / ``api``. Every handler
acts on the engine of the center it was asked through; the drills that
build engines of their own (``sim op=run``, ``chaos``, ``waterfall
op=saturate``) build them on that engine's device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.datasource import converters as CV
from sentinel_tpu_torch.datasource.base import WritableDataSource
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.transport.command_center import (
    CommandRequest,
    CommandResponse,
    command_mapping,
    registered_commands,
)

_writable_datasources: Dict[str, WritableDataSource] = {}
_searcher_cache: Dict[tuple, MetricSearcher] = {}


def _drill_device(req: CommandRequest):
    """Where a drill builds its engines: the device of the engine the
    command was asked through (None, the card, for a bare request)."""
    return getattr(req.engine, "device", None)


def register_writable_datasource(rule_type: str, ds: WritableDataSource) -> None:
    """``WritableDataSourceRegistry`` analog: setRules persists through it."""
    _writable_datasources[rule_type] = ds


_FAMILIES = {
    # type -> (manager attr, from_json, to_dicts)
    "flow": ("flow_rules", CV.flow_rules_from_json,
             lambda rs: [CV.flow_rule_to_dict(r) for r in rs]),
    "degrade": ("degrade_rules", CV.degrade_rules_from_json,
                lambda rs: [CV.degrade_rule_to_dict(r) for r in rs]),
    "system": ("system_rules", CV.system_rules_from_json,
               lambda rs: [CV.system_rule_to_dict(r) for r in rs]),
    "authority": ("authority_rules", CV.authority_rules_from_json,
                  lambda rs: [CV.authority_rule_to_dict(r) for r in rs]),
    "paramFlow": ("param_rules", CV.param_rules_from_json,
                  lambda rs: [CV.param_rule_to_dict(r) for r in rs]),
    "tps": ("tps_rules", CV.tps_rules_from_json,
            lambda rs: [CV.tps_rule_to_dict(r) for r in rs]),
}


@command_mapping("version", "framework version")
def cmd_version(req: CommandRequest) -> CommandResponse:
    import sentinel_tpu_torch

    return CommandResponse.of_success(
        f"sentinel-tpu/{sentinel_tpu_torch.__version__}")


@command_mapping("basicInfo", "process + app identity")
def cmd_basic_info(req: CommandRequest) -> CommandResponse:
    port = req.center.bound_port if req.center is not None else config.api_port()
    return CommandResponse.of_success({
        "appName": config.app_name(),
        "appType": config.app_type(),
        "pid": os.getpid(),
        "port": port,
    })


@command_mapping("getRules", "get active rules by type")
def cmd_get_rules(req: CommandRequest) -> CommandResponse:
    rule_type = req.get_param("type")
    fam = _FAMILIES.get(rule_type or "")
    if fam is None:
        return CommandResponse.of_failure("invalid type")
    manager = getattr(req.engine, fam[0])
    return CommandResponse.of_success(fam[2](manager.get_rules()))


@command_mapping("setRules", "load rules wholesale by type")
def cmd_set_rules(req: CommandRequest) -> CommandResponse:
    rule_type = req.get_param("type")
    fam = _FAMILIES.get(rule_type or "")
    if fam is None:
        return CommandResponse.of_failure("invalid type")
    data = req.get_param("data") or req.body
    try:
        rules = fam[1](data or "[]")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(f"parse error: {ex}")
    from sentinel_tpu_torch.telemetry.journal import acting

    with acting("ops:setRules"):  # audit-journal provenance
        getattr(req.engine, fam[0]).load_rules(rules)
    ds = _writable_datasources.get(rule_type)
    if ds is not None:
        try:
            ds.write(rules)
        except Exception as ex:
            return CommandResponse.of_failure(f"store error: {ex!r}")
    return CommandResponse.of_success("success")


@command_mapping("metric", "query the metric log by time range")
def cmd_metric(req: CommandRequest) -> CommandResponse:
    try:
        start = int(req.get_param("startTime", "0"))
        end_raw = req.get_param("endTime")
        end = int(end_raw) if end_raw else None
        max_lines = min(int(req.get_param("maxLines", "6000")), 12000)
    except ValueError:
        return CommandResponse.of_failure("invalid time range")
    identity = req.get_param("identity")
    key = (config.log_dir(), config.app_name())
    searcher = _searcher_cache.get(key)
    if searcher is None:
        # Cache per (dir, app) — the dashboard polls /metric at ~1 Hz
        # (reference keeps one SENTINEL_METRIC_SEARCHER for the same reason).
        searcher = _searcher_cache[key] = MetricSearcher(*key)
    if end is not None or identity is not None:
        nodes = searcher.find_by_time_and_resource(
            start, end if end is not None else 2**62, identity, max_lines)
    else:
        nodes = searcher.find(start, max_lines)
    if not nodes:
        return CommandResponse.of_success("")
    return CommandResponse.of_success(
        "\n".join(n.to_thin_string() for n in nodes) + "\n")


@command_mapping("cnode", "per-resource live stats")
def cmd_cnode(req: CommandRequest) -> CommandResponse:
    res = req.get_param("id")
    if not res:
        return CommandResponse.of_failure("invalid parameter: empty id")
    snap = req.engine.node_snapshot().get(res)
    if snap is None:
        return CommandResponse.of_success("")
    return CommandResponse.of_success({"resource": res, **snap})


@command_mapping("clusterNode", "all resource nodes' live stats")
def cmd_cluster_node(req: CommandRequest) -> CommandResponse:
    snap = req.engine.node_snapshot()
    return CommandResponse.of_success(
        [{"resource": r, **v} for r, v in sorted(snap.items())])


@command_mapping("jsonTree", "call tree as JSON")
def cmd_json_tree(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success(req.engine.tree_dict())


@command_mapping("tree", "call tree as text")
def cmd_tree(req: CommandRequest) -> CommandResponse:
    lines = []

    def walk(node: dict, depth: int):
        lines.append(
            "-" * depth
            + f"{node['resource'] or '(root)'}("
            + f"T:{node['threadNum']} pq:{node['passQps']} bq:{node['blockQps']}"
            + f" tq:{node['totalQps']} rt:{node['averageRt']:.1f}"
            + f" e:{node['exceptionQps']})"
        )
        for c in node["children"]:
            walk(c, depth + 1)

    walk(req.engine.tree_dict(), 0)
    return CommandResponse.of_success("\n".join(lines) + "\n")


@command_mapping("systemStatus", "system protection signals")
def cmd_system_status(req: CommandRequest) -> CommandResponse:
    eng = req.engine
    sig = eng.system_status.snapshot()
    totals, threads = eng.row_stats()
    from sentinel_tpu_torch.core import constants as C
    from sentinel_tpu_torch.core.registry import ENTRY_ROW

    t = totals[ENTRY_ROW]
    succ = float(t[C.MetricEvent.SUCCESS])
    return CommandResponse.of_success({
        "load": float(sig[0]),
        "cpuUsage": float(sig[1]),
        "qps": float(t[C.MetricEvent.PASS]),
        "avgRt": float(t[C.MetricEvent.RT]) / succ if succ > 0 else 0.0,
        "maxThread": int(threads[ENTRY_ROW]),
        "failOpenCount": int(getattr(eng, "fail_open_count", 0)),
        "clusterFallbackCount": int(getattr(eng, "cluster_fallback_count", 0)),
    })


@command_mapping("resilience", "degradation channels: fail-open, cluster "
                               "fallbacks, breaker state, cluster HA role/"
                               "epoch/failovers, remote-loop health")
def cmd_resilience(req: CommandRequest) -> CommandResponse:
    """Resilience snapshot (no reference twin — the reference surfaces
    none of its own remote clients' health): fail-open and cluster
    fallback counters, the token client's CLOSED/OPEN/HALF_OPEN gate,
    the cluster-HA block (current role, leadership epoch, failover
    count, degraded-quota spells — cluster/ha.py), and last-success
    ages for every registered remote loop."""
    return CommandResponse.of_success(req.engine.resilience_stats())


@command_mapping("rollout", "staged rollout: shadow/canary candidate rulesets")
def cmd_rollout(req: CommandRequest) -> CommandResponse:
    """Staged-rollout control plane (rollout/ — no reference
    twin: the reference pushes rule edits straight to enforcement).

    ``op`` selects the action:
      * ``status`` (default) — candidate sets + guardrail snapshot
      * ``diff``   — per-resource shadow-vs-live outcome deltas
      * ``load``   — stage a candidate: ``name=`` + JSON body/data
                     ``{family: [rule dicts]}`` (+ optional ``stage=``,
                     ``canaryBps=``)
      * ``stage``  — move the active candidate: ``stage=shadow|canary``
                     (+ ``canaryBps=``)
      * ``promote`` / ``abort`` — end the rollout (``name=`` optional
                     cross-check)
      * ``tick``   — run one guardrail window now (ops cadence / cron)
    """
    from sentinel_tpu_torch.rollout.manager import ACTIVE_STAGES

    rollout = req.engine.rollout
    op = req.get_param("op", "status")
    name = req.get_param("name")
    try:
        if op == "status":
            return CommandResponse.of_success(rollout.snapshot())
        if op == "diff":
            return CommandResponse.of_success(rollout.diff())
        if op == "tick":
            return CommandResponse.of_success(rollout.tick())
        if op == "load":
            if not name:
                return CommandResponse.of_failure("missing parameter: name")
            data = req.get_param("data") or req.body
            rules = json.loads(data or "{}")
            if not isinstance(rules, dict):
                return CommandResponse.of_failure(
                    "expected a JSON object {family: [rules]}")
            stage = req.get_param("stage", "shadow")
            bps = req.get_param("canaryBps")
            cand = rollout.load_candidate(
                name, rules, stage=stage,
                canary_bps=int(bps) if bps is not None else None)
            return CommandResponse.of_success(
                {"loaded": cand.name, "stage": cand.stage,
                 "families": {f: len(cand.rules[f]) for f in cand.families()}})
        if op == "stage":
            stage = req.get_param("stage", "")
            if stage not in ACTIVE_STAGES:
                return CommandResponse.of_failure(
                    f"stage must be one of {list(ACTIVE_STAGES)}")
            bps = req.get_param("canaryBps")
            cand = rollout.set_stage(
                name, stage, canary_bps=int(bps) if bps is not None else None)
            return CommandResponse.of_success(
                {"name": cand.name, "stage": cand.stage,
                 "canaryBps": cand.canary_bps})
        if op == "promote":
            return CommandResponse.of_success(rollout.promote(name))
        if op == "abort":
            return CommandResponse.of_success(
                rollout.abort(name, reason=req.get_param("reason", "manual")))
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("profile", "device step timing stats")
def cmd_profile(req: CommandRequest) -> CommandResponse:
    """Per-step timing snapshot (SURVEY §5 — no reference twin: the
    upstream has no in-process profiler; the port's dispatch timing is
    the analog of its entry-overhead JMH harness, live). Per-kind
    p50/p95/p99 of the sampled synchronous step walls AND the always-on
    enqueue walls; the sampling cadence is ``csp.sentinel.profile.
    syncEvery``. ``reset=true`` clears the rings after reading."""
    reset = (req.get_param("reset") or "").lower() == "true"
    # Kinds stay top-level (the pre-existing response shape tooling
    # parses); the sampling cadence rides beside them.
    out = dict(req.engine.step_timer.snapshot(reset=reset))
    out["syncEvery"] = req.engine.step_timer.sync_every
    return CommandResponse.of_success(out)


@command_mapping("telemetry", "unified telemetry snapshot (JSON parity "
                              "with the /metrics exposition)")
def cmd_telemetry(req: CommandRequest) -> CommandResponse:
    """Device-resident decision attribution + RT histograms + cumulative
    counters as JSON (telemetry/ — no reference twin). The
    same series the OpenMetrics ``metrics`` command exposes for
    scrapers."""
    return CommandResponse.of_success(req.engine.telemetry_snapshot())


@command_mapping("traces", "sampled blocked-entry decision traces + "
                           "cross-process spans")
def cmd_traces(req: CommandRequest) -> CommandResponse:
    """The decision-trace ring (telemetry/trace_ring.py): every Nth
    blocked entry's (resource, origin, reason, rule slot, window
    snapshot), newest first. ``limit=`` caps the returned traces and
    ``offset=`` skips the newest N (pagination); ``drain=true``
    processes any queued batches synchronously first (deterministic
    reads for tooling). ``spans=true`` adds the cross-process span view
    (telemetry/spans.py — engine decision -> token request -> server
    token-service, grouped per trace id); ``format=otlp`` returns the
    collected spans as OTLP-flavored JSON instead (feed it to any OTLP
    HTTP receiver / trace viewer)."""
    traces = req.engine.traces
    if (req.get_param("drain") or "").lower() == "true":
        traces.drain()
    try:
        limit = req.get_param("limit")
        limit_n = int(limit) if limit is not None else None
        offset_n = int(req.get_param("offset", "0"))
    except ValueError:
        return CommandResponse.of_failure("invalid parameter: limit/offset")
    if (req.get_param("format") or "").lower() == "otlp":
        from sentinel_tpu_torch.core.config import config as _cfg
        from sentinel_tpu_torch.telemetry.spans import to_otlp

        snap = req.engine.spans.snapshot(limit=limit_n, offset=offset_n)
        return CommandResponse.of_success(
            to_otlp(snap["spans"], service_name=_cfg.app_name()))
    out = traces.snapshot(limit=limit_n, offset=offset_n)
    if (req.get_param("spans") or "").lower() == "true":
        out["spanTraces"] = req.engine.spans.traces(limit=limit_n)
        out["spanSampling"] = {
            k: v for k, v in req.engine.spans.snapshot(limit=0).items()
            if k != "spans"}
    return CommandResponse.of_success(out)


@command_mapping("timeseries", "flight recorder: exact per-second "
                               "telemetry series")
def cmd_timeseries(req: CommandRequest) -> CommandResponse:
    """Per-second flight-recorder windows (telemetry/timeseries.py):
    pass/block/success/exception/RT-bucket deltas per resource plus the
    per-(reason, rule-slot) split, exact per wall-clock second.
    ``resource=`` filters; ``sinceMs=`` returns only seconds strictly
    after the given stamp (the SSE pump's cursor); ``startMs=``/
    ``endMs=`` bound the window; ``limit=``/``offset=`` paginate
    newest-first (chronological inside the page). Cursor reads
    (``sinceMs`` without an explicit ``limit``) are UNBOUNDED: the
    newest-first default cap would silently drop the oldest unserved
    seconds for a consumer more than one page behind, advancing its
    cursor past data the host still retains."""
    try:
        limit = req.get_param("limit")
        since = req.get_param("sinceMs")
        limit_n = (int(limit) if limit is not None
                   else None if since is not None else 60)
        offset_n = int(req.get_param("offset", "0"))
        start = req.get_param("startMs")
        start_n = int(since) + 1 if since is not None else (
            int(start) if start is not None else None)
        end = req.get_param("endMs")
        end_n = int(end) if end is not None else None
    except ValueError:
        return CommandResponse.of_failure("invalid parameter")
    return CommandResponse.of_success(req.engine.timeseries_view(
        resource=req.get_param("resource"), start_ms=start_n, end_ms=end_n,
        limit=limit_n, offset=offset_n))


@command_mapping("explain", "why was this entry blocked: trace × "
                            "flight-recorder join")
def cmd_explain(req: CommandRequest) -> CommandResponse:
    """Join a sampled blocked-entry trace with the flight-recorder
    second it occurred in: verdict (reason + first-blocking rule slot),
    that second's window occupancy for the resource, and the loaded
    rules of the blocking family — reconstructed from recorded data, no
    step re-run. ``resource=`` picks the newest trace for a resource,
    ``index=`` pages further back (0 = newest)."""
    try:
        index = int(req.get_param("index", "0"))
    except ValueError:
        return CommandResponse.of_failure("invalid parameter: index")
    out = req.engine.explain_trace(resource=req.get_param("resource"),
                                   index=index)
    if out is None:
        return CommandResponse.of_failure("no matching trace sampled yet")
    return CommandResponse.of_success(out)


@command_mapping("alerts", "active SLO/anomaly alerts + transition log")
def cmd_alerts(req: CommandRequest) -> CommandResponse:
    """The SLO engine's alert store (slo/): active alerts
    plus the seq-numbered fired/resolved transition log. ``sinceSeq=``
    returns only transitions strictly after the cursor (the dashboard
    SSE pump's resume point); ``resource=`` filters both lists;
    ``limit=`` caps the returned transitions (newest kept). Reading
    refreshes judgement first (fold + spill + evaluate), so the answer
    is current through the newest complete second."""
    try:
        since = int(req.get_param("sinceSeq", "0"))
        limit = req.get_param("limit")
        limit_n = int(limit) if limit is not None else None
    except ValueError:
        return CommandResponse.of_failure("invalid parameter: sinceSeq/limit")
    req.engine.slo_refresh()
    return CommandResponse.of_success(req.engine.slo.alerts_snapshot(
        since_seq=since, resource=req.get_param("resource"), limit=limit_n))


@command_mapping("slo", "SLO objectives, burn rates, baselines, health")
def cmd_slo(req: CommandRequest) -> CommandResponse:
    """SLO control + status plane (slo/ — no reference
    twin). ``op`` selects the action:

      * ``status`` (default) — objectives + per-rule burn snapshot +
        anomaly baselines + health scores (refreshes first)
      * ``get``  — the configured objectives as JSON (round-trips
        through the ``sloRules`` converter schema)
      * ``set``  — load objectives wholesale: JSON array in
        ``data=``/body (the same wholesale semantics every rule family
        uses; a datasource-bound deployment hot-reloads through the
        ``sloRules`` converter instead)
    """
    slo = req.engine.slo
    op = req.get_param("op", "status")
    try:
        if op == "status":
            req.engine.slo_refresh()
            return CommandResponse.of_success(slo.status())
        if op == "get":
            return CommandResponse.of_success(
                [CV.slo_objective_to_dict(o) for o in slo.objectives()])
        if op == "set":
            from sentinel_tpu_torch.telemetry.journal import acting

            data = req.get_param("data") or req.body
            objectives = CV.slo_objectives_from_json(data or "[]")
            with acting("ops:slo"):
                slo.load_objectives(objectives)
            return CommandResponse.of_success(
                {"loaded": len(objectives)})
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("waterfall", "wire-to-device latency waterfall: per-stage "
                              "budget, exemplars, sentry, saturation probe")
def cmd_waterfall(req: CommandRequest) -> CommandResponse:
    """The latency waterfall's control + status plane
    (telemetry/waterfall.py). ``op`` selects:

      * ``status`` (default) — cumulative + recent per-second per-stage
        budgets, RTT reconciliation, exemplars, and the regression
        sentry's burn snapshot (refreshes judgement first so staged
        seconds seal); ``limit=`` caps the recent seconds returned
      * ``budgets`` — merge sentry budget overrides: JSON object in
        ``data=``/body mapping ``lane.stage`` to ms (<= 0 removes a
        budget); journaled as a config action
      * ``saturate`` — run the loopback saturation probe inline across
        a (depth x connections) grid: ``depths=``/``conns=`` comma
        lists, ``windowS=`` per-cell window (grid capped at 6 cells,
        window at 2s; the full grid runs through
        ``saturation_probe`` directly)
    """
    waterfall = getattr(req.engine, "waterfall", None)
    if waterfall is None:
        return CommandResponse.of_failure("waterfall recorder unavailable")
    op = req.get_param("op", "status")
    try:
        if op == "status":
            req.engine.slo_refresh()
            limit = int(req.get_param("limit", "60"))
            return CommandResponse.of_success(waterfall.snapshot(limit=limit))
        if op == "budgets":
            import json as _json

            from sentinel_tpu_torch.telemetry.journal import acting

            data = req.get_param("data") or req.body
            overrides = _json.loads(data or "{}")
            if not isinstance(overrides, dict):
                return CommandResponse.of_failure(
                    "budgets payload must be a JSON object")
            with acting("ops:waterfallBudgets"):
                budgets = waterfall.sentry.set_budgets(overrides)
                req.engine.journal.record("waterfallBudgets",
                                          budgets=dict(budgets))
            return CommandResponse.of_success({"budgetsMs": budgets})
        if op == "saturate":
            from sentinel_tpu_torch.telemetry.waterfall import saturation_probe

            depths = [int(x) for x in
                      (req.get_param("depths") or "1,2").split(",") if x]
            conns = [int(x) for x in
                     (req.get_param("conns") or "2,8").split(",") if x]
            window_s = min(2.0, float(req.get_param("windowS", "1.0")))
            out = saturation_probe(depths=depths, conns_grid=conns,
                                   window_s=window_s, settle_s=0.5,
                                   max_cells=6, device=_drill_device(req))
            return CommandResponse.of_success(out)
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("population", "namespace telescope: top-k, cardinality, "
                               "churn, admission-readiness projection")
def cmd_population(req: CommandRequest) -> CommandResponse:
    """The namespace telescope's read plane
    (telemetry/population.py). ``op`` selects:

      * ``status`` (default) — totals, HLL cardinalities (global +
        per-slice), top-k with error bars, churn series, baseline +
        alarm, fold-overhead counters (refreshes the fold first);
        ``topk=`` / ``windows=`` cap the lists
      * ``report`` — admission-readiness projection for a hypothetical
        slot budget (``budget=``, default 1024): hit rate with
        guaranteed/upper bounds, eviction/steal rate, cold-tail mass
      * ``curve`` — ``report`` across a budget ladder (``budgets=``
        comma list) — the dashboard's projection curve
      * ``page`` — the raw mergeable wire page (federation debugging)
      * ``fleet`` — scrape + exactly merge every watched leader's page
        (needs a ``fleet op=watch`` collector); ``budget=``/``budgets=``
        add the merged report/curve
    """
    population = getattr(req.engine, "population", None)
    if population is None:
        return CommandResponse.of_failure("population tracker unavailable")
    op = req.get_param("op", "status")
    try:
        if op == "status":
            req.engine.slo_refresh()
            topk = req.get_param("topk")
            windows = int(req.get_param("windows", "60"))
            return CommandResponse.of_success(population.snapshot(
                topk=int(topk) if topk is not None else None,
                windows=windows))
        if op == "report":
            budget = int(req.get_param("budget", "1024"))
            return CommandResponse.of_success(
                req.engine.population_report(slot_budget=budget))
        if op == "curve":
            from sentinel_tpu_torch.telemetry.population import projection_curve

            req.engine.slo_refresh()
            budgets = [int(x) for x in
                       (req.get_param("budgets")
                        or "16,32,64,128,256,512,1024,4096").split(",") if x]
            page = population.page()
            return CommandResponse.of_success({
                "curve": projection_curve(
                    page, budgets,
                    window_seconds=population.window_ms // 1000),
                "alarm": population.alarm,
            })
        if op == "page":
            req.engine.slo_refresh()
            return CommandResponse.of_success(population.page())
        if op == "fleet":
            fleet = getattr(req.engine, "fleet", None)
            if fleet is None:
                return CommandResponse.of_success(
                    {"watching": False,
                     "hint": "no collector attached (fleet op=watch first)"})
            if (req.get_param("poll") or "true").lower() != "false":
                fleet.poll_population()
            budget = req.get_param("budget")
            budgets = req.get_param("budgets")
            return CommandResponse.of_success(fleet.fleet_population(
                slot_budget=int(budget) if budget is not None else None,
                budgets=([int(x) for x in budgets.split(",") if x]
                         if budgets else None)))
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("slots", "slot-table admission: status, hot map, "
                          "freeze/thaw the steal plane")
def cmd_slots(req: CommandRequest) -> CommandResponse:
    """The bounded device hot set's ops plane (core/slots.py). ``op``
    selects:

      * ``status`` (default) — budget/hot/free/pinned, every counter
        (evictions, rehydrations, steals, storms, cold-tail verdicts,
        torn spills, late exits), the measured hit rate, and the
        freeze reason currently in force (manual > churn-alarm >
        telemetry-stale)
      * ``hot`` — the live resource -> (slot, generation) map
      * ``freeze`` — manual steal freeze (``reason=`` optional);
        journaled; first-touch admits keep flowing
      * ``thaw`` — lift a manual freeze (journaled; automation gates
        may still hold steals)
    """
    slots = getattr(req.engine, "slots", None)
    if slots is None:
        return CommandResponse.of_failure(
            "engine is not in slot mode (csp.sentinel.slots.budget=0)")
    op = req.get_param("op", "status")
    try:
        if op == "status":
            out = slots.status()
            out["freezeReason"] = slots.freeze_reason(req.engine.now_ms())
            return CommandResponse.of_success(out)
        if op == "hot":
            snap = slots.checkpoint_dict()
            hot = {res: {"slot": sg[0], "generation": sg[1]}
                   for res, sg in sorted(snap["hot"].items())}
            return CommandResponse.of_success(
                {"budget": slots.budget, "hot": hot})
        if op == "freeze":
            reason = req.get_param("reason", "manual")
            slots.freeze(reason)
            req.engine.journal.record("slotsFreeze", reason=reason)
            return CommandResponse.of_success(
                {"frozen": True, "reason": reason})
        if op == "thaw":
            slots.thaw()
            req.engine.journal.record("slotsThaw")
            return CommandResponse.of_success({
                "frozen": False,
                "freezeReason": slots.freeze_reason(req.engine.now_ms()),
            })
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("adaptive", "closed-loop adaptive limiting: status, "
                             "enable/freeze, targets, decision log")
def cmd_adaptive(req: CommandRequest) -> CommandResponse:
    """Control + status plane of the adaptive loop (adaptive/ — no
    reference twin). ``op`` selects the action:

      * ``status`` (default) — enabled/frozen state, in-flight
        candidate, targets, latest senses, cooldowns, counters
      * ``enable`` / ``disable`` — flip autonomous actuation (disable
        aborts any in-flight adaptive candidate through the rollout
        manager)
      * ``freeze`` / ``unfreeze`` — manual global freeze (+ optional
        ``reason=``); freeze also aborts any in-flight candidate
      * ``history`` — seq-cursored decision log: ``sinceSeq=`` returns
        only entries strictly after the cursor, ``limit=`` caps them
      * ``get`` / ``set`` — the adaptive targets as JSON (``set`` loads
        wholesale from ``data=``/body, the ``adaptiveTargets``
        converter schema — a datasource-bound deployment hot-reloads
        through that converter instead)
      * ``tick`` — force one loop evaluation now (drills / tests; the
        loop normally rides the once-per-second fold at its configured
        interval)
    """
    loop = req.engine.adaptive
    op = req.get_param("op", "status")
    try:
        if op == "status":
            return CommandResponse.of_success(loop.status())
        if op == "enable":
            return CommandResponse.of_success(loop.enable())
        if op == "disable":
            return CommandResponse.of_success(loop.disable())
        if op == "freeze":
            return CommandResponse.of_success(
                loop.freeze(reason=req.get_param("reason", "ops")))
        if op == "unfreeze":
            return CommandResponse.of_success(loop.unfreeze())
        if op == "history":
            since = int(req.get_param("sinceSeq", "0"))
            limit = req.get_param("limit")
            return CommandResponse.of_success(loop.history(
                since_seq=since,
                limit=int(limit) if limit is not None else None))
        if op == "get":
            return CommandResponse.of_success(
                [CV.adaptive_target_to_dict(t)
                 for t in loop.controller.targets()])
        if op == "set":
            from sentinel_tpu_torch.telemetry.journal import acting

            data = req.get_param("data") or req.body
            targets = CV.adaptive_targets_from_json(data or "[]")
            with acting("ops:adaptive"):
                loop.load_targets(targets)
            return CommandResponse.of_success({"loaded": len(targets)})
        if op == "tick":
            return CommandResponse.of_success(loop.tick(force=True))
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("flightrec", "flight recorder trace capture: export "
                              "history as a replay trace, tee live "
                              "seconds to a file")
def cmd_flightrec(req: CommandRequest) -> CommandResponse:
    """Trace capture surface of the simulator (simulator/ — no
    reference twin). ``op`` selects the action:

      * ``status`` (default) — recorder/retention state + active tee
      * ``export`` — the spilled flight-recorder history as one
        versioned trace document (``startMs=``/``endMs=`` bound the
        window, ``limit=`` keeps the newest N seconds, ``resource=``
        filters); feed it to ``ReplayEngine`` / the ``sim`` command
      * ``tee`` — start streaming every complete second to ``path=``
        (JSONL: header + one line per second, crash-safe)
      * ``stop`` — detach and close the active tee
    """
    from sentinel_tpu_torch.simulator.trace import TraceWriter, export_trace

    eng = req.engine
    op = req.get_param("op", "status")
    # The active writer lives ON the engine (not a module registry):
    # its lifecycle is the engine's, so a discarded engine can't leak a
    # retained writer + open file behind an unreachable id() key.
    writer = getattr(eng, "_flightrec_writer", None)
    try:
        if op == "status":
            return CommandResponse.of_success({
                "recorderSeconds": eng.flight_seconds,
                "retainedSeconds": eng.timeseries.retained(),
                "tee": writer.status() if writer is not None else None,
            })
        if op == "export":
            start = req.get_param("startMs")
            end = req.get_param("endMs")
            limit = req.get_param("limit")
            trace = export_trace(
                eng,
                start_ms=int(start) if start is not None else None,
                end_ms=int(end) if end is not None else None,
                limit=int(limit) if limit is not None else None,
                resource=req.get_param("resource"))
            return CommandResponse.of_success(trace.to_dict())
        if op == "tee":
            if writer is not None and not writer.status()["closed"]:
                return CommandResponse.of_failure(
                    f"tee already active to {writer.path!r} (op=stop first)")
            path = req.get_param("path")
            if not path:
                return CommandResponse.of_failure("missing parameter: path")
            writer = TraceWriter(path, eng)
            eng._flightrec_writer = writer
            eng.add_flight_tee(writer.on_second)
            return CommandResponse.of_success(writer.status())
        if op == "stop":
            if writer is None:
                return CommandResponse.of_failure("no tee active")
            # Land any staged-but-unspilled seconds WHILE the tee is
            # still attached (the spill is what feeds it), so the
            # capture covers everything complete at stop time; only
            # then detach and close.
            eng.slo_refresh()
            eng.remove_flight_tee(writer.on_second)
            writer.close()
            eng._flightrec_writer = None
            return CommandResponse.of_success(writer.status())
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError, OSError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("sim", "trace-replay simulator: policy-lab report, "
                        "scenario catalog, drill replays")
def cmd_sim(req: CommandRequest) -> CommandResponse:
    """Read/drill surface of the offline simulator (simulator/ — no
    reference twin). ``op`` selects the action:

      * ``report`` (default) — the last policy-lab comparison report
        (per-policy objective vectors, winners; the dashboard panel's
        source). Offline suites populate it via ``run_lab``.
      * ``scenarios`` — the built-in synthetic scenario catalog
      * ``run`` — replay one scenario NOW, open loop, on a fresh sim
        engine: ``scenario=`` (+ ``seconds=``, ``seed=``). Synchronous
        and CPU-bound — bounded by ``csp.sentinel.sim.drill.max.
        seconds``; real policy evaluation belongs in the offline lab.
    """
    op = req.get_param("op", "report")
    try:
        if op == "report":
            from sentinel_tpu_torch.simulator.lab import last_report

            report = last_report()
            if report is None:
                return CommandResponse.of_success(
                    {"report": None,
                     "hint": "no policy-lab run in this process yet — "
                             "populate it with simulator.lab.run_lab "
                             "(op=run is a plain replay drill; it does "
                             "not produce a comparison report)"})
            return CommandResponse.of_success({"report": report})
        if op == "scenarios":
            from sentinel_tpu_torch.simulator.scenarios import SCENARIOS

            return CommandResponse.of_success(
                {"scenarios": sorted(SCENARIOS)})
        if op == "run":
            from sentinel_tpu_torch.simulator.replay import ReplayEngine
            from sentinel_tpu_torch.simulator.scenarios import build_scenario

            name = req.get_param("scenario")
            if not name:
                return CommandResponse.of_failure(
                    "missing parameter: scenario")
            cap = config.sim_drill_max_seconds()
            seconds = int(req.get_param("seconds", "60"))
            if seconds > cap:
                return CommandResponse.of_failure(
                    f"seconds={seconds} exceeds the drill cap {cap} "
                    "(csp.sentinel.sim.drill.max.seconds); run longer "
                    "scenarios through the offline lab")
            trace = build_scenario(
                name, seconds=seconds, seed=int(req.get_param("seed", "0")))
            result = ReplayEngine(trace, device=_drill_device(req)).run(
                warmup=True)
            out = result.to_dict()
            out["scenario"] = name
            out["secondsPerWallSecond"] = round(
                result.seconds / result.replay_wall_s, 1)
            return CommandResponse.of_success(out)
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("chaos", "deterministic chaos campaigns: run/replay "
                          "seeded episodes, shrink violations")
def cmd_chaos(req: CommandRequest) -> CommandResponse:
    """The chaos campaign engine (chaos/ — no reference twin). ``op``
    selects the action:

      * ``status`` (default) — process-wide counters (episodes,
        violations, faults fired, shrink steps) + the last campaign
        report's summary
      * ``run`` — run a campaign NOW: ``seed=`` (+ ``episodes=``,
        ``seconds=``). Synchronous and CPU-bound, bounded by
        ``csp.sentinel.chaos.max.episodes``; the full 200-episode
        acceptance campaign runs through ``ChaosCampaign`` directly.
      * ``replay`` — re-run ONE episode from ``seed=`` + ``episode=``
        and return its verdict/fault hashes (bit-identical for the
        same coordinates — the seed-replay contract). Schedules are a
        function of the campaign's ``seconds`` too: pass the same
        ``seconds=`` the original campaign ran with (default: the
        config default the `run` op uses).
      * ``shrink`` — replay ``seed=``/``episode=``(/``seconds=``) and,
        if it violates, ddmin the schedule to a minimal repro bundle
    """
    from sentinel_tpu_torch import chaos as chaos_pkg
    from sentinel_tpu_torch.chaos.campaign import ChaosCampaign

    op = req.get_param("op", "status")
    try:
        if op == "status":
            report = chaos_pkg.last_report()
            summary = None
            if report is not None:
                summary = {k: report[k] for k in
                           ("campaignSeed", "episodesRun", "violations",
                            "shrinkSteps", "episodesPerSec",
                            "verdictSha256")}
                summary["bundles"] = len(report["bundles"])
            return CommandResponse.of_success(
                {"counters": chaos_pkg.counters(),
                 "lastCampaign": summary})
        if op == "run":
            cap = config.chaos_max_episodes()
            episodes = int(req.get_param("episodes",
                                         str(config.chaos_episodes())))
            if episodes > cap:
                return CommandResponse.of_failure(
                    f"episodes={episodes} exceeds the command cap {cap} "
                    "(csp.sentinel.chaos.max.episodes); run long "
                    "campaigns through ChaosCampaign directly")
            seconds = req.get_param("seconds")
            if seconds is not None and not 1 <= int(seconds) <= 60:
                return CommandResponse.of_failure(
                    f"seconds={seconds} outside [1, 60] — the synchronous "
                    "command runs bounded episodes; size long campaigns "
                    "through the library")
            campaign = ChaosCampaign(
                campaign_seed=int(req.get_param("seed", "0")),
                episodes=episodes,
                seconds=int(seconds) if seconds is not None else None,
                device=_drill_device(req))
            report = campaign.run()
            out = dict(report)
            out["bundles"] = len(report["bundles"])
            out.pop("firstEpisode", None)
            return CommandResponse.of_success(out)
        if op in ("replay", "shrink"):
            episode = req.get_param("episode")
            if episode is None:
                return CommandResponse.of_failure(
                    "missing parameter: episode")
            seconds = req.get_param("seconds")
            if seconds is not None and not 1 <= int(seconds) <= 60:
                return CommandResponse.of_failure(
                    f"seconds={seconds} outside [1, 60]")
            campaign = ChaosCampaign(
                campaign_seed=int(req.get_param("seed", "0")),
                seconds=int(seconds) if seconds is not None else None,
                device=_drill_device(req))
            result = campaign.run_episode(int(episode))
            if op == "replay" or not result.violations:
                return CommandResponse.of_success(result.to_dict())
            bundle, _runs = campaign.shrink_and_bundle(int(episode),
                                                       result=result)
            return CommandResponse.of_success(bundle)
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except RuntimeError as ex:
        # Overlapping campaigns: the process-wide injector slot is
        # already taken (another run/replay in flight) — a clean
        # failure reply, not a handler-thread traceback.
        return CommandResponse.of_failure(str(ex))
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("journal", "control-plane audit journal: seq-cursored "
                            "record tail + causality walks")
def cmd_journal(req: CommandRequest) -> CommandResponse:
    """The crash-safe control-plane audit journal (telemetry/journal.py
    — no reference twin: the reference's rule pushes leave no durable
    record). ``op`` selects the action:

      * ``tail`` (default) — records after ``sinceSeq=`` (the cursor;
        strictly-after), newest kept under ``limit=``; ``kind=``
        filters one record kind (ruleLoad, sloTransition,
        adaptiveDecision, rolloutStage/Promote/Abort, haRoleFlip,
        clusterMapApply, shardMapApply, clockSwap, ...)
      * ``chain`` — the causality walk from ``seq=`` up its causeSeq
        back-pointers (nearest first)
      * ``status`` — seq cursor, retention, durability, drop counters
    """
    journal = req.engine.journal
    op = req.get_param("op", "tail")
    try:
        if op == "status":
            return CommandResponse.of_success(journal.stats())
        if op == "chain":
            seq = req.get_param("seq")
            if seq is None:
                return CommandResponse.of_failure("missing parameter: seq")
            return CommandResponse.of_success(
                {"chain": journal.chain(int(seq))})
        if op == "tail":
            since = int(req.get_param("sinceSeq", "0"))
            limit = req.get_param("limit")
            records = journal.tail(
                since_seq=since, kind=req.get_param("kind"),
                limit=int(limit) if limit is not None else None)
            return CommandResponse.of_success(
                {"records": records, "nextSeq": journal.last_seq})
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("why", "forensic verdict join: flight-recorder second "
                        "× journal records in force at that stamp")
def cmd_why(req: CommandRequest) -> CommandResponse:
    """"Why was this resource blocked at T": joins the flight-recorder
    second at ``stampMs=`` (default: the newest complete second for the
    resource) with the journal records in force then — the blocking
    rule family's live rules from the load record (with datasource
    provenance and the causeSeq chain), the rollout candidate in force,
    and the shard map in force (telemetry/journal.py
    ``forensic_why``)."""
    resource = req.get_param("resource")
    if not resource:
        return CommandResponse.of_failure("missing parameter: resource")
    stamp = req.get_param("stampMs")
    try:
        out = req.engine.why_query(
            resource, int(stamp) if stamp is not None else None)
    except (ValueError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))
    return CommandResponse.of_success(out)


@command_mapping("fleet", "fleet telemetry: federate N leaders' "
                          "per-second series, staleness, health")
def cmd_fleet(req: CommandRequest) -> CommandResponse:
    """The FleetView collector (telemetry/fleet.py — no reference twin:
    the reference dashboard polls per-machine metric logs). ``op``:

      * ``status`` (default) — per-leader staleness/skew/health/slice
        ownership + fleet health (min of instance healths); refreshes
        with one poll cycle first unless ``poll=false``
      * ``watch`` — attach a collector: JSON list in ``data=``/body of
        ``{"name":..., "host":..., "port":...}`` leader specs
        (replaces any previous collector)
      * ``series`` — the federated per-second series (``resource=``,
        ``limit=``, ``sinceMs=`` filter/paginate); exact fleet sums
        beside the per-leader split
      * ``poll`` — force one scrape cycle now
      * ``stop`` — detach the collector
    """
    from sentinel_tpu_torch.telemetry.fleet import FleetView

    eng = req.engine
    op = req.get_param("op", "status")
    try:
        if op == "watch":
            data = req.get_param("data") or req.body
            leaders = json.loads(data or "[]")
            if not isinstance(leaders, list) or not leaders:
                return CommandResponse.of_failure(
                    "expected a non-empty JSON list of "
                    '{"name","host","port"} leader specs')
            # Build (and fully validate) the NEW collector before
            # touching the old one: a bad spec must leave the working
            # collector attached, not tear it down and then fail. Names
            # come from the VALIDATED collector — the raw payload may
            # use tuple-form specs with no "name" key.
            fresh = FleetView(leaders, clock=eng.now_ms)
            watching = sorted(fresh._leaders.keys())
            old, eng.fleet = eng.fleet, fresh
            if old is not None:
                old.stop()
            return CommandResponse.of_success({"watching": watching})
        fleet = eng.fleet
        if fleet is None:
            return CommandResponse.of_success(
                {"watching": False,
                 "hint": "no collector attached (op=watch first)"})
        if op == "status":
            if (req.get_param("poll") or "true").lower() != "false":
                fleet.poll()
            return CommandResponse.of_success(fleet.status())
        if op == "poll":
            return CommandResponse.of_success({"ingested": fleet.poll()})
        if op == "series":
            limit = req.get_param("limit")
            since = req.get_param("sinceMs")
            return CommandResponse.of_success({
                "seconds": fleet.series(
                    resource=req.get_param("resource"),
                    limit=int(limit) if limit is not None else 60,
                    since_ms=int(since) if since is not None else None),
                "settledThroughMs": fleet.settled_through_ms(),
            })
        if op == "stop":
            eng.fleet = None
            fleet.stop()
            return CommandResponse.of_success({"watching": False})
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("rebalance", "governed shard placement: sense, plan, "
                              "chaos-certify, apply, rollback")
def cmd_rebalance(req: CommandRequest) -> CommandResponse:
    """The ShardRebalancer's ops surface (cluster/rebalance.py —
    docs/OPERATIONS.md "Self-driving rebalancing"). ``op``:

      * ``status`` (default) — freeze state, counters, plan history,
        last-known-good version
      * ``sense`` — slice-granular load fold + skew (``window=``)
      * ``plan`` — propose a minimal-movement diff (``window=``)
      * ``join`` — fold a new seat in (``machine=``, ``host=``,
        ``port=``)
      * ``leave`` — fold a seat out (``machine=``); the freeze gate
        ignores degraded leaders here (the sick seat is WHY we move)
      * ``certify`` — dry-run plan ``plan=`` as a seeded chaos-mesh
        episode (``seed=``); any invariant violation vetoes + backs off
      * ``apply`` — actuate a certified plan ``plan=`` (``force=true``
        bypasses certification AND the freeze gate — break-glass only)
      * ``rollback`` — restore last-known-good ownership, one command
      * ``freeze`` / ``unfreeze`` — manual freeze (outranks everything)
    """
    rb = getattr(req.engine, "rebalancer", None)
    if rb is None:
        return CommandResponse.of_failure("no rebalancer on this engine")
    op = req.get_param("op", "status")
    try:
        if op == "status":
            return CommandResponse.of_success(rb.status())
        if op == "sense":
            win = req.get_param("window")
            return CommandResponse.of_success(
                rb.sense(int(win) if win is not None else None))
        if op == "plan":
            win = req.get_param("window")
            return CommandResponse.of_success(
                rb.propose(window_seconds=int(win) if win is not None
                           else None))
        if op == "join":
            machine = req.get_param("machine")
            host = req.get_param("host")
            port = req.get_param("port")
            if not machine or not host or port is None:
                return CommandResponse.of_failure(
                    "missing parameter: machine/host/port")
            return CommandResponse.of_success(
                rb.plan_join(machine, host, int(port)))
        if op == "leave":
            machine = req.get_param("machine")
            if not machine:
                return CommandResponse.of_failure(
                    "missing parameter: machine")
            return CommandResponse.of_success(rb.plan_leave(machine))
        if op == "certify":
            plan = req.get_param("plan")
            if plan is None:
                return CommandResponse.of_failure("missing parameter: plan")
            seed = req.get_param("seed")
            return CommandResponse.of_success(rb.certify(
                int(plan),
                campaign_seed=int(seed) if seed is not None else 0))
        if op == "apply":
            plan = req.get_param("plan")
            if plan is None:
                return CommandResponse.of_failure("missing parameter: plan")
            force = (req.get_param("force") or "false").lower() == "true"
            return CommandResponse.of_success(rb.apply(int(plan),
                                                       force=force))
        if op == "rollback":
            return CommandResponse.of_success(rb.rollback())
        if op in ("freeze", "unfreeze"):
            return CommandResponse.of_success(rb.freeze(op == "freeze"))
        return CommandResponse.of_failure(f"unknown op {op!r}")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(str(ex))


@command_mapping("metrics", "Prometheus/OpenMetrics exposition")
def cmd_metrics(req: CommandRequest) -> CommandResponse:
    """``GET /metrics``: the whole engine — attribution counters, RT
    histograms, resilience channels, rollout guardrail, step timing —
    as OpenMetrics text under stable ``sentinel_tpu_*`` names
    (docs/OPERATIONS.md "Telemetry & scraping")."""
    from sentinel_tpu_torch.telemetry.exporter import render_engine_metrics
    from sentinel_tpu_torch.telemetry.openmetrics import OPENMETRICS_CONTENT_TYPE

    return CommandResponse(True, render_engine_metrics(req.engine),
                           content_type=OPENMETRICS_CONTENT_TYPE)


@command_mapping("leases", "token-lease fast-path state")
def cmd_leases(req: CommandRequest) -> CommandResponse:
    """Which resources admit host-side (core/lease.py) and their mirrored
    window usage — the ops view of the fast path (no reference twin; the
    lease itself has none)."""
    from sentinel_tpu_torch.utils import time_util

    eng = req.engine
    now = time_util.current_time_millis()
    out = {res: {"thresholds": lease.thresholds,
                 "intervalMs": lease.interval_ms,
                 "usageQps": round(lease.usage(now), 2),
                 # which admission ring serves this lease: the C
                 # extension (csrc/lease_ext.c) or the Python fallback
                 "nativeRing": lease._ring is not None,
                 # widened-lease coverage (ROADMAP 3c): mirrored warm-up
                 # rule count + whether a param rule is host-admitted
                 "warmupRules": len(getattr(lease, "warm", ()) or ()),
                 "paramLease": getattr(lease, "param", None) is not None}
           for res, lease in sorted(eng._leases.items())}
    return CommandResponse.of_success({
        # configured vs EFFECTIVE: system rules / SPI registrations turn
        # the whole fast path off even when the config flag is on.
        "enabled": eng.lease_enabled,
        "effective": bool(eng._leases) or eng._unruled_fastpath,
        "unruledFastpath": eng._unruled_fastpath,
        "guardedResources": sorted(eng._guarded_resources),
        "resources": out,
    })


@command_mapping("resetSlotFloor", "shrink ratcheted per-slot device loops")
def cmd_reset_slot_floor(req: CommandRequest) -> CommandResponse:
    """Reclaim step cost after a transient rule burst: the engine's
    slot-count ratchet (engine._ratchet_slots) widens per-family rule
    tensors monotonically, so a one-time K-rule push costs K slots per
    step forever. This command drops the floor to what current rules
    need, at the price of ONE rule-tensor rebuild on the next dispatch
    (no reference twin: the upstream's per-resource object graph has no
    compiled shapes)."""
    eng = req.engine
    old = eng.reset_slot_floor()
    return CommandResponse.of_success({
        "previousFloor": old,
        "floor": dict(eng._slot_floor),
        "note": "next dispatch rebuilds the rule tensors of every family",
    })


@command_mapping("getSwitch", "global protection switch state")
def cmd_get_switch(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success(
        f"Sentinel switch value: {'true' if req.engine.enabled else 'false'}")


@command_mapping("setSwitch", "flip the global protection switch")
def cmd_set_switch(req: CommandRequest) -> CommandResponse:
    value = (req.get_param("value") or "").lower()
    if value not in ("true", "false"):
        return CommandResponse.of_failure("invalid parameter: value")
    req.engine.enabled = value == "true"
    return CommandResponse.of_success("success")


@command_mapping("getClusterMode", "cluster role of this instance")
def cmd_get_cluster_mode(req: CommandRequest) -> CommandResponse:
    """Reference: ``FetchClusterModeCommandHandler`` — grown an ``ha``
    block (cluster/ha.py): role, leadership epoch, failover and
    degraded-mode counters, so the dashboard's HA panel reads one
    endpoint per machine."""
    cs = req.engine.cluster
    return CommandResponse.of_success({
        "mode": cs.mode,
        "lastModified": cs.last_modified,
        "clientAvailable": cs.client_if_active() is not None,
        "serverRunning": cs.token_server is not None,
        "ha": cs.ha_stats(),
        # Frontend overload: the embedded token server's
        # queue/shed snapshot (None while not a server) — the
        # dashboard's Overload panel reads this per machine — plus the
        # engine-side count of entries a shed degraded to the local
        # lease/fallback path.
        "overload": cs.overload_stats(),
        # Wire path: the reactor frontend's connection /
        # coalescing / RTT snapshot (None while not a reactor server).
        "wire": cs.wire_stats(),
        "clusterOverloadCount": getattr(
            req.engine, "cluster_overload_count", 0),
    })


@command_mapping("setClusterMode", "flip cluster role (0=client, 1=server)")
def cmd_set_cluster_mode(req: CommandRequest) -> CommandResponse:
    """Reference: ``ModifyClusterModeCommandHandler``."""
    try:
        mode = int(req.get_param("mode", ""))
    except ValueError:
        return CommandResponse.of_failure("invalid parameter: mode")
    try:
        req.engine.cluster.apply_mode(mode)
    except (ValueError, OSError) as ex:
        return CommandResponse.of_failure(f"failed to apply mode: {ex}")
    return CommandResponse.of_success("success")


@command_mapping("cluster/client/fetchConfig", "token client config")
def cmd_cluster_client_fetch(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success(dict(req.engine.cluster.client_config))


@command_mapping("cluster/client/modifyConfig", "stage token client config")
def cmd_cluster_client_modify(req: CommandRequest) -> CommandResponse:
    """Reference: ``ModifyClusterClientConfigHandler`` (data= JSON body)."""
    from sentinel_tpu_torch.cluster.state import CLUSTER_CLIENT

    data = req.get_param("data") or req.body
    try:
        cfg = json.loads(data or "{}")
        if not isinstance(cfg, dict):
            raise ValueError("expected an object")
        staged = {k: cfg[k] for k in ("serverHost", "serverPort",
                                      "requestTimeout", "namespace") if k in cfg}
        # Validate before mutating so a bad payload can't poison the
        # staged config for later setClusterMode calls.
        if "serverPort" in staged:
            staged["serverPort"] = int(staged["serverPort"])
        if "requestTimeout" in staged:
            staged["requestTimeout"] = float(staged["requestTimeout"])
            if staged["requestTimeout"] <= 0:
                raise ValueError("requestTimeout must be positive (ms)")
    except (ValueError, TypeError) as ex:
        return CommandResponse.of_failure(f"parse error: {ex}")
    cs = req.engine.cluster
    cs.client_config.update(staged)
    # A live client re-connects to the new target (reference listener
    # behavior on ClusterClientConfigManager updates).
    if cs.mode == CLUSTER_CLIENT:
        try:
            cs.apply_mode(CLUSTER_CLIENT)
        except (ValueError, OSError) as ex:
            return CommandResponse.of_failure(f"failed to re-apply: {ex}")
    return CommandResponse.of_success("success")


@command_mapping("cluster/server/fetchConfig", "token server config + namespaces")
def cmd_cluster_server_fetch(req: CommandRequest) -> CommandResponse:
    cs = req.engine.cluster
    out = dict(cs.server_config)
    srv = cs.token_server
    if srv is not None:
        out["boundPort"] = srv.bound_port
        out["namespaces"] = srv.service.rules.namespaces()
    return CommandResponse.of_success(out)


@command_mapping("cluster/server/modifyTransportConfig", "stage token server config")
def cmd_cluster_server_modify(req: CommandRequest) -> CommandResponse:
    cs = req.engine.cluster
    port = req.get_param("port")
    qps = req.get_param("maxAllowedQps")
    try:
        if port is not None:
            cs.server_config["port"] = int(port)
        if qps is not None:
            cs.server_config["maxAllowedQps"] = float(qps)
    except ValueError:
        return CommandResponse.of_failure("invalid parameter")
    return CommandResponse.of_success("success")


@command_mapping("cluster/server/modifyFlowRules", "load cluster flow rules")
def cmd_cluster_server_rules(req: CommandRequest) -> CommandResponse:
    """Reference: ``ModifyClusterFlowRulesCommandHandler`` — wholesale per
    namespace. Targets the running server's manager, or the persistent
    staged manager (shared with future ``setClusterMode=1`` flips) so rules
    can be pre-loaded and survive server re-applies."""
    cs = req.engine.cluster
    namespace = req.get_param("namespace", "default")
    data = req.get_param("data") or req.body
    try:
        rules = CV.flow_rules_from_json(data or "[]")
    except (ValueError, KeyError, TypeError) as ex:
        return CommandResponse.of_failure(f"parse error: {ex}")
    # Always land in the persistent staged manager (future apply_mode flips
    # serve from it); a running server with its OWN manager — started via
    # set_to_server(service=...) rather than apply_mode — gets the same
    # load so the live and staged rule sets can't split-brain.
    staged = cs.server_rules()
    staged.load_rules(namespace, rules)
    srv = cs.token_server
    if srv is not None and srv.service.rules is not staged:
        srv.service.rules.load_rules(namespace, rules)
    return CommandResponse.of_success("success")


@command_mapping("cluster/server/metrics", "token server per-flowId metrics")
def cmd_cluster_server_metrics(req: CommandRequest) -> CommandResponse:
    srv = req.engine.cluster.token_server
    if srv is None:
        return CommandResponse.of_failure("token server not running")
    snap = srv.service.metrics_snapshot()
    return CommandResponse.of_success(
        [{"flowId": fid, **vals} for fid, vals in sorted(snap.items())])


@command_mapping("api", "list registered commands")
def cmd_api(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success([
        {"url": f"/{name}", "desc": desc}
        for name, desc in sorted(registered_commands().items())
    ])

# -- gateway rules / API groups (reference: the sentinel-api-gateway
# command handlers — gateway/getRules, gateway/updateRules,
# gateway/getApiDefinitions, gateway/updateApiDefinitions) -----------------


@command_mapping("gateway/getRules", "active gateway flow rules")
def cmd_gateway_get_rules(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.adapters import gateway as GW

    rules_mgr, _ = GW.managers_for(req.engine)
    return CommandResponse.of_success(
        [GW.gateway_rule_to_dict(r) for r in rules_mgr.get_rules()])


@command_mapping("gateway/updateRules", "load gateway flow rules wholesale")
def cmd_gateway_update_rules(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.adapters import gateway as GW

    data = req.get_param("data") or req.body
    try:
        rules = GW.gateway_rules_from_json(data or "[]")
    except (ValueError, KeyError, TypeError, AttributeError) as ex:
        return CommandResponse.of_failure(f"parse error: {ex}")
    rules_mgr, _ = GW.managers_for(req.engine)
    rules_mgr.load_rules(rules)
    return CommandResponse.of_success("success")


@command_mapping("gateway/getApiDefinitions", "custom API groups")
def cmd_gateway_get_apis(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.adapters import gateway as GW

    _, api_mgr = GW.managers_for(req.engine)
    return CommandResponse.of_success(
        [GW.api_definition_to_dict(a)
         for a in api_mgr.get_api_definitions()])


@command_mapping("gateway/updateApiDefinitions", "load custom API groups")
def cmd_gateway_update_apis(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.adapters import gateway as GW

    data = req.get_param("data") or req.body
    try:
        defs = GW.api_definitions_from_json(data or "[]")
    except (ValueError, KeyError, TypeError, AttributeError) as ex:
        return CommandResponse.of_failure(f"parse error: {ex}")
    _, api_mgr = GW.managers_for(req.engine)
    api_mgr.load_api_definitions(defs)
    return CommandResponse.of_success("success")
