"""JSON rule converters: the reference's wire schema <-> rule dataclasses
(port of ``sentinel_tpu/datasource/converters.py``, its five rule
families).

The JSON field names are the reference's (camelCase POJO properties as
fastjson serializes them), so rule files and dashboard payloads written
for the reference parse unchanged. Any rule may carry the staged-rollout
tags ``candidateSet`` and ``rolloutStage``; they travel both ways, and an
untagged rule keeps the reference's wire schema byte for byte.

The TPS family (``llm/``), the SLO-objective (``slo/``) and
adaptive-target (``adaptive/``) converters are here too, and the
cluster-map and shard-map converters of the HA token cluster
(``cluster/ha.py``, ``cluster/sharding.py``).
"""

from __future__ import annotations

import json
from typing import List, Optional

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.models.authority import AuthorityRule
from sentinel_tpu_torch.models.degrade import DegradeRule
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.models.param_flow import ParamFlowItem, ParamFlowRule
from sentinel_tpu_torch.models.system import SystemRule


def _loads(source) -> list:
    if source is None:
        return []
    data = json.loads(source) if isinstance(source, str) else source
    if data is None:
        return []
    if not isinstance(data, list):
        raise ValueError("expected a JSON array of rules")
    return data


# -- staged rollout tags (rollout/) ------------------------------------------
# ``candidateSet`` names the candidate ruleset a rule belongs to (evaluated
# in shadow lanes instead of enforced); ``rolloutStage`` ("shadow" |
# "canary") is the stage a datasource-tagged candidate starts in.

def _rollout_fields(d: dict) -> dict:
    out = {}
    cs = d.get("candidateSet")
    if cs:
        out["candidate_set"] = str(cs)
    rs = d.get("rolloutStage")
    if rs:
        out["rollout_stage"] = str(rs)
    return out


def _emit_rollout(d: dict, r) -> dict:
    if getattr(r, "candidate_set", None):
        d["candidateSet"] = r.candidate_set
    if getattr(r, "rollout_stage", None):
        d["rolloutStage"] = r.rollout_stage
    return d


# -- flow -------------------------------------------------------------------

def flow_rule_from_dict(d: dict) -> FlowRule:
    return FlowRule(
        resource=d.get("resource", ""),
        count=float(d.get("count", 0)),
        grade=int(d.get("grade", C.FLOW_GRADE_QPS)),
        limit_app=d.get("limitApp") or C.LIMIT_APP_DEFAULT,
        strategy=int(d.get("strategy", C.FLOW_STRATEGY_DIRECT)),
        ref_resource=d.get("refResource"),
        control_behavior=int(d.get("controlBehavior",
                                   C.CONTROL_BEHAVIOR_DEFAULT)),
        warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
        max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
        cluster_mode=bool(d.get("clusterMode", False)),
        cluster_config=d.get("clusterConfig"),
        derived_from=d.get("derivedFrom"),
        **_rollout_fields(d),
    )


def flow_rule_to_dict(r: FlowRule) -> dict:
    d = {
        "resource": r.resource, "limitApp": r.limit_app, "grade": r.grade,
        "count": r.count, "strategy": r.strategy,
        "controlBehavior": r.control_behavior,
        "warmUpPeriodSec": r.warm_up_period_sec,
        "maxQueueingTimeMs": r.max_queueing_time_ms,
        "clusterMode": r.cluster_mode,
    }
    if r.ref_resource:
        d["refResource"] = r.ref_resource
    if r.cluster_config:
        d["clusterConfig"] = r.cluster_config
    if getattr(r, "derived_from", None):
        d["derivedFrom"] = r.derived_from
    return _emit_rollout(d, r)


def flow_rules_from_json(source) -> List[FlowRule]:
    return [flow_rule_from_dict(d) for d in _loads(source)]


def flow_rules_to_json(rules: List[FlowRule]) -> str:
    return json.dumps([flow_rule_to_dict(r) for r in rules])


# -- tps (llm/: LLM token-budget admission) ----------------------------------
# Per-(model, tenant) tokens-per-second budgets with optional burst
# headroom and a concurrent-stream cap; the engine lowers a load onto flow
# rules (llm/rules.py).

def tps_rule_from_dict(d: dict):
    from sentinel_tpu_torch.llm.rules import TpsRule

    return TpsRule(
        model=d.get("model", ""),
        tokens_per_second=float(d.get("tokensPerSecond", 0)),
        burst_tokens=float(d.get("burstTokens", 0)),
        tenant=d.get("tenant") or C.LIMIT_APP_DEFAULT,
        max_concurrent_streams=int(d.get("maxConcurrentStreams", 0)),
        cluster_mode=bool(d.get("clusterMode", False)),
        cluster_config=d.get("clusterConfig"),
        **_rollout_fields(d),
    )


def tps_rule_to_dict(r) -> dict:
    d = {
        "model": r.model, "tenant": r.tenant,
        "tokensPerSecond": r.tokens_per_second,
        "burstTokens": r.burst_tokens,
        "maxConcurrentStreams": r.max_concurrent_streams,
        "clusterMode": r.cluster_mode,
    }
    if r.cluster_config:
        d["clusterConfig"] = r.cluster_config
    return _emit_rollout(d, r)


def tps_rules_from_json(source) -> list:
    return [tps_rule_from_dict(d) for d in _loads(source)]


def tps_rules_to_json(rules) -> str:
    return json.dumps([tps_rule_to_dict(r) for r in rules])


# -- degrade ----------------------------------------------------------------

def degrade_rule_from_dict(d: dict) -> DegradeRule:
    return DegradeRule(
        resource=d.get("resource", ""),
        count=float(d.get("count", 0)),
        grade=int(d.get("grade", C.DEGRADE_GRADE_RT)),
        time_window=int(d.get("timeWindow", 0)),
        slow_ratio_threshold=float(
            d.get("slowRatioThreshold", C.DEGRADE_DEFAULT_SLOW_RATIO_THRESHOLD)),
        min_request_amount=int(
            d.get("minRequestAmount", C.DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT)),
        stat_interval_ms=int(
            d.get("statIntervalMs", C.DEGRADE_DEFAULT_STAT_INTERVAL_MS)),
        limit_app=d.get("limitApp") or C.LIMIT_APP_DEFAULT,
        **_rollout_fields(d),
    )


def degrade_rule_to_dict(r: DegradeRule) -> dict:
    return _emit_rollout({
        "resource": r.resource, "limitApp": r.limit_app, "grade": r.grade,
        "count": r.count, "timeWindow": r.time_window,
        "slowRatioThreshold": r.slow_ratio_threshold,
        "minRequestAmount": r.min_request_amount,
        "statIntervalMs": r.stat_interval_ms,
    }, r)


def degrade_rules_from_json(source) -> List[DegradeRule]:
    return [degrade_rule_from_dict(d) for d in _loads(source)]


def degrade_rules_to_json(rules: List[DegradeRule]) -> str:
    return json.dumps([degrade_rule_to_dict(r) for r in rules])


# -- system -----------------------------------------------------------------

def system_rule_from_dict(d: dict) -> SystemRule:
    def g(key):
        v = d.get(key, -1)
        return float(v) if v is not None else -1.0

    return SystemRule(
        highest_system_load=g("highestSystemLoad"),
        highest_cpu_usage=g("highestCpuUsage"),
        qps=g("qps"),
        max_thread=g("maxThread"),
        avg_rt=g("avgRt"),
        **_rollout_fields(d),
    )


def system_rule_to_dict(r: SystemRule) -> dict:
    return _emit_rollout({
        "highestSystemLoad": r.highest_system_load,
        "highestCpuUsage": r.highest_cpu_usage,
        "qps": r.qps, "maxThread": r.max_thread, "avgRt": r.avg_rt,
    }, r)


def system_rules_from_json(source) -> List[SystemRule]:
    return [system_rule_from_dict(d) for d in _loads(source)]


def system_rules_to_json(rules: List[SystemRule]) -> str:
    return json.dumps([system_rule_to_dict(r) for r in rules])


# -- authority --------------------------------------------------------------

def authority_rule_from_dict(d: dict) -> AuthorityRule:
    return AuthorityRule(
        resource=d.get("resource", ""),
        limit_app=d.get("limitApp", ""),
        strategy=int(d.get("strategy", C.AUTHORITY_WHITE)),
        **_rollout_fields(d),
    )


def authority_rule_to_dict(r: AuthorityRule) -> dict:
    return _emit_rollout({"resource": r.resource, "limitApp": r.limit_app,
                          "strategy": r.strategy}, r)


def authority_rules_from_json(source) -> List[AuthorityRule]:
    return [authority_rule_from_dict(d) for d in _loads(source)]


def authority_rules_to_json(rules: List[AuthorityRule]) -> str:
    return json.dumps([authority_rule_to_dict(r) for r in rules])


# -- param flow -------------------------------------------------------------

_CLASS_TYPES = {
    "int": int, "Integer": int, "long": int, "Long": int,
    "double": float, "Double": float, "float": float, "Float": float,
    "String": str, "java.lang.String": str, "boolean": bool, "Boolean": bool,
}


def _java_class_type(obj) -> str:
    """The reference's classType names, so round-trips (and reference
    tooling) re-type item objects correctly. bool before int: Python
    bools are ints."""
    if isinstance(obj, bool):
        return "boolean"
    if isinstance(obj, int):
        return "long"
    if isinstance(obj, float):
        return "double"
    return "String"


def _coerce_item_object(obj, class_type: Optional[str]):
    """Items arrive as (object-as-string, classType); re-type here so the
    host param hash matches the values seen at entry time."""
    if class_type is None:
        return obj
    py = _CLASS_TYPES.get(class_type)
    if py is None:
        return obj
    if py is bool and isinstance(obj, str):
        return obj.lower() == "true"
    try:
        return py(obj)
    except (TypeError, ValueError):
        return obj


def param_rule_from_dict(d: dict) -> ParamFlowRule:
    items = []
    for it in d.get("paramFlowItemList") or []:
        items.append(ParamFlowItem(
            object=_coerce_item_object(it.get("object"), it.get("classType")),
            count=float(it.get("count", 0)),
        ))
    return ParamFlowRule(
        resource=d.get("resource", ""),
        param_idx=int(d.get("paramIdx", 0)),
        count=float(d.get("count", 0)),
        grade=int(d.get("grade", C.PARAM_FLOW_GRADE_QPS)),
        duration_in_sec=int(d.get("durationInSec", 1)),
        burst_count=int(d.get("burstCount", 0)),
        control_behavior=int(d.get("controlBehavior",
                                   C.CONTROL_BEHAVIOR_DEFAULT)),
        max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 0)),
        items=items,
        cluster_mode=bool(d.get("clusterMode", False)),
        cluster_config=d.get("clusterConfig"),
        **_rollout_fields(d),
    )


def param_rule_to_dict(r: ParamFlowRule) -> dict:
    d = {
        "resource": r.resource, "paramIdx": r.param_idx, "grade": r.grade,
        "count": r.count, "durationInSec": r.duration_in_sec,
        "burstCount": r.burst_count, "controlBehavior": r.control_behavior,
        "maxQueueingTimeMs": r.max_queueing_time_ms,
        "clusterMode": r.cluster_mode,
    }
    if r.items:
        d["paramFlowItemList"] = [
            {
                "object": str(it.object),
                "classType": _java_class_type(it.object),
                "count": it.count,
            }
            for it in r.items
        ]
    if r.cluster_config:
        d["clusterConfig"] = r.cluster_config
    return _emit_rollout(d, r)


def param_rules_from_json(source) -> List[ParamFlowRule]:
    return [param_rule_from_dict(d) for d in _loads(source)]


def param_rules_to_json(rules: List[ParamFlowRule]) -> str:
    return json.dumps([param_rule_to_dict(r) for r in rules])


# -- cluster map (cluster/ha.py — datasource-driven leader assignment) ------
#
# The HA analog of the reference's cluster-assign config: one JSON object
# naming the leadership epoch, the ordered token-server seats (leader
# first) and the client membership that sizes the degraded-quota share.
#
#     {"epoch": 3, "namespace": "default",
#      "servers": [{"machineId": "node-a", "host": "10.0.0.1", "port": 18730},
#                  {"machineId": "node-b", "host": "10.0.0.2", "port": 18730}],
#      "clients": ["node-c", "node-d"],
#      "leader": "node-a",            // optional; default servers[0]
#      "requestTimeoutMs": 2000}      // optional
#
# Push it through any datasource with ``cluster_map_from_json`` as the
# converter and hand the property to ``ClusterHAManager.watch``.


def cluster_map_from_dict(d: dict) -> "object":
    from sentinel_tpu_torch.cluster.ha import ClusterMap, ClusterServerSpec

    if not isinstance(d, dict):
        raise ValueError("cluster map must be a JSON object")
    try:
        epoch = int(d.get("epoch", 0))
    except (TypeError, ValueError):
        raise ValueError(f"cluster map epoch {d.get('epoch')!r} not an int")
    raw_servers = d.get("servers")
    if not isinstance(raw_servers, list) or not raw_servers:
        raise ValueError("cluster map needs a non-empty 'servers' list")
    servers = []
    for s in raw_servers:
        if not isinstance(s, dict) or not s.get("machineId") \
                or not s.get("host"):
            raise ValueError(f"bad cluster map server entry: {s!r}")
        try:
            port = int(s["port"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"bad cluster map server port in: {s!r}")
        servers.append(ClusterServerSpec(str(s["machineId"]),
                                         str(s["host"]), port))
    leader = d.get("leader")
    if leader:
        ordered = [s for s in servers if s.machine_id == str(leader)]
        if not ordered:
            raise ValueError(
                f"cluster map leader {leader!r} not in the servers list")
        ordered += [s for s in servers if s.machine_id != str(leader)]
        servers = ordered
    raw_clients = d.get("clients") or []
    if not isinstance(raw_clients, (list, tuple)):
        # A bare string would iterate character-wise into a silently
        # wrong degraded-quota divisor — reject like every other field.
        raise ValueError(
            f"cluster map 'clients' must be a list, got {raw_clients!r}")
    clients = tuple(str(c) for c in raw_clients)
    try:
        timeout_ms = int(d.get("requestTimeoutMs", 2000))
    except (TypeError, ValueError):
        timeout_ms = 2000
    return ClusterMap(epoch=epoch, servers=tuple(servers), clients=clients,
                      namespace=str(d.get("namespace") or "default"),
                      request_timeout_ms=max(1, timeout_ms))


def cluster_map_from_json(source) -> "object":
    data = json.loads(source) if isinstance(source, str) else source
    return cluster_map_from_dict(data)


def cluster_map_to_dict(m) -> dict:
    return {
        "epoch": m.epoch,
        "namespace": m.namespace,
        "servers": [{"machineId": s.machine_id, "host": s.host,
                     "port": s.port} for s in m.servers],
        "clients": list(m.clients),
        "requestTimeoutMs": m.request_timeout_ms,
    }


# -- shard maps (cluster/sharding.py — sharded multi-leader) ---------------
#
#     {"version": 4, "nSlices": 64, "namespace": "default",
#      "servers": [{"machineId": "a", "host": "10.0.0.1", "port": 18730},
#                  {"machineId": "b", "host": "10.0.0.2", "port": 18730}],
#      "sliceOwners": {"a": [0, 1, ...], "b": [32, 33, ...]},
#      "sliceEpochs": {"0": 4, "32": 7},   // optional; absent -> version
#      "clients": ["node-c"],
#      "requestTimeoutMs": 2000}
#
# ``sliceOwners`` must cover every slice exactly once; ``sliceEpochs``
# defaults each slice's fencing term to the map version (correct but
# coarse — a rebalance SHOULD bump only the moved slices' epochs so
# standing leaders' in-flight replies stay honest). Push through any
# datasource with ``shard_map_from_json`` and hand the property to
# ``ClusterHAManager.watch`` — apply_map dispatches on the map type.


def shard_map_from_dict(d: dict) -> "object":
    from sentinel_tpu_torch.cluster.ha import ClusterServerSpec
    from sentinel_tpu_torch.cluster.sharding import ShardMap
    from sentinel_tpu_torch.core.config import config as _cfg

    if not isinstance(d, dict):
        raise ValueError("shard map must be a JSON object")
    try:
        version = int(d.get("version", 0))
    except (TypeError, ValueError):
        raise ValueError(f"shard map version {d.get('version')!r} not an int")
    try:
        n_slices = int(d.get("nSlices", _cfg.cluster_shard_slices()))
    except (TypeError, ValueError):
        raise ValueError(f"shard map nSlices {d.get('nSlices')!r} not an int")
    if n_slices <= 0:
        raise ValueError(f"shard map nSlices must be positive: {n_slices}")
    raw_servers = d.get("servers")
    if not isinstance(raw_servers, list) or not raw_servers:
        raise ValueError("shard map needs a non-empty 'servers' list")
    servers = []
    for s in raw_servers:
        if not isinstance(s, dict) or not s.get("machineId") \
                or not s.get("host"):
            raise ValueError(f"bad shard map server entry: {s!r}")
        try:
            port = int(s["port"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"bad shard map server port in: {s!r}")
        servers.append(ClusterServerSpec(str(s["machineId"]),
                                         str(s["host"]), port))
    known = {s.machine_id for s in servers}
    raw_owners = d.get("sliceOwners")
    owner = [None] * n_slices
    if isinstance(raw_owners, dict):
        for mid, slist in raw_owners.items():
            if str(mid) not in known:
                raise ValueError(
                    f"sliceOwners names unknown server {mid!r}")
            if not isinstance(slist, (list, tuple)):
                raise ValueError(
                    f"sliceOwners[{mid!r}] must be a list of slice ids")
            for sl in slist:
                try:
                    sl = int(sl)
                except (TypeError, ValueError):
                    raise ValueError(f"bad slice id {sl!r} for {mid!r}")
                if not 0 <= sl < n_slices:
                    raise ValueError(
                        f"slice {sl} out of ring [0, {n_slices})")
                if owner[sl] is not None:
                    raise ValueError(f"slice {sl} assigned twice")
                owner[sl] = str(mid)
    elif isinstance(raw_owners, list):
        if len(raw_owners) != n_slices:
            raise ValueError(
                f"sliceOwners list has {len(raw_owners)} entries, "
                f"ring has {n_slices}")
        for sl, mid in enumerate(raw_owners):
            if str(mid) not in known:
                raise ValueError(
                    f"sliceOwners[{sl}] names unknown server {mid!r}")
            owner[sl] = str(mid)
    else:
        raise ValueError("shard map needs 'sliceOwners' (dict or list)")
    missing = [i for i, m in enumerate(owner) if m is None]
    if missing:
        raise ValueError(
            f"{len(missing)} slice(s) unowned (first: {missing[:5]}) — "
            "every slice needs exactly one owner")
    raw_epochs = d.get("sliceEpochs")
    epochs = [version] * n_slices
    if raw_epochs is not None:
        if isinstance(raw_epochs, dict):
            for sl, ep in raw_epochs.items():
                try:
                    sl, ep = int(sl), int(ep)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"bad sliceEpochs entry {sl!r}: {ep!r}")
                if not 0 <= sl < n_slices:
                    raise ValueError(
                        f"sliceEpochs slice {sl} out of ring [0, {n_slices})")
                epochs[sl] = ep
        elif isinstance(raw_epochs, list):
            if len(raw_epochs) != n_slices:
                raise ValueError(
                    f"sliceEpochs list has {len(raw_epochs)} entries, "
                    f"ring has {n_slices}")
            try:
                epochs = [int(e) for e in raw_epochs]
            except (TypeError, ValueError):
                raise ValueError("sliceEpochs entries must be ints")
        else:
            raise ValueError("'sliceEpochs' must be a dict or list")
    raw_clients = d.get("clients") or []
    if not isinstance(raw_clients, (list, tuple)):
        raise ValueError(
            f"shard map 'clients' must be a list, got {raw_clients!r}")
    try:
        timeout_ms = int(d.get("requestTimeoutMs", 2000))
    except (TypeError, ValueError):
        timeout_ms = 2000
    return ShardMap(
        version=version, n_slices=n_slices, servers=tuple(servers),
        slice_owner=tuple(owner), slice_epoch=tuple(epochs),
        clients=tuple(str(c) for c in raw_clients),
        namespace=str(d.get("namespace") or "default"),
        request_timeout_ms=max(1, timeout_ms))


def shard_map_from_json(source) -> "object":
    data = json.loads(source) if isinstance(source, str) else source
    return shard_map_from_dict(data)


def shard_map_to_dict(m) -> dict:
    owners: dict = {}
    for sl, mid in enumerate(m.slice_owner):
        owners.setdefault(mid, []).append(sl)
    return {
        "version": m.version,
        "nSlices": m.n_slices,
        "namespace": m.namespace,
        "servers": [{"machineId": s.machine_id, "host": s.host,
                     "port": s.port} for s in m.servers],
        "sliceOwners": owners,
        "sliceEpochs": {str(i): int(e)
                        for i, e in enumerate(m.slice_epoch)},
        "clients": list(m.clients),
        "requestTimeoutMs": m.request_timeout_ms,
    }


def any_cluster_map_from_json(source) -> "object":
    """Converter accepting EITHER map flavor (the standalone
    participant's file watcher): a ``sliceOwners`` key selects the
    shard-map schema, anything else parses as a plain cluster map."""
    data = json.loads(source) if isinstance(source, str) else source
    if isinstance(data, dict) and "sliceOwners" in data:
        return shard_map_from_dict(data)
    return cluster_map_from_dict(data)


# -- SLO objectives (slo/ — datasource-driven judgement) --------------------
#
# The ``sloRules`` converter: one JSON array of objective objects, pushed
# through any datasource (file/Redis/HTTP/push) with
# ``slo_objectives_from_json`` as the converter and
# ``engine.slo.load_objectives`` as the sink, so objectives hot-reload
# exactly like flow rules. Absent fields take the shipped defaults
# (docs/OPERATIONS.md "SLOs & alerting" has the full schema + window
# table):
#
#     [{"resource": "getUser", "sli": "availability", "objective": 0.999,
#       "minEvents": 10,
#       "windows": [{"longSeconds": 60, "shortSeconds": 5,
#                    "burnRate": 14.4, "severity": "page"},
#                   {"longSeconds": 300, "shortSeconds": 60,
#                    "burnRate": 6, "severity": "ticket"}]},
#      {"resource": "getUser", "sli": "latency", "objective": 0.99,
#       "latencyMs": 64, "name": "getUser-rt"}]


def slo_objective_from_dict(d: dict) -> "object":
    from sentinel_tpu_torch.slo.objectives import (
        BurnWindow, DEFAULT_BURN_WINDOWS, DEFAULT_MIN_EVENTS, SloObjective)

    if not isinstance(d, dict):
        raise ValueError(f"SLO objective must be a JSON object, got {d!r}")
    raw_windows = d.get("windows")
    if raw_windows is None:
        windows = DEFAULT_BURN_WINDOWS
    else:
        if not isinstance(raw_windows, list) or not raw_windows:
            raise ValueError(
                f"'windows' must be a non-empty list, got {raw_windows!r}")
        windows = tuple(
            BurnWindow(
                long_s=int(w.get("longSeconds", 0)),
                short_s=int(w.get("shortSeconds", 0)),
                burn=float(w.get("burnRate", 0)),
                severity=str(w.get("severity", "page")),
            )
            for w in raw_windows
        )
    return SloObjective(
        resource=str(d.get("resource", "")),
        sli=str(d.get("sli", "availability")),
        objective=float(d.get("objective", 0.99)),
        latency_ms=int(d.get("latencyMs", 256)),
        min_events=int(d.get("minEvents", DEFAULT_MIN_EVENTS)),
        windows=windows,
        name=str(d.get("name", "")),
    ).validate()


def slo_objective_to_dict(o) -> dict:
    d = {
        "resource": o.resource,
        "sli": o.sli,
        "objective": o.objective,
        "minEvents": o.min_events,
        "windows": [{"longSeconds": w.long_s, "shortSeconds": w.short_s,
                     "burnRate": w.burn, "severity": w.severity}
                    for w in o.windows],
    }
    if o.sli == "latency":
        d["latencyMs"] = o.latency_ms
        # What the RT histogram actually enforces (log2 bucket edges).
        d["effectiveLatencyMs"] = o.snapped_latency_ms
    if o.name:
        d["name"] = o.name
    return d


def slo_objectives_from_json(source) -> List["object"]:
    return [slo_objective_from_dict(d) for d in _loads(source)]


def slo_objectives_to_json(objectives) -> str:
    return json.dumps([slo_objective_to_dict(o) for o in objectives])


# -- adaptive targets (adaptive/ — closed-loop limiting) --------------------
#
# The ``adaptiveTargets`` converter: one JSON array of target objects,
# pushed through any datasource with ``adaptive_targets_from_json`` as
# the converter and ``engine.adaptive.load_targets`` as the sink (the
# ``adaptive`` command's ``op=set`` shares the schema). Absent fields
# take the dataclass defaults (docs/OPERATIONS.md "Adaptive limiting"):
#
#     [{"resource": "getUser", "maxBlockRate": 0.05, "rtP99Ms": 250,
#       "floor": 50, "ceiling": 5000, "minEntries": 32}]


def adaptive_target_from_dict(d: dict) -> "object":
    from sentinel_tpu_torch.adaptive.controller import (
        DEFAULT_MIN_ENTRIES, AdaptiveTarget)

    if not isinstance(d, dict):
        raise ValueError(f"adaptive target must be a JSON object, got {d!r}")
    defaults = AdaptiveTarget(resource="_")
    return AdaptiveTarget(
        resource=str(d.get("resource", "")),
        max_block_rate=float(d.get("maxBlockRate",
                                   defaults.max_block_rate)),
        rt_p99_ms=float(d.get("rtP99Ms", defaults.rt_p99_ms)),
        floor=float(d.get("floor", defaults.floor)),
        ceiling=float(d.get("ceiling", defaults.ceiling)),
        min_entries=int(d.get("minEntries", DEFAULT_MIN_ENTRIES)),
    ).validate()


def adaptive_target_to_dict(t) -> dict:
    return {
        "resource": t.resource,
        "maxBlockRate": t.max_block_rate,
        "rtP99Ms": t.rt_p99_ms,
        "floor": t.floor,
        "ceiling": t.ceiling,
        "minEntries": t.min_entries,
    }


def adaptive_targets_from_json(source) -> List["object"]:
    return [adaptive_target_from_dict(d) for d in _loads(source)]


def adaptive_targets_to_json(targets) -> str:
    return json.dumps([adaptive_target_to_dict(t) for t in targets])
