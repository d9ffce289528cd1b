"""API-gateway common layer (reference:
``sentinel-api-gateway-adapter-common`` — ``GatewayFlowRule`` /
``GatewayParamFlowItem`` / ``GatewayRuleManager`` (conversion to param-flow
rules) / ``api/ApiDefinition`` + ``GatewayApiDefinitionManager`` /
``param/GatewayParamParser`` — SURVEY.md §2.5).

Gateway rules are enforced through the hot-param machinery: every gateway
rule on a resource gets an assigned param index; rules without a param item
match a generated constant value, and pattern-bearing items rewrite
non-matching values to a pass-through sentinel with an unlimited per-value
item — exactly the reference's conversion trick.

Port of ``sentinel_tpu/adapters/gateway.py``. Gateway rules reach the
engine's param slots: on the card, a gateway entry runs the param rule's
K=1 segmented prefix (``csrc/segmented_prefix.cu``) in whichever step
decides it.
"""

from __future__ import annotations

import json
import re
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import MAX_PARAMS
from sentinel_tpu_torch.models.param_flow import ParamFlowItem, ParamFlowRule

# resourceMode
RESOURCE_MODE_ROUTE_ID = 0
RESOURCE_MODE_CUSTOM_API_NAME = 1

# parseStrategy
PARAM_PARSE_STRATEGY_CLIENT_IP = 0
PARAM_PARSE_STRATEGY_HOST = 1
PARAM_PARSE_STRATEGY_HEADER = 2
PARAM_PARSE_STRATEGY_URL_PARAM = 3
PARAM_PARSE_STRATEGY_COOKIE = 4

# matchStrategy (URL + param patterns)
PARAM_MATCH_STRATEGY_EXACT = 0
PARAM_MATCH_STRATEGY_PREFIX = 1
PARAM_MATCH_STRATEGY_REGEX = 2
PARAM_MATCH_STRATEGY_CONTAINS = 3

# Generated parser constants (reference: SentinelGatewayConstants).
GATEWAY_DEFAULT_PARAM = "$D"       # rules without a param item
GATEWAY_NOT_MATCH_PARAM = "$NM"    # pattern miss -> pass-through value
NOT_MATCH_PASS_COUNT = 1e9


@dataclass
class GatewayParamFlowItem:
    parse_strategy: int = PARAM_PARSE_STRATEGY_CLIENT_IP
    field_name: Optional[str] = None
    pattern: Optional[str] = None
    match_strategy: int = PARAM_MATCH_STRATEGY_EXACT


@dataclass
class GatewayFlowRule:
    resource: str
    count: float
    resource_mode: int = RESOURCE_MODE_ROUTE_ID
    grade: int = C.PARAM_FLOW_GRADE_QPS
    interval_sec: int = 1
    control_behavior: int = C.CONTROL_BEHAVIOR_DEFAULT
    burst: int = 0
    max_queueing_timeout_ms: int = 500
    param_item: Optional[GatewayParamFlowItem] = None

    def is_valid(self) -> bool:
        return bool(self.resource) and self.count >= 0 and self.interval_sec > 0


@dataclass
class ApiPredicateItem:
    pattern: str
    match_strategy: int = PARAM_MATCH_STRATEGY_EXACT


@dataclass
class ApiDefinition:
    api_name: str
    predicate_items: List[ApiPredicateItem] = field(default_factory=list)


@dataclass
class GatewayRequest:
    """The transport-agnostic request view the param parser reads."""

    path: str = "/"
    client_ip: str = ""
    host: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    params: Dict[str, str] = field(default_factory=dict)
    cookies: Dict[str, str] = field(default_factory=dict)
    route: Optional[str] = None


def _matches(pattern: str, strategy: int, value: str) -> bool:
    if strategy == PARAM_MATCH_STRATEGY_PREFIX:
        return value.startswith(pattern)
    if strategy == PARAM_MATCH_STRATEGY_REGEX:
        return re.fullmatch(pattern, value) is not None
    if strategy == PARAM_MATCH_STRATEGY_CONTAINS:
        return pattern in value
    return value == pattern


class GatewayApiDefinitionManager:
    """Custom API groups (reference: ``GatewayApiDefinitionManager``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._apis: Dict[str, ApiDefinition] = {}

    def load_api_definitions(self, defs: Sequence[ApiDefinition]) -> None:
        with self._lock:
            self._apis = {d.api_name: d for d in defs if d.api_name}

    def get_api_definitions(self) -> List[ApiDefinition]:
        with self._lock:
            return list(self._apis.values())

    def matching_apis(self, path: str) -> List[str]:
        with self._lock:
            apis = list(self._apis.values())
        return [
            a.api_name for a in apis
            if any(_matches(p.pattern, p.match_strategy, path)
                   for p in a.predicate_items)
        ]


class GatewayRuleManager:
    """Converts gateway rules to param-flow rules (``GatewayRuleManager``).

    Each gateway rule on a resource is assigned a param index (capped by the
    batch's MAX_PARAMS); the parser emits the matching argument vector.
    """

    def __init__(self, engine=None, _weak_engine=None):
        self._engine = engine
        self._engine_ref = _weak_engine  # weakref.ref (managers_for)
        self._lock = threading.Lock()
        self._rules: List[GatewayFlowRule] = []
        # resource -> [(gateway_rule, param_idx)]
        self._by_resource: Dict[str, List[Tuple[GatewayFlowRule, int]]] = {}

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        if self._engine_ref is not None:
            eng = self._engine_ref()
            if eng is not None:
                return eng
        return st.get_engine()

    def load_rules(self, rules: Sequence[GatewayFlowRule]) -> None:
        by_resource: Dict[str, List[Tuple[GatewayFlowRule, int]]] = {}
        param_rules: List[ParamFlowRule] = []
        enforced: List[GatewayFlowRule] = []
        dropped = 0
        for r in rules:
            if not r.is_valid():
                continue
            assigned = by_resource.setdefault(r.resource, [])
            idx = len(assigned)
            if idx >= MAX_PARAMS:
                dropped += 1
                continue
            assigned.append((r, idx))
            enforced.append(r)
            items = []
            if r.param_item is not None and r.param_item.pattern is not None:
                # Pattern miss rewrites to $NM, which passes unlimited.
                items.append(ParamFlowItem(GATEWAY_NOT_MATCH_PARAM,
                                           NOT_MATCH_PASS_COUNT))
            param_rules.append(ParamFlowRule(
                resource=r.resource,
                param_idx=idx,
                count=r.count,
                grade=r.grade,
                duration_in_sec=r.interval_sec,
                burst_count=r.burst,
                control_behavior=r.control_behavior,
                max_queueing_time_ms=r.max_queueing_timeout_ms,
                items=items,
            ))
        with self._lock:
            # Engine push inside the critical section: the parser's index
            # map and the enforced rule set must publish atomically, and
            # get_rules() only reports rules that are actually enforced.
            self._rules = enforced
            self._by_resource = by_resource
            self.engine.param_rules.load_gateway_rules(param_rules)
        if dropped:
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn(
                "gateway: %d rules beyond %d per resource dropped",
                dropped, MAX_PARAMS)

    def get_rules(self) -> List[GatewayFlowRule]:
        with self._lock:
            return list(self._rules)

    # -- param parsing (reference: GatewayParamParser) ---------------------

    def parse_parameters(self, resource: str, request: GatewayRequest) -> Tuple:
        with self._lock:
            assigned = list(self._by_resource.get(resource, ()))
        args: List[str] = [""] * len(assigned)
        for rule, idx in assigned:
            item = rule.param_item
            if item is None:
                value = GATEWAY_DEFAULT_PARAM
            else:
                s = item.parse_strategy
                if s == PARAM_PARSE_STRATEGY_CLIENT_IP:
                    value = request.client_ip
                elif s == PARAM_PARSE_STRATEGY_HOST:
                    value = request.host
                elif s == PARAM_PARSE_STRATEGY_HEADER:
                    value = request.headers.get(item.field_name or "", "")
                elif s == PARAM_PARSE_STRATEGY_URL_PARAM:
                    value = request.params.get(item.field_name or "", "")
                elif s == PARAM_PARSE_STRATEGY_COOKIE:
                    value = request.cookies.get(item.field_name or "", "")
                else:
                    value = ""
                if item.pattern is not None and not _matches(
                        item.pattern, item.match_strategy, value):
                    value = GATEWAY_NOT_MATCH_PARAM
            args[idx] = value
        return tuple(args)


_default_api_manager = GatewayApiDefinitionManager()
_default_rule_manager: Optional[GatewayRuleManager] = None


def get_api_manager() -> GatewayApiDefinitionManager:
    return _default_api_manager


_default_rule_manager_lock = threading.Lock()


def get_gateway_rule_manager() -> GatewayRuleManager:
    global _default_rule_manager
    if _default_rule_manager is None:
        # locked: two racing first touches must not split enforcement
        # and reporting across two manager instances
        with _default_rule_manager_lock:
            if _default_rule_manager is None:
                _default_rule_manager = GatewayRuleManager()
    return _default_rule_manager


_engine_managers: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_engine_managers_lock = threading.Lock()


def managers_for(engine) -> Tuple[GatewayRuleManager,
                                  GatewayApiDefinitionManager]:
    """Gateway managers scoped to ``engine``: the module defaults when it
    IS the current default engine (so ops-plane pushes and
    ``gateway_entry``'s default managers share state), else a per-engine
    memoized pair — a command center bound to a non-default engine must
    not silently load rules into the default one.

    The pair holds only a WEAK reference to the engine (a strong one in
    the value would pin the WeakKeyDictionary key forever, leaking every
    short-lived engine), and the check-then-insert is locked so two
    racing first-touch commands can't split enforcement and reporting
    across different manager pairs."""
    if engine is st.get_engine():
        return get_gateway_rule_manager(), _default_api_manager
    with _engine_managers_lock:
        pair = _engine_managers.get(engine)
        if pair is None:
            pair = (GatewayRuleManager(_weak_engine=weakref.ref(engine)),
                    GatewayApiDefinitionManager())
            _engine_managers[engine] = pair
    return pair


def gateway_entry(request: GatewayRequest,
                  rule_manager: Optional[GatewayRuleManager] = None,
                  api_manager: Optional[GatewayApiDefinitionManager] = None):
    """Enter all gateway resources a request maps to: its route id plus any
    matching custom API groups. Returns the live entries (exit in reverse);
    raises BlockException if any resource rejects (already-taken entries are
    exited first, reference filter semantics).
    """
    rm = rule_manager or get_gateway_rule_manager()
    am = api_manager or _default_api_manager
    resources = []
    if request.route:
        resources.append(request.route)
    resources.extend(am.matching_apis(request.path))
    entries = []
    try:
        for resource in resources:
            args = rm.parse_parameters(resource, request)
            entries.append(st.entry(
                resource, entry_type=C.EntryType.IN, args=args))
    except Exception:
        for e in reversed(entries):
            e.exit()
        raise
    return entries


# -- JSON wire schema (reference fastjson camelCase field names, so
# dashboard payloads written for the reference parse unchanged) ------------


def gateway_rule_from_dict(d: dict) -> GatewayFlowRule:
    item = d.get("paramItem")
    return GatewayFlowRule(
        resource=d.get("resource", ""),
        count=float(d.get("count", 0)),
        resource_mode=int(d.get("resourceMode", RESOURCE_MODE_ROUTE_ID)),
        grade=int(d.get("grade", C.PARAM_FLOW_GRADE_QPS)),
        interval_sec=int(d.get("intervalSec", 1)),
        control_behavior=int(d.get("controlBehavior",
                                   C.CONTROL_BEHAVIOR_DEFAULT)),
        burst=int(d.get("burst", 0)),
        max_queueing_timeout_ms=int(d.get("maxQueueingTimeoutMs", 500)),
        param_item=None if item is None else GatewayParamFlowItem(
            parse_strategy=int(item.get("parseStrategy",
                                        PARAM_PARSE_STRATEGY_CLIENT_IP)),
            field_name=item.get("fieldName"),
            pattern=item.get("pattern"),
            match_strategy=int(item.get("matchStrategy",
                                        PARAM_MATCH_STRATEGY_EXACT)),
        ),
    )


def gateway_rule_to_dict(r: GatewayFlowRule) -> dict:
    out = {
        "resource": r.resource, "resourceMode": r.resource_mode,
        "grade": r.grade, "count": r.count, "intervalSec": r.interval_sec,
        "controlBehavior": r.control_behavior, "burst": r.burst,
        "maxQueueingTimeoutMs": r.max_queueing_timeout_ms,
    }
    if r.param_item is not None:
        out["paramItem"] = {
            "parseStrategy": r.param_item.parse_strategy,
            "fieldName": r.param_item.field_name,
            "pattern": r.param_item.pattern,
            "matchStrategy": r.param_item.match_strategy,
        }
    return out


def gateway_rules_from_json(source) -> List[GatewayFlowRule]:
    data = json.loads(source) if isinstance(source, str) else (source or [])
    return [gateway_rule_from_dict(d) for d in data]


def gateway_rules_to_json(rules: Sequence[GatewayFlowRule]) -> str:
    return json.dumps([gateway_rule_to_dict(r) for r in rules])


def api_definitions_from_json(source) -> List[ApiDefinition]:
    data = json.loads(source) if isinstance(source, str) else (source or [])
    return [
        ApiDefinition(
            api_name=d.get("apiName", ""),
            predicate_items=[
                ApiPredicateItem(
                    pattern=p.get("pattern", ""),
                    match_strategy=int(p.get("matchStrategy",
                                             PARAM_MATCH_STRATEGY_EXACT)))
                for p in (d.get("predicateItems") or [])
            ])
        for d in data
    ]


def api_definition_to_dict(a: ApiDefinition) -> dict:
    return {"apiName": a.api_name,
            "predicateItems": [{"pattern": p.pattern,
                                "matchStrategy": p.match_strategy}
                               for p in a.predicate_items]}


def api_definitions_to_json(defs: Sequence[ApiDefinition]) -> str:
    return json.dumps([api_definition_to_dict(a) for a in defs])
