"""TPS rules: per-(model, tenant) weighted-cost limits, lowered onto flow
(port of ``sentinel_tpu/llm/rules.py``).

``TpsRule`` limits *tokens* per second for one model (optionally one
tenant): ``tokensPerSecond`` steady-state budget, ``burstTokens`` extra
headroom inside the 1s window, ``maxConcurrentStreams`` an optional cap
on simultaneously-open streaming reservations.

The family adds NO new device machinery.  ``lower_tps_rules`` compiles
each TPS rule into a QPS-grade DEFAULT-behavior :class:`FlowRule` on the
synthetic resource ``llm:{model}`` with ``count = tokensPerSecond +
burstTokens`` — the fused step's mixed-count path debits an N-token
acquire against that window exactly, so token budgets inherit every
existing property: device-exact windows, the token-lease fast path,
cluster mode (a ``clusterConfig.flowId`` forwards verbatim, so remote
enforcement and the HA degraded-quota path cover lowered rules with no
special cases), shadow/canary rollout, and adaptive retuning (a
default-tenant lowered rule satisfies the adaptive loop's tunable
shape).  Lowered rules carry ``derived_from="tps"``; each TPS load
strips previously-derived rules before re-injecting, so the lowering
is idempotent.  An operator flow-rule push REPLACES the whole flow
list — lowered rules vanish until the next TPS load re-lowers (the
documented contract: push TPS rules through the ``tps`` family, not by
hand-editing their lowered form).

Degradation: when the cluster path is lost, ``degraded_tps_quota``
builds the HA :class:`DegradedQuota` over the lowered cluster-mode
rules' thresholds — each client gets threshold/clients tokens per
window, so the sum of tenant shares never exceeds the global budget
(the reference's SEMANTICS.md "Degraded-quota bound").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.models.flow import FlowRule

#: Synthetic-resource namespace the lowering targets. Keeping every
#: lowered rule under one prefix lets telemetry/dashboards group the
#: family and keeps operator resources collision-free.
LLM_RESOURCE_PREFIX = "llm:"

#: ``FlowRule.derived_from`` tag identifying rules this module owns.
DERIVED_TPS = "tps"


def llm_resource(model: str) -> str:
    """The flow resource a model's token window lives on."""
    return LLM_RESOURCE_PREFIX + model


@dataclass
class TpsRule:
    model: str
    tokens_per_second: float
    burst_tokens: float = 0.0
    tenant: str = C.LIMIT_APP_DEFAULT
    max_concurrent_streams: int = 0  # 0 = unbounded
    cluster_mode: bool = False
    cluster_config: Optional[dict] = None
    # Staged rollout tags ride through the lowering: a candidate TPS
    # rule lowers into a candidate flow rule (same shadow-lane story).
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None

    def is_valid(self) -> bool:
        if not self.model or self.tokens_per_second < 0:
            return False
        if self.burst_tokens < 0 or self.max_concurrent_streams < 0:
            return False
        return True


class TpsRuleManager(RuleManager[TpsRule]):
    """Wholesale-swap registry, same lifecycle as every other family."""


def lower_tps_rules(rules: Iterable[TpsRule]) -> List[FlowRule]:
    """Compile TPS rules onto the flow machinery (see module docstring)."""
    lowered: List[FlowRule] = []
    for r in rules:
        if not r.is_valid():
            continue
        lowered.append(FlowRule(
            resource=llm_resource(r.model),
            count=float(r.tokens_per_second) + float(r.burst_tokens),
            grade=C.FLOW_GRADE_QPS,
            limit_app=r.tenant or C.LIMIT_APP_DEFAULT,
            strategy=C.FLOW_STRATEGY_DIRECT,
            control_behavior=C.CONTROL_BEHAVIOR_DEFAULT,
            cluster_mode=r.cluster_mode,
            cluster_config=r.cluster_config,
            candidate_set=r.candidate_set,
            rollout_stage=r.rollout_stage,
            derived_from=DERIVED_TPS,
        ))
    return lowered


def max_streams_by_resource(rules: Iterable[TpsRule]) -> Dict[str, int]:
    """resource -> effective ``maxConcurrentStreams`` (tightest positive
    cap across that model's rules; models with no positive cap absent)."""
    caps: Dict[str, int] = {}
    for r in rules:
        if not r.is_valid() or r.max_concurrent_streams <= 0:
            continue
        res = llm_resource(r.model)
        cur = caps.get(res)
        caps[res] = r.max_concurrent_streams if cur is None \
            else min(cur, r.max_concurrent_streams)
    return caps


def degraded_tps_quota(rules: Iterable[TpsRule], clients: int):
    """Tenant-fair degraded shares for cluster-mode TPS rules.

    Reuses the HA share math verbatim: each of ``clients`` admitters
    gets ``threshold / clients`` tokens per window for every lowered
    cluster-mode rule carrying a ``flowId``, so the fleet-wide sum of
    shares is ≤ the global token budget even while partitioned (the
    lowering maps token budgets onto the exact threshold shape the
    degraded-quota bound quantifies over)."""
    from sentinel_tpu_torch.cluster.ha import DegradedQuota
    from sentinel_tpu_torch.cluster.rules import cluster_thresholds

    lowered = [r for r in lower_tps_rules(rules) if r.cluster_mode]
    return DegradedQuota(divisor=max(1, int(clients)),
                         thresholds=cluster_thresholds(lowered))
