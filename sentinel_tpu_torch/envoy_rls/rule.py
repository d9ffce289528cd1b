"""Envoy RLS rules + conversion to cluster flow rules (port of
``sentinel_tpu/envoy_rls/rule.py``; reference:
``…/envoy/rls/rule/EnvoyRlsRule.java``, ``EnvoyRlsRuleManager.java``,
``EnvoySentinelRuleConverter.java``): each (domain, descriptor key/value
set) maps to one generated cluster ``FlowRule`` whose ``flowId`` is a stable
hash of the descriptor identity, enforced GLOBAL-threshold by the token
service.

The flowId is the wire contract between an RLS front end and its token
service: the same SHA-1 of the same identity as the JAX package, bit for
bit, so either package's rules and services agree on every descriptor.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.constants import THRESHOLD_GLOBAL
from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
from sentinel_tpu_torch.models.flow import FlowRule

SEPARATOR = "|"


@dataclass
class KeyValueResource:
    key: str
    value: str


@dataclass
class ResourceDescriptor:
    resources: List[KeyValueResource]
    count: float  # permitted QPS for this descriptor


@dataclass
class EnvoyRlsRule:
    domain: str
    descriptors: List[ResourceDescriptor] = field(default_factory=list)

    def is_valid(self) -> bool:
        return bool(self.domain) and all(
            d.count >= 0 and d.resources for d in self.descriptors)


def descriptor_identity(domain: str, entries: Sequence[Tuple[str, str]]) -> str:
    parts = [domain] + [f"{k}:{v}" for k, v in entries]
    return SEPARATOR.join(parts)


def descriptor_flow_id(domain: str, entries: Sequence[Tuple[str, str]]) -> int:
    """Stable 63-bit flowId from the descriptor identity (converter analog)."""
    digest = hashlib.sha1(
        descriptor_identity(domain, entries).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") & ((1 << 63) - 1)


def to_cluster_flow_rules(rule: EnvoyRlsRule) -> List[FlowRule]:
    """``EnvoySentinelRuleConverter.toSentinelFlowRules`` analog."""
    out = []
    for d in rule.descriptors:
        entries = [(r.key, r.value) for r in d.resources]
        identity = descriptor_identity(rule.domain, entries)
        out.append(FlowRule(
            resource=identity,
            count=d.count,
            cluster_mode=True,
            cluster_config={
                "flowId": descriptor_flow_id(rule.domain, entries),
                "thresholdType": THRESHOLD_GLOBAL,
                "fallbackToLocalWhenFail": False,
            },
        ))
    return out


class EnvoyRlsRuleManager:
    """Holds RLS rules per domain; regenerates the token-service rule set
    (one namespace per domain) on every load — wholesale swap semantics."""

    def __init__(self, cluster_rules: Optional[ClusterFlowRuleManager] = None):
        self.cluster_rules = cluster_rules or ClusterFlowRuleManager()
        self._lock = threading.Lock()
        self._rules: Dict[str, EnvoyRlsRule] = {}

    def load_rules(self, rules: List[EnvoyRlsRule]) -> None:
        valid = [r for r in rules if r.is_valid()]
        with self._lock:
            old_domains = set(self._rules)
            self._rules = {r.domain: r for r in valid}
            for r in valid:
                self.cluster_rules.load_rules(
                    r.domain, to_cluster_flow_rules(r))
            for gone in old_domains - set(self._rules):
                self.cluster_rules.load_rules(gone, [])

    def get_rules(self) -> List[EnvoyRlsRule]:
        with self._lock:
            return list(self._rules.values())
