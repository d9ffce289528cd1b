"""Envoy rate-limit-service front-end (port of
``sentinel_tpu/envoy_rls/``; reference:
``sentinel-cluster-server-envoy-rls`` — SURVEY.md §2.4): implements
``envoy.service.ratelimit.v2.RateLimitService/ShouldRateLimit`` on top of the
token service, with descriptor-driven rule generation.

The service's token service runs on ``cuda`` unless the caller passes
``device="cpu"`` (``SentinelEnvoyRlsService(device=...)``, ``python -m
sentinel_tpu_torch.envoy_rls --device``); with no card it raises.
"""

from sentinel_tpu_torch.envoy_rls.rule import (
    EnvoyRlsRule,
    EnvoyRlsRuleManager,
    KeyValueResource,
    ResourceDescriptor,
    descriptor_flow_id,
    to_cluster_flow_rules,
)
from sentinel_tpu_torch.envoy_rls.service import SentinelEnvoyRlsService

__all__ = [
    "EnvoyRlsRule", "EnvoyRlsRuleManager", "KeyValueResource",
    "ResourceDescriptor", "SentinelEnvoyRlsService", "descriptor_flow_id",
    "to_cluster_flow_rules",
]
