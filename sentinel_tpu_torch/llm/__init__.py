"""LLM-inference admission (port of ``sentinel_tpu/llm/``).

A tokens-per-second (TPS) rule family with streaming reservations, the
cost-aware counterpart of the count-shaped flow family (SLINFER's
workload: wildly varying per-request token cost, per-model and
per-tenant budgets, pacing instead of binary reject — PAPERS.md).

Layout:

* ``rules.py``   — ``TpsRule`` + ``TpsRuleManager`` and the LOWERING:
  every TPS rule compiles onto the existing flow-rule machinery as a
  QPS-grade rule on the synthetic resource ``llm:{model}`` whose window
  debits count *tokens*, not requests (the fused step's mixed-count
  fixpoint path already carries N-token acquires exactly).  Degraded
  tenant-fair shares reuse the HA ``DegradedQuota`` math.
* ``streams.py`` — the host-side streaming-reservation ledger: an
  occupy-style estimate acquired up front as a lease that ticks down as
  output tokens stream, reconciled on completion/abort.

Timebase discipline: nothing in this package reads the wall clock —
every timestamp is the engine's ``now_ms()``, so the simulator can drive
streams deterministically. Host state only: the device sees the lowered
flow rules and the token debits, never the ledger.
"""

from sentinel_tpu_torch.llm.rules import (
    DERIVED_TPS,
    LLM_RESOURCE_PREFIX,
    TpsRule,
    TpsRuleManager,
    degraded_tps_quota,
    llm_resource,
    lower_tps_rules,
    max_streams_by_resource,
)
from sentinel_tpu_torch.llm.streams import StreamLease, StreamLedger

__all__ = [
    "DERIVED_TPS", "LLM_RESOURCE_PREFIX", "TpsRule", "TpsRuleManager",
    "degraded_tps_quota", "llm_resource", "lower_tps_rules",
    "max_streams_by_resource", "StreamLease", "StreamLedger",
]
