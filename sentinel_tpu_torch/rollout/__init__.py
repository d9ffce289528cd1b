"""Shadow-rule evaluation and staged rollout (shadow -> canary -> promote),
port of ``sentinel_tpu/rollout/``.

A candidate ruleset is extra rule tensors evaluated in non-enforcing lanes
of the same fused step (``ops/step.py``): operators stage a rule edit
against live traffic before it rejects a request, enforce it for a
deterministic hash-selected canary slice, then promote it through the
rule-manager path every datasource push takes (or let the block-rate
guardrail abort it).

:mod:`~sentinel_tpu_torch.rollout.canary` is re-exported here;
:class:`~sentinel_tpu_torch.rollout.manager.RolloutManager` is imported
from its module directly (it imports the step, which imports ``canary``).
"""

from sentinel_tpu_torch.rollout.canary import (  # noqa: F401
    CANARY_BPS_MAX,
    canary_bucket,
    canary_hash,
    in_canary,
)

__all__ = ["CANARY_BPS_MAX", "canary_bucket", "canary_hash", "in_canary"]
