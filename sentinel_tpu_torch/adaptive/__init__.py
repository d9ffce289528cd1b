"""Closed-loop adaptive limiting (port of ``sentinel_tpu/adaptive/``; no
Java-Sentinel twin — its rules are static until an operator or
datasource pushes new ones).

The loop senses from the SLO engine + flight recorder
(``controller.py``), bounds every ask with hard safety envelopes
(``envelope.py``), and actuates EXCLUSIVELY through the staged-rollout
lifecycle (``loop.py`` -> ``rollout/manager.py``), so the block-rate
guardrail and SLO auto-abort shield every autonomous change. See
docs/OPERATIONS.md "Adaptive limiting" and docs/SEMANTICS.md
"Actuation safety envelope".
"""

from sentinel_tpu_torch.adaptive.controller import (  # noqa: F401
    AdaptiveController,
    AdaptiveTarget,
    AimdPolicy,
    Policy,
    ResourceSense,
)
from sentinel_tpu_torch.adaptive.envelope import (  # noqa: F401
    EnvelopeDecision,
    FreezeGate,
    FreezeState,
    SafetyEnvelope,
)
from sentinel_tpu_torch.adaptive.loop import AdaptiveLoop  # noqa: F401
