"""SLO engine: burn-rate alerting, anomaly baselines, health scoring
(port of ``sentinel_tpu/slo/``).

Declarative per-resource objectives (:mod:`objectives`) are evaluated on
every COMPLETE second the flight recorder spills, with SRE-style
multi-window burn-rate rules; resources with no explicit objective get a
rolling EWMA baseline (:mod:`baseline`) with z-score breach detection;
both roll up into a composite health score per resource and per instance
(:mod:`manager`). Alert transitions fan out to webhooks (:mod:`webhook`)
and to the rollout guardrail's auto-abort signal.

Everything here is host arithmetic over seconds the device already
folded once per second: SLO evaluation adds no per-step device work.
"""

from sentinel_tpu_torch.slo.baseline import EwmaBaseline
from sentinel_tpu_torch.slo.manager import SloManager
from sentinel_tpu_torch.slo.objectives import (
    BurnWindow,
    DEFAULT_BURN_WINDOWS,
    SloObjective,
)
from sentinel_tpu_torch.slo.webhook import AlertWebhook

__all__ = [
    "AlertWebhook",
    "BurnWindow",
    "DEFAULT_BURN_WINDOWS",
    "EwmaBaseline",
    "SloManager",
    "SloObjective",
]
