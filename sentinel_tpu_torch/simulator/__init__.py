"""Deterministic trace-replay simulator (port of ``sentinel_tpu/simulator/``).

The offline half of the closed adaptive loop: recorded flight-recorder
seconds (or seedable synthetic scenarios) are re-driven through a REAL
``SentinelEngine`` — on the card, the production fused step with its
segmented-prefix kernel; on the CPU with ``device="cpu"``, its plain
form — on a fully frozen, program-advanced clock at accelerated wall
speed, with the adaptive loop, SLO judgement, and rollout guardrails all
running in-sim unmodified. On top of the replay engine sits a policy lab that
scores candidate :class:`~sentinel_tpu_torch.adaptive.controller.Policy`
implementations on the multi-objective vector (block-rate, RT-p99,
utilization) the DRL adaptive-rate-limiting literature motivates
(PAPERS.md), entirely offline.

Pieces:

* :mod:`~sentinel_tpu_torch.simulator.clock` — the program-advanced ms clock
  injected through the engine's clock seam (``SentinelEngine(clock=)``).
* :mod:`~sentinel_tpu_torch.simulator.trace` — the versioned, portable
  trace format (the JAX package's, byte for byte): capture from a live
  engine (``export_trace``), tee live seconds into a file
  (``TraceWriter``), load/save/round-trip.
* :mod:`~sentinel_tpu_torch.simulator.scenarios` — seedable synthetic trace
  generators: diurnal cycles, flash crowds, retry storms (the one
  closed-loop coupling real traces cannot carry), correlated
  multi-resource overload, SLINFER-style heterogeneous token-cost
  mixes.
* :mod:`~sentinel_tpu_torch.simulator.replay` — ``ReplayEngine``: drives the
  engine through the trace second by second, batching each second's
  demand through the production step, and returns the exact verdict
  stream + per-second series + the adaptive decision log.
* :mod:`~sentinel_tpu_torch.simulator.lab` — ``run_lab`` / ``tune_aimd``:
  N policies x M scenarios, scored objective vectors, a comparison
  report, and grid-search AIMD tuning.
"""

from sentinel_tpu_torch.simulator.clock import SimClock
from sentinel_tpu_torch.simulator.lab import (
    LabPolicy,
    last_report,
    run_lab,
    tune_aimd,
)
from sentinel_tpu_torch.simulator.replay import ReplayEngine, ReplayResult
from sentinel_tpu_torch.simulator.scenarios import SCENARIOS, build_scenario
from sentinel_tpu_torch.simulator.trace import (
    TRACE_KIND,
    TRACE_VERSION,
    Trace,
    TraceWriter,
    export_trace,
)

__all__ = [
    "SimClock", "Trace", "TraceWriter", "TRACE_KIND", "TRACE_VERSION",
    "export_trace", "SCENARIOS", "build_scenario", "ReplayEngine",
    "ReplayResult", "LabPolicy", "run_lab", "tune_aimd", "last_report",
]
