"""The offline policy lab: N policies x M scenarios, scored and ranked
(port of ``sentinel_tpu/simulator/lab.py``).

"Multi-Objective Adaptive Rate Limiting using DRL" (PAPERS.md) frames
the objective: a policy is judged on the vector (block-rate, RT-p99,
utilization), not on any single number. The lab runs each candidate
:class:`~sentinel_tpu_torch.adaptive.controller.Policy` through the replay
engine over a scenario suite — the full in-sim closed loop, every
actuation riding the standard shadow->canary->promote path behind the
rollout guardrail — and scores the resulting vectors with an explicit
weighted scalarization (weights are part of the report: a different
operator trade-off is a re-rank, not a re-run).

Safety is a GATE, not a score term: a run with any band violation
(promoted or final count outside the declared [floor, ceiling]) is
disqualified from winning outright, and guardrail aborts are reported
per run so a "winner" that churned candidates is visible.

``tune_aimd`` is the shipped offline tuner: a deterministic grid search
over AIMD gains on a scenario, returning the best-scoring parameters —
the "tuned AIMD" the acceptance criteria pit against the default.

The last completed report is retained module-wide (``last_report``) for
the ops plane (the ``sim`` command and the ``sentinel_tpu_sim_*``
exporter families, which the port does not have yet).

Device: ``run_lab`` and ``tune_aimd`` take ``device=`` for their replay
engines (``cuda`` unless the caller asks for the CPU; raises with no
card).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from sentinel_tpu_torch.adaptive.controller import AdaptiveTarget, AimdPolicy
from sentinel_tpu_torch.simulator.replay import ReplayEngine
from sentinel_tpu_torch.simulator.trace import Trace

# Scalarization defaults: utilization and block-rate trade 1:1 (both are
# fractions of offered demand), RT-p99 priced per second of latency.
DEFAULT_WEIGHTS = {"utilization": 1.0, "blockRate": 1.0, "rtP99": 0.25}

# Small by design: each cell is a full closed-loop replay. The axes are
# the two AIMD gains that dominate convergence speed vs overshoot.
DEFAULT_AIMD_GRID = (
    {"increase_pct": 0.10, "decrease_pct": 0.30, "hysteresis_pct": 0.10},
    {"increase_pct": 0.25, "decrease_pct": 0.30, "hysteresis_pct": 0.10},
    {"increase_pct": 0.50, "decrease_pct": 0.30, "hysteresis_pct": 0.10},
    {"increase_pct": 0.50, "decrease_pct": 0.50, "hysteresis_pct": 0.05},
    {"increase_pct": 1.00, "decrease_pct": 0.30, "hysteresis_pct": 0.05},
)

_report_lock = threading.Lock()
_last_report: Optional[Dict] = None
# Process-wide monotone counters (read by the ops plane's
# sentinel_tpu_sim_* families): lab runs completed + total simulated
# seconds replayed.
_counters = {"labRuns": 0, "replayedSeconds": 0}


class LabPolicy:
    """One policy under test: a Policy instance (or AIMD gains to build
    one), optional per-policy adaptive knob overrides and targets."""

    __slots__ = ("name", "policy", "knobs", "targets")

    def __init__(self, name: str, policy=None,
                 aimd: Optional[Dict] = None,
                 knobs: Optional[Dict] = None,
                 targets: Optional[List[AdaptiveTarget]] = None):
        if policy is None:
            params = {"increase_pct": 0.10, "decrease_pct": 0.30,
                      "hysteresis_pct": 0.10}
            params.update(aimd or {})
            policy = AimdPolicy(**params)
        self.name = name
        self.policy = policy
        self.knobs = dict(knobs or {})
        self.targets = targets


def default_targets(trace: Trace, max_block_rate: float = 0.05,
                    ceiling_factor: float = 16.0) -> List[AdaptiveTarget]:
    """One availability target per tunable flow rule the trace carries:
    hold block-rate at/below ``max_block_rate``, band = [count/4,
    count*ceiling_factor] around the trace's initial limit. TPS rules
    target their LOWERED resource (``llm:<model>``) at the
    lowered count (tps + burst) — the adaptive loop tunes the lowered
    flow rule, which is how a per-model tokensPerSecond gets retuned."""
    out = []
    tps_lowered = [
        {"resource": "llm:" + r.get("model", ""),
         "count": float(r.get("tokensPerSecond", 0))
         + float(r.get("burstTokens", 0))}
        for r in trace.rules.get("tps", ())]
    for rule in list(trace.rules.get("flow", ())) + tps_lowered:
        count = float(rule.get("count", 0))
        if count <= 0:
            continue
        out.append(AdaptiveTarget(
            resource=rule["resource"],
            max_block_rate=max_block_rate,
            floor=max(1.0, count / 4.0),
            ceiling=count * ceiling_factor))
    return out


def score_vector(vector: Dict[str, float],
                 weights: Optional[Dict] = None) -> float:
    """Higher is better: weighted utilization minus weighted block-rate
    minus weighted RT-p99 (priced in seconds)."""
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    return (w["utilization"] * vector["utilization"]
            - w["blockRate"] * vector["blockRate"]
            - w["rtP99"] * vector["rtP99Ms"] / 1000.0)


def _run_one(trace: Trace, policy: LabPolicy,
             weights: Optional[Dict], replay_kw: Dict) -> Dict:
    targets = policy.targets if policy.targets is not None \
        else default_targets(trace)
    result = ReplayEngine(
        trace, adaptive=policy.knobs, policy=policy.policy,
        targets=targets, **replay_kw).run()
    vector = result.objective_vector()
    return {
        "objective": vector,
        "score": round(score_vector(vector, weights), 6),
        "promotions": result.counters.get("promotions", 0),
        "aborts": result.counters.get("aborts", 0),
        "clamped": result.counters.get("clamped", 0),
        "bandViolations": result.band_violations,
        "finalCounts": result.final_counts,
        "retried": result.retried,
        "verdictSha256": result.verdict_sha256,
        "seconds": result.seconds,
        "secondsPerWallSecond": round(
            result.seconds / result.total_wall_s, 1),
    }


def run_lab(scenarios: Dict[str, Trace], policies: List[LabPolicy],
            weights: Optional[Dict] = None,
            replay_kw: Optional[Dict] = None,
            stamp_ms: Optional[int] = None, device=None) -> Dict:
    """The comparison harness: every policy over every scenario, one
    report. Deterministic given the traces and policies (the replay
    engine is; wall-rate fields are the only measured numbers)."""
    replay_kw = dict(replay_kw or {})
    replay_kw.setdefault("device", device)
    results: Dict[str, Dict] = {}
    winners: Dict[str, str] = {}
    replayed = 0
    t0 = time.perf_counter()
    for scen_name in sorted(scenarios):
        trace = scenarios[scen_name]
        cell: Dict[str, Dict] = {}
        for pol in policies:
            cell[pol.name] = _run_one(trace, pol, weights, replay_kw)
            replayed += cell[pol.name]["seconds"]
        results[scen_name] = cell
        # Safety gates the win: band violations disqualify. With NO
        # safe run the scenario has no winner (None — the dashboard
        # stars nothing); crowning the least-bad violator would put an
        # envelope-escaping policy behind the ★.
        safe = {name: r for name, r in cell.items()
                if r["bandViolations"] == 0}
        winners[scen_name] = max(
            sorted(safe), key=lambda name: safe[name]["score"]) \
            if safe else None
    wall_s = max(time.perf_counter() - t0, 1e-9)
    report = {
        "stampMs": stamp_ms,
        "weights": dict(DEFAULT_WEIGHTS, **(weights or {})),
        "scenarios": {
            name: {"seconds": scenarios[name].duration_s,
                   "meta": {k: v for k, v in scenarios[name].meta.items()
                            if k in ("scenario", "seed", "retry")}}
            for name in sorted(scenarios)},
        "policies": [p.name for p in policies],
        "results": results,
        "winners": winners,
        "replayedSeconds": replayed,
        "wallSeconds": round(wall_s, 3),
        "secondsPerWallSecond": round(replayed / wall_s, 1),
    }
    set_last_report(report)
    return report


def tune_aimd(trace: Trace, grid=DEFAULT_AIMD_GRID,
              targets: Optional[List[AdaptiveTarget]] = None,
              weights: Optional[Dict] = None,
              replay_kw: Optional[Dict] = None, device=None) -> Dict:
    """Deterministic grid search over AIMD gains on one scenario.
    Returns the best parameters + every trial's score; build the tuned
    contender with ``LabPolicy("aimd-tuned", aimd=out["best"])``.
    Unsafe trials (band violations) are disqualified, so the tuner can
    never hand back parameters that escaped the envelope."""
    replay_kw = dict(replay_kw or {})
    replay_kw.setdefault("device", device)
    trials = []
    for params in grid:
        pol = LabPolicy(f"aimd-{params['increase_pct']:g}-"
                        f"{params['decrease_pct']:g}-"
                        f"{params['hysteresis_pct']:g}",
                        aimd=params, targets=targets)
        run = _run_one(trace, pol, weights, replay_kw)
        trials.append({"params": dict(params), "name": pol.name, **run})
    safe = [tr for tr in trials if tr["bandViolations"] == 0]
    if not safe:
        # The guarantee is absolute: the tuner NEVER hands back
        # envelope-escaping gains. All-violating grids are a caller
        # error (bad band/grid combination) and must fail loudly.
        raise ValueError(
            "every tune_aimd trial violated the safety envelope "
            f"({len(trials)} trials) — widen the targets' band or "
            "shrink the grid's gains")
    best = max(safe, key=lambda tr: tr["score"])
    return {"best": best["params"], "bestScore": best["score"],
            "trials": trials}


def set_last_report(report: Dict) -> None:
    global _last_report
    with _report_lock:
        _last_report = report
        _counters["labRuns"] += 1
        _counters["replayedSeconds"] += int(
            report.get("replayedSeconds", 0))


def last_report() -> Optional[Dict]:
    with _report_lock:
        return _last_report


def counters() -> Dict[str, int]:
    with _report_lock:
        return dict(_counters)
