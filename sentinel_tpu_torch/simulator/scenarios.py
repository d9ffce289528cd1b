"""Seedable synthetic scenario generators (port of
``sentinel_tpu/simulator/scenarios.py``).

Every generator is a pure function of its parameters plus one
``numpy.random.default_rng(seed)`` stream, so a (name, seconds, seed,
params) tuple names exactly one trace forever, in both packages: the
generators draw from numpy alone, so a seed gives the same JSON here and
in the JAX package.

Shapes covered:

* ``diurnal`` — a smooth load cycle (cosine day compressed to
  ``period_s``) with Poisson noise: the baseline-drift case.
* ``flash_crowd`` — a step burst of ``crowd`` tokens/s for ``width_s``
  seconds on top of a calm base: the under-provisioned-limit case the
  adaptive loop must open fast.
* ``retry_storm`` — an overload burst whose BLOCKED demand re-offers
  after a backoff with a decay factor (``meta["retry"]``): the one
  closed-loop coupling a real recorded trace cannot carry, implemented
  by the replay engine itself.
* ``correlated_overload`` — several resources spiking in the SAME
  seconds: the multi-resource blast-radius case (one resource's tuning
  must not be judged on another's alerts).
* ``hetero_cost`` — SLINFER-style heterogeneous inference costs: mixed
  acquire counts per entry (small chat / medium completion / large
  batch-prompt classes) against shared per-model budgets.

Load-dependent RT: generators attach ``meta["rtProfile"][resource] =
{"baseMs", "loadedMs", "kneeTps"}`` — the replay engine stamps admitted
tokens beyond the knee with the loaded RT, so over-admission shows up in
the scored RT-p99 exactly like a congested backend would show it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# The one canary-epoch definition (core/config.py): synthetic traces
# live far from the wall clock, aligned to a second boundary, so an
# ambient clock read in a replayed path is instantly wrong.
from sentinel_tpu_torch.core.config import (
    DEFAULT_SIM_EPOCH_MS as DEFAULT_EPOCH_MS,
)
from sentinel_tpu_torch.simulator.trace import Trace


def _flow_rule(resource: str, count: float) -> Dict:
    """A plain tunable QPS rule (the shape the adaptive loop may
    retune: direct strategy, default control behavior / limit app)."""
    return {"resource": resource, "grade": 1, "count": float(count),
            "strategy": 0, "controlBehavior": 0, "limitApp": "default"}


def _seconds_from_demand(demand: Dict[str, np.ndarray],
                         counts: Optional[Dict[str, List[List[int]]]] = None
                         ) -> List[Dict]:
    """Per-resource tokens/s vectors -> sparse trace seconds. ``counts``
    optionally splits a resource's tokens into an acquire-count mix
    ([[count, weight], ...]; weights are relative)."""
    n = max(len(v) for v in demand.values())
    seconds = []
    for t in range(n):
        d: Dict[str, list] = {}
        for res in sorted(demand):
            tokens = int(demand[res][t]) if t < len(demand[res]) else 0
            if tokens <= 0:
                continue
            mix = (counts or {}).get(res)
            if not mix:
                d[res] = [[1, tokens]]
                continue
            # Deterministic split: weight-proportional tokens per class,
            # remainder tokens to the smallest count class as 1-token
            # acquires would misstate the mix — they go to the first.
            total_w = sum(w for _, w in mix)
            pairs = []
            used = 0
            for count, w in mix:
                share = int(tokens * w / total_w)
                entries = share // count
                if entries:
                    pairs.append([count, entries])
                    used += entries * count
            rest = tokens - used
            if rest > 0:
                pairs.append([1, rest])
            d[res] = pairs
        if d:
            seconds.append({"t": t, "d": d})
    return seconds


def diurnal(seconds: int = 240, seed: int = 0, base: float = 40,
            peak: float = 200, period_s: int = 120,
            limit: float = 120) -> Trace:
    rng = np.random.default_rng(seed)
    t = np.arange(seconds)
    mean = base + (peak - base) * 0.5 * (1 - np.cos(2 * np.pi * t / period_s))
    demand = rng.poisson(mean).astype(np.int64)
    return Trace(
        epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
        meta={"scenario": "diurnal", "seed": seed,
              "rtProfile": {"web": {"baseMs": 8, "loadedMs": 40,
                                    "kneeTps": int(limit * 2)}}},
        resources=["web"],
        rules={"flow": [_flow_rule("web", limit)]},
        seconds=_seconds_from_demand({"web": demand}))


def flash_crowd(seconds: int = 240, seed: int = 0, base: float = 30,
                crowd: float = 400, at_s: Optional[int] = None,
                width_s: Optional[int] = None, limit: float = 50) -> Trace:
    rng = np.random.default_rng(seed)
    at = seconds // 4 if at_s is None else at_s
    width = seconds // 2 if width_s is None else width_s
    mean = np.full(seconds, base, np.float64)
    mean[at:at + width] += crowd
    demand = rng.poisson(mean).astype(np.int64)
    return Trace(
        epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
        meta={"scenario": "flash_crowd", "seed": seed,
              "crowd": {"atS": at, "widthS": width},
              "rtProfile": {"web": {"baseMs": 10, "loadedMs": 60,
                                    "kneeTps": int(crowd * 2)}}},
        resources=["web"],
        rules={"flow": [_flow_rule("web", limit)]},
        seconds=_seconds_from_demand({"web": demand}))


def retry_storm(seconds: int = 240, seed: int = 0, base: float = 40,
                burst: float = 300, at_s: Optional[int] = None,
                width_s: int = 20, limit: float = 60,
                backoff_s: int = 2, factor: float = 0.7,
                max_attempts: int = 3) -> Trace:
    """Overload burst + client retries: blocked demand re-offers after
    ``backoff_s`` at ``factor`` strength, up to ``max_attempts`` — the
    replay engine closes this loop (``meta["retry"]``), so a policy that
    opens the limit faster also drains the storm faster."""
    rng = np.random.default_rng(seed)
    at = seconds // 4 if at_s is None else at_s
    mean = np.full(seconds, base, np.float64)
    mean[at:at + width_s] += burst
    demand = rng.poisson(mean).astype(np.int64)
    return Trace(
        epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
        meta={"scenario": "retry_storm", "seed": seed,
              "retry": {"backoffSeconds": int(backoff_s),
                        "factor": float(factor),
                        "maxAttempts": int(max_attempts)},
              "rtProfile": {"api": {"baseMs": 12, "loadedMs": 80,
                                    "kneeTps": int(burst * 2)}}},
        resources=["api"],
        rules={"flow": [_flow_rule("api", limit)]},
        seconds=_seconds_from_demand({"api": demand}))


def correlated_overload(seconds: int = 240, seed: int = 0,
                        resources: int = 3, base: float = 30,
                        surge: float = 150, at_s: Optional[int] = None,
                        width_s: Optional[int] = None,
                        limit: float = 45) -> Trace:
    """All resources surge in the SAME window (a shared upstream event):
    the case where per-resource tuning must hold under a fleet-wide
    spike and one resource's alerts must not gate the others' retunes."""
    rng = np.random.default_rng(seed)
    at = seconds // 3 if at_s is None else at_s
    width = seconds // 3 if width_s is None else width_s
    names = [f"svc{i}" for i in range(resources)]
    demand = {}
    for i, name in enumerate(names):
        mean = np.full(seconds, base * (1 + 0.2 * i), np.float64)
        mean[at:at + width] += surge * (1 + 0.1 * i)
        demand[name] = rng.poisson(mean).astype(np.int64)
    return Trace(
        epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
        meta={"scenario": "correlated_overload", "seed": seed,
              "rtProfile": {name: {"baseMs": 10, "loadedMs": 50,
                                   "kneeTps": int(surge * 3)}
                            for name in names}},
        resources=names,
        rules={"flow": [_flow_rule(name, limit) for name in names]},
        seconds=_seconds_from_demand(demand))


def hetero_cost(seconds: int = 240, seed: int = 0, base_tokens: float = 200,
                swing: float = 0.5, period_s: int = 80,
                limit: float = 240, streams_per_s: float = 0.0,
                stream_len_s: int = 6, stream_tokens: int = 120,
                abandon_rate: float = 0.0) -> Trace:
    """SLINFER-style heterogeneous inference admission: two model
    resources sharing the token-per-second currency, each second's
    demand split into acquire-count classes (chat=1, completion=4,
    batch-prompt=16 tokens) in model-specific proportions — the
    mixed-count fixpoint regime of the fused step, driven at scale.

    Streamed-generation mode (opt-in — ``streams_per_s > 0``):
    the scenario switches to the TPS rule family (``llm:*`` lowered
    resources) and adds Poisson streamed-generation arrivals — each
    stream opens with a ``stream_tokens`` estimate, ticks its output
    down over ``stream_len_s`` seconds, and closes; ``abandon_rate``
    of streams abort mid-generation with their reservation
    unreconciled (the over-admission bound's stress knob). All stream
    draws happen AFTER the demand draws, so the default
    (``streams_per_s=0``) trace stays bit-identical to captures made
    before the streamed mode existed."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds)
    wave = 1 + swing * np.sin(2 * np.pi * t / period_s)
    streamed = streams_per_s > 0
    prefix = "llm:" if streamed else ""
    small, large = prefix + "model-small", prefix + "model-large"
    demand = {
        small: rng.poisson(base_tokens * wave).astype(np.int64),
        # The large model trails by half a period (tenants shift load).
        large: rng.poisson(
            base_tokens * 0.6 * (2 - wave)).astype(np.int64),
    }
    counts = {
        small: [[1, 6], [4, 3]],         # chat-heavy
        large: [[4, 2], [16, 3], [1, 1]],  # long generations
    }
    secs = _seconds_from_demand(demand, counts)
    meta = {"scenario": "hetero_cost", "seed": seed,
            "countClasses": counts,
            "rtProfile": {
                small: {"baseMs": 30, "loadedMs": 250,
                        "kneeTps": int(base_tokens * 2)},
                large: {"baseMs": 120, "loadedMs": 900,
                        "kneeTps": int(base_tokens)}}}
    if not streamed:
        return Trace(
            epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
            meta=meta, resources=[small, large],
            rules={"flow": [_flow_rule(small, limit),
                            _flow_rule(large, limit * 0.6)]},
            seconds=secs)
    # Streamed-generation arrivals: all draws AFTER the demand draws,
    # in a fixed (model-sorted, time-ordered) sequence — one seed names
    # one event schedule forever.
    meta["streams"] = {"perS": float(streams_per_s),
                       "lenS": int(stream_len_s),
                       "tokens": int(stream_tokens),
                       "abandonRate": float(abandon_rate)}
    by_t: Dict[int, list] = {}
    sid = 0
    for model in ("model-large", "model-small"):
        arrivals = rng.poisson(streams_per_s, seconds)
        for t0 in range(seconds):
            for _ in range(int(arrivals[t0])):
                sid += 1
                stream_id = f"g{sid}"
                length = max(1, int(stream_len_s))
                per_tick = max(1, int(np.ceil(stream_tokens / length)))
                aborts = bool(rng.random() < abandon_rate)
                # An aborted stream dies after a prefix of its ticks,
                # leaving the rest of its reservation unreconciled.
                live_ticks = length if not aborts else \
                    1 + int(rng.random() * max(1, length - 1))
                by_t.setdefault(t0, []).append(
                    {"op": "open", "id": stream_id, "model": model,
                     "est": int(stream_tokens)})
                left = int(stream_tokens)
                end_t = t0
                for k in range(1, live_ticks + 1):
                    tk = t0 + k
                    if tk >= seconds:
                        break
                    tok = min(per_tick, left) if k < length else left
                    by_t.setdefault(tk, []).append(
                        {"op": "tick", "id": stream_id, "tok": int(tok)})
                    left -= int(tok)
                    end_t = tk
                close_t = min(end_t + 1, seconds - 1)
                by_t.setdefault(close_t, []).append(
                    {"op": "abort" if aborts else "close",
                     "id": stream_id})
    sec_by_t = {s["t"]: s for s in secs}
    for t0, events in by_t.items():
        rec = sec_by_t.get(t0)
        if rec is None:
            rec = {"t": t0, "d": {}}
            sec_by_t[t0] = rec
        rec["g"] = events
    return Trace(
        epoch_ms=DEFAULT_EPOCH_MS, duration_s=seconds,
        meta=meta, resources=[small, large],
        rules={"tps": [
            {"model": "model-small", "tokensPerSecond": float(limit),
             "burstTokens": 0.0, "maxConcurrentStreams": 0},
            {"model": "model-large",
             "tokensPerSecond": float(limit * 0.6),
             "burstTokens": 0.0, "maxConcurrentStreams": 0},
        ]},
        seconds=sorted(sec_by_t.values(), key=lambda s: s["t"]))


SCENARIOS = {
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "retry_storm": retry_storm,
    "correlated_overload": correlated_overload,
    "hetero_cost": hetero_cost,
}


def build_scenario(name: str, seconds: Optional[int] = None,
                   seed: int = 0, **params) -> Trace:
    """Build a named scenario trace; unknown names raise with the
    catalog (the ``sim`` command's error surface)."""
    builder = SCENARIOS.get(name)
    if builder is None:
        raise ValueError(
            f"unknown scenario {name!r} (have: {sorted(SCENARIOS)})")
    if seconds is not None:
        params["seconds"] = int(seconds)
    return builder(seed=seed, **params)
