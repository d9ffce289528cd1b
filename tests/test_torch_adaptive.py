"""Closed-loop adaptive limiting in the port (``sentinel_tpu_torch/
adaptive/``) against the JAX package's.

Module level (no engine): the envelope's clamps, cooldown and flip
hysteresis, the freeze gate's truth table and the AIMD policy
(``tests/test_adaptive.py:118-224``) give the same decisions in both
packages over a seeded sweep of proposals; the target converters
round-trip and reject alike.

Engine level (one JAX engine and one port engine on one injected clock,
``tests/test_torch_rollout.py``'s twin, drill-speed knobs): the closed
loop proposes, shadows, canaries and promotes until a count=4 rule under
16/s of demand meets its 0.05 block-rate target (``test_adaptive.py:256``:
4 -> 8 -> 16), and an RT-driven decrease breaches the guardrail and aborts
with the last-known-good rules intact (``:301``). Every batch's decisions
and state are compared, and the decision logs, live rules, shadow
counters and journal records must be equal. Lint: nothing in the port's
``adaptive/`` calls ``load_rules``, replaces a rule manager or builds its
own ``RolloutManager``.
"""

from __future__ import annotations

import json
from dataclasses import astuple
import re
from pathlib import Path

import numpy as np
import pytest

from sentinel_tpu.adaptive import controller as JC
from sentinel_tpu.adaptive import envelope as JE
from sentinel_tpu.core.batch import make_exit_batch_np
from sentinel_tpu.core.config import config as jcfg
from sentinel_tpu.datasource import converters as JCV

from sentinel_tpu_torch.adaptive import controller as PC
from sentinel_tpu_torch.adaptive import envelope as PE
from sentinel_tpu_torch.core.config import config as pcfg
from sentinel_tpu_torch.datasource import converters as PCV

from tests.test_torch_journal import _code_lines
from tests.test_torch_rollout import Twin
from tests.test_torch_support import jax_exit

REPO = Path(__file__).resolve().parents[1]
PASS = 0


def test_envelope_decisions_match_over_a_seeded_sweep():
    """Seeded (current, proposed, band, clock, promotion) sequences: the
    same EnvelopeDecision and cooldown view from both envelopes."""
    rng = np.random.default_rng(11)
    envs = [M.SafetyEnvelope(step_pct=0.25, cooldown_ms=10_000)
            for M in (JE, PE)]
    now = 0
    for _ in range(400):
        now += int(rng.integers(0, 4_000))
        res = f"r{int(rng.integers(3))}"
        current = float(rng.choice([1.0, 2.0, 50.0, 100.0, 2000.0]))
        proposed = float(current * rng.uniform(0.1, 3.0))
        floor = float(rng.choice([1.0, 50.0, 90.0]))
        ceiling = float(rng.choice([110.0, 1000.0, 5000.0]))
        got = [e.admit(res, current, proposed, floor, ceiling, now)
               for e in envs]
        assert astuple(got[1]) == astuple(got[0])
        if got[1].allowed and rng.random() < 0.5:
            for e in envs:
                e.record_actuation(res, current, got[1].value, now)
        assert envs[1].cooldown_state(now) == envs[0].cooldown_state(now)


def test_freeze_gate_truth_table_matches():
    gates = [M.FreezeGate(stale_after_ms=5_000) for M in (JE, PE)]
    rng = np.random.default_rng(4)
    for _ in range(300):
        kw = dict(manual_frozen=bool(rng.random() < 0.2),
                  recorder_enabled=bool(rng.random() < 0.9),
                  last_second_ms=int(rng.choice([0, 90_000, 95_000,
                                                 99_000])),
                  fault_delta=int(rng.integers(0, 2)),
                  backoff_until_ms=int(rng.choice([0, 100_000, 100_001])))
        got = [g.evaluate(100_000, **kw) for g in gates]
        assert astuple(got[1]) == astuple(got[0])
    rb = [M.RebalanceFreezeGate(stale_after_ms=5_000) for M in (JE, PE)]
    for kw in (dict(manual_frozen=True, settled_through_ms=0),
               dict(manual_frozen=False, settled_through_ms=90_000),
               dict(manual_frozen=False, settled_through_ms=99_000,
                    degraded_leaders=("L2",)),
               dict(manual_frozen=False, settled_through_ms=99_000,
                    backoff_until_ms=100_001),
               dict(manual_frozen=False, settled_through_ms=99_000)):
        got = [g.evaluate(100_000, **kw) for g in rb]
        assert astuple(got[1]) == astuple(got[0])


def test_aimd_policy_and_sense_fold_match():
    rng = np.random.default_rng(8)
    for _ in range(200):
        inc, dec, hyst = (float(rng.uniform(0.05, 1.0)),
                          float(rng.uniform(0.05, 0.9)),
                          float(rng.uniform(0.0, 0.3)))
        tkw = dict(resource="r", max_block_rate=float(rng.uniform(0, 0.5)),
                   rt_p99_ms=float(rng.choice([0.0, 50.0, 100.0])),
                   min_entries=int(rng.integers(0, 20)))
        targets = [M.AdaptiveTarget(**tkw) for M in (JC, PC)]
        entries = int(rng.integers(0, 200))
        blocked = int(rng.integers(0, entries + 1))
        rate = blocked / entries if entries else 0.0
        rt = float(rng.uniform(0, 300))
        comp = int(rng.integers(0, 50))
        senses = [M.ResourceSense(resource="r", seconds=2,
                                  passed=entries - blocked, blocked=blocked,
                                  completions=comp, block_rate=rate,
                                  rt_p99_ms=rt) for M in (JC, PC)]
        current = float(rng.uniform(1, 500))
        got = [M.AimdPolicy(inc, dec, hyst).propose(s, t, current)
               for M, s, t in zip((JC, PC), senses, targets)]
        assert got[1] == got[0]
    seconds = []
    for k in range(12):
        res = {}
        for r in ("a", "b", "c"):
            if rng.random() < 0.8:
                res[r] = {"pass": int(rng.integers(0, 40)),
                          "block": int(rng.integers(0, 40)),
                          "rtBuckets": [int(x) for x in
                                        rng.integers(0, 9, 14)]}
        seconds.append({"timestamp": k * 1000, "resources": res})
    folds = []
    for M in (JC, PC):
        ctl = M.AdaptiveController(M.AimdPolicy(0.1, 0.3, 0.1))
        ctl.load_targets([M.AdaptiveTarget(resource=r, max_block_rate=0.05)
                          for r in ("a", "b", "x")])
        senses = ctl.fold_senses(json.loads(json.dumps(seconds)))
        desired = ctl.desired(senses, {"a": 10.0, "b": 20.0, "x": 5.0})
        folds.append(([astuple(s) for _, s in sorted(senses.items())],
                      [(d["resource"], d["current"], d["proposed"])
                       for d in desired]))
    assert folds[1] == folds[0]


def test_adaptive_target_converters_match():
    good = [{"resource": "getUser", "maxBlockRate": 0.05, "rtP99Ms": 250,
             "floor": 50, "ceiling": 5000, "minEntries": 16},
            {"resource": "x"}]
    bad = [{"resource": ""}, {"resource": "x", "maxBlockRate": 1.5},
           {"resource": "x", "floor": 0},
           {"resource": "x", "floor": 10, "ceiling": 5},
           {"resource": "x", "rtP99Ms": -1},
           {"resource": "x", "minEntries": -1}, "not-a-dict"]
    outs = []
    for CV, M in ((JCV, JC), (PCV, PC)):
        ts = CV.adaptive_targets_from_json(json.dumps(good))
        text = CV.adaptive_targets_to_json(ts)
        assert CV.adaptive_targets_from_json(text) == ts
        errors = []
        for b in bad:
            with pytest.raises(ValueError) as ex:
                CV.adaptive_target_from_dict(b)
            errors.append(str(ex.value))
        with pytest.raises(ValueError):
            M.AdaptiveController(M.AimdPolicy(0.1, 0.3, 0.1)).load_targets(
                [M.AdaptiveTarget(resource="x"),
                 M.AdaptiveTarget(resource="x")])
        outs.append((text, errors))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# engine level: the closed loop through the fused step's shadow lanes
# ---------------------------------------------------------------------------

DRILL = {
    "csp.sentinel.adaptive.interval.seconds": "2",
    "csp.sentinel.adaptive.shadow.seconds": "2",
    "csp.sentinel.adaptive.canary.seconds": "2",
    "csp.sentinel.adaptive.cooldown.seconds": "4",
    "csp.sentinel.adaptive.abort.backoff.seconds": "30",
    "csp.sentinel.adaptive.step.pct": "1.0",
    "csp.sentinel.adaptive.increase.pct": "1.0",
    "csp.sentinel.adaptive.freeze.stale.seconds": "5",
}


@pytest.fixture(scope="module")
def pair():
    saved = [(cfg, {k: cfg._config.get(k) for k in DRILL})
             for cfg in (jcfg, pcfg)]
    for cfg in (jcfg, pcfg):
        for k, v in DRILL.items():
            cfg.set(k, v)
    tw = Twin(capacity=128)
    yield tw
    tw.close()
    for cfg, old in saved:
        for k, v in old.items():
            if v is None:
                cfg._config.pop(k, None)
            else:
                cfg.set(k, v)


@pytest.fixture
def twin(pair):
    pair.fresh()
    for eng in pair.engines:
        eng.rollout.min_window_entries = 8
        eng.rollout.abort_windows = 3
    return pair


def _complete(twin, res, n, rt_ms, now):
    for eng in twin.engines:
        buf = make_exit_batch_np(64)
        parent = eng.registry.entrance_row("ctx")
        c, dn, orow, _ = eng.registry.resolve_entry(res, "ctx", "", parent, 1)
        for i in range(n):
            buf["cluster_row"][i] = c
            buf["dn_row"][i] = dn
            buf["origin_row"][i] = orow
            buf["count"][i] = 1
            buf["rt_ms"][i] = rt_ms
            buf["success"][i] = True
        if eng is twin.j:
            eng.complete_batch(jax_exit(buf), now_ms=now)
        else:
            eng.complete_batch(buf, now_ms=now)


def _drive(twin, res, per_sec, seconds, rt_ms=None):
    for _ in range(seconds):
        now = twin.clock.now
        reasons = twin.check([(res, "", None)] * per_sec, now=now)
        if rt_ms is not None:
            passed = int((reasons == PASS).sum())
            if passed:
                _complete(twin, res, passed, rt_ms, now + 900)
        twin.clock.now = now + 1000


def _tick(twin):
    outs = [eng.adaptive.tick(now_ms=twin.clock.now, force=True)
            for eng in twin.engines]
    assert outs[1] == outs[0]
    twin.assert_state()
    return outs[1]


def _books(eng):
    return (eng.adaptive.history(), eng.adaptive.status(),
            eng.adaptive.guardrail_state(),
            [(r.resource, r.count) for r in eng.flow_rules.get_rules()],
            eng.journal.tail(kind="adaptiveDecision"),
            eng.resilience_stats()["adaptive"])


def _targets(twin, **kw):
    for eng, M in ((twin.j, JC), (twin.p, PC)):
        eng.adaptive.load_targets([M.AdaptiveTarget(**kw)])
        eng.adaptive.enable()


def _count_of(eng, res):
    return [r.count for r in eng.flow_rules.get_rules()
            if r.resource == res][0]


def test_closed_loop_reaches_its_target_alike(twin):
    twin.load("flow", [{"resource": "ad", "count": 4}])
    _targets(twin, resource="ad", max_block_rate=0.05, floor=1.0,
             ceiling=64.0, min_entries=8)
    promoted = []
    for _ in range(40):
        _drive(twin, "ad", 16, 1)
        _tick(twin)
        if twin.p.adaptive.promotion_count > len(promoted):
            promoted.append(_count_of(twin.p, "ad"))
            twin.shadow_counts()
        sense = twin.p.adaptive.status()["senses"].get("ad")
        if promoted and sense and sense["blockRate"] <= 0.05 \
                and twin.p.adaptive.status()["inflight"] is None:
            break
    assert _books(twin.p) == _books(twin.j)
    assert promoted == [8.0, 16.0]
    assert _count_of(twin.j, "ad") == 16.0
    kinds = [e["kind"] for e in twin.p.adaptive.history()["events"]]
    assert kinds.count("promote") == 2 and kinds.count("canary") >= 2
    assert twin.p.adaptive.target_deltas() == twin.j.adaptive.target_deltas()
    assert twin.p.adaptive.target_deltas()["ad"] <= 0.0
    for eng in twin.engines:
        eng.adaptive.disable()


def test_guardrail_abort_restores_last_known_good_alike(twin):
    twin.load("flow", [{"resource": "mir", "count": 8}])
    _targets(twin, resource="mir", max_block_rate=0.5, rt_p99_ms=1.0,
             floor=1.0, ceiling=64.0, min_entries=8)
    lkg = [eng.adaptive.last_known_good()["flow"] for eng in twin.engines]
    _drive(twin, "mir", 8, 3, rt_ms=50)
    out = _tick(twin)
    assert out["status"] == "proposed"
    statuses = []
    for _ in range(6):
        _drive(twin, "mir", 8, 1, rt_ms=50)
        statuses.append(_tick(twin)["status"])
        twin.shadow_counts()
        if statuses[-1] == "aborted":
            break
    assert statuses[-1] == "aborted"
    assert _books(twin.p) == _books(twin.j)
    for eng, want in zip(twin.engines, lkg):
        assert eng.flow_rules.get_rules() == want
        cand = eng.rollout.candidate(out["candidate"])
        assert cand.stage == "aborted" and "guardrail" in cand.ended_reason
    abort = [e for e in twin.p.adaptive.history()["events"]
             if e["kind"] == "abort"][-1]
    assert abort["lkgIntact"] is True
    reasons = twin.check([("mir", "", None)] * 12)
    assert int((reasons == PASS).sum()) == 8
    _drive(twin, "mir", 8, 1, rt_ms=50)
    assert _tick(twin)["reason"] == "abort-backoff"
    for eng in twin.engines:
        eng.adaptive.disable()


def test_adaptive_never_mutates_rules_directly():
    patterns = [re.compile(r"\.load_rules\s*\("),
                re.compile(
                    r"\.(?:flow|degrade|authority|system|param)_rules\s*="),
                re.compile(r"RolloutManager\s*\(")]
    offenders = []
    for path in sorted((REPO / "sentinel_tpu_torch" / "adaptive")
                       .rglob("*.py")):
        for n, code in _code_lines(path):
            if any(p.search(code) for p in patterns):
                offenders.append(f"{path.name}:{n}")
    assert not offenders, offenders


def test_port_adaptive_keys_only_in_config():
    pattern = re.compile(r"[\"']csp\.sentinel\.(?:adaptive|slo|alert)\."
                         r"[a-z.]+[\"']")
    offenders = []
    for path in sorted((REPO / "sentinel_tpu_torch").rglob("*.py")):
        if path.name == "config.py":
            continue
        offenders += [f"{path}: {m}" for m in
                      pattern.findall(path.read_text())]
    assert not offenders, offenders
