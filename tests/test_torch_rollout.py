"""Staged rollout in the port (``sentinel_tpu_torch/rollout/``, the shadow
lanes and the canary mix of ``ops/step.py``, the engine's shadow plumbing)
against the JAX package's, driven through the same calls.

The scenarios are ``tests/test_rollout.py``'s (and
``tests/test_telemetry.py``'s canary attribution): a JAX engine and a port
engine (``device="cpu"``) on one injected clock receive the same rule
pushes, candidate loads, stage changes and batches. After every step the
decisions and the whole device state, the shadow world included, must be
equal: integer counters and int64 stamps bit for bit, the float rule
state within ``FLOAT_RTOL`` (the harness of ``tests/test_torch_support.py``).
The differential oracle runs the merged candidate as live rules on a
second port engine: its per-resource tallies must equal the shadow's
would-pass / would-block counters.

One engine pair serves the whole module (the JAX reference compiles its
step once per batch width and state structure, ~4.5 s each on the CPU):
every test starts by ending any candidate, pushing empty rule sets and
moving the clock 100 s on to a whole second, and every batch is padded to
one width. The geometry test runs last, since it retunes the pair.

Owed, and left out here: the rollout ops command (``test_rollout.py:395``,
with the ops plane) and the pod shadow psum (``test_rollout.py:440``, with
the pod reduction; the reference cannot run it under jax 0.9.0 either).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import jax.numpy as jnp

from sentinel_tpu.core import checkpoint as jckpt
from sentinel_tpu.core import constants as JC
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.batch import make_entry_batch_np
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.core.exceptions import BlockException as JBlock
from sentinel_tpu.datasource import converters as JCV
from sentinel_tpu.rollout import canary as jcanary
from sentinel_tpu.rollout.manager import _salt_for as jsalt
from sentinel_tpu.utils.param_hash import hash_param

from sentinel_tpu_torch.core import checkpoint as pckpt
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.core.exceptions import BlockException as PBlock
from sentinel_tpu_torch.datasource import converters as PCV
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.ops.window import MIN_RT_EMPTY
from sentinel_tpu_torch.rollout import canary as pcanary
from sentinel_tpu_torch.rollout.manager import (
    STAGE_ABORTED, STAGE_CANARY, STAGE_PROMOTED, STAGE_SHADOW, _salt_for)
from sentinel_tpu_torch.utils.device import SYNCS

from tests.test_torch_support import (assert_decisions_equal,
                                      assert_tree_equal, jax_entry,
                                      jax_to_np, port_np)

BASE_MS = 1_700_000_000_000
WIDTH = 64
CTX = "ctx"
FAMILIES = ("flow", "degrade", "authority", "system", "param")
LOADERS = {"flow": "flow_rules_from_json", "degrade": "degrade_rules_from_json",
           "authority": "authority_rules_from_json",
           "system": "system_rules_from_json",
           "param": "param_rules_from_json"}
MANAGERS = {"flow": "flow_rules", "degrade": "degrade_rules",
            "authority": "authority_rules", "system": "system_rules",
            "param": "param_rules"}

CANDIDATE = {
    "flow": [
        {"resource": "resA", "count": 5, "grade": JC.FLOW_GRADE_QPS},
        {"resource": "resB", "count": 100,
         "controlBehavior": JC.CONTROL_BEHAVIOR_RATE_LIMITER,
         "maxQueueingTimeMs": 5},
    ],
    "authority": [
        {"resource": "resC", "limitApp": "appX",
         "strategy": JC.AUTHORITY_WHITE},
    ],
    "paramFlow": [
        {"resource": "resD", "paramIdx": 0, "count": 3,
         "grade": JC.PARAM_FLOW_GRADE_QPS, "durationInSec": 1},
    ],
}


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def fill(reg, buf, lanes, counts=None, prioritized=False):
    """Stage abstract lanes [(resource, origin, param or None)] into
    ``buf``, resolved against ``reg`` (row ids are per engine)."""
    parent = reg.entrance_row(CTX)
    for i, (res, origin, param) in enumerate(lanes):
        cr, dn, orow, oid = reg.resolve_entry(res, CTX, origin, parent,
                                              int(JC.EntryType.OUT))
        buf["cluster_row"][i] = cr
        buf["dn_row"][i] = dn
        buf["origin_row"][i] = orow
        buf["origin_id"][i] = oid
        buf["context_id"][i] = reg.context_id(CTX)
        buf["count"][i] = 1 if counts is None else counts[i]
        buf["prioritized"][i] = prioritized
        if param is not None:
            buf["param_hash"][i, 0] = hash_param(param)
            buf["param_present"][i, 0] = True
    return buf


def traffic(seed=7, batches=12, width=48):
    """The reference's replayable stream: (now_ms offset, lanes) per batch,
    130 ms apart (bucket and second boundaries)."""
    rng = np.random.default_rng(seed)
    resources = ["resA", "resB", "resC", "resD", "resFree"]
    origins = ["appX", "appY", ""]
    out = []
    for b in range(batches):
        lanes = []
        for _ in range(width):
            res = resources[rng.integers(0, len(resources))]
            origin = origins[rng.integers(0, len(origins))]
            param = int(rng.integers(0, 5)) if res == "resD" else None
            lanes.append((res, origin, param))
        out.append((130 * b, lanes))
    return out


class Twin:
    """A JAX and a port engine on one injected clock, one call stream."""

    def __init__(self, capacity=512, slot_budget=0):
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
            ctx.bump_generation()
        self.clock = Clock(BASE_MS)
        kw = {"slot_budget": slot_budget} if slot_budget else {}
        self.j = JEngine(capacity=capacity, clock=self.clock,
                         journal_path="", **kw)
        self.p = PEngine(capacity=capacity, device="cpu", clock=self.clock,
                         **kw)
        self.engines = (self.j, self.p)

    def close(self):
        for eng in (self.p, self.j):
            eng.close()
        for ctx in (jctx, pctx):
            ctx.replace_context(None)

    def fresh(self):
        """End any candidate, clear every family, move 100 s on to a
        whole second: the next test starts on cold windows."""
        for eng in self.engines:
            if eng.rollout.active_name is not None:
                eng.rollout.abort()
        for fam in FAMILIES:
            self.load(fam, [])
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
        self.clock.now += 200_000 - self.clock.now % 100_000

    def load(self, family, dicts):
        """Push one family on both sides (rules parsed by each package's
        converters), compiled at once: a compile run later by a
        background flush would intern rows at a moment set by thread
        timing."""
        for eng, cv in ((self.j, JCV), (self.p, PCV)):
            eng._flush_committer()
            getattr(eng, MANAGERS[family]).load_rules(
                getattr(cv, LOADERS[family])(list(dicts)))
            with eng._lock:
                eng._ensure_compiled()

    def candidate(self, name, rules, **kw):
        out = [eng.rollout.load_candidate(name, rules, **kw)
               for eng in self.engines]
        return out[1]

    def stage(self, name, stage, **kw):
        for eng in self.engines:
            eng.rollout.set_stage(name, stage, **kw)

    def buf(self, eng, lanes, counts=None, prioritized=False, width=WIDTH):
        return fill(eng.registry, make_entry_batch_np(width), lanes, counts,
                    prioritized)

    def check(self, lanes, now=None, counts=None, prioritized=False):
        """One batch on both sides: equal decisions and equal state (the
        shadow world included). Returns the port's reasons."""
        now = self.clock.now if now is None else now
        jb = self.buf(self.j, lanes, counts, prioritized)
        pb = self.buf(self.p, lanes, counts, prioritized)
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        jd = self.j.check_batch(jax_entry(jb), now_ms=now)
        pd = self.p.check_batch(pb, now_ms=now)
        assert_decisions_equal(jd, pd)
        self.assert_state()
        return pd.reason.numpy()[:len(lanes)].copy()

    def serve(self, res, error=False):
        """One ``entry`` / ``exit`` on both sides through the width-1 API;
        the verdict symbol."""
        out = []
        for eng, block in ((self.j, JBlock), (self.p, PBlock)):
            try:
                with eng.entry(res) as h:
                    if error:
                        h.trace(RuntimeError("boom"))
                out.append("P")
            except block:
                out.append("B")
        assert out[0] == out[1], (res, out)
        return out[1]

    def assert_state(self):
        for eng in self.engines:
            eng._flush_committer()
        with self.j._lock, self.p._lock:
            assert_tree_equal(jax_to_np(self.j._state),
                              port_np(self.p.state))
            if self.j._shadow_rules is None:
                assert self.p._shadow_rules is None
            else:
                assert_tree_equal(jax_to_np(self.j._shadow_rules),
                                  port_np(self.p._shadow_rules))

    def shadow_counts(self):
        jc, pc = self.j.shadow_counts(), self.p.shadow_counts()
        if jc is None:
            assert pc is None
            return None
        np.testing.assert_array_equal(pc, jc)
        return pc


# The widest rule shapes the tests use, pushed once before the first
# compile: the slot floors ratchet to them, so later live and candidate
# packs share one tensor shape and the JAX reference compiles once per
# width and state structure.
WARM_RULES = {
    "flow": [{"resource": "_warm", "count": 1e9},
             {"resource": "_warm", "count": 1e9}],
    "degrade": [{"resource": "_warm", "count": 1, "timeWindow": 5}],
    "authority": [{"resource": "_warm", "limitApp": "x"}],
    "param": [{"resource": "_warm", "paramIdx": 0, "count": 1e9}],
}


@pytest.fixture(scope="module")
def pair():
    tw = Twin()
    for fam, dicts in WARM_RULES.items():
        tw.load(fam, dicts)
    yield tw
    tw.close()


@pytest.fixture
def twin(pair):
    pair.fresh()
    return pair


def fresh_context():
    """Drop this thread's pooled context: one made for another engine
    holds that engine's rows (reset() alone retires it only for the
    default engine)."""
    pctx.replace_context(None)
    pctx.bump_generation()


def enforcer(rules_by_family, clock):
    """The oracle: a port engine that ENFORCES the given rules."""
    fresh_context()
    eng = PEngine(capacity=512, device="cpu", clock=clock)
    for fam, dicts in rules_by_family.items():
        getattr(eng, MANAGERS[fam]).load_rules(
            getattr(PCV, LOADERS[fam])(list(dicts)))
    return eng


def drive_enforced(eng, stream, base, counts_of=None):
    """Per-resource {"pass", "block"} token tallies of an enforcing
    engine over ``stream``."""
    tally = {}
    for off, lanes, *rest in stream:
        counts = rest[0] if rest else None
        buf = fill(eng.registry, make_entry_batch_np(WIDTH), lanes, counts)
        reasons = eng.check_batch(buf, now_ms=base + off).reason.numpy()
        for i, (res, _, _) in enumerate(lanes):
            t = tally.setdefault(res, {"pass": 0, "block": 0})
            t["block" if reasons[i] > 0 else "pass"] += \
                1 if counts is None else int(counts[i])
    return tally


def shadow_tally(eng, counts):
    return {
        res: {"pass": int(counts[S.SH_WOULD_PASS, row]),
              "block": int(counts[S.SH_WOULD_BLOCK, row])}
        for res, row in eng.registry.resources().items()
        if counts[[S.SH_WOULD_PASS, S.SH_WOULD_BLOCK], row].any()}


# -- the canary hash -----------------------------------------------------------


INT32 = hs.integers(-2**31, 2**31 - 1)


@settings(max_examples=60, deadline=None)
@given(origins=hs.lists(INT32, min_size=1, max_size=64),
       contexts=hs.lists(INT32, min_size=1, max_size=64),
       salt=hs.integers(0, 2**31 - 1), bps=hs.integers(0, 10_000))
def test_canary_hash_equals_the_reference_over_int32(origins, contexts,
                                                     salt, bps):
    """The device form (int64, masked to 32 bits after every step, 16-bit
    split products) equals the JAX host and device functions bit for bit
    over the whole int32 range of both ids, negatives included."""
    import torch

    n = min(len(origins), len(contexts))
    o = np.array(origins[:n] + [-2**31, 2**31 - 1, -1, 0], np.int32)
    c = np.array(contexts[:n] + [2**31 - 1, -2**31, -1, 0], np.int32)
    got = pcanary.device_in_canary(torch.from_numpy(o), torch.from_numpy(c),
                                   salt, bps).numpy()
    jdev = np.asarray(jcanary.device_in_canary(jnp.asarray(o),
                                               jnp.asarray(c), salt, bps))
    host = np.array([jcanary.in_canary(int(a), int(b), salt, bps)
                     for a, b in zip(o, c)])
    port_host = np.array([pcanary.in_canary(int(a), int(b), salt, bps)
                          for a, b in zip(o, c)])
    np.testing.assert_array_equal(got, jdev)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(port_host, host)
    assert [pcanary.canary_hash(int(a), int(b), salt) for a, b in zip(o, c)] \
        == [jcanary.canary_hash(int(a), int(b), salt) for a, b in zip(o, c)]


def test_canary_edges_and_salt_match_the_reference():
    import torch

    o = torch.arange(-600, 600, dtype=torch.int32)
    c = torch.full_like(o, 3)
    assert not pcanary.device_in_canary(o, c, 9, 0).any()
    assert pcanary.device_in_canary(o, c, 9, 10_000).all()
    for name in ("v2", "cut", "a-much-longer-candidate-name", ""):
        assert _salt_for(name) == jsalt(name)


# -- shadow exactness: the differential oracle -----------------------------------


def test_shadow_counts_match_real_enforcement_oracle(twin):
    """``test_rollout.py:118``: shadow would-counts equal the tallies of
    an engine that enforces the merged candidate over the same stream, and
    the port's whole state equals the JAX engine's after every batch."""
    twin.load("flow", [{"resource": "resA", "count": 100000}])
    cand = twin.candidate("v2", CANDIDATE)
    assert cand.stage == STAGE_SHADOW and cand.families() == \
        ["flow", "authority", "param"]
    base = twin.clock.now
    stream = traffic()
    for off, lanes in stream:
        twin.clock.now = base + off
        reasons = twin.check(lanes)
        assert (reasons == 0).all()  # the live world blocks nothing
    counts = twin.shadow_counts()
    shadow = shadow_tally(twin.p, counts)

    oracle_eng = enforcer(
        {"flow": CANDIDATE["flow"] + [{"resource": "resFree",
                                        "count": 100000}],
         "authority": CANDIDATE["authority"],
         "param": CANDIDATE["paramFlow"]}, Clock(base))
    try:
        oracle = drive_enforced(oracle_eng, stream, base)
    finally:
        oracle_eng.close()
    for res in ("resA", "resB", "resC", "resD", "resFree"):
        assert shadow.get(res, {"pass": 0, "block": 0}) == \
            oracle.get(res, {"pass": 0, "block": 0}), res
    assert shadow["resA"]["block"] > 0      # QPS
    assert shadow["resB"]["block"] > 0      # rate limiter queue cap
    assert shadow["resC"]["block"] > 0      # authority
    assert shadow["resD"]["block"] > 0      # param flow
    assert shadow["resFree"]["block"] == 0  # untouched resource


def test_shadow_counters_cover_every_target_row(twin):
    """``test_rollout.py:155`` and beyond it: the per-family columns sum
    to the would-block total on EVERY row a lane commits to (cluster,
    default node, origin), the live channels equal the live window's
    PASS / BLOCK commit, and the live world blocked nothing."""
    twin.load("flow", [{"resource": "resA", "count": 100000}])
    twin.candidate("v2", CANDIDATE)
    before = twin.p.telemetry_counts()["totals"]
    base = twin.clock.now
    for off, lanes in traffic():
        twin.clock.now = base + off
        twin.check(lanes)
    counts = twin.shadow_counts()
    rows = twin.p.registry.resources()
    assert counts[S.SH_WB_FLOW, rows["resA"]] > 0
    assert counts[S.SH_WB_AUTHORITY, rows["resC"]] > 0
    assert counts[S.SH_WB_PARAM, rows["resD"]] > 0
    fam = [S.SH_WB_AUTHORITY, S.SH_WB_SYSTEM, S.SH_WB_PARAM, S.SH_WB_FLOW,
           S.SH_WB_DEGRADE]
    np.testing.assert_array_equal(counts[fam].sum(axis=0),
                                  counts[S.SH_WOULD_BLOCK])
    assert counts[S.SH_LIVE_BLOCK].sum() == 0
    # Default-node and origin rows carry the same channels as their
    # cluster rows: every target row of a lane is committed.
    touched = set(np.nonzero(counts.any(axis=0))[0].tolist())
    cluster = {rows[r] for r in ("resA", "resB", "resC", "resD", "resFree")}
    assert cluster < touched, touched
    totals = twin.p.telemetry_counts()["totals"] - before
    np.testing.assert_array_equal(counts[S.SH_LIVE_PASS],
                                  totals[JC.MetricEvent.PASS])
    np.testing.assert_array_equal(
        counts[S.SH_WOULD_PASS] + counts[S.SH_WOULD_BLOCK],
        counts[S.SH_LIVE_PASS] + counts[S.SH_LIVE_BLOCK])


def test_mixed_acquire_counts_oracle(twin):
    """``test_rollout.py:511``: mixed acquire counts take the survivor
    fixpoint loop in both worlds, and the token tallies still agree."""
    twin.load("flow", [{"resource": "resM", "count": 100000}])
    twin.candidate("vm", {"flow": [{"resource": "resM", "count": 9}]})
    rng = np.random.default_rng(3)
    base = twin.clock.now
    stream = []
    for b in range(6):
        stream.append((300 * b, [("resM", "", None)] * 16,
                       rng.integers(1, 6, size=16)))
    for off, lanes, counts in stream:
        twin.clock.now = base + off
        twin.check(lanes, counts=counts)
    shadow = shadow_tally(twin.p, twin.shadow_counts())["resM"]
    oracle_eng = enforcer({"flow": [{"resource": "resM", "count": 9}]},
                          Clock(base))
    try:
        tally = drive_enforced(oracle_eng, stream, base)["resM"]
    finally:
        oracle_eng.close()
    assert shadow == tally
    assert tally["block"] > 0 and tally["pass"] > 0


def test_shadow_of_the_live_rules_mirrors_the_live_world(twin):
    """A candidate equal to the live rules gives the live world's windows
    and verdicts in the shadow lanes, and the live world runs exactly as
    an engine with no candidate does (no write crosses between them)."""
    rules = {
        "flow": [{"resource": "resA", "count": 4},
                 {"resource": "resB", "count": 50,
                  "controlBehavior": JC.CONTROL_BEHAVIOR_RATE_LIMITER,
                  "maxQueueingTimeMs": 20},
                 {"resource": "resD", "count": 2,
                  "grade": JC.FLOW_GRADE_THREAD}],
        "authority": [{"resource": "resC", "limitApp": "appX"}],
        "param": [{"resource": "resD", "paramIdx": 0, "count": 6}],
    }
    base = twin.clock.now
    clock = Clock(base)
    shadowed, plain = enforcer(rules, clock), enforcer(rules, clock)
    try:
        shadowed.rollout.load_candidate("same", rules)
        for fam, dicts in rules.items():
            twin.load(fam, dicts)
        twin.candidate("same", rules)
        for off, lanes in traffic(seed=5, batches=8):
            twin.clock.now = clock.now = base + off
            twin.check(lanes)  # the port equals the reference
            got = [eng.check_batch(fill(eng.registry,
                                        make_entry_batch_np(WIDTH), lanes))
                   for eng in (shadowed, plain)]
            for f in got[0]._fields:
                np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                              getattr(got[1], f).numpy())
        counts = shadowed.shadow_counts()
        np.testing.assert_array_equal(counts[S.SH_WOULD_PASS],
                                      counts[S.SH_LIVE_PASS])
        np.testing.assert_array_equal(counts[S.SH_WOULD_BLOCK],
                                      counts[S.SH_LIVE_BLOCK])
        assert counts[S.SH_LIVE_BLOCK].sum() > 0
        with shadowed._lock, plain._lock:
            live, ref = port_np(shadowed.state), port_np(plain.state)
        shadow = live.pop("shadow")
        assert_tree_equal(ref, live)
        pass_ev = JC.MetricEvent.PASS
        np.testing.assert_array_equal(shadow["w1"]["counts"][:, pass_ev],
                                      live["w1"]["counts"][:, pass_ev])
        np.testing.assert_array_equal(shadow["w1"]["starts"],
                                      live["w1"]["starts"])
    finally:
        shadowed.close()
        plain.close()


def test_shadow_degrade_fed_by_live_completions(twin):
    """``test_rollout.py:174``: a candidate breaker trips from the LIVE
    exit stream (width-1 entries and exits) and its would-block shows up."""
    twin.candidate("brk", {"degrade": [{
        "resource": "resE", "count": 3,
        "grade": JC.DEGRADE_GRADE_EXCEPTION_COUNT, "timeWindow": 10,
        "minRequestAmount": 1, "statIntervalMs": 10_000}]})
    for _ in range(8):
        assert twin.serve("resE", error=True) == "P"
    twin.assert_state()
    counts = twin.shadow_counts()
    row = twin.p.registry.resources()["resE"]
    assert counts[S.SH_LIVE_BLOCK, row] == 0
    assert counts[S.SH_WB_DEGRADE, row] > 0


# -- canary -----------------------------------------------------------------------


def test_canary_assignment_deterministic_and_matches_host(twin):
    """``test_rollout.py:191``."""
    twin.load("flow", [{"resource": "resK", "count": 100000}])
    cand = twin.candidate("cut", {"flow": [{"resource": "resK",
                                            "count": 0}]})
    twin.stage("cut", STAGE_CANARY, canary_bps=5000)
    assert cand.canary_bps == 5000
    assert twin.p._canary_bps == twin.j._canary_bps == 5000
    assert twin.p._canary_salt == twin.j._canary_salt == _salt_for("cut")
    lanes = [("resK", f"origin{i}", None) for i in range(64)]
    r1 = twin.check(lanes) > 0
    twin.clock.now += 5000
    r2 = twin.check(lanes) > 0
    np.testing.assert_array_equal(r1, r2)
    buf = twin.buf(twin.p, lanes)
    expect = np.array([jcanary.in_canary(int(o), int(c), _salt_for("cut"),
                                         5000)
                       for o, c in zip(buf["origin_id"], buf["context_id"])])
    np.testing.assert_array_equal(r1, expect)
    assert 10 < int(expect.sum()) < 54


def test_canary_bps_zero_and_full(twin):
    """``test_rollout.py:222``."""
    twin.load("flow", [{"resource": "resK", "count": 100000}])
    twin.candidate("cut", {"flow": [{"resource": "resK", "count": 0}]})
    lanes = [("resK", f"origin{i}", None) for i in range(32)]
    twin.stage("cut", STAGE_CANARY, canary_bps=0)
    assert (twin.check(lanes) == 0).all()
    twin.stage("cut", STAGE_CANARY, canary_bps=10_000)
    twin.clock.now += 10_000
    assert (twin.check(lanes) == int(JC.BlockReason.FLOW)).all()


def test_canary_leaves_pre_decided_and_granted_lanes_live(twin):
    """The mix governs only undecided lanes: pre-blocked and pre-passed
    lanes keep their verdict, and an occupy-granted prioritized lane stays
    live-governed, at a full (10,000 bps) slice."""
    twin.load("flow", [{"resource": "resK", "count": 2}])
    twin.candidate("cut", {"flow": [{"resource": "resK", "count": 0}]},
                   stage=STAGE_CANARY, canary_bps=10_000)
    lanes = [("resK", "", None)] * 6
    jb = twin.buf(twin.j, lanes, prioritized=True)
    pb = twin.buf(twin.p, lanes, prioritized=True)
    for b in (jb, pb):
        b["pre_passed"][0] = True
        b["pre_blocked"][1] = True
        b["pre_reason"][1] = int(JC.BlockReason.FLOW)
    now = twin.clock.now + 100  # mid-bucket: borrows can be granted
    # Fill the live quota first so prioritized lanes borrow.
    twin.clock.now = now
    jd = twin.j.check_batch(jax_entry(jb), now_ms=now)
    pd = twin.p.check_batch(pb, now_ms=now)
    assert_decisions_equal(jd, pd)
    twin.assert_state()
    reasons, waits = pd.reason.numpy(), pd.wait_us.numpy()
    flow = int(JC.BlockReason.FLOW)
    assert reasons[0] == 0 and reasons[1] == flow  # pre-decided: kept
    assert (reasons[2:4] == flow).all()  # live passes, the candidate blocks
    # Live-blocked prioritized lanes borrow the next bucket: granted, they
    # stay live-governed (a wait, not the candidate's block).
    assert (reasons[4:6] == 0).all() and (waits[4:6] > 0).all()


def test_attribution_exact_under_canary_enforcement(twin):
    """``test_telemetry.py:174``: canary-enforced lanes attribute to the
    candidate's verdict (the reason after the mix), as a replay of the
    candidate as live rules does."""
    twin.load("flow", [{"resource": "c", "count": 100000}])
    twin.candidate("vc", {"flow": [{"resource": "c", "count": 2}]},
                   stage=STAGE_CANARY, canary_bps=10_000)
    reasons = twin.check([("c", "", None)] * 5)
    assert int((reasons > 0).sum()) == 3
    oracle_eng = enforcer({"flow": [{"resource": "c", "count": 2}]},
                          Clock(twin.clock.now))
    try:
        tally = drive_enforced(oracle_eng, [(0, [("c", "", None)] * 5)],
                               twin.clock.now)
        want = oracle_eng.telemetry_counts()
    finally:
        oracle_eng.close()
    assert tally["c"]["block"] == 3
    jt, pt = twin.j.telemetry_counts(), twin.p.telemetry_counts()
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    row, orow = (twin.p.registry.resources()["c"],
                 oracle_eng.registry.resources()["c"])
    np.testing.assert_array_equal(pt["blockByReason"][:, row],
                                  want["blockByReason"][:, orow])
    assert int(pt["blockByReason"][:, row].sum()) == 3


# -- guardrail, promote, staged sources -------------------------------------------


def test_guardrail_auto_abort(twin):
    """``test_rollout.py:239``: three breached windows abort; the shadow
    world is torn down and the guardrail state equals the reference's."""
    twin.load("flow", [{"resource": "resG", "count": 100000}])
    for eng in twin.engines:
        eng.rollout.min_window_entries = 8
        eng.rollout.abort_windows = 3
    twin.candidate("bad", {"flow": [{"resource": "resG", "count": 0}]})
    lanes = [("resG", "", None)] * 16
    epoch = twin.p.rollout.promotion_epoch

    def window():
        twin.check(lanes)
        twin.clock.now += 1000
        out = [eng.rollout.tick(now_ms=twin.clock.now)
               for eng in twin.engines]
        assert out[0] == out[1]
        return out[1]

    assert window()["status"] == "baseline"
    t1, t2, t3 = window(), window(), window()
    assert t1["breach"] and t1["breachStreak"] == 1
    assert t1["windowsToAbort"] == 2
    assert t2["breachStreak"] == 2
    assert t3["status"] == "aborted"
    p = twin.p.rollout
    assert p.active_name is None
    assert p.candidate("bad").stage == STAGE_ABORTED
    assert "guardrail" in p.candidate("bad").ended_reason
    assert twin.shadow_counts() is None
    assert twin.p._shadow_rules is None
    assert p.guardrail_state() == twin.j.rollout.guardrail_state()
    assert p.guardrail_state()["promotionEpoch"] == epoch
    assert p.snapshot() == twin.j.rollout.snapshot()
    twin.assert_state()


def test_guardrail_tolerates_matching_block_rates(twin):
    """``test_rollout.py:274``."""
    twin.load("flow", [{"resource": "resH", "count": 3}])
    for eng in twin.engines:
        eng.rollout.min_window_entries = 8
    twin.candidate("same", {"flow": [{"resource": "resH", "count": 3}]})
    lanes = [("resH", "", None)] * 16
    out = [eng.rollout.tick(now_ms=twin.clock.now) for eng in twin.engines]
    for _ in range(4):
        twin.check(lanes)
        twin.clock.now += 1000
        out = [eng.rollout.tick(now_ms=twin.clock.now)
               for eng in twin.engines]
        assert out[0] == out[1]
    assert out[1]["status"] == "ok" and not out[1]["breach"]
    assert twin.p.rollout.active_name == "same"
    assert twin.p.rollout.diff() == twin.j.rollout.diff()


def test_promote_swaps_into_live_rules(twin):
    """``test_rollout.py:292``: the merged candidate goes live through the
    rule managers, the shadow is torn down, leases come back."""
    twin.load("flow", [{"resource": "resP", "count": 100000},
                       {"resource": "other", "count": 7}])
    twin.candidate("v3", {"flow": [{"resource": "resP", "count": 2}]})
    assert twin.p._leases == {}
    epoch = twin.p.rollout.promotion_epoch
    outs = [eng.rollout.promote("v3") for eng in twin.engines]
    assert outs[0] == outs[1]
    assert outs[1]["promoted"] == "v3" and outs[1]["epoch"] == epoch + 1
    live = twin.p.flow_rules.get_rules()
    by_res = {r.resource: r for r in live}
    assert by_res["resP"].count == 2
    assert by_res["other"].count == 7
    assert all(r.candidate_set is None for r in live)
    assert [PCV.flow_rule_to_dict(r) for r in live] == \
        [JCV.flow_rule_to_dict(r) for r in twin.j.flow_rules.get_rules()]
    assert twin.shadow_counts() is None
    assert twin.p._shadow_rules is None
    assert "resP" in twin.p._leases  # the fast path is back
    verdicts = [twin.serve("resP") for _ in range(6)]
    assert verdicts.count("B") == 4
    twin.assert_state()
    assert twin.p.rollout.candidate("v3").stage == STAGE_PROMOTED


def test_datasource_tagged_rules_become_candidate(twin):
    """``test_rollout.py:319``."""
    twin.load("flow", [
        {"resource": "resS", "count": 50},
        {"resource": "resS", "count": 5, "candidateSet": "cv",
         "rolloutStage": "shadow"}])
    for eng in twin.engines:
        assert [r.count for r in eng.flow_rules.get_rules()] == [50]
        assert [r.count for r in eng.flow_rules.get_staged("cv")] == [5]
    p = twin.p.rollout
    assert p.active_name == "cv"
    assert p.active_set().stage == STAGE_SHADOW
    assert p.active_set().source == "datasource"
    assert twin.p._dirty["rollout"] is False  # compiled at the push
    twin.check([("resS", "", None)] * 8)
    assert twin.shadow_counts() is not None
    twin.load("flow", [{"resource": "resS", "count": 50}])
    assert p.active_name is None
    assert twin.j.rollout.active_name is None
    assert p.candidate("cv").ended_reason == "staged rules removed at source"


def test_republish_does_not_demote_ops_escalated_canary(twin):
    """``test_rollout.py:337``."""
    tagged = [{"resource": "resT", "count": 50},
              {"resource": "resT", "count": 5, "candidateSet": "cv"}]
    twin.load("flow", tagged)
    p = twin.p.rollout
    assert p.active_set().stage == STAGE_SHADOW
    twin.stage("cv", STAGE_CANARY, canary_bps=2500)
    twin.load("flow", tagged)
    assert p.active_set().stage == STAGE_CANARY
    assert p.active_set().canary_bps == 2500
    assert twin.p._canary_bps == twin.j._canary_bps == 2500
    twin.load("flow", [{"resource": "resT", "count": 50},
                       {"resource": "resT", "count": 5, "candidateSet": "cv",
                        "rolloutStage": "shadow"}])
    assert p.active_set().stage == STAGE_CANARY
    for eng in twin.engines:
        eng.rollout.abort("cv")
    twin.load("flow", [{"resource": "resU", "count": 5, "candidateSet": "cw",
                        "rolloutStage": "canary"}])
    assert p.active_set().stage == STAGE_CANARY
    assert p.active_set().canary_bps > 0
    assert p.snapshot() == twin.j.rollout.snapshot()


def test_rollout_disables_lease_fast_path(twin):
    """``test_rollout.py:385``: leases and the unruled pass stand down
    while a candidate holds the device and come back after abort."""
    twin.load("flow", [{"resource": "resL", "count": 100}])
    assert "resL" in twin.p._leases and twin.p._unruled_fastpath
    twin.candidate("v4", {"flow": [{"resource": "resL", "count": 1}]})
    assert twin.p._leases == {} and not twin.p._unruled_fastpath
    # Every entry reaches the step: the shadow sees each one.
    for _ in range(3):
        twin.serve("resL")
        twin.serve("unruledName")
    counts = twin.shadow_counts()
    rows = twin.p.registry.resources()
    assert counts[S.SH_WOULD_PASS, rows["resL"]] == 1
    assert counts[S.SH_WOULD_BLOCK, rows["resL"]] == 2
    assert counts[S.SH_LIVE_PASS, rows["unruledName"]] == 3
    for eng in twin.engines:
        eng.rollout.abort("v4")
    assert "resL" in twin.p._leases and twin.p._unruled_fastpath
    twin.assert_state()


def test_second_active_candidate_rejected(twin):
    """``test_rollout.py:432``."""
    twin.candidate("one", {"flow": [{"resource": "rX", "count": 1}]})
    with pytest.raises(ValueError, match="already shadow"):
        twin.p.rollout.load_candidate(
            "two", {"flow": [{"resource": "rY", "count": 1}]})


def test_lifecycle_listeners_fire_under_the_config_lock(twin):
    """Listeners see every promote and abort, fired under the config lock,
    in the reference's order."""
    seen = {}

    def listener_for(eng):
        out = seen.setdefault(eng, [])
        return lambda event, cand, reason: out.append(
            (event, cand.name, reason, eng._config_lock._is_owned()))

    for eng in twin.engines:
        eng.rollout.add_lifecycle_listener(listener_for(eng))
    try:
        twin.candidate("l1", {"flow": [{"resource": "rZ", "count": 1}]})
        for eng in twin.engines:
            eng.rollout.abort("l1", reason="done")
        twin.candidate("l2", {"flow": [{"resource": "rZ", "count": 1}]})
        for eng in twin.engines:
            eng.rollout.promote("l2")
    finally:
        for eng in twin.engines:
            eng.rollout._listeners.clear()
    assert seen[twin.p] == [("aborted", "l1", "done", True),
                            ("promoted", "l2", None, True)]
    assert seen[twin.j] == seen[twin.p]


def test_rollout_tags_round_trip_json():
    """``test_rollout.py:370``: the tags travel both ways, and untagged
    rules keep the wire schema byte for byte (the JAX converters' bytes)."""
    src = ('[{"resource": "r", "count": 5, "candidateSet": "cv", '
           '"rolloutStage": "canary"}]')
    rules = PCV.flow_rules_from_json(src)
    assert rules[0].candidate_set == "cv"
    assert rules[0].rollout_stage == "canary"
    d = PCV.flow_rule_to_dict(rules[0])
    assert d["candidateSet"] == "cv" and d["rolloutStage"] == "canary"
    assert PCV.flow_rules_to_json(rules) == \
        JCV.flow_rules_to_json(JCV.flow_rules_from_json(src))
    plain = [{"resource": "r", "count": 5}]
    for fam in ("flow", "degrade", "authority", "system", "param"):
        j = getattr(JCV, f"{fam}_rules_to_json")(
            getattr(JCV, f"{fam}_rules_from_json")(plain))
        p = getattr(PCV, f"{fam}_rules_to_json")(
            getattr(PCV, f"{fam}_rules_from_json")(plain))
        assert p == j, fam
        assert "candidateSet" not in p and "rolloutStage" not in p
        tagged = [dict(plain[0], candidateSet="x", rolloutStage="shadow")]
        assert getattr(PCV, f"{fam}_rules_to_json")(
            getattr(PCV, f"{fam}_rules_from_json")(tagged)) == \
            getattr(JCV, f"{fam}_rules_to_json")(
                getattr(JCV, f"{fam}_rules_from_json")(tagged))


# -- host syncs, races -------------------------------------------------------------


def test_candidate_adds_syncs_and_abort_restores_them(twin):
    """No candidate: the step's host syncs are what they were; a
    candidate's cascade adds its own; after abort they return exactly."""
    twin.load("flow", [{"resource": "resA", "count": 3}])
    twin.load("param", [{"resource": "resD", "paramIdx": 0, "count": 6}])
    lanes = traffic(seed=9, batches=1)[0][1]
    counted = []
    step = twin.p._entry_step

    def counting(*a, **kw):
        before = SYNCS.count
        out = step(*a, **kw)
        counted.append(SYNCS.count - before)
        return out

    twin.p._entry_step = counting
    try:
        for k in range(3):
            if k == 1:
                twin.candidate("s", CANDIDATE)
            if k == 2:
                for eng in twin.engines:
                    eng.rollout.abort("s")
            twin.clock.now += 1000
            twin.check(lanes)
    finally:
        twin.p._entry_step = step
    base, with_candidate, after = counted
    assert after == base
    assert with_candidate > base


def _bounded(fn, seconds):
    """Run ``fn`` on a daemon thread; fail if it has not ended in time."""
    err = []

    def run():
        try:
            fn()
        except BaseException as ex:  # noqa: BLE001 — reported below
            err.append(ex)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"deadlock: still running after {seconds} s"
    if err:
        raise err[0]


def _race(eng, drive, seconds=30.0):
    """``drive(stop)`` on two threads while a third stages, escalates and
    ends candidates; nothing may deadlock or fail open."""
    stop = threading.Event()

    def stager():
        for k in range(12):
            name = f"race{k}"
            eng.rollout.load_candidate(
                name, {"flow": [{"resource": "hot", "count": 2}]})
            time.sleep(0.002)
            eng.rollout.set_stage(name, STAGE_CANARY, canary_bps=5000)
            time.sleep(0.002)
            if k % 2:
                eng.rollout.abort(name)
            else:
                eng.rollout.promote(name)
                eng.flow_rules.load_rules(
                    PCV.flow_rules_from_json([{"resource": "hot",
                                               "count": 1000}]))

    def all_of():
        workers = [threading.Thread(target=drive, args=(stop,), daemon=True)
                   for _ in range(2)]
        for w in workers:
            w.start()
        try:
            stager()
        finally:
            stop.set()
            for w in workers:
                w.join()

    _bounded(all_of, seconds)
    assert eng.fail_open_count == 0
    assert eng.rollout.active_name is None


def test_pipeline_cycles_run_through_the_shadow_lanes():
    """With the pipeline running, a tagged push stages a candidate and
    every collector cycle runs its lanes: each entry shows in the shadow
    counters, as its own lane."""
    fresh_context()
    clock = Clock(BASE_MS)
    eng = PEngine(capacity=512, device="cpu", clock=clock)
    eng.start_pipeline(max_batch=8, linger_s=0.0005)
    try:
        eng.flow_rules.load_rules(PCV.flow_rules_from_json(
            [{"resource": "piped", "count": 1000},
             {"resource": "piped", "count": 3, "candidateSet": "pc"}]))
        assert eng.rollout.active_name == "pc"
        verdicts = []
        for _ in range(10):
            try:
                eng.entry("piped").exit()
                verdicts.append("P")
            except PBlock:
                verdicts.append("B")
        counts = eng.shadow_counts()
        row = eng.registry.resources()["piped"]
        assert verdicts == ["P"] * 10  # live count 1000
        assert counts[S.SH_LIVE_PASS, row] == 10
        assert counts[S.SH_WOULD_PASS, row] == 3
        assert counts[S.SH_WOULD_BLOCK, row] == 7
        assert eng.pipeline_stats()["cycles"] >= 1
        assert eng.fail_open_count == 0
    finally:
        eng.close()
        pctx.replace_context(None)


def test_stage_changes_race_the_committer_without_deadlock():
    fresh_context()
    eng = PEngine(capacity=512, device="cpu")
    eng.flow_rules.load_rules(PCV.flow_rules_from_json(
        [{"resource": "hot", "count": 1000}]))

    def drive(stop):
        while not stop.is_set():
            for res in ("hot", "cold", "hot"):
                try:
                    eng.entry(res).exit()
                except PBlock:
                    pass

    try:
        for res in ("hot", "cold"):
            eng.entry(res).exit()  # leased and unruled: the committer runs
        committer = eng.committer
        assert committer is not None
        _race(eng, drive)
        eng._flush_committer()
        assert committer.failures == 0 and committer.pending() == (0, 0)
    finally:
        eng.close()
        pctx.replace_context(None)


def test_stage_changes_race_the_pipeline_without_deadlock():
    fresh_context()
    eng = PEngine(capacity=512, device="cpu")
    eng.flow_rules.load_rules(PCV.flow_rules_from_json(
        [{"resource": "hot", "count": 1000}]))
    eng.start_pipeline(max_batch=8, linger_s=0.0005)

    def drive(stop):
        while not stop.is_set():
            try:
                eng.entry("hot").exit()
            except PBlock:
                pass

    try:
        _race(eng, drive)
        assert eng.pipeline_stats()["cycles"] > 0
    finally:
        eng.close()
        pctx.replace_context(None)


# -- slot mode, restore, geometry -------------------------------------------------


def test_slot_surgery_zeroes_the_shadow_columns():
    """Slot mode with a datasource-staged candidate (pinned before its
    compile): through steals and rehydrations both engines stay equal,
    shadow included, and every surgery leaves the touched shadow columns
    zero (never grafted)."""
    import random

    from tests.test_torch_slots import Twin as SlotTwin

    names = [f"oracle{i}" for i in range(16)]
    tw = SlotTwin(8, [(names[i], 3) for i in (0, 5, 10)])
    checked = []

    def watch(eng):
        execute = eng.slots._execute

        def zeroed(evicts, admits, now_ms):
            execute(evicts, admits, now_ms)
            touched = sorted({s for _, s, _ in evicts} | {s for _, s in admits})
            with eng._lock:
                sh = eng.state.shadow
                assert sh is not None
                assert not sh.counts[:, touched].any()
                assert not sh.w1.counts[:, :, touched].any()
                assert (sh.w1.min_rt[:, touched] == MIN_RT_EMPTY).all()
            checked.append(len(touched))

        eng.slots._execute = zeroed

    try:
        flow = [{"resource": names[i], "count": 3} for i in (0, 5, 10)]
        staged = flow + [{"resource": names[0], "count": 1,
                          "candidateSet": "slotc"},
                         {"resource": names[3], "count": 2,
                          "candidateSet": "slotc"}]
        tw.j.flow_rules.load_rules(JCV.flow_rules_from_json(staged))
        tw.p.flow_rules.load_rules(PCV.flow_rules_from_json(staged))
        assert tw.p.rollout.active_name == "slotc"
        # The candidate-only resource was pinned hot before its compile.
        assert names[3] in tw.p._slot_pinned_resources()
        assert tw.p.slots.current(names[3]) is not None
        watch(tw.p)
        weights = [1.0 / (i + 1) ** 1.2 for i in range(16)]
        rng = random.Random(1234)
        for _sec in range(10):
            for _ in range(20):
                tw.serve(rng.choices(names, weights=weights)[0])
            tw.second()
        tw.assert_same()
        assert np.array_equal(tw.p.shadow_counts(), tw.j.shadow_counts())
        status = tw.p.slots.status()
        assert status["evictionsTotal"] > 0 and status["rehydrationsTotal"] > 0
        assert checked and sum(checked) > 0
        assert tw.p.shadow_counts()[S.SH_WOULD_BLOCK].sum() > 0
    finally:
        tw.close()


def test_restore_with_a_candidate_staged_installs_a_fresh_shadow(twin,
                                                                 tmp_path):
    """A checkpoint never carries the shadow world: a restore with a
    candidate staged rebuilds a FRESH one on both engines, and the next
    batches stay equal."""
    twin.load("flow", [{"resource": "resA", "count": 100000}])
    twin.candidate("v2", CANDIDATE)
    base = twin.clock.now
    stream = traffic(seed=4, batches=6)
    for off, lanes in stream[:3]:
        twin.clock.now = base + off
        twin.check(lanes)
    assert twin.shadow_counts().sum() > 0
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jckpt.save_checkpoint(twin.j, jpath)
    pckpt.save_checkpoint(twin.p, ppath)
    jckpt.restore_checkpoint(twin.j, jpath, force=True)
    pckpt.restore_checkpoint(twin.p, ppath, force=True)
    twin.assert_state()
    assert twin.shadow_counts().sum() == 0  # fresh, not restored
    for off, lanes in stream[3:]:
        twin.clock.now = base + off
        twin.check(lanes)
    assert twin.shadow_counts().sum() > 0


def test_geometry_push_during_a_shadow_rebuilds_its_window(twin):
    """A geometry push resets the live instant window and marks the
    rollout dirty: the shadow world is rebuilt under the new spec at the
    next compile, as the reference does. (Runs last: it retunes the pair.)"""
    twin.load("flow", [{"resource": "resA", "count": 100000}])
    twin.candidate("v2", CANDIDATE)
    base = twin.clock.now
    stream = traffic(seed=6, batches=8)
    for off, lanes in stream[:4]:
        twin.clock.now = base + off
        twin.check(lanes)
    for eng in twin.engines:
        assert eng.window_geometry_property.update_value(
            {"intervalMs": 2000, "sampleCount": 4})
    assert twin.p._dirty["rollout"]
    for off, lanes in stream[4:]:
        twin.clock.now = base + off
        twin.check(lanes)
    with twin.p._lock:
        assert twin.p.state.shadow.w1.counts.shape[0] == 4
    assert twin.shadow_counts()[S.SH_WOULD_BLOCK].sum() > 0
