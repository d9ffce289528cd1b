"""The namespace telescope in the port (``telemetry/population.py`` and the
engine's feed) against the JAX package's (the scenarios of
``tests/test_population.py``).

The sketches are pure host code in both packages: the same streams must
give the same cells, registers, pages and reports, bit for bit (pages
are compared as canonical JSON). The engine tests feed the same batches
to a JAX engine and a port engine (``device="cpu"``) and compare
``population_report``; the port alone is held to the reference's A/B
guard: the telescope adds no device dispatch and no host sync.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

from sentinel_tpu.cluster.sharding import slice_of as jslice_of
from sentinel_tpu.core import constants as JC
from sentinel_tpu.core.batch import make_entry_batch_np
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.telemetry import population as JP

from sentinel_tpu_torch.core.config import POPULATION_ENABLED
from sentinel_tpu_torch.core.config import config as pconfig
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.models.flow import FlowRule as PFlowRule
from sentinel_tpu_torch.telemetry import population as PP
from sentinel_tpu_torch.utils.device import SYNCS

from tests.test_torch_support import jax_entry

BASE_MS = 1_700_000_000_000
WIN_MS = 10_000  # csp.sentinel.population.window.seconds default


def _canon(page):
    return json.dumps(page, sort_keys=True, separators=(",", ":"))


def _stream(seed, n_keys, n):
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(n_keys)]
    weights = [1.0 / (i + 1) ** 1.1 for i in range(n_keys)]
    return rng.choices(keys, weights, k=n)


# -- sketches: the same cells for the same stream ---------------------------


def test_sketch_hash_and_slice_of_equal_the_reference():
    for key in ("", "a", "res/42", "ünïcode", "k" * 300):
        assert PP.sketch_hash(key) == JP.sketch_hash(key)
        assert PP.sketch_hash(key.encode("utf-8")) == \
            JP.sketch_hash(key.encode("utf-8"))
    for fid in (0, 1, 7, 2**31 - 1, 2**40 + 3):
        for n in (1, 8, 64):
            assert PP.slice_of(fid, n) == jslice_of(fid, n)


@pytest.mark.parametrize("seed,n_keys,k", [(3, 300, 50), (17, 120, 32)])
def test_space_saving_equals_the_reference(seed, n_keys, k):
    stream = _stream(seed, n_keys, 4000)
    ours, ref = PP.SpaceSaving(k), JP.SpaceSaving(k)
    exact = {}
    for key in stream:
        inc = 1 + len(key) % 3
        ours.update(key, inc)
        ref.update(key, inc)
        exact[key] = exact.get(key, 0) + inc
    assert ours.top() == ref.top()
    assert ours.floor() == ref.floor()
    for key, count, err in ours.top():
        assert exact[key] <= count <= exact[key] + err


def test_cms_and_hll_equal_the_reference():
    stream = _stream(5, 2000, 6000)
    cms = (PP.CountMinSketch(4, 64), JP.CountMinSketch(4, 64))
    hll = (PP.HyperLogLog(11), JP.HyperLogLog(11))
    for key in stream:
        h = PP.sketch_hash(key)
        for sk in cms:
            sk.update(h, 2)
        for sk in hll:
            sk.add(h)
    assert cms[0].rows == cms[1].rows
    assert cms[0].query(PP.sketch_hash("k1")) == \
        cms[1].query(JP.sketch_hash("k1"))
    assert hll[0].registers == hll[1].registers
    assert hll[0].estimate() == hll[1].estimate()
    assert hll[0].b64() == hll[1].b64()


def _tracker(mod, transition=None):
    return mod.PopulationTracker(now_ms=lambda: BASE_MS,
                                 transition=transition)


def _page_from(mod, stream, windows=2):
    tr = _tracker(mod)
    per = max(1, len(stream) // windows)
    now = BASE_MS
    for i in range(0, len(stream), per):
        tr.observe_pairs([(k, 1) for k in stream[i:i + per]])
        tr.roll(now)
        now += WIN_MS
    tr.roll(now)
    return tr.page()


def test_pages_merge_summary_and_report_equal_the_reference():
    streams = [_stream(s, 400, 1500) for s in (1, 2, 3)]
    ours = [_page_from(PP, s) for s in streams]
    ref = [_page_from(JP, s) for s in streams]
    for a, b in zip(ours, ref):
        assert _canon(a) == _canon(b)
    merged = PP.merge_pages(ours)
    assert _canon(merged) == _canon(JP.merge_pages(ref))
    # associative and commutative, bit for bit
    assert _canon(PP.merge_pages([PP.merge_pages(ours[:2]), ours[2]])) == \
        _canon(PP.merge_pages([ours[2], PP.merge_pages(ours[1::-1])]))
    assert PP.page_summary(merged) == JP.page_summary(merged)
    for budget in (4, 32, 64, 4096):
        assert PP.report_from_page(merged, budget) == \
            JP.report_from_page(merged, budget)
    assert PP.projection_curve(merged, (1, 8, 100)) == \
        JP.projection_curve(merged, (1, 8, 100))
    assert PP.merge_pages([]) == {}
    bad = dict(ours[0], geom=dict(ours[0]["geom"], k=1))
    with pytest.raises(ValueError, match="geometry"):
        PP.merge_pages([ours[0], bad])
    cap = ours[0]
    assert _canon(PP.PopulationTracker.page(_feed(PP, cap), 2048)) == \
        _canon(JP.PopulationTracker.page(_feed(JP, cap), 2048))


def _feed(mod, page):
    """A tracker fed a page's top-k as one window (for the byte cap)."""
    tr = _tracker(mod)
    tr.observe_pairs([(k, c) for k, c, _e in page["ss"]["entries"]])
    tr.roll(BASE_MS)
    tr.roll(BASE_MS + WIN_MS)
    return tr


# -- the tracker: windows, churn, alarm, disabled ------------------------------


def _snap(tr):
    snap = tr.snapshot()
    snap.pop("foldMsTotal")  # a duration, measured
    return snap


def test_tracker_windows_and_churn_equal_the_reference():
    trs = [_tracker(PP), _tracker(JP)]
    for tr in trs:
        tr.observe_pairs([("a", 6), ("b", 4)])
        tr.roll(BASE_MS)
        tr.observe("a", 2)
        tr.roll(BASE_MS + 1000)
        tr.observe("c", 1)
        tr.roll(BASE_MS + WIN_MS)
        tr.roll(BASE_MS + 2 * WIN_MS)
    ours, ref = trs
    assert ours.series() == ref.series()
    assert _snap(ours) == _snap(ref)
    assert ours.observed_total == 13 and ours.folded_keys == 4
    assert ours.series()[1]["entered"] == 1
    assert ours.report(2) == ref.report(2)


def test_cardinality_alarm_fires_and_resolves_like_the_reference():
    fired = {"p": [], "j": []}
    trs = {"p": _tracker(PP, lambda *a: fired["p"].append(a)),
           "j": _tracker(JP, lambda *a: fired["j"].append(a))}
    steady = [(f"s{i}", 1) for i in range(6)]
    for tr in trs.values():
        now = BASE_MS
        for i in range(13):
            tr.observe_pairs(steady[:5 + i % 2])
            tr.roll(now)
            now += WIN_MS
        tr.observe_pairs([(f"blow{i}", 1) for i in range(400)])
        tr.roll(now)
        tr.roll(now + WIN_MS)
        assert tr.alarm is True
        tr.observe_pairs(steady[:5])
        tr.roll(now + 2 * WIN_MS)
        assert tr.alarm is False
    assert fired["p"] == fired["j"]
    firing = [f for f in fired["p"] if f[1]]
    assert firing and firing[-1][0] == PP.PopulationTracker.ALERT_KEY
    assert firing[-1][3]["z"] > 4.0
    assert _snap(trs["p"]) == _snap(trs["j"])


def test_no_observation_when_disabled():
    pconfig.set(POPULATION_ENABLED, "false")
    try:
        tr = _tracker(PP)
        assert tr.enabled is False
        tr.observe("x", 5)
        tr.observe_pairs([("y", 1)])
        tr.observe_rows(np.array([3]), np.array([1]), [None] * 4)
        tr.roll(BASE_MS)
        assert tr.observed_total == 0 and tr.fold_count == 0
    finally:
        pconfig.set(POPULATION_ENABLED, "")


def test_staged_batches_fold_in_observation_order():
    """A device batch staged behind an event that has not landed holds
    back every later observation, so the fold sees the keys in the order
    they were observed (the reference's insertion order); batches already
    landed fold at once, without waiting."""

    class _Event:
        def __init__(self, ready):
            self.ready, self.waited = ready, False

        def query(self):
            return self.ready

        def synchronize(self):
            self.waited = True

    class _Meta:
        def __init__(self, name):
            self.resource = name

    metas = [_Meta(f"r{i}") for i in range(4)]
    rows = lambda *r: torch.tensor(r, dtype=torch.int32)
    tr = _tracker(PP)
    late, landed = _Event(False), _Event(True)
    tr.observe_rows_staged(rows(1, 2, -1), rows(1, 1, 1), late, metas)
    tr.observe("x", 2)
    tr.observe_rows_staged(rows(3), rows(2), landed, metas)
    assert len(tr._staged) == 3 and tr._pending == {}
    tr.roll(BASE_MS)
    assert late.waited
    assert list(tr._ss.counts.items()) == [("r1", 1), ("r2", 1), ("x", 2),
                                            ("r3", 2)]
    ref = _tracker(JP)
    ref.observe_pairs([("r1", 1), ("r2", 1), ("x", 2), ("r3", 2)])
    ref.roll(BASE_MS)
    assert _snap(tr) == _snap(ref)
    ready = _tracker(PP)
    ready.observe_rows_staged(rows(0, 0), rows(1, 3), _Event(True), metas)
    assert ready._staged == [] and ready._pending == {"r0": 4}


# -- the engine feed ---------------------------------------------------------


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def _buf(reg, lanes, width):
    buf = make_entry_batch_np(width)
    parent = reg.entrance_row("ctx")
    for i, res in enumerate(lanes):
        cr, dn, orow, oid = reg.resolve_entry(res, "ctx", "", parent,
                                              int(JC.EntryType.OUT))
        buf["cluster_row"][i] = cr
        buf["dn_row"][i] = dn
        buf["origin_row"][i] = orow
        buf["origin_id"][i] = oid
    return buf


def test_telescope_adds_no_dispatch_and_no_sync():
    """A/B: the same stream with the telescope on and off dispatches the
    same steps and reads the device the same number of times."""

    def run(enabled):
        pconfig.set(POPULATION_ENABLED, "" if enabled else "false")
        clock = _Clock(BASE_MS)
        eng = PEngine(capacity=256, device="cpu", clock=clock)
        try:
            eng.flow_rules.load_rules([PFlowRule(resource="ab", count=100)])
            SYNCS.count = 0
            for _ in range(5):
                eng._run_entry_batch(_buf(eng.registry, ["ab"] * 4, 8))
                eng.timeseries_view(now_ms=clock.now)
                clock.now += 1000
            eng.timeseries_view(now_ms=clock.now)
            dispatches = {k: v["dispatches"]
                          for k, v in eng.step_timer.snapshot().items()}
            return dispatches, SYNCS.count, eng.population.observed_total
        finally:
            eng.close()
            pconfig.set(POPULATION_ENABLED, "")

    off = run(False)
    on = run(True)
    assert off[2] == 0
    assert on[2] == 20, "the A/B run never exercised the telescope"
    assert on[0] == off[0]
    assert on[1] == off[1]


def test_zipf_replay_reports_equal_the_reference():
    """A seeded Zipf stream through both engines: equal reports, and the
    reference's acceptance (projected hit rate within 5% absolute of the
    measured one) on the port."""
    rng = random.Random(1234)
    resources = [f"z{i:03d}" for i in range(150)]
    weights = [1.0 / (r + 1) ** 1.1 for r in range(150)]
    jclk, pclk = _Clock(BASE_MS), _Clock(BASE_MS)
    jeng = JEngine(capacity=512, clock=jclk, journal_path="")
    peng = PEngine(capacity=512, device="cpu", clock=pclk)
    truth = {}
    try:
        now = BASE_MS
        for _ in range(25):
            draws = rng.choices(resources, weights, k=200)
            for res in draws:
                truth[res] = truth.get(res, 0) + 1
            jclk.now = pclk.now = now
            for i in range(0, len(draws), 100):
                jb = _buf(jeng.registry, draws[i:i + 100], 128)
                pb = _buf(peng.registry, draws[i:i + 100], 128)
                np.testing.assert_array_equal(pb["cluster_row"],
                                              jb["cluster_row"])
                jeng._run_entry_batch(jax_entry(jb))
                peng._run_entry_batch(pb)
            jeng.slo_refresh(now_ms=now)
            peng.timeseries_view(now_ms=now)
            now += 1000
        jclk.now = pclk.now = now
        total = sum(truth.values())
        ranked = sorted(truth.values(), reverse=True)
        for budget in (4, 12, 32, 4096):
            rep = peng.population_report(slot_budget=budget, now_ms=now)
            assert rep == jeng.population_report(slot_budget=budget,
                                                 now_ms=now)
            if budget < 4096:
                measured = sum(ranked[:budget]) / total
                assert abs(rep["hitRate"] - measured) <= 0.05
            else:
                assert rep["extrapolated"] is True
        assert peng.population.observed_total == total
        assert _canon(peng.population.page()) == \
            _canon(jeng.population.page())
    finally:
        peng.close()
        jeng.close()
