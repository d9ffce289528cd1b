"""The flight recorder in the port (the ring in ``ops/step.py``, the spill
in ``core/engine.py:_spill_flight`` and the history in
``telemetry/timeseries.py``) against the JAX package's (the scenarios of
``tests/test_timeseries.py``).

A JAX engine and a port engine (``device="cpu"``) with the same capacity
take the same batches (one ``make_entry_batch_np`` / ``make_exit_batch_np``
dict, padded to width 16 so the JAX reference compiles its steps once)
at the same explicit ``now_ms``. ``timeseries_view`` must render the same
dicts on both, and the device state, ring tensors included, must be equal
through ``convert.py``: exactly, as these are integer counters and int64
stamps (the float rule state within ``FLOAT_RTOL``). The module keeps one
engine pair; each test swaps both clocks (``set_clock`` drops the state
and clears the history) and pushes its own rules.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest
import torch

from sentinel_tpu.core import constants as JC
from sentinel_tpu.core.batch import make_entry_batch_np, make_exit_batch_np
from sentinel_tpu.core.config import config as jconfig
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.models.flow import FlowRule as JFlowRule
from sentinel_tpu.ops import step as JS
from sentinel_tpu.telemetry import attribution as JAT
from sentinel_tpu.telemetry.timeseries import TimeseriesHistory as JHistory
from sentinel_tpu.telemetry.timeseries import compact_second as jcompact

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.config import TELEMETRY_TIMESERIES_SECONDS
from sentinel_tpu_torch.core.config import config as pconfig
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.models.flow import FlowRule as PFlowRule
from sentinel_tpu_torch.ops import step as PS
from sentinel_tpu_torch.telemetry.timeseries import (
    TimeseriesHistory as PHistory)
from sentinel_tpu_torch.telemetry.timeseries import compact_second

from tests.test_torch_support import (assert_tree_equal, jax_entry, jax_exit,
                                      jax_to_np, port_np)

BASE_MS = 1_700_000_000_000
CAPACITY = 256
WIDTH = 16


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


class Pair:
    def __init__(self, capacity=CAPACITY):
        self.j = JEngine(capacity=capacity, clock=_Clock(BASE_MS),
                         journal_path="")
        self.p = PEngine(capacity=capacity, device="cpu",
                         clock=_Clock(BASE_MS))

    def close(self):
        self.p.close()
        self.j.close()

    def restart(self, now):
        """Fresh statistics and history on both sides at ``now``."""
        for eng in (self.j, self.p):
            eng.set_clock(_Clock(now))

    def flow(self, *rules):
        self.j.flow_rules.load_rules([JFlowRule(resource=r, count=c)
                                      for r, c in rules])
        self.p.flow_rules.load_rules([PFlowRule(resource=r, count=c)
                                      for r, c in rules])

    def _rows(self, res):
        rows = []
        for eng in (self.j, self.p):
            reg = eng.registry
            rows.append(reg.resolve_entry(res, "ctx", "",
                                          reg.entrance_row("ctx"),
                                          int(JC.EntryType.OUT)))
        assert rows[0] == rows[1], rows
        return rows[1]

    def check(self, lanes, counts, now):
        """One entry step of ``lanes`` (resource names) on both; the
        verdicts."""
        buf = make_entry_batch_np(WIDTH)
        for i, res in enumerate(lanes):
            cr, dn, orow, oid = self._rows(res)
            buf["cluster_row"][i] = cr
            buf["dn_row"][i] = dn
            buf["origin_row"][i] = orow
            buf["origin_id"][i] = oid
            buf["count"][i] = counts[i]
        jr = np.asarray(self.j.check_batch(jax_entry(buf), now_ms=now).reason)
        pr = self.p.check_batch(buf, now_ms=now).reason.numpy()
        np.testing.assert_array_equal(pr, jr)
        return pr[:len(lanes)]

    def complete(self, lanes, counts, rts, errors, now):
        buf = make_exit_batch_np(WIDTH)
        for i, res in enumerate(lanes):
            cr, dn, orow, _ = self._rows(res)
            buf["cluster_row"][i] = cr
            buf["dn_row"][i] = dn
            buf["origin_row"][i] = orow
            buf["count"][i] = counts[i]
            buf["rt_ms"][i] = rts[i]
            buf["success"][i] = True
            buf["error"][i] = errors[i]
        self.j.complete_batch(jax_exit(buf), now_ms=now)
        self.p.complete_batch(buf, now_ms=now)

    def view(self, **kw):
        jv = self.j.timeseries_view(**kw)
        pv = self.p.timeseries_view(**kw)
        assert pv == jv
        return pv

    def assert_state_equal(self):
        with self.j._lock, self.p._lock:
            want = jax_to_np(self.j._state)
            got = port_np(self.p.state)
        assert "flight" in want and "flight" in got
        assert_tree_equal(want, got)


@pytest.fixture(scope="module")
def engines():
    pr = Pair()
    yield pr
    pr.close()


_BASES = iter(range(BASE_MS, BASE_MS + 10**9, 10_000_000))


@pytest.fixture
def pair(engines):
    engines.restart(next(_BASES))
    return engines


def _cell():
    return {"pass": 0, "block": 0, "success": 0, "exception": 0,
            "rtSumMs": 0, "blockByReason": defaultdict(int),
            "rtBuckets": np.zeros(JAT.NUM_RT_BUCKETS, np.int64)}


def _run_stream(pair, seed, base, steps=40):
    """Randomized mixed-count traffic with exits on both engines; returns
    the per-second oracle accumulated from the step's own verdicts."""
    rng = np.random.default_rng(seed)
    pair.flow(("tsA", 9), ("tsB", 4))
    oracle = defaultdict(lambda: defaultdict(_cell))
    now = base
    for _ in range(steps):
        lanes = ["tsA" if rng.integers(0, 2) else "tsB"
                 for _ in range(int(rng.integers(6, 14)))]
        counts = [int(rng.integers(1, 4)) for _ in lanes]
        reasons = pair.check(lanes, counts, now)
        second = now - now % 1000
        passed = []
        for i, res in enumerate(lanes):
            cell = oracle[second][res]
            if reasons[i] > 0:
                cell["block"] += counts[i]
                cell["blockByReason"]["FLOW"] += counts[i]
            else:
                cell["pass"] += counts[i]
                passed.append(i)
        if passed:
            rts = [int(rng.integers(1, 3000)) for _ in passed]
            errs = [bool(rng.integers(0, 4) == 0) for _ in passed]
            pair.complete([lanes[i] for i in passed],
                          [counts[i] for i in passed], rts, errs, now)
            for k, i in enumerate(passed):
                cell = oracle[second][lanes[i]]
                cell["success"] += counts[i]
                cell["rtSumMs"] += rts[k]
                if errs[k]:
                    cell["exception"] += counts[i]
                cell["rtBuckets"][int(np.sum(
                    rts[k] > np.asarray(JAT.RT_BUCKET_EDGES_MS)))] += 1
        now += int(rng.integers(120, 450))
    return oracle, now


def test_recorder_matches_the_reference_and_the_host_oracle(pair):
    """Every complete second of a randomized mixed-count stream with exits
    renders the same on both engines and equals the host oracle; the
    pages, a range query and the ring tensors agree too."""
    base = pair.p.now_ms()
    oracle, end_now = _run_stream(pair, 7, base)
    final_now = end_now + 2500
    view = pair.view(now_ms=final_now)
    by_stamp = {s["timestamp"]: s for s in view["seconds"]}
    complete = [s for s in sorted(oracle) if s < final_now - final_now % 1000]
    assert len(complete) >= 5
    for stamp in complete:
        got = by_stamp[stamp]["resources"]
        want = {r: c for r, c in oracle[stamp].items()
                if c["pass"] or c["block"] or c["success"] or c["exception"]}
        assert set(got) == set(want)
        for res, cell in want.items():
            g = got[res]
            for k in ("pass", "block", "success", "exception", "rtSumMs"):
                assert g[k] == cell[k], (stamp, res, k)
            assert g["blockByReason"] == dict(cell["blockByReason"])
            assert g["rtBuckets"] == cell["rtBuckets"].tolist()
    assert set(by_stamp) <= set(complete)
    all_secs = view["seconds"]
    for limit, offset in ((3, 0), (2, 1), (1, len(all_secs) - 1)):
        page = pair.view(limit=limit, offset=offset, now_ms=final_now)
        assert page["seconds"] == all_secs[:len(all_secs) - offset][-limit:]
    mid = complete[len(complete) // 2]
    ranged = pair.view(start_ms=mid, end_ms=mid + 1000, now_ms=final_now)
    assert [s["timestamp"] for s in ranged["seconds"]] == [mid]
    assert pair.view(resource="tsB", now_ms=final_now)["total"] > 0
    pair.assert_state_equal()


def test_in_progress_second_stays_staged(pair):
    base = pair.p.now_ms()
    pair.flow(("ip", 1))
    pair.check(["ip"] * 3, [1] * 3, base)
    assert pair.view(now_ms=base + 500)["seconds"] == []
    view = pair.view(now_ms=base + 1000)
    assert [s["timestamp"] for s in view["seconds"]] == [base]
    assert view["seconds"][0]["resources"]["ip"]["block"] == 2
    pair.assert_state_equal()


def test_slot_attribution_series(pair):
    base = pair.p.now_ms()
    pair.flow(("sl", 100000), ("sl", 2))
    pair.check(["sl"] * 5, [1] * 5, base)
    view = pair.view(now_ms=base + 1000)
    assert view["seconds"][0]["blockBySlot"] == {"FLOW": {"1": 3}}
    pair.assert_state_equal()


def test_ring_holds_the_pre_reset_staging_across_a_boundary(pair):
    """Traffic on both sides of a second boundary, the second side's first
    step the one that folds: the completed second's ring slot must hold
    the staging as it was BEFORE the fold zeroed it, and the new second's
    traffic must not leak into it."""
    base = pair.p.now_ms()
    pair.flow(("bd", 3))
    pair.check(["bd"] * 5, [1] * 5, base + 999)      # 3 pass, 2 block
    pair.complete(["bd"] * 3, [1] * 3, [5, 6, 7], [False] * 3, base + 999)
    # The 1 s window still holds the 3 passes: all 4 block.
    pair.check(["bd"] * 4, [1] * 4, base + 1000)     # folds base first
    with pair.p._lock:
        ring = pair.p.state.flight
        i = (base // 1000) % ring.stamps.shape[0]
        assert int(ring.stamps[i]) == base
        ev = ring.events[i]
        assert int(ev[JC.MetricEvent.PASS].sum()) == 3 * 2  # DN + cluster
        assert int(ev[JC.MetricEvent.BLOCK].sum()) == 2 * 2
        assert int(ev[JC.MetricEvent.SUCCESS].sum()) == 3 * 2
        assert int(ring.hist[i].sum()) == 3
    view = pair.view(now_ms=base + 2000)
    bd = [s["resources"]["bd"] for s in view["seconds"]]
    assert [(r["pass"], r["block"]) for r in bd] == [(3, 2), (0, 4)]
    pair.assert_state_equal()


@pytest.fixture
def ring_of():
    made = []

    def make(seconds):
        for cfg in (jconfig, pconfig):
            cfg.set(TELEMETRY_TIMESERIES_SECONDS, str(seconds))
        try:
            pr = Pair(capacity=128)
        finally:
            for cfg in (jconfig, pconfig):
                cfg.set(TELEMETRY_TIMESERIES_SECONDS, "")
        made.append(pr)
        return pr

    yield make
    for pr in made:
        pr.close()


def test_ring_wrap_spills_to_host_history(ring_of):
    """A 4-slot ring over 10 seconds: the host history keeps every second
    when the reader keeps pace."""
    pr = ring_of(4)
    assert pr.p.flight_seconds == pr.j.flight_seconds == 4
    pr.flow(("wrap", 1))
    now = BASE_MS
    for _ in range(10):
        pr.check(["wrap"] * 2, [1, 1], now)
        now += 1000
        pr.view(now_ms=now)
    view = pr.view(now_ms=now + 1000)
    assert [s["timestamp"] for s in view["seconds"]] == \
        [BASE_MS + 1000 * k for k in range(10)]
    for s in view["seconds"]:
        assert (s["resources"]["wrap"]["pass"],
                s["resources"]["wrap"]["block"]) == (1, 1)
    pr.assert_state_equal()


def test_recording_disabled_is_clean(ring_of):
    pr = ring_of(0)
    pr.flow(("off", 1))
    pr.check(["off"] * 3, [1] * 3, BASE_MS)
    pr.check(["off"], [1], BASE_MS + 1000)
    assert pr.j._state.flight is None and pr.p.state.flight is None
    view = pr.view(now_ms=BASE_MS + 2000)
    assert view["seconds"] == [] and view["recorderSeconds"] == 0
    with pr.p._lock:
        totals = pr.p.state.telemetry.totals + pr.p.state.sec.counts
        row = pr.p.registry.get_cluster_row("off")
        assert int(totals[JC.MetricEvent.BLOCK, row]) == 2
    with pr.j._lock, pr.p._lock:
        assert "flight" not in port_np(pr.p.state)
        assert_tree_equal(jax_to_np(pr.j._state), port_np(pr.p.state))


def test_history_bounds_and_order_match_the_reference():
    E, A, H = JC.NUM_EVENTS, JAT.NUM_ATTR_REASONS, JAT.NUM_RT_BUCKETS
    zeros = lambda *s: np.zeros(s, np.int32)
    hists = (JHistory(retention_seconds=3), PHistory(retention_seconds=3))
    for h, compact in zip(hists, (jcompact, compact_second)):
        for k in range(5):
            ev = zeros(E, 8)
            ev[JC.MetricEvent.PASS, 3] = k + 1
            h.append(compact(BASE_MS + k * 1000, ev, zeros(A, 8),
                             zeros(H, 8), zeros(A, JAT.NUM_SLOT_BINS)))
        # out-of-order / duplicate appends are dropped (first wins)
        h.append(compact(BASE_MS + 2000, np.ones((E, 8), np.int32),
                         zeros(A, 8), zeros(H, 8),
                         zeros(A, JAT.NUM_SLOT_BINS)))
    jh, ph = hists
    assert ph.retained() == jh.retained() == 3
    assert ph.last_stamp_ms == jh.last_stamp_ms == BASE_MS + 4000
    for jr, pr in zip(jh.query(), ph.query()):
        assert pr.stamp_ms == jr.stamp_ms
        for f in ("rows", "events", "attr", "hist", "slot_attr"):
            np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
    assert [r.stamp_ms for r in ph.query(BASE_MS + 3000)] == \
        [BASE_MS + 3000, BASE_MS + 4000]
    ph.clear()
    assert ph.retained() == 0 and ph.last_stamp_ms == -1


def test_convert_carries_the_ring_both_ways():
    jstate = JS.make_state(16, 1, BASE_MS, flight_seconds=3)
    pstate = convert.state_from_numpy(jax_to_np(jstate), "cpu")
    assert pstate.flight is not None and pstate.flight.events.shape == \
        (3, JC.NUM_EVENTS, 16)
    assert_tree_equal(jax_to_np(jstate), port_np(pstate))
    back = convert.state_from_numpy(port_np(pstate), "cpu")
    assert_tree_equal(port_np(pstate), port_np(back), rtol=0)
    bare = convert.state_from_numpy(
        jax_to_np(JS.make_state(16, 1, BASE_MS)), "cpu")
    assert bare.flight is None and "flight" not in port_np(bare)
    made = PS.make_state(16, 1, BASE_MS, device="cpu", flight_seconds=2)
    assert made.flight.stamps.tolist() == [-1, -1]
    assert made.flight.hist.dtype == torch.int32
