"""Slot-table admission in the port (``sentinel_tpu_torch/core/slots.py``
and the engine's slot mode) against the JAX package's, driven through the
same calls (the scenarios of ``tests/test_slots.py``).

Each test builds a JAX engine and a port engine (``device="cpu"``) with
the same slot budget on two clocks that move together, serves the same
entry / exit stream on both, and runs the once-per-second fold on both
with ``timeseries_view(now_ms=...)`` (a committer flush and
``_spill_flight``, which ends in the slot table's rebalance). Verdict
strings, ``slots.status()``, the event-sink histories, the rendered
``timeseries_view`` and the device state (the flight ring included) must
be equal, exactly: these are integer counters, int64 stamps and host
dicts (the float rule state within ``FLOAT_RTOL``, as everywhere in the
port's tests). Both committers are flushed before every clock step, so
the leased commits of a second land in that second on both sides, and
whenever six commits are queued, so no flush is wider than 8 (the JAX
reference compiles its step once per width).
"""

from __future__ import annotations

import random

import pytest

from sentinel_tpu.chaos.invariants import History, check_all
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.core.exceptions import BlockException as JBlock
from sentinel_tpu.models.flow import FlowRule as JFlowRule
from sentinel_tpu.resilience import FaultInjector as JInjector
from sentinel_tpu.simulator.clock import SimClock

from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.core.exceptions import BlockException as PBlock
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.core.slots import FIRST_SLOT, SlotTable
from sentinel_tpu_torch.models.flow import FlowRule as PFlowRule
from sentinel_tpu_torch.resilience.faults import FaultInjector as PInjector

from tests.test_torch_support import assert_tree_equal, jax_to_np, port_np

BASE_MS = 1_700_000_000_000
MAX_QUEUED = 6


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.copy()
            for k, v in tree.items()}


class Twin:
    """A JAX and a port slot-mode engine at one budget, one stream."""

    def __init__(self, budget, flow=()):
        # A context pooled on this thread by an earlier engine holds that
        # engine's rows: drop it and retire every pooled one.
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
            ctx.bump_generation()
        self.jclk = SimClock(BASE_MS)
        self.pclk = _Clock(BASE_MS)
        self.j = JEngine(clock=self.jclk.now_ms, journal_path="",
                         slot_budget=budget)
        self.p = PEngine(device="cpu", clock=self.pclk, slot_budget=budget)
        self.jhist, self.phist = History(), History()
        self.j.slots.event_sink = self.jhist.events.append
        self.p.slots.event_sink = self.phist.events.append
        self.snaps = {"j": [], "p": []}
        for side, eng in (("j", self.j), ("p", self.p)):
            self._record_surgeries(side, eng)
        if flow:
            self.j.flow_rules.load_rules(
                [JFlowRule(resource=r, count=c) for r, c in flow])
            self.p.flow_rules.load_rules(
                [PFlowRule(resource=r, count=c) for r, c in flow])

    def _record_surgeries(self, side, eng):
        """Keep the device state after every surgery. The surgery flushes
        the committer first and the test thread is inside it, so nothing
        commits between its end and the snapshot."""
        execute = eng.slots._execute
        snaps = self.snaps[side]
        to_np = jax_to_np if side == "j" else port_np

        def recorded(*a, **k):
            execute(*a, **k)
            with eng._lock:
                # Copies: on the CPU both packages' arrays may alias the
                # live buffers that later steps update.
                snaps.append(_copy(to_np(eng._state)))

        eng.slots._execute = recorded

    def close(self):
        for eng in (self.p, self.j):
            eng.close()
        for ctx in (jctx, pctx):
            ctx.replace_context(None)

    def serve(self, res):
        """One entry / exit on both sides; the verdict symbol."""
        out = []
        for eng, block in ((self.j, JBlock), (self.p, PBlock)):
            try:
                eng.entry(res).exit()
                out.append("P")
            except block:
                out.append("B")
            c = eng._committer
            if c is not None and max(len(c._entries),
                                     len(c._exits)) >= MAX_QUEUED:
                c.flush()
        assert out[0] == out[1], (res, out)
        return out[0]

    def second(self):
        """Close the simulated second on both sides and run the fold."""
        for eng in (self.j, self.p):
            eng._flush_committer()
        self.jclk.advance(1000)
        self.pclk.now += 1000
        now = self.pclk.now
        assert self.jclk.now_ms() == now
        jv = self.j.timeseries_view(now_ms=now)
        pv = self.p.timeseries_view(now_ms=now)
        assert pv == jv
        return pv

    def assert_same(self):
        """Status, event history, view and state equal on both sides."""
        assert self.p.slots.status() == self.j.slots.status()
        assert self.phist.events == self.jhist.events
        now = self.pclk.now
        assert self.p.timeseries_view(now_ms=now) == \
            self.j.timeseries_view(now_ms=now)
        assert self.p.slots.checkpoint_dict() == \
            self.j.slots.checkpoint_dict()
        with self.j._lock, self.p._lock:
            assert_tree_equal(jax_to_np(self.j._state), port_np(self.p.state))
            assert_tree_equal(jax_to_np(self.j._rules), port_np(self.p.rules))
        assert len(self.snaps["p"]) == len(self.snaps["j"])
        for want, got in zip(self.snaps["j"], self.snaps["p"]):
            assert_tree_equal(want, got)


@pytest.fixture
def twins():
    made = []

    def make(budget, flow=()):
        tw = Twin(budget, flow)
        made.append(tw)
        return tw

    yield make
    for tw in made:
        tw.close()


# -- differential oracle: tiny budget vs never-evicting twin ---------------


def test_differential_oracle_matches_the_reference_and_the_twin(twins):
    """A 6-usable-slot engine under a 16-resource Zipf stream evicts and
    rehydrates; a 62-usable-slot twin never evicts. On the port the two
    verdict strings are identical, and each equals the JAX engine's at the
    same budget, with the same status, events, history and state after
    every surgery."""
    names = [f"oracle{i}" for i in range(16)]
    flow = [(names[i], 3) for i in (0, 5, 10)]
    weights = [1.0 / (i + 1) ** 1.2 for i in range(16)]
    streams, statuses = [], []
    for budget in (8, 64):
        tw = twins(budget, flow)
        rng = random.Random(1234)  # identical draws per budget
        verdicts = []
        for _sec in range(10):
            for _ in range(20):
                verdicts.append(
                    tw.serve(rng.choices(names, weights=weights)[0]))
            tw.second()
        tw.assert_same()
        streams.append("".join(verdicts))
        statuses.append(tw.p.slots.status())
    assert streams[0] == streams[1], (
        "eviction/rehydration changed a verdict:\n"
        f"  small {streams[0]}\n  twin  {streams[1]}")
    assert "B" in streams[0] and "P" in streams[0]
    assert statuses[0]["evictionsTotal"] > 0, statuses[0]
    assert statuses[0]["coldPassTotal"] > 0, statuses[0]
    assert statuses[1]["evictionsTotal"] == 0, statuses[1]
    assert statuses[1]["coldPassTotal"] == 0, statuses[1]


# -- storm drill -------------------------------------------------------------


@pytest.fixture(scope="module")
def storm_drill():
    """The reference's evict -> cold -> rehydrate drill on both engines:
    budget 3 (one usable slot), ``slots.evict.storm`` armed ``after=2,
    times=2`` through each package's own injector."""
    tw = Twin(3)
    plan = [["alpha"] * 3, ["alpha"] * 2, [], ["beta"] * 3,
            ["alpha"] * 2 + ["beta"], ["alpha", "beta"]]
    try:
        with JInjector(seed=99, scope_thread=True) as ji, \
                PInjector(seed=99, scope_thread=True) as pi:
            for inj in (ji, pi):
                inj.arm("slots.evict.storm", mode="error", after=2, times=2)
            for second in plan:
                for res in second:
                    tw.serve(res)
                tw.second()
        view = tw.p.timeseries_view(now_ms=tw.pclk.now)
        yield {"twin": tw, "view": view, "status": tw.p.slots.status()}
    finally:
        tw.close()


def test_storm_drill_equals_the_reference(storm_drill):
    tw = storm_drill["twin"]
    tw.assert_same()
    assert storm_drill["status"]["stormsTotal"] == 2
    assert check_all(tw.phist, {}, 1) == []


def test_generation_leak_history_renders_under_recorded_tenancy(
        storm_drill):
    """Seconds recorded while alpha held the slot still name alpha after
    beta reuses the same slot row."""
    by_res = {}
    for sec in storm_drill["view"]["seconds"]:
        names = sorted(sec.get("resources", {}))
        for name in names:
            by_res[name] = by_res.get(name, 0) + 1
        assert names in (["alpha"], ["beta"], []), sec
    assert by_res.get("alpha", 0) >= 3, by_res   # sec 1, 2, 5
    assert by_res.get("beta", 0) == 1, by_res    # sec 4 only


def test_evict_rehydrate_round_trip_conserves_window_state(storm_drill):
    history = storm_drill["twin"].phist
    evicts = history.of("slotEvict")
    alpha_evict = next(e for e in evicts if e["resource"] == "alpha")
    assert alpha_evict["spilledPass"] >= 5 and not alpha_evict["torn"]
    warm = [r for r in history.of("slotRehydrate")
            if r["resource"] == "alpha" and r["fromRecord"]]
    assert len(warm) == 1, warm
    grafted = warm[0]["graftedPass"] + warm[0]["stalePass"]
    assert 0 < grafted <= alpha_evict["spilledPass"], (warm, alpha_evict)
    status = storm_drill["status"]
    assert status["evictionsTotal"] >= 2
    assert status["rehydrationsTotal"] >= 3
    assert status["rehydrationsColdTotal"] >= 2
    assert status["coldPassTotal"] >= 2, status
    cold = [v for v in history.of("slotVerdict") if v["slot"] < 0]
    assert cold and all(v["gen"] < 0 for v in cold)


# -- cold tail and namespace size ----------------------------------------------


def test_cold_ruled_resource_enforced_host_exact_past_pin_capacity(twins):
    """Four leaseable rules over two usable slots: the overflowed ones
    live on the cold tail and their limits still hold host-exactly."""
    tw = twins(4, [(f"ruled{i}", 2) for i in range(4)])
    for i in (0, 1):
        tw.serve(f"ruled{i}")
    hot = set(tw.p.slots.checkpoint_dict()["hot"])
    cold_ruled = next(r for r in ("ruled2", "ruled3") if r not in hot)
    verdicts = "".join(tw.serve(cold_ruled) for _ in range(6))
    assert verdicts == "PPBBBB", verdicts
    status = tw.p.slots.status()
    assert status["coldBlockTotal"] >= 4 and status["coldPassTotal"] >= 2
    tw.second()
    tw.assert_same()


def test_namespace_10x_budget_zero_registration_failures(twins):
    tw = twins(8)
    names = [f"wide{i}" for i in range(60)]
    for _sec in range(3):
        for res in names:
            assert tw.serve(res) == "P"
        tw.second()
    tw.assert_same()
    status = tw.p.slots.status()
    assert status["hot"] <= 6, status
    assert status["coldPassTotal"] > 0, status
    assert 0.0 < status["hitRate"] < 1.0, status
    assert tw.p.registry.overflow_count == 0


def test_registry_overflow_is_counted_not_raised():
    reg = NodeRegistry(capacity=4)  # ROOT + ENTRY pre-allocated
    assert reg.cluster_row("fits-a") >= 0
    assert reg.cluster_row("fits-b") >= 0
    for i in range(3):
        assert reg.cluster_row(f"over-{i}") == -1
    assert reg.overflow_count == 3
    assert reg.cluster_row("fits-a") >= 0
    assert reg.overflow_count == 3


# -- checkpoint support, the pipeline refusal, the clock seam ----------------


def test_checkpoint_dict_round_trip_at_the_slot_table(twins):
    tw = twins(6, [("ck-a", 100)])
    for res in ("ck-a", "ck-b", "ck-c"):
        tw.serve(res)
    saved = tw.p.slots.checkpoint_dict()
    assert saved == tw.j.slots.checkpoint_dict()
    table = SlotTable(tw.p, 6)
    table.restore_assignment(saved)
    assert table.checkpoint_dict() == saved
    assert table.device_row("ck-a") == saved["hot"]["ck-a"][0]
    assert sorted(table._free) == [
        s for s in range(FIRST_SLOT, 6)
        if s not in {sg[0] for sg in saved["hot"].values()}]
    with pytest.raises(ValueError, match="slot budget"):
        SlotTable(tw.p, 8).restore_assignment(saved)
    bad = dict(saved, hot={"x": [0, 0]})
    with pytest.raises(ValueError, match="corrupt"):
        SlotTable(tw.p, 6).restore_assignment(bad)


def test_start_pipeline_is_refused_in_slot_mode(twins):
    tw = twins(4)
    msgs = []
    for eng in (tw.j, tw.p):
        with pytest.raises(RuntimeError) as err:
            eng.start_pipeline(max_batch=8)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "slot mode" in msgs[1]


def test_set_clock_clears_the_history_and_the_telescope_timebase(twins):
    tw = twins(6)
    for res in ("sc-a", "sc-b"):
        tw.serve(res)
    tw.second()
    p = tw.p
    assert p.timeseries.retained() == 1
    assert p.population._win_start is not None
    p.set_clock(_Clock(BASE_MS - 3_600_000))
    assert p.timeseries.retained() == 0
    assert p.timeseries.last_stamp_ms == -1
    assert p.population._win_start is None
    assert p.state is None
