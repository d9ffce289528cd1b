"""The port's trace-replay simulator (``sentinel_tpu_torch/simulator/``)
against the JAX package's, on the CPU.

Every tier-1 test of ``tests/test_simulator.py`` but the ``sim`` /
``flightrec`` ops commands (the port has no ``transport/`` yet) runs here
on BOTH packages, the port's replays with ``device="cpu"``: the trace
format and its validation, the scenario generators, the determinism
oracle, the retry model, a live engine's export replayed, the policy lab's
closed-loop runs, and the clock seam. Where the reference replays a trace
twice to show determinism, the JAX package replays it once and the port
twice, and all three runs must agree: the verdict sha256, the per-second
series, offered / passed / blocked / retried, ``rt_hist``, the adaptive
decision log and counters, the journal and the stream outcomes.

Beyond the reference file: every scenario at two seeds gives the same
``Trace.to_json()`` in both packages, and 60-second replays of
``flash_crowd`` (seed 7), ``retry_storm`` and the streamed ``hetero_cost``
(abandon rate 0.2) agree across the packages. The slow tier holds the
port's 600-second ``flash_crowd`` replay to its anchor sha.
"""

from __future__ import annotations

import hashlib
import json

import pytest

from tests.test_simulator import BASE_MS, DEFAULT_GAINS, TUNED_GAINS
from tests.test_torch_support import llm_pkgs, replay_view


def pkgs():
    return llm_pkgs()


def replays_agree(build, runs_port=2, **kw):
    """The trace ``build(P)`` makes, replayed once by the JAX package and
    ``runs_port`` times by the port: every observation equal. Returns the
    JAX package's view."""
    J, P = pkgs()
    jt, pt = build(J), build(P)
    assert jt.to_json() == pt.to_json()
    want = replay_view(J.replayer(jt, **kw).run())
    for _ in range(runs_port):
        assert replay_view(P.replayer(pt, **kw).run()) == want
    return want


# -- pure-host: clock, trace format, generators ---------------------------


def test_sim_clock_is_program_driven():
    for P in pkgs():
        clk = P.sim.SimClock(5_000)
        assert clk.now_ms() == 5_000
        assert clk.advance(1000) == 6_000
        with pytest.raises(ValueError):
            clk.advance(-1)


def test_trace_roundtrip_and_validation():
    """tests/test_simulator.py:71 on both packages; each package reads
    the other's JSON back to the same dict, and every rejection carries
    the same message."""
    J, P = pkgs()
    docs = []
    for pkg in (J, P):
        tr = pkg.sim.build_scenario("hetero_cost", seconds=20, seed=3)
        again = pkg.sim.Trace.from_json(tr.to_json())
        assert again.to_dict() == tr.to_dict()
        docs.append(tr.to_json())
    assert docs[0] == docs[1]
    for src, dst in ((J, P), (P, J)):
        tr = src.sim.Trace.from_json(docs[0])
        assert dst.sim.Trace.from_json(tr.to_json()).to_dict() \
            == tr.to_dict()

    base = json.loads(docs[0])
    bad = [
        (dict(base, kind="something-else"), "kind"),
        (dict(base, version=99), "version"),
        (dict(base, durationS=0), "durationS"),
        (dict(base, seconds=[{"t": 0, "d": {"web": [[0, 5]]}}]), "invalid"),
        (dict(base, seconds=[{"t": 10_000, "d": {"web": [[1, 5]]}}]),
         "outside"),
        (dict(base, seconds=[{"t": 1, "d": {"web": [[1, 5]]}},
                             {"t": 1, "d": {"web": [[1, 6]]}}]),
         "duplicate"),
        (dict(base, rules={"nope": []}), "unknown rule families"),
        (dict(base, seconds=[{"t": 0, "d": {"web": [[1, 5]]},
                              "x": {"web": {"rt": [1] * 20, "err": 0}}}]),
         "rt buckets"),
    ]
    for doc, match in bad:
        msgs = []
        for pkg in (J, P):
            with pytest.raises(ValueError, match=match) as info:
                pkg.sim.Trace.from_dict(doc)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]

    tr = P.sim.Trace.from_json(docs[0])
    head = {k: v for k, v in tr.to_dict().items() if k != "seconds"}
    lines = [json.dumps(head)] + [json.dumps(s) for s in tr.seconds]
    torn = "\n".join(lines) + "\n" + '{"t": 19, "d": {"web"'
    salvaged = [pkg.sim.Trace.from_json(torn).to_dict() for pkg in (J, P)]
    assert salvaged[0] == salvaged[1]
    assert len(salvaged[1]["seconds"]) == len(tr.seconds)


def test_scenario_generators_seed_deterministic_and_shaped():
    """tests/test_simulator.py:115 on the port, and every scenario at two
    seeds equal to the JAX package's JSON."""
    J, P = pkgs()
    assert sorted(J.scen.SCENARIOS) == sorted(P.scen.SCENARIOS)
    for name in P.scen.SCENARIOS:
        for seed in (7, 8):
            a = P.sim.build_scenario(name, seconds=30, seed=seed)
            assert a.to_json() == P.sim.build_scenario(
                name, seconds=30, seed=seed).to_json(), name
            assert a.to_json() == J.sim.build_scenario(
                name, seconds=30, seed=seed).to_json(), (name, seed)
        assert P.sim.build_scenario(name, seconds=30, seed=7).to_json() \
            != P.sim.build_scenario(name, seconds=30, seed=8).to_json()
    streamed = [pkg.scen.hetero_cost(seconds=30, seed=seed,
                                     streams_per_s=0.5, abandon_rate=0.2)
                .to_json() for seed in (7, 8) for pkg in (J, P)]
    assert streamed[0] == streamed[1] and streamed[2] == streamed[3]

    crowd = P.sim.build_scenario("flash_crowd", seconds=40, seed=1)
    at = crowd.meta["crowd"]["atS"]
    calm = sum(n for s in crowd.seconds if s["t"] < at
               for _, n in s["d"]["web"])
    surge = sum(n for s in crowd.seconds if at <= s["t"] < at + 5
                for _, n in s["d"]["web"])
    assert surge > calm
    hetero = P.sim.build_scenario("hetero_cost", seconds=10, seed=1)
    counts = {c for s in hetero.seconds
              for pairs in s["d"].values() for c, _ in pairs}
    assert {4, 16} <= counts
    storm = P.sim.build_scenario("retry_storm", seconds=10, seed=1)
    assert storm.meta["retry"]["maxAttempts"] >= 1
    with pytest.raises(ValueError, match="unknown scenario"):
        P.sim.build_scenario("nope")


# -- the determinism oracle -----------------------------------------------


def test_replay_determinism_oracle():
    """tests/test_simulator.py:145: flash_crowd 30 s, seed 11."""
    want = replays_agree(lambda pkg: pkg.sim.build_scenario(
        "flash_crowd", seconds=30, seed=11))
    tr = pkgs()[1].sim.build_scenario("flash_crowd", seconds=30, seed=11)
    assert want["offered"] == tr.total_offered()
    assert want["blocked"] > 0


def test_retry_storm_closes_the_demand_loop():
    """tests/test_simulator.py:174: retry_storm 40 s, seed 5."""
    want = replays_agree(lambda pkg: pkg.sim.build_scenario(
        "retry_storm", seconds=40, seed=5), runs_port=1)
    tr = pkgs()[1].sim.build_scenario("retry_storm", seconds=40, seed=5)
    assert want["retried"] > 0
    assert want["offered"] == tr.total_offered() + want["retried"]


@pytest.mark.parametrize("name,kw", [
    ("flash_crowd", dict(seed=7)),
    ("retry_storm", dict(seed=7)),
    ("hetero_cost", dict(seed=7, streams_per_s=0.4, abandon_rate=0.2)),
], ids=["flash_crowd", "retry_storm", "hetero_cost_streamed"])
def test_sixty_second_replays_match_the_reference(name, kw):
    """60-second traces: the same verdict sha256, series, counts and
    ``rt_hist`` in both packages."""
    want = replays_agree(lambda pkg: pkg.scen.SCENARIOS[name](
        seconds=60, **kw), runs_port=1)
    assert want["seconds"] == 60 and want["offered"] > 0
    if name == "hetero_cost":
        assert want["streams"]["opened"] > 0
        assert want["streams"]["outstandingTokens"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("name,seed", [
    ("diurnal", 5), ("retry_storm", 23), ("hetero_cost", 40),
    ("correlated_overload", 13),
])
def test_replay_determinism_multi_seed(name, seed):
    """tests/test_simulator.py:162, the slow tier."""
    replays_agree(lambda pkg: pkg.sim.build_scenario(
        name, seconds=60, seed=seed))


@pytest.mark.slow
def test_flash_crowd_anchor_on_the_port():
    """The 600-second ``flash_crowd`` replay (seed 7) on the port's CPU
    at the default capacity and at the main path's 32,768 rows: the JAX
    package's sha as it runs in this repository (ROADMAP C17), 138,382
    offered and 23,981 passed."""
    P = pkgs()[1]
    tr = P.sim.build_scenario("flash_crowd", seconds=600, seed=7)
    for capacity in (None, 32768):
        r = P.replayer(tr, capacity=capacity).run(warmup=True)
        assert r.verdict_sha256 == (
            "d0a27aec0ec0b6beb9b74a462d4371779988fbe33d9ada5319c524fa631bcba4")
        assert (r.offered, r.passed) == (138_382, 23_981)


# -- recorded live, then replayed -----------------------------------------


def test_recorded_live_then_replayed_reproduces_pass_block_exactly():
    """tests/test_simulator.py:187 on both packages: the live seconds,
    the exported trace and its replay equal across the packages, and the
    replayed series equal to the live one."""

    def go(P):
        demand = [5, 30, 18, 40, 2, 25, 60, 0, 12, 33]
        clock = P.sim.SimClock(BASE_MS)
        live = P.engine(capacity=128, clock=clock.now_ms)
        try:
            live.traces.stop()
            live.flow_rules.load_rules([P.flow.FlowRule(resource="liveres",
                                                        count=20)])
            c_row = live.registry.cluster_row("liveres")
            for n in demand:
                if n:
                    buf = P.batch.make_entry_batch_np(64)
                    buf["cluster_row"][:n] = c_row
                    buf["count"][:n] = 1
                    live.check_batch(P.entry_batch(buf),
                                     now_ms=clock.now_ms())
                clock.advance(1000)
            live._spill_flight(clock.now_ms())
            live_secs = live.timeseries_view()["seconds"]
            trace = P.sim.export_trace(live)
        finally:
            live.close()
        assert trace.epoch_ms == BASE_MS
        assert any(r.get("resource") == "liveres" and r.get("count") == 20.0
                   for r in trace.rules["flow"])
        replayed = replay_view(P.replayer(trace).run())
        live_by_t = {(int(s["timestamp"]) - BASE_MS) // 1000:
                     s["resources"]["liveres"] for s in live_secs}
        sim_by_t = {s["t"]: s for s in replayed["series"]}
        assert set(live_by_t) == set(sim_by_t)
        for t, cell in live_by_t.items():
            assert sim_by_t[t]["pass"].get("liveres", 0) == cell["pass"], t
            assert sim_by_t[t]["block"].get("liveres", 0) == cell["block"], t
        return live_secs, trace.to_json(), replayed

    J, P = pkgs()
    assert go(J) == go(P)


# -- the policy lab --------------------------------------------------------


@pytest.fixture(scope="module")
def lab_runs():
    """tests/test_simulator.py:234's closed-loop replays of flash_crowd
    (45 s, seed 11): the JAX package runs the default and the tuned gains
    once each, the port runs both and the tuned gains again."""
    J, P = pkgs()

    def run(pkg, gains):
        tr = pkg.sim.build_scenario("flash_crowd", seconds=45, seed=11)
        return pkg.replayer(tr, adaptive={},
                            policy=pkg.controller.AimdPolicy(**gains),
                            targets=pkg.lab.default_targets(tr)).run()

    return {"trace": P.sim.build_scenario("flash_crowd", seconds=45,
                                          seed=11),
            "jax_default": run(J, DEFAULT_GAINS),
            "jax_tuned": run(J, TUNED_GAINS),
            "default": run(P, DEFAULT_GAINS), "tuned": run(P, TUNED_GAINS),
            "tuned_again": run(P, TUNED_GAINS)}


def test_lab_runs_match_the_reference(lab_runs):
    """The port's closed-loop runs give the JAX package's decision log,
    counters, journal, final counts and objective vector."""
    for gains in ("default", "tuned"):
        assert replay_view(lab_runs[gains]) \
            == replay_view(lab_runs[f"jax_{gains}"]), gains


def test_adaptive_replay_decision_log_is_deterministic(lab_runs):
    r1, r2 = lab_runs["tuned"], lab_runs["tuned_again"]
    assert r1.verdict_sha256 == r2.verdict_sha256
    assert r1.decisions == r2.decisions
    assert r1.counters == r2.counters
    assert r1.final_counts == r2.final_counts


def test_winner_promotes_through_shadow_canary_in_sim(lab_runs):
    r = lab_runs["tuned"]
    assert r.counters["promotions"] >= 1
    stages = {}
    for ev in r.decisions:
        if ev["kind"] in ("propose", "canary", "promote"):
            stages.setdefault(ev.get("candidate"), []).append(ev["kind"])
    promoted = [c for c, ks in stages.items() if "promote" in ks]
    assert promoted
    for cand in promoted:
        assert stages[cand] == ["propose", "canary", "promote"], cand
    assert lab_runs["default"].final_counts["web"] > 50.0
    assert r.final_counts["web"] > lab_runs["default"].final_counts["web"]


def test_tuned_aimd_beats_default_without_regressing_safety(lab_runs):
    P = pkgs()[1]
    rd, rt = lab_runs["default"], lab_runs["tuned"]
    assert P.lab.score_vector(rt.objective_vector()) \
        > P.lab.score_vector(rd.objective_vector())
    assert rt.block_rate < rd.block_rate
    assert rt.utilization > rd.utilization
    assert rt.band_violations == 0 and rd.band_violations == 0
    assert rt.counters["aborts"] == 0
    band = {t.resource: t for t in P.lab.default_targets(lab_runs["trace"])}
    for res, count in rt.final_counts.items():
        assert band[res].floor <= count <= band[res].ceiling


@pytest.mark.slow
def test_policy_lab_full_grid_and_suite():
    """tests/test_simulator.py:305 on the port's CPU, but for its ``sim``
    command (not ported): the report is read through ``last_report``."""
    P = pkgs()[1]
    crowd = P.sim.build_scenario("flash_crowd", seconds=45, seed=11)
    tuned = P.lab.tune_aimd(crowd, device="cpu")
    assert tuned["trials"]
    assert all(tr["bandViolations"] == 0 for tr in tuned["trials"])
    default_score = next(tr["score"] for tr in tuned["trials"]
                         if tr["params"] == DEFAULT_GAINS)
    assert tuned["bestScore"] >= default_score
    scen = {"flash_crowd": crowd,
            "retry_storm": P.sim.build_scenario("retry_storm", seconds=45,
                                                seed=11)}
    report = P.lab.run_lab(
        scen, [P.lab.LabPolicy("aimd-default"),
               P.lab.LabPolicy("aimd-tuned", aimd=tuned["best"])],
        stamp_ms=BASE_MS, device="cpu")
    assert set(report["results"]) == {"flash_crowd", "retry_storm"}
    assert "aimd-tuned" in report["winners"].values()
    for cell in report["results"].values():
        for run in cell.values():
            assert run["bandViolations"] == 0
    assert P.lab.last_report()["winners"] == report["winners"]


# -- clock seam + backward-clock regression --------------------------------


def test_set_clock_resets_cursors_and_survives_backward_step():
    """tests/test_simulator.py:340 on both packages (each on its default
    engine and frozen clock), with what each cursor read equal."""

    def go(P):
        P.tu.freeze_time(BASE_MS)
        engine = P.reset(capacity=512)
        seen = []
        try:
            P.st.load_flow_rules([P.st.FlowRule(resource="clockres",
                                                count=100)])
            c_row = engine.registry.cluster_row("clockres")

            def drive(now):
                buf = P.batch.make_entry_batch_np(8)
                buf["cluster_row"][:4] = c_row
                buf["count"][:4] = 1
                engine.check_batch(P.entry_batch(buf), now_ms=now)

            drive(BASE_MS)
            P.tu.advance_time(1000)
            engine._spill_flight(BASE_MS + 1000)
            assert engine.timeseries.last_stamp_ms == BASE_MS
            assert engine.slo._last_ingest_ms == BASE_MS
            engine.adaptive._backoff_until_ms = BASE_MS + 60_000

            sim = P.sim.SimClock(86_400_000)
            engine.set_clock(sim.now_ms)
            assert engine.now_ms() == 86_400_000
            assert engine.timeseries.retained() == 0
            assert engine.slo._last_ingest_ms == -1
            assert engine.adaptive._backoff_until_ms == 0
            lease = engine._leases.get("clockres")
            if lease is not None:
                assert lease.usage(sim.now_ms()) == 0.0
            drive(sim.now_ms())
            sim.advance(1000)
            engine._spill_flight(sim.now_ms())
            assert engine.timeseries.last_stamp_ms == 86_400_000
            assert engine.slo._last_ingest_ms == 86_400_000
            seen.append(engine.timeseries_view()["seconds"])

            loop = engine.adaptive
            loop.interval_s = 1
            loop._last_tick_ms = BASE_MS
            loop._enabled = True
            loop.on_spill(86_401_000)
            assert loop._last_tick_ms == 86_401_000
            loop.on_spill(86_403_000)
            assert loop._last_tick_ms == 86_403_000

            engine.rollout.load_candidate(
                "adaptive-99",
                {"flow": [P.st.FlowRule(resource="clockres", count=200)]},
                stage="shadow", source="adaptive")
            loop._inflight = "adaptive-99"
            loop.reset_timebase()
            assert loop._inflight is None
            assert engine.rollout.candidate("adaptive-99").stage == "aborted"
            assert loop._backoff_until_ms == 0
            engine.set_clock(None)
            seen.append([(r["kind"], r.get("family"))
                         for r in engine.journal.tail()])
        finally:
            P.retire(engine)
            P.tu.unfreeze_time()
        return seen

    J, P = pkgs()
    assert go(J) == go(P)


def test_set_clock_after_a_replay():
    """An engine that has replayed a trace on a ``SimClock`` swaps back to
    the process clock: both packages' cursors reset alike and the next
    second spills on the new timebase."""

    def go(P):
        tr = P.sim.build_scenario("flash_crowd", seconds=6, seed=2)
        rep = P.replayer(tr)
        clock = P.sim.SimClock(tr.epoch_ms)
        eng = rep._build_engine(clock)
        try:
            rows = rep._resolve_rows(eng)
            for sec in tr.seconds:
                entries = [("web", c, n, 0) for c, n in sec["d"]["web"]]
                rep._dispatch_entries(eng, rows, entries, clock.now_ms(),
                                      hashlib.sha256())
                clock.advance(1000)
            eng._spill_flight(clock.now_ms())
            before = eng.timeseries.last_stamp_ms
            P.tu.freeze_time(BASE_MS)
            eng.set_clock(None)
            after = (eng.now_ms(), eng.timeseries.retained(),
                     eng.slo._last_ingest_ms)
            buf = P.batch.make_entry_batch_np(8)
            buf["cluster_row"][:3] = rows["web"][0]
            buf["count"][:3] = 1
            dec = eng.check_batch(P.entry_batch(buf))
            P.tu.advance_time(1000)
            eng._spill_flight()
            return (before, after, [int(x) for x in dec.reason],
                    eng.timeseries.last_stamp_ms,
                    eng.timeseries_view()["seconds"])
        finally:
            eng.close()
            P.tu.unfreeze_time()

    J, P = pkgs()
    got = go(P)
    assert got == go(J)
    assert got[1] == (BASE_MS, 0, -1) and got[3] == BASE_MS
