"""LLM admission in the port (``sentinel_tpu_torch/llm/``, the engine's
streaming reservations, their checkpoint rows and the ``MSG_STREAM_TICK``
wire branch) against the JAX package, on the CPU.

Every tier-1 test of ``tests/test_llm.py`` but the exporter's (the port
has no ``telemetry/exporter.py`` yet) runs here on BOTH packages: each
scenario is written once against a package namespace
(``tests/test_torch_support.py:LlmPkg``) and driven on the JAX package's
default engine and on the port's (``device="cpu"``), each on its own
package's frozen clock at the same instant. What each side observed
(verdicts, returned amounts, ledger ``stats()``, lowered rules as
converter dicts) must be equal, and so must the engines' state and rule
tensors afterwards (integers bit for bit, floats within ``FLOAT_RTOL``).
The reference's assertions run on both sides as well. The differential
oracle is the reference's own numpy mirror (``tests/test_llm.py:
_TpsOracle``), held against both engines op for op.

Beyond the reference file: a checkpoint with open reservations crosses
the packages both ways with equal ledger rows, and the ``MSG_STREAM_TICK``
replies (open, tick, close, abort, a block, a malformed frame, an unknown
stream) are byte-equal to the JAX package's server on both frontends.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_llm import BASE_MS, _TpsOracle
from tests.test_torch_support import (assert_tree_equal, jax_to_np,
                                      llm_pkgs, port_np, replay_view)


@pytest.fixture
def pair():
    """A fresh default engine of each package (capacity 512, the
    reference fixture's), each on its package's frozen clock."""
    pkgs = llm_pkgs()
    for P in pkgs:
        P.tu.freeze_time(BASE_MS)
    sides = [(P, P.reset(capacity=512)) for P in pkgs]
    yield sides
    for P, eng in sides:
        P.retire(eng)
        P.tu.unfreeze_time()


def both(sides, fn):
    """``fn(P, eng)`` on each side; the two observations must be equal."""
    out = [fn(P, eng) for P, eng in sides]
    assert out[0] == out[1], out
    return out[1]


def advance(sides, ms):
    for P, _ in sides:
        P.tu.advance_time(ms)


def assert_engines_equal(sides):
    """Equal state and rule tensors once both committers have landed."""
    (_, j), (_, p) = sides
    for _, eng in sides:
        eng._flush_committer()
    with j._lock, p._lock:
        if j._state is None or p.state is None:
            assert j._state is None and p.state is None
            return
        assert_tree_equal(jax_to_np(j._state), port_np(p.state))
        assert_tree_equal(jax_to_np(j._rules), port_np(p.rules))


def tps(P, **kw):
    return P.rules.TpsRule(**kw)


# -- rule lowering + hot reload ----------------------------------------------


def test_tps_rules_lower_into_flow_family(pair):
    """tests/test_llm.py:33, on both packages: the lowered rules as
    converter dicts, a hot reload that keeps operator flow rules, and the
    journal's rule loads."""

    def go(P, eng):
        eng.tps_rules.load_rules([
            tps(P, model="m1", tokens_per_second=100, burst_tokens=20),
            tps(P, model="m2", tokens_per_second=50, tenant="tenantA"),
        ])
        lowered = {r.resource: r for r in eng.flow_rules.get_rules()
                   if getattr(r, "derived_from", None) == "tps"}
        assert set(lowered) == {"llm:m1", "llm:m2"}
        assert lowered["llm:m1"].count == 120.0
        assert lowered["llm:m2"].limit_app == "tenantA"
        first = [P.conv.flow_rule_to_dict(r)
                 for r in eng.flow_rules.get_rules()]
        P.st.load_flow_rules([P.st.FlowRule(resource="plain", count=7)])
        eng.tps_rules.load_rules([tps(P, model="m1", tokens_per_second=300)])
        by_res = {r.resource: r for r in eng.flow_rules.get_rules()}
        assert by_res["llm:m1"].count == 300.0
        assert "llm:m2" not in by_res
        assert by_res["plain"].count == 7.0
        loads = [(r["kind"], r.get("family"), r.get("count"))
                 for r in eng.journal.tail()]
        return (first, [P.conv.flow_rule_to_dict(r)
                        for r in eng.flow_rules.get_rules()],
                eng._llm_window_budget, eng._llm_max_streams, loads)

    both(pair, go)
    assert_engines_equal(pair)


def test_tps_converter_round_trip():
    """tests/test_llm.py:54, on both packages, and across them: each
    package parses the other's JSON back to an equal rule."""
    J, P = llm_pkgs()
    dicts = []
    for pkg in (J, P):
        rules = [tps(pkg, model="m", tokens_per_second=10, burst_tokens=2,
                     tenant="t", max_concurrent_streams=3,
                     cluster_mode=True, cluster_config={"flowId": 77},
                     candidate_set="c1", rollout_stage="canary")]
        text = pkg.conv.tps_rules_to_json(rules)
        assert pkg.conv.tps_rules_from_json(text) == rules
        mgr = pkg.rules.TpsRuleManager()
        mgr.load_rules(pkg.conv.tps_rules_from_json(
            json.dumps([{"model": "", "tokensPerSecond": 5}])))
        assert mgr.get_rules() == []
        dicts.append(json.loads(text))
    assert dicts[0] == dicts[1]
    for src, dst in ((J, P), (P, J)):
        back = dst.conv.tps_rules_from_json(src.conv.tps_rules_to_json(
            src.conv.tps_rules_from_json(json.dumps(dicts[0]))))
        assert [dataclasses.asdict(r) for r in back] == [
            dataclasses.asdict(r)
            for r in src.conv.tps_rules_from_json(json.dumps(dicts[0]))]


# -- the numpy differential oracle, held against both engines ----------------


def _drive_differential(sides, seed, steps):
    """tests/test_llm.py:233's drive, every op on both engines: each
    verdict and returned amount equal to the oracle's on both."""
    rng = np.random.default_rng(seed)
    models = [("mA", 120, 0), ("mB", 40, 2)]
    for P, eng in sides:
        eng.tps_rules.load_rules([
            tps(P, model=m, tokens_per_second=t, max_concurrent_streams=c)
            for m, t, c in models])
    res_of = {m: "llm:" + m for m, _, _ in models}
    oracle = _TpsOracle(
        limits={res_of[m]: float(t) for m, t, _ in models},
        max_streams={res_of[m]: c for m, _, c in models if c})
    counts = (1, 4, 16)
    sid_seq = 0
    open_ids = []

    def outcome(P, fn):
        try:
            return True, fn()
        except P.exc.BlockException as ex:
            return False, type(ex).__name__

    for _ in range(steps):
        roll = rng.random()
        model, _tps, _cap = models[int(rng.integers(0, len(models)))]
        res = res_of[model]
        now = sides[0][1].now_ms()
        assert sides[1][1].now_ms() == now
        if roll < 0.22:
            count = int(counts[int(rng.integers(0, 3))])
            want = oracle.acquire(res, count, now)
            got = both(sides, lambda P, e: outcome(
                P, lambda: e.entry(res, count=count).exit()))
            assert got[0] == want, (seed, "acquire", count, now)
        elif roll < 0.5:
            sid = f"s{sid_seq}"
            sid_seq += 1
            est = int(rng.integers(1, 400))
            want = oracle.open(sid, res, est, now)
            got = both(sides, lambda P, e: outcome(
                P, lambda: dataclasses.asdict(
                    e.stream_open(sid, model, est))))
            assert got[0] == want, (seed, "open", sid, est, now)
            if got[0]:
                open_ids.append(sid)
        elif roll < 0.75 and open_ids:
            sid = open_ids[int(rng.integers(0, len(open_ids)))]
            tokens = int(rng.integers(0, 200))
            want = oracle.tick(sid, tokens, now)
            got = both(sides, lambda P, e: outcome(
                P, lambda: e.stream_tick(sid, tokens)))
            assert got[0] == want, (seed, "tick", sid, tokens, now)
            if got[0]:
                assert got[1] == oracle.streams[sid]["remaining"]
        elif roll < 0.85 and open_ids:
            sid = open_ids.pop(int(rng.integers(0, len(open_ids))))
            aborted = bool(rng.random() < 0.5)
            want = oracle.close(sid, now, aborted=aborted)
            got = both(sides, lambda P, e: e.stream_close(
                sid, aborted=aborted))
            assert got == want, (seed, "close", sid, aborted, now)
        else:
            advance(sides, int(rng.choice([100, 250, 500, 750, 1000, 1500])))
    now = sides[0][1].now_ms()
    for sid in open_ids:
        want = oracle.close(sid, now)
        assert both(sides, lambda P, e: e.stream_close(sid)) == want
    stats = both(sides, lambda P, e: e.streams.stats())
    for key, want in oracle.stats.items():
        assert stats[key] == want, (seed, key, stats[key], want)
    assert stats["outstandingTokens"] == 0 and stats["active"] == 0
    assert_engines_equal(sides)


@pytest.mark.parametrize("seed,steps", [
    (3, 70),
    pytest.param(11, 70, marks=pytest.mark.slow),
])
def test_tps_differential_oracle(pair, seed, steps):
    _drive_differential(pair, seed, steps)


@pytest.mark.slow
@pytest.mark.parametrize("seed,steps", [(23, 220), (41, 220)])
def test_tps_differential_oracle_soak(pair, seed, steps):
    _drive_differential(pair, seed, steps)


# -- ledger mechanics --------------------------------------------------------


def test_reservation_caps_at_one_window_budget(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=100)])
        lease = eng.stream_open("s1", "m", 5000)
        assert lease.reserved == 100.0 and lease.estimate == 5000.0
        assert eng.streams.stats()["tokensDebited"] == 100.0
        return dataclasses.asdict(lease), eng.streams.stats()

    both(pair, go)
    assert_engines_equal(pair)


def test_abort_refunds_credit_reused_within_window(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=100)])
        eng.stream_open("s1", "m", 60)
        left = eng.stream_tick("s1", 10)
        released = eng.stream_close("s1", aborted=True)
        assert released == 50.0
        eng.stream_open("s2", "m", 60)
        stats = eng.streams.stats()
        assert stats["creditUsed"] == 50.0
        assert stats["tokensDebited"] == 70.0
        return left, released, stats

    both(pair, go)
    assert_engines_equal(pair)


def test_credit_expires_at_window_boundary(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=100)])
        eng.stream_open("s1", "m", 80)
        eng.stream_close("s1")
        P.tu.advance_time(2000)
        eng.stream_open("s2", "m", 80)
        stats = eng.streams.stats()
        assert stats["creditUsed"] == 0.0
        assert stats["creditExpired"] == 80.0
        assert stats["tokensDebited"] == 160.0
        return stats

    both(pair, go)
    assert_engines_equal(pair)


def test_max_concurrent_streams_and_capacity(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([
            tps(P, model="m", tokens_per_second=1000,
                max_concurrent_streams=2)])
        eng.stream_open("a", "m", 1)
        eng.stream_open("b", "m", 1)
        with pytest.raises(P.exc.FlowException):
            eng.stream_open("c", "m", 1)
        assert eng.streams.stats()["openBlocked"] == 1
        led = P.streams.StreamLedger(capacity=1)
        led.open("x", "llm:m", "default", 1, 1, 1, BASE_MS)
        assert led.at_capacity()
        with pytest.raises(OverflowError):
            led.open("y", "llm:m", "default", 1, 1, 1, BASE_MS)
        return eng.streams.stats(), led.stats(), led.checkpoint_rows()

    both(pair, go)
    assert_engines_equal(pair)


def test_idle_eviction_rides_spill_cadence(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=500)])
        eng.streams.idle_evict_ms = 5_000
        eng.stream_open("zombie", "m", 100)
        P.tu.advance_time(6_000)
        eng._spill_flight(eng.now_ms())
        stats = eng.streams.stats()
        assert stats["evicted"] == 1 and stats["active"] == 0
        assert eng.streams.credit_tokens("llm:m") == 100.0
        with pytest.raises(KeyError):
            eng.stream_close("zombie")
        return stats, eng.timeseries_view()["seconds"]

    both(pair, go)
    assert_engines_equal(pair)


# -- checkpoints -------------------------------------------------------------


def _open_reservations(P, eng):
    eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=200),
                              tps(P, model="n", tokens_per_second=50)])
    eng.stream_open("live", "m", 120)
    eng.stream_tick("live", 30)
    eng.stream_open("other", "n", 40)
    eng.stream_tick("other", 45)  # 5 over the reservation, debited live


def test_checkpoint_grafts_stream_ledger(pair, tmp_path):
    """tests/test_llm.py:364, on both packages: the grafted lease
    finishes its lifecycle on the restored engine."""

    def go(P, eng):
        _open_reservations(P, eng)
        ckpt = str(tmp_path / f"llm-{P.name}.npz")
        P.ckpt.save_checkpoint(eng, ckpt)
        fresh = P.reset(capacity=512)
        fresh.tps_rules.load_rules([tps(P, model="m", tokens_per_second=200),
                                    tps(P, model="n", tokens_per_second=50)])
        P.ckpt.restore_checkpoint(fresh, ckpt)
        lease = fresh.streams.get("live")
        assert lease is not None
        assert lease.remaining == 90.0 and lease.streamed == 30.0
        rows = fresh.streams.checkpoint_rows()
        assert fresh.stream_close("live") == 90.0
        return rows, fresh.streams.stats()

    rows = both(pair, go)[0]
    assert {r["streamId"] for r in rows} == {"live", "other"}
    pair[:] = [(P, P.st.get_engine()) for P, _ in pair]
    assert_engines_equal(pair)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_checkpoint_with_open_reservations_crosses_packages(
        pair, tmp_path, source):
    """A save with open reservations in one package restores into a
    fresh engine of EACH package: ledger rows equal to the saver's (but
    ``lastMs``, re-stamped to the restore's now), the two restored
    engines' state equal, and the leases closing to the same
    remainders."""
    for pkg, eng in pair:
        _open_reservations(pkg, eng)
    src = next((pkg, eng) for pkg, eng in pair if pkg.name == source)
    want = [dict(r, lastMs=BASE_MS) for r in src[1].streams.checkpoint_rows()]
    ckpt = str(tmp_path / "cross.npz")
    src[0].ckpt.save_checkpoint(src[1], ckpt)

    def restore(pkg, eng):
        fresh = pkg.reset(capacity=512)
        fresh.tps_rules.load_rules([
            tps(pkg, model="m", tokens_per_second=200),
            tps(pkg, model="n", tokens_per_second=50)])
        pkg.ckpt.restore_checkpoint(fresh, ckpt)
        return fresh

    pair[:] = [(pkg, restore(pkg, eng)) for pkg, eng in pair]
    rows = both(pair, lambda pkg, e: e.streams.checkpoint_rows())
    assert rows == want and {r["streamId"] for r in rows} == {"live",
                                                              "other"}
    assert_engines_equal(pair)
    closes = both(pair, lambda pkg, e: (e.stream_close("live"),
                                        e.stream_close("other", aborted=True),
                                        e.streams.stats()))
    assert closes[:2] == (90.0, 0.0)
    assert_engines_equal(pair)


# -- degraded tenant-fair shares ---------------------------------------------


def test_degraded_sum_of_tenant_shares_bounded():
    """tests/test_llm.py:390, on both packages: every grant equal."""

    def go(P):
        rules = [tps(P, model="m", tokens_per_second=90, cluster_mode=True,
                     cluster_config={"flowId": 501})]
        clients = 3
        global_limit = sum(r.count for r in P.rules.lower_tps_rules(rules))
        grants = []
        for _ in range(clients):
            quota = P.rules.degraded_tps_quota(rules, clients)
            got = [int(quota.acquire(501, 1, now_ms=BASE_MS).status)
                   for _ in range(200)]
            assert got.count(0) == int(global_limit / clients)
            grants.append(got)
        assert sum(g.count(0) for g in grants) <= global_limit
        return grants

    J, P = llm_pkgs()
    assert go(J) == go(P)


# -- wire: MSG_STREAM_TICK ---------------------------------------------------


def _stream_script(codec, CC):
    """(xid, entity) frames of MSG_STREAM_TICK: open, tick, close, a
    second open, a blocked third, an unknown stream's tick and abort, an
    unknown sub-op, a truncated entity, then the second stream's abort."""
    enc = codec.encode_stream_request
    return [
        (1, enc(CC.STREAM_OP_OPEN, "w1", "m", 60)),
        (2, enc(CC.STREAM_OP_TICK, "w1", "", 25)),
        (3, enc(CC.STREAM_OP_CLOSE, "w1")),
        (4, enc(CC.STREAM_OP_OPEN, "w2", "m", 60)),
        (5, enc(CC.STREAM_OP_OPEN, "w3", "m", 60)),
        (6, enc(CC.STREAM_OP_TICK, "ghost", "", 5)),
        (7, enc(CC.STREAM_OP_ABORT, "ghost")),
        (8, enc(9, "w2")),
        (9, b"\x00\x03ab"),
        (10, enc(CC.STREAM_OP_ABORT, "w2")),
    ]


def test_wire_stream_round_trip(pair):
    """tests/test_llm.py:419 through ``process_control_frame`` on both
    packages: the reply bytes equal, the reference's statuses, and FAIL
    with no engine."""

    def run(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=100)])
        server = SimpleNamespace(engine=eng)
        out = []
        for xid, entity in _stream_script(P.codec, P.CC):
            reply, _ns = P.server.process_control_frame(
                server, P.codec.Request(xid, P.CC.MSG_STREAM_TICK, entity),
                {}, None)
            out.append(reply)
        reply, _ = P.server.process_control_frame(
            SimpleNamespace(engine=None),
            P.codec.Request(11, P.CC.MSG_STREAM_TICK,
                            P.codec.encode_stream_request(
                                P.CC.STREAM_OP_OPEN, "x", "m", 1)), {}, None)
        out.append(reply)
        return out, eng.streams.stats()

    replies, _ = both(pair, run)
    P = pair[1][0]
    S = P.CC.TokenResultStatus
    got = []
    for raw in replies:
        resp = P.codec.decode_response(raw[P.codec._LEN.size:])
        body = (P.codec.decode_stream_response(resp.entity)
                if resp.entity else None)
        got.append((resp.status, body))
    assert got == [(S.OK, 60), (S.OK, 35), (S.OK, 35), (S.OK, 60),
                   (S.BLOCKED, 0), (S.BAD_REQUEST, None),
                   (S.BAD_REQUEST, None), (S.BAD_REQUEST, None),
                   (S.BAD_REQUEST, None), (S.OK, 60), (S.FAIL, None)]
    assert_engines_equal(pair)


def _recv_one(sock, reader):
    while True:
        data = sock.recv(65536)
        assert data, "connection closed"
        frames = reader.feed(data)
        if frames:
            assert len(frames) == 1
            return frames[0]


@pytest.mark.parametrize("reactor", [True, False])
def test_stream_tick_replies_match_the_reference_on_both_frontends(
        pair, reactor):
    """The script above over loopback, one frame at a time, to a token
    server of each package serving its engine: byte-equal replies."""

    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=100)])
        svc = P.ts.DefaultTokenService(**P.kw)
        server = P.server.ClusterTokenServer(
            svc, host="127.0.0.1", port=0, reactor=reactor,
            engine=eng).start()
        raw = []
        try:
            with socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=15) as sock:
                sock.settimeout(15)
                reader = P.codec.FrameReader()
                for xid, entity in _stream_script(P.codec, P.CC):
                    sock.sendall(P.codec.encode_request(
                        xid, P.CC.MSG_STREAM_TICK, entity))
                    raw.append(bytes(_recv_one(sock, reader)))
        finally:
            server.stop()
        return raw, eng.streams.stats()

    raw, stats = both(pair, go)
    assert len(raw) == 10 and stats["opened"] == 2
    assert_engines_equal(pair)


# -- simulator + gateway e2e -------------------------------------------------


def test_hetero_cost_default_has_no_stream_surface():
    def go(P):
        tr = P.scen.hetero_cost(seconds=20, seed=3)
        assert tr.rules.get("flow") and "tps" not in tr.rules
        assert tr.resources == ["model-small", "model-large"]
        assert all("g" not in sec for sec in tr.seconds)
        return tr.to_json()

    J, P = llm_pkgs()
    assert go(J) == go(P)


def test_hetero_cost_streamed_replay_is_deterministic():
    """tests/test_llm.py:468: the JAX package replays once, the port
    twice; every observation equal."""

    def trace(P):
        tr = P.scen.hetero_cost(seconds=16, seed=5, streams_per_s=0.9,
                                abandon_rate=0.3)
        assert tr.rules.get("tps") and "flow" not in tr.rules
        rt = P.trace.Trace.from_dict(json.loads(json.dumps(tr.to_dict())))
        assert rt.to_dict() == tr.to_dict()
        return tr

    J, P = llm_pkgs()
    jt, pt = trace(J), trace(P)
    assert jt.to_json() == pt.to_json()
    want = replay_view(J.replayer(jt).run())
    p1 = replay_view(P.replayer(pt).run())
    p2 = replay_view(P.replayer(pt).run())
    assert p1 == p2 == want
    assert want["streams"]["opened"] > 0
    assert want["streams"]["outstandingTokens"] == 0
    assert want["streams"]["active"] == 0


def test_trace_rejects_malformed_stream_events():
    def go(P):
        tr = P.scen.hetero_cost(seconds=10, seed=1, streams_per_s=1.0)
        d = tr.to_dict()
        sec = next(s for s in d["seconds"] if s.get("g"))
        sec["g"][0] = {"op": "teleport", "id": "x"}
        with pytest.raises(ValueError) as info:
            P.trace.Trace.from_dict(d)
        return tr.to_json(), str(info.value)

    J, P = llm_pkgs()
    assert go(J) == go(P)


def test_gateway_completion_lifecycle(pair):
    def go(P, eng):
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=500)])
        gw = P.gw.LLMGateway(engine=eng,
                             server=P.gw.MockInferenceServer(seed=7))
        r = gw.complete("req-1", "m", max_tokens=64, collect_events=True)
        assert r.admitted and not r.aborted
        assert r.events[-1] == P.gw.SSE_DONE
        assert r.streamed_tokens > 0
        r2 = gw.complete("req-2", "m", max_tokens=64, abandon_after_tokens=8)
        assert r2.aborted and r2.released_tokens > 0
        stats = eng.streams.stats()
        assert stats["active"] == 0 and stats["outstandingTokens"] == 0
        eng.tps_rules.load_rules([tps(P, model="m", tokens_per_second=1)])
        P.tu.advance_time(2000)
        r3 = gw.complete("req-3", "m", max_tokens=1)
        blocked = gw.complete("req-4", "m", max_tokens=64)
        assert not blocked.admitted and blocked.blocked_reason
        return ([dataclasses.asdict(x) for x in (r, r2, r3, blocked)],
                eng.streams.stats())

    both(pair, go)
    assert_engines_equal(pair)


def test_gateway_default_engine_and_device_policy(pair):
    """``LLMGateway()`` rides the module's default engine (the one
    ``reset`` built); ``run_demo`` and ``ReplayEngine`` with no device
    raise where there is no card, and never fall back to the CPU."""
    import torch

    P, eng = pair[1]
    assert P.gw.LLMGateway().engine is eng
    if not torch.cuda.is_available():
        tr = P.scen.hetero_cost(seconds=4, seed=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.replay.ReplayEngine(tr)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.gw.run_demo(seconds=4)


@pytest.mark.slow
def test_gateway_demo_end_to_end():
    """tests/test_llm.py:497 on the port's CPU: the ledger drains, no
    silent drops, at least one per-model TPS promotion."""
    P = llm_pkgs()[1]
    summary = P.gw.run_demo(seconds=90, seed=0, device="cpu")
    assert summary["ledgerDrained"]
    assert summary["silentDrops"] == 0
    assert summary["tpsPromotes"] >= 1
    assert summary["finalCounts"]


@pytest.mark.slow
def test_gateway_demo_anchor_on_the_port():
    """``run_demo(60, 0)`` on the port's CPU gives the JAX package's
    verdict sha (as it runs in this repository, ROADMAP C17), objective
    and stream counts."""
    P = llm_pkgs()[1]
    d = P.gw.run_demo(seconds=60, seed=0, device="cpu")
    assert d["verdictSha256"] == (
        "478b073cd1254f6758e6c7841f65f4b84b962001a15bc0c0e65e20ddc17ed46a")
    assert d["objective"] == {"blockRate": 0.027284, "rtP99Ms": 126.09,
                              "utilization": 0.972716}
    assert d["tpsPromotes"] == 5
    assert {k: d["streams"][k] for k in ("opened", "ticks", "blocked",
                                         "closed", "aborted",
                                         "outstandingTokens")} == {
        "opened": 20, "ticks": 91, "blocked": 28, "closed": 14,
        "aborted": 6, "outstandingTokens": 0}
    assert d["ledgerDrained"] and d["silentDrops"] == 0
