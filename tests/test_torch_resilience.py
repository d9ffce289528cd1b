"""The port's resilience layer and span context against the JAX package's,
on the CPU: ``DeadlineBudget`` on frozen clocks, ``RetryPolicy``
schedules under one seed, ``HealthGate`` transitions on both packages'
frozen clocks, the health-probe registry, the fault seams, and the W3C
traceparent / span collector / OTLP export. Every comparison is exact.
"""

from __future__ import annotations

import pytest

from sentinel_tpu import resilience as jres
from sentinel_tpu.core import config as jconfig
from sentinel_tpu.telemetry import spans as jspans
from sentinel_tpu.utils import time_util as jtu

from sentinel_tpu_torch import resilience as pres
from sentinel_tpu_torch.core import config as pconfig
from sentinel_tpu_torch.telemetry import spans as pspans
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000


@pytest.fixture()
def clocks():
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    yield
    for tu in (jtu, ptu):
        tu.unfreeze_time()


def _advance(ms):
    for tu in (jtu, ptu):
        tu.advance_time(ms)


def test_deadline_budget(clocks):
    j, p = jres.DeadlineBudget(500), pres.DeadlineBudget(500)
    for step, wait in ((0, 900), (120, 100), (300, 700), (80, 5), (10, 1)):
        _advance(step)
        assert (p.remaining_ms(), p.expired, p.clamp_wait_ms(wait)) == (
            j.remaining_ms(), j.expired, j.clamp_wait_ms(wait))
    assert p.expired and p.clamp_wait_ms(-3) == 0


@pytest.mark.parametrize("jitter", ["decorrelated", "full", "none"])
@pytest.mark.parametrize("seed", [None, 0, 42])
def test_retry_schedules_match_under_one_seed(jitter, seed):
    kw = dict(base_ms=200, max_ms=9000, multiplier=2.5, jitter=jitter,
              seed=seed)
    js, ps = (jres.RetryPolicy(**kw).session(),
              pres.RetryPolicy(**kw).session())
    if seed is None and jitter != "none":
        assert [ps.next_delay_ms() for _ in range(2)][0] == 200
        return
    for k in range(12):
        if k == 7:
            js.reset()
            ps.reset()
        assert ps.next_delay_ms() == js.next_delay_ms()
        assert ps.attempt == js.attempt


def test_retry_policy_from_config_and_validation():
    keys = {"csp.sentinel.resilience.seed": "17",
            "csp.sentinel.resilience.retry.base.ms": "300",
            "csp.sentinel.resilience.cluster.client.retry.max.ms": "4000",
            "csp.sentinel.resilience.retry.jitter": "full"}
    try:
        for k, v in keys.items():
            jconfig.config.set(k, v)
            pconfig.config.set(k, v)
        jp = jres.RetryPolicy.from_config("cluster.client", 500, 60_000)
        pp = pres.RetryPolicy.from_config("cluster.client", 500, 60_000)
        assert vars(pp) == vars(jp)
        js, ps = jp.session(), pp.session()
        assert [ps.next_delay_ms() for _ in range(8)] == [
            js.next_delay_ms() for _ in range(8)]
    finally:
        for k in keys:
            for c in (jconfig.config, pconfig.config):
                c._config.pop(k, None)
    for bad in (dict(base_ms=0), dict(base_ms=10, max_ms=5),
                dict(multiplier=0.5), dict(jitter="x")):
        for mod in (jres, pres):
            with pytest.raises(ValueError):
                mod.RetryPolicy(**bad)


def test_health_gate_transitions(clocks):
    """CLOSED -> OPEN after 3 failures -> rejects -> HALF_OPEN probe
    after open_ms -> a failed probe re-opens -> a good probe closes; each
    snapshot equal between the packages."""
    j = jres.HealthGate(failure_threshold=3, open_ms=1000,
                        half_open_probes=2)
    p = pres.HealthGate(failure_threshold=3, open_ms=1000,
                        half_open_probes=2)
    script = ["f", "s", "f", "f", "f", "a", "a", 600, "a", 400, "a", "a",
              "a", "f", "a", 1000, "a", "s", "a", "f"]
    for op in script:
        if isinstance(op, int):
            _advance(op)
            continue
        outs = []
        for g in (j, p):
            if op == "a":
                outs.append(g.allow())
            elif op == "s":
                g.record_success()
            else:
                g.record_failure()
        assert outs[:1] == outs[1:]
        assert p.snapshot() == j.snapshot()
        assert p.state_name == j.state_name
    assert p.snapshot()["openCount"] == 2
    for bad in (dict(failure_threshold=0), dict(open_ms=-1),
                dict(half_open_probes=0)):
        with pytest.raises(ValueError):
            pres.HealthGate(**bad)


def test_health_gate_from_config_defaults():
    assert vars(pres.HealthGate.from_config()).keys() == vars(
        jres.HealthGate.from_config()).keys()
    g = pres.HealthGate.from_config()
    assert (g.failure_threshold, g.open_ms, g.half_open_probes) == (3, 5000, 1)


def test_probe_registry_and_fault_points():
    class Loop:
        def probe(self):
            return {"lastSuccessMs": 5}

    loop = Loop()
    off = pres.register_probe("port-loop", loop.probe)
    pres.register_probe("port-static", lambda: 1 / 0)
    try:
        snap = pres.health_snapshot()
        assert snap["port-loop"] == {"lastSuccessMs": 5}
        assert "error" in snap["port-static"]
        del loop  # a dropped owner self-prunes
        assert "port-loop" not in pres.health_snapshot()
    finally:
        off()
        pres.register_probe("port-static", lambda: {})()  # replace, then off
    for point in ("cluster.client.send", "cluster.server.frame",
                  "cluster.ha.leader.crash", "cluster.ha.halfopen",
                  "cluster.ha.stale.epoch", "cluster.reactor.conn.drop",
                  "cluster.reactor.conn.stall"):
        assert point in pres.faults.FAULT_POINTS
        assert point in jres.faults.FAULT_POINTS
    # One seeded schedule fires the same on both packages.
    fired = []
    for mod in (jres, pres):
        with mod.FaultInjector(seed=9) as inj:
            inj.arm("cluster.client.send", "error", probability=0.5,
                    after=2, times=4)
            out = []
            for _ in range(20):
                try:
                    mod.faults.fire("cluster.client.send")
                    out.append(0)
                except mod.FaultInjected:
                    out.append(1)
            fired.append(out)
    assert fired[0] == fired[1] and sum(fired[1]) == 4


@pytest.mark.parametrize("value", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "00-zzf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "",
])
def test_traceparent_parse(value):
    want = jspans.parse_traceparent(value)
    got = pspans.parse_traceparent(value)
    assert (None if got is None else tuple(got)) == (
        None if want is None else tuple(want))
    if got is not None:
        assert got.traceparent() == want.traceparent()
        child = got.child()
        assert child.trace_id == got.trace_id
        assert child.span_id != got.span_id


def test_span_collector_snapshot_traces_and_otlp(clocks):
    """The same spans recorded on both collectors (local and shipped
    remote ones) give the same snapshot, grouping and OTLP document."""
    ctx = pspans.parse_traceparent(
        "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01")
    jctx = jspans.parse_traceparent(ctx.traceparent())
    out = []
    for mod, c in ((jspans, jctx), (pspans, ctx)):
        col = mod.SpanCollector(sample_every=2, capacity=3)
        assert [col.sample() is not None for _ in range(4)] == [
            False, True, False, True]
        sp = mod.Span("sentinel.entry", c, attrs={"resource": "r"})
        sp.attrs.update(blocked=False, reason=0, ratio=0.5)
        col.record(sp.finish(duration_us=42))
        for k in range(3):
            col.record_remote(
                mod.TraceContext(c.trace_id, f"{k:016x}"),
                "cluster.token_service", c.span_id, NOW0 + k, 10 + k,
                attrs={"flowId": 7})
        out.append((col.snapshot(), col.snapshot(limit=1, offset=1),
                    col.traces(limit=1), mod.to_otlp(col.snapshot()["spans"])))
    assert out[1] == out[0]
    assert out[1][0]["recorded"] == 4 and len(out[1][0]["spans"]) == 3


def test_span_tlv_round_trip_between_packages():
    from sentinel_tpu.cluster import codec as jcodec
    from sentinel_tpu_torch.cluster import codec as pcodec

    ctx = pspans.new_trace_context()
    for enc, dec in ((pcodec, jcodec), (jcodec, pcodec)):
        ent = enc.append_trace_tlv(enc.encode_flow_request(1, 2, True),
                                   ctx.traceparent())
        back = pspans.parse_traceparent(dec.read_trace_tlv(
            ent, dec.FLOW_REQ_SIZE))
        assert back == ctx
        info = enc.encode_span_info(ctx.span_id, NOW0, 77)
        assert dec.decode_span_info(info) == (ctx.span_id, NOW0, 77)
    assert pcodec.decode_span_info("a:b") is None
    assert pcodec.read_trace_tlv(b"\x00" * 13, 13) is None
