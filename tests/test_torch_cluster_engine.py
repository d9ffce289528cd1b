"""The engine's cluster token check, port against the JAX package, on the
CPU: one JAX engine that is the client of a JAX token server, one port
engine (``device="cpu"``) that is the client of a port token server,
both packages' clocks frozen at one instant.

Each script runs ``entry`` / ``exit`` on cluster-mode flow and param
rules through both. Compared exactly: every verdict (pass, or the
exception's type), each device-path step's (reason, wait_us), the
cluster counters (``cluster_fallback_count``,
``cluster_budget_exhausted_count``, ``cluster_overload_count``),
``resilience_stats()`` except ``adaptive`` (not ported yet), and
``telemetry_snapshot()`` except the step timer's measured walls (its
keys and counts are compared). The stitched span tree of a sampled entry
(``sentinel.entry`` → ``cluster.token_request`` →
``cluster.token_service``) has the same shape on both.

The JAX engines are built once for the module (each compiles its step
at width 1, several seconds on the CPU); every test starts both servers
afresh, so the global windows start empty.
"""

from __future__ import annotations

import pytest

import sentinel_tpu as jst
from sentinel_tpu.cluster import server as JS
from sentinel_tpu.cluster import token_service as JT
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.resilience import faults as jfaults
from sentinel_tpu.utils import time_util as jtu

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.cluster import server as PS
from sentinel_tpu_torch.cluster import token_service as PT
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.resilience import faults as pfaults
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000
FLOW_RES, PARAM_RES, LOCAL_RES = "cluster-flow", "cluster-param", "plain"
FLOW_ID, PARAM_ID = 9100, 9101


def _engine_rules(pkg):
    flow = [pkg.FlowRule(resource=FLOW_RES, count=3, cluster_mode=True,
                         cluster_config={"flowId": FLOW_ID,
                                         "thresholdType": 1,
                                         "fallbackToLocalWhenFail": True}),
            pkg.FlowRule(resource=LOCAL_RES, count=2)]
    param = [pkg.ParamFlowRule(resource=PARAM_RES, param_idx=0, count=2,
                               cluster_mode=True,
                               cluster_config={"flowId": PARAM_ID,
                                               "thresholdType": 1})]
    return flow, param


def _server_rules(pkg):
    # The server's copy: a looser flow quota than the local fallback (4
    # against 3), so a fallback is visible in the verdicts.
    return [pkg.FlowRule(resource=FLOW_RES, count=4, cluster_mode=True,
                         cluster_config={"flowId": FLOW_ID,
                                         "thresholdType": 1}),
            pkg.FlowRule(resource=PARAM_RES, count=2, cluster_mode=True,
                         cluster_config={"flowId": PARAM_ID,
                                         "thresholdType": 1})]


class Side:
    def __init__(self, name, pkg, eng, server_mod, service_fn, tu, ctx,
                 faults):
        self.name, self.pkg, self.eng = name, pkg, eng
        self.server_mod, self.service_fn = server_mod, service_fn
        self.tu, self.ctx, self.faults = tu, ctx, faults
        self.server = None
        self.last = (0, 0)
        submit = eng._submit_entry

        def recorded(*a, **k):
            self.last = submit(*a, **k)
            return self.last

        eng._submit_entry = recorded
        flow, param = _engine_rules(pkg)
        eng.flow_rules.load_rules(flow)
        eng.param_rules.load_rules(param)

    def start_server(self, reactor):
        svc = self.service_fn()
        svc.rules.load_rules("default", _server_rules(self.pkg))
        self.server = self.server_mod.ClusterTokenServer(
            svc, host="127.0.0.1", port=0, reactor=reactor).start()
        self.eng.cluster.set_to_client("127.0.0.1", self.server.bound_port,
                                       request_timeout_s=5.0)
        assert self.eng.cluster.client_if_active() is not None

    def stop_server(self):
        if self.server is not None:
            self.server.stop()
            self.server = None

    def op(self, resource, args=(), prioritized=False, exit_after=True):
        self.last = (0, 0)
        try:
            h = self.eng.entry(resource, args=args, prioritized=prioritized)
        except self.pkg.BlockException as ex:
            return type(ex).__name__, self.last
        if exit_after:
            h.exit()
        return "pass", self.last

    def counters(self):
        e = self.eng
        return (e.cluster_fallback_count, e.cluster_budget_exhausted_count,
                e.cluster_overload_count)


@pytest.fixture(scope="module")
def sides():
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    # A context pooled on this thread by an earlier module's engine holds
    # that engine's rows: drop it, and retire every pooled one.
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()
    # First steps are slow on both sides: the JAX service compiles its
    # acquire step once per shape, and the port's first window scatter
    # imports torch's shape helpers (~0.8 s). Absorb both here, or a first
    # acquire could outlast the entry's budget and fall back on one side
    # only.
    for svc, pkg in ((JT.DefaultTokenService(), jst),
                     (PT.DefaultTokenService(device="cpu"), pst)):
        svc.rules.load_rules("default", _server_rules(pkg))
        svc.request_tokens([(FLOW_ID, 1, False)])
    j = Side("jax", jst, JEngine(capacity=256), JS,
             lambda: JT.DefaultTokenService(), jtu, jctx, jfaults)
    p = Side("port", pst, PEngine(capacity=256, device="cpu"), PS,
             lambda: PT.DefaultTokenService(device="cpu"), ptu, pctx,
             pfaults)
    # A generous entry budget on both sides: the clocks are frozen, so the
    # budget only caps each acquire's real wait, and a loaded machine must
    # not turn a slow reply into a fallback on one side only.
    for s in (j, p):
        s.eng.cluster_entry_budget_ms = 3000
    yield j, p
    for s in (j, p):
        s.stop_server()
        s.eng.close()
    for tu in (jtu, ptu):
        tu.unfreeze_time()


@pytest.fixture()
def pair(sides, request):
    """Both servers fresh, both clocks moved to a whole second far from
    every earlier test's windows."""
    reactor = getattr(request, "param", True)
    for s in sides:
        s.tu.advance_time(100_000 - s.tu.current_time_millis() % 1000)
        s.ctx.replace_context(None)
        s.start_server(reactor)
        s.eng.spans.sample_every = 0
    yield sides
    for s in sides:
        s.stop_server()
        s.eng.cluster.stop()
        s.ctx.replace_context(None)


def _both(pair, *a, **k):
    j, p = pair
    want, got = j.op(*a, **k), p.op(*a, **k)
    assert got == want, (a, k)
    return got


def _advance(pair, ms):
    for s in pair:
        s.tu.advance_time(ms)


def _stats(side):
    out = side.eng.resilience_stats()
    out.pop("adaptive")
    return out


@pytest.mark.parametrize("pair", [True, False], indirect=True,
                         ids=["reactor", "legacy"])
def test_cluster_verdicts_counters_and_stats_match(pair):
    """Server verdicts on the cluster flow rule (quota 4 on the server, 3
    locally), the cluster param rule per value, a local rule beside them,
    a prioritized entry past the quota (SHOULD_WAIT sleeps, then
    passes), the next second; then equal counters and stats."""
    outcomes = []
    for _ in range(5):
        outcomes.append(_both(pair, FLOW_RES))
    for v in ("a", "a", "b", "a", 3):
        outcomes.append(_both(pair, PARAM_RES, args=(v,)))
    for _ in range(3):
        outcomes.append(_both(pair, LOCAL_RES))
    _advance(pair, 1000)
    for _ in range(4):
        outcomes.append(_both(pair, FLOW_RES))
    outcomes.append(_both(pair, FLOW_RES, prioritized=True))
    verdicts = [o[0] for o in outcomes]
    assert verdicts[:5] == ["pass"] * 4 + ["FlowException"]
    # A cluster BLOCKED pre-blocks the entry: the reference raises it as
    # a flow block, param rule or not.
    assert verdicts[5:10] == ["pass", "pass", "pass", "FlowException",
                              "pass"]
    assert "pass" == verdicts[-1]
    j, p = pair
    assert p.counters() == j.counters()
    assert _stats(p) == _stats(j)
    assert p.eng.cluster_degraded_thresholds() == \
        j.eng.cluster_degraded_thresholds() == {FLOW_ID: (3.0, 1000)}
    snap = p.eng.resilience_stats()
    assert snap["adaptive"] == j.eng.resilience_stats()["adaptive"]
    assert snap["adaptive"]["enabled"] is False
    assert snap["tokenClientBreaker"]["state"] == "CLOSED"
    assert snap["clusterHA"]["roleName"] == "CLIENT"


def test_fallback_when_the_send_seam_fires(pair):
    """``cluster.client.send`` raising: the acquire FAILs, the rule falls
    back to its local check (counted), and the client drops its
    connection, so later entries go local without an acquire."""
    j, p = pair
    with j.faults.FaultInjector(seed=3) as jinj, \
            p.faults.FaultInjector(seed=3) as pinj:
        for inj in (jinj, pinj):
            inj.arm("cluster.client.send", "error")
        verdicts = [_both(pair, FLOW_RES)[0] for _ in range(4)]
        assert pinj.fires("cluster.client.send") == \
            jinj.fires("cluster.client.send") == 1
    assert verdicts == ["pass"] * 3 + ["FlowException"]
    assert p.counters() == j.counters()
    assert _stats(p) == _stats(j)


def test_breaker_opens_on_a_half_open_server(pair):
    """The servers swallow their replies (``cluster.ha.halfopen``): each
    acquire times out at the entry's budget, falls back (counted), and
    after three failures the breaker opens, so the next entries fail
    fast without the wire. Local quota 3 decides the verdicts."""
    j, p = pair
    before = (j.counters(), p.counters())
    with j.faults.FaultInjector(seed=4) as jinj, \
            p.faults.FaultInjector(seed=4) as pinj:
        for inj in (jinj, pinj):
            inj.arm("cluster.ha.halfopen", "garbage", garbage=b"")
        for s in pair:  # each swallowed reply costs one budget of waiting
            s.eng.cluster_entry_budget_ms = 300
        try:
            verdicts = [_both(pair, FLOW_RES)[0] for _ in range(5)]
        finally:
            for s in pair:
                s.eng.cluster_entry_budget_ms = 3000
    assert verdicts == ["pass"] * 3 + ["FlowException"] * 2
    assert p.counters() == j.counters()
    assert p.counters()[0] - before[1][0] == 5
    stats = _stats(p)
    assert stats == _stats(j)
    assert stats["tokenClientBreaker"]["state"] == "OPEN"
    assert stats["tokenClientBreaker"]["rejectedCount"] == 2


def test_local_check_when_the_server_is_down(pair):
    """The server stopped: the client drops its connection and the
    cluster rules are enforced locally (no acquire, nothing counted)."""
    import time

    j, p = pair
    before = (j.counters(), p.counters())
    for s in pair:
        s.stop_server()
    deadline = time.monotonic() + 10
    while any(s.eng.cluster.client_if_active() is not None for s in pair):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    verdicts = [_both(pair, FLOW_RES)[0] for _ in range(4)]
    assert verdicts == ["pass"] * 3 + ["FlowException"]
    assert (j.counters(), p.counters()) == before
    assert _stats(p) == _stats(j)


def test_stitched_span_tree_and_telemetry_snapshot(pair):
    """Every entry sampled: a cluster-checked entry records
    ``sentinel.entry`` → ``cluster.token_request`` →
    ``cluster.token_service`` (the server's span, shipped back in the
    reply), one trace id; an entry without cluster rules records none.
    Then ``telemetry_snapshot()`` agrees."""
    for s in pair:
        s.eng.spans.sample_every = 1
    _both(pair, FLOW_RES)
    _both(pair, LOCAL_RES)
    _both(pair, PARAM_RES, args=("z",))
    trees = []
    for s in pair:
        traces = s.eng.spans.traces()
        assert len(traces) == 2
        shapes = []
        for t in traces:
            by_id = {sp["spanId"]: sp for sp in t["spans"]}
            assert all(sp["traceId"] == t["traceId"] for sp in t["spans"])
            shape = sorted(
                (sp["name"], by_id[sp["parentSpanId"]]["name"]
                 if sp["parentSpanId"] in by_id else None,
                 sp["attributes"].get("kind"))
                for sp in t["spans"])
            shapes.append(shape)
        trees.append(shapes)
    assert trees[0] == trees[1]
    for shape in trees[1]:
        assert [n for n, _, _ in shape] == [
            "cluster.token_request", "cluster.token_service",
            "sentinel.entry"]
        assert shape[0][1] == "sentinel.entry"
        assert shape[1][1] == "cluster.token_request"
    j, p = pair
    want, got = j.eng.telemetry_snapshot(), p.eng.telemetry_snapshot()
    for key in ("stepTimer", "pipeline"):
        assert set(got.pop(key)) == set(want.pop(key))
    assert got == want


def test_slot_mode_cluster_check(sides):
    """Slot mode (``slot_budget``): the cluster verdict pre-blocks or
    masks the device check at the slot row as on the fixed-capacity
    path; port slot engine against the JAX slot engine."""
    j, p = sides
    engines = (JEngine(capacity=64, slot_budget=8),
               PEngine(capacity=64, device="cpu", slot_budget=8))
    servers = []
    try:
        outs = []
        for side, eng in zip(sides, engines):
            side.ctx.replace_context(None)
            flow, param = _engine_rules(side.pkg)
            eng.flow_rules.load_rules(flow)
            svc = side.service_fn()
            svc.rules.load_rules("default", _server_rules(side.pkg))
            srv = side.server_mod.ClusterTokenServer(
                svc, host="127.0.0.1", port=0).start()
            servers.append(srv)
            eng.cluster.set_to_client("127.0.0.1", srv.bound_port,
                                      request_timeout_s=5.0)
            out = []
            for _ in range(6):
                try:
                    eng.entry(FLOW_RES).exit()
                    out.append("pass")
                except side.pkg.BlockException as ex:
                    out.append(type(ex).__name__)
            out.append((eng.cluster_fallback_count,
                        eng.slots.status()["hot"]))
            outs.append(out)
        assert outs[1] == outs[0]
        assert outs[1][:6] == ["pass"] * 4 + ["FlowException"] * 2
    finally:
        for srv in servers:
            srv.stop()
        for eng in engines:
            eng.close()
        for side in sides:
            side.ctx.replace_context(None)
