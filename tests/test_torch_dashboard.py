"""The port's dashboard (``sentinel_tpu_torch/dashboard/``) held to the JAX
package's on the CPU.

Every case of ``tests/test_dashboard.py`` runs once per package: the same
HTTP requests to each package's ``DashboardServer`` over loopback, which
manages that package's default engine through that package's
``CommandCenter``, and what each observed (status codes, result
envelopes, parsed JSON, verdicts, pages) must be equal. The ports the
servers bound and the wall-clock stamps of heartbeats are left out of the
comparison by name. The reference's own assertions then run on the port's
observations.

Both default engines are built ONCE for the module (capacity 512, the
CPU, both clocks frozen at the same epoch, the lease fast path off so
every entry and exit is one width-1 device step in call order); each
case starts a whole second at least 100 s past the last with no rules,
no gateway rules and no context.

Then: each package's dashboard manages the other package's engine (the
wire between them is the command protocol, nothing else), the V2 rule
publisher through the port's Redis connector and fake server
(``tests/test_redis_datasource.py:187``), the machine registry's purge,
``python -m sentinel_tpu_torch.dashboard``, and the unbounded-queue rule
of ``tests/test_lint.py:516`` over the port's serving paths.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tests.test_torch_support import ops_pkgs, strip_keys, wait_for

NOW0 = 1_700_000_000_000
LEASE_KEY = "csp.sentinel.lease.enabled"
REPO = Path(__file__).resolve().parent.parent

# Machine fields that carry a bound port or a heartbeat's wall stamp.
_EPHEMERAL = ("port", "lastHeartbeat", "tokenPort", "server", "boundPort",
              "serverPort", "lastModified", "rttP50Ms", "rttP99Ms")


@pytest.fixture(autouse=True)
def _loopback_heartbeat(monkeypatch):
    # Command centers bind loopback; register the matching address.
    monkeypatch.setenv("CSP_SENTINEL_HEARTBEAT_CLIENT_IP", "127.0.0.1")


# -- HTTP helpers -------------------------------------------------------------

def raw(dash, path, method="GET", body=b"", headers=None):
    """(status, headers, parsed JSON) of one request to ``dash``."""
    url = f"http://127.0.0.1:{dash.bound_port}{path}"
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as ex:
        return ex.code, dict(ex.headers), json.loads(ex.read().decode())


def get(dash, path):
    code, _, body = raw(dash, path)
    assert code == 200 and body["success"], body
    return body["data"]


def post(dash, path, body=""):
    code, _, out = raw(dash, path, method="POST", body=body.encode())
    assert code == 200 and out["success"], out
    return out["data"]


def page(dash, path="/"):
    with urllib.request.urlopen(f"http://127.0.0.1:{dash.bound_port}{path}",
                                timeout=30) as r:
        return r.headers["Content-Type"], r.read().decode()


def register(P, dash, center):
    """One heartbeat of ``center``'s engine to ``dash``; the app name."""
    assert P.hb.HeartbeatSender(dashboards=[f"127.0.0.1:{dash.bound_port}"],
                                api_port=center.bound_port).send_once()
    return get(dash, "/app/names.json")[0]


# -- the shared pair ----------------------------------------------------------

@pytest.fixture(scope="module")
def twins():
    """Both packages' default engines, built once."""
    pkgs = ops_pkgs()
    saved = [P.config.config.get(LEASE_KEY) for P in pkgs]
    engines = {}
    for P in pkgs:
        P.config.config.set(LEASE_KEY, "false")
        P.tu.freeze_time(NOW0)
        P.ctx.replace_context(None)
        P.ctx.bump_generation()
        engines[P.name] = P.st.reset(capacity=512, **P.kw)
    yield pkgs, engines
    for P, value in zip(pkgs, saved):
        P.ctx.replace_context(None)
        P.tu.unfreeze_time()
        if value is None:
            P.config.config._config.pop(LEASE_KEY, None)
        else:
            P.config.config.set(LEASE_KEY, value)
    # The JAX default engine is left fresh, as tests/conftest.py leaves
    # it; the port's is closed.
    pkgs[0].st.reset(capacity=512)
    engines["port"].close()


def _clean(P, eng):
    for mgr in (eng.flow_rules, eng.degrade_rules, eng.system_rules,
                eng.authority_rules, eng.param_rules):
        mgr.load_rules([])
    P.gw.get_gateway_rule_manager().load_rules([])
    P.gw.get_api_manager().load_api_definitions([])
    P.ctx.replace_context(None)


@pytest.fixture()
def case(twins):
    """A case on the shared engines: no rules and no context, both clocks
    at one whole second at least 100 s past the last case; each package's
    dashboard started fresh (``start(fetch=False)``: the cases drive
    ``fetch_once`` themselves)."""
    pkgs, engines = twins
    target = max(P.tu.current_time_millis() for P in pkgs)
    target = (target // 1000 + 100) * 1000
    dashes = {}
    for P in pkgs:
        _clean(P, engines[P.name])
        P.tu.advance_time(target - P.tu.current_time_millis())
        dashes[P.name] = P.dash.DashboardServer(port=0).start(fetch=False)
    yield pkgs, engines, dashes
    for P in pkgs:
        dashes[P.name].stop()
        _clean(P, engines[P.name])


def both(case, run):
    """``run(P, engine, dashboard)`` for the JAX package, then the port;
    returns (jax_out, port_out)."""
    pkgs, engines, dashes = case
    return tuple(run(P, engines[P.name], dashes[P.name]) for P in pkgs)


def centers(P, eng, n=2):
    return [P.cc.CommandCenter(eng, port=0).start() for _ in range(n)]


def lanes_batch(P, eng, resource, n):
    """``n`` lanes of ``resource`` in context ``ctx`` as this package's
    ``check_batch`` takes them."""
    buf = P.batch.make_entry_batch_np(n)
    reg = eng.registry
    cr, dn, orow, oid = reg.resolve_entry(resource, "ctx", "",
                                          reg.entrance_row("ctx"),
                                          int(P.C.EntryType.OUT))
    buf["cluster_row"][:] = cr
    buf["dn_row"][:] = dn
    buf["origin_row"][:] = orow
    buf["origin_id"][:] = oid
    buf["context_id"][:] = reg.context_id("ctx")
    buf["count"][:] = 1
    return P.batch.EntryBatch(**buf) if P.name == "jax" else buf


# -- tests/test_dashboard.py, case by case -------------------------------------

def test_discovery_from_heartbeats(case):
    def run(P, eng, dash):
        cs = centers(P, eng)
        try:
            app = register(P, dash, cs[0])
            register(P, dash, cs[1])
            apps = get(dash, "/app/names.json")
            machines = get(dash, f"/app/machines.json?app={app}")
            return {"apps": apps, "machines": strip_keys(machines,
                                                         _EPHEMERAL),
                    "ports": ({m["port"] for m in machines}
                              == {c.bound_port for c in cs})}
        finally:
            for c in cs:
                c.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert len(port_out["apps"]) == 1 and port_out["ports"]
    assert all(m["healthy"] for m in port_out["machines"])


def test_rule_crud_pushes_to_all_machines(case):
    def run(P, eng, dash):
        cs = centers(P, eng)
        try:
            app = register(P, dash, cs[0])
            register(P, dash, cs[1])
            before = get(dash, f"/v1/rules?app={app}&type=flow")
            pushed = post(dash, f"/v1/rules?app={app}&type=flow",
                          json.dumps([{"resource": "dashRes", "count": 2.0}]))
            shown = get(dash, f"/v1/rules?app={app}&type=flow")
            passed = sum(1 for _ in range(5) if P.st.entry_ok("dashRes"))
            return {"before": before, "pushed": sorted(pushed.values()),
                    "machines": len(pushed), "shown": shown,
                    "passed": passed}
        finally:
            for c in cs:
                c.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["before"] == []
    assert port_out["pushed"] == [True, True]
    shown = port_out["shown"]
    assert shown[0]["resource"] == "dashRes" and shown[0]["count"] == 2.0
    assert port_out["passed"] == 2


def _write_metric_log(P, eng, base, app, seconds):
    """``seconds`` = entries a second of ``hist``-style traffic on the
    frozen clock, each second sealed into ``base`` by the metric timer."""
    writer = P.writer.MetricWriter(app=app, base_dir=str(base))
    listener = P.timer.MetricTimerListener(eng, writer)
    for res, n in seconds:
        for _ in range(n):
            h = P.st.entry_ok(res)
            if h:
                h.exit()
        P.tu.advance_time(1_000)
        listener.tick(P.tu.current_time_millis())
    writer.close()


def test_metric_fetch_into_repository(case, tmp_path, monkeypatch):
    """engine traffic -> metric log -> /metric -> MetricFetcher ->
    repository -> the dashboard's query endpoints."""
    monkeypatch.setenv("PROJECT_NAME", "dashApp")

    def run(P, eng, dash):
        base = tmp_path / P.name
        monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(base))
        P.st.load_flow_rules([P.st.FlowRule(resource="hot", count=3)])
        for _ in range(5):
            h = P.st.entry_ok("hot")
            if h:
                h.exit()
        P.tu.advance_time(2_000)  # seal the second
        writer = P.writer.MetricWriter(app="dashApp", base_dir=str(base))
        P.timer.MetricTimerListener(eng, writer).tick(
            P.tu.current_time_millis())
        writer.close()
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            app = register(P, dash, center)
            now = P.tu.current_time_millis()
            ingested = dash.fetcher.fetch_once(now_ms=now)
            top = get(dash, f"/metric/queryTopResourceMetric.json?app={app}"
                            f"&startTime={now - 60_000}&endTime={now}")
            series = get(dash, f"/metric/queryByAppAndResource.json?app="
                               f"{app}&identity=hot&startTime="
                               f"{now - 60_000}&endTime={now}")
            return {"app": app, "ingested": ingested, "top": top,
                    "series": series}
        finally:
            center.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["app"] == "dashApp" and port_out["ingested"] >= 1
    pts = port_out["top"]["resource"]["hot"]
    assert pts[0]["passQps"] == 3 and pts[0]["blockQps"] == 2
    assert port_out["series"] and port_out["series"][0]["passQps"] == 3


@pytest.mark.parametrize("scenario", ["aggregates_and_evicts",
                                      "ranked_by_volume",
                                      "deterministic_tie_break",
                                      "eviction_keeps_fresh_seconds"])
def test_repository(scenario):
    """The repository cases (aggregates and evicts, top resources by
    volume, the tie-break, per-second eviction) on both packages'
    ``InMemoryMetricsRepository``, through the same calls."""
    def run(P):
        MN = P.metric_node.MetricNode
        Repo = P.dash.InMemoryMetricsRepository
        if scenario == "aggregates_and_evicts":
            repo = Repo(retention_ms=10_000)
            for _ in range(2):  # one second from two machines aggregates
                repo.save("a", MN(timestamp=1000, resource="r", pass_qps=5,
                                  block_qps=1, rt=10.0))
            out = [repo.query("a", "r", 0, 5000)]
            repo._evict(now_ms=20_000)
            return out + [repo.query("a", "r", 0, 5000)]
        if scenario == "ranked_by_volume":
            repo = Repo()
            repo.save("a", MN(timestamp=1000, resource="low", pass_qps=1))
            repo.save("a", MN(timestamp=1000, resource="high", pass_qps=50))
            return [repo.top_resources("a", 0, 5000)]
        if scenario == "deterministic_tie_break":
            repo = Repo()
            for res in ("zeta", "alpha", "mid"):
                repo.save("a", MN(timestamp=1000, resource=res, pass_qps=7))
            repo.save("a", MN(timestamp=1000, resource="big", pass_qps=9))
            return [repo.top_resources("a", 0, 5000),
                    repo.top_resources("a", 0, 5000, limit=2)]
        repo = Repo(retention_ms=10_000)
        for ts, n in ((4_999, 1), (5_000, 2), (9_000, 3)):
            repo.save("a", MN(timestamp=ts, resource="r", pass_qps=n))
        repo._evict(now_ms=15_000)  # floor = 5_000
        kept = [e["timestamp"] for e in repo.query("a", "r", 0, 2**60)]
        repo.save("a", MN(timestamp=5_500, resource="old", pass_qps=1))
        repo._evict(now_ms=40_000)
        return [kept, repo.resources_of("a"), repo.apps()]

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    if scenario == "aggregates_and_evicts":
        assert port_out[0][0]["passQps"] == 10
        assert port_out[0][0]["rt"] == 10.0  # averaged, not summed
        assert port_out[1] == []
    elif scenario == "ranked_by_volume":
        assert port_out == [["high", "low"]]
    elif scenario == "deterministic_tie_break":
        assert port_out == [["big", "alpha", "mid", "zeta"],
                            ["big", "alpha"]]
    else:
        assert port_out == [[5_000, 9_000], [], []]


def test_dashboard_metrics_endpoint_openmetrics(case):
    from prometheus_client.openmetrics import parser as om_parser

    stamp = int(time.time() * 1000) - 3_000

    def run(P, eng, dash):
        dash.repository.save("appZ", P.metric_node.MetricNode(
            timestamp=stamp, resource="resQ", pass_qps=11, block_qps=4))
        return page(dash, "/metrics")

    (jct, jtext), (pct, ptext) = both(case, run)
    assert (pct, ptext) == (jct, jtext)
    assert "openmetrics-text" in pct
    fams = {f.name: f for f in om_parser.text_string_to_metric_families(ptext)}
    samples = [s for s in
               fams["sentinel_tpu_dashboard_resource_pass_qps"].samples
               if s.labels == {"app": "appZ", "resource": "resQ"}]
    assert samples and samples[0].value == 11


def test_ui_page_served(case):
    """The page (``test_ui_page_served``, ``test_ui_reaches_every_backend_
    endpoint``, ``test_ui_rule_forms_cover_all_families``): both servers
    serve it with the same content type, the same lines of script and
    markup apart from two (a tooltip and a comment), and every endpoint,
    schema and field the reference's cases look for."""
    import difflib

    jax_out, port_out = both(case, lambda P, eng, dash: page(dash, "/"))
    assert port_out[0] == jax_out[0]
    changed = [line for line in difflib.unified_diff(
        jax_out[1].splitlines(), port_out[1].splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert len(changed) == 4, changed  # two lines, each - and +
    ctype, text = port_out
    assert ctype == "text/html; charset=utf-8"
    assert "sentinel-tpu" in text and "queryTopResourceMetric" in text
    for endpoint in (
            "/auth/login", "/app/names.json", "/app/machines.json",
            "/v1/rules", "/v2/rules", "/gateway/rules", "/gateway/apis",
            "/metric/queryTopResourceMetric.json",
            "/metric/queryByAppAndResource.json",
            "/resource/machineResource.json", "/cluster/assign",
            "/cluster/state.json", "/telemetry/summary.json",
            "/telemetry/traces.json", "/telemetry/stream", "/metrics"):
        assert endpoint in text, f"UI does not reference {endpoint}"
    for family in ("flow:", "degrade:", "system:", "authority:",
                   "paramFlow:", "gatewayFlow:", "gatewayApi:"):
        assert family in text, f"no CRUD schema for {family}"
    for field in ("controlBehavior", "slowRatioThreshold",
                  "minRequestAmount", "statIntervalMs", "limitApp",
                  "highestSystemLoad", "highestCpuUsage", "paramIdx",
                  "durationInSec", "burstCount", "warmUpPeriodSec",
                  "maxQueueingTimeMs", "clusterMode", "refResource",
                  "intervalSec", "resourceMode", "paramItem", "apiName",
                  "predicateItems"):
        assert f'"{field}"' in text, f"schema missing field {field}"
    assert "overlaySeries" in text and "machineResource" in text


# -- auth -------------------------------------------------------------------------

def test_auth_disabled_by_default(case):
    def run(P, eng, dash):
        return {"enabled": dash.auth.enabled,
                "names": raw(dash, "/app/names.json")[::2],
                "check": raw(dash, "/auth/check")[::2]}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert not port_out["enabled"]
    assert port_out["names"][0] == 200 and port_out["names"][1]["success"]
    assert port_out["check"][0] == 200
    assert port_out["check"][1]["data"]["authRequired"] is False


def _with_auth(P, **kw):
    return P.dash.DashboardServer(
        port=0, auth=P.dash.AuthService("admin", "s3cret"), **kw).start(
            fetch=False)


def test_auth_gates_api_but_not_heartbeat():
    def run(P):
        d = _with_auth(P)
        try:
            names = raw(d, "/app/names.json")[::2]
            beat = raw(d, "/registry/machine?app=a&ip=127.0.0.1&port=1",
                       method="POST")[::2]
            return {"names": names[0], "beat": beat,
                    "login_overlay": "loginform" in page(d, "/")[1],
                    "metrics": page(d, "/metrics")[0]}
        finally:
            d.stop()

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    assert port_out["names"] == 401
    assert port_out["beat"][0] == 200 and port_out["beat"][1]["success"]
    assert port_out["login_overlay"]


def test_auth_login_session_logout():
    def run(P):
        d = _with_auth(P)
        try:
            out = [raw(d, "/auth/login", method="POST",
                       body=b"username=admin&password=wrong")[::2]]
            code, hdrs, body = raw(d, "/auth/login", method="POST",
                                   body=b"username=admin&password=s3cret")
            out.append((code, body))
            cookie = hdrs["Set-Cookie"].split(";")[0]
            token = cookie.split("=", 1)[1]
            out.append(hdrs["Set-Cookie"].split(";", 1)[1])
            out.append(raw(d, "/app/names.json",
                           headers={"Cookie": cookie})[::2])
            out.append(raw(d, "/app/names.json", headers={
                "Authorization": f"Bearer {token}"})[0])
            out.append(raw(d, "/auth/logout", method="POST",
                           headers={"Cookie": cookie})[::2])
            out.append(raw(d, "/app/names.json",
                           headers={"Cookie": cookie})[0])
            return out
        finally:
            d.stop()

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    assert port_out[0][0] == 401
    assert port_out[1][0] == 200
    assert port_out[1][1]["data"]["username"] == "admin"
    assert port_out[3][0] == 200 and port_out[3][1]["success"]
    assert port_out[4] == 200
    assert port_out[5][0] == 200
    assert port_out[6] == 401


def test_auth_service_credentials_and_expiry():
    """``test_auth_non_ascii_credentials``,
    ``test_auth_blank_password_stays_disabled`` and
    ``test_auth_session_expiry`` on both packages' ``AuthService``."""
    def run(P):
        svc = P.dash.AuthService("admin", "café")
        out = [svc.login("admin", "wrong·guess")]
        token = svc.login("admin", "café")
        out.append(bool(token) and svc.validate(token).username)
        blank = P.dash.AuthService("admin", "")
        out += [blank.enabled, blank.login("admin", "")]
        clock = [0.0]
        svc = P.dash.AuthService("u", "p", ttl_s=100, clock=lambda: clock[0])
        token = svc.login("u", "p")
        for t in (0.0, 99.0, 100.0):
            clock[0] = t
            out.append(svc.validate(token) is not None)
        return out

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    assert port_out == [None, "admin", False, None, True, True, False]


def test_auth_keys_and_cookie_match_the_reference():
    jax, port = ops_pkgs()
    for name in ("AUTH_USERNAME", "AUTH_PASSWORD", "COOKIE_NAME",
                 "DEFAULT_SESSION_TTL_S"):
        assert getattr(port.dash.auth, name) == getattr(jax.dash.auth, name)
    assert port.dash.auth.AUTH_USERNAME == "sentinel.dashboard.auth.username"


# -- cluster assignment, V2 rules, the heartbeat token ---------------------------

def test_cluster_assign_flow(case):
    """Assign: the chosen machine flips to SERVER, the other healthy one
    becomes a CLIENT pointed at the bound token port."""
    def run(P, eng, dash):
        cs = centers(P, eng)
        try:
            app = register(P, dash, cs[0])
            register(P, dash, cs[1])
            out = post(dash, f"/cluster/assign?app={app}&ip=127.0.0.1"
                             f"&port={cs[0].bound_port}&tokenPort=0")
            states = get(dash, f"/cluster/state.json?app={app}")
            return {"server_is_c1":
                        out["server"] == f"127.0.0.1:{cs[0].bound_port}",
                    "token_port_bound": out["tokenPort"] > 0,
                    "clients": sorted(out["clients"].values()),
                    "states": strip_keys(states, _EPHEMERAL)}
        finally:
            eng.cluster.stop()
            for c in cs:
                c.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["server_is_c1"] and port_out["token_port_bound"]
    assert port_out["clients"] == [True]
    states = port_out["states"]
    assert states and all(s["mode"] in (0, 1) for s in states)


def test_v2_rules_through_config_source(case):
    """The dashboard publishes to a config source (a broker key); the
    engine converges through its own push datasource binding."""
    def run(P, eng, dash):
        broker = P.push.InProcessBroker()
        key = "sentinel:rules:appV2:flow"
        src = P.push.BrokerDataSource(broker, key,
                                      converter=P.ds.flow_rules_from_json)
        P.ds.bind(src, P.st.load_flow_rules)
        dash.register_rule_source(
            "appV2", "flow",
            provider=lambda: json.loads(broker.get(key) or "[]"),
            publisher=lambda rules: broker.set(key, json.dumps(rules)))
        try:
            unregistered = raw(dash, "/v2/rules?app=appV2&type=degrade")[::2]
            pushed = post(dash, "/v2/rules?app=appV2&type=flow",
                          json.dumps([{"resource": "v2res", "count": 1.0}]))
            verdicts = [P.st.entry_ok("v2res") is not None for _ in range(2)]
            shown = get(dash, "/v2/rules?app=appV2&type=flow")
            bad = raw(dash, "/v2/rules?app=appV2&type=nope")[::2]
            return {"unregistered": unregistered, "pushed": pushed,
                    "verdicts": verdicts, "shown": shown, "bad": bad}
        finally:
            src.close()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["unregistered"][0] == 502
    assert not port_out["unregistered"][1]["success"]
    assert port_out["pushed"] == "published"
    assert port_out["verdicts"] == [True, False]
    assert port_out["shown"][0]["resource"] == "v2res"
    assert port_out["bad"][0] == 400


def test_heartbeat_token_closes_registration():
    def run(P):
        d = P.dash.DashboardServer(port=0,
                                   heartbeat_token="hb-secret").start(
                                       fetch=False)
        try:
            path = "/registry/machine?app=a&ip=127.0.0.1&port=1"
            refused = raw(d, path, method="POST")[::2]
            accepted = raw(d, path, method="POST", headers={
                "X-Sentinel-Heartbeat-Token": "hb-secret"})[::2]
            return refused, accepted, d.apps.app_names()
        finally:
            d.stop()

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    refused, accepted, names = port_out
    assert refused[0] == 403 and not refused[1]["success"]
    assert accepted[0] == 200 and accepted[1]["success"]
    assert names == ["a"]


def test_heartbeat_sender_carries_token(monkeypatch):
    monkeypatch.setenv("SENTINEL_DASHBOARD_HEARTBEAT_TOKEN", "hb-secret")

    def run(P):
        d = P.dash.DashboardServer(port=0).start(fetch=False)
        try:
            hb = P.hb.HeartbeatSender(dashboards=[f"127.0.0.1:{d.bound_port}"],
                                      api_port=8719)
            return d.heartbeat_token, hb.send_once(), bool(d.apps.app_names())
        finally:
            d.stop()

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out == ("hb-secret", True, True)


def test_metric_history_series_shape(case, tmp_path, monkeypatch):
    """``queryTopResourceMetric.json`` serves a multi-second series in the
    schema the UI's chart reads, timestamps ascending."""
    monkeypatch.setenv("PROJECT_NAME", "histApp")

    def run(P, eng, dash):
        monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(tmp_path / P.name))
        P.st.load_flow_rules([P.st.FlowRule(resource="hist", count=100)])
        _write_metric_log(P, eng, tmp_path / P.name, "histApp",
                          (("hist", 4), ("hist", 1), ("hist", 3)))
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            register(P, dash, center)
            P.tu.advance_time(2_000)  # the newest second clears the lag
            now = P.tu.current_time_millis()
            dash.fetcher.fetch_once(now_ms=now)
            return get(dash, f"/metric/queryTopResourceMetric.json?app="
                             f"histApp&startTime={now - 60_000}"
                             f"&endTime={now}")
        finally:
            center.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    pts = port_out["resource"]["hist"]
    assert len(pts) == 3
    ts = [p["timestamp"] for p in pts]
    assert ts == sorted(ts) and ts[2] - ts[0] == 2_000
    assert [p["passQps"] for p in pts] == [4, 1, 3]
    for p in pts:
        assert set(p) == {"resource", "timestamp", "passQps", "blockQps",
                          "successQps", "exceptionQps", "rt"}


# -- the SSE stream ---------------------------------------------------------------

def read_sse(url, last_event_id=None, timeout=30):
    """One bounded SSE response as [(event, data)]."""
    events = []
    headers = {} if last_event_id is None else {"Last-Event-ID":
                                                last_event_id}
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        event = None
        for line in r:
            line = line.decode("utf-8").rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: ") and event is not None:
                events.append((event, json.loads(line[len("data: "):])))
                event = None
    return events


def test_sse_stream_pushes_flight_recorder_seconds(case):
    def run(P, eng, dash):
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            app = register(P, dash, center)
            P.st.load_flow_rules([P.st.FlowRule(resource="sse", count=2)])
            now = P.tu.current_time_millis()
            base = now - now % 1000 - 3000  # three complete seconds
            for k in range(3):
                eng.check_batch(lanes_batch(P, eng, "sse", 4),
                                now_ms=base + k * 1000)
                eng.traces.drain()
            dash.stream_interval_s = 0.05
            url = (f"http://127.0.0.1:{dash.bound_port}/telemetry/stream"
                   f"?app={app}")
            # The shared engine's ring holds the earlier cases' seconds:
            # resume after the second before ``base`` (a reconnect's
            # ``Last-Event-ID``), where a fresh engine's stream begins.
            resume = f"{base - 1000}:0"
            return {"three": read_sse(url + "&maxEvents=3", resume),
                    "one": read_sse(url + "&maxEvents=1", resume),
                    "base": base}
        finally:
            center.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    events, base = port_out["three"], port_out["base"]
    assert [e for e, _ in events] == ["second"] * 3
    assert [d["timestamp"] for _, d in events] == [base, base + 1000,
                                                   base + 2000]
    for _, d in events:
        assert d["resources"]["sse"]["pass"] == 2
        assert d["resources"]["sse"]["block"] == 2
        assert d["resources"]["sse"]["blockByReason"] == {"FLOW": 2}
    one = port_out["one"]
    assert len(one) == 1 and one[0][0] == "second"


def test_sse_stream_error_frames(case):
    """The first error frame of a stream for an app with no machine, read
    by hand; the consumer gauge decays once the client goes."""
    import socket

    def run(P, eng, dash):
        dash.stream_interval_s = 0.05
        conn = socket.create_connection(("127.0.0.1", dash.bound_port),
                                        timeout=5)
        try:
            conn.sendall(b"GET /telemetry/stream?app=ghost HTTP/1.1\r\n"
                         b"Host: x\r\n\r\n")
            buf = b""
            deadline = time.time() + 5
            while b"event: error" not in buf and time.time() < deadline:
                buf += conn.recv(4096)
            status = buf.split(b"\r\n", 1)[0]
            err = json.loads(buf.split(b"event: error\ndata: ", 1)[1]
                             .split(b"\n", 1)[0].decode())
        finally:
            conn.close()
        return status, err, wait_for(lambda: dash.sse_clients == 0, 3.0)

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    status, err, drained = port_out
    assert b"200" in status and "ghost" in err["error"] and drained


def test_telemetry_routes_fail_structured_when_machine_down(case):
    paths = ("/telemetry/summary.json?app=deadapp",
             "/telemetry/traces.json?app=deadapp",
             "/rollout/status.json?app=deadapp",
             "/v1/rules?app=deadapp&type=flow")

    def run(P, eng, dash):
        post(dash, "/registry/machine?app=deadapp&ip=127.0.0.1&port=1")
        return [raw(dash, p)[::2] for p in paths]

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    for code, body in port_out:
        assert code == 502 and body["success"] is False and body["msg"]


def test_gateway_rules_through_dashboard(case):
    """dashboard -> the machine's gateway commands -> the adapter
    managers, and back."""
    rules = [{"resource": "route-x", "count": 9, "intervalSec": 1,
              "paramItem": {"parseStrategy": 0}}]
    apis = [{"apiName": "orders",
             "predicateItems": [{"pattern": "/orders", "matchStrategy": 1}]}]

    def run(P, eng, dash):
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            app = register(P, dash, center)
            out = {"rules": post(dash, f"/gateway/rules?app={app}",
                                 json.dumps(rules))}
            out["manager"] = P.gw.get_gateway_rule_manager().get_rules()[
                0].resource
            out["got"] = get(dash, f"/gateway/rules?app={app}")
            out["apis"] = post(dash, f"/gateway/apis?app={app}",
                               json.dumps(apis))
            out["got_apis"] = get(dash, f"/gateway/apis?app={app}")
            out["not_a_list"] = raw(dash, f"/gateway/rules?app={app}",
                                    method="POST", body=b"{}")[::2]
            return out
        finally:
            center.stop()

    jax_out, port_out = both(case, run)
    assert {k: v for k, v in port_out.items() if k not in ("rules", "apis")} \
        == {k: v for k, v in jax_out.items() if k not in ("rules", "apis")}
    assert list(port_out["rules"].values()) == list(jax_out["rules"].values())
    assert all(port_out["rules"].values()) and all(port_out["apis"].values())
    assert port_out["manager"] == "route-x"
    got = port_out["got"][0]
    assert got["resource"] == "route-x" and got["count"] == 9
    assert got["paramItem"]["parseStrategy"] == 0
    assert port_out["got_apis"] == apis
    assert port_out["not_a_list"][0] == 400


def test_json_views_proxy_the_control_plane(case):
    """The read-only JSON views (rollout, adaptive, sim, fleet, rebalance,
    waterfall, population, alerts, telemetry, machineResource) and
    ``/rollout/command``: the same codes and envelopes from both
    dashboards over their own engines (each body as far as it holds no
    wall time)."""
    views = ("/rollout/status.json", "/rollout/diff.json", "/adaptive.json",
             "/adaptive.json?op=history", "/adaptive.json?op=nope",
             "/sim.json?op=scenarios", "/fleet.json?op=journal",
             "/fleet.json?op=nope", "/rebalance.json", "/waterfall.json",
             "/population.json?op=nope", "/alerts.json",
             "/telemetry/traces.json?limit=5")

    def run(P, eng, dash):
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            app = register(P, dash, center)
            with P.st.entry("viewRes"):
                pass
            out = {}
            for v in views:
                sep = "&" if "?" in v else "?"
                code, _, body = raw(dash, f"{v}{sep}app={app}")
                out[v] = (code, body["success"], sorted(body["data"])
                          if isinstance(body["data"], dict) else None)
            code, _, body = raw(dash, "/resource/machineResource.json?ip="
                                      f"127.0.0.1&port={center.bound_port}")
            out["machineResource"] = (code, sorted(
                n["resource"] for n in body["data"]))
            out["rollout_get"] = raw(dash, f"/rollout/command?app={app}"
                                           f"&op=abort")[0]
            code, _, body = raw(dash, f"/rollout/command?app={app}&op=abort",
                                method="POST")
            out["rollout_post"] = (code, [
                {k: v.replace(f":{center.bound_port}:", ":<port>:")
                 for k, v in r.items()} for r in body["data"].values()])
            out["unknown"] = raw(dash, "/nope")[::2]
            return out
        finally:
            center.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["/rollout/status.json"][:2] == (200, True)
    assert port_out["/adaptive.json?op=nope"][0] == 400
    assert port_out["rollout_get"] == 405
    assert port_out["unknown"][0] == 404
    assert "viewRes" in port_out["machineResource"][1]


# -- each package's dashboard over the other's engine ----------------------------

@pytest.mark.parametrize("dash_pkg", ["port", "jax"])
def test_dashboard_manages_the_other_packages_engine(case, tmp_path,
                                                     monkeypatch, dash_pkg):
    """One package's dashboard manages the other package's engine through
    that engine's command center: discovery, a V1 push the engine
    enforces, the read-back, the metric fetch, ``machineResource`` and the
    cluster state. The observations equal those of the dashboard of the
    engine's own package."""
    pkgs, engines, dashes = case
    by_name = {P.name: P for P in pkgs}
    monkeypatch.setenv("PROJECT_NAME", "crossApp")

    def run(E, D):
        """E's engine, managed by D's dashboard."""
        eng, dash = engines[E.name], dashes[D.name]
        base = tmp_path / f"{E.name}-{D.name}"
        monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(base))
        _clean(E, eng)
        center = E.cc.CommandCenter(eng, port=0).start()
        try:
            app = register(E, dash, center)
            out = {"machines": strip_keys(get(dash, f"/app/machines.json?"
                                                    f"app={app}"),
                                          _EPHEMERAL)}
            out["pushed"] = list(post(dash, f"/v1/rules?app={app}&type=flow",
                                      json.dumps([{"resource": "x",
                                                   "count": 3.0}])).values())
            out["shown"] = get(dash, f"/v1/rules?app={app}&type=flow")
            _write_metric_log(E, eng, base, "crossApp", (("x", 5), ("x", 2)))
            E.tu.advance_time(2_000)
            now = E.tu.current_time_millis()
            out["ingested"] = dash.fetcher.fetch_once(now_ms=now)
            series = get(dash, f"/metric/queryByAppAndResource.json?"
                               f"app={app}&identity=x&startTime="
                               f"{now - 60_000}&endTime={now}")
            # Stamps relative to the clock: the two runs are 100 s apart.
            out["series"] = [dict(p, timestamp=p["timestamp"] - now)
                             for p in series]
            out["nodes"] = sorted(
                (n["resource"], n["passQps"], n["blockQps"])
                for n in get(dash, "/resource/machineResource.json?ip="
                                   f"127.0.0.1&port={center.bound_port}"))
            out["state"] = strip_keys(get(dash, f"/cluster/state.json?"
                                                f"app={app}"), _EPHEMERAL)
            dash.apps.remove(app, "127.0.0.1", center.bound_port)
            return out
        finally:
            center.stop()
            _clean(E, eng)

    other = "jax" if dash_pkg == "port" else "port"
    E, D = by_name[other], by_name[dash_pkg]
    cross = run(E, D)
    own = run(E, E)
    assert cross == own
    assert cross["pushed"] == [True]
    assert cross["shown"][0]["resource"] == "x"
    assert [p["passQps"] for p in cross["series"]] == [3, 2]
    assert [p["blockQps"] for p in cross["series"]] == [2, 0]


# -- the V2 publisher through Redis ------------------------------------------------

def test_dashboard_v2_publishes_through_redis(case):
    """dashboard publisher -> Redis (SET + PUBLISH over a socket) -> the
    engine's own subscribed datasource -> enforcement, on each package's
    connector and fake server."""
    def run(P, eng, dash):
        R = P.redis
        server = R.MiniRedisServer().start()
        key, chan = "sentinel:rules:appR:flow", "sentinel:rules:appR:flow:chan"
        src = R.RedisDataSource("127.0.0.1", server.port, key, chan,
                                P.ds.flow_rules_from_json).start()
        try:
            P.ds.bind(src, P.st.load_flow_rules)
            writer = R.RedisWritableDataSource(
                "127.0.0.1", server.port, key, chan, P.ds.flow_rules_to_json)
            reader = R.RedisDataSource("127.0.0.1", server.port, key, chan,
                                       P.ds.flow_rules_from_json)
            dash.register_rule_source(
                "appR", "flow",
                provider=lambda: json.loads(
                    (reader.read_source() or b"[]").decode()),
                publisher=lambda rules: writer.write(
                    P.ds.flow_rules_from_json(rules)))
            published = post(dash, "/v2/rules?app=appR&type=flow",
                             json.dumps([{"resource": "viaDash",
                                          "count": 1.0}]))
            converged = wait_for(lambda: [r.resource for r in
                                          eng.flow_rules.get_rules()]
                                 == ["viaDash"], 20.0)
            verdicts = [P.st.entry_ok("viaDash") is not None
                        for _ in range(2)]
            shown = get(dash, "/v2/rules?app=appR&type=flow")
            return published, converged, verdicts, shown
        finally:
            src.close()
            server.stop()

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    published, converged, verdicts, shown = port_out
    assert published == "published" and converged
    assert verdicts == [True, False]
    assert shown[0]["resource"] == "viaDash"


# -- the registry, the module entry point, the lint rule ---------------------------

def test_machine_registry_health_and_purge():
    """``MachineInfo`` health and death on injected clocks, and
    ``purge_dead`` dropping dead machines and emptied apps, on both
    packages."""
    def run(P):
        D = P.dash.discovery
        apps = D.AppManagement()
        for app, port in (("a", 1), ("a", 2), ("b", 3)):
            apps.register(D.MachineInfo(app=app, ip="127.0.0.1", port=port))
        stamp = apps.machines("a")[0].last_heartbeat_ms
        m = apps.machines("a")[0]
        health = [m.healthy(stamp + D.DEFAULT_UNHEALTHY_MS - 1),
                  m.healthy(stamp + D.DEFAULT_UNHEALTHY_MS),
                  m.dead(stamp + D.DEAD_MS), m.dead(stamp + D.DEAD_MS + 1)]
        apps.machines("b")[0].last_heartbeat_ms -= D.DEAD_MS + 5_000
        apps._apps["a"]["127.0.0.1:2"].last_heartbeat_ms -= D.DEAD_MS + 5_000
        listed = [m.key for m in apps.machines("a", include_dead=True)]
        alive = [m.key for m in apps.machines("a")]
        purged = apps.purge_dead()
        removed = apps.remove("a", "127.0.0.1", 1)
        return (health, listed, alive, purged, apps.app_names(), removed,
                apps.app_names(), sorted(m.to_dict()) if m else None)

    jax_out, port_out = (run(P) for P in ops_pkgs())
    assert port_out == jax_out
    assert port_out[:7] == ([True, False, False, True],
                            ["127.0.0.1:1", "127.0.0.1:2"], ["127.0.0.1:1"],
                            2, ["a"], True, ["a"])


def test_module_entry_point_serves_the_page():
    """``python -m sentinel_tpu_torch.dashboard --port 0`` prints its
    address and serves the page there."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentinel_tpu_torch.dashboard", "--port", "0"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("sentinel-tpu dashboard on http://127.0.0.1:")
        url = line.rsplit(" ", 1)[1]
        with urllib.request.urlopen(url, timeout=30) as r:
            assert "sentinel-tpu" in r.read().decode()
        with urllib.request.urlopen(url + "app/names.json", timeout=30) as r:
            assert json.loads(r.read()) == {"success": True, "code": 0,
                                            "msg": None, "data": []}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_no_unbounded_queues_in_the_ports_serving_paths():
    """``tests/test_lint.py:516``'s rule over the port: no unbounded
    ``queue.Queue()`` in its token server, command plane, Envoy RLS or
    dashboard."""
    import re

    from tests.test_lint import _code_lines

    pattern = re.compile(r"queue\.Queue\(\s*\)")
    offenders, seen = [], 0
    for sub in ("cluster", "transport", "envoy_rls", "dashboard"):
        for path in sorted((REPO / "sentinel_tpu_torch" / sub).rglob("*.py")):
            seen += 1
            for lineno, code in _code_lines(path):
                if pattern.search(code):
                    offenders.append(f"{path.relative_to(REPO)}:{lineno}")
    assert seen >= 20
    assert not offenders, (
        "unbounded queue.Queue() in a serving path (pass maxsize= and "
        "shed on full): " + ", ".join(offenders))


def test_dashboard_imports_nothing_of_jax():
    """The port's dashboard modules and ``native.py`` import neither
    ``jax`` nor the JAX package: none of their imports, the lazy ones
    inside functions included, names either, and importing them in a
    fresh interpreter loads neither."""
    import ast

    root = REPO / "sentinel_tpu_torch"
    mods = set()
    for path in sorted((root / "dashboard").glob("*.py")) + [
            root / "native.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
    assert "sentinel_tpu_torch.telemetry.exporter" in mods
    assert "sentinel_tpu_torch.cluster.token_service" in mods
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                        "sentinel_tpu"))
    assert not bad, bad
    code = ("import sys, sentinel_tpu_torch.dashboard, "
            "sentinel_tpu_torch.dashboard.__main__, sentinel_tpu_torch.native;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'sentinel_tpu' or "
            "m.startswith('sentinel_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
