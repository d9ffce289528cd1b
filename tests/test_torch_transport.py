"""The port's ops plane (``sentinel_tpu_torch/transport/``, ``st.init_ops_plane``)
held to the JAX package's on the CPU.

Every case of ``tests/test_transport.py`` runs once per package: the same
HTTP requests to each package's ``CommandCenter`` (or ``AsyncCommandCenter``)
over loopback, on that package's default engine, and what each observed
(status codes, bodies, parsed JSON, verdicts) must be equal. Ports that
the two servers bound, wall-clock stamps and the embedded token server's
RTT percentiles are left out of the comparison by name. The reference's own
assertions then run on the port's observations.

Both default engines are built ONCE for the module (capacity 512, the
CPU, both clocks frozen at the same epoch, the lease fast path off so
every entry and exit is one width-1 device step in call order); each
case starts a whole second at least 100 s past the last with no rules,
no gateway rules and the switch on. Each package's center is started
once for the module; cases that need a center of their own start one.

The rest: every command the port registers answers once (the status
code equal to the JAX package's), the ops plane's lifecycle
(idempotent start, following ``st.reset``, the heartbeat reaching a
dashboard stub, shutdown leaving no thread), the writable-datasource
round trip of ``setRules`` and the config readers.
"""

from __future__ import annotations

import asyncio
import gc
import http.client
import json
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
import weakref
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from tests.test_torch_support import ops_pkgs, strip_keys, wait_for

NOW0 = 1_700_000_000_000
LEASE_KEY = "csp.sentinel.lease.enabled"


# -- HTTP helpers -------------------------------------------------------------

def _url(center, path):
    return f"http://127.0.0.1:{center.bound_port}/{path}"


def _open(req):
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def get(center, path):
    """(status, body) of ``GET /path``; an HTTP error is a status too."""
    return _open(_url(center, path))


def post(center, path, body: str):
    return _open(urllib.request.Request(_url(center, path),
                                        data=body.encode(), method="POST"))


def form(obj) -> str:
    return f"data={urllib.parse.quote(json.dumps(obj))}"


# -- the shared pair ----------------------------------------------------------

@pytest.fixture(scope="module")
def twins():
    """Both packages' default engines and one center each, built once."""
    pkgs = ops_pkgs()
    saved = [P.config.config.get(LEASE_KEY) for P in pkgs]
    engines, centers = {}, {}
    for P in pkgs:
        P.config.config.set(LEASE_KEY, "false")
        P.tu.freeze_time(NOW0)
        P.ctx.replace_context(None)
        P.ctx.bump_generation()
        engines[P.name] = P.st.reset(capacity=512, **P.kw)
        centers[P.name] = P.cc.CommandCenter(engines[P.name], port=0).start()
    yield pkgs, engines, centers
    for P, value in zip(pkgs, saved):
        centers[P.name].stop()
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
    rm, am = P.gw.managers_for(eng)
    rm.load_rules([])
    am.load_api_definitions([])
    eng.enabled = True
    P.ctx.replace_context(None)


@pytest.fixture()
def case(twins):
    """A case on the shared engines: no rules, no context, the switch on,
    both clocks a whole second at least 100 s past the last case."""
    pkgs, engines, centers = twins
    for P in pkgs:
        _clean(P, engines[P.name])
        now = P.tu.current_time_millis()
        P.tu.advance_time((now // 1000 + 100) * 1000 - now)
    yield twins
    for P in pkgs:
        _clean(P, engines[P.name])


def both(twins, run):
    """``run(P, engine, center)`` for the JAX package, then the port;
    returns (jax_out, port_out)."""
    pkgs, engines, centers = twins
    return tuple(run(P, engines[P.name], centers[P.name]) for P in pkgs)


# -- tests/test_transport.py, case by case -------------------------------------

def test_version_and_basic_info(case):
    def run(P, eng, c):
        version = get(c, "version")
        status, body = get(c, "basicInfo")
        info = json.loads(body)
        return {"version": version, "basicInfo": (status, strip_keys(info)),
                "port_is_bound_port": info["port"] == c.bound_port}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    status, body = port_out["version"]
    assert status == 200 and body.startswith("sentinel-tpu/")
    assert port_out["basicInfo"][1]["pid"] > 0
    assert port_out["port_is_bound_port"]


def test_unknown_command_is_400(case):
    jax_out, port_out = both(case, lambda P, e, c: get(c, "noSuchCommand"))
    assert port_out == jax_out
    assert port_out[0] == 400


def test_get_set_rules_round_trip(case):
    rules = [{"resource": "api", "count": 7.0, "grade": 1}]

    def run(P, eng, c):
        pushed = post(c, "setRules?type=flow", form(rules))
        # The engine now enforces the pushed rule.
        passed = sum(1 for _ in range(10) if P.st.entry_ok("api"))
        status, body = get(c, "getRules?type=flow")
        return {"pushed": pushed, "passed": passed,
                "rules": (status, json.loads(body))}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["pushed"] == (200, "success")
    assert port_out["passed"] == 7
    got = port_out["rules"][1]
    assert got[0]["resource"] == "api" and got[0]["count"] == 7.0


def test_set_rules_every_family(case):
    payloads = {
        "degrade": [{"resource": "d", "grade": 2, "count": 1,
                     "timeWindow": 5}],
        "system": [{"qps": 1000}],
        "authority": [{"resource": "a", "limitApp": "x", "strategy": 0}],
        "paramFlow": [{"resource": "p", "paramIdx": 0, "count": 3}],
    }

    def run(P, eng, c):
        out = {}
        for rule_type, rules in payloads.items():
            pushed = post(c, f"setRules?type={rule_type}", form(rules))
            status, body = get(c, f"getRules?type={rule_type}")
            out[rule_type] = (pushed, status, json.loads(body))
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    for rule_type, (pushed, status, got) in port_out.items():
        assert pushed == (200, "success"), rule_type
        assert status == 200 and len(got) == 1, rule_type


def test_cnode_and_cluster_node(case):
    def run(P, eng, c):
        with P.st.entry("res1"):
            pass
        eng._flush_committer()
        status, body = get(c, "cnode?id=res1")
        _, nodes = get(c, "clusterNode")
        return {"cnode": (status, json.loads(body)),
                "clusterNode": json.loads(nodes)}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    node = port_out["cnode"][1]
    assert node["resource"] == "res1" and node["passQps"] == 1
    assert any(n["resource"] == "res1" for n in port_out["clusterNode"])


def test_tree_commands(case):
    def run(P, eng, c):
        P.st.context_enter("ctxA")
        with P.st.entry("deep"):
            pass
        P.st.exit_context()
        eng._flush_committer()
        _, tree = get(c, "jsonTree")
        return {"jsonTree": json.loads(tree), "tree": get(c, "tree")}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    tree = port_out["jsonTree"]
    assert tree["resource"] == "machine-root"
    flat = json.dumps(tree)
    assert "ctxA" in flat and "deep" in flat
    assert "deep(" in port_out["tree"][1]


def test_switch_round_trip(case):
    def run(P, eng, c):
        P.st.load_flow_rules([P.flow.FlowRule(resource="sw", count=0)])
        out = [P.st.entry_ok("sw") is None]
        out.append(get(c, "setSwitch?value=false"))
        # Switch off: everything passes unguarded.
        out.append(P.st.entry_ok("sw") is not None)
        out.append(get(c, "setSwitch?value=true"))
        out.append(P.st.entry_ok("sw") is None)
        out.append(get(c, "getSwitch"))
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out[0] and port_out[2] and port_out[4]
    assert port_out[1] == (200, "success")
    assert "true" in port_out[5][1]


def test_api_lists_commands(case):
    jax_out, port_out = both(case, lambda P, e, c: json.loads(
        get(c, "api")[1]))
    assert port_out == jax_out
    urls = {e["url"] for e in port_out}
    assert {"/version", "/getRules", "/setRules", "/metric", "/jsonTree",
            "/cnode", "/clusterNode"} <= urls


def test_metric_command_reads_log(case, tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_NAME", "transportApp")

    def run(P, eng, c):
        base = tmp_path / P.name
        monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(base))
        with P.st.entry("m1"):
            pass
        P.tu.advance_time(2000)
        timer = P.timer.MetricTimerListener(
            eng, P.writer.MetricWriter(app="transportApp",
                                       base_dir=str(base)))
        written = timer.tick(P.tu.current_time_millis())
        timer.writer.close()
        return {"written": written,
                "metric": get(c, "metric?startTime=0&identity=m1")}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["written"] >= 1
    status, body = port_out["metric"]
    assert status == 200 and "|m1|" in body


# -- heartbeat ------------------------------------------------------------------

class _DashboardStub(BaseHTTPRequestHandler):
    received = []

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length).decode()
        _DashboardStub.received.append(
            (self.path, urllib.parse.parse_qs(body),
             self.headers.get("X-Sentinel-Heartbeat-Token")))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")


@pytest.fixture()
def dashboard_stub():
    _DashboardStub.received.clear()
    server = HTTPServer(("127.0.0.1", 0), _DashboardStub)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    t.join(timeout=5)


def test_heartbeat_posts_registry_machine(dashboard_stub):
    outs = []
    for P in ops_pkgs():
        _DashboardStub.received.clear()
        hb = P.hb.HeartbeatSender(dashboards=[dashboard_stub], api_port=8719)
        sent = hb.send_once()
        path, params, token = _DashboardStub.received[0]
        # ``version`` is this POST's wall-clock stamp.
        outs.append({"sent": sent, "path": path, "token": token,
                     "params": strip_keys(params, ("version",)),
                     "stamp_is_ms": params["version"][0].isdigit()})
    jax_out, port_out = outs
    assert port_out == jax_out
    assert port_out["sent"] and port_out["stamp_is_ms"]
    assert port_out["path"] == "/registry/machine"
    params = port_out["params"]
    assert params["port"] == ["8719"]
    assert "app" in params and "ip" in params


def test_heartbeat_rotates_on_failure():
    outs = []
    for P in ops_pkgs():
        hb = P.hb.HeartbeatSender(dashboards=["127.0.0.1:1", "127.0.0.1:2"],
                                  api_port=1)
        outs.append((hb.send_once(), hb._idx))
    assert outs[1] == outs[0]
    assert outs[1] == (False, 1)  # rotated to the second dashboard


# -- cluster-mode ops commands ----------------------------------------------------

# Fields of getClusterMode / fetchConfig that carry a bound port, the
# wall-clock stamp of the last mode change or the wire frontend's
# measured RTT.
_EPHEMERAL = ("port", "boundPort", "serverPort", "lastModified", "rttP50Ms",
              "rttP99Ms")


def test_cluster_mode_flip_via_http(case):
    """Stage server config, flip to SERVER, load cluster rules, read
    metrics; acquire real tokens from the embedded server; flip back."""
    rules = [{"resource": "cr", "count": 2.0, "clusterMode": True,
              "clusterConfig": {"flowId": 77, "thresholdType": 1}}]

    def run(P, eng, c):
        out = {"mode0": json.loads(get(c, "getClusterMode")[1])}
        out["stage"] = post(c, "cluster/server/modifyTransportConfig?port=0",
                            "")
        out["flip"] = post(c, "setClusterMode?mode=1", "")
        out["mode1"] = json.loads(get(c, "getClusterMode")[1])
        cfg = json.loads(get(c, "cluster/server/fetchConfig")[1])
        port = cfg["boundPort"]
        out["fetch"] = cfg
        out["rules"] = post(c, "cluster/server/modifyFlowRules?namespace="
                               "default", form(rules))
        out["client_cfg"] = post(
            c, "cluster/client/modifyConfig",
            json.dumps({"serverHost": "127.0.0.1", "serverPort": port}))
        client = P.client.ClusterTokenClient("127.0.0.1", port, "default",
                                             request_timeout_s=60.0).start()
        try:
            out["tokens"] = [int(client.request_token(77, 1).status)
                             for _ in range(3)]
        finally:
            client.stop()
        out["metrics"] = json.loads(get(c, "cluster/server/metrics")[1])
        out["down"] = post(c, "setClusterMode?mode=-1", "")
        out["mode2"] = json.loads(get(c, "getClusterMode")[1])
        out["port_bound"] = port > 0
        return strip_keys(out, _EPHEMERAL)

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    TS = ops_pkgs()[1].CC.TokenResultStatus
    assert port_out["mode0"]["mode"] == -1  # NOT_STARTED
    assert port_out["stage"][1] == "success"
    assert port_out["flip"] == (200, "success")
    assert port_out["mode1"]["mode"] == 1 and port_out["mode1"][
        "serverRunning"]
    assert port_out["port_bound"]
    assert port_out["rules"][1] == "success"
    assert port_out["client_cfg"][1] == "success"
    assert port_out["tokens"] == [TS.OK, TS.OK, TS.BLOCKED]
    row = {m["flowId"]: m for m in port_out["metrics"]}[77]
    assert row["pass"] == 2.0 and row["blockRequest"] == 1.0
    assert port_out["down"][1] == "success"
    assert port_out["mode2"]["mode"] == -1


def test_cluster_client_mode_via_http_against_external_server(case):
    """setClusterMode=0 connects the engine's token client to the staged
    server address (fetchConfig shows it; getClusterMode clientAvailable)."""
    def run(P, eng, c):
        ext = P.server.ClusterTokenServer(
            P.ts.DefaultTokenService(P.cluster_rules.ClusterFlowRuleManager(),
                                     **P.kw),
            host="127.0.0.1", port=0).start()
        try:
            post(c, "cluster/client/modifyConfig",
                 json.dumps({"serverHost": "127.0.0.1",
                             "serverPort": ext.bound_port}))
            out = {"flip": post(c, "setClusterMode?mode=0", "")}
            cfg = json.loads(get(c, "cluster/client/fetchConfig")[1])
            out["cfg_port_is_ext"] = cfg["serverPort"] == ext.bound_port
            out["cfg"] = cfg
            # the PING handshake is asynchronous
            out["available"] = wait_for(lambda: json.loads(
                get(c, "getClusterMode")[1])["clientAvailable"], 5.0)
            out["down"] = post(c, "setClusterMode?mode=-1", "")
        finally:
            ext.stop()
        return strip_keys(out, _EPHEMERAL)

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["flip"][1] == "success"
    assert port_out["cfg_port_is_ext"] and port_out["available"]


def test_cluster_rules_survive_server_reapply(case):
    """Rules staged before the flip are served after it, and a config
    re-apply (setClusterMode=1 again) does NOT discard loaded rules."""
    rules = [{"resource": "keep", "count": 9.0, "clusterMode": True,
              "clusterConfig": {"flowId": 5150, "thresholdType": 1}}]

    def run(P, eng, c):
        out = {"staged": post(c, "cluster/server/modifyFlowRules?namespace="
                                 "default", form(rules))}
        post(c, "cluster/server/modifyTransportConfig?port=0", "")
        post(c, "setClusterMode?mode=1", "")
        out["ns1"] = json.loads(get(c, "cluster/server/fetchConfig")[1])[
            "namespaces"]
        post(c, "cluster/server/modifyTransportConfig?maxAllowedQps=123", "")
        post(c, "setClusterMode?mode=1", "")
        cfg = json.loads(get(c, "cluster/server/fetchConfig")[1])
        out["ns2"] = cfg["namespaces"]
        out["cfg"] = strip_keys(cfg, _EPHEMERAL)
        out["flows"] = sorted(m["flowId"] for m in json.loads(
            get(c, "cluster/server/metrics")[1]))
        post(c, "setClusterMode?mode=-1", "")
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["staged"][1] == "success"
    assert port_out["ns1"] == ["default"] and port_out["ns2"] == ["default"]
    assert port_out["flows"] == [5150]


def test_cluster_client_modify_rejects_bad_port(case):
    """A malformed serverPort fails cleanly WITHOUT poisoning the staged
    config."""
    def run(P, eng, c):
        post(c, "cluster/client/modifyConfig",
             json.dumps({"serverHost": "127.0.0.1", "serverPort": 12345}))
        bad = post(c, "cluster/client/modifyConfig",
                   json.dumps({"serverPort": "abc"}))
        cfg = json.loads(get(c, "cluster/client/fetchConfig")[1])
        return {"bad": bad, "cfg": cfg}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["bad"][0] == 400
    assert port_out["cfg"]["serverPort"] == 12345  # staged value intact


# -- the event-loop transport ------------------------------------------------------

class TestAsyncCommandCenter:
    """Event-loop transport twin (netty-http analog): same command SPI,
    same responses, keep-alive connections."""

    def test_same_commands_as_threaded_center(self, case):
        def run(P, eng, c):
            P.st.load_flow_rules([P.flow.FlowRule(resource="aioRes",
                                                  count=7)])
            ac = P.aio.AsyncCommandCenter(eng, port=0).start()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", ac.bound_port,
                                                  timeout=10)
                # keep-alive: three commands over ONE connection
                conn.request("GET", "/version")
                version = conn.getresponse().read().decode()
                conn.request("GET", "/getRules?type=flow")
                rules = json.loads(conn.getresponse().read().decode())
                conn.request("POST", "/setRules", body=json.dumps(
                    {"type": "flow",
                     "data": json.dumps([{"resource": "aioRes",
                                          "count": 1}])}))
                resp = conn.getresponse()
                set_rules = (resp.status, resp.read().decode())
                conn.close()
                # unknown command -> 400, same as the threaded transport
                conn2 = http.client.HTTPConnection("127.0.0.1",
                                                   ac.bound_port, timeout=10)
                conn2.request("GET", "/nope")
                unknown = conn2.getresponse().status
                conn2.close()
            finally:
                ac.stop()
            return {"version": version, "rules": rules,
                    "setRules": set_rules, "unknown": unknown,
                    "threaded_version": get(c, "version")[1]}

        jax_out, port_out = both(case, run)
        assert port_out == jax_out
        assert "sentinel" in port_out["version"].lower()
        assert port_out["version"] == port_out["threaded_version"]
        assert port_out["rules"][0]["resource"] == "aioRes"
        assert port_out["setRules"][0] in (200, 400)
        assert port_out["unknown"] == 400

    def test_start_async_on_callers_loop(self, case):
        def run(P, eng, c):
            async def go():
                ac = await P.aio.AsyncCommandCenter(eng, port=0).start_async()
                port = ac.bound_port
                out = await asyncio.to_thread(
                    lambda: urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/clusterNode", timeout=10
                    ).read().decode())
                await ac.stop_async()
                return out

            return {"async": json.loads(asyncio.run(go())),
                    "threaded": json.loads(get(c, "clusterNode")[1])}

        jax_out, port_out = both(case, run)
        assert port_out == jax_out
        assert port_out["async"] == port_out["threaded"]

    def test_bad_content_length_gets_400(self, case):
        def run(P, eng, c):
            ac = P.aio.AsyncCommandCenter(eng, port=0).start()
            try:
                s = socket.create_connection(("127.0.0.1", ac.bound_port),
                                             timeout=10)
                s.sendall(b"GET /version HTTP/1.1\r\ncontent-length: abc"
                          b"\r\n\r\n")
                head = s.recv(4096).split(b"\r\n", 1)[0]
                s.close()
            finally:
                ac.stop()
            return head

        jax_out, port_out = both(case, run)
        assert port_out == jax_out
        assert b"400" in port_out


# -- gateway commands --------------------------------------------------------------

def test_gateway_rules_and_api_definitions_commands(case):
    """gateway/* commands: wholesale update + fetch of gateway rules and
    custom API groups, with the rules ENFORCED through the param
    machinery."""
    rules = [{"resource": "route-a", "count": 2, "intervalSec": 1}]
    apis = [{"apiName": "user-api",
             "predicateItems": [{"pattern": "/users/", "matchStrategy": 1}]}]

    def run(P, eng, c):
        out = {"update": post(c, "gateway/updateRules", form(rules))}
        out["rules"] = json.loads(get(c, "gateway/getRules")[1])
        out["updateApis"] = post(c, "gateway/updateApiDefinitions",
                                 form(apis))
        out["apis"] = json.loads(get(c, "gateway/getApiDefinitions")[1])
        req = P.gw.GatewayRequest(path="/x", route="route-a",
                                  client_ip="1.2.3.4")
        passed = 0
        for _ in range(4):
            try:
                entries = P.gw.gateway_entry(req)
                passed += 1
                for e in reversed(entries):
                    e.exit()
            except P.st.BlockException:
                pass
        out["passed"] = passed
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["update"] == (200, "success")
    got = port_out["rules"]
    assert got[0]["resource"] == "route-a" and got[0]["count"] == 2
    assert port_out["updateApis"] == (200, "success")
    assert port_out["apis"] == apis
    assert port_out["passed"] == 2  # 2 QPS on route-a


def test_gateway_bad_payload_rejected(case):
    jax_out, port_out = both(case, lambda P, e, c: post(
        c, "gateway/updateRules", "data=%7Bnot-json"))
    assert port_out == jax_out
    assert port_out[0] == 400 and "parse error" in port_out[1]


def test_gateway_commands_scope_to_their_engine(case):
    """A center bound to a NON-default engine loads gateway rules into
    that engine, not into the default one."""
    def run(P, eng, c):
        other = P.st.SentinelEngine(capacity=256, **P.kw)
        c2 = P.cc.CommandCenter(other, port=0).start()
        try:
            out = {"update": post(c2, "gateway/updateRules",
                                  form([{"resource": "route-b",
                                         "count": 1}]))}
            out["own"] = json.loads(get(c2, "gateway/getRules")[1])
            out["default"] = json.loads(get(c, "gateway/getRules")[1])
            out["singleton"] = P.gw.get_gateway_rule_manager().get_rules()
            out["other_param"] = bool(other.param_rules._gateway_rules)
            out["default_param"] = bool(eng.param_rules._gateway_rules)
        finally:
            c2.stop()
            other.close()
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["update"][1] == "success"
    assert port_out["own"][0]["resource"] == "route-b"
    assert port_out["default"] == [] and port_out["singleton"] == []
    assert port_out["other_param"] and not port_out["default_param"]


def test_gateway_manager_pair_released_with_engine(case):
    """The per-engine manager memo does not pin dead engines."""
    def run(P, eng, c):
        other = P.st.SentinelEngine(capacity=256, **P.kw)
        c2 = P.cc.CommandCenter(other, port=0).start()
        try:
            get(c2, "gateway/getRules")  # first touch memoizes the pair
            memoized = any(k is other for k in P.gw._engine_managers.keys())
        finally:
            c2.stop()
            other.close()
        ref = weakref.ref(other)
        del other, c2  # the center itself holds the engine strongly
        gc.collect()
        return {"memoized": memoized, "released": ref() is None}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out == {"memoized": True, "released": True}


# -- command cases of other reference files -----------------------------------------

def test_resilience_command_surfaces_stats(case):
    """``test_chaos.py:302``: the fail-open and fallback counters and the
    entry budget through ``GET /resilience``."""
    def run(P, eng, c):
        before = json.loads(get(c, "resilience")[1])
        eng._note_fail_open("test")
        eng._note_cluster_fallback()
        body = json.loads(get(c, "resilience")[1])
        return {"delta": (body["failOpenCount"] - before["failOpenCount"],
                          body["clusterFallbackCount"]
                          - before["clusterFallbackCount"]),
                "budget_is_engine's": body["clusterEntryBudgetMs"]
                == eng.cluster_entry_budget_ms,
                "body": strip_keys(body, ("probes",)),
                "has": sorted(k for k in ("probes", "tokenClientBreaker")
                              if k in body)}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["delta"] == (1, 1)
    assert port_out["budget_is_engine's"]
    assert port_out["has"] == ["probes", "tokenClientBreaker"]


def test_rebalance_command_surface(case):
    """``test_rebalance.py:472``: status, freeze and unfreeze round trip;
    an unknown op fails."""
    def run(P, eng, c):
        status = json.loads(get(c, "rebalance?op=status")[1])
        return {"status": status,
                "freeze": json.loads(get(c, "rebalance?op=freeze")[1]),
                "unfreeze": json.loads(get(c, "rebalance?op=unfreeze")[1]),
                "bad": get(c, "rebalance?op=nope")}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert "counters" in port_out["status"] and "frozen" in port_out[
        "status"]
    assert port_out["freeze"]["frozen"] is True
    assert port_out["unfreeze"]["frozen"] is False
    assert port_out["bad"][0] == 400


def test_rollout_ops_command(case):
    """``test_rollout.py:395``: load, status, stage, diff, tick, abort,
    a second load and promote through ``/rollout``."""
    def run(P, eng, c):
        def op(query, body=None):
            status, text = (post(c, f"rollout?{query}", body)
                            if body is not None
                            else get(c, f"rollout?{query}"))
            return status, json.loads(text) if status == 200 else text

        out = {"load": op("op=load&name=v5",
                          '{"flow": [{"resource": "resO", "count": 1}]}')}
        out["status"] = op("op=status")
        out["stage"] = op("op=stage&stage=canary&canaryBps=2500")
        with P.st.entry("resO"):
            pass
        eng._flush_committer()
        out["diff"] = op("op=diff")
        out["tick"] = op("op=tick")
        out["abort"] = op("op=abort&reason=test%20over")
        out["load2"] = op("op=load&name=v6",
                          '{"flow": [{"resource": "resO", "count": 2}]}')
        out["promote"] = op("op=promote&name=v6")
        out["bad"] = op("op=nope")
        return out

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["load"] == (200, {"loaded": "v5", "stage": "shadow",
                                      "families": {"flow": 1}})
    st_ = port_out["status"][1]
    assert st_["active"] == "v5" and st_["stage"] == "shadow"
    assert port_out["stage"] == (200, {"name": "v5", "stage": "canary",
                                       "canaryBps": 2500})
    assert "resO" in port_out["diff"][1]["resources"]
    assert port_out["tick"][1]["active"] == "v5"
    assert port_out["abort"] == (200, {"aborted": "v5",
                                       "reason": "test over"})
    assert port_out["promote"][1]["promoted"] == "v6"
    assert port_out["bad"][0] == 400


def test_flightrec_and_sim_commands(case, tmp_path):
    """``test_simulator.py:403``: a tee started before traffic, the
    exported trace's split, stop landing the last second through the
    still-attached tee; the ``sim`` catalog, its drill cap and an 8 s
    drill replay on the engine's device."""
    def run(P, eng, c):
        eng.flow_rules.load_rules([P.flow.FlowRule(resource="cmdres",
                                                   count=10)])
        row = eng.registry.cluster_row("cmdres")

        def drive(n):
            buf = P.batch.make_entry_batch_np(64)
            buf["cluster_row"][:n] = row
            buf["count"][:n] = 1
            batch = P.batch.EntryBatch(**buf) if P.name == "jax" else buf
            eng.check_batch(batch, now_ms=P.tu.current_time_millis())

        def op(query):
            status, text = get(c, f"flightrec?{query}")
            return status, json.loads(text) if status == 200 else text

        # Land the seconds earlier cases left staged, so the tee sees
        # this case's seconds only (the reference's engine is fresh).
        eng.slo_refresh()
        since = P.tu.current_time_millis()
        out = {"status": op("op=status")}
        path = tmp_path / f"{P.name}.trace.jsonl"
        out["tee"] = op(f"op=tee&path={urllib.parse.quote(str(path))}")
        drive(25)
        P.tu.advance_time(1000)
        drive(6)
        P.tu.advance_time(1000)
        eng.slo_refresh()
        status, exported = op(f"op=export&startMs={since}")
        out["export"] = (status, [
            {k: v for k, v in sec.items() if k in ("d", "t")}
            for sec in exported["seconds"]], exported["resources"])
        before = op("op=status")[1]["tee"]["secondsWritten"]
        drive(7)
        P.tu.advance_time(1000)
        out["stop"] = op("op=stop")
        out["stop_wrote_one"] = out["stop"][1]["secondsWritten"] == \
            before + 1
        out["stop_again"] = op("op=stop")
        teed = [json.loads(line) for line in path.read_text().splitlines()]
        out["teed"] = [line.get("d") for line in teed[1:]]
        status, text = get(c, "sim?op=scenarios")
        out["scenarios"] = (status, json.loads(text))
        out["cap"] = get(c, "sim?op=run&scenario=diurnal&seconds=999999")
        return strip_keys(out, ("path",))

    jax_out, port_out = both(case, run)
    # The drill replay on the port alone (test_torch_simulator.py holds
    # the port's replays to the JAX package's): on the engine's device.
    status, text = get(case[2]["port"],
                       "sim?op=run&scenario=diurnal&seconds=8&seed=2")
    drill = json.loads(text) if status == 200 else text
    assert port_out == jax_out
    assert port_out["status"][1]["tee"] is None
    assert port_out["tee"][0] == 200
    status, seconds, resources = port_out["export"]
    assert status == 200 and resources == ["cmdres"]
    # 25 offered against a limit of 10: the exported second's split
    assert seconds[0]["d"]["cmdres"] == [[1, 25]]
    assert port_out["stop"][0] == 200 and port_out["stop_wrote_one"]
    assert port_out["stop_again"][0] == 400  # no tee active any more
    assert port_out["teed"][0]["cmdres"] == [[1, 25]]
    assert port_out["teed"][-1]["cmdres"] == [[1, 7]]
    assert "flash_crowd" in port_out["scenarios"][1]["scenarios"]
    assert port_out["cap"][0] == 400 and "drill cap" in port_out["cap"][1]
    assert status == 200, drill
    assert drill["seconds"] == 8 and drill["offered"] > 0
    assert drill["scenario"] == "diurnal"


# -- beyond tests/test_transport.py ------------------------------------------------

# Parameters that make each command do its work on an engine with no
# cluster role, slot table, trace or token server. A command not listed
# runs bare. Ones that still fail say so by name (400 and a reason).
WALK_PARAMS = {
    "cnode": "id=walk", "explain": "resource=walk",
    "getRules": "type=flow", "setRules": "type=flow&data=%5B%5D",
    "setSwitch": "value=true", "setClusterMode": "mode=-1",
    "why": "resource=walk", "timeseries": "limit=5",
    "metric": "startTime=0", "traces": "drain=true&limit=5",
    "rollout": "op=status", "adaptive": "op=status",
    "fleet": "op=status", "sim": "op=scenarios",
}
WALK_EXPECTED_FAILURES = {
    "cluster/server/metrics": "token server not running",
    "explain": "no matching trace sampled yet",
    "slots": "engine is not in slot mode (csp.sentinel.slots.budget=0)",
}


def test_every_registered_command_answers(case, tmp_path, monkeypatch):
    """Each command ``api`` lists runs once on the port (so its lazy
    imports resolve inside the port) and answers with the JAX package's
    status code; none raises (500)."""
    monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(tmp_path))

    def run(P, eng, c):
        with P.st.entry("walk"):
            pass
        eng._flush_committer()
        P.tu.advance_time(1500)
        names = [e["url"][1:] for e in json.loads(get(c, "api")[1])]
        out = {}
        for name in names:
            q = WALK_PARAMS.get(name)
            out[name] = get(c, f"{name}?{q}" if q else name)
        return out

    jax_out, port_out = both(case, run)
    assert sorted(port_out) == sorted(jax_out)
    assert len(port_out) >= 43
    for name, (status, body) in port_out.items():
        assert status == jax_out[name][0], (name, body, jax_out[name])
        assert status != 500, (name, body)
        if name in WALK_EXPECTED_FAILURES:
            assert (status, body) == (400, WALK_EXPECTED_FAILURES[name])
        else:
            assert status == 200, (name, body)
    # Bodies with no timing or process identity in them are equal too,
    # apart from the ports and addresses earlier cases bound (the journal
    # records each mode change's target).
    for name in ("version", "getRules", "cnode", "clusterNode", "tree",
                 "jsonTree", "getSwitch", "leases", "journal", "why",
                 "resilience", "rollout", "slo", "gateway/getRules",
                 "getClusterMode", "cluster/client/fetchConfig", "sim",
                 "metric", "timeseries", "systemStatus"):
        bodies = [out[name][1] for out in (jax_out, port_out)]
        if name not in ("version", "getSwitch", "tree", "metric"):
            bodies = [strip_keys(json.loads(b), _EPHEMERAL + ("target",))
                      for b in bodies]
        assert bodies[1] == bodies[0], name


def test_set_rules_persists_through_a_writable_datasource(case):
    """setRules -> BrokerWritableDataSource -> broker -> a push source's
    listener: the reference's datasource persistence loop, per package."""
    rules = [{"resource": "rt", "count": 4.0}]

    def run(P, eng, c):
        broker = P.push.InProcessBroker()
        P.handlers.register_writable_datasource(
            "flow", P.push.BrokerWritableDataSource(
                broker, "rules/flow", P.conv.flow_rules_to_json))
        observed = []
        reader = P.push.PushDataSource(P.conv.flow_rules_from_json)
        broker.subscribe("rules/flow", reader.on_update)
        reader.property.add_listener(type("L", (), {
            "config_update": lambda self, v: observed.append(v),
            "config_load": lambda self, v: observed.append(v)})())
        try:
            pushed = post(c, "setRules?type=flow", form(rules))
        finally:
            P.handlers._writable_datasources.pop("flow", None)
        return {"pushed": pushed, "version": broker.version("rules/flow"),
                "observed": [P.conv.flow_rule_to_dict(r)
                             for r in observed[-1]]}

    jax_out, port_out = both(case, run)
    assert port_out == jax_out
    assert port_out["pushed"] == (200, "success")
    assert port_out["version"] == 1
    assert port_out["observed"][0]["resource"] == "rt"


@pytest.mark.parametrize("key,value", [
    ("csp.sentinel.api.port", None), ("csp.sentinel.api.port", "9123"),
    ("csp.sentinel.api.port", "junk"),
    ("csp.sentinel.heartbeat.interval.ms", None),
    ("csp.sentinel.heartbeat.interval.ms", "250"),
    ("csp.sentinel.dashboard.server", None),
    ("csp.sentinel.dashboard.server", "a:1,b:2"),
    ("csp.sentinel.app.type", "3"),
])
def test_ops_config_readers_match_reference(key, value, monkeypatch):
    reader = {"csp.sentinel.api.port": "api_port",
              "csp.sentinel.heartbeat.interval.ms": "heartbeat_interval_ms",
              "csp.sentinel.dashboard.server": "dashboard_server",
              "csp.sentinel.app.type": "app_type"}[key]
    outs = []
    for P in ops_pkgs():
        cfg = P.config.config
        if value is None:
            monkeypatch.delitem(cfg._config, key, raising=False)
        else:
            monkeypatch.setitem(cfg._config, key, value)
        outs.append(getattr(cfg, reader)())
    assert outs[1] == outs[0]
    JC, PC = (P.config for P in ops_pkgs())
    for name in ("DASHBOARD_SERVER", "API_PORT", "HEARTBEAT_INTERVAL_MS",
                 "HEARTBEAT_CLIENT_IP", "HEARTBEAT_TOKEN",
                 "DEFAULT_API_PORT", "DEFAULT_HEARTBEAT_INTERVAL_MS"):
        assert getattr(PC, name) == getattr(JC, name), name


def test_heartbeat_token_header_and_local_ip(dashboard_stub, monkeypatch):
    """The optional shared-secret header and the reported address, per
    package: the override key wins, and with no route out the address
    falls back to 127.0.0.1."""
    outs = []
    for P in ops_pkgs():
        cfg = P.config.config
        monkeypatch.setitem(cfg._config, P.config.HEARTBEAT_TOKEN, "s3cret")
        monkeypatch.setitem(cfg._config, P.config.HEARTBEAT_CLIENT_IP,
                            "10.1.2.3")
        _DashboardStub.received.clear()
        hb = P.hb.HeartbeatSender(dashboards=[dashboard_stub], api_port=1)
        assert hb.send_once()
        _, params, token = _DashboardStub.received[0]
        monkeypatch.delitem(cfg._config, P.config.HEARTBEAT_CLIENT_IP)

        def no_route(*a, **k):
            raise OSError("no route")

        monkeypatch.setattr(P.hb.socket.socket, "connect", no_route)
        fallback = P.hb._local_ip()
        monkeypatch.undo()
        outs.append((token, params["ip"], fallback))
    assert outs[1] == outs[0] == ("s3cret", ["10.1.2.3"], "127.0.0.1")


def test_heartbeat_backoff_after_full_rotation_resets_on_success():
    """Every dashboard failing in a row backs off; one success restores
    the interval (the same waits from both packages' senders)."""
    outs = []
    for P in ops_pkgs():
        R = P.resilience.RetryPolicy
        hb = P.hb.HeartbeatSender(
            dashboards=["d1:80", "d2:80"], interval_ms=100, api_port=1,
            retry_policy=R(base_ms=100, max_ms=1600, multiplier=2.0,
                           jitter="none"))
        waits = [hb._next_wait_ms(False) for _ in range(6)]
        waits.append(hb._next_wait_ms(True))
        outs.append((waits, hb.consecutive_failures))
    assert outs[1] == outs[0]
    waits, failures = outs[1]
    # the first full rotation waits the base delay, later ones longer
    assert waits[:3] == [100, 100, 100] and max(waits[3:-1]) > 100
    assert waits[-1] == 100
    assert failures == 0


def test_heartbeat_last_success_monotonic_across_failover():
    """``test_cluster_ha.py:828`` on both packages: a failover to a
    dashboard while the observed clock runs backwards never moves the
    exported last-success stamp back; the probe registry serves it."""
    outs = []
    for P in ops_pkgs():
        class Beat(P.hb.HeartbeatSender):
            def _post(self, req) -> bool:
                return True

        R = P.resilience.RetryPolicy
        P.tu.freeze_time(NOW0)
        try:
            with P.resilience.faults.FaultInjector(seed=7) as inj:
                hb = Beat(dashboards=["d1:80", "d2:80"], interval_ms=100,
                          api_port=1,
                          retry_policy=R(base_ms=100, max_ms=1600,
                                         multiplier=2.0, jitter="none"))
                seq = [hb.send_once(), hb.last_success_ms]
                inj.arm("heartbeat.post", "error", times=1)
                seq += [hb.send_once(), hb._idx]   # d1 fails: rotate
                P.tu.freeze_time(NOW0 - 5_000)     # skewed back
                seq += [hb.send_once(), hb.last_success_ms]
                P.tu.freeze_time(NOW0 + 1_000)
                seq += [hb.send_once(), hb.last_success_ms]
                off = P.resilience.register_probe("heartbeat", hb.health)
                try:
                    seq.append(P.resilience.health_snapshot()["heartbeat"][
                        "lastSuccessMs"])
                finally:
                    off()
        finally:
            P.tu.unfreeze_time()
        outs.append(seq)
    assert outs[1] == outs[0]
    assert outs[1] == [True, NOW0, False, 1, True, NOW0, True, NOW0 + 1_000,
                       NOW0 + 1_000]


# -- st.init_ops_plane ------------------------------------------------------------

def _new_threads(before):
    return [t for t in threading.enumerate()
            if t not in before and t.is_alive()]


def test_ops_plane_lifecycle(tmp_path, monkeypatch, dashboard_stub):
    """init_ops_plane: idempotent; the center, the metric timer and the
    heartbeat (a dashboard is configured) start; the center follows the
    live default engine across st.reset; shutdown stops and joins every
    thread it started and the bound port refuses connections."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import context as ctx
    from sentinel_tpu_torch.core.config import config

    monkeypatch.setitem(config._config, "csp.sentinel.log.dir",
                        str(tmp_path))
    monkeypatch.setitem(config._config, "csp.sentinel.dashboard.server",
                        dashboard_stub)
    monkeypatch.setitem(config._config, "csp.sentinel.heartbeat.interval.ms",
                        "50")
    before = set(threading.enumerate())
    _DashboardStub.received.clear()
    ctx.replace_context(None)
    ctx.bump_generation()
    first = st.reset(capacity=128, device="cpu")
    try:
        parts = st.init_ops_plane(port=0)
        assert st.init_ops_plane(port=0) is parts  # idempotent
        center = parts["command_center"]
        assert center.bound_port > 0
        assert parts["heartbeat"] is not None
        assert {t.name for t in _new_threads(before)} >= {
            "sentinel-command-center", "sentinel-metrics-record",
            "sentinel-heartbeat"}
        st.load_flow_rules([st.FlowRule(resource="ops", count=3)])
        assert json.loads(get(center, "getRules?type=flow")[1])[0][
            "resource"] == "ops"
        # the heartbeat carries the BOUND port and the app name
        assert wait_for(lambda: _DashboardStub.received, 5.0)
        _, params, _ = _DashboardStub.received[0]
        assert params["port"] == [str(center.bound_port)]
        assert params["app"] == [config.app_name()]

        ctx.replace_context(None)
        second = st.reset(capacity=128, device="cpu")
        assert second is not first
        assert center.engine is second
        assert json.loads(get(center, "getRules?type=flow")[1]) == []
        st.load_flow_rules([st.FlowRule(resource="after", count=1)])
        assert json.loads(get(center, "getRules?type=flow")[1])[0][
            "resource"] == "after"
        body = get(center, "metrics")[1]
        assert body.endswith("# EOF\n")
        port = center.bound_port
    finally:
        st.shutdown_ops_plane()
        st.shutdown_ops_plane()  # a second call is a no-op
        ctx.replace_context(None)
        st.get_engine().close()
    assert st._ops_plane is None
    assert not _new_threads(before), [t.name for t in _new_threads(before)]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


def test_ops_plane_without_dashboard_starts_no_heartbeat(tmp_path,
                                                          monkeypatch):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import context as ctx
    from sentinel_tpu_torch.core.config import config

    monkeypatch.setitem(config._config, "csp.sentinel.log.dir",
                        str(tmp_path))
    monkeypatch.delitem(config._config, "csp.sentinel.dashboard.server",
                        raising=False)
    monkeypatch.delenv("CSP_SENTINEL_DASHBOARD_SERVER", raising=False)
    ctx.replace_context(None)
    ctx.bump_generation()
    eng = st.reset(capacity=128, device="cpu")
    try:
        parts = st.init_ops_plane(port=0)
        assert parts["heartbeat"] is None
        assert parts["metric_timer"].engine is eng
    finally:
        st.shutdown_ops_plane()
        ctx.replace_context(None)
        eng.close()


def test_ops_plane_raises_without_a_card(monkeypatch):
    """With no card and no default engine, the ops plane's first call
    builds the default engine on ``cuda`` and raises; nothing starts."""
    import torch

    import sentinel_tpu_torch as st

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(st, "_default_engine", None)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="CUDA"):
        st.init_ops_plane(port=0)
    assert st._ops_plane is None and st._default_engine is None
    assert not _new_threads(before)


def test_lazy_imports_of_the_ops_plane_point_at_the_port():
    """Every import in the port's transport and exporter modules, the
    handlers' lazy ones inside functions included, names the port or the
    standard library: an import left pointing at the JAX package would
    pass every test that never calls its command."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "sentinel_tpu_torch"
    files = sorted((root / "transport").glob("*.py")) + [
        root / "telemetry" / "exporter.py",
        root / "telemetry" / "openmetrics.py"]
    mods = set()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
    assert any(m.startswith("sentinel_tpu_torch.simulator") for m in mods)
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                        "sentinel_tpu"))
    assert not bad, bad
