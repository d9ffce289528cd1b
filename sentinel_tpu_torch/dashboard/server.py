"""The dashboard web server: discovery + metrics + rule CRUD + cluster ops
(port of ``sentinel_tpu/dashboard/server.py``). It has no device of its
own: it manages engines, which run on the card, through their command
centers, and renders ``/metrics`` with the port's exporter.

Reference: ``sentinel-dashboard`` (SURVEY.md §2.6) — Spring Boot +
AngularJS there; here a stdlib HTTP server exposing the same capability
set as a small JSON API plus one static page:

  * ``POST /registry/machine``                heartbeat receiver
    (``MachineRegistryController``)
  * ``GET  /app/names.json``                  app list (``AppController``)
  * ``GET  /app/machines.json?app=``          machine list + health
  * ``GET  /v1/rules?app=&type=``             rule CRUD, V1 style: read from
  * ``POST /v1/rules?app=&type=``             the machines, push to ALL
    (``FlowControllerV1`` et al. via ``SentinelApiClient``)
  * ``GET/POST /v2/rules?app=&type=``         rule CRUD, V2 style: through a
    registered config-source provider/publisher pair
    (``FlowControllerV2`` + ``DynamicRuleProvider``/``Publisher``;
    see :meth:`DashboardServer.register_rule_source`)
  * ``GET/POST /gateway/rules?app=``          gateway flow rules, V1 style
  * ``GET/POST /gateway/apis?app=``           custom API groups
    (``GatewayFlowRuleController`` / ``GatewayApiController`` via the
    machines' ``gateway/*`` commands)
  * ``GET  /metric/queryTopResourceMetric.json?app=``    live QPS series
  * ``GET  /metric/queryByAppAndResource.json?app=&identity=``
    (``MetricController`` over ``InMemoryMetricsRepository``)
  * ``GET  /resource/machineResource.json?ip=&port=``    clusterNode proxy
  * ``GET  /rollout/status.json?app=``        staged-rollout state
  * ``GET  /rollout/diff.json?app=``          shadow-vs-live outcome deltas
  * ``GET  /metrics``                         dashboard aggregates as
    OpenMetrics text (fleet view; each engine serves its own /metrics)
  * ``GET  /telemetry/summary.json?app=``     engine telemetry snapshot
  * ``GET  /telemetry/traces.json?app=``      sampled decision traces
    (both proxy the machines' ``telemetry`` / ``traces`` commands)
  * ``GET  /telemetry/stream?app=``           Server-Sent Events: one
    ``event: second`` per new complete flight-recorder second plus one
    ``event: alert`` per SLO/anomaly alert transition (proxies the
    machines' ``timeseries`` + ``alerts`` commands on a ~1s cadence;
    fetch failures surface as ``event: error`` frames, the stream stays
    up; ``Last-Event-ID`` resumes both cursors after a reconnect)
  * ``GET  /adaptive.json?app=``              adaptive-loop state: enabled/
    frozen, in-flight candidate, targets, senses, decision counters
  * ``GET  /alerts.json?app=``                SLO/anomaly alerts: active
    set + transition log (proxies the machines' ``alerts`` command)
  * ``GET  /sim.json?app=``                   trace-replay simulator: last
    policy-lab report / scenario catalog (proxies the ``sim`` command)
  * ``GET  /rebalance.json?app=``             shard rebalancer: freeze state,
    plan history (op=status) or slice-load fold (op=sense)
  * ``GET  /waterfall.json?app=``             wire-to-device latency
    waterfall: per-stage budget, RTT reconciliation, exemplars + sentry
    (proxies the machines' ``waterfall`` command, op=status)
  * ``GET  /population.json?app=``            namespace telescope:
    cardinality, top-k with error bars, churn, slot-budget projection
    (proxies the machines' ``population`` command; op=status/report/
    curve/fleet)
  * ``GET  /fleet.json?app=``                 fleet observability: federated
    per-leader staleness/skew/health + exact fleet series (proxies the
    machines' ``fleet`` command; ``op=series`` for the per-second sums,
    ``op=why&resource=&stampMs=`` routes the forensic ``why`` join,
    ``op=journal`` the audit-journal tail)
  * ``POST /rollout/command?app=&op=``        stage/canary/promote/abort/tick
    (no reference twin — proxies the engines' ``rollout`` command)
  * ``POST /cluster/assign?app=&ip=&port=``   token-server assignment
    (``ClusterConfigController.assign``: chosen machine -> SERVER, every
    other healthy machine -> CLIENT of it)
  * ``GET  /``                                the UI (static/index.html)
  * ``POST /auth/login`` / ``/auth/logout``, ``GET /auth/check``
    (``auth.AuthService``; enabled only when
    ``sentinel.dashboard.auth.username`` is configured)

Rules are owned by the engines (and their writable datasources); the
dashboard holds no rule store — matching the reference's V1 controllers,
whose in-memory repository is a display cache, not a source of truth.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

from sentinel_tpu_torch.dashboard.auth import COOKIE_NAME, AuthService
from sentinel_tpu_torch.dashboard.client import ApiError, SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.metrics import InMemoryMetricsRepository, MetricFetcher

RULE_TYPES = ("flow", "degrade", "system", "authority", "paramFlow")
_STATIC_DIR = Path(__file__).parent / "static"
# LoginAuthenticationFilter exemptions: login itself, the UI shell, the
# heartbeat receiver (engines are not logged-in browsers), and the
# OpenMetrics endpoint (scrapers are not logged-in browsers either; it
# exposes aggregate numbers only, no rule mutation).
_PUBLIC_PATHS = ("/", "/index.html", "/auth/login", "/auth/check",
                 "/registry/machine", "/metrics")


def _flat_qs(qs: str) -> Dict[str, str]:
    """query-string / form body → first-value-wins flat dict."""
    return {k: v[0] for k, v in urllib.parse.parse_qs(qs).items()}


class DashboardServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 fetch_interval_s: float = 1.0,
                 auth: Optional[AuthService] = None,
                 heartbeat_token: Optional[str] = None):
        from sentinel_tpu_torch.core.config import HEARTBEAT_TOKEN
        from sentinel_tpu_torch.core.config import config as _cfg

        self.host = host
        self.port = port
        self.auth = auth if auth is not None else AuthService()
        # Optional shared secret for /registry/machine (auth-exempt by
        # reference parity): without it, any network peer can register a
        # rogue machine the dashboard will then poll and trust.
        self.heartbeat_token = (
            heartbeat_token if heartbeat_token is not None
            else (_cfg.get(HEARTBEAT_TOKEN, "") or ""))
        self.apps = AppManagement()
        self.api = SentinelApiClient()
        # (app, rule_type) -> (provider, publisher) — the V2 pipeline.
        self.rule_sources: Dict = {}
        self.repository = InMemoryMetricsRepository()
        self.fetcher = MetricFetcher(self.apps, self.repository,
                                     interval_s=fetch_interval_s)
        # SSE (/telemetry/stream): poll cadence against the machines'
        # `timeseries` command, and the live consumer gauge the
        # dashboard /metrics exposition reports.
        self.stream_interval_s = 1.0
        self.sse_clients = 0
        self._sse_lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def bound_port(self) -> int:
        return self._server.server_address[1] if self._server else self.port

    def start(self, fetch: bool = True) -> "DashboardServer":
        """``fetch=False`` skips the metric poll thread (tests drive
        ``fetcher.fetch_once`` deterministically)."""
        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.dashboard = self
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sentinel-dashboard",
            daemon=True)
        self._thread.start()
        if fetch:
            self.fetcher.start()
        return self

    def stop(self) -> None:
        self.fetcher.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- operations (handlers delegate here; also usable programmatically) --

    def register_machine(self, params: Dict[str, str]) -> None:
        self.apps.register(MachineInfo(
            app=params.get("app", "unknown"),
            ip=params.get("ip", "127.0.0.1"),
            port=int(params.get("port", "8719")),
            hostname=params.get("hostname", ""),
            app_type=int(params.get("app_type", "0") or 0),
            version=params.get("v", ""),
            pid=int(params.get("pid", "0") or 0),
        ))

    def _first_healthy(self, app: str) -> MachineInfo:
        ms = self.apps.healthy_machines(app)
        if not ms:
            raise ApiError(f"no healthy machine for app {app!r}")
        return ms[0]

    def register_rule_source(self, app: str, rule_type: str,
                             provider, publisher) -> None:
        """V2 rule pipeline (reference ``FlowControllerV2`` +
        ``DynamicRuleProvider``/``DynamicRulePublisher``): rules for
        (app, type) are read from and published to a CONFIG SOURCE (e.g.
        a broker key the engines' push datasources listen on) instead of
        the machines' command API — the dashboard writes config, engines
        converge via their own datasource bindings.

        ``provider()`` returns the current rule list (dicts);
        ``publisher(rules)`` persists it to the source."""
        if rule_type not in RULE_TYPES:
            raise ValueError(f"invalid rule type {rule_type!r}")
        self.rule_sources[(app, rule_type)] = (provider, publisher)

    def get_rules_v2(self, app: str, rule_type: str):
        src = self.rule_sources.get((app, rule_type))
        if src is None:
            raise ApiError(
                f"no v2 rule source registered for ({app}, {rule_type})")
        return src[0]()

    def set_rules_v2(self, app: str, rule_type: str, rules) -> str:
        src = self.rule_sources.get((app, rule_type))
        if src is None:
            raise ApiError(
                f"no v2 rule source registered for ({app}, {rule_type})")
        src[1](rules)
        return "published"

    def get_rules(self, app: str, rule_type: str):
        m = self._first_healthy(app)
        return self.api.fetch_rules(m.ip, m.port, rule_type)

    def set_rules(self, app: str, rule_type: str, rules) -> Dict[str, bool]:
        """Push wholesale to every healthy machine (V1 publish semantics)."""
        out = {}
        for m in self.apps.healthy_machines(app):
            try:
                self.api.set_rules(m.ip, m.port, rule_type, rules)
                out[m.key] = True
            except ApiError:
                out[m.key] = False
        if not out:
            raise ApiError(f"no healthy machine for app {app!r}")
        return out

    def get_gateway(self, app: str, kind: str):
        m = self._first_healthy(app)
        if kind == "apis":
            return self.api.fetch_api_definitions(m.ip, m.port)
        return self.api.fetch_gateway_rules(m.ip, m.port)

    def set_gateway(self, app: str, kind: str, payload) -> Dict[str, bool]:
        """Wholesale push to every healthy machine (V1 semantics), for
        gateway rules (kind='rules') or custom API groups (kind='apis')."""
        out = {}
        for m in self.apps.healthy_machines(app):
            try:
                if kind == "apis":
                    self.api.set_api_definitions(m.ip, m.port, payload)
                else:
                    self.api.set_gateway_rules(m.ip, m.port, payload)
                out[m.key] = True
            except ApiError:
                out[m.key] = False
        if not out:
            raise ApiError(f"no healthy machine for app {app!r}")
        return out

    def get_rollout(self, app: str, op: str = "status"):
        """Staged-rollout read path (status / shadow-vs-live diff) from
        the first healthy machine — like the V1 rule read path."""
        m = self._first_healthy(app)
        return self.api.fetch_rollout(m.ip, m.port, op)

    def get_adaptive(self, app: str, op: str = "status",
                     since_seq: Optional[int] = None,
                     limit: Optional[int] = None):
        """Adaptive-loop read path (``adaptive`` command status or
        history) from the first healthy machine — the Adaptive panel's
        source. Read-only: enable/freeze/set go through the machines'
        command plane directly (the runbook's drill)."""
        if op not in ("status", "history"):
            raise ValueError(f"unsupported adaptive op {op!r}")
        m = self._first_healthy(app)
        return self.api.fetch_adaptive(m.ip, m.port, op=op,
                                       since_seq=since_seq, limit=limit)

    def get_fleet(self, app: str, op: str = "status",
                  params: Optional[Dict[str, str]] = None):
        """Fleet observability read path: the machines' ``fleet``
        command (status/series), the ``journal`` tail, or the ``why``
        forensic join — one dashboard proxy for the whole plane."""
        m = self._first_healthy(app)
        if op == "journal":
            return self.api.fetch_journal(m.ip, m.port,
                                          params=params or {})
        if op == "why":
            return self.api.fetch_why(m.ip, m.port, params=params or {})
        if op not in ("status", "series", "poll"):
            raise ValueError(f"unsupported fleet op {op!r}")
        return self.api.fetch_fleet(m.ip, m.port, op=op,
                                    params=params or {})

    def get_rebalance(self, app: str, op: str = "status",
                      params: Optional[Dict[str, str]] = None):
        """Rebalancer read path (``rebalance`` command status/sense)
        from the first healthy machine. Read-only: plan/certify/apply/
        rollback are governed actions and go through the machines'
        command plane directly."""
        if op not in ("status", "sense"):
            raise ValueError(f"unsupported rebalance op {op!r}")
        m = self._first_healthy(app)
        return self.api.fetch_rebalance(m.ip, m.port, op=op,
                                        params=params or {})

    def get_waterfall(self, app: str,
                      params: Optional[Dict[str, str]] = None):
        """Latency-waterfall read path (``waterfall`` command,
        op=status) from the first healthy machine — the Waterfall
        panel's source. Read-only: budget overrides and saturation
        probes go through the machines' command plane directly."""
        m = self._first_healthy(app)
        return self.api.fetch_waterfall(m.ip, m.port,
                                        params=params or {})

    def get_population(self, app: str, op: str = "status",
                       params: Optional[Dict[str, str]] = None):
        """Namespace-telescope read path (``population`` command) from
        the first healthy machine — the Namespace population panel's
        source. Read-only ops only (the tracker has no mutating ops)."""
        if op not in ("status", "report", "curve", "fleet"):
            raise ValueError(f"unsupported population op {op!r}")
        m = self._first_healthy(app)
        return self.api.fetch_population(m.ip, m.port, op=op,
                                         params=params or {})

    def get_sim(self, app: str, op: str = "report"):
        """Simulator read path (``sim`` command report/scenarios) from
        the first healthy machine — the Simulator panel's source.
        Read-only: drill replays and lab runs go through the machines'
        command plane / the offline lab directly."""
        if op not in ("report", "scenarios"):
            raise ValueError(f"unsupported sim op {op!r}")
        m = self._first_healthy(app)
        return self.api.fetch_sim(m.ip, m.port, op=op)

    def get_telemetry(self, app: str, kind: str = "summary",
                      limit: Optional[int] = None):
        """Engine telemetry read path: attribution/histogram snapshot
        (kind='summary') or sampled decision traces (kind='traces') from
        the first healthy machine."""
        m = self._first_healthy(app)
        if kind == "traces":
            return self.api.fetch_traces(m.ip, m.port, limit=limit)
        return self.api.fetch_telemetry(m.ip, m.port)

    def rollout_command(self, app: str, params: Dict[str, str],
                        body: str = "") -> Dict:
        """Staged-rollout mutation (load/stage/promote/abort/tick) pushed
        to EVERY healthy machine, V1 publish semantics: each engine runs
        its own shadow/canary/guardrail over its own traffic slice."""
        out = {}
        for m in self.apps.healthy_machines(app):
            try:
                out[m.key] = self.api.rollout_command(m.ip, m.port, params,
                                                      body=body)
            except ApiError as ex:
                out[m.key] = {"error": str(ex)}
        if not out:
            raise ApiError(f"no healthy machine for app {app!r}")
        return out

    def assign_token_server(self, app: str, ip: str, port: int,
                            token_port: int = 0) -> Dict:
        """Reference ``ClusterConfigController`` assign flow: flip the chosen
        machine to SERVER, then point every other healthy machine at it."""
        self.api.modify_cluster_server_config(ip, port, token_port)
        self.api.set_cluster_mode(ip, port, 1)
        bound = self.api.fetch_cluster_server_config(ip, port).get("boundPort")
        if bound is None:
            raise ApiError(
                f"{ip}:{port} flipped to server but reports no bound token port")
        clients = {}
        for m in self.apps.healthy_machines(app):
            if m.ip == ip and m.port == port:
                continue
            try:
                self.api.modify_cluster_client_config(m.ip, m.port, ip, int(bound))
                self.api.set_cluster_mode(m.ip, m.port, 0)
                clients[m.key] = True
            except ApiError:
                clients[m.key] = False
        return {"server": f"{ip}:{port}", "tokenPort": bound, "clients": clients}


class _Handler(BaseHTTPRequestHandler):
    server_version = "sentinel-tpu-dashboard"

    def log_message(self, fmt, *args):
        pass

    # -- plumbing ----------------------------------------------------------

    def _json(self, obj, code: int = 200, headers=()):
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _ok(self, result, headers=()):
        # reference dashboard Result<T> envelope: {success, code, msg, data}
        self._json({"success": True, "code": 0, "msg": None, "data": result},
                   headers=headers)

    def _fail(self, msg: str, code: int = 400):
        self._json({"success": False, "code": code, "msg": msg, "data": None},
                   code=code)

    def _text(self, text: str, ctype: str, code: int = 200):
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _static(self, name: str):
        path = _STATIC_DIR / name
        if not path.is_file():
            self._fail("not found", 404)
            return
        data = path.read_bytes()
        ctype = "text/html; charset=utf-8" if name.endswith(".html") else \
            "application/javascript" if name.endswith(".js") else "text/css"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # -- auth --------------------------------------------------------------

    def _session_token(self) -> Optional[str]:
        authz = self.headers.get("Authorization", "")
        if authz.startswith("Bearer "):
            return authz[len("Bearer "):].strip()
        for part in self.headers.get("Cookie", "").split(";"):
            k, _, v = part.strip().partition("=")
            if k == COOKIE_NAME and v:
                return v
        return None

    def _auth_routes(self, d: DashboardServer, path: str, body: str) -> bool:
        """Handle /auth/*; returns True when the request was consumed."""
        if path == "/auth/login":
            if self.command != "POST":
                self._fail("POST required", 405)
                return True
            form = _flat_qs(body)
            token = d.auth.login(form.get("username", ""),
                                 form.get("password", ""))
            if token is None:
                self._fail("invalid username or password", 401)
            else:
                self._ok({"username": form.get("username", "")},
                         headers=[("Set-Cookie",
                                   f"{COOKIE_NAME}={token}; HttpOnly; "
                                   f"Path=/; SameSite=Strict")])
            return True
        if path == "/auth/logout":
            if self.command != "POST":
                self._fail("POST required", 405)
                return True
            d.auth.logout(self._session_token())
            self._ok("logged out")
            return True
        if path == "/auth/check":
            user = d.auth.validate(self._session_token())
            if user is None and d.auth.enabled:
                self._fail("not logged in", 401)
            else:
                self._ok({"username": user.username if user else "",
                          "authRequired": d.auth.enabled})
            return True
        return False

    # -- routing -----------------------------------------------------------

    def do_GET(self):
        self._route("")

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length).decode("utf-8") if length else ""
        self._route(body)

    def _route(self, body: str):
        d: DashboardServer = self.server.dashboard
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        q = _flat_qs(parsed.query)
        try:
            if self._auth_routes(d, path, body):
                return
            if d.auth.enabled and path not in _PUBLIC_PATHS \
                    and d.auth.validate(self._session_token()) is None:
                return self._fail("not logged in", 401)
            if path in ("/", "/index.html"):
                return self._static("index.html")
            # Mutating routes are POST-only: a crawler or <img> prefetch must
            # not reassign a cluster or register phantom machines via GET.
            if path in ("/registry/machine", "/cluster/assign") \
                    and self.command != "POST":
                return self._fail("POST required", 405)
            if path == "/registry/machine":
                if d.heartbeat_token:
                    import hmac

                    # Compare as bytes: compare_digest raises TypeError on
                    # non-ASCII str, and header bytes arrive latin-1-decoded.
                    got = self.headers.get("X-Sentinel-Heartbeat-Token", "")
                    if not hmac.compare_digest(
                            got.encode("utf-8"),
                            d.heartbeat_token.encode("utf-8")):
                        return self._fail("bad heartbeat token", 403)
                form = _flat_qs(body)
                form.update(q)
                d.register_machine(form)
                return self._ok("registered")
            if path == "/app/names.json":
                return self._ok(d.apps.app_names())
            if path == "/app/machines.json":
                return self._ok([m.to_dict()
                                 for m in d.apps.machines(q.get("app", ""))])
            if path in ("/gateway/rules", "/gateway/apis"):
                # reference: GatewayFlowRuleController / GatewayApiController
                app = q.get("app", "")
                kind = "apis" if path.endswith("apis") else "rules"
                if self.command == "GET":
                    return self._ok(d.get_gateway(app, kind))
                payload = json.loads(body or "[]")
                if not isinstance(payload, list):
                    return self._fail("expected a JSON list")
                return self._ok(d.set_gateway(app, kind, payload))
            if path in ("/v1/rules", "/v2/rules"):
                app, rtype = q.get("app", ""), q.get("type", "flow")
                if rtype not in RULE_TYPES:
                    return self._fail(f"invalid type {rtype!r}")
                v2 = path == "/v2/rules"
                if self.command == "GET":
                    return self._ok(d.get_rules_v2(app, rtype) if v2
                                    else d.get_rules(app, rtype))
                rules = json.loads(body or "[]")
                if not isinstance(rules, list):
                    return self._fail("expected a JSON list")
                return self._ok(d.set_rules_v2(app, rtype, rules) if v2
                                else d.set_rules(app, rtype, rules))
            if path == "/metric/queryTopResourceMetric.json":
                return self._metric_top(d, q)
            if path == "/metric/queryByAppAndResource.json":
                app = q.get("app", "")
                res = q.get("identity", "")
                start, end = self._range(q)
                return self._ok(d.repository.query(app, res, start, end))
            if path == "/resource/machineResource.json":
                return self._ok(d.api.fetch_cluster_node(
                    q.get("ip", ""), int(q.get("port", "8719"))))
            if path == "/cluster/assign":
                return self._ok(d.assign_token_server(
                    q.get("app", ""), q.get("ip", ""),
                    int(q.get("port", "8719")),
                    int(q.get("tokenPort", "0"))))
            if path in ("/rollout/status.json", "/rollout/diff.json"):
                op = "diff" if path.endswith("diff.json") else "status"
                return self._ok(d.get_rollout(q.get("app", ""), op))
            if path == "/metrics":
                from sentinel_tpu_torch.telemetry.exporter import (
                    render_dashboard_metrics)
                from sentinel_tpu_torch.telemetry.openmetrics import (
                    OPENMETRICS_CONTENT_TYPE)

                return self._text(render_dashboard_metrics(d),
                                  OPENMETRICS_CONTENT_TYPE)
            if path == "/telemetry/stream":
                return self._sse_stream(d, q)
            if path == "/adaptive.json":
                since = q.get("sinceSeq")
                limit = q.get("limit")
                return self._ok(d.get_adaptive(
                    q.get("app", ""), op=q.get("op", "status"),
                    since_seq=int(since) if since else None,
                    limit=int(limit) if limit else None))
            if path == "/sim.json":
                return self._ok(d.get_sim(
                    q.get("app", ""), op=q.get("op", "report")))
            if path == "/fleet.json":
                op = q.get("op", "status")
                params = {k: v for k, v in q.items()
                          if k not in ("app", "op")}
                return self._ok(d.get_fleet(q.get("app", ""), op=op,
                                            params=params))
            if path == "/rebalance.json":
                op = q.get("op", "status")
                params = {k: v for k, v in q.items()
                          if k not in ("app", "op")}
                return self._ok(d.get_rebalance(q.get("app", ""), op=op,
                                                params=params))
            if path == "/waterfall.json":
                params = {k: v for k, v in q.items() if k != "app"}
                return self._ok(d.get_waterfall(q.get("app", ""),
                                                params=params))
            if path == "/population.json":
                op = q.get("op", "status")
                params = {k: v for k, v in q.items()
                          if k not in ("app", "op")}
                return self._ok(d.get_population(q.get("app", ""), op=op,
                                                 params=params))
            if path == "/alerts.json":
                m = d._first_healthy(q.get("app", ""))
                since = q.get("sinceSeq")
                return self._ok(d.api.fetch_alerts(
                    m.ip, m.port,
                    since_seq=int(since) if since else None))
            if path in ("/telemetry/summary.json", "/telemetry/traces.json"):
                kind = "traces" if path.endswith("traces.json") else "summary"
                limit = q.get("limit")
                return self._ok(d.get_telemetry(
                    q.get("app", ""), kind,
                    limit=int(limit) if limit else None))
            if path == "/rollout/command":
                # Mutating: POST-only, like /cluster/assign above.
                if self.command != "POST":
                    return self._fail("POST required", 405)
                params = {k: v for k, v in q.items() if k != "app"}
                return self._ok(d.rollout_command(
                    q.get("app", ""), params, body=body))
            if path == "/cluster/state.json":
                out = []
                for m in d.apps.healthy_machines(q.get("app", "")):
                    try:
                        out.append({**m.to_dict(),
                                    **d.api.fetch_cluster_mode(m.ip, m.port)})
                    except ApiError:
                        pass
                return self._ok(out)
            return self._fail(f"unknown path {path}", 404)
        except ApiError as ex:
            return self._fail(str(ex), 502)
        except (ValueError, KeyError) as ex:
            return self._fail(f"bad request: {ex}")
        except BrokenPipeError:
            pass

    def _sse_stream(self, d: DashboardServer, q):
        """``/telemetry/stream``: Server-Sent Events pushing each new
        complete flight-recorder second of the app's first healthy
        machine (``event: second``, data = the `timeseries` command's
        per-second JSON) plus each SLO/anomaly alert transition
        (``event: alert``, data = one `alerts` command event). A failed
        upstream fetch emits ``event: error`` with a structured body and
        the stream keeps polling — a machine restart mid-stream degrades
        to error frames, not a dropped connection. ``maxEvents=`` closes
        the stream after N data frames (second + alert — bounded
        consumption for tests/tools).

        Resume: every data frame carries ``id: <secondStamp>:<alertSeq>``
        (both cursors, whatever the frame type). A reconnecting
        EventSource replays its ``Last-Event-ID`` header here, and the
        stream resumes from BOTH cursors — the missed complete seconds
        replay from the machine's bounded host history and the missed
        alert transitions from its bounded event log, instead of being
        silently lost across a reconnect."""
        app = q.get("app", "")
        try:
            max_events = int(q.get("maxEvents", "0") or 0)
        except ValueError:
            return self._fail("bad request: maxEvents")
        cursor = None   # newest streamed second stamp (ms)
        alert_seq = 0   # newest streamed alert transition seq
        last_id = (self.headers.get("Last-Event-ID") or "").strip()
        if last_id:
            sec_part, _, seq_part = last_id.partition(":")
            try:
                cursor = int(sec_part) if int(sec_part) > 0 else None
                alert_seq = max(0, int(seq_part or "0"))
            except ValueError:
                cursor, alert_seq = None, 0  # foreign id: fresh stream
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream; charset=utf-8")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

        def emit(event: str, payload) -> None:
            self.wfile.write(
                f"id: {cursor or 0}:{alert_seq}\nevent: {event}\n"
                f"data: {json.dumps(payload)}\n\n".encode("utf-8"))
            self.wfile.flush()

        with d._sse_lock:
            d.sse_clients += 1
        sent = 0
        try:
            # stop() nulls _server; without this check a connected
            # stream would keep polling engines ~1/s forever after the
            # server is stopped (ThreadingHTTPServer's server_close
            # only closes the LISTENING socket, never handler threads).
            while d._server is not None:
                try:
                    m = d._first_healthy(app)
                    # First poll: only the newest 60 (a fresh consumer
                    # wants recent context, not the whole history).
                    # Cursor polls (including a Last-Event-ID resume):
                    # EVERYTHING after the cursor — a capped catch-up
                    # would silently skip the seconds beyond the cap
                    # while the cursor jumped past them.
                    out = d.api.fetch_timeseries(
                        m.ip, m.port, since_ms=cursor,
                        limit=60 if cursor is None else 1_000_000)
                    for sec in out.get("seconds", []):
                        cursor = max(cursor or 0, int(sec["timestamp"]))
                        emit("second", sec)
                        sent += 1
                        if max_events and sent >= max_events:
                            return
                    alerts = d.api.fetch_alerts(m.ip, m.port,
                                                since_seq=alert_seq)
                    for ev in alerts.get("events", []):
                        alert_seq = max(alert_seq, int(ev["seq"]))
                        emit("alert", ev)
                        sent += 1
                        if max_events and sent >= max_events:
                            return
                except (ApiError, ValueError, KeyError) as ex:
                    # Structured failure INSIDE the stream: consumers see
                    # what broke instead of a silent stall.
                    emit("error", {"error": str(ex)})
                if max_events and sent >= max_events:
                    return
                # Comment frame doubles as the disconnect probe: a gone
                # client surfaces as BrokenPipe here, ending the loop.
                self.wfile.write(b": keepalive\n\n")
                self.wfile.flush()
                time.sleep(d.stream_interval_s)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with d._sse_lock:
                d.sse_clients -= 1

    def _range(self, q):
        now = int(time.time() * 1000)
        start = int(q.get("startTime", now - 5 * 60_000))
        end = int(q.get("endTime", now))
        return start, end

    def _metric_top(self, d: DashboardServer, q):
        app = q.get("app", "")
        start, end = self._range(q)
        top = d.repository.top_resources(app, start, end,
                                         int(q.get("pageSize", "30")))
        return self._ok({
            "resource": {r: d.repository.query(app, r, start, end)
                         for r in top},
        })
