"""HTTP client to each engine's command port (port of
``sentinel_tpu/dashboard/client.py``).

Reference: ``dashboard:client/SentinelApiClient.java`` — the dashboard
talks to every registered instance's command center (default :8719) to
fetch/push rules, scrape metrics, and drive cluster mode. Thin, synchronous
``urllib`` here (callers poll from worker threads).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

DEFAULT_TIMEOUT_S = 3.0


class ApiError(RuntimeError):
    pass


class SentinelApiClient:
    def __init__(self, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.timeout_s = timeout_s

    # -- raw command transport --------------------------------------------

    def _url(self, ip: str, port: int, cmd: str, params: Optional[Dict] = None) -> str:
        qs = f"?{urllib.parse.urlencode(params)}" if params else ""
        return f"http://{ip}:{port}/{cmd}{qs}"

    def get(self, ip: str, port: int, cmd: str,
            params: Optional[Dict] = None) -> str:
        try:
            with urllib.request.urlopen(
                    self._url(ip, port, cmd, params), timeout=self.timeout_s) as r:
                return r.read().decode("utf-8")
        except (urllib.error.URLError, OSError) as ex:
            raise ApiError(f"GET {cmd} on {ip}:{port} failed: {ex}") from ex

    def post(self, ip: str, port: int, cmd: str,
             params: Optional[Dict] = None, body: str = "") -> str:
        req = urllib.request.Request(
            self._url(ip, port, cmd, params), data=body.encode("utf-8"),
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read().decode("utf-8")
        except urllib.error.HTTPError as ex:
            raise ApiError(
                f"POST {cmd} on {ip}:{port}: {ex.read().decode(errors='replace')}"
            ) from ex
        except (urllib.error.URLError, OSError) as ex:
            raise ApiError(f"POST {cmd} on {ip}:{port} failed: {ex}") from ex

    # -- typed surface (mirrors SentinelApiClient methods) ----------------

    def fetch_rules(self, ip: str, port: int, rule_type: str) -> List[Dict]:
        return json.loads(self.get(ip, port, "getRules", {"type": rule_type}))

    def set_rules(self, ip: str, port: int, rule_type: str,
                  rules: List[Dict]) -> None:
        out = self.post(ip, port, "setRules", {"type": rule_type},
                        body=f"data={urllib.parse.quote(json.dumps(rules))}")
        if out != "success":
            raise ApiError(f"setRules rejected: {out}")

    def fetch_gateway_rules(self, ip: str, port: int) -> List[Dict]:
        return json.loads(self.get(ip, port, "gateway/getRules"))

    def set_gateway_rules(self, ip: str, port: int,
                          rules: List[Dict]) -> None:
        out = self.post(ip, port, "gateway/updateRules", {},
                        body=f"data={urllib.parse.quote(json.dumps(rules))}")
        if out != "success":
            raise ApiError(f"gateway/updateRules rejected: {out}")

    def fetch_api_definitions(self, ip: str, port: int) -> List[Dict]:
        return json.loads(self.get(ip, port, "gateway/getApiDefinitions"))

    def set_api_definitions(self, ip: str, port: int,
                            defs: List[Dict]) -> None:
        out = self.post(ip, port, "gateway/updateApiDefinitions", {},
                        body=f"data={urllib.parse.quote(json.dumps(defs))}")
        if out != "success":
            raise ApiError(f"gateway/updateApiDefinitions rejected: {out}")

    def fetch_metric(self, ip: str, port: int, start_ms: int, end_ms: int,
                     max_lines: int = 6000) -> str:
        return self.get(ip, port, "metric", {
            "startTime": start_ms, "endTime": end_ms, "maxLines": max_lines})

    def fetch_cluster_node(self, ip: str, port: int) -> List[Dict]:
        return json.loads(self.get(ip, port, "clusterNode"))

    def fetch_cluster_mode(self, ip: str, port: int) -> Dict:
        return json.loads(self.get(ip, port, "getClusterMode"))

    # -- staged rollout (rollout/) ----------------------------------------

    def fetch_rollout(self, ip: str, port: int, op: str = "status") -> Dict:
        """``rollout`` read ops: status / diff."""
        return json.loads(self.get(ip, port, "rollout", {"op": op}))

    def fetch_telemetry(self, ip: str, port: int) -> Dict:
        """``telemetry`` snapshot (attribution / RT percentiles / timers)."""
        return json.loads(self.get(ip, port, "telemetry"))

    def fetch_traces(self, ip: str, port: int,
                     limit: Optional[int] = None,
                     offset: Optional[int] = None) -> Dict:
        """Sampled decision traces (``traces`` command), drained first."""
        params = {"drain": "true"}
        if limit is not None:
            params["limit"] = limit
        if offset is not None:
            params["offset"] = offset
        return json.loads(self.get(ip, port, "traces", params))

    def fetch_timeseries(self, ip: str, port: int,
                         since_ms: Optional[int] = None,
                         resource: Optional[str] = None,
                         limit: Optional[int] = None) -> Dict:
        """Flight-recorder per-second windows (``timeseries`` command);
        ``since_ms`` is the SSE pump's cursor (strictly-after filter)."""
        params: Dict = {}
        if since_ms is not None:
            params["sinceMs"] = since_ms
        if resource is not None:
            params["resource"] = resource
        if limit is not None:
            params["limit"] = limit
        return json.loads(self.get(ip, port, "timeseries", params))

    def fetch_alerts(self, ip: str, port: int,
                     since_seq: Optional[int] = None,
                     limit: Optional[int] = None) -> Dict:
        """SLO/anomaly alerts (``alerts`` command): active set + the
        seq-numbered transition log after ``since_seq`` (the SSE pump's
        cursor)."""
        params: Dict = {}
        if since_seq is not None:
            params["sinceSeq"] = since_seq
        if limit is not None:
            params["limit"] = limit
        return json.loads(self.get(ip, port, "alerts", params))

    def fetch_adaptive(self, ip: str, port: int, op: str = "status",
                       since_seq: Optional[int] = None,
                       limit: Optional[int] = None) -> Dict:
        """Adaptive-loop state (``adaptive`` command): status (default)
        or the seq-cursored decision log (``op="history"``)."""
        params: Dict = {"op": op}
        if since_seq is not None:
            params["sinceSeq"] = since_seq
        if limit is not None:
            params["limit"] = limit
        return json.loads(self.get(ip, port, "adaptive", params))

    def fetch_sim(self, ip: str, port: int, op: str = "report") -> Dict:
        """Simulator state (``sim`` command): the last policy-lab
        report (per-policy objective vectors) or the scenario catalog."""
        return json.loads(self.get(ip, port, "sim", {"op": op}))

    def fetch_fleet(self, ip: str, port: int, op: str = "status",
                    params: Optional[Dict] = None) -> Dict:
        """Fleet federation state (``fleet`` command): per-leader
        staleness/skew/health (op=status) or the exact federated
        per-second series (op=series)."""
        return json.loads(self.get(ip, port, "fleet",
                                   {"op": op, **(params or {})}))

    def fetch_rebalance(self, ip: str, port: int, op: str = "status",
                        params: Optional[Dict] = None) -> Dict:
        """Shard rebalancer state (``rebalance`` command): freeze
        state, counters and plan history (op=status) or the
        slice-granular load fold + skew (op=sense)."""
        return json.loads(self.get(ip, port, "rebalance",
                                   {"op": op, **(params or {})}))

    def fetch_waterfall(self, ip: str, port: int,
                        params: Optional[Dict] = None) -> Dict:
        """Wire-to-device latency waterfall (``waterfall`` command,
        op=status): per-stage cumulative budget, RTT reconciliation,
        exemplars and the regression sentry's alert state."""
        return json.loads(self.get(ip, port, "waterfall",
                                   {"op": "status", **(params or {})}))

    def fetch_population(self, ip: str, port: int, op: str = "status",
                         params: Optional[Dict] = None) -> Dict:
        """Namespace telescope (``population`` command): cardinality +
        top-k + churn (op=status), admission-readiness projection
        (op=report, budget=), the budget-ladder curve (op=curve), or
        the fleet-merged view (op=fleet)."""
        return json.loads(self.get(ip, port, "population",
                                   {"op": op, **(params or {})}))

    def fetch_journal(self, ip: str, port: int,
                      params: Optional[Dict] = None) -> Dict:
        """Audit-journal tail (``journal`` command): seq-cursored
        control-plane records (sinceSeq/limit/kind)."""
        return json.loads(self.get(ip, port, "journal", params or {}))

    def fetch_why(self, ip: str, port: int,
                  params: Optional[Dict] = None) -> Dict:
        """Forensic ``why`` join for one (resource, stampMs)."""
        return json.loads(self.get(ip, port, "why", params or {}))

    def fetch_explain(self, ip: str, port: int,
                      resource: Optional[str] = None,
                      index: int = 0) -> Dict:
        """``explain`` join: sampled trace × flight-recorder second."""
        params: Dict = {"index": index}
        if resource is not None:
            params["resource"] = resource
        return json.loads(self.get(ip, port, "explain", params))

    def rollout_command(self, ip: str, port: int, params: Dict,
                        body: str = "") -> Dict:
        """``rollout`` mutating ops (load/stage/promote/abort/tick)."""
        out = self.post(ip, port, "rollout", params, body=body)
        try:
            return json.loads(out)
        except ValueError as ex:
            raise ApiError(f"rollout command rejected: {out}") from ex

    def set_cluster_mode(self, ip: str, port: int, mode: int) -> None:
        out = self.post(ip, port, "setClusterMode", {"mode": mode})
        if out != "success":
            raise ApiError(f"setClusterMode rejected: {out}")

    def modify_cluster_client_config(self, ip: str, port: int,
                                     server_host: str, server_port: int) -> None:
        self.post(ip, port, "cluster/client/modifyConfig",
                  body=json.dumps({"serverHost": server_host,
                                   "serverPort": server_port}))

    def modify_cluster_server_config(self, ip: str, port: int,
                                     token_port: int) -> None:
        self.post(ip, port, "cluster/server/modifyTransportConfig",
                  {"port": token_port})

    def fetch_cluster_server_config(self, ip: str, port: int) -> Dict:
        return json.loads(self.get(ip, port, "cluster/server/fetchConfig"))
