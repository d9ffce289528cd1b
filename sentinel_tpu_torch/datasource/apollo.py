"""Apollo config datasource: the notifications/v2 long-poll protocol
(reference: ``sentinel-datasource-apollo``'s ``ApolloDataSource`` — the
Apollo client's ``ConfigChangeListener`` on one property key inside a
namespace, here spoken directly over Apollo's meta/config-service HTTP
wire — SURVEY.md §2.2).

The three real endpoints (no Apollo SDK):

- ``GET /notifications/v2?appId=&cluster=&notifications=[{"namespaceName":
  ..., "notificationId": ...}]`` — the server parks the request until the
  namespace's notification id advances past the submitted one (or ~60s),
  then answers 200 with the new ids; 304 = nothing changed, poll again.
- ``GET /configs/{appId}/{cluster}/{namespace}?releaseKey=`` — the full
  released key→value map as JSON; 304 when ``releaseKey`` still matches
  (the client echoes the last seen release, exactly like the real one).
- the open-api item+release pair (``POST/PUT …/items/…`` then
  ``POST …/releases``) — the writable side, mirroring the reference
  dashboard's ``ApolloOpenApiClient`` publisher: rule edits land in the
  namespace's working copy and become visible only on release, which is
  Apollo's actual durability model.

Like the reference, the datasource reads ONE property key (e.g.
``flowRules``) out of the namespace; other keys in the same namespace are
ignored. Delivery is at-least-once across outages: the notification id
comparison on reconnect answers immediately if anything was missed, and
the releaseKey echo suppresses no-op re-reads. Bad payloads keep the
last good rules.

``MiniApolloServer`` is the in-repo fake (the endpoints above with real
long-poll parking and working-copy/release separation); point the
datasource at a real Apollo config service and no line changes.

Port of ``sentinel_tpu/datasource/apollo.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple

from sentinel_tpu_torch.datasource._mini_http import (
    RestartableHTTPServer,
    normalize_base,
)
from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    Converter,
    ReconnectingWatchMixin,
    T,
    WritableDataSource,
    _log_warn,
)

NOTIFICATION_INIT = -1  # Apollo: "never seen any release" sentinel


class ApolloDataSource(ReconnectingWatchMixin, AbstractDataSource[str, T]):
    """Initial config GET + notifications/v2 long-poll, reconnect/backoff.

    ``poll_timeout_ms`` bounds one long-poll round client-side (Apollo
    servers hold ~60s; tests shrink it via the fake's ``max_hold_ms``).
    """

    _watch_exceptions = (OSError, urllib.error.URLError, ValueError)
    _watch_thread_name = "sentinel-apollo-listener"

    def __init__(self, server_addr: str, app_id: str, namespace: str,
                 rule_key: str, converter: Converter,
                 cluster: str = "default", poll_timeout_ms: int = 60000,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        self.base = normalize_base(server_addr)
        self.app_id, self.cluster = app_id, cluster
        self.namespace, self.rule_key = namespace, rule_key
        self.poll_timeout_ms = poll_timeout_ms
        self._notification_id = NOTIFICATION_INIT
        self._release_key = ""
        self._init_watch(reconnect_backoff_ms)

    # -- ReadableDataSource ------------------------------------------------

    def read_source(self) -> Optional[str]:
        """The rule key's current released value (None if absent)."""
        cfg = self._fetch_config(release_key="")
        if cfg is None:
            return None
        return cfg.get("configurations", {}).get(self.rule_key)

    def start(self) -> "ApolloDataSource":
        try:
            self._apply_config(self._fetch_config(release_key=""))
        except (OSError, urllib.error.URLError) as ex:
            _log_warn("apollo datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    # -- internals ---------------------------------------------------------

    def _fetch_config(self, release_key: Optional[str] = None
                      ) -> Optional[dict]:
        """``GET /configs/...``; None on 404 (namespace never released)
        or 304 (releaseKey unchanged)."""
        if release_key is None:
            release_key = self._release_key
        qs = urllib.parse.urlencode({"releaseKey": release_key})
        url = (f"{self.base}/configs/{urllib.parse.quote(self.app_id)}/"
               f"{urllib.parse.quote(self.cluster)}/"
               f"{urllib.parse.quote(self.namespace)}?{qs}")
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as ex:
            if ex.code in (304, 404):
                return None
            raise

    def _apply_config(self, cfg: Optional[dict]) -> None:
        if cfg is None or self._stop.is_set():
            # stop guard: a straggler round completing after close() must
            # not mutate rules under a caller that shut the source down
            return
        # releaseKey advances on RECEIPT, applied or not (the Apollo
        # client's bookkeeping) — advancing only on successful conversion
        # would busy-loop the config fetch on a bad payload.
        self._release_key = cfg.get("releaseKey", "")
        raw = cfg.get("configurations", {}).get(self.rule_key)
        if raw is None:
            return  # rule key absent in this release: keep last good
        try:
            value = self.converter(raw)
        except Exception as ex:  # keep last good rules
            _log_warn("apollo datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)

    def _watch_round(self) -> None:
        """One notifications/v2 round: park, then fetch on change."""
        notifications = json.dumps([{
            "namespaceName": self.namespace,
            "notificationId": self._notification_id}])
        qs = urllib.parse.urlencode({
            "appId": self.app_id, "cluster": self.cluster,
            "notifications": notifications})
        try:
            with urllib.request.urlopen(
                    f"{self.base}/notifications/v2?{qs}",
                    timeout=self.poll_timeout_ms / 1000.0 + 10.0) as resp:
                changed = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as ex:
            if ex.code == 304:  # quiet round: the server is fine
                self._healthy()
                return
            raise
        for note in changed:
            if note.get("namespaceName") != self.namespace:
                continue
            # Fetch BEFORE advancing the id: if the config GET fails here
            # (server blip right after the notify), the mixin reconnects
            # and the next poll re-submits the OLD id, so the server
            # re-answers immediately and the release is re-delivered —
            # advancing first would mark it seen and silently skip it
            # until some future release (breaking at-least-once).
            self._apply_config(self._fetch_config())
            self._notification_id = note.get("notificationId",
                                             self._notification_id)
        self._healthy()


class ApolloWritableDataSource(WritableDataSource[T]):
    """Open-api item upsert + release (the reference dashboard publisher's
    ``ApolloOpenApiClient`` two-step: a written item is invisible until
    released)."""

    def __init__(self, server_addr: str, app_id: str, namespace: str,
                 rule_key: str, encoder: Converter, cluster: str = "default",
                 env: str = "DEV", token: str = ""):
        self.base = normalize_base(server_addr)
        self.app_id, self.cluster = app_id, cluster
        self.namespace, self.rule_key = namespace, rule_key
        self.encoder = encoder
        self.env, self.token = env, token

    def _open_api(self, tail: str) -> str:
        return (f"{self.base}/openapi/v1/envs/{urllib.parse.quote(self.env)}"
                f"/apps/{urllib.parse.quote(self.app_id)}"
                f"/clusters/{urllib.parse.quote(self.cluster)}"
                f"/namespaces/{urllib.parse.quote(self.namespace)}{tail}")

    def _call(self, method: str, url: str, payload: dict) -> int:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode("utf-8"), method=method,
            headers={"Content-Type": "application/json;charset=UTF-8",
                     "Authorization": self.token})
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return resp.status
        except urllib.error.HTTPError as ex:
            return ex.code

    def write(self, value: T) -> None:
        item = {"key": self.rule_key, "value": self.encoder(value),
                "dataChangeCreatedBy": "sentinel"}
        # PUT updates an existing item; 404 = first write, POST creates.
        code = self._call(
            "PUT", self._open_api(f"/items/{urllib.parse.quote(self.rule_key)}"
                                  "?createIfNotExists=false"), item)
        if code == 404:
            code = self._call("POST", self._open_api("/items"), item)
        if code not in (200, 201):
            raise OSError(f"apollo item write rejected ({code})")
        code = self._call("POST", self._open_api("/releases"), {
            "releaseTitle": "sentinel-rule-push",
            "releasedBy": "sentinel"})
        if code not in (200, 201):
            raise OSError(f"apollo release rejected ({code})")


# -- in-repo fake server ------------------------------------------------------


class _ApolloHandler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes = b"",
              ctype: str = "application/json;charset=UTF-8") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode("utf-8"))

    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniApolloServer" = self.server  # type: ignore
        path, _, query = self.path.partition("?")
        q = urllib.parse.parse_qs(query)
        parts = [urllib.parse.unquote(p) for p in path.split("/") if p]
        if parts[:1] == ["notifications"] and parts[1:2] == ["v2"]:
            return self._long_poll(server, q)
        if parts[:1] == ["configs"] and len(parts) == 4:
            _, app_id, cluster, namespace = parts
            key = (app_id, cluster, namespace)
            with server._cond:
                ns = server._released.get(key)
            if ns is None:
                return self._json(404, {"message": "namespace not found"})
            release_key, configurations = ns
            if q.get("releaseKey", [""])[0] == release_key:
                return self._send(304)
            return self._json(200, {
                "appId": app_id, "cluster": cluster,
                "namespaceName": namespace,
                "configurations": configurations,
                "releaseKey": release_key})
        self._json(404, {"message": "not found"})

    def _long_poll(self, server: "MiniApolloServer", q) -> None:
        app_id = q.get("appId", [""])[0]
        cluster = q.get("cluster", ["default"])[0]
        try:
            wanted = json.loads(q.get("notifications", ["[]"])[0])
        except ValueError:
            return self._json(400, {"message": "bad notifications"})
        deadline = time.monotonic() + server.max_hold_ms / 1000.0

        def changed():
            out = []
            for note in wanted:
                ns = note.get("namespaceName", "")
                seen = note.get("notificationId", NOTIFICATION_INIT)
                cur = server._notifications.get((app_id, cluster, ns), 0)
                if cur > seen:
                    out.append({"namespaceName": ns, "notificationId": cur})
            return out

        with server._cond:
            server.poll_rounds += 1
            while True:
                hits = changed()
                remaining = deadline - time.monotonic()
                if hits or remaining <= 0 or server._stopping:
                    break
                server._cond.wait(min(remaining, 0.25))
        if hits:
            return self._json(200, hits)
        self._send(304)

    def do_POST(self):  # noqa: N802 — http.server API
        self._open_api_write(create=True)

    def do_PUT(self):  # noqa: N802 — http.server API
        self._open_api_write(create=False)

    def _open_api_write(self, create: bool) -> None:
        server: "MiniApolloServer" = self.server  # type: ignore
        parts = [urllib.parse.unquote(p)
                 for p in self.path.partition("?")[0].split("/") if p]
        # /openapi/v1/envs/{env}/apps/{app}/clusters/{c}/namespaces/{ns}/…
        if parts[:2] != ["openapi", "v1"] or len(parts) < 10:
            return self._json(404, {"message": "not found"})
        app_id, cluster, namespace = parts[5], parts[7], parts[9]
        key = (app_id, cluster, namespace)
        n = int(self.headers.get("Content-Length", "0"))
        try:
            payload = json.loads(self.rfile.read(n).decode("utf-8") or "{}")
        except ValueError:
            return self._json(400, {"message": "bad json"})
        if server.token and \
                self.headers.get("Authorization", "") != server.token:
            return self._json(401, {"message": "unauthorized"})
        tail = parts[10:]
        if tail[:1] == ["items"]:
            item_key = tail[1] if len(tail) > 1 else payload.get("key", "")
            with server._cond:
                items = server._working.setdefault(key, {})
                if not create and item_key not in items:
                    return self._json(404, {"message": "item not found"})
                items[item_key or payload.get("key", "")] = \
                    payload.get("value", "")
            return self._json(200, payload)
        if tail[:1] == ["releases"]:
            server.release(app_id, cluster, namespace)
            return self._json(200, {"releaseTitle":
                                    payload.get("releaseTitle", "")})
        self._json(404, {"message": "not found"})

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniApolloServer(RestartableHTTPServer):
    """Apollo config-service + open-api subset with real long-poll parking
    and working-copy/release separation. ``stop()``/``start()`` rebinds
    the same port; released configs and notification ids survive (a real
    Apollo's would too). ``max_hold_ms`` caps listener parking for tests.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_hold_ms: int = 60000, token: str = ""):
        super().__init__(host, port, _ApolloHandler)
        self.max_hold_ms = max_hold_ms
        self.token = token
        # (appId, cluster, ns) -> (releaseKey, {key: value})  [released]
        self._released: Dict[Tuple[str, str, str],
                             Tuple[str, Dict[str, str]]] = {}
        # (appId, cluster, ns) -> {key: value}                [unreleased]
        self._working: Dict[Tuple[str, str, str], Dict[str, str]] = {}
        self._notifications: Dict[Tuple[str, str, str], int] = {}
        self._release_seq = 0

    def publish(self, app_id: str, namespace: str, key: str, value: str,
                cluster: str = "default") -> None:
        """Write + release in one step (as the open-api two-step would)."""
        k = (app_id, cluster, namespace)
        with self._cond:
            self._working.setdefault(k, {})[key] = value
        self.release(app_id, cluster, namespace)

    def release(self, app_id: str, cluster: str, namespace: str) -> None:
        k = (app_id, cluster, namespace)
        with self._cond:
            self._release_seq += 1
            working = dict(self._working.get(k, {}))
            self._released[k] = (f"release-{self._release_seq}", working)
            self._notifications[k] = self._release_seq
            self._cond.notify_all()
