"""Eureka datasource: rules carried in instance **metadata** (reference:
``sentinel-datasource-eureka``'s ``EurekaDataSource`` — poll
``GET {serviceUrl}/apps/{appId}/{instanceId}`` across a failover list of
service URLs and extract ``instance.metadata[ruleKey]`` — SURVEY.md §2.2).

This speaks the actual Eureka REST API (JSON representation), not an SDK:

- ``GET /apps/<APP>/<instanceId>`` with ``Accept: application/json`` →
  ``{"instance": {"instanceId": ..., "app": "<APP>", "status": "UP",
  "metadata": {"<ruleKey>": "<rules json>", ...}, ...}}``; 404 when the
  instance is not registered.
- ``PUT /apps/<APP>/<instanceId>/metadata?<key>=<value>`` updates one
  metadata entry (the writable path).

Reference semantics preserved: the service-URL list is tried in order
with sticky failover (stay on the first URL that answers; rotate on
error), polling is ``AutoRefreshDataSource``-shaped (default 3s), bad or
missing payloads keep the last good rules, and unchanged metadata pushes
nothing (content dedup — Eureka has no change-index to key on).

``MiniEurekaServer`` is the in-repo fake (apps registry subset with real
JSON representation + metadata PUT); point the datasource at a real
Eureka server and no line of the connector changes.

Port of ``sentinel_tpu/datasource/eureka.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Sequence

from sentinel_tpu_torch.datasource._mini_http import (
    JsonResponderMixin,
    RestartableHTTPServer,
    normalize_base,
)
from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource,
    ContentDedupPollMixin,
    Converter,
    T,
    WritableDataSource,
)


class EurekaDataSource(ContentDedupPollMixin, AutoRefreshDataSource[str, T]):
    """Poll instance metadata across a failover list of service URLs.

    ``service_urls`` mirrors the reference constructor's ``serviceUrls``
    (each the Eureka context base, e.g. ``http://host:8761/eureka``).
    The poller is sticky: it stays on the URL that last answered and
    advances to the next only on a network error, so one dead replica
    costs one failed request per poll at worst, not per-request fanout.
    """

    def __init__(self, service_urls: Sequence[str], app_id: str,
                 instance_id: str, rule_key: str, converter: Converter,
                 recommend_refresh_ms: int = 3000, timeout_s: float = 5.0,
                 retry_policy=None):
        super().__init__(converter, recommend_refresh_ms,
                         retry_policy=retry_policy)
        if not service_urls:
            raise ValueError("service_urls can't be empty")
        self.service_urls = [normalize_base(u) for u in service_urls]
        self.app_id = app_id
        self.instance_id = instance_id
        self.rule_key = rule_key
        self.timeout_s = timeout_s
        self._url_idx = 0
        self.failover_count = 0  # ops visibility + test hook

    # -- ReadableDataSource ------------------------------------------------

    def _instance_url(self, base: str) -> str:
        return "%s/apps/%s/%s" % (
            base,
            urllib.parse.quote(self.app_id),
            urllib.parse.quote(self.instance_id),
        )

    def _fetch_one(self, base: str) -> Optional[str]:
        """One service URL → metadata[rule_key] (None when unregistered
        or key absent — both keep last good rules, like the reference)."""
        req = urllib.request.Request(
            self._instance_url(base), headers={"Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as ex:
            if ex.code == 404:
                return None
            raise
        meta = (doc.get("instance") or {}).get("metadata") or {}
        value = meta.get(self.rule_key)
        return value if isinstance(value, str) else None

    def read_source(self) -> Optional[str]:
        """Sticky-failover read: every URL gets one try per poll; the
        poll fails (and the auto-refresh loop logs + survives) only when
        ALL replicas are down."""
        last_err: Optional[Exception] = None
        for attempt in range(len(self.service_urls)):
            base = self.service_urls[self._url_idx]
            try:
                return self._fetch_one(base)
            except (OSError, urllib.error.URLError, ValueError) as ex:
                last_err = ex
                self._url_idx = (self._url_idx + 1) % len(self.service_urls)
                self.failover_count += 1
        raise last_err if last_err is not None else OSError("no replicas")

    # load_config: ContentDedupPollMixin — Eureka has no ModifyIndex/
    # releaseKey, so the bytes are the only change signal; an absent
    # instance/key keeps the last good rules rather than clearing them.


class EurekaWritableDataSource(WritableDataSource[T]):
    """Publish via ``PUT /apps/<APP>/<id>/metadata?<ruleKey>=<encoded>``
    (Eureka's real metadata-update endpoint — the value rides a query
    parameter, so it is URL-encoded).

    Size limitation (inherent to the endpoint, not this client): the
    whole encoded rule document travels in the request URL, and common
    servers/proxies cap URLs around 8KB — a few hundred JSON rules.
    Writes whose URL exceeds ``max_url_bytes`` (default 7KB, leaving
    headroom under the usual 8KB cap) raise ``ValueError`` up front
    rather than failing opaquely server-side; raise the limit only if
    every hop to your Eureka server is known to accept more."""

    def __init__(self, service_url: str, app_id: str, instance_id: str,
                 rule_key: str, encoder: Converter, timeout_s: float = 5.0,
                 max_url_bytes: int = 7168):
        self.base = normalize_base(service_url)
        self.app_id = app_id
        self.instance_id = instance_id
        self.rule_key = rule_key
        self.encoder = encoder
        self.timeout_s = timeout_s
        self.max_url_bytes = max_url_bytes

    def write(self, value: T) -> None:
        qs = urllib.parse.urlencode({self.rule_key: self.encoder(value)})
        url = "%s/apps/%s/%s/metadata?%s" % (
            self.base, urllib.parse.quote(self.app_id),
            urllib.parse.quote(self.instance_id), qs)
        if len(url.encode("utf-8")) > self.max_url_bytes:
            raise ValueError(
                "eureka metadata write: encoded URL is "
                f"{len(url.encode('utf-8'))} bytes > max_url_bytes="
                f"{self.max_url_bytes}; Eureka's metadata endpoint rides "
                "the query string and servers/proxies commonly cap URLs "
                "~8KB — shrink the rule set or use another datasource")
        req = urllib.request.Request(url, method="PUT")
        # urlopen raises on >=400; any 2xx (200 or a proxy's 204) is a
        # successful write.
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            if not (200 <= resp.status < 300):
                raise OSError(f"eureka metadata put -> {resp.status}")


# -- in-repo fake server ------------------------------------------------------


class _EurekaHandler(JsonResponderMixin, BaseHTTPRequestHandler):
    def _parse_instance_path(self, path: str):
        # /<context…>/apps/<APP>/<instanceId>[/metadata] — real service
        # URLs carry a context base ("/eureka" or "/eureka/v2"); anything
        # before the "apps" segment is that context.
        parts = [urllib.parse.unquote(p) for p in path.split("/") if p]
        if "apps" in parts:
            parts = parts[parts.index("apps"):]
        if len(parts) >= 3 and parts[0] == "apps":
            return parts[1].upper(), parts[2], parts[3:]
        return None, None, None

    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniEurekaServer" = self.server  # type: ignore
        path = self.path.partition("?")[0]
        app, inst, rest = self._parse_instance_path(path)
        if app is None or rest:
            return self._send_json(404, {"error": "not found"})
        with server._cond:
            server.request_count += 1
            meta = server._apps.get((app, inst))
            if meta is None:
                return self._send_json(404, {"error": "instance not found"})
            doc = {"instance": {
                "instanceId": inst, "app": app, "status": "UP",
                "hostName": "127.0.0.1", "ipAddr": "127.0.0.1",
                "metadata": dict(meta),
            }}
        self._send_json(200, doc)

    def do_PUT(self):  # noqa: N802 — http.server API
        server: "MiniEurekaServer" = self.server  # type: ignore
        path, _, query = self.path.partition("?")
        app, inst, rest = self._parse_instance_path(path)
        if app is None or rest != ["metadata"]:
            return self._send_json(404, {"error": "not found"})
        updates = {k: v[0] for k, v in
                   urllib.parse.parse_qs(query, keep_blank_values=True).items()}
        with server._cond:
            meta = server._apps.get((app, inst))
            if meta is None:
                return self._send_json(404, {"error": "instance not found"})
            meta.update(updates)
        self._send_json(200, {"ok": True})

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniEurekaServer(RestartableHTTPServer):
    """Eureka apps-registry subset: JSON instance representation +
    metadata PUT. App names are case-normalized to upper like the real
    server. The registry survives ``stop()``/``start()`` cycles (restart
    = same replica coming back with its registry intact)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port, _EurekaHandler)
        self._apps: Dict[tuple, Dict[str, str]] = {}
        self.request_count = 0

    @property
    def service_url(self) -> str:
        return f"{self.addr}/eureka"

    def register(self, app_id: str, instance_id: str,
                 metadata: Optional[Dict[str, str]] = None) -> None:
        with self._cond:
            self._apps[(app_id.upper(), instance_id)] = dict(metadata or {})

    def set_metadata(self, app_id: str, instance_id: str,
                     key: str, value: str) -> None:
        with self._cond:
            self._apps[(app_id.upper(), instance_id)][key] = value

    def metadata(self, app_id: str, instance_id: str) -> Dict[str, str]:
        with self._cond:
            return dict(self._apps[(app_id.upper(), instance_id)])
