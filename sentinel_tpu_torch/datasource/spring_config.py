"""Spring Cloud Config datasource (reference:
``sentinel-datasource-spring-cloud-config`` — SURVEY.md §2.2): poll the
config server's environment endpoint and extract one property as the
rule document.

This speaks the actual Spring Cloud Config Server REST API, not a
Spring client:

- ``GET /{application}/{profile}[/{label}]`` (``Accept:
  application/json``) → the Environment representation
  ``{"name": ..., "profiles": [...], "label": ..., "version": "<scm
  rev>", "propertySources": [{"name": ..., "source": {k: v}}, ...]}``.
  Property sources are ordered **most-specific first**; the first source
  containing ``rule_key`` wins — exactly Spring's own precedence rule.
- Optional HTTP Basic auth (config servers are routinely basic-auth'd).

The reference module wires rule refresh through Spring's
``ContextRefresher`` events; outside a Spring container the wire-level
equivalent is this poll (the config-monitor webhook path ultimately also
lands in a client re-fetch of the same endpoint). Unchanged documents
push nothing (content dedup — the environment endpoint has no
conditional-request form, so every poll refetches; ``_version`` is kept
as ops-visible state only).

``MiniSpringConfigServer`` is the in-repo fake (layered property sources
with real precedence + version bumps); point the datasource at a real
config server and no line of the connector changes.

Port of ``sentinel_tpu/datasource/spring_config.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import base64
import json
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple

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
)


class SpringCloudConfigDataSource(ContentDedupPollMixin,
                                  AutoRefreshDataSource[str, T]):
    """Environment-endpoint poller with Spring source precedence."""

    def __init__(self, server_addr: str, application: str, rule_key: str,
                 converter: Converter, profile: str = "default",
                 label: Optional[str] = None,
                 auth: Optional[Tuple[str, str]] = None,
                 recommend_refresh_ms: int = 3000, timeout_s: float = 5.0,
                 retry_policy=None):
        super().__init__(converter, recommend_refresh_ms,
                         retry_policy=retry_policy)
        self.base = normalize_base(server_addr)
        self.application = application
        self.profile = profile
        self.label = label
        self.rule_key = rule_key
        self.timeout_s = timeout_s
        self._auth_header: Optional[str] = None
        if auth is not None:
            raw = ("%s:%s" % auth).encode("utf-8")
            self._auth_header = "Basic " + base64.b64encode(raw).decode()
        self._version: Optional[str] = None  # ops visibility (no
        # conditional form exists on this API, so it can't gate a fetch)

    # -- ReadableDataSource ------------------------------------------------

    def _endpoint(self) -> str:
        parts = [urllib.parse.quote(self.application),
                 urllib.parse.quote(self.profile)]
        if self.label:
            # Spring's slash convention: a '/' in a label (git branch
            # names like "release/1.2") must be sent as "(_)" or the
            # server reads it as an extra path segment.
            parts.append(urllib.parse.quote(
                self.label.replace("/", "(_)"), safe="()"))
        return self.base + "/" + "/".join(parts)

    def _fetch_environment(self) -> dict:
        req = urllib.request.Request(
            self._endpoint(), headers={"Accept": "application/json"})
        if self._auth_header:
            req.add_header("Authorization", self._auth_header)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    @staticmethod
    def _extract(env: dict, key: str) -> Optional[str]:
        """First (most-specific) property source containing ``key`` wins."""
        for ps in env.get("propertySources") or []:
            source = ps.get("source") or {}
            if key in source:
                value = source[key]
                return value if isinstance(value, str) else json.dumps(value)
        return None

    def read_source(self) -> Optional[str]:
        env = self._fetch_environment()
        self._version = env.get("version")
        return self._extract(env, self.rule_key)

    # load_config: ContentDedupPollMixin — the environment endpoint has
    # no conditional-request form, so every poll refetches; unchanged
    # bytes push nothing.


# -- in-repo fake server ------------------------------------------------------


class _SpringConfigHandler(JsonResponderMixin, BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniSpringConfigServer" = self.server  # type: ignore
        if server.auth is not None:
            raw = ("%s:%s" % server.auth).encode("utf-8")
            want = "Basic " + base64.b64encode(raw).decode()
            if self.headers.get("Authorization") != want:
                self.send_response(401)
                self.send_header("WWW-Authenticate", "Basic")
                self.end_headers()
                return
        parts = [urllib.parse.unquote(p)
                 for p in self.path.partition("?")[0].split("/") if p]
        if len(parts) not in (2, 3):
            return self._send_json(404, {"error": "not found"})
        app, profile = parts[0], parts[1]
        label = parts[2] if len(parts) == 3 else server.default_label
        label = label.replace("(_)", "/")  # Spring's slash convention
        with server._cond:
            server.request_count += 1
            # Spring precedence: app-profile beats app-default (profile
            # None marks a default source in the store key).
            tiers = sorted(
                ((0 if p is not None else 1, name, kv)
                 for (a, p, l, name), kv in server._sources.items()
                 if a == app and p in (profile, None) and l == label and kv),
                key=lambda t: t[0])
            sources = [{"name": name, "source": dict(kv)}
                       for _, name, kv in tiers]
            doc = {"name": app, "profiles": [profile], "label": label,
                   "version": server.version, "state": None,
                   "propertySources": sources}
        self._send_json(200, doc)

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniSpringConfigServer(RestartableHTTPServer):
    """Config-server environment subset with layered property sources.

    ``set_property(app, key, value, profile=None)`` writes into the
    app-profile source when ``profile`` is given, else the app default
    source (served to every profile) — and bumps ``version`` like a
    fresh SCM revision. State survives ``stop()``/``start()`` (the git
    repo behind a real server would too).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth: Optional[Tuple[str, str]] = None,
                 default_label: str = "main"):
        super().__init__(host, port, _SpringConfigHandler)
        self.auth = auth
        self.default_label = default_label
        # (app, profile-or-None, label, source-name) -> {key: value}
        self._sources: Dict[tuple, Dict[str, str]] = {}
        self._rev = 0
        self.request_count = 0

    @property
    def version(self) -> str:
        return "rev-%d" % self._rev

    def set_property(self, app: str, key: str, value: str,
                     profile: Optional[str] = None,
                     label: Optional[str] = None) -> None:
        label = label or self.default_label
        name = f"{app}-{profile}.yml" if profile else f"{app}.yml"
        with self._cond:
            self._sources.setdefault((app, profile, label, name), {})[key] = value
            self._rev += 1

    def delete_property(self, app: str, key: str,
                        profile: Optional[str] = None,
                        label: Optional[str] = None) -> None:
        label = label or self.default_label
        name = f"{app}-{profile}.yml" if profile else f"{app}.yml"
        with self._cond:
            self._sources.get((app, profile, label, name), {}).pop(key, None)
            self._rev += 1
