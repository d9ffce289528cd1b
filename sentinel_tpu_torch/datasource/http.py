"""HTTP-polling datasource: the Eureka / Spring-Cloud-Config / Apollo
shape (reference: ``sentinel-datasource-eureka`` /
``…-spring-cloud-config`` — SURVEY.md §2.2): periodically GET a config
URL, push on change. Change detection is conditional-request native:
``ETag``/``If-None-Match`` first, ``Last-Modified``/``If-Modified-Since``
second, so an unchanged poll costs one 304 round-trip and no conversion.

``MiniConfigHTTPServer`` is the in-repo fake — a minimal config endpoint
serving one document with proper ETag/304 semantics — used by tests and
demos; point the datasource at any real HTTP config endpoint and nothing
changes.

Port of ``sentinel_tpu/datasource/http.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import hashlib
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Optional

from sentinel_tpu_torch.datasource._mini_http import RestartableHTTPServer
from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource,
    Converter,
    T,
)


class HttpRefreshableDataSource(AutoRefreshDataSource[str, T]):
    """GET ``url`` every ``recommend_refresh_ms``; convert + push on 200,
    skip cheaply on 304. Network errors keep the last good rules and the
    poll loop alive (the reference's AutoRefresh stance)."""

    def __init__(self, url: str, converter: Converter,
                 recommend_refresh_ms: int = 3000,
                 timeout_s: float = 5.0,
                 headers: Optional[dict] = None,
                 retry_policy=None):
        super().__init__(converter, recommend_refresh_ms,
                         retry_policy=retry_policy)
        self.url = url
        self.timeout_s = timeout_s
        self.headers = dict(headers or {})
        self._etag: Optional[str] = None
        self._last_modified: Optional[str] = None
        self._pending: Optional[tuple] = None
        self._not_modified = False

    def read_source(self) -> Optional[str]:
        req = urllib.request.Request(self.url, headers=dict(self.headers))
        if self._etag:
            req.add_header("If-None-Match", self._etag)
        elif self._last_modified:
            req.add_header("If-Modified-Since", self._last_modified)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = resp.read().decode(
                    resp.headers.get_content_charset() or "utf-8")
                # Stage the validators; load_config commits them only
                # after the CONVERTER succeeds too — recording them any
                # earlier turns a mid-body or bad-document failure into a
                # poisoned cache (every later poll 304s against a document
                # that was never actually applied).
                self._pending = (resp.headers.get("ETag"),
                                 resp.headers.get("Last-Modified"))
                self._not_modified = False
                return body
        except urllib.error.HTTPError as ex:
            if ex.code == 304:
                self._not_modified = True
                return None  # unchanged: load_config pushes nothing
            raise

    def load_config(self):
        raw = self.read_source()
        if raw is None and self._not_modified:
            return None
        value = self.converter(raw)
        if self._pending is not None:
            self._etag, self._last_modified = self._pending
            self._pending = None
        return value


class _ConfigHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniConfigHTTPServer" = self.server  # type: ignore
        with server._lock:
            body, etag = server._body, server._etag
            server.request_count += 1
            if self.headers.get("If-None-Match") == etag:
                server.not_modified_count += 1
                self.send_response(304)
                self.send_header("ETag", etag)
                self.end_headers()
                return
        self.send_response(200)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("ETag", etag)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniConfigHTTPServer(RestartableHTTPServer):
    """One-document config endpoint with real ETag/304 semantics (the
    shared base adds stop()+start() same-port restartability)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port, _ConfigHandler)
        self._lock = threading.Lock()
        self._body = b"[]"
        self._etag = '"empty"'
        self.request_count = 0
        self.not_modified_count = 0

    @property
    def url(self) -> str:
        return f"{self.addr}/config"

    def set_document(self, text: str) -> None:
        raw = text.encode("utf-8")
        with self._lock:
            self._body = raw
            self._etag = '"%s"' % hashlib.sha1(raw).hexdigest()[:16]
