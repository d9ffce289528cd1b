"""Nacos config datasource: the HTTP long-poll push protocol (reference:
``sentinel-datasource-nacos``'s ``NacosDataSource`` — an initial config
GET plus a registered listener that Nacos's client library drives with
md5-keyed long-polling — SURVEY.md §2.2).

This speaks the actual Nacos 1.x open-api wire protocol, not an SDK:

- ``GET  /nacos/v1/cs/configs?dataId=&group=&tenant=`` → config body
  (200) or 404 when absent.
- ``POST /nacos/v1/cs/configs/listener`` with form field
  ``Listening-Configs = dataId ^2 group ^2 md5 [^2 tenant] ^1`` (the
  literal ``\\x02`` / ``\\x01`` separators, percent-encoded) and header
  ``Long-Pulling-Timeout: <ms>``. The server parks the request until the
  config's md5 differs from the submitted one (or the timeout elapses)
  and answers with the changed ``dataId%02group%01`` keys, percent-
  encoded — empty body = nothing changed.
- ``POST /nacos/v1/cs/configs`` with ``dataId``/``group``/``content``
  form fields publishes (the writable side).

The connector owns reconnect/backoff and md5 bookkeeping; a change
published while the poller was down is caught by the md5 mismatch on the
next listener round (the long-poll answers immediately), so delivery is
at-least-once across outages. Bad payloads keep the last good rules.

``MiniNacosServer`` is the in-repo fake (the three endpoints above with
real long-poll parking); point the datasource at a real Nacos and no
line of the connector changes.

Port of ``sentinel_tpu/datasource/nacos.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import hashlib
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

WORD_SEP = "\x02"   # Nacos: field separator inside one listening entry
LINE_SEP = "\x01"   # Nacos: entry terminator


def _md5_hex(content: str) -> str:
    return hashlib.md5(content.encode("utf-8")).hexdigest()


class NacosDataSource(ReconnectingWatchMixin, AbstractDataSource[str, T]):
    """Initial GET + md5 long-poll listener, with reconnect/backoff.

    ``poll_timeout_ms`` is the ``Long-Pulling-Timeout`` the listener
    advertises (Nacos default 30000; tests shrink it). The HTTP read
    timeout stretches past it so only a dead server — not a quiet one —
    trips the reconnect path.
    """

    _watch_exceptions = (OSError, urllib.error.URLError, ValueError)
    _watch_thread_name = "sentinel-nacos-listener"

    def __init__(self, server_addr: str, data_id: str, group: str,
                 converter: Converter, tenant: str = "",
                 poll_timeout_ms: int = 30000,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        self.base = normalize_base(server_addr)
        self.data_id, self.group, self.tenant = data_id, group, tenant
        self.poll_timeout_ms = poll_timeout_ms
        self._md5 = ""          # md5 of the last RECEIVED content ("" = none)
        self._init_watch(reconnect_backoff_ms)

    # -- ReadableDataSource ------------------------------------------------

    def read_source(self) -> Optional[str]:
        qs = urllib.parse.urlencode({
            "dataId": self.data_id, "group": self.group,
            "tenant": self.tenant})
        try:
            with urllib.request.urlopen(
                    f"{self.base}/nacos/v1/cs/configs?{qs}",
                    timeout=5.0) as resp:
                return resp.read().decode("utf-8")
        except urllib.error.HTTPError as ex:
            if ex.code == 404:
                return None  # config not published yet
            raise

    def start(self) -> "NacosDataSource":
        try:
            self._apply(self.read_source())
        except (OSError, urllib.error.URLError) as ex:
            _log_warn("nacos datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    # -- internals ---------------------------------------------------------

    def _apply(self, content: Optional[str]) -> None:
        if content is None or self._stop.is_set():
            return
        # md5 advances on RECEIPT, applied or not — the real client
        # library's bookkeeping (receive → update md5 → notify listener;
        # a listener error doesn't roll the md5 back). Advancing only on
        # successful conversion would make every later long-poll answer
        # instantly with the same drift: a zero-delay busy loop against
        # the server until someone publishes a good payload.
        self._md5 = _md5_hex(content)
        try:
            value = self.converter(content)
        except Exception as ex:  # keep last good rules
            _log_warn("nacos datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)

    def _listening_entry(self) -> str:
        fields = [self.data_id, self.group, self._md5]
        if self.tenant:
            fields.append(self.tenant)
        return WORD_SEP.join(fields) + LINE_SEP

    def _watch_round(self) -> None:
        """One listener round: park until change/timeout, GET on change."""
        body = urllib.parse.urlencode(
            {"Listening-Configs": self._listening_entry()})
        req = urllib.request.Request(
            f"{self.base}/nacos/v1/cs/configs/listener",
            data=body.encode("utf-8"),
            headers={"Long-Pulling-Timeout": str(self.poll_timeout_ms),
                     "Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(
                req, timeout=self.poll_timeout_ms / 1000.0 + 10.0) as resp:
            changed = urllib.parse.unquote(resp.read().decode("utf-8"))
        if changed.strip():
            # Changed keys arrived (we only ever listen to one); re-GET.
            content = self.read_source()
            if content is None:
                # Config DELETED server-side: record the absence (Nacos
                # md5 of an absent config is "") or every later round
                # reports the same drift instantly — the deletion twin of
                # the bad-payload busy loop. Last good rules are kept.
                self._md5 = ""
            else:
                self._apply(content)
        self._healthy()  # a completed round proves the server is up


class NacosWritableDataSource(WritableDataSource[T]):
    """Publish via ``POST /nacos/v1/cs/configs`` (the reference dashboard's
    ``DynamicRulePublisher`` shape for Nacos)."""

    def __init__(self, server_addr: str, data_id: str, group: str,
                 encoder: Converter, tenant: str = ""):
        self.base = normalize_base(server_addr)
        self.data_id, self.group, self.tenant = data_id, group, tenant
        self.encoder = encoder

    def write(self, value: T) -> None:
        body = urllib.parse.urlencode({
            "dataId": self.data_id, "group": self.group,
            "tenant": self.tenant, "content": self.encoder(value)})
        req = urllib.request.Request(
            f"{self.base}/nacos/v1/cs/configs", data=body.encode("utf-8"),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            if resp.read().decode("utf-8").strip() != "true":
                raise OSError("nacos publish rejected")


# -- in-repo fake server ------------------------------------------------------


class _NacosHandler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes = b"",
              ctype: str = "text/plain; charset=utf-8") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniNacosServer" = self.server  # type: ignore
        path, _, query = self.path.partition("?")
        if path != "/nacos/v1/cs/configs":
            return self._send(404, b"not found")
        q = urllib.parse.parse_qs(query)
        key = (q.get("dataId", [""])[0], q.get("group", [""])[0],
               q.get("tenant", [""])[0])
        with server._cond:
            content = server._configs.get(key)
        if content is None:
            return self._send(404, b"config data not exist")
        self._send(200, content.encode("utf-8"))

    def do_DELETE(self):  # noqa: N802 — http.server API
        server: "MiniNacosServer" = self.server  # type: ignore
        path, _, query = self.path.partition("?")
        if path != "/nacos/v1/cs/configs":
            return self._send(404, b"not found")
        q = urllib.parse.parse_qs(query)
        key = (q.get("dataId", [""])[0], q.get("group", [""])[0],
               q.get("tenant", [""])[0])
        with server._cond:
            server._configs.pop(key, None)
            server._cond.notify_all()
        self._send(200, b"true")

    def do_POST(self):  # noqa: N802 — http.server API
        server: "MiniNacosServer" = self.server  # type: ignore
        n = int(self.headers.get("Content-Length", "0"))
        form = urllib.parse.parse_qs(self.rfile.read(n).decode("utf-8"))
        if self.path == "/nacos/v1/cs/configs":
            key = (form.get("dataId", [""])[0], form.get("group", [""])[0],
                   form.get("tenant", [""])[0])
            content = form.get("content", [""])[0]
            with server._cond:
                server._configs[key] = content
                server._cond.notify_all()
            return self._send(200, b"true")
        if self.path == "/nacos/v1/cs/configs/listener":
            raw = form.get("Listening-Configs", [""])[0]
            timeout_ms = int(self.headers.get("Long-Pulling-Timeout",
                                              "30000"))
            timeout_s = min(timeout_ms, server.max_hold_ms) / 1000.0
            entries = []
            for line in raw.split(LINE_SEP):
                if not line:
                    continue
                f = line.split(WORD_SEP)
                if len(f) < 3:
                    return self._send(400, b"invalid probeModify")
                entries.append(((f[0], f[1], f[3] if len(f) > 3 else ""),
                                f[2]))

            def changed_keys():
                out = []
                for key, md5 in entries:
                    cur = server._configs.get(key)
                    cur_md5 = _md5_hex(cur) if cur is not None else ""
                    if cur_md5 != md5:
                        out.append(key)
                return out

            deadline = time.monotonic() + timeout_s
            with server._cond:
                server.poll_rounds += 1
                while True:
                    hits = changed_keys()
                    remaining = deadline - time.monotonic()
                    if hits or remaining <= 0 or server._stopping:
                        break
                    server._cond.wait(min(remaining, 0.25))
            body = "".join(
                urllib.parse.quote(
                    f"{d}{WORD_SEP}{g}"
                    + (f"{WORD_SEP}{t}" if t else "") + LINE_SEP)
                for d, g, t in hits)
            return self._send(200, body.encode("utf-8"))
        self._send(404, b"not found")

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniNacosServer(RestartableHTTPServer):
    """Nacos open-api config subset with real long-poll parking.

    ``stop()`` + ``start()`` rebinds the same port for reconnect tests;
    configs survive the restart (a real Nacos's do too).
    ``max_hold_ms`` caps how long a listener parks, so tests never wait a
    full client-advertised 30s.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_hold_ms: int = 30000):
        super().__init__(host, port, _NacosHandler)
        self.max_hold_ms = max_hold_ms
        self._configs: Dict[Tuple[str, str, str], str] = {}

    def publish(self, data_id: str, group: str, content: str,
                tenant: str = "") -> None:
        with self._cond:
            self._configs[(data_id, group, tenant)] = content
            self._cond.notify_all()

    def delete(self, data_id: str, group: str, tenant: str = "") -> None:
        with self._cond:
            self._configs.pop((data_id, group, tenant), None)
            self._cond.notify_all()
