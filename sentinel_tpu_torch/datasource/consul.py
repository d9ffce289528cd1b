"""Consul KV datasource: the blocking-query watch protocol (reference:
``sentinel-datasource-consul``'s ``ConsulDataSource`` — an initial KV get
plus a long-poll watch keyed on ``X-Consul-Index`` — SURVEY.md §2.2).

This speaks the actual Consul HTTP KV API, not an SDK:

- ``GET /v1/kv/<key>`` → JSON array of one entry
  ``{"Key": ..., "Value": <base64>, "ModifyIndex": N, ...}`` with the
  current index mirrored in the ``X-Consul-Index`` response header;
  404 when the key is absent (the header is still present).
- Blocking query: ``GET /v1/kv/<key>?index=<N>&wait=<dur>`` parks until
  ``ModifyIndex > N`` or the wait elapses, then answers with the current
  state (possibly unchanged — the caller compares indexes). ``wait``
  accepts Consul's duration syntax (``10s``, ``1m``).

The connector owns reconnect/backoff and index bookkeeping. Consul's
contract makes missed-update recovery automatic: whatever happened while
the watcher was down is visible in the first reply after reconnect
(state-based, not event-based). Bad payloads keep the last good rules.

``MiniConsulServer`` is the in-repo fake (KV subset with real blocking
queries and index semantics); point the datasource at a real Consul
agent and no line of the connector changes.

Port of ``sentinel_tpu/datasource/consul.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import base64
import json
import re
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


def _parse_wait(raw: str) -> float:
    """Consul duration (``10s`` / ``1m`` / bare seconds) → seconds."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h)?", raw.strip())
    if not m:
        raise ValueError(f"bad wait duration {raw!r}")
    scale = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
             None: 1.0}[m.group(2)]
    return float(m.group(1)) * scale


class ConsulDataSource(ReconnectingWatchMixin, AbstractDataSource[str, T]):
    """Initial get + index-keyed blocking-query watch loop.

    ``wait`` is the blocking-query duration advertised to the server
    (Consul default 5m; tests shrink it). The HTTP read timeout stretches
    past it so only a dead agent — not a quiet key — trips reconnect.
    """

    _watch_exceptions = (OSError, urllib.error.URLError, ValueError)
    _watch_thread_name = "sentinel-consul-watch"

    def __init__(self, agent_addr: str, key: str, converter: Converter,
                 wait: str = "30s", token: Optional[str] = None,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        self.base = normalize_base(agent_addr)
        self.key = key.lstrip("/")
        self.wait = wait
        # A typo'd duration must fail HERE, not inside every blocking
        # read (where the watch loop would swallow it as an endless
        # reconnect and silently never deliver updates).
        self._wait_s = _parse_wait(wait)
        self.token = token
        self._index = 0          # last X-Consul-Index seen
        self._applied = None     # raw content of the last APPLIED value
        self._init_watch(reconnect_backoff_ms)

    # -- ReadableDataSource ------------------------------------------------

    def _get(self, blocking: bool) -> Tuple[Optional[dict], int]:
        """One KV read → (entry-or-None, X-Consul-Index)."""
        params = {}
        if blocking:
            params = {"index": str(self._index), "wait": self.wait}
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        req = urllib.request.Request(
            f"{self.base}/v1/kv/{urllib.parse.quote(self.key)}{qs}")
        if self.token:
            req.add_header("X-Consul-Token", self.token)
        timeout = (self._wait_s + 10.0) if blocking else 5.0
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                idx = int(resp.headers.get("X-Consul-Index", "0"))
                entries = json.loads(resp.read().decode("utf-8"))
                return (entries[0] if entries else None), idx
        except urllib.error.HTTPError as ex:
            if ex.code == 404:
                idx = int(ex.headers.get("X-Consul-Index", "0") or 0)
                return None, idx
            raise

    def read_source(self) -> Optional[str]:
        entry, _ = self._get(blocking=False)
        if entry is None or entry.get("Value") is None:
            return None
        return base64.b64decode(entry["Value"]).decode("utf-8")

    def start(self) -> "ConsulDataSource":
        try:
            entry, idx = self._get(blocking=False)
            self._index = idx
            self._apply(entry)
        except (OSError, urllib.error.URLError, ValueError) as ex:
            _log_warn("consul datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    # -- internals ---------------------------------------------------------

    def _apply(self, entry: Optional[dict]) -> None:
        if entry is None or entry.get("Value") is None or self._stop.is_set():
            return
        try:
            content = base64.b64decode(entry["Value"]).decode("utf-8")
        except Exception as ex:
            _log_warn("consul datasource bad payload: %r", ex)
            return
        # Dedup on CONTENT, not ModifyIndex: a wait that elapses idle
        # re-delivers the same value (Consul's normal case), and an index
        # reset (leader change) can reuse an old index for NEW content —
        # only the bytes say whether anything actually changed.
        if content == self._applied:
            return
        try:
            value = self.converter(content)
        except Exception as ex:  # keep last good rules
            _log_warn("consul datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)
            self._applied = content

    def _watch_round(self) -> None:
        entry, idx = self._get(blocking=True)
        # Consul contract: a reset index (e.g. leader change / restarted
        # fake) must restart the watch from scratch.
        self._index = idx if idx >= self._index else 0
        self._apply(entry)
        self._healthy()


class ConsulWritableDataSource(WritableDataSource[T]):
    """Publish via ``PUT /v1/kv/<key>`` (raw body, like the reference's
    writer)."""

    def __init__(self, agent_addr: str, key: str, encoder: Converter,
                 token: Optional[str] = None):
        self.base = normalize_base(agent_addr)
        self.key = key.lstrip("/")
        self.encoder = encoder
        self.token = token

    def write(self, value: T) -> None:
        req = urllib.request.Request(
            f"{self.base}/v1/kv/{urllib.parse.quote(self.key)}",
            data=self.encoder(value).encode("utf-8"), method="PUT")
        if self.token:
            req.add_header("X-Consul-Token", self.token)
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            if resp.read().decode("utf-8").strip() != "true":
                raise OSError("consul put rejected")


# -- in-repo fake server ------------------------------------------------------


class _ConsulHandler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, index: int,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("X-Consul-Index", str(index))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        server: "MiniConsulServer" = self.server  # type: ignore
        path, _, query = self.path.partition("?")
        if not path.startswith("/v1/kv/"):
            return self._send(404, b"[]", 0)
        key = urllib.parse.unquote(path[len("/v1/kv/"):])
        q = urllib.parse.parse_qs(query)
        want_index = int(q.get("index", ["0"])[0] or 0)
        wait_s = 0.0
        if "index" in q:
            wait_s = min(_parse_wait(q.get("wait", ["5m"])[0]),
                         server.max_hold_ms / 1000.0)

        deadline = time.monotonic() + wait_s
        with server._cond:
            if wait_s > 0:
                server.poll_rounds += 1
            while True:
                entry = server._kv.get(key)
                cur = entry[1] if entry else 0
                remaining = deadline - time.monotonic()
                if (cur > want_index or remaining <= 0
                        or server._stopping):
                    break
                server._cond.wait(min(remaining, 0.25))
            global_index = server._index
            if entry is None:
                return self._send(404, b"[]", global_index)
            value, modify = entry
            body = json.dumps([{
                "Key": key,
                "Value": base64.b64encode(value).decode("ascii"),
                "ModifyIndex": modify, "CreateIndex": modify,
                "Flags": 0, "LockIndex": 0,
            }]).encode("utf-8")
        self._send(200, body, max(global_index, modify))

    def do_PUT(self):  # noqa: N802 — http.server API
        server: "MiniConsulServer" = self.server  # type: ignore
        path = self.path.partition("?")[0]
        if not path.startswith("/v1/kv/"):
            return self._send(404, b"false", 0)
        key = urllib.parse.unquote(path[len("/v1/kv/"):])
        n = int(self.headers.get("Content-Length", "0"))
        value = self.rfile.read(n)
        with server._cond:
            server._index += 1
            server._kv[key] = (value, server._index)
            server._cond.notify_all()
            idx = server._index
        self._send(200, b"true", idx)

    def log_message(self, fmt, *args):  # quiet
        pass


class MiniConsulServer(RestartableHTTPServer):
    """Consul KV subset with real blocking queries and index semantics.

    ``stop()`` + ``start()`` rebinds the same port for reconnect tests;
    the KV (and its indexes) survive the restart, like a real agent
    backed by its servers. ``max_hold_ms`` caps blocking-query parking so
    tests never wait a client-advertised 5m.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_hold_ms: int = 30000):
        super().__init__(host, port, _ConsulHandler)
        self.max_hold_ms = max_hold_ms
        self._kv: Dict[str, Tuple[bytes, int]] = {}  # key -> (value, index)
        self._index = 0

    def put(self, key: str, value: str) -> None:
        with self._cond:
            self._index += 1
            self._kv[key.lstrip("/")] = (value.encode("utf-8"), self._index)
            self._cond.notify_all()
