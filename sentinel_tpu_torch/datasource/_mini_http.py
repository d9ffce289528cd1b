"""Shared plumbing for the HTTP-speaking connectors and their in-repo
fake servers (Nacos / Consul): base-URL normalization and a
``ThreadingHTTPServer`` that can stop and rebind the SAME port, so
reconnect paths are testable against a "restarted" server.

Port of ``sentinel_tpu/datasource/_mini_http.py``: the same classes, importing
only this package.
"""

from __future__ import annotations

import socket
import threading
from http.server import ThreadingHTTPServer
from typing import Optional


class JsonResponderMixin:
    """``_send_json`` for fake-server handlers that speak plain JSON
    (mix in ahead of ``BaseHTTPRequestHandler``)."""

    def _send_json(self, code: int, doc) -> None:
        import json

        body = json.dumps(doc).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def normalize_base(addr: str) -> str:
    """``host:port`` or URL → scheme-ful base with no trailing slash."""
    base = addr.rstrip("/")
    if not base.startswith(("http://", "https://")):
        # Full-scheme check: a bare hostname like "httpd-gw:8848" must
        # still get a scheme, or urllib parses "httpd-gw" as one.
        base = "http://" + base
    return base


class RestartableHTTPServer(ThreadingHTTPServer):
    """Fake-server base: background serve thread, condition-variable state
    for long-poll parking, and ``stop()``/``start()`` cycles that rebind
    the same resolved port (pinned in ``server_address`` by the first
    bind) — state held in subclass fields survives, like a real config
    server's backing store would.
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, host: str, port: int, handler) -> None:
        super().__init__((host, port), handler)
        self._cond = threading.Condition()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self.poll_rounds = 0  # long-poll/blocking-query rounds served

    @property
    def addr(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"

    def start(self) -> "RestartableHTTPServer":
        self._stopping = False
        if self.socket.fileno() == -1:
            # Restart after stop(): fresh socket, same pinned port.
            self.socket = socket.socket(self.address_family,
                                        self.socket_type)
            self.server_bind()
            self.server_activate()
        # A 50 ms poll (the stdlib's default is 500 ms) bounds how long
        # stop() waits for the serve loop to notice its shutdown.
        self._thread = threading.Thread(
            target=self.serve_forever, kwargs={"poll_interval": 0.05},
            name=f"mini-{type(self).__name__.lower()}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()  # release parked long-polls promptly
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
