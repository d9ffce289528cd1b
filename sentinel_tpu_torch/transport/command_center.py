"""Embedded HTTP command center (port of
``sentinel_tpu/transport/command_center.py``; reference:
``sentinel-transport-common``'s ``CommandHandler``/``@CommandMapping`` SPI
+ ``sentinel-transport-simple-http``'s ``SimpleHttpCommandCenter``,
SURVEY.md §2.3).

One handler per command name, dispatched on the URL path
(``GET /version``, ``GET /getRules?type=flow``, ``POST /setRules``, ...).
Responses are the reference's plain-text/JSON bodies so dashboard and curl
tooling transfer. The server is a stdlib ``ThreadingHTTPServer`` on the
configured ``csp.sentinel.api.port`` (default 8719; pass ``port=0`` for an
ephemeral one). The command registry is the port's own: the JAX package's
handlers are never registered here.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.core.config import config


@dataclass
class CommandRequest:
    """Reference: ``CommandRequest`` — parameters + optional body.

    ``engine`` / ``center`` are injected by the dispatching command center so
    handlers act on *that* server's engine (several centers can coexist, and
    a center built without an explicit engine follows the live default one).
    """

    parameters: Dict[str, str] = field(default_factory=dict)
    body: str = ""
    engine: object = None
    center: object = None

    def get_param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        v = self.parameters.get(name)
        return v if v not in (None, "") else default


@dataclass
class CommandResponse:
    """Reference: ``CommandResponse`` — success flag + result string.

    ``content_type`` lets non-JSON commands (the OpenMetrics ``metrics``
    exposition) declare their media type; the default matches the
    reference's plain-text bodies.
    """

    success: bool
    result: str
    content_type: str = "text/plain; charset=utf-8"

    @classmethod
    def of_success(cls, result) -> "CommandResponse":
        if not isinstance(result, str):
            result = json.dumps(result)
        return cls(True, result)

    @classmethod
    def of_failure(cls, message: str) -> "CommandResponse":
        return cls(False, message)


Handler = Callable[[CommandRequest], CommandResponse]

_registry: Dict[str, Handler] = {}
_descriptions: Dict[str, str] = {}


def command_mapping(name: str, desc: str = ""):
    """Register a handler under a command name (``@CommandMapping`` analog)."""

    def deco(fn: Handler) -> Handler:
        _registry[name] = fn
        _descriptions[name] = desc
        return fn

    return deco


def get_handler(name: str) -> Optional[Handler]:
    return _registry.get(name)


def registered_commands() -> Dict[str, str]:
    return dict(_descriptions)


def dispatch_command(center, path: str, body: str):
    """Shared request->handler dispatch: ``(status_code, text, ctype)``.

    Used by both transports (threaded simple-http here, the event-loop
    center in ``aio_command_center.py``) so command semantics cannot
    drift between them."""
    plain = "text/plain; charset=utf-8"
    parsed = urllib.parse.urlparse(path)
    name = parsed.path.strip("/")
    params = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
    # Reference simple-http also accepts form-encoded bodies as params.
    if body and "=" in body and not body.lstrip().startswith(("[", "{")):
        for k, v in urllib.parse.parse_qs(body).items():
            params.setdefault(k, v[0])
        body = ""
    handler = get_handler(name)
    if handler is None:
        return 400, f"Unknown command `{name}`", plain
    try:
        resp = handler(CommandRequest(parameters=params, body=body,
                                      engine=center.engine, center=center))
    except Exception as ex:
        return 500, f"command error: {ex!r}", plain
    return (200 if resp.success else 400), resp.result, resp.content_type


class _HttpHandler(BaseHTTPRequestHandler):
    server_version = "sentinel-tpu"

    def log_message(self, fmt, *args):  # quiet; ops logs go to record_log
        pass

    def _dispatch(self, body: str):
        code, text, ctype = dispatch_command(self.server.command_center,
                                             self.path, body)
        self._reply(code, text, ctype)

    def _reply(self, code: int, text: str,
               ctype: str = "text/plain; charset=utf-8"):
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("")

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length).decode("utf-8") if length else ""
        self._dispatch(body)


class CommandCenter:
    """The embedded command server (``SimpleHttpCommandCenter`` analog).

    Binds ``csp.sentinel.api.host``, defaulting to 127.0.0.1: the command
    plane is unauthenticated (``setRules``/``setSwitch`` can disable all
    protection), so exposing it beyond loopback is an explicit operator
    decision via config, not a default. Without an explicit ``engine`` the
    center follows the process-default engine, surviving
    ``sentinel_tpu_torch.reset()``.
    """

    def __init__(self, engine=None, port: Optional[int] = None,
                 host: Optional[str] = None):
        # Importing handlers registers the default command set (SPI analog).
        from sentinel_tpu_torch.transport import handlers as _h  # noqa: F401

        self._engine = engine
        self.host = host or config.get("csp.sentinel.api.host") or "127.0.0.1"
        self.port = port if port is not None else config.api_port()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        import sentinel_tpu_torch

        return sentinel_tpu_torch.get_engine()

    @property
    def bound_port(self) -> int:
        return self._server.server_address[1] if self._server else self.port

    def start(self) -> "CommandCenter":
        self._server = ThreadingHTTPServer((self.host, self.port), _HttpHandler)
        self._server.command_center = self
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="sentinel-command-center", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
