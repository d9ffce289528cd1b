"""Event-loop command center (port of
``sentinel_tpu/transport/aio_command_center.py``; reference:
``sentinel-transport-netty-http``'s ``NettyHttpCommandCenter``, SURVEY.md
§2.3).

The reference ships TWO transports over one command-handler SPI: a
thread-per-connection simple-http server and a Netty event-loop server.
This is the event-loop twin of ``command_center.CommandCenter``: one
asyncio server task serves every connection (keep-alive supported), with
handler dispatch shared via :func:`~sentinel_tpu_torch.transport.
command_center.dispatch_command` so the two transports cannot drift.

Two entry styles, mirroring how Netty servers get embedded:

  * sync apps: ``AsyncCommandCenter(engine).start()`` spawns one daemon
    thread running a private event loop;
  * asyncio apps: ``await AsyncCommandCenter(engine).start_async()``
    serves on the caller's loop.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.transport.command_center import dispatch_command

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 4 * 1024 * 1024


class AsyncCommandCenter:
    def __init__(self, engine=None, port: Optional[int] = None,
                 host: Optional[str] = None):
        from sentinel_tpu_torch.transport import handlers as _h  # noqa: F401

        self._engine = engine
        self.host = host or config.get("csp.sentinel.api.host") or "127.0.0.1"
        self.port = port if port is not None else config.api_port()
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._owns_loop = False

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        import sentinel_tpu_torch

        return sentinel_tpu_torch.get_engine()

    @property
    def bound_port(self) -> int:
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    # -- connection handling ----------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await reader.readline()
                if not request:
                    return
                try:
                    method, path, _version = request.decode(
                        "latin-1").strip().split(" ", 2)
                except ValueError:
                    return await self._respond(writer, 400, "bad request",
                                               close=True)
                headers = {}
                hdr_bytes = 0
                while True:
                    line = await reader.readline()
                    hdr_bytes += len(line)
                    if hdr_bytes > _MAX_HEADER_BYTES:
                        return await self._respond(writer, 431,
                                                   "headers too large",
                                                   close=True)
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    length = int(headers.get("content-length") or 0)
                except ValueError:
                    return await self._respond(writer, 400,
                                               "bad content-length",
                                               close=True)
                if length < 0:
                    return await self._respond(writer, 400,
                                               "bad content-length",
                                               close=True)
                if length > _MAX_BODY_BYTES:
                    return await self._respond(writer, 413, "body too large",
                                               close=True)
                body = (await reader.readexactly(length)).decode("utf-8") \
                    if length else ""
                if method not in ("GET", "POST"):
                    await self._respond(writer, 405, "GET/POST only")
                    continue
                # Off-loop dispatch: a handler may recompile rules or block
                # on the engine lock for seconds — the event loop (possibly
                # the HOST app's loop under start_async) must keep serving.
                code, text, ctype = await asyncio.to_thread(
                    dispatch_command, self, path, body)
                keep = headers.get("connection", "keep-alive").lower() \
                    != "close"
                await self._respond(writer, code, text, close=not keep,
                                    ctype=ctype)
                if not keep:
                    return
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError, ValueError):
            # ValueError: an oversized request line makes StreamReader's
            # readline raise it (limit exceeded) — drop the connection.
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _respond(self, writer: asyncio.StreamWriter, code: int,
                       text: str, close: bool = False,
                       ctype: str = "text/plain; charset=utf-8") -> None:
        reason = {200: "OK", 400: "Bad Request", 405: "Method Not Allowed",
                  413: "Payload Too Large", 431: "Headers Too Large",
                  500: "Internal Server Error"}.get(code, "Error")
        data = text.encode("utf-8")
        head = (f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: {'close' if close else 'keep-alive'}\r\n"
                f"\r\n").encode("latin-1")
        writer.write(head + data)
        await writer.drain()

    # -- lifecycle ---------------------------------------------------------

    async def start_async(self) -> "AsyncCommandCenter":
        """Serve on the CURRENT event loop (asyncio-native apps)."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port)
        return self

    async def stop_async(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def start(self) -> "AsyncCommandCenter":
        """Spawn a daemon thread with a private loop (sync apps)."""
        ready = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            self._owns_loop = True

            async def boot():
                self._server = await asyncio.start_server(
                    self._serve_conn, self.host, self.port)
                ready.set()

            loop.run_until_complete(boot())
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.close()

        self._thread = threading.Thread(
            target=run, name="sentinel-aio-command-center", daemon=True)
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError("async command center failed to start")
        return self

    def stop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is None:
            return
        if self._owns_loop:
            async def shutdown():
                await self.stop_async()
                loop.stop()

            asyncio.run_coroutine_threadsafe(shutdown(), loop)
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            return
        # start_async() on someone else's loop: stop() must still work —
        # silently returning would leak the bound listener for the process
        # lifetime. Off-loop callers get a synchronous close; on-loop
        # callers must await stop_async() (blocking here would deadlock).
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self._loop = loop  # undo: the center is still live
            raise RuntimeError(
                "stop() called from the serving event loop; "
                "await stop_async() instead")
        asyncio.run_coroutine_threadsafe(self.stop_async(), loop).result(
            timeout=5.0)
