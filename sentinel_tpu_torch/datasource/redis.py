"""Redis (RESP) datasource: the first connector speaking a real external
protocol over a real socket (reference: ``sentinel-datasource-redis``'s
``RedisDataSource`` — initial GET of the rule key, then pub/sub SUBSCRIBE
for pushes; the writable side SETs the key and PUBLISHes the channel —
SURVEY.md §2.2).

Everything here is RESP2 (the stable wire dialect every Redis-compatible
server speaks): requests are arrays of bulk strings; replies are simple
strings ``+``, errors ``-``, integers ``:``, bulk strings ``$`` and
arrays ``*``. The connector owns reconnect/backoff, partial-read
reassembly, and a catch-up GET on every (re)subscribe so a push missed
during an outage is never lost.

``MiniRedisServer`` is the in-repo fake (GET/SET/DEL/PUBLISH/SUBSCRIBE/
AUTH/PING subset) used by tests and demos; point the datasource at a real
Redis and no line of the connector changes.

Port of ``sentinel_tpu/datasource/redis.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    Converter,
    ReconnectingWatchMixin,
    T,
    WritableDataSource,
    _log_warn,
)


class RespError(Exception):
    """Server-side ``-ERR ...`` reply."""


def encode_command(*args) -> bytes:
    """RESP array-of-bulk-strings request frame."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        raw = a if isinstance(a, bytes) else str(a).encode("utf-8")
        out.append(b"$%d\r\n%s\r\n" % (len(raw), raw))
    return b"".join(out)


class _Reader:
    """Buffered RESP reply reader: reassembles values across arbitrary
    TCP fragmentation (the protocol twin of the TLV ``FrameReader``)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self) -> None:
        data = self._sock.recv(65536)
        if not data:
            raise ConnectionError("peer closed")
        self._buf += data

    def read_line(self) -> bytes:
        while True:
            i = self._buf.find(b"\r\n")
            if i >= 0:
                line, self._buf = self._buf[:i], self._buf[i + 2:]
                return line
            self._fill()

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + trailing \r\n
            self._fill()
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def read_reply(self):
        """One RESP value: str | int | bytes | list | None."""
        line = self.read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RespError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self.read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self.read_reply() for _ in range(n)]
        raise RespError(f"bad RESP type byte {kind!r}")


class RespConnection:
    """One blocking client connection (command mode or subscriber mode)."""

    def __init__(self, host: str, port: int, password: Optional[str] = None,
                 timeout_s: Optional[float] = 5.0):
        # Connect + AUTH always run under a bounded timeout, even for
        # subscriber connections that will block forever on reads later: a
        # blackholed SYN or a mute server must not park the caller where
        # close() can't interrupt it. ``timeout_s`` applies after setup.
        self.sock = socket.create_connection((host, port), timeout=5.0)
        if self.sock.getsockname() == self.sock.getpeername():
            # TCP simultaneous-open self-connect: while the server is down,
            # the kernel may hand this outgoing socket the server's own
            # port as its source port — the connect "succeeds" against
            # itself and would hang forever on the first command (and hold
            # the port hostage against the server's rebind).
            self.sock.close()
            raise ConnectionError("self-connect (server down)")
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.reader = _Reader(self.sock)
        if password is not None:
            self.command("AUTH", password)
        self.sock.settimeout(timeout_s)

    def command(self, *args):
        self.sock.sendall(encode_command(*args))
        return self.reader.read_reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RedisDataSource(ReconnectingWatchMixin, AbstractDataSource[bytes, T]):
    """Initial GET + SUBSCRIBE pushes, with reconnect and catch-up.

    The subscriber connection GETs the rule key immediately before
    SUBSCRIBE on every (re)connect: an update published while the
    connection was down is recovered the moment it is back, which is the
    at-least-once delivery the reference's poll-backed sources get for
    free. Bad payloads keep the last good rules (converter errors are
    logged, never pushed)."""

    # ValueError/IndexError/UnicodeDecodeError: a corrupt or desynced
    # RESP frame from the parser — the connection is unusable but the
    # CONNECTOR must survive and reconnect.
    _watch_exceptions = (OSError, ConnectionError, RespError, ValueError,
                         IndexError, UnicodeDecodeError)
    _watch_thread_name = "sentinel-redis-subscriber"

    def __init__(self, host: str, port: int, rule_key: str, channel: str,
                 converter: Converter, password: Optional[str] = None,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        self.host, self.port = host, port
        self.rule_key, self.channel = rule_key, channel
        self.password = password
        self._active: Optional[RespConnection] = None
        self._init_watch(reconnect_backoff_ms)

    # -- ReadableDataSource ------------------------------------------------

    def read_source(self) -> Optional[bytes]:
        conn = RespConnection(self.host, self.port, self.password)
        try:
            return conn.command("GET", self.rule_key)
        finally:
            conn.close()

    def start(self) -> "RedisDataSource":
        try:
            self._push_raw(self.read_source())
        except (OSError, RespError) as ex:
            _log_warn("redis datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    def _interrupt_watch(self) -> None:
        active = self._active
        if active is not None:
            # shutdown() wakes the subscriber thread out of its blocking
            # recv (a bare close would leave it parked there forever).
            try:
                active.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # -- internals ---------------------------------------------------------

    def _push_raw(self, raw: Optional[bytes]) -> None:
        if raw is None or self._stop.is_set():
            # stop guard: a straggler thread completing a connect after
            # close() must not mutate rules under a caller that believes
            # the source is shut down
            return
        try:
            value = self.converter(
                raw.decode("utf-8") if isinstance(raw, bytes) else raw)
        except Exception as ex:  # keep last good rules
            _log_warn("redis datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)

    def _watch_round(self) -> None:
        """One connect → subscribe → catch-up → read-until-error cycle."""
        conn = None
        try:
            conn = RespConnection(self.host, self.port, self.password,
                                  timeout_s=None)
            self._active = conn
            sub = conn.command("SUBSCRIBE", self.channel)
            if not (isinstance(sub, list) and sub
                    and sub[0] == b"subscribe"):
                raise RespError(f"unexpected SUBSCRIBE reply {sub!r}")
            # catch-up AFTER subscribe (on a command connection — a
            # subscribed conn can't GET): an update missed while down
            # is recovered here, and one racing this instant arrives
            # as a message too. GET-then-subscribe would have a lossy
            # gap between the two; this order has none.
            self._push_raw(self.read_source())
            self._healthy()
            while not self._stop.is_set():
                msg = conn.reader.read_reply()
                if (isinstance(msg, list) and len(msg) == 3
                        and msg[0] == b"message"):
                    self._push_raw(msg[2])
        finally:
            self._active = None
            if conn is not None:
                conn.close()


class RedisWritableDataSource(WritableDataSource[T]):
    """SET the rule key + PUBLISH the channel (the reference publisher's
    two-step, so poll-style AND push-style readers both see the write)."""

    def __init__(self, host: str, port: int, rule_key: str, channel: str,
                 encoder: Converter, password: Optional[str] = None):
        self.host, self.port = host, port
        self.rule_key, self.channel = rule_key, channel
        self.encoder = encoder
        self.password = password

    def write(self, value: T) -> None:
        raw = self.encoder(value)
        conn = RespConnection(self.host, self.port, self.password)
        try:
            conn.command("SET", self.rule_key, raw)
            conn.command("PUBLISH", self.channel, raw)
        finally:
            conn.close()


# -- in-repo fake server ------------------------------------------------------


class MiniRedisServer:
    """RESP2 subset server (GET/SET/DEL/PUBLISH/SUBSCRIBE/UNSUBSCRIBE/
    AUTH/PING) for tests and demos. ``stop()`` + ``start()`` rebinds the
    SAME port, so reconnect paths are testable; the KV survives a restart
    (a real Redis with persistence would too), unless ``clear()``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None):
        self.host = host
        self.port = port
        self.password = password
        self._kv: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        # channel -> set of (socket, send-lock) subscriber entries
        self._subs: Dict[bytes, Set] = {}
        self._listener: Optional[socket.socket] = None
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()

    def start(self) -> "MiniRedisServer":
        self._stopping.clear()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        deadline = time.time() + 3.0
        while True:
            try:
                self._listener.bind((self.host, self.port))
                break
            except OSError:
                # A reconnecting client can transiently hold our port as
                # its ephemeral source port (see RespConnection's
                # self-connect guard); it releases within its backoff.
                if time.time() >= deadline:
                    raise
                time.sleep(0.05)
        self.port = self._listener.getsockname()[1]  # pin for restarts
        self._listener.listen(16)
        t = threading.Thread(target=self._accept_loop,
                             name="mini-redis-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        """Close the listener and every live connection (simulates a
        server crash for reconnect tests); KV state is retained.

        Socket discipline (all three measured necessary for an instant
        same-port restart on Linux): ``shutdown()`` before ``close()`` —
        a plain close never wakes a thread blocked in accept()/recv(),
        whose in-syscall reference keeps the fd (and the LISTEN) alive
        forever; SO_LINGER(0) so accepted sockets RST instead of parking
        the port in TIME_WAIT; each conn's own serve thread does the
        final close()."""
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._lock:
            conns, self._conns = self._conns, []
            self._subs.clear()
        for c in conns:
            try:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads = []

    def clear(self) -> None:
        with self._lock:
            self._kv.clear()

    # -- plumbing ----------------------------------------------------------

    def _accept_loop(self) -> None:
        listener = self._listener
        while not self._stopping.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="mini-redis-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        reader = _Reader(conn)
        send_lock = threading.Lock()
        authed = self.password is None
        subscribed: Set[bytes] = set()

        def reply(data: bytes) -> None:
            with send_lock:
                conn.sendall(data)

        try:
            while not self._stopping.is_set():
                req = reader.read_reply()
                if not isinstance(req, list) or not req:
                    reply(b"-ERR protocol error\r\n")
                    continue
                cmd = bytes(req[0]).upper()
                args = req[1:]
                if cmd == b"AUTH":
                    if (self.password is not None and len(args) == 1
                            and args[0] == self.password.encode()):
                        authed = True
                        reply(b"+OK\r\n")
                    else:
                        reply(b"-ERR invalid password\r\n")
                    continue
                if not authed:
                    reply(b"-NOAUTH Authentication required.\r\n")
                    continue
                if cmd == b"PING":
                    reply(b"+PONG\r\n")
                elif cmd == b"GET" and len(args) == 1:
                    with self._lock:
                        v = self._kv.get(args[0])
                    reply(b"$-1\r\n" if v is None
                          else b"$%d\r\n%s\r\n" % (len(v), v))
                elif cmd == b"SET" and len(args) == 2:
                    with self._lock:
                        self._kv[args[0]] = args[1]
                    reply(b"+OK\r\n")
                elif cmd == b"DEL":
                    with self._lock:
                        n = sum(1 for k in args if self._kv.pop(k, None)
                                is not None)
                    reply(b":%d\r\n" % n)
                elif cmd == b"PUBLISH" and len(args) == 2:
                    reply(b":%d\r\n" % self._publish(args[0], args[1]))
                elif cmd == b"SUBSCRIBE" and args:
                    for ch in args:
                        subscribed.add(ch)
                        # Registration and ack under ONE send_lock hold:
                        # a racing PUBLISH (which sends under send_lock
                        # but never holds self._lock while sending) can
                        # otherwise deliver its message frame BEFORE the
                        # +subscribe ack, which clients read as a bogus
                        # SUBSCRIBE reply.
                        with send_lock:
                            with self._lock:
                                self._subs.setdefault(ch, set()).add(
                                    (conn, send_lock))
                            conn.sendall(b"*3\r\n$9\r\nsubscribe\r\n"
                                         b"$%d\r\n%s\r\n:%d\r\n"
                                         % (len(ch), ch, len(subscribed)))
                elif cmd == b"UNSUBSCRIBE":
                    for ch in (args or list(subscribed)):
                        subscribed.discard(ch)
                        with self._lock:
                            self._subs.get(ch, set()).discard(
                                (conn, send_lock))
                        reply(b"*3\r\n$11\r\nunsubscribe\r\n"
                              b"$%d\r\n%s\r\n:%d\r\n"
                              % (len(ch), ch, len(subscribed)))
                else:
                    reply(b"-ERR unknown command %s\r\n"
                          % cmd.decode("ascii", "replace").encode())
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                for ch in subscribed:
                    self._subs.get(ch, set()).discard((conn, send_lock))
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _publish(self, channel: bytes, payload: bytes) -> int:
        with self._lock:
            targets = list(self._subs.get(channel, ()))
        delivered = 0
        frame = (b"*3\r\n$7\r\nmessage\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                 % (len(channel), channel, len(payload), payload))
        for sock, lock in targets:
            try:
                with lock:
                    sock.sendall(frame)
                delivered += 1
            except OSError:
                pass
        return delivered
