"""ZooKeeper datasource speaking the real jute/ZAB client wire protocol
(reference: ``sentinel-datasource-zookeeper``'s ``ZookeeperDataSource`` —
a Curator ``NodeCache`` on the rule path: initial read, then re-read on
every node-changed watch event — SURVEY.md §2.2).

No Curator and no zkclient here: the connector encodes the jute frames
itself (length-prefixed big-endian records: ConnectRequest/Response,
RequestHeader/ReplyHeader, getData/setData/create/exists bodies, Stat,
WatcherEvent). That keeps it dependency-free and wire-compatible with a
real ZooKeeper ensemble — point it at one and no line changes.

Watch discipline mirrors the reference's NodeCache: ZooKeeper watches are
ONE-SHOT, so every fired event triggers a re-read that also re-arms the
watch; the re-read is the catch-up (data changed again between event and
read → the read sees the newest data and the re-armed watch covers the
rest). On reconnect the connector starts a fresh session and re-reads
immediately, so an update missed during an outage is never lost.

``MiniZooKeeperServer`` is the in-repo fake (connect/ping/getData/
setData/create/delete/exists/closeSession subset with real one-shot
watches) used by tests and demos.

Port of ``sentinel_tpu/datasource/zookeeper.py``: the same classes, wire and
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

# -- jute opcodes / constants (org.apache.zookeeper.ZooDefs.OpCode) -----------

OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GET_DATA = 4
OP_SET_DATA = 5
OP_PING = 11
OP_CLOSE = -11

XID_NOTIFICATION = -1  # watch events arrive under this xid
XID_PING = -2

# KeeperException codes (subset the connector handles)
ERR_OK = 0
ERR_NONODE = -101
ERR_BADVERSION = -103
ERR_NODEEXISTS = -110

# Watcher.Event.EventType / KeeperState
EVENT_CREATED = 1
EVENT_DELETED = 2
EVENT_DATA_CHANGED = 3
STATE_SYNC_CONNECTED = 3

_STAT = struct.Struct(">qqqqiiiqiiq")  # czxid..pzxid, 68 bytes


class ZkError(Exception):
    """Non-OK ``ReplyHeader.err`` from the server."""

    def __init__(self, code: int, what: str = ""):
        super().__init__(f"zookeeper error {code} {what}".rstrip())
        self.code = code


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack(">i", len(raw)) + raw


def _pack_buf(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Cursor:
    """Sequential jute decoder over one reply payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.data, self.pos)
        self.pos += 8
        return v

    def buf(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def ustr(self) -> str:
        b = self.buf()
        return "" if b is None else b.decode("utf-8")


class ZkConnection:
    """One client session: handshake, xid-sequenced requests, watch-event
    demux. Single-threaded use (one in-flight request at a time) — the
    connector's read/write paths each own a connection, like the
    reference's Curator client owns its ZooKeeper handle."""

    def __init__(self, host: str, port: int, session_timeout_ms: int = 10000,
                 timeout_s: Optional[float] = 5.0):
        self.sock = socket.create_connection((host, port), timeout=5.0)
        if self.sock.getsockname() == self.sock.getpeername():
            # TCP simultaneous-open self-connect while the server is down
            # (see RespConnection for the full story).
            self.sock.close()
            raise ConnectionError("self-connect (server down)")
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        self._xid = 0
        self.events: List[Tuple[int, int, str]] = []  # queued watch events
        # ConnectRequest: protoVer, lastZxidSeen, timeOut, sessionId, passwd
        body = struct.pack(">iqiq", 0, 0, session_timeout_ms, 0) + _pack_buf(b"")
        self.sock.sendall(struct.pack(">i", len(body)) + body)
        resp = _Cursor(self._read_frame())
        resp.i32()  # protocolVersion
        self.negotiated_timeout_ms = resp.i32()
        self.session_id = resp.i64()
        if self.negotiated_timeout_ms <= 0:
            raise ConnectionError("session rejected (expired/invalid)")
        self.sock.settimeout(timeout_s)

    # -- framing -----------------------------------------------------------

    def _read_frame(self) -> bytes:
        while len(self._buf) < 4:
            self._fill()
        (n,) = struct.unpack_from(">i", self._buf)
        if n < 0 or n > 1 << 26:
            raise ConnectionError(f"bad frame length {n}")
        while len(self._buf) < 4 + n:
            self._fill()
        frame, self._buf = self._buf[4:4 + n], self._buf[4 + n:]
        return frame

    def _fill(self) -> None:
        data = self.sock.recv(65536)
        if not data:
            raise ConnectionError("peer closed")
        self._buf += data

    # -- request/reply -----------------------------------------------------

    def _send(self, xid: int, op: int, body: bytes = b"") -> None:
        payload = struct.pack(">ii", xid, op) + body
        self.sock.sendall(struct.pack(">i", len(payload)) + payload)

    def request(self, op: int, body: bytes) -> _Cursor:
        """Send one request; return its reply payload (header consumed,
        err checked). Watch events arriving first are queued on
        ``self.events`` — jute multiplexes notifications onto the one
        session socket, demuxed by xid."""
        self._xid += 1
        xid = self._xid
        self._send(xid, op, body)
        while True:
            cur = _Cursor(self._read_frame())
            rxid, _zxid, err = cur.i32(), cur.i64(), cur.i32()
            if rxid == XID_NOTIFICATION:
                self.events.append((cur.i32(), cur.i32(), cur.ustr()))
                continue
            if rxid == XID_PING:
                continue
            if rxid != xid:
                raise ConnectionError(f"xid mismatch {rxid} != {xid}")
            if err != ERR_OK:
                raise ZkError(err)
            return cur

    def next_event(self) -> Tuple[int, int, str]:
        """Block until a watch event arrives (sending pings on recv
        timeouts so the parked session never expires)."""
        if self.events:
            return self.events.pop(0)
        while True:
            try:
                cur = _Cursor(self._read_frame())
            except socket.timeout:
                self.ping()
                continue
            rxid, _zxid, _err = cur.i32(), cur.i64(), cur.i32()
            if rxid == XID_NOTIFICATION:
                return (cur.i32(), cur.i32(), cur.ustr())
            # stray ping ack or stale reply: ignore and keep parking

    def ping(self) -> None:
        self._send(XID_PING, OP_PING)

    # -- ops ---------------------------------------------------------------

    def get_data(self, path: str, watch: bool = False) -> bytes:
        cur = self.request(OP_GET_DATA, _pack_str(path) + bytes([watch]))
        return cur.buf() or b""

    def exists(self, path: str, watch: bool = False) -> bool:
        try:
            self.request(OP_EXISTS, _pack_str(path) + bytes([watch]))
            return True
        except ZkError as ex:
            if ex.code == ERR_NONODE:
                return False
            raise

    def set_data(self, path: str, data: bytes, version: int = -1) -> None:
        self.request(OP_SET_DATA,
                     _pack_str(path) + _pack_buf(data)
                     + struct.pack(">i", version))

    def create(self, path: str, data: bytes = b"") -> str:
        # One world-readable ACL (world:anyone, perms=ALL=0x1f), flags=0
        acl = struct.pack(">i", 1) + struct.pack(">i", 0x1F) \
            + _pack_str("world") + _pack_str("anyone")
        cur = self.request(OP_CREATE,
                           _pack_str(path) + _pack_buf(data) + acl
                           + struct.pack(">i", 0))
        return cur.ustr()

    def delete(self, path: str, version: int = -1) -> None:
        self.request(OP_DELETE, _pack_str(path) + struct.pack(">i", version))

    def close(self) -> None:
        try:
            self._send(self._xid + 1, OP_CLOSE)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class ZookeeperDataSource(ReconnectingWatchMixin, AbstractDataSource[bytes, T]):
    """Initial read + one-shot-watch re-reads, with reconnect + catch-up
    (the ``NodeCache`` behavior of the reference's ``ZookeeperDataSource``).

    If the rule znode does not exist yet, the connector parks on an
    ``exists`` watch and loads the moment it is created — the reference
    gets the same from NodeCache's created-event handling."""

    _watch_exceptions = (OSError, ConnectionError, ZkError, ValueError,
                         IndexError, struct.error, UnicodeDecodeError)
    _watch_thread_name = "sentinel-zookeeper-watcher"

    def __init__(self, server_addr: str, path: str, converter: Converter,
                 session_timeout_ms: int = 10000,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        host, _, port = server_addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.path = path
        self.session_timeout_ms = session_timeout_ms
        self._active: Optional[ZkConnection] = None
        self._init_watch(reconnect_backoff_ms)

    # -- ReadableDataSource ------------------------------------------------

    def read_source(self) -> Optional[bytes]:
        conn = ZkConnection(self.host, self.port, self.session_timeout_ms)
        try:
            return conn.get_data(self.path)
        except ZkError as ex:
            if ex.code == ERR_NONODE:
                return None
            raise
        finally:
            conn.close()

    def start(self) -> "ZookeeperDataSource":
        try:
            self._push_raw(self.read_source())
        except (OSError, ZkError) as ex:
            _log_warn("zookeeper datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    def _interrupt_watch(self) -> None:
        active = self._active
        if active is not None:
            try:
                active.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # -- internals ---------------------------------------------------------

    def _push_raw(self, raw: Optional[bytes]) -> None:
        if raw is None or self._stop.is_set():
            # stop guard: a straggler completing a read after close() must
            # not mutate rules under a caller that shut the source down
            return
        try:
            value = self.converter(
                raw.decode("utf-8") if isinstance(raw, bytes) else raw)
        except Exception as ex:  # keep last good rules
            _log_warn("zookeeper datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)

    def _watch_round(self) -> None:
        """One session: connect → watched read (catch-up) → event loop.

        Each ``get_data(watch=True)`` both delivers the current rules and
        re-arms the one-shot watch, so the read IS the ack — no separate
        re-arm step can be forgotten."""
        conn = None
        try:
            conn = ZkConnection(self.host, self.port, self.session_timeout_ms,
                                timeout_s=self.session_timeout_ms / 3000.0)
            self._active = conn
            self._read_and_rearm(conn)
            self._healthy()
            while not self._stop.is_set():
                etype, _state, path = conn.next_event()
                if path != self.path:
                    continue
                # EVENT_DELETED included: keep last good rules (reference
                # NodeCache keeps its last state too); _read_and_rearm's
                # NONODE branch parks on the exists watch — and closes the
                # delete-then-recreate race where the create lands before
                # the watch is re-armed.
                self._read_and_rearm(conn)
        finally:
            self._active = None
            if conn is not None:
                conn.close()

    def _read_and_rearm(self, conn: ZkConnection) -> None:
        while True:
            try:
                self._push_raw(conn.get_data(self.path, watch=True))
                return
            except ZkError as ex:
                if ex.code != ERR_NONODE:
                    raise
            # Not created yet: exists-watch fires EVENT_CREATED later. If
            # the node appeared between the NONODE read and this arm, loop
            # and read it now — otherwise that create would be invisible
            # until the NEXT change.
            if not conn.exists(self.path, watch=True):
                return


class ZookeeperWritableDataSource(WritableDataSource[T]):
    """setData the rule path (creating it if absent) — the writable twin
    the dashboard's V2 publisher drives."""

    def __init__(self, server_addr: str, path: str, encoder: Converter,
                 session_timeout_ms: int = 10000):
        host, _, port = server_addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.path = path
        self.encoder = encoder
        self.session_timeout_ms = session_timeout_ms

    def write(self, value: T) -> None:
        raw = self.encoder(value)
        data = raw.encode("utf-8") if isinstance(raw, str) else raw
        conn = ZkConnection(self.host, self.port, self.session_timeout_ms)
        try:
            try:
                conn.set_data(self.path, data)
            except ZkError as ex:
                if ex.code != ERR_NONODE:
                    raise
                conn.create(self.path, data)
        finally:
            conn.close()


# -- in-repo fake server ------------------------------------------------------


class MiniZooKeeperServer:
    """Jute-protocol subset server (connect/ping/getData/setData/create/
    delete/exists/closeSession) with REAL one-shot watches, for tests and
    demos. ``stop()``/``start()`` rebinds the same port; znode data
    survives a restart (a real ensemble's would too) unless ``clear()``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._nodes: Dict[str, Tuple[bytes, int]] = {}  # path -> (data, ver)
        self._zxid = 0
        self._next_session = 0x1000
        self._lock = threading.Lock()
        # path -> set of (socket, send-lock); cleared when fired (one-shot)
        self._watches: Dict[str, Set] = {}
        self._listener: Optional[socket.socket] = None
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()

    def start(self) -> "MiniZooKeeperServer":
        self._stopping.clear()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        deadline = time.time() + 3.0
        while True:
            try:
                self._listener.bind((self.host, self.port))
                break
            except OSError:
                # A reconnecting client can transiently hold the port as
                # its ephemeral source port (self-connect guard twin).
                if time.time() >= deadline:
                    raise
                time.sleep(0.05)
        self.port = self._listener.getsockname()[1]  # pin for restarts
        self._listener.listen(16)
        t = threading.Thread(target=self._accept_loop,
                             name="mini-zk-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        """Crash the server (reconnect tests): close listener + every live
        connection; znode state is retained. Socket discipline per
        ``MiniRedisServer.stop`` (shutdown-then-close + LINGER(0))."""
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
            self._watches.clear()
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
            self._nodes.clear()

    def set_node(self, path: str, data: bytes) -> None:
        """Out-of-band publish (as another client would): fires watches."""
        self._apply_set(path, data, -1)

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
                                 name="mini-zk-conn", daemon=True)
            t.start()
            # Prune dead entries on append: every read_source()/write()
            # dials a fresh connection, so an unpruned list grows without
            # bound over a long demo (and stop() joins each at 1s budget).
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _recv_frame(self, conn: socket.socket, buf: bytearray) -> bytes:
        while len(buf) < 4:
            data = conn.recv(65536)
            if not data:
                raise ConnectionError("client closed")
            buf += data
        (n,) = struct.unpack_from(">i", buf)
        if n < 0 or n > 1 << 26:
            raise ConnectionError(f"bad frame length {n}")
        while len(buf) < 4 + n:
            data = conn.recv(65536)
            if not data:
                raise ConnectionError("client closed")
            buf += data
        frame = bytes(buf[4:4 + n])
        del buf[:4 + n]
        return frame

    def _serve(self, conn: socket.socket) -> None:
        buf = bytearray()
        send_lock = threading.Lock()
        my_watches: List[str] = []

        def reply(xid: int, err: int, body: bytes = b"") -> None:
            payload = struct.pack(">iqi", xid, self._zxid, err) + body
            with send_lock:
                conn.sendall(struct.pack(">i", len(payload)) + payload)

        try:
            # handshake
            req = _Cursor(self._recv_frame(conn, buf))
            req.i32()  # protocolVersion
            req.i64()  # lastZxidSeen
            timeout_ms = req.i32()
            with self._lock:
                self._next_session += 1
                session = self._next_session
            body = struct.pack(">iiq", 0, max(timeout_ms, 1000), session) \
                + _pack_buf(b"\x00" * 16)
            with send_lock:
                conn.sendall(struct.pack(">i", len(body)) + body)

            while not self._stopping.is_set():
                cur = _Cursor(self._recv_frame(conn, buf))
                xid, op = cur.i32(), cur.i32()
                if op == OP_PING:
                    reply(XID_PING, ERR_OK)
                elif op == OP_CLOSE:
                    reply(xid, ERR_OK)
                    return
                else:
                    self._dispatch(op, cur, xid, reply, conn, send_lock,
                                   my_watches)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            with self._lock:
                for p in my_watches:
                    self._watches.get(p, set()).discard((conn, send_lock))
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op, cur, xid, reply, conn, send_lock, my_watches):
        if op == OP_GET_DATA:
            path = cur.ustr()
            watch = cur.data[cur.pos] != 0  # jute bool: one byte
            with self._lock:
                node = self._nodes.get(path)
                if watch:
                    # Real ZK arms the getData watch only when the node
                    # exists (a NONODE getData does NOT leave a watch).
                    if node is not None:
                        self._watches.setdefault(path, set()).add(
                            (conn, send_lock))
                        my_watches.append(path)
            if node is None:
                reply(xid, ERR_NONODE)
            else:
                reply(xid, ERR_OK,
                      _pack_buf(node[0]) + self._stat(node))
        elif op == OP_EXISTS:
            path = cur.ustr()
            watch = cur.data[cur.pos] != 0
            with self._lock:
                node = self._nodes.get(path)
                if watch:
                    self._watches.setdefault(path, set()).add(
                        (conn, send_lock))
                    my_watches.append(path)
            if node is None:
                reply(xid, ERR_NONODE)
            else:
                reply(xid, ERR_OK, self._stat(node))
        elif op == OP_SET_DATA:
            path = cur.ustr()
            data = cur.buf() or b""
            version = cur.i32()
            err = self._apply_set(path, data, version, create=False)
            if err:
                reply(xid, err)
            else:
                with self._lock:
                    node = self._nodes[path]
                reply(xid, ERR_OK, self._stat(node))
        elif op == OP_CREATE:
            path = cur.ustr()
            data = cur.buf() or b""
            err = self._apply_set(path, data, -1, created=True)
            if err:
                reply(xid, err)
            else:
                reply(xid, ERR_OK, _pack_str(path))
        elif op == OP_DELETE:
            path = cur.ustr()
            with self._lock:
                existed = self._nodes.pop(path, None) is not None
                self._zxid += 1
            if not existed:
                reply(xid, ERR_NONODE)
            else:
                reply(xid, ERR_OK)
                self._fire(path, EVENT_DELETED)
        else:
            reply(xid, ERR_OK)

    def _stat(self, node: Tuple[bytes, int]) -> bytes:
        data, version = node
        return _STAT.pack(self._zxid, self._zxid, 0, 0, version, 0, 0, 0,
                          len(data), 0, self._zxid)

    def _apply_set(self, path: str, data: bytes, version: int,
                   create: bool = True, created: bool = False) -> int:
        with self._lock:
            node = self._nodes.get(path)
            if node is None and not create and not created:
                return ERR_NONODE
            if node is not None and created:
                # Existence check inside the lock: two racing creates must
                # resolve OK/NODEEXISTS like a real ensemble, not OK/OK.
                return ERR_NODEEXISTS
            if node is not None and version not in (-1, node[1]):
                return ERR_BADVERSION
            was_absent = node is None
            new_version = 0 if was_absent else node[1] + 1
            self._nodes[path] = (data, new_version)
            self._zxid += 1
        self._fire(path,
                   EVENT_CREATED if was_absent else EVENT_DATA_CHANGED)
        return ERR_OK

    def _fire(self, path: str, etype: int) -> None:
        """Deliver one-shot watch events (cleared on fire, like real ZK)."""
        with self._lock:
            targets = self._watches.pop(path, set())
        body = struct.pack(">ii", etype, STATE_SYNC_CONNECTED) \
            + _pack_str(path)
        payload = struct.pack(">iqi", XID_NOTIFICATION, self._zxid, ERR_OK) \
            + body
        frame = struct.pack(">i", len(payload)) + payload
        for sock, lock in targets:
            try:
                with lock:
                    sock.sendall(frame)
            except OSError:
                pass
