"""Event-driven wire frontend for the token server (port of
``sentinel_tpu/cluster/reactor.py``).

One ``selectors``-based I/O loop multiplexes every client connection
(thousands of sockets, zero threads parked on reads), a zero-copy
``FrameScanner`` (cluster/codec.py) parses TLV frames as memoryview
slices straight off each recv chunk, and a coalescing collector drains
ALL ready connections per loop cycle into ONE fused-step group through
the server's bounded, deadline-tagged admission batcher — which itself
pipelines up to ``csp.sentinel.wire.inflight.depth`` fused batches on
the device stream via the token service's enqueue-only dispatch/harvest
split.

Replies multiplex back per connection with COALESCED writes: every
request gets an ordered reply slot at parse time; a harvester thread
fills slots as fused batches resolve; the reactor flushes each
connection's contiguous filled prefix as one buffer per flush (never a
write per request), preserving per-connection FIFO regardless of which
worker or harvest filled which slot (docs/SEMANTICS.md "Coalescing
ordering"). Non-FLOW frames (ENTRY/EXIT/PARAM_FLOW — engine work) run
on a small compute-only worker pool so the I/O loop never blocks.

Backpressure: a slow consumer's reply backlog is bounded by
``csp.sentinel.wire.outbuf.max.bytes`` — past it the connection stops
being read (TCP backpressure upstream) and requests already parsed shed
OVERLOADED (``outbufShed`` counts them); reply bytes never grow
unboundedly. A connection that dies mid-harvest simply drops its
verdicts (``droppedReplies``) — no strand, no stalled batch.

Chaos parity: reply bytes pass the same ``cluster.server.frame`` /
``cluster.ha.halfopen`` mutate seams as the legacy frontend
(server.mutate_reply), and epoch stamping rides the shared
``build_flow_reply`` encoder, so the wire stays byte-identical between
the two frontends.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.cluster.constants import (
    MSG_FLOW,
    MSG_PING,
    TokenResultStatus,
)
from sentinel_tpu_torch.cluster.server import (
    build_flow_reply,
    mutate_reply,
    process_control_frame,
)
from sentinel_tpu_torch.resilience import faults
_LISTEN_BACKLOG = 256  # the legacy frontend's reconnect-storm headroom

# Estimated bytes per PROMISED reply (an unfilled slot): the backlog
# bound must count replies the connection is owed, not just bytes
# already encoded — replies materialize only at harvest, so a flood
# parsed in one chunk would otherwise sail past the bound before a
# single byte of it is queued. A FLOW reply is 16-40 bytes on the wire.
_REPLY_EST_BYTES = 24


class _Conn:
    """Per-connection reactor state. ``replies`` is the ordered slot
    ring: one single-element list per in-flight request, filled (from
    any thread) with the encoded reply bytes; the reactor pops and
    writes only the contiguous filled prefix, so the byte stream always
    answers requests in arrival order."""

    __slots__ = ("sock", "fd", "scanner", "namespace", "remote_entries",
                 "replies", "outq", "out_off", "out_bytes", "last_active",
                 "paused", "closed", "tasks", "task_running", "task_lock")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fd = sock.fileno()
        self.scanner = codec.FrameScanner()
        self.namespace: Optional[str] = None
        self.remote_entries: Dict[int, object] = {}
        self.replies: deque = deque()
        self.outq: deque = deque()
        self.out_off = 0
        self.out_bytes = 0
        self.last_active = time.monotonic()
        self.paused = False
        self.closed = False
        self.tasks: deque = deque()
        self.task_running = False
        self.task_lock = threading.Lock()


class WireReactor:
    """The selectors loop + harvester + compute pool behind
    :class:`~sentinel_tpu.cluster.server.ClusterTokenServer`."""

    def __init__(self, server):
        from sentinel_tpu_torch.core.config import config

        self.server = server
        self.coalesce_max = config.wire_coalesce_max_batch()
        self.outbuf_max = config.wire_outbuf_max_bytes()
        self.read_chunk = config.wire_read_chunk_bytes()
        self.n_workers = config.wire_workers()
        self._sel = selectors.DefaultSelector()
        self._listener: Optional[socket.socket] = None
        self._waker_r: Optional[socket.socket] = None
        self._waker_w: Optional[socket.socket] = None
        self._conns: Dict[int, _Conn] = {}
        # (conn, xid, slot, req, t_arrival, t_staged)
        self._staged: List[tuple] = []
        # Latency-waterfall recorder: resolved by the owning
        # server before it constructs us (engine-attached servers only —
        # never boots the engine). None => per-request stamp work is
        # skipped entirely; the A/B dispatch-count guard pins that the
        # enabled path adds zero device work either way.
        self._wf = getattr(server.batcher, "waterfall", None)
        self._dirty_lock = threading.Lock()
        self._dirty: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._harvester: Optional[threading.Thread] = None
        self._pool = None
        # Bounded hand-off to the harvester: items exist only for groups
        # the bounded admission queue ADMITTED, so this can never grow
        # past (queue bound + in-flight depth); the margin is headroom.
        cap = server.batcher.max_queue_groups * 2 + 16
        self._harvest_q: "queue.Queue" = queue.Queue(maxsize=cap)
        # -- wire stats (sentinel_tpu_wire_* source) ----------------------
        self._stats_lock = threading.Lock()
        self.connections_total = 0
        self.outbuf_shed = 0
        self.dropped_replies = 0
        self.fused_batches = 0
        self.fused_requests = 0
        self._batch_sizes: deque = deque(maxlen=512)
        self._rtt_ms: deque = deque(maxlen=2048)       # arrival -> reply built
        self._coalesce_wait_ms: deque = deque(maxlen=2048)  # arrival -> submit
        self._queue_wait_ms: deque = deque(maxlen=2048)     # submit -> harvest

    # -- lifecycle ---------------------------------------------------------

    @property
    def bound_port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else 0

    def attach_waterfall(self, recorder) -> None:
        """Late attach (engine booted after server start): subsequent
        requests start carrying stage-stamp records."""
        self._wf = recorder

    def start(self) -> "WireReactor":
        import concurrent.futures

        # Bind synchronously so an EADDRINUSE surfaces to the caller
        # (role flips must fail honestly, cluster/state.py semantics).
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            lst.bind((self.server.host, self.server.port))
            lst.listen(_LISTEN_BACKLOG)
        except OSError:
            lst.close()
            raise
        lst.setblocking(False)
        self._listener = lst
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        # Non-blocking writes too: a full waker buffer means a wake is
        # already pending — the send's only job is edge-triggering, and
        # a blocking write could park a harvester/worker against a
        # reactor that is busy (or stopping).
        self._waker_w.setblocking(False)
        self._sel.register(lst, selectors.EVENT_READ, "accept")
        self._sel.register(self._waker_r, selectors.EVENT_READ, "wake")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.n_workers,
            thread_name_prefix="sentinel-wire-worker")
        self._harvester = threading.Thread(
            target=self._harvest_loop, name="sentinel-wire-harvester",
            daemon=True)
        self._harvester.start()
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-wire-reactor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._harvester is not None:
            self._harvester.join(timeout=2.0)
            self._harvester = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _wake(self) -> None:
        try:
            if self._waker_w is not None:
                self._waker_w.send(b"\0")
        except OSError:
            pass

    # -- the I/O loop ------------------------------------------------------

    def _loop(self) -> None:
        last_sweep = time.monotonic()
        try:
            while not self._stop.is_set():
                events = self._sel.select(timeout=0.05)
                for key, mask in events:
                    kind = key.data
                    if kind == "accept":
                        self._accept()
                    elif kind == "wake":
                        try:
                            while self._waker_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        conn = kind
                        if mask & selectors.EVENT_READ:
                            self._read(conn)
                        if mask & selectors.EVENT_WRITE and not conn.closed:
                            self._try_send(conn)
                # Coalesce: everything staged this cycle goes out as
                # fused-step group(s) through the bounded batcher.
                if self._staged:
                    self._submit_staged()
                # Flush connections whose slots got filled off-loop.
                if self._dirty:
                    with self._dirty_lock:
                        dirty, self._dirty = self._dirty, set()
                    for conn in dirty:
                        if not conn.closed:
                            self._flush(conn)
                now = time.monotonic()
                if now - last_sweep >= 0.5:
                    last_sweep = now
                    self._sweep_idle(now)
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            for sock in (self._listener, self._waker_r, self._waker_w):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            self._listener = None
            self._sel.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[conn.fd] = conn
            with self._stats_lock:
                self.connections_total += 1
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                self._close(conn)

    def _interest(self, conn: _Conn) -> None:
        """Recompute a live connection's selector interest set."""
        events = 0
        if not conn.paused:
            events |= selectors.EVENT_READ
        if conn.outq:
            events |= selectors.EVENT_WRITE
        try:
            if events:
                self._sel.modify(conn.sock, events, conn)
            else:
                # Fully quiesced (paused, nothing to write): parked until
                # a flush or resume re-registers it.
                self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            if events:
                try:
                    self._sel.register(conn.sock, events, conn)
                except (KeyError, ValueError, OSError):
                    pass

    @staticmethod
    def _backlog(conn: _Conn) -> int:
        """The connection's reply backlog: bytes queued for the socket
        plus an estimate for every reply still OWED (unfilled or
        unflushed slots) — the quantity the outbuf bound actually
        limits."""
        return conn.out_bytes + len(conn.replies) * _REPLY_EST_BYTES

    def _read(self, conn: _Conn) -> None:
        # Chaos seams (resilience/faults.py): conn.stall in
        # delay mode wedges this read (a saturated loop / stuck peer);
        # conn.drop in error mode kills the connection mid-stream — the
        # peer sees a clean drop and the close path must strand nothing
        # (remote entries exited, reply slots discarded).
        try:
            faults.fire("cluster.reactor.conn.stall")
            faults.fire("cluster.reactor.conn.drop")
        except OSError:
            self._close(conn)
            return
        try:
            chunk = conn.sock.recv(self.read_chunk)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not chunk:
            self._close(conn)
            return
        conn.last_active = time.monotonic()
        t_arrival = time.perf_counter()
        shed_retry = self.server.batcher.retry_after_ms
        wf = self._wf
        for frame in conn.scanner.feed(chunk):
            try:
                req = codec.decode_request(frame)
            except Exception:  # noqa: BLE001 — garbled frame: drop the conn
                self._close(conn)
                return
            # Slot ring cell: [reply_bytes, waterfall_stamp_record].
            # _flush keys on [0]; [1] stays None for control frames,
            # sheds, and stamp-disabled runs.
            slot = [None, None]
            conn.replies.append(slot)
            if req.msg_type == MSG_FLOW:
                if self._backlog(conn) > self.outbuf_max:
                    # Slow-consumer shed: the reply backlog is over its
                    # bound — answer OVERLOADED without device work
                    # instead of growing the backlog further.
                    with self._stats_lock:
                        self.outbuf_shed += 1
                    slot[0] = build_flow_reply(
                        self.server, req.xid, None, shed_retry)
                    continue
                try:
                    r = codec.decode_flow_request(req.entity)
                    if len(req.entity) > codec.FLOW_REQ_SIZE:
                        tp = codec.read_trace_tlv(
                            req.entity, codec.FLOW_REQ_SIZE)
                        if tp:
                            from sentinel_tpu_torch.telemetry.spans import (
                                parse_traceparent,
                            )

                            ctx = parse_traceparent(tp)
                            if ctx is not None:
                                r = r + (ctx,)
                except Exception:  # noqa: BLE001 — undecodable entity
                    slot[0] = codec.encode_response(
                        req.xid, MSG_FLOW, TokenResultStatus.BAD_REQUEST)
                    continue
                # Waterfall "read" stage boundary: parse+stage done for
                # THIS frame (per-frame stamp only while capturing).
                t_staged = time.perf_counter() if wf is not None \
                    else t_arrival
                self._staged.append(
                    (conn, req.xid, slot, r, t_arrival, t_staged))
            elif req.msg_type == MSG_PING and not conn.task_running \
                    and not conn.tasks:
                # Cheap + ordering-safe inline (no compute work queued).
                self._fill_control(conn, req.materialized(), slot)
            else:
                self._enqueue_task(conn, req.materialized(), slot)
        self._flush(conn)
        # Read-side backpressure: past the outbuf bound, stop reading —
        # the kernel's socket buffers push back on the sender.
        if self._backlog(conn) > self.outbuf_max and not conn.paused:
            conn.paused = True
            self._interest(conn)

    # -- coalescing submit + harvest --------------------------------------

    def _submit_staged(self) -> None:
        staged, self._staged = self._staged, []
        batcher = self.server.batcher
        burst_cap = self.server.conn_max_burst
        while staged:
            reqs: List[tuple] = []
            routing: List[tuple] = []
            rest: List[tuple] = []
            per_conn: Dict[int, int] = {}
            t_first = staged[0][4]
            for item in staged:
                fd = item[0].fd
                if (len(reqs) >= self.coalesce_max
                        or per_conn.get(fd, 0) >= burst_cap):
                    rest.append(item)
                    continue
                per_conn[fd] = per_conn.get(fd, 0) + 1
                reqs.append(item[3])
                routing.append(item)
            t_submit = time.perf_counter()
            # No explicit budget: submit_many builds its own AFTER the
            # watermark check, so shed groups allocate nothing.
            done, box = batcher.submit_many(reqs)
            with self._stats_lock:
                self.fused_batches += 1
                self.fused_requests += len(reqs)
                self._batch_sizes.append(len(reqs))
                self._coalesce_wait_ms.append((t_submit - t_first) * 1e3)
            if done.is_set():
                # Shed (or an already-resolved stub): reply inline.
                self._resolve(done, box, routing, t_submit)
            else:
                try:
                    self._harvest_q.put_nowait((done, box, routing, t_submit))
                except queue.Full:
                    # Harvester stalled far behind (the cap bounds
                    # admission-queue residents, not drained-but-
                    # unresolved items): the group is ADMITTED — its
                    # tokens will be granted — so resolve it inline
                    # with its REAL box rather than faking a FAIL for
                    # verdicts the device is about to (or did) commit.
                    done.wait(timeout=max(
                        5.0, batcher.deadline_ms / 1000.0 + 1.0))
                    self._resolve(done, box, routing, t_submit)
            staged = rest

    def _harvest_loop(self) -> None:
        batcher = self.server.batcher
        wait_s = max(5.0, batcher.deadline_ms / 1000.0 + 1.0)
        while not self._stop.is_set():
            try:
                done, box, routing, t_submit = self._harvest_q.get(
                    timeout=0.1)
            except queue.Empty:
                continue
            done.wait(timeout=wait_s + len(routing) * 0.01)
            self._resolve(done, box, routing, t_submit)

    def _resolve(self, done, box, routing, t_submit) -> None:
        """Fill every routed reply slot from a completed (or failed)
        group; runs on the harvester thread or, for pre-set groups,
        inline on the reactor thread."""
        results = box.get("results")
        shed_retry = box.get("shed_retry_after_ms")
        t_done = time.perf_counter()
        # Waterfall stamps: admitted groups carry the
        # batcher's drain/dispatch/device marks; together with the
        # reactor-side marks they chain gap-free into the 8-stage
        # record _flush observes. Sheds/fails carry no stamps.
        wf_stamps = box.get("wfStamps") if self._wf is not None else None
        dirty = set()
        dropped = 0
        for k, item in enumerate(routing):
            conn, xid, slot, _req, t_arrival = item[0], item[1], item[2], \
                item[3], item[4]
            result = results[k] if results else None
            slot[0] = build_flow_reply(self.server, xid, result, shed_retry)
            if wf_stamps is not None:
                ctx = _req[3] if len(_req) > 3 else None
                slot[1] = (t_arrival, item[5], t_submit, wf_stamps, t_done,
                           ctx.trace_id if ctx is not None else None)
            if conn.closed:
                dropped += 1
            else:
                dirty.add(conn)
            self._rtt_ms.append((t_done - t_arrival) * 1e3)
        self._queue_wait_ms.append((t_done - t_submit) * 1e3)
        if dropped:
            with self._stats_lock:
                self.dropped_replies += dropped
        if dirty:
            with self._dirty_lock:
                self._dirty.update(dirty)
            self._wake()

    # -- non-FLOW compute (worker pool) ------------------------------------

    def _fill_control(self, conn: _Conn, req: codec.Request, slot) -> None:
        try:
            reply, conn.namespace = process_control_frame(
                self.server, req, conn.remote_entries, conn.namespace)
        except Exception:  # noqa: BLE001 — engine death must not kill I/O
            reply = codec.encode_response(
                req.xid, req.msg_type, TokenResultStatus.FAIL)
        slot[0] = reply

    def _enqueue_task(self, conn: _Conn, req: codec.Request, slot) -> None:
        with conn.task_lock:
            conn.tasks.append((req, slot))
            if not conn.task_running:
                conn.task_running = True
                self._pool.submit(self._run_conn_tasks, conn)

    def _run_conn_tasks(self, conn: _Conn) -> None:
        """Drain one connection's control-frame queue sequentially: a
        connection's ENTRY/EXIT stream keeps its order (the slot ring
        already keeps the REPLY order) while different connections run
        in parallel across the pool."""
        while True:
            with conn.task_lock:
                if not conn.tasks:
                    conn.task_running = False
                    break
                req, slot = conn.tasks.popleft()
            self._fill_control(conn, req, slot)
        with self._dirty_lock:
            self._dirty.add(conn)
        self._wake()

    # -- writes ------------------------------------------------------------

    def _flush(self, conn: _Conn) -> None:
        """Coalesce the contiguous filled reply prefix into ONE buffer
        (never a write per request) and push it down the socket. Slots
        carrying a waterfall stamp record complete their 8-stage chain
        here (reply-slot wait ends at the pick, flush ends after the
        bytes are handed to the socket layer) and land in the recorder."""
        wf = self._wf
        t_pick = time.perf_counter() if wf is not None else 0.0
        chunks = []
        recs = None
        while conn.replies and conn.replies[0][0] is not None:
            slot = conn.replies.popleft()
            chunks.append(slot[0])
            if slot[1] is not None:
                if recs is None:
                    recs = []
                recs.append(slot[1])
        if chunks:
            data = mutate_reply(b"".join(chunks))
            if data:
                conn.outq.append(data)
                conn.out_bytes += len(data)
        self._try_send(conn)
        if recs and wf is not None:
            t_sent = time.perf_counter()
            for (t_arr, t_stg, t_sub, (t_drn, t_dsp, t_dev), t_fill,
                 trace_id) in recs:
                wf.observe_wire((
                    (t_stg - t_arr) * 1e3,   # read: recv -> parse+stage
                    (t_sub - t_stg) * 1e3,   # coalesce: stage -> submit
                    (t_drn - t_sub) * 1e3,   # queue: submit -> drain
                    (t_dsp - t_drn) * 1e3,   # dispatch: drain -> device
                    (t_dev - t_dsp) * 1e3,   # device: dispatch -> harvest
                    (t_fill - t_dev) * 1e3,  # harvest: wake -> slot fill
                    (t_pick - t_fill) * 1e3,  # reply: fill -> flush pick
                    (t_sent - t_pick) * 1e3), trace_id)  # flush

    def _try_send(self, conn: _Conn) -> None:
        while conn.outq:
            head = conn.outq[0]
            try:
                sent = conn.sock.send(
                    memoryview(head)[conn.out_off:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close(conn)
                return
            conn.out_bytes -= sent
            conn.out_off += sent
            if conn.out_off >= len(head):
                conn.outq.popleft()
                conn.out_off = 0
            elif sent == 0:
                break
        if conn.paused and self._backlog(conn) <= self.outbuf_max // 2:
            conn.paused = False
        self._interest(conn)

    # -- cleanup -----------------------------------------------------------

    def _sweep_idle(self, now: float) -> None:
        limit = self.server.idle_timeout_s
        for conn in list(self._conns.values()):
            if now - conn.last_active > limit:
                self._close(conn)

    def _close(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.fd, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.namespace is not None:
            self.server.service.connections.disconnect(conn.namespace)
            conn.namespace = None
        # A dead peer must not leak thread counts: exit whatever its
        # connection still holds (the legacy handler's finally-block
        # semantics — a dropped link is not a biz exception).
        for handle in conn.remote_entries.values():
            try:
                handle.exit()
            except Exception:  # noqa: BLE001 — best-effort drain
                pass
        conn.remote_entries.clear()
        # Unsent slots are simply discarded; droppedReplies counts ONLY
        # verdicts resolved after their connection died (_resolve sees
        # conn.closed) — counting unfilled slots here too would tally
        # the same dropped verdict twice once its harvest lands.
        conn.replies.clear()

    # -- introspection -----------------------------------------------------

    def wire_stats(self) -> dict:
        """Snapshot for the ``sentinel_tpu_wire_*`` families and the
        ``getClusterMode``/dashboard surfaces. Lock-light: deque
        snapshots + plain counters."""
        def pct(ring, q):
            if not ring:
                return 0.0
            return round(float(np.percentile(np.asarray(ring), q)), 3)

        sizes = list(self._batch_sizes)
        return {
            "connections": len(self._conns),
            "connectionsTotal": self.connections_total,
            "fusedBatches": self.fused_batches,
            "fusedRequests": self.fused_requests,
            "coalescedBatchP50": pct(sizes, 50),
            "coalescedBatchMax": max(sizes) if sizes else 0,
            "rttP50Ms": pct(list(self._rtt_ms), 50),
            "rttP99Ms": pct(list(self._rtt_ms), 99),
            "coalesceWaitP50Ms": pct(list(self._coalesce_wait_ms), 50),
            "queueWaitP50Ms": pct(list(self._queue_wait_ms), 50),
            "outbufShed": self.outbuf_shed,
            "droppedReplies": self.dropped_replies,
            "outbufMaxBytes": self.outbuf_max,
            "coalesceMaxBatch": self.coalesce_max,
            "inflightDepth": self.server.batcher.inflight_depth,
        }
