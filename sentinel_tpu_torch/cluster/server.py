"""The token server's TCP frontend (port of ``sentinel_tpu/cluster/server.py``;
reference:
``cluster-server:netty/NettyTransportServer.java`` + ``TokenServerHandler`` +
``processor/*RequestProcessor`` — SURVEY.md §2.4).

Concurrent client requests are *micro-batched* — each connection enqueues
its decoded request and a collector drains the queue into one
``DefaultTokenService`` device step, so the server's cost per acquire
amortizes across clients (SURVEY.md §7 hard part #1). Single-request
latency still takes at most ``batch_linger_s``.

The ``MSG_FLEET`` branch serves this leader's fleet telemetry page
(``telemetry/fleet.py``), and the ``MSG_STREAM_TICK`` branch lets a
remote gateway drive the engine's streaming reservations (``llm/``):
open, tick, close and abort. A sharded leader (``cluster/sharding.py``)
answers a flow outside its slices WRONG_SLICE: no epoch TLV, the
shard-map version in a TLV of its own (and in ``waitMs`` of a flow
reply).
"""

from __future__ import annotations

import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Optional, Tuple

from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.cluster.constants import (
    MSG_ENTRY,
    MSG_EXIT,
    MSG_FLEET,
    MSG_FLOW,
    MSG_PARAM_FLOW,
    MSG_PING,
    MSG_STREAM_TICK,
    STREAM_OP_ABORT,
    STREAM_OP_CLOSE,
    STREAM_OP_OPEN,
    STREAM_OP_TICK,
    TokenResultStatus,
)
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.resilience import DeadlineBudget, faults


def pad_width(n_flat: int) -> int:
    """Device batch width for ``n_flat`` requests: exact up to 64, then a
    coarse ladder (256, 1024, 4096, +4096...), the reference's widths, so
    both packages run the same batches (the padding lanes are unknown
    flows and commit nothing)."""
    if n_flat <= 64:
        return n_flat
    width = 256
    while width < n_flat:
        width = width * 4 if width < 4096 else width + 4096
    return width


class _Batcher:
    """Collects flow-token requests into one device step per linger tick.

    Requests arrive as GROUPS (a pipelined client burst shares one
    group): one Event + one results list per group instead of per
    request. ``max_batch`` is a soft cap at group granularity: a drained
    group is never split across device calls.

    Overload-safe admission: the queue is BOUNDED at
    ``max_queue_groups`` and every group carries a ``DeadlineBudget``.
    Submissions over the watermark (or against a full queue) are shed
    immediately — ``box["shed_retry_after_ms"]`` instead of results, the
    frontend replies OVERLOADED — and the drain loop sheds groups whose
    deadline expired while queued BEFORE spending a device step on them.
    Shedding happens strictly before ``request_tokens``: a shed request
    is never half-admitted (docs/SEMANTICS.md "Shed-before-admission").
    """

    def __init__(self, service: DefaultTokenService, linger_s: float, max_batch: int,
                 crash_cb=None, max_queue_groups: Optional[int] = None,
                 watermark_pct: Optional[int] = None,
                 deadline_ms: Optional[int] = None,
                 retry_after_ms: Optional[int] = None,
                 inflight_depth: Optional[int] = None):
        self.service = service
        self.linger_s = linger_s
        self.max_batch = max_batch
        # Pipelined drain: up to this many fused batches ride the device
        # stream at once via the token service's dispatch/harvest split.
        # Depth 1 (or a service without dispatch_tokens) is the
        # synchronous drain.
        self.inflight_depth = int(
            inflight_depth if inflight_depth is not None
            else config.wire_inflight_depth())
        # Leader-crash seam (resilience/faults.py "cluster.ha.leader.crash"):
        # fired per drained batch; when armed, ``crash_cb`` hard-kills the
        # owning server — the chaos suite's process-crash analog.
        self.crash_cb = crash_cb
        self.max_queue_groups = int(
            max_queue_groups if max_queue_groups is not None
            else config.overload_queue_max_groups())
        pct = int(watermark_pct if watermark_pct is not None
                  else config.overload_queue_watermark_pct())
        self.watermark_groups = max(1, self.max_queue_groups * pct // 100)
        self.deadline_ms = int(deadline_ms if deadline_ms is not None
                               else config.overload_deadline_ms())
        self.retry_after_ms = int(retry_after_ms if retry_after_ms is not None
                                  else config.overload_retry_after_ms())
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue_groups)
        self._stats_lock = threading.Lock()
        # Submit-time sheds are terminal and identical for every caller,
        # so they share ONE pre-set Event and ONE immutable box — the
        # shed path allocates NOTHING per request or per group. Admitted
        # groups still get their own event: one wakeup per GROUP, never
        # per request.
        self._shed_done = threading.Event()
        self._shed_done.set()
        self._shed_box = {"shed_retry_after_ms": self.retry_after_ms}
        self.groups_allocated = 0
        self.admitted_groups = 0
        self.admitted_requests = 0
        self.shed_watermark = 0
        self.shed_queue_full = 0
        self.shed_deadline_expired = 0
        self.shed_requests = 0
        self.queue_depth_max = 0
        # Latency waterfall recorder, attached by the owning server at
        # start when its engine has one. When set, each fused batch stamps drain/dispatch/
        # device marks into its groups' boxes (three perf_counter reads
        # per BATCH — nothing per request, nothing on the shed path).
        self.waterfall = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _shed(self, box: dict, done: threading.Event, n_requests: int,
              cause: str) -> None:
        with self._stats_lock:
            setattr(self, cause, getattr(self, cause) + 1)
            self.shed_requests += n_requests
        box["shed_retry_after_ms"] = self.retry_after_ms
        done.set()

    def _shed_fast(self, n_requests: int, cause: str):
        """Submit-time shed: counters only — the reply rides the SHARED
        pre-set event + immutable box (zero allocations per shed)."""
        with self._stats_lock:
            setattr(self, cause, getattr(self, cause) + 1)
            self.shed_requests += n_requests
        return self._shed_done, self._shed_box

    def submit_many(self, requests, budget: Optional[DeadlineBudget] = None):
        """One group: ``(done_event, box)``; ``box["results"]`` carries
        one TokenResult per request (absent on a failed device call), or
        ``box["shed_retry_after_ms"]`` when the group was shed instead of
        admitted. ``budget`` is the group's remaining deadline (defaults
        to the configured overload deadline)."""
        reqs = list(requests)
        # Watermark shed: past the high-water mark the queue is already
        # deeper than a healthy drain can clear inside a deadline, so an
        # explicit "not now" beats silently joining the backlog.
        if self._queue.qsize() >= self.watermark_groups:
            return self._shed_fast(len(reqs), "shed_watermark")
        if budget is None:
            budget = DeadlineBudget(self.deadline_ms)
        done = threading.Event()
        box: dict = {}
        try:
            self._queue.put_nowait((reqs, done, box, budget))
        except queue.Full:
            return self._shed_fast(len(reqs), "shed_queue_full")
        with self._stats_lock:
            self.groups_allocated += 1
            self.admitted_groups += 1
            self.admitted_requests += len(reqs)
            depth = self._queue.qsize()
            if depth > self.queue_depth_max:
                self.queue_depth_max = depth
        return done, box

    def shed_rate(self) -> float:
        """Cumulative shed fraction: shed requests over everything that
        reached admission. The SLO engine's health score consumes the
        DELTA of the underlying counters between evaluations; this ratio
        is the ops-glance form."""
        denom = self.shed_requests + self.admitted_requests
        return self.shed_requests / float(denom) if denom else 0.0

    def overload_stats(self) -> dict:
        """Lock-free read (the /metrics scrape path): counters are plain
        ints, a racing scrape just sees a near-instant snapshot."""
        return {
            "queueDepth": self._queue.qsize(),
            "queueDepthMax": self.queue_depth_max,
            "queueLimitGroups": self.max_queue_groups,
            "watermarkGroups": self.watermark_groups,
            "admittedGroups": self.admitted_groups,
            "admittedRequests": self.admitted_requests,
            "shedRate": self.shed_rate(),
            "shedWatermark": self.shed_watermark,
            "shedQueueFull": self.shed_queue_full,
            "shedDeadlineExpired": self.shed_deadline_expired,
            "shedRequests": self.shed_requests,
            "deadlineMs": self.deadline_ms,
        }

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="sentinel-token-batcher", daemon=True)
        self._thread.start()
        return self

    def _fail(self, groups) -> None:
        for _reqs, done, _box, _budget in groups:
            done.set()  # empty box -> handler replies FAIL

    def _complete(self, groups, results, wf_stamps=None) -> None:
        off = 0
        for reqs, done, box, _budget in groups:
            box["results"] = results[off:off + len(reqs)]
            if wf_stamps is not None:
                box["wfStamps"] = wf_stamps
            off += len(reqs)
            done.set()

    def _harvest(self, ticket, groups, n_flat: int,
                 t_drain: float = 0.0, t_dispatch: float = 0.0) -> None:
        """Resolve one in-flight fused batch: the np readback happens
        here, outside the service lock — an async device death fails
        exactly this batch's groups (the drain loop keeps running)."""
        try:
            results = self.service.harvest_tokens(ticket)[:n_flat]
        except Exception as ex:  # noqa: BLE001 — poison harvest
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn("token batch harvest failed: %r", ex)
            self._fail(groups)
            return
        wf = self.waterfall
        if wf is not None:
            t_device = time.perf_counter()
            wf.observe_batch((t_device - t_dispatch) * 1e3, n_flat)
            self._complete(groups, results, (t_drain, t_dispatch, t_device))
        else:
            self._complete(groups, results)

    def _run(self):
        from collections import deque

        # In-flight fused batches (ticket, groups, n_flat, t_drain,
        # t_dispatch), oldest first.
        inflight: "deque" = deque()
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                while inflight:  # idle: resolve whatever still rides
                    self._harvest(*inflight.popleft())
                continue
            # Waterfall "queue" stage boundary: one drain stamp per
            # fused batch (groups folded in during the linger below
            # attribute their residual queue time to "dispatch" — the
            # stage chain stays gap-free either way, SEMANTICS.md).
            t_drain = time.perf_counter()
            groups = [first]
            try:
                faults.fire("cluster.ha.leader.crash")
            except OSError:
                # The "process" dies mid-batch: fail the in-flight group
                # fast (its handler replies FAIL an instant before the
                # sockets close) and hard-stop the server off-thread.
                # Requests granted but not yet checkpointed are exactly
                # the over-admission margin failover is allowed.
                first[1].set()
                if self.crash_cb is not None:
                    threading.Thread(target=self.crash_cb,
                                     daemon=True).start()
                self._stop.set()
                return
            # Linger briefly so concurrent clients fold into one step.
            deadline = threading.Event()
            deadline.wait(self.linger_s)
            n = len(first[0])
            while n < self.max_batch:
                try:
                    g = self._queue.get_nowait()
                except queue.Empty:
                    break
                groups.append(g)
                n += len(g[0])
            # Deadline-aware shed BEFORE the device step: a group whose
            # budget expired while queued is dead weight — its client
            # already timed out — and spending a device step on it only
            # delays the still-live groups behind it. Shed here is also
            # the half-admission proof point: expiry is checked strictly
            # before request_tokens, so no shed request ever holds a
            # granted token (docs/SEMANTICS.md "Shed-before-admission").
            live = []
            for g in groups:
                if g[3].expired:
                    self._shed(g[2], g[1], len(g[0]),
                               "shed_deadline_expired")
                else:
                    live.append(g)
            groups = live
            if not groups:
                continue
            flat = [r for g in groups for r in g[0]]
            # The reference's batch widths (pad_width): small batches at
            # their exact width, larger bursts on a coarse ladder; padding
            # rows carry a None flow id -> slot -1 -> NO_RULE_EXISTS and
            # are sliced off.
            n_flat = len(flat)
            width = pad_width(n_flat)
            padded = flat + [(None, 0, False)] * (width - n_flat)
            dispatch = getattr(self.service, "dispatch_tokens", None)
            if dispatch is None or self.inflight_depth <= 1:
                # Synchronous drain: services without the dispatch/
                # harvest split (stubs), or depth pinned to 1.
                t_dispatch = time.perf_counter()
                try:
                    results = self.service.request_tokens(padded)[:n_flat]
                except Exception as ex:  # a poison batch must not kill the loop
                    from sentinel_tpu_torch.log.record_log import record_log

                    record_log.warn("token batch failed: %r", ex)
                    self._fail(groups)
                    continue
                wf = self.waterfall
                if wf is not None:
                    t_device = time.perf_counter()
                    wf.observe_batch((t_device - t_dispatch) * 1e3, n_flat)
                    self._complete(groups, results,
                                   (t_drain, t_dispatch, t_device))
                else:
                    self._complete(groups, results)
                continue
            # Pipelined drain: keep at most inflight_depth fused batches
            # on the device stream. Each dispatch reads the previous
            # batch's state on the same stream, so execution order is
            # forced by the data dependency — verdicts stay bit-identical
            # to the sync drain.
            while len(inflight) >= self.inflight_depth:
                self._harvest(*inflight.popleft())
            try:
                ticket = dispatch(padded)
            except Exception as ex:  # a poison dispatch must not kill the loop
                from sentinel_tpu_torch.log.record_log import record_log

                record_log.warn("token batch dispatch failed: %r", ex)
                self._fail(groups)
                continue
            inflight.append((ticket, groups, n_flat,
                             t_drain, time.perf_counter()))
            if self._queue.empty():
                # Idle queue ⇒ immediate harvest: the no-concurrency
                # latency floor stays one step, overlap only engages
                # when there is follow-on work to overlap with.
                while inflight:
                    self._harvest(*inflight.popleft())
        while inflight:  # stop(): every submitted group still resolves
            self._harvest(*inflight.popleft())

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


def stamp_epoch(server: "ClusterTokenServer", entity: bytes,
                epoch: Optional[int] = None) -> bytes:
    """Append the leader's epoch TLV (the HA fence) to a token response
    entity; epoch 0 (pre-HA) keeps the wire format byte-identical.
    ``epoch`` overrides the stamped value with a PER-SLICE term
    (cluster/sharding.py: each verdict carries the fencing epoch of the
    slice it was granted under). With no override, a SHARDED service
    stamps nothing — its flat service epoch is the max over owned
    slices, and stamping that under another slice's fence lane would
    poison honest lower-epoch slices. The payload passes the
    ``cluster.ha.stale.epoch`` mutate seam so a test can replay a
    deposed epoch."""
    if epoch is None:
        epoch = 0 if getattr(server.service, "shard", None) is not None \
            else server.service.epoch
    if not epoch:
        return entity
    return codec.append_epoch_tlv(entity, faults.mutate(
        "cluster.ha.stale.epoch", codec.encode_epoch_value(epoch)))


def mutate_reply(data: bytes) -> bytes:
    """Every reply write passes the ``cluster.server.frame`` fault
    point, so the chaos suite can corrupt/delay/kill server->client
    bytes without a proxy — and the ``cluster.ha.halfopen`` seam,
    whose garbage=b"" mode swallows replies with the connection left
    up (a half-open socket the client must time out of). Shared by the
    legacy handler and the reactor flush path."""
    return faults.mutate("cluster.ha.halfopen",
                         faults.mutate("cluster.server.frame", data))


def build_flow_reply(server: "ClusterTokenServer", xid: int, result,
                     shed_retry) -> bytes:
    """One FLOW response frame from a batcher outcome — the ONE reply
    encoder both frontends (legacy handler, reactor) share, so the wire
    bytes can never drift between them."""
    if shed_retry is not None:
        # Admission-queue shed: explicit OVERLOADED with a retry-after
        # hint in the waitMs field — never a silent queue or hung socket.
        return codec.encode_response(
            xid, MSG_FLOW, TokenResultStatus.OVERLOADED,
            stamp_epoch(server, codec.encode_flow_response(0, shed_retry)))
    if result is None:
        return codec.encode_response(xid, MSG_FLOW, TokenResultStatus.FAIL)
    entity = codec.encode_flow_response(result.remaining, result.wait_ms)
    if result.server_span is not None:
        sp = result.server_span
        entity = codec.append_trace_tlv(
            entity, codec.encode_span_info(
                sp["spanId"], sp["startMs"], sp["durationUs"]))
    if result.status == TokenResultStatus.WRONG_SLICE:
        # Out-of-slice (cluster/sharding.py): no epoch TLV — this
        # leader holds no term for the slice, and stamping one would
        # poison the client's per-slice fence lane. The shard-map
        # version rides a dedicated TLV (and mirrors in waitMs) so the
        # mis-routed client can tell how stale its map is.
        entity = codec.append_map_version_tlv(entity, result.wait_ms)
        return codec.encode_response(xid, MSG_FLOW, result.status, entity)
    # Epoch AFTER the span TLV: pre-HA clients read the span at a
    # fixed offset. Sharded verdicts stamp their PER-SLICE epoch
    # (TokenResult.epoch); unsharded replies keep the service epoch.
    entity = stamp_epoch(server, entity, getattr(result, "epoch", None))
    return codec.encode_response(xid, MSG_FLOW, result.status, entity)


def process_control_frame(server: "ClusterTokenServer", req: codec.Request,
                          remote_entries: dict, namespace):
    """Handle every non-FLOW message type; -> (reply_bytes, namespace').

    Shared by the legacy thread-per-connection handler and the reactor's
    worker pool — one implementation, so the two frontends answer
    byte-identically (pinned by test_wire's wire-compat test)."""
    if req.msg_type == MSG_PING:
        ns = codec.decode_ping(req.entity)
        if namespace is None and ns:
            server.service.connections.connect(ns)
            namespace = ns
        return (codec.encode_response(
            req.xid, MSG_PING, TokenResultStatus.OK), namespace)
    if req.msg_type == MSG_PARAM_FLOW:
        from sentinel_tpu_torch.telemetry.spans import parse_traceparent

        flow_id, count, params = codec.decode_param_flow_request(req.entity)
        tp = codec.read_trace_tlv(
            req.entity, codec.param_flow_request_size(req.entity))
        ctx = parse_traceparent(tp) if tp else None
        result = server.service.request_param_token(
            flow_id, count, params, trace=ctx)
        entity = b""
        if result.server_span is not None:
            sp = result.server_span
            entity = codec.append_trace_tlv(
                b"", codec.encode_span_info(
                    sp["spanId"], sp["startMs"], sp["durationUs"]))
        if result.status == TokenResultStatus.WRONG_SLICE:
            # Param responses have no waitMs field: the map-version TLV
            # is the ONLY carrier here (no epoch TLV — see
            # build_flow_reply's out-of-slice note).
            entity = codec.append_map_version_tlv(entity, result.wait_ms)
        else:
            entity = stamp_epoch(server, entity,
                                 getattr(result, "epoch", None))
        return (codec.encode_response(
            req.xid, MSG_PARAM_FLOW, result.status, entity), namespace)
    if req.msg_type == MSG_ENTRY:
        resource, origin, count, etype, prio, params = \
            codec.decode_entry_request(req.entity)
        handle, reason = server.remote_entry(
            resource, origin, count, etype, prio, params)
        if handle is not None:
            entry_id = server.next_entry_id()
            remote_entries[entry_id] = handle
            return (codec.encode_response(
                req.xid, MSG_ENTRY, TokenResultStatus.OK,
                codec.encode_entry_response(entry_id, 0)), namespace)
        if reason < 0:  # engine unavailable, fail-open on the JVM
            return (codec.encode_response(
                req.xid, MSG_ENTRY, TokenResultStatus.FAIL,
                codec.encode_entry_response(0, 0)), namespace)
        return (codec.encode_response(
            req.xid, MSG_ENTRY, TokenResultStatus.BLOCKED,
            codec.encode_entry_response(0, reason)), namespace)
    if req.msg_type == MSG_FLEET:
        # Fleet telemetry pull: this leader's flight-recorder spill page,
        # instance health and shard ownership, epoch-stamped like any
        # token reply; shared by both frontends.
        from sentinel_tpu_torch.telemetry.fleet import (
            leader_fleet_payload,
            leader_population_payload,
        )

        try:
            since_ms, max_s = codec.decode_fleet_request(req.entity)
            # max_seconds == -1 selects the population page (same
            # message, no new opcode).
            if max_s == -1:
                entity = stamp_epoch(server, leader_population_payload(
                    server))
            else:
                entity = stamp_epoch(
                    server, leader_fleet_payload(server, since_ms, max_s))
            return (codec.encode_response(
                req.xid, MSG_FLEET, TokenResultStatus.OK, entity), namespace)
        except Exception:  # noqa: BLE001 — a read must never kill the conn
            return (codec.encode_response(
                req.xid, MSG_FLEET, TokenResultStatus.FAIL), namespace)
    if req.msg_type == MSG_STREAM_TICK:
        # Streaming reservations (llm/): a remote gateway drives the
        # engine's reservation ledger over the token wire. Shared by both
        # frontends; a tick must never kill the connection.
        from sentinel_tpu_torch.core.exceptions import BlockException

        try:
            op, sid, model, tokens = codec.decode_stream_request(req.entity)
        except (IndexError, ValueError, struct.error):
            return (codec.encode_response(
                req.xid, MSG_STREAM_TICK,
                TokenResultStatus.BAD_REQUEST), namespace)
        eng = server.engine
        if eng is None:
            return (codec.encode_response(
                req.xid, MSG_STREAM_TICK, TokenResultStatus.FAIL), namespace)
        try:
            if op == STREAM_OP_OPEN:
                lease = eng.stream_open(
                    sid, model, None if tokens < 0 else tokens)
                remaining = int(lease.remaining)
            elif op == STREAM_OP_TICK:
                remaining = int(eng.stream_tick(sid, max(0, tokens)))
            elif op in (STREAM_OP_CLOSE, STREAM_OP_ABORT):
                remaining = int(eng.stream_close(
                    sid, aborted=op == STREAM_OP_ABORT))
            else:
                return (codec.encode_response(
                    req.xid, MSG_STREAM_TICK,
                    TokenResultStatus.BAD_REQUEST), namespace)
        except BlockException:
            return (codec.encode_response(
                req.xid, MSG_STREAM_TICK, TokenResultStatus.BLOCKED,
                codec.encode_stream_response(0)), namespace)
        except (KeyError, ValueError, OverflowError):
            return (codec.encode_response(
                req.xid, MSG_STREAM_TICK,
                TokenResultStatus.BAD_REQUEST), namespace)
        except Exception:  # noqa: BLE001 — a tick must never kill the conn
            return (codec.encode_response(
                req.xid, MSG_STREAM_TICK, TokenResultStatus.FAIL), namespace)
        return (codec.encode_response(
            req.xid, MSG_STREAM_TICK, TokenResultStatus.OK,
            codec.encode_stream_response(remaining)), namespace)
    if req.msg_type == MSG_EXIT:
        entry_id, error, count = codec.decode_exit_request(req.entity)
        handle = remote_entries.pop(entry_id, None)
        if handle is None:
            return (codec.encode_response(
                req.xid, MSG_EXIT, TokenResultStatus.BAD_REQUEST), namespace)
        if error:
            handle.trace(None)  # biz exception on the JVM side
        handle.exit(count if count >= 0 else None)
        return (codec.encode_response(
            req.xid, MSG_EXIT, TokenResultStatus.OK), namespace)
    return (codec.encode_response(
        req.xid, req.msg_type, TokenResultStatus.BAD_REQUEST), namespace)


class _Handler(socketserver.BaseRequestHandler):
    def _send(self, data: bytes) -> None:
        """Reply write through :func:`mutate_reply`'s chaos seams."""
        data = mutate_reply(data)
        if data:
            self.request.sendall(data)

    def _stamp_epoch(self, entity: bytes) -> bytes:
        return stamp_epoch(self.server.token_server, entity)

    def handle(self):
        server: "ClusterTokenServer" = self.server.token_server
        reader = codec.FrameReader()
        namespace: Optional[str] = None
        # Live remote entries on THIS connection (the M4 slot-chain
        # bridge): id -> EntryHandle. Ids come from a SERVER-wide
        # counter: a reconnecting bridge keeps stale ids in its
        # thread-local stacks, and per-connection numbering restarting
        # at 1 would let those stale ids alias (and exit) a fresh
        # entry's id on the new connection. Globally-unique
        # ids make a stale exit a harmless BAD_REQUEST instead. The map
        # stays per-connection so one peer can never exit another's.
        self._remote_entries = {}
        # Configurable idle timeout: a silent peer
        # holds a handler thread + its remote-entry map for at most this
        # long before the connection is reaped.
        self.request.settimeout(server.idle_timeout_s)
        try:
            while True:
                data = self.request.recv(65536)
                if not data:
                    break
                reqs = [codec.decode_request(b) for b in reader.feed(data)]
                i = 0
                while i < len(reqs):
                    if reqs[i].msg_type == MSG_FLOW:
                        # Pipelined FLOW runs go to the batcher as ONE
                        # group before any reply is awaited — otherwise
                        # a client's burst of N degrades to N sequential
                        # linger+device-step cycles — and the replies go
                        # out as ONE write.
                        from sentinel_tpu_torch.telemetry.spans import (
                            parse_traceparent)

                        j = i
                        burst = []
                        # Per-connection concurrency cap: a pipelined
                        # burst larger than conn.max.burst is split into
                        # sequential groups (each awaited before the
                        # next is read), so one connection can occupy at
                        # most one bounded group in the admission queue
                        # — TCP backpressure does the rest.
                        while (j < len(reqs)
                               and reqs[j].msg_type == MSG_FLOW
                               and len(burst) < server.conn_max_burst):
                            # Optional trailing trace TLV (spans): a
                            # traced request becomes a 4-tuple the token
                            # service records a server span for.
                            tp = codec.read_trace_tlv(
                                reqs[j].entity, codec.FLOW_REQ_SIZE)
                            ctx = parse_traceparent(tp) if tp else None
                            r = codec.decode_flow_request(reqs[j].entity)
                            burst.append(
                                (reqs[j].xid,
                                 r + (ctx,) if ctx is not None else r))
                            j += 1
                        done, box = server.batcher.submit_many(
                            [r for _, r in burst])
                        # Wait at least the group's deadline budget: a
                        # shorter wait would reply FAIL while the group
                        # is still live in the queue, and the drain
                        # could then commit its tokens AFTER the reply —
                        # the half-admission window SEMANTICS.md's
                        # deadline-shed bound promises stays closed.
                        done.wait(timeout=max(
                            5, server.batcher.deadline_ms / 1000 + 1)
                            + len(burst) * 0.01)
                        results = box.get("results")
                        shed_retry = box.get("shed_retry_after_ms")
                        server_obj = self.server.token_server
                        replies = [
                            build_flow_reply(
                                server_obj, xid,
                                results[k] if results else None, shed_retry)
                            for k, (xid, _r) in enumerate(burst)
                        ]
                        self._send(b"".join(replies))
                        i = j
                    else:
                        namespace = self._process(server, reqs[i], namespace)
                        i += 1
        except OSError:
            pass
        finally:
            if namespace is not None:
                server.service.connections.disconnect(namespace)
            # A dead JVM must not leak thread counts: exit whatever its
            # connection still holds (reference analog: CtEntry cleanup;
            # the error flag stays False — a dropped link is not a biz
            # exception, and RT for these is honest wall time to now).
            for handle in self._remote_entries.values():
                try:
                    handle.exit()
                except Exception:  # noqa: BLE001 — best-effort drain
                    pass
            self._remote_entries.clear()

    def _process(self, server, req: codec.Request, namespace):
        # NOTE: no MSG_FLOW arm — handle() consumes every FLOW frame in
        # its burst branch (a lone frame is a burst of one). All other
        # types route through the SHARED process_control_frame, the same
        # implementation the reactor's worker pool runs.
        reply, namespace = process_control_frame(
            server, req, self._remote_entries, namespace)
        self._send(reply)
        return namespace


class _ThreadingTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # Connection-storm headroom: the socketserver default backlog of 5
    # refuses/falls over under a fleet-wide reconnect (e.g. right after
    # a leader promotion — exactly when every client dials at once).
    # Accepted connections are cheap (one parked thread each until the
    # idle timeout reaps them); the admission QUEUE is what stays
    # bounded.
    request_queue_size = 256


class ClusterTokenServer:
    """Embedded-or-standalone token server (``SentinelDefaultTokenServer``).

    Two frontends share this facade (and every seam: the batcher, the
    chaos fault points, the shared reply encoders):

    * the REACTOR (cluster/reactor.py, default): one selectors-based
      I/O loop multiplexing every connection, zero-copy TLV parse, and
      a coalescing collector folding ALL ready connections into
      pipelined fused-step batches;
    * the legacy thread-per-connection socketserver (``reactor=False``
      or ``csp.sentinel.wire.reactor.enabled=false``), kept as the
      wire-compat reference implementation.
    """

    def __init__(self, service: Optional[DefaultTokenService] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 batch_linger_s: float = 0.0005, max_batch: int = 256,
                 engine=None, max_queue_groups: Optional[int] = None,
                 watermark_pct: Optional[int] = None,
                 deadline_ms: Optional[int] = None,
                 idle_timeout_s: Optional[int] = None,
                 conn_max_burst: Optional[int] = None,
                 reactor: Optional[bool] = None):
        # No service given: one on the engine's device (an engine given
        # with device="cpu" gets a CPU service), else on cuda.
        self.service = service or DefaultTokenService(
            device=getattr(engine, "device", None))
        self.host = host
        self.port = port
        self.reactor_enabled = bool(
            config.wire_reactor_enabled() if reactor is None else reactor)
        self.idle_timeout_s = int(
            idle_timeout_s if idle_timeout_s is not None
            else config.overload_idle_timeout_s())
        self.conn_max_burst = int(
            conn_max_burst if conn_max_burst is not None
            else config.overload_conn_max_burst())
        self.batcher = _Batcher(self.service, batch_linger_s, max_batch,
                                crash_cb=self._fault_crash,
                                max_queue_groups=max_queue_groups,
                                watermark_pct=watermark_pct,
                                deadline_ms=deadline_ms)
        self.crashed = False
        self._server: Optional[_ThreadingTCP] = None
        self._thread: Optional[threading.Thread] = None
        self._reactor = None
        # Engine serving MSG_ENTRY/MSG_EXIT (the M4 slot-chain bridge).
        # None -> the process default engine, resolved lazily so merely
        # constructing a token server never boots the engine singleton.
        self._engine = engine
        self._entry_id_lock = threading.Lock()
        self._entry_id = 0

    def next_entry_id(self) -> int:
        """Server-unique remote-entry id (never reused across
        connections — see _Handler.handle's aliasing note)."""
        with self._entry_id_lock:
            self._entry_id += 1
            return self._entry_id

    @property
    def engine(self):
        if self._engine is None:
            import sentinel_tpu_torch

            self._engine = sentinel_tpu_torch.get_engine()
        return self._engine

    def remote_entry(self, resource: str, origin: str, count: int,
                     entry_type: int, prioritized: bool, params):
        """Run the FULL local slot chain for a remote (JVM) caller.

        Returns ``(handle, 0)`` on pass, ``(None, reason>0)`` on block,
        ``(None, -1)`` when the engine is unusable (the bridge's wire
        FAIL -> the JVM falls open, mirroring fallbackToLocalOrPass).

        Each remote entry runs in its OWN context object (name
        ``sentinel_remote_context``, the caller's origin): connection
        threads interleave entries from many JVM threads, so borrowing
        the connection thread's context would corrupt parent/child
        chains. The handle keeps its context alive; exit may happen on
        any thread (engine._do_exit tolerates out-of-order pops)."""
        from sentinel_tpu_torch.core import context as ctx_mod
        from sentinel_tpu_torch.core.exceptions import (
            BlockException,
            reason_for_exception,
        )

        prev = ctx_mod.get_context()
        ctx_mod.replace_context(None)
        try:
            ctx_mod.enter("sentinel_remote_context", origin)
            handle = self.engine.entry(
                resource, entry_type, count, tuple(params), prioritized)
            return handle, 0
        except BlockException as ex:
            return None, reason_for_exception(ex)
        except Exception:  # noqa: BLE001 — engine death must fail open
            return None, -1
        finally:
            ctx_mod.replace_context(prev)

    @property
    def bound_port(self) -> int:
        if self._reactor is not None:
            return self._reactor.bound_port
        return self._server.server_address[1] if self._server else self.port

    def waterfall_recorder(self):
        """The engine's latency-waterfall recorder WITHOUT booting the
        engine singleton: an explicitly-passed engine wins; otherwise
        only an ALREADY-booted process engine attaches (constructing a
        bare token server must stay engine-free). None when there is no
        engine yet or capture is disabled."""
        eng = self._engine
        if eng is None:
            import sentinel_tpu_torch

            eng = sentinel_tpu_torch._default_engine
        wf = getattr(eng, "waterfall", None) if eng is not None else None
        return wf if wf is not None and wf.enabled else None

    def attach_waterfall(self, recorder) -> None:
        """Late attach (an engine booted after ``start()``): hands the
        recorder to the batcher and the reactor frontend."""
        self.batcher.waterfall = recorder
        if self._reactor is not None:
            self._reactor.attach_waterfall(recorder)

    def start(self) -> "ClusterTokenServer":
        # Bind BEFORE starting the batcher drain thread: a failed bind
        # (EADDRINUSE on a role flip) must leave nothing running — the
        # caller retries, and a leaked drain thread per attempt would
        # accumulate (both frontends bind synchronously here).
        self.batcher.waterfall = self.waterfall_recorder()
        if self.reactor_enabled:
            from sentinel_tpu_torch.cluster.reactor import WireReactor

            self._reactor = WireReactor(self).start()
            self.batcher.start()
            return self
        self._server = _ThreadingTCP((self.host, self.port), _Handler)
        self._server.token_server = self
        self.batcher.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="sentinel-token-server", daemon=True)
        self._thread.start()
        return self

    @property
    def epoch(self) -> int:
        """Leadership epoch stamped into every token response (0 = no
        stamp, the pre-HA wire format)."""
        return self.service.epoch

    def overload_stats(self) -> dict:
        """Frontend overload snapshot: admission-queue depth/bounds and
        shed counters (the ``sentinel_tpu_overload_*`` gauges' source)."""
        return {
            **self.batcher.overload_stats(),
            "idleTimeoutS": self.idle_timeout_s,
            "connMaxBurst": self.conn_max_burst,
            "reactor": self.reactor_enabled,
        }

    def wire_stats(self) -> Optional[dict]:
        """Reactor wire-path snapshot (connections, coalesced batch
        sizes, RTT split, outbuf sheds — the ``sentinel_tpu_wire_*``
        gauges' source), or None on the legacy frontend."""
        if self._reactor is None:
            return None
        return self._reactor.wire_stats()

    def _fault_crash(self) -> None:
        """Hard-kill for the ``cluster.ha.leader.crash`` fault point: the
        process-crash analog — listener and connections close, no drain,
        no checkpoint publish. ``crashed`` lets the HA layer distinguish
        this from a graceful stop."""
        self.crashed = True
        self.stop()

    def stop(self) -> None:
        self.batcher.stop()
        if self._reactor is not None:
            self._reactor.stop()
            self._reactor = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
