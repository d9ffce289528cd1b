"""The token client (port of ``sentinel_tpu/cluster/client.py``; reference:
``cluster-client:DefaultClusterTokenClient``
+ ``netty/NettyTransportClient`` + ``TokenClientPromiseHolder`` — SURVEY.md
§2.4): one TCP connection, xid-correlated request/response futures, request
timeouts, backoff reconnect, and a namespace PING on connect.

Resilience (sentinel_tpu/resilience/): reconnects follow a seedable
``RetryPolicy`` instead of a fixed cadence, and a ``HealthGate`` breaker
guards the request path — a connected-but-degraded server (slow, hung,
partitioned) trips the gate after consecutive timeouts and token requests
fail fast (no wire touch) until the gate's probe succeeds.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
from typing import Dict, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.cluster.constants import (
    MSG_FLEET,
    MSG_FLOW,
    MSG_PARAM_FLOW,
    MSG_PING,
    TokenResultStatus,
)
from sentinel_tpu_torch.cluster.token_service import TokenResult
from sentinel_tpu_torch.resilience import HealthGate, RetryPolicy, faults


class _GarbageFrame(Exception):
    """Undecodable frame on the wire: the stream is desynced; treated as
    a connection loss (internal to the read loop)."""


class _Gather:
    """Shared completion latch for one pipelined batch: every
    xid of the batch registers THIS object in ``_pending`` instead of
    its own ``threading.Event`` — ``set()`` counts a response down and
    wakes the waiter once, when the LAST response (or drop) lands. One
    wakeup per batch, not per request; duck-types the per-request Event
    for the read loop and ``_drop_connection``, which only call set()."""

    __slots__ = ("_event", "_remaining", "_lock")

    def __init__(self, n: int):
        self._event = threading.Event()
        self._remaining = n
        self._lock = threading.Lock()

    def set(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining > 0:
                return
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


_CONFIG_GATE = object()  # default marker: build the HealthGate from config


class ClusterTokenClient:
    def __init__(self, host: str, port: int, namespace: str = "default",
                 request_timeout_s: float = 2.0,
                 reconnect_interval_s: float = 2.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 health_gate=_CONFIG_GATE,
                 epoch_fence=None,
                 connect_timeout_s: float = 3.0,
                 fence_scope_fn=None):
        self.host = host
        self.port = port
        self.namespace = namespace
        self.request_timeout_s = request_timeout_s
        self.reconnect_interval_s = reconnect_interval_s
        self.connect_timeout_s = connect_timeout_s
        # Leadership-epoch fence (cluster/ha.py): responses stamped with
        # an epoch BELOW the highest this fence has observed are from a
        # deposed leader — rejected as FAIL so split-brain can never
        # double-grant quota. None (default) disables fencing.
        self.epoch_fence = epoch_fence
        # Sharded fencing (cluster/sharding.py): maps a request's
        # flowId to the fence SCOPE its response is judged under (the
        # flow's hash slice, via the shared ``sharding.slice_of``
        # helper) — per-slice leadership terms are independent, so one
        # slice's epoch must never gate another's. None (default)
        # keeps the single global fence lane.
        self.fence_scope_fn = fence_scope_fn
        # Backoff schedule for the reconnect loop: first delay is exactly
        # ``reconnect_interval_s`` (legacy cadence), repeated failures
        # back off with decorrelated jitter instead of hammering a dead
        # or recovering server every 2s forever.
        self.retry_policy = retry_policy or RetryPolicy.from_config(
            "cluster.client", base_ms=int(reconnect_interval_s * 1000),
            max_ms=60_000)
        # ``health_gate=None`` disables the breaker (raw client); the
        # default builds one from csp.sentinel.resilience.breaker.*.
        self.health_gate: Optional[HealthGate] = (
            HealthGate.from_config() if health_gate is _CONFIG_GATE
            else health_gate)
        self._xid = itertools.count(1)
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()  # serialize frame writes
        self._sock: Optional[socket.socket] = None
        self._pending: Dict[int, Tuple[threading.Event, dict]] = {}
        self._reader: Optional[threading.Thread] = None
        self._reconnector: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- connection management --------------------------------------------

    def start(self) -> "ClusterTokenClient":
        self._stop.clear()
        try:
            self._connect()
        except OSError:
            pass  # reconnector keeps trying
        self._reconnector = threading.Thread(
            target=self._reconnect_loop, name="sentinel-token-reconnect",
            daemon=True)
        self._reconnector.start()
        return self

    def _connect(self) -> None:
        # Dial OUTSIDE the lock: a blackholed server must not stall
        # is_connected() readers (the entry() fallback path) for the
        # connect timeout.
        with self._lock:
            if self._sock is not None:
                return
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        # Bounded I/O timeout, derived from the request timeout (was
        # ``settimeout(None)``): with an unbounded socket, a server that
        # stops READING mid-reply leaves ``sendall`` parked forever
        # holding ``_send_lock`` — every later request on this client
        # hangs behind it with no path to the reconnector. Bounded, the
        # stalled write raises and drops the connection like any other
        # wire failure. The read side treats a timeout as an idle tick
        # (no traffic != failure — see ``_read_loop``), so a quiet but
        # healthy connection is never torn down by this.
        sock.settimeout(self._io_timeout_s())
        with self._lock:
            if self._sock is not None:  # raced with another connect
                sock.close()
                return
            self._sock = sock
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,),
            name="sentinel-token-reader", daemon=True)
        self._reader.start()
        # Register the namespace (reference: PingRequest on channel active).
        self._call(MSG_PING, codec.encode_ping(self.namespace))

    def _reconnect_loop(self):
        session = self.retry_policy.session()
        delay_s = session.next_delay_ms() / 1000.0
        while not self._stop.wait(delay_s):
            if self.is_connected():
                session.reset()
                delay_s = session.next_delay_ms() / 1000.0
                continue
            try:
                self._connect()
                session.reset()
            except OSError:
                pass
            delay_s = session.next_delay_ms() / 1000.0

    def _io_timeout_s(self) -> float:
        """Socket send/recv bound: twice the request timeout (a write
        that cannot progress for 2x the longest any caller would wait on
        its reply is a dead peer, not a slow one), floored so a
        pathologically small request timeout can't busy-spin the
        reader."""
        return max(self.request_timeout_s * 2, 0.2)

    def is_connected(self) -> bool:
        with self._lock:
            return self._sock is not None

    def _drop_connection(self):
        with self._lock:
            sock, self._sock = self._sock, None
            pending = list(self._pending.values())
            self._pending.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for done, box in pending:
            done.set()  # fail fast: box stays empty -> FAIL

    def _read_loop(self, sock: socket.socket):
        reader = codec.FrameReader()
        try:
            while True:
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    # Idle tick on the bounded-I/O socket: no traffic
                    # for the timeout window is normal on a quiet
                    # connection — only a real error drops it.
                    continue
                if not data:
                    break
                for body in reader.feed(data):
                    try:
                        resp = codec.decode_response(body)
                    except (ValueError, struct.error, IndexError):
                        # Garbage frame: the length-prefixed stream is
                        # desynced beyond repair — drop the connection
                        # (pending requests fail fast, the reconnector
                        # dials fresh) instead of letting the decode
                        # error kill this thread with the socket open
                        # and every future request left to time out.
                        raise _GarbageFrame()
                    with self._lock:
                        entry = self._pending.pop(resp.xid, None)
                    if entry is not None:
                        entry[1]["resp"] = resp
                        entry[0].set()
        except (OSError, _GarbageFrame):
            pass
        finally:
            self._drop_connection()

    def stop(self) -> None:
        self._stop.set()
        self._drop_connection()
        if self._reconnector is not None:
            self._reconnector.join(timeout=1.0)
            self._reconnector = None

    # -- requests ----------------------------------------------------------

    def _call(self, msg_type: int, entity: bytes,
              timeout_s: Optional[float] = None) -> Optional[codec.Response]:
        xid = next(self._xid)
        done = threading.Event()
        box: dict = {}
        with self._lock:
            sock = self._sock
            if sock is None:
                return None
            self._pending[xid] = (done, box)
        try:
            raw = codec.encode_request(xid, msg_type, entity)
        except (ValueError, struct.error):  # oversized frame: fail this call
            with self._lock:
                self._pending.pop(xid, None)
            return None
        try:
            faults.fire("cluster.client.send")
            with self._send_lock:  # frames must not interleave on the wire
                sock.sendall(raw)
        except OSError:
            self._drop_connection()
            return None
        wait_s = self.request_timeout_s if timeout_s is None \
            else min(timeout_s, self.request_timeout_s)
        if not done.wait(wait_s):
            with self._lock:
                self._pending.pop(xid, None)
            return None
        return box.get("resp")

    def _gated_call(self, msg_type: int, entity: bytes,
                    timeout_s: Optional[float] = None,
                    gate_neutral: bool = False) -> Optional[codec.Response]:
        """`_call` behind the health gate: an OPEN breaker fails fast
        without touching the wire; outcomes feed the gate.

        ``gate_neutral``: a failed call does NOT count against the
        breaker. Deadline-budgeted callers set it when the remaining
        budget is so small that a HEALTHY server could miss it — a miss
        against a starved deadline says nothing about server health, and
        counting it would spuriously trip the gate under load."""
        gate = self.health_gate
        if gate is not None and not gate.allow():
            return None
        resp = self._call(msg_type, entity, timeout_s)
        if gate is not None:
            if resp is not None:
                gate.record_success()
            elif not gate_neutral:
                gate.record_failure()
        return resp

    @staticmethod
    def _read_server_span(entity: bytes, offset: int):
        """Server-side span info TLV from a response entity, or None."""
        tlv = codec.read_trace_tlv(entity, offset)
        if not tlv:
            return None
        info = codec.decode_span_info(tlv)
        if info is None:
            return None
        return {"spanId": info[0], "startMs": info[1], "durationUs": info[2]}

    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False,
                      timeout_s: Optional[float] = None,
                      gate_neutral: bool = False,
                      trace=None) -> TokenResult:
        """One acquire; FAIL on disconnect/timeout/open-breaker — immediate
        (no wire wait) when disconnected or the gate is OPEN; callers
        decide fallback. ``timeout_s`` tightens (never widens) the
        configured request timeout, for deadline-budgeted callers;
        ``gate_neutral`` keeps a starved-deadline miss out of the
        breaker's failure count. ``trace`` (telemetry/spans.py
        TraceContext) rides the wire as a trailing TLV old servers
        ignore; a new server ships its token-service span back in
        ``TokenResult.server_span``."""
        entity = codec.encode_flow_request(flow_id, count, prioritized)
        if trace is not None:
            entity = codec.append_trace_tlv(entity, trace.traceparent())
        resp = self._gated_call(MSG_FLOW, entity, timeout_s, gate_neutral)
        return self._flow_result(resp, traced=trace is not None,
                                 scope=self._scope_for(flow_id))

    def _scope_for(self, flow_id):
        """The fence scope (hash slice) a flow's responses are judged
        under, or None on un-sharded clients."""
        if self.fence_scope_fn is None:
            return None
        return self.fence_scope_fn(flow_id)

    def _flow_result(self, resp: Optional[codec.Response],
                     traced: bool = False, scope=None) -> TokenResult:
        """Decode one FLOW response (epoch fence, OVERLOADED retry-after,
        span TLV) — shared by the per-request and pipelined paths."""
        if resp is None:
            return TokenResult(TokenResultStatus.FAIL)
        if resp.status == TokenResultStatus.WRONG_SLICE:
            # Out-of-slice (cluster/sharding.py): not a verdict and not
            # fenced (the replying leader holds no term for the slice).
            # waitMs mirrors the map-version TLV; prefer the TLV.
            _, wait_ms = codec.decode_flow_response(resp.entity)
            ver = codec.read_map_version_tlv(resp.entity,
                                             codec.FLOW_RESP_SIZE)
            return TokenResult(resp.status,
                               wait_ms=int(ver if ver is not None
                                           else wait_ms))
        if self._epoch_stale(resp.entity, codec.FLOW_RESP_SIZE, scope):
            return TokenResult(TokenResultStatus.FAIL)
        remaining, wait_ms = codec.decode_flow_response(resp.entity)
        span = (self._read_server_span(resp.entity, codec.FLOW_RESP_SIZE)
                if traced else None)
        if resp.status in (TokenResultStatus.SHOULD_WAIT,
                           TokenResultStatus.OVERLOADED):
            # OVERLOADED is a shed, not a verdict: waitMs carries the
            # server's retry-after hint. It reaches the caller as-is —
            # the failover client backs the target off, the engine
            # degrades the entry to its local lease/fallback path.
            return TokenResult(resp.status, wait_ms=wait_ms,
                               server_span=span)
        return TokenResult(resp.status, remaining=remaining,
                           server_span=span)

    def request_tokens_pipelined(self, requests: Sequence[Tuple],
                                 timeout_s: Optional[float] = None,
                                 gate_neutral: bool = False):
        """Batched acquires with >1 request in flight on ONE socket:
        every request gets its own xid, all frames go out as
        ONE coalesced write, and responses are matched back by xid in
        any arrival order — the old path serialized send+wait per call,
        so a single connection could never keep the server's coalescing
        collector fed. Requests are ``(flow_id, count, prioritized)``
        tuples; returns one TokenResult per request, in request order.

        Semantics are per-request identical to :meth:`request_token`
        (epoch fencing, OVERLOADED retry-after, FAIL on drop/timeout);
        the health gate is consulted once for the batch and fed one
        outcome: success if any response arrived, failure (unless
        ``gate_neutral``) if none did."""
        n = len(requests)
        if n == 0:
            return []
        gate = self.health_gate
        if gate is not None and not gate.allow():
            return [TokenResult(TokenResultStatus.FAIL)] * n
        gather = _Gather(n)
        xids = []
        frames = []
        boxes = []
        scopes = [self._scope_for(r[0]) for r in requests]
        with self._lock:
            sock = self._sock
            if sock is None:
                return [TokenResult(TokenResultStatus.FAIL)] * n
            for flow_id, count, prioritized in requests:
                xid = next(self._xid)
                box: dict = {}
                try:
                    frames.append(codec.encode_request(
                        xid, MSG_FLOW, codec.encode_flow_request(
                            flow_id, count, prioritized)))
                except (ValueError, struct.error):
                    # Oversized/garbage request: pre-resolved FAIL slot,
                    # never registered — the gather shrinks accordingly.
                    gather.set()
                    boxes.append(None)
                    xids.append(None)
                    continue
                self._pending[xid] = (gather, box)
                xids.append(xid)
                boxes.append(box)
        try:
            faults.fire("cluster.client.send")
            with self._send_lock:  # frames must not interleave on the wire
                sock.sendall(b"".join(frames))
        except OSError:
            self._drop_connection()  # sets the gather for every pending xid
        wait_s = self.request_timeout_s if timeout_s is None \
            else min(timeout_s, self.request_timeout_s)
        gather.wait(wait_s)
        with self._lock:
            for xid in xids:
                if xid is not None:
                    self._pending.pop(xid, None)
        out = [self._flow_result(box.get("resp"), scope=scopes[k])
               if box is not None
               else TokenResult(TokenResultStatus.FAIL)
               for k, box in enumerate(boxes)]
        if gate is not None:
            if any(b is not None and "resp" in b for b in boxes):
                gate.record_success()
            elif not gate_neutral:
                gate.record_failure()
        return out

    def request_fleet_telemetry(self, since_ms: int = 0,
                                max_seconds: int = 16,
                                timeout_s: Optional[float] = None
                                ) -> Optional[dict]:
        """Pull one fleetTelemetry page: the leader's
        complete seconds strictly after ``since_ms``, its instance
        health, and shard ownership, as a decoded dict (plus
        ``wireEpoch`` when the reply carried the epoch TLV). None on
        disconnect/timeout/garbled payload; ``{"unsupported": True}``
        when the server predates the command (BAD_REQUEST).

        Deliberately NOT behind the health gate: a telemetry scrape
        failing must never trip the breaker the TOKEN path relies on —
        the read plane reports staleness, it doesn't fail admission."""
        resp = self._call(
            MSG_FLEET, codec.encode_fleet_request(since_ms, max_seconds),
            timeout_s)
        if resp is None:
            return None
        if resp.status == TokenResultStatus.BAD_REQUEST:
            return {"unsupported": True}
        if resp.status != TokenResultStatus.OK:
            return None
        payload, end = codec.decode_json_entity(resp.entity)
        if payload is None:
            return None
        epoch = codec.read_epoch_tlv(resp.entity, end)
        if epoch is not None:
            # Reported, never fenced: telemetry is read-only — a stale
            # leader's page is still true history, and rejecting it
            # would inflate the fence's stale counter with reads.
            payload["wireEpoch"] = epoch
        return payload

    def request_population_page(self, timeout_s: Optional[float] = None
                                ) -> Optional[dict]:
        """Pull this leader's namespace-telescope page —
        the ``MSG_FLEET`` message with the ``max_seconds == -1``
        sentinel. None on disconnect/timeout/garbled payload;
        ``{"unsupported": True}`` when the server predates the message
        entirely (BAD_REQUEST) OR answered with a plain seconds page
        (a pre-telescope fleet server that ignored the sentinel).

        Same stance as :meth:`request_fleet_telemetry`: NOT behind the
        health gate — a telescope scrape failing must never trip the
        breaker the token path relies on."""
        resp = self._call(
            MSG_FLEET, codec.encode_fleet_request(0, -1), timeout_s)
        if resp is None:
            return None
        if resp.status == TokenResultStatus.BAD_REQUEST:
            return {"unsupported": True}
        if resp.status != TokenResultStatus.OK:
            return None
        payload, end = codec.decode_json_entity(resp.entity)
        if payload is None:
            return None
        if "population" not in payload:
            return {"unsupported": True}
        epoch = codec.read_epoch_tlv(resp.entity, end)
        if epoch is not None:
            payload["wireEpoch"] = epoch
        page = payload.get("population")
        if page:
            page["leader"] = payload.get("leader")
            page["nowMs"] = payload.get("nowMs")
        return page or {"unsupported": True}

    def request_param_token(self, flow_id: int, count: int, params: Sequence,
                            timeout_s: Optional[float] = None,
                            gate_neutral: bool = False,
                            trace=None) -> TokenResult:
        entity = codec.encode_param_flow_request(flow_id, count, params)
        if trace is not None:
            entity = codec.append_trace_tlv(entity, trace.traceparent())
        resp = self._gated_call(MSG_PARAM_FLOW, entity, timeout_s,
                                gate_neutral)
        if resp is None:
            return TokenResult(TokenResultStatus.FAIL)
        if resp.status == TokenResultStatus.WRONG_SLICE:
            # Param responses carry the shard-map version ONLY in the
            # TLV (no waitMs field in the entity).
            ver = codec.read_map_version_tlv(resp.entity, 0)
            return TokenResult(resp.status,
                               wait_ms=int(ver) if ver is not None else 0)
        if self._epoch_stale(resp.entity, 0, self._scope_for(flow_id)):
            return TokenResult(TokenResultStatus.FAIL)
        span = (self._read_server_span(resp.entity, 0)
                if trace is not None else None)
        return TokenResult(resp.status, server_span=span)

    def _epoch_stale(self, entity: bytes, offset: int, scope=None) -> bool:
        """True when the response's epoch TLV is below the fence's
        high-water mark: a deposed leader replied, and honoring its
        grant could double-spend quota the new leader is also granting.
        ``scope`` keys the fence lane (the flow's hash slice on sharded
        clients — per-slice terms are independent); unstamped responses
        (pre-HA servers) pass through unfenced."""
        fence = self.epoch_fence
        if fence is None:
            return False
        epoch = codec.read_epoch_tlv(entity, offset)
        if epoch is None:
            return False
        return not fence.observe(epoch, scope)
