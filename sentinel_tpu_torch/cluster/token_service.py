"""The token service: global-quota admission (port of
``sentinel_tpu/cluster/token_service.py``; reference:
``cluster-server:DefaultTokenService.java`` + ``flow/ClusterFlowChecker.java``
+ ``flow/statistic/*`` + ``connection/ConnectionManager.java`` +
``flow/statistic/limit/GlobalRequestLimiter.java`` — SURVEY.md §2.4, §3.3).

All flow rules' global sliding windows live in one RowWindow tensor on
the service's device; :func:`acquire_step` evaluates a whole batch of
token requests at once (rotation → per-rule usage → the serial admission
scan → verdicts → commit). The TCP frontend batches concurrent client
requests into these steps; per-request semantics follow
``ClusterFlowChecker.acquireClusterToken``:

  * effective threshold = count (GLOBAL) or count × connected-client count
    (AVG_LOCAL), compared against the window's per-second pass average;
  * pass → commit PASS/PASS_REQUEST, status OK;
  * over + prioritized → if the waiting backlog is under
    ``maxOccupyRatio × threshold``, commit WAITING and return
    SHOULD_WAIT(ms until the next bucket);
  * otherwise commit BLOCK/BLOCK_REQUEST, status BLOCKED;
  * unknown flowId → NO_RULE_EXISTS (client falls back to local);
  * namespace over ``maxAllowedQps`` → TOO_MANY_REQUEST (GlobalRequestLimiter).

The scan is ``ops/cluster_acquire.py``: the hand-written kernel on a CUDA
device, its plain form on the CPU. Rotation, the window totals, the
gathers and the five commits stay torch ops, as they are XLA ops in the
reference.

Device: ``cuda`` unless the caller passes ``device="cpu"``; with no card
and no explicit device the constructor raises. The dispatch / harvest
split copies each batch's verdicts to pinned host memory behind a CUDA
event at dispatch (under the service lock) and waits for it at harvest
(outside the lock). A failed launch or readback drops the window state
cold (recompiled on the next batch) and raises: there is no retry on the
CPU form.

Param-flow tokens (``requestParamToken``) use per-(flowId, param-hash) QPS
buckets server-side, mirroring ``ClusterParamFlowChecker``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.cluster import constants as CC
from sentinel_tpu_torch.cluster.rules import (
    ClusterFlowRuleManager,
    ClusterMetricState,
    ClusterRuleTensors,
)
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.cluster_acquire import acquire_scan
from sentinel_tpu_torch.utils import time_util
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.param_hash import hash_param

INT32_MAX = 2**31 - 1


class TokenTicket(NamedTuple):
    """An in-flight batched acquire: ``dispatch_tokens`` returns one whose
    verdicts are on their way to pinned host memory behind ``event`` (or
    plain results on the synchronous path), ``harvest_tokens`` resolves it
    OUTSIDE the service lock — so the TCP frontend can stage and dispatch
    batch N+1 while batch N still computes."""

    requests: tuple
    traces: tuple
    pre: tuple          # pre-decided TokenResults (limiter/TOO_MANY), or None
    status: object      # int32[N] host tensor (valid once ``event`` is done)
    extra: object       # int32[N] host tensor (same)
    now_ms: int
    t0: float           # dispatch perf_counter (span timing)
    sync_results: object = None  # pre-resolved results (synchronous path)
    event: object = None  # torch.cuda.Event after the copies, or None


class TokenResult(NamedTuple):
    """Reference: ``TokenResult`` (status + optional wait hint).

    ``server_span`` rides only on traced requests (telemetry/spans.py):
    the server-side token-service span's identity + timing, shipped back
    over the wire so the client can stitch per-hop latency.

    ``epoch``: a per-verdict fencing epoch the TCP frontend stamps into
    the reply's epoch TLV instead of the service-global one (the JAX
    package's sharded leaders set it). None stamps ``service.epoch``."""

    status: int
    remaining: int = 0
    wait_ms: int = 0
    server_span: Optional[Dict] = None  # {"spanId","startMs","durationUs"}
    epoch: Optional[int] = None


class ConnectionManager:
    """namespace → live client connection count (feeds AVG_LOCAL)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, int] = {}

    def connect(self, namespace: str) -> None:
        with self._lock:
            self._groups[namespace] = self._groups.get(namespace, 0) + 1

    def disconnect(self, namespace: str) -> None:
        with self._lock:
            n = self._groups.get(namespace, 0) - 1
            if n <= 0:
                self._groups.pop(namespace, None)
            else:
                self._groups[namespace] = n

    def connected_count(self, namespace: str) -> int:
        with self._lock:
            return self._groups.get(namespace, 0)


class GlobalRequestLimiter:
    """Per-namespace QPS self-protection cap on the token server itself."""

    def __init__(self, max_allowed_qps: float = CC.DEFAULT_MAX_ALLOWED_QPS):
        self.max_allowed_qps = max_allowed_qps
        self._lock = threading.Lock()
        self._counts: Dict[str, Tuple[int, int]] = {}  # ns -> (second, count)

    def try_pass(self, namespace: str, now_ms: int) -> bool:
        sec = now_ms // 1000
        with self._lock:
            cur_sec, count = self._counts.get(namespace, (sec, 0))
            if cur_sec != sec:
                cur_sec, count = sec, 0
            if count + 1 > self.max_allowed_qps:
                self._counts[namespace] = (cur_sec, count)
                return False
            self._counts[namespace] = (cur_sec, count + 1)
            return True


# ---------------------------------------------------------------------------
# Device-side acquire step
# ---------------------------------------------------------------------------


def acquire_step(
    state: ClusterMetricState,
    rt: ClusterRuleTensors,
    conn_counts: torch.Tensor,  # int32[NS] per-namespace connected clients
    slots: torch.Tensor,        # int32[N] rule slot per request (-1 = unknown)
    counts: torch.Tensor,       # int32[N]
    prioritized: torch.Tensor,  # bool[N]
    now_ms: int,
    max_occupy_ratio: float = CC.DEFAULT_MAX_OCCUPY_RATIO,
) -> Tuple[ClusterMetricState, torch.Tensor, torch.Tensor]:
    """-> (state', status int32[N], extra int32[N]): ``extra`` is the
    remaining quota of an OK verdict, the wait of a SHOULD_WAIT one."""
    win = W.row_rotate(state.win, now_ms)
    n = slots.shape[0]
    known = slots >= 0

    def g(a, fill=0):
        return W.gather(a, slots, fill)

    # Per-second pass average of each request's rule window. WAITING
    # counts (prioritized requests that pass after their sleep) are
    # charged as usage too, so waited-through admissions can't let the
    # next window over-admit beyond the configured threshold.
    totals = W.row_window_totals(win, slots)  # int64[N, E]
    interval = g(rt.interval_ms, 1000).clamp(min=1).to(torch.float32)
    passes = totals[:, CC.ClusterFlowEvent.PASS].to(torch.float32)
    waiting = totals[:, CC.ClusterFlowEvent.WAITING].to(torch.float32)
    base = passes + waiting

    ns = g(rt.namespace_id, -1)
    conns = W.gather(conn_counts, ns, 0).to(torch.float32)
    raw = g(rt.threshold, 0.0)
    thr = torch.where(g(rt.threshold_type) == CC.THRESHOLD_GLOBAL, raw,
                      raw * conns.clamp(min=1.0))
    # A tensor divisor: ``1000.0 / interval`` would run as
    # ``interval.reciprocal() * 1000`` (torch's reflected division), two
    # roundings where the reference divides once.
    qps_scale = torch.full_like(interval, 1000.0) / interval

    # Greedy serial admission in arrival order, per slot — the
    # reference's per-request CAS semantics (ops/cluster_acquire.py).
    num_slots = rt.threshold.shape[0]
    countsf = counts.to(torch.float32)
    ok, can_wait, passed = acquire_scan(
        slots, countsf, base, thr, qps_scale, known, prioritized, waiting,
        num_slots, max_occupy_ratio)

    bucket_ms = g(win.bucket_ms, 1000).clamp(min=1)
    wait_ms = (bucket_ms - int(now_ms) % bucket_ms).to(torch.int32)

    status = torch.where(ok, int(CC.TokenResultStatus.OK),
                         int(CC.TokenResultStatus.BLOCKED))
    status = torch.where(can_wait, int(CC.TokenResultStatus.SHOULD_WAIT),
                         status)
    status = torch.where(known, status,
                         int(CC.TokenResultStatus.NO_RULE_EXISTS))
    status = status.to(torch.int32)
    is_ok = status == CC.TokenResultStatus.OK
    is_blocked = status == CC.TokenResultStatus.BLOCKED
    is_wait = status == CC.TokenResultStatus.SHOULD_WAIT
    wait_ms = torch.where(is_wait, wait_ms, 0)

    # Commit: PASS/BLOCK counts + request tallies + WAITING backlog.
    rows = torch.where(known, slots, -1)
    one = torch.ones_like(counts)
    zero = torch.zeros_like(counts)
    for event, values in (
            (CC.ClusterFlowEvent.PASS, torch.where(is_ok, counts, zero)),
            (CC.ClusterFlowEvent.PASS_REQUEST, torch.where(is_ok, one, zero)),
            (CC.ClusterFlowEvent.BLOCK, torch.where(is_blocked, counts, zero)),
            (CC.ClusterFlowEvent.BLOCK_REQUEST,
             torch.where(is_blocked, one, zero)),
            (CC.ClusterFlowEvent.WAITING, torch.where(is_wait, counts, zero))):
        win = W.row_window_add(
            win, now_ms, rows,
            torch.full((n,), int(event), dtype=torch.int32,
                       device=slots.device), values)

    # thr - passed - counts rounds twice (no fused multiply-add here in
    # the reference's compile); the float -> int32 cast saturates, as
    # XLA's convert does.
    rem = (thr - passed - countsf).clamp(min=0)
    remaining = torch.where(rem >= float(INT32_MAX), INT32_MAX,
                            rem.clamp(max=2**31 - 128).to(torch.int32))
    extra = torch.where(is_ok, remaining.to(torch.int32), wait_ms)
    return ClusterMetricState(win=win), status, extra


# ---------------------------------------------------------------------------
# Host service
# ---------------------------------------------------------------------------


class DefaultTokenService:
    """The server-side token service over :func:`acquire_step`."""

    def __init__(self, rules: Optional[ClusterFlowRuleManager] = None,
                 max_allowed_qps: float = CC.DEFAULT_MAX_ALLOWED_QPS,
                 max_occupy_ratio: float = CC.DEFAULT_MAX_OCCUPY_RATIO,
                 epoch: int = 0, device=None):
        self.device = resolve_device(device)
        # The one stream every step of this service runs on (None on the
        # CPU), made current in whichever thread dispatches.
        self._stream = (torch.cuda.default_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.rules = rules or ClusterFlowRuleManager()
        # Leadership epoch: stamped into every response by the TCP
        # frontend so deposed leaders' replies are fenced; 0 (default)
        # keeps the pre-HA wire format byte-identical.
        self.epoch = int(epoch)
        self.connections = ConnectionManager()
        self.limiter = GlobalRequestLimiter(max_allowed_qps)
        self.max_occupy_ratio = max_occupy_ratio
        self._lock = threading.Lock()
        self._compiled_version = -1
        self._rt: Optional[ClusterRuleTensors] = None
        self._state: Optional[ClusterMetricState] = None
        self._slot_of: Dict[int, int] = {}
        self._ns_of: Dict[int, str] = {}
        # Param-flow cluster buckets: (flowId, param_hash) -> (window_start, used)
        self._param_buckets: Dict[Tuple[int, int], Tuple[int, float]] = {}
        # Server-side spans (telemetry/spans.py): every TRACED request
        # records a token-service span here — sampling already happened
        # on the client, so the server keeps whatever arrives traced.
        from sentinel_tpu_torch.telemetry.spans import SpanCollector

        self.spans = SpanCollector(sample_every=0)
        # Namespace telescope (telemetry/population.py): the leader's
        # flowId-axis observation point. Bound to the engine's tracker
        # by ClusterStateManager.set_to_server; None disables it.
        self.population = None

    def _device_ctx(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _ensure_compiled(self):
        if self._compiled_version == self.rules.version:
            return
        old_state, old_slots = self._state, self._slot_of
        self._rt, fresh, self._slot_of, self._ns_of = self.rules.compile(
            self.device)
        # A rule push must NOT reset surviving flows' windows (the reference
        # keeps per-flowId ClusterMetrics across updates): carry each
        # surviving flowId's row over — unless its bucket geometry changed.
        if old_state is not None and old_slots:
            old_counts = old_state.win.counts
            old_bucket = old_state.win.bucket_ms.cpu().numpy()
            new_bucket = fresh.win.bucket_ms.cpu().numpy()
            same_buckets = old_counts.shape[1] == fresh.win.counts.shape[1]
            pairs = [(new_slot, old_slots[flow_id])
                     for flow_id, new_slot in self._slot_of.items()
                     if flow_id in old_slots and same_buckets
                     and old_bucket[old_slots[flow_id]] == new_bucket[new_slot]]
            if pairs:
                dst = torch.tensor([p[0] for p in pairs], device=self.device)
                src = torch.tensor([p[1] for p in pairs], device=self.device)
                fresh.win.counts[dst] = old_counts[src]
                fresh.win.starts[dst] = old_state.win.starts[src]
        self._state = fresh
        self._compiled_version = self.rules.version

    def _conn_counts(self) -> List[int]:
        ns_ids = self.rules.namespace_ids()
        counts = [0] * max(len(ns_ids), 1)
        for ns, nid in ns_ids.items():
            counts[nid] = self.connections.connected_count(ns)
        return counts

    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False,
                      now_ms: Optional[int] = None) -> TokenResult:
        results = self.request_tokens([(flow_id, count, prioritized)], now_ms)
        return results[0]

    def request_tokens(self, requests: Sequence[Tuple],
                       now_ms: Optional[int] = None) -> List[TokenResult]:
        """Batched acquire — the TCP frontend folds concurrent clients in.

        Each request is ``(flow_id, count, prioritized)`` or, for traced
        requests (telemetry/spans.py), ``(flow_id, count, prioritized,
        TraceContext)`` — the trace context from the client's traceparent
        TLV. Traced requests get a server-side span (recorded in
        ``self.spans`` AND returned in ``TokenResult.server_span``)
        timing the device acquire step their verdict came from.

        Synchronous form of :meth:`dispatch_tokens` +
        :meth:`harvest_tokens` — one code path, so the pipelined wire
        frontend and direct callers can never drift. When an instance
        override exists, this (class-level) body is only reachable
        THROUGH the override's captured real(), so it goes straight to
        the device path rather than looping back into the override.
        """
        return self.harvest_tokens(self._dispatch_device(requests, now_ms))

    def dispatch_tokens(self, requests: Sequence[Tuple],
                        now_ms: Optional[int] = None) -> TokenTicket:
        """Enqueue-only batched acquire: the host prep and the device step
        run under the service lock, and the verdicts' copy to pinned host
        memory is only enqueued; :meth:`harvest_tokens` waits for it
        outside the lock, which lets the wire frontend keep up to
        ``wire.inflight.depth`` fused batches in flight.

        When ``request_tokens`` has been overridden on the INSTANCE
        (test harnesses wrap it to inject step latency or faults), the
        override must see every batch — the ticket degrades to a
        pre-resolved synchronous one through it."""
        if "request_tokens" in self.__dict__:
            t0 = time.perf_counter()
            results = self.__dict__["request_tokens"](requests, now_ms)
            return TokenTicket(tuple(requests), (), (), None, None,
                               now_ms or 0, t0, sync_results=list(results))
        return self._dispatch_device(requests, now_ms)

    def _dispatch_device(self, requests: Sequence[Tuple],
                         now_ms: Optional[int] = None) -> TokenTicket:
        """The real dispatch (the body behind both :meth:`dispatch_tokens`
        and :meth:`request_tokens`)."""
        now = now_ms if now_ms is not None else time_util.current_time_millis()
        traces = tuple(r[3] if len(r) > 3 else None for r in requests)
        population = self.population
        pop_rows = [] if population is not None else None
        n = len(requests)
        with self._lock:
            pre: List[Optional[TokenResult]] = [None] * n
            host = np.zeros((3, n), np.int32)  # slots, counts, prioritized
            host[0] = -1
            try:
                self._ensure_compiled()
                for i, req in enumerate(requests):
                    flow_id, count, prioritized = req[0], req[1], req[2]
                    try:
                        flow_id = int(flow_id)
                    except (TypeError, ValueError):
                        continue  # slot stays -1 -> NO_RULE_EXISTS
                    ns = self._ns_of.get(flow_id)
                    if pop_rows is not None:
                        pop_rows.append((ns, flow_id, count))
                    if ns is not None and not self.limiter.try_pass(ns, now):
                        pre[i] = TokenResult(
                            CC.TokenResultStatus.TOO_MANY_REQUEST)
                        continue
                    host[0, i] = self._slot_of.get(flow_id, -1)
                    host[1, i] = count
                    host[2, i] = bool(prioritized)
                conns = np.asarray(self._conn_counts(), np.int32)
                t0 = time.perf_counter()
                with self._device_ctx():
                    # One host-to-device copy per batch; from pinned
                    # memory on the card, so it never waits for the
                    # batch still in flight.
                    src = torch.from_numpy(
                        np.concatenate([host.reshape(-1), conns]))
                    if self._stream is not None:
                        src = src.pin_memory()
                    dev = src.to(self.device, non_blocking=True)
                    self._state, status, extra = acquire_step(
                        self._state, self._rt, dev[3 * n:], dev[:n],
                        dev[n:2 * n], dev[2 * n:3 * n].to(torch.bool), now,
                        max_occupy_ratio=self.max_occupy_ratio)
                    event = None
                    if self.device.type == "cuda":
                        out = torch.empty((2, n), dtype=torch.int32,
                                          pin_memory=True)
                        out.copy_(torch.stack([status, extra]),
                                  non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    else:
                        out = torch.stack([status, extra])
            except Exception:
                # A failed build, launch or copy may have left the window
                # half-committed: drop it cold (recompiled on the next
                # batch) rather than serve from it.
                self._state = None
                self._compiled_version = -1
                raise
            if pop_rows:
                population.observe_flows(pop_rows)
            return TokenTicket(tuple(requests), traces, tuple(pre),
                               out[0], out[1], now, t0, event=event)

    def harvest_tokens(self, ticket: TokenTicket) -> List[TokenResult]:
        """Resolve a dispatched batch to concrete TokenResults. The wait
        for the device happens HERE, outside the service lock, so a slow
        step never blocks the next batch's dispatch. A device fault
        surfaces here; the service state drops cold exactly as on a
        failed dispatch, and the caller fails the batch's requests."""
        if ticket.sync_results is not None:
            return ticket.sync_results
        try:
            if ticket.event is not None:
                ticket.event.synchronize()
            status = ticket.status.numpy()
            extra = ticket.extra.numpy()
        except Exception:
            with self._lock:
                self._state = None
                self._compiled_version = -1
            raise
        # The batch shares one device step; each traced request's span
        # carries the dispatch-to-harvest wall (its verdict's true
        # compute cost, including any pipelined overlap) plus its own
        # verdict attributes.
        step_us = int((time.perf_counter() - ticket.t0) * 1e6)
        out: List[TokenResult] = []
        for i, req in enumerate(ticket.requests):
            result = ticket.pre[i]
            if result is None:
                s = int(status[i])
                if s == CC.TokenResultStatus.SHOULD_WAIT:
                    result = TokenResult(s, wait_ms=int(extra[i]))
                else:
                    result = TokenResult(s, remaining=int(extra[i]))
            if ticket.traces[i] is not None:
                result = result._replace(server_span=self._record_span(
                    ticket.traces[i], req[0], ticket.now_ms, step_us,
                    int(result.status), len(ticket.requests)))
            out.append(result)
        return out

    def _record_span(self, ctx, flow_id, start_ms: int, duration_us: int,
                     status: int, batch_n: int) -> Dict:
        """One server-side token-service span; returns the wire-shippable
        identity+timing dict (TokenResult.server_span)."""
        child = ctx.child()
        self.spans.record_remote(
            child, "cluster.token_service", ctx.span_id, start_ms,
            duration_us, attrs={"flowId": flow_id, "status": status,
                                "batch": batch_n})
        return {"spanId": child.span_id, "startMs": int(start_ms),
                "durationUs": int(duration_us)}

    def request_param_token(self, flow_id: int, count: int,
                            params: Sequence, now_ms: Optional[int] = None,
                            trace=None) -> TokenResult:
        """Per-(flowId, param) global QPS buckets (``ClusterParamFlowChecker``)."""
        now = now_ms if now_ms is not None else time_util.current_time_millis()
        t0 = time.perf_counter()
        result = self._request_param_token(flow_id, count, params, now)
        if trace is not None:
            result = result._replace(server_span=self._record_span(
                trace, flow_id, now, int((time.perf_counter() - t0) * 1e6),
                int(result.status), 1))
        return result

    def _request_param_token(self, flow_id: int, count: int,
                             params: Sequence, now: int) -> TokenResult:
        try:
            flow_id = int(flow_id)  # one bucket key space for "123" and 123
        except (TypeError, ValueError):
            return TokenResult(CC.TokenResultStatus.NO_RULE_EXISTS)
        rule = self.rules.rule_by_flow_id(flow_id)
        if rule is None:
            return TokenResult(CC.TokenResultStatus.NO_RULE_EXISTS)
        ns = self.rules.namespace_of_flow_id(flow_id)
        if ns is not None and not self.limiter.try_pass(ns, now):
            return TokenResult(CC.TokenResultStatus.TOO_MANY_REQUEST)
        # AVG_LOCAL scales the per-value threshold by the namespace's live
        # client count, mirroring the flow-token path (reference:
        # ClusterParamFlowChecker.calcGlobalThreshold).
        thr = rule.count
        cc = rule.cluster_config or {}
        if int(cc.get("thresholdType", CC.THRESHOLD_AVG_LOCAL)) == CC.THRESHOLD_AVG_LOCAL:
            thr *= max(self.connections.connected_count(ns), 1) if ns else 1
        window_start = now - now % 1000
        with self._lock:
            # Check all values first (any over-quota value blocks the whole
            # request, reference ParamFlowChecker semantics), accumulating
            # within-call usage so duplicate params cannot each be judged
            # against the untouched bucket.
            pending: Dict[Tuple[int, int], float] = {}
            blocked = False
            for p in params:
                key = (flow_id, hash_param(p))
                start, used = self._param_buckets.get(key, (window_start, 0.0))
                if start != window_start:
                    used = 0.0
                within = pending.get(key, 0.0)
                if used + within + count > thr:
                    blocked = True
                    break
                pending[key] = within + count
            if blocked:
                return TokenResult(CC.TokenResultStatus.BLOCKED)
            for key, add in pending.items():
                start, used = self._param_buckets.get(key, (window_start, 0.0))
                if start != window_start:
                    used = 0.0
                self._param_buckets[key] = (window_start, used + add)
            if len(self._param_buckets) > 100_000:  # bounded key space
                self._param_buckets.clear()
        return TokenResult(CC.TokenResultStatus.OK)

    # -- introspection -----------------------------------------------------

    def metrics_snapshot(self) -> Dict[int, Dict[str, float]]:
        """Per-flowId window totals (cluster command handlers' data source)."""
        with self._lock:
            self._ensure_compiled()
            now = time_util.current_time_millis()
            with self._device_ctx():
                win = W.row_rotate(self._state.win, now)
                totals = win.counts.sum(dim=1).cpu().numpy()
        out = {}
        for flow_id, slot in self._slot_of.items():
            t = totals[slot]
            out[flow_id] = {
                "pass": float(t[CC.ClusterFlowEvent.PASS]),
                "block": float(t[CC.ClusterFlowEvent.BLOCK]),
                "passRequest": float(t[CC.ClusterFlowEvent.PASS_REQUEST]),
                "blockRequest": float(t[CC.ClusterFlowEvent.BLOCK_REQUEST]),
                "waiting": float(t[CC.ClusterFlowEvent.WAITING]),
            }
        return out
