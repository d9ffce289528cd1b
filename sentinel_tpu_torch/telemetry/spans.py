"""Cross-process spans (port of ``sentinel_tpu/telemetry/spans.py``):
W3C-traceparent-style trace context + host-side span collection with an
OTLP-flavored JSON export.

The decision traces stop at the engine: a sampled blocked entry shows
WHAT the verdict was, but when the verdict came from the cluster token
server the round-trip that decided it is invisible. This module carries
a trace context across the cluster wire (``cluster/codec.py`` appends it
as a trailing TLV the old decoders ignore — wire-compatible with old
peers) so one sampled entry stitches:

    engine decision span  ->  token_request span (client wall)
                          ->  token_service span (server-side, shipped
                              back in the response TLV with its own
                              timing)

All spans of a trace share one 128-bit trace id; per-hop timings fall
out of the client/server span walls (client wall minus server duration
= wire + queue overhead). Sampling is independent of the blocked-entry
trace ring (``csp.sentinel.telemetry.spans.sampleEvery``; the cluster
path is pre-verdict, so sampling cannot condition on "blocked").

The context format follows W3C trace-context (``00-<trace32>-<span16>-
<flags2>``) so exported spans join external tracing backends unchanged.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from sentinel_tpu_torch.utils import time_util

TRACEPARENT_VERSION = "00"


class TraceContext(NamedTuple):
    """One hop's identity inside a trace (immutable; children fork)."""

    trace_id: str   # 32 lowercase hex chars (128-bit)
    span_id: str    # 16 lowercase hex chars (64-bit)
    flags: int = 1  # W3C trace-flags; bit 0 = sampled

    def traceparent(self) -> str:
        return (f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}"
                f"-{self.flags:02x}")

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — the context a downstream hop gets."""
        return TraceContext(self.trace_id, secrets.token_hex(8), self.flags)


def new_trace_context() -> TraceContext:
    return TraceContext(secrets.token_hex(16), secrets.token_hex(8), 1)


def parse_traceparent(value: str) -> Optional[TraceContext]:
    """Strict-enough parse of ``00-<trace>-<span>-<flags>``; None on any
    malformation (a bad peer costs itself the trace, never the caller)."""
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id.lower(), span_id.lower(), flag_bits)


class Span:
    """One timed operation. Mutable until :meth:`finish`; host-side only."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "start_ms", "duration_us", "attrs", "_t0")

    def __init__(self, name: str, ctx: TraceContext,
                 parent_span_id: str = "",
                 attrs: Optional[Dict] = None):
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.start_ms = time_util.current_time_millis()
        self.duration_us = 0
        self.attrs: Dict = dict(attrs or {})
        self._t0 = time.perf_counter()

    def finish(self, duration_us: Optional[int] = None) -> "Span":
        """Stamp the duration (monotonic wall since construction, unless
        the caller measured it elsewhere — e.g. a server-shipped span)."""
        self.duration_us = (int((time.perf_counter() - self._t0) * 1e6)
                            if duration_us is None else int(duration_us))
        return self

    def to_dict(self) -> Dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_span_id,
            "name": self.name,
            "startMs": self.start_ms,
            "durationUs": self.duration_us,
            "attributes": dict(self.attrs),
        }


class SpanCollector:
    """Bounded host ring of finished spans + the sampling counter.

    ``sample()`` is the one dispatch-path call: a counter hit returns a
    fresh root :class:`TraceContext`, otherwise None — callers skip all
    span work on None, so the un-sampled steady state costs one integer
    op. Recording is lock-guarded appends of already-finished spans.
    """

    def __init__(self, sample_every: Optional[int] = None,
                 capacity: Optional[int] = None):
        from sentinel_tpu_torch.core.config import (
            DEFAULT_TELEMETRY_SPANS_CAPACITY,
            DEFAULT_TELEMETRY_SPANS_SAMPLE_EVERY,
            TELEMETRY_SPANS_CAPACITY,
            TELEMETRY_SPANS_SAMPLE_EVERY,
            config as _cfg,
        )

        if sample_every is None:
            sample_every = _cfg.get_int(TELEMETRY_SPANS_SAMPLE_EVERY,
                                        DEFAULT_TELEMETRY_SPANS_SAMPLE_EVERY)
        if capacity is None:
            capacity = _cfg.get_int(TELEMETRY_SPANS_CAPACITY,
                                    DEFAULT_TELEMETRY_SPANS_CAPACITY)
        self.sample_every = max(0, int(sample_every))  # 0 = disabled
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: List[Dict] = []
        self._seen = 0
        self._recorded = 0

    def sample(self) -> Optional[TraceContext]:
        if self.sample_every <= 0:
            return None
        with self._lock:
            self._seen += 1
            if self._seen % self.sample_every != 0:
                return None
        return new_trace_context()

    def record(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            self._recorded += 1
            self._ring.append(d)
            del self._ring[:-self.capacity]

    def record_remote(self, ctx: TraceContext, name: str, parent_span_id: str,
                      start_ms: int, duration_us: int,
                      attrs: Optional[Dict] = None) -> None:
        """A span another process measured (e.g. the token server's,
        shipped back in the response TLV) joins the local ring verbatim."""
        with self._lock:
            self._recorded += 1
            self._ring.append({
                "traceId": ctx.trace_id, "spanId": ctx.span_id,
                "parentSpanId": parent_span_id, "name": name,
                "startMs": int(start_ms), "durationUs": int(duration_us),
                "attributes": dict(attrs or {}),
            })
            del self._ring[:-self.capacity]

    # -- read side --------------------------------------------------------

    def snapshot(self, limit: Optional[int] = None, offset: int = 0) -> Dict:
        from sentinel_tpu_torch.telemetry.timeseries import page_newest_first

        with self._lock:
            spans = list(self._ring)
            seen, recorded = self._seen, self._recorded
        spans = page_newest_first(spans, limit, offset)
        spans.reverse()  # newest first
        return {
            "sampleEvery": self.sample_every,
            "capacity": self.capacity,
            "seen": seen,
            "recorded": recorded,
            "spans": spans,
        }

    def traces(self, limit: Optional[int] = None) -> List[Dict]:
        """Spans grouped per trace id, newest trace first."""
        with self._lock:
            spans = list(self._ring)
        grouped: Dict[str, List[Dict]] = {}
        order: List[str] = []
        for s in spans:
            if s["traceId"] not in grouped:
                order.append(s["traceId"])
            grouped.setdefault(s["traceId"], []).append(s)
        order.reverse()
        if limit is not None:
            order = order[:max(0, int(limit))]
        return [{"traceId": t, "spans": grouped[t]} for t in order]


def to_otlp(spans: List[Dict], service_name: str = "sentinel-tpu") -> Dict:
    """OTLP/JSON-flavored export of collected span dicts: the
    ``resourceSpans -> scopeSpans -> spans`` shape OTLP HTTP receivers
    and trace viewers ingest, with ns timestamps and typed attributes."""

    def _attrs(d: Dict) -> List[Dict]:
        out = []
        for k, v in d.items():
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            out.append({"key": str(k), "value": val})
        return out

    otlp_spans = []
    for s in spans:
        start_ns = int(s["startMs"]) * 1_000_000
        otlp_spans.append({
            "traceId": s["traceId"],
            "spanId": s["spanId"],
            "parentSpanId": s.get("parentSpanId", ""),
            "name": s["name"],
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + int(s["durationUs"]) * 1000),
            "attributes": _attrs(s.get("attributes", {})),
        })
    return {
        "resourceSpans": [{
            "resource": {"attributes": _attrs({"service.name": service_name})},
            "scopeSpans": [{
                # The reference's scope name: both packages export the
                # same document.
                "scope": {"name": "sentinel_tpu.telemetry.spans"},
                "spans": otlp_spans,
            }],
        }],
    }
