"""Streaming-reservation ledger: occupy-style token leases, host side (port
of ``sentinel_tpu/llm/streams.py``).

A long generation acquires its ESTIMATED output budget up front — the
estimate is debited into the model's TPS window the moment the stream
is admitted (chunked through the normal N-token entry path), and the
lease *ticks down* as output tokens actually stream.  ``tick``
reconciles estimate vs actual; on completion/abort the unconsumed
remainder is returned as an expiring per-resource CREDIT that later
admissions on the same resource consume before debiting the live
window.  A credit expires at the end of the 1s window it was granted
in — the same boundary where the PASS debit it compensates rolls out
of the QPS window — which is what makes the over-admission bound tight
(the streaming-reservation bound: over-admission across an abort ≤ the
unreconciled estimate, for ≤ one window interval).

The ledger is deliberately passive and wall-clock-free: every method
takes ``now_ms`` from the caller (the engine's ``now_ms()`` timebase), so
simulator replays drive it deterministically.
Bounded (``capacity``) and idle-evicting (``evict`` rides the engine's
flight-recorder spill cadence); rows checkpoint-graft keyed by
``streamId`` like the cluster flowId rows (``core/checkpoint.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class StreamLease:
    stream_id: str
    resource: str
    tenant: str
    estimate: float        # the caller's FULL output estimate
    reserved: float        # debited up front: min(estimate, window budget)
                           # — a reservation can never exceed one window's
                           # token budget, so a multi-second generation
                           # reserves its first window's worth and pays the
                           # rest live as it streams across later windows
    remaining: float       # reserved minus streamed tokens, floor 0
    streamed: float        # actual output tokens seen via tick
    debited: float         # reserved tokens debited LIVE (rest via credit)
    opened_ms: int
    last_ms: int           # last open/tick stamp (idle-eviction base)


class StreamLedger:
    """Reservation state for every in-flight streamed generation."""

    def __init__(self, capacity: int = 4096, idle_evict_ms: int = 30_000,
                 window_ms: int = 1000):
        self.capacity = max(1, int(capacity))
        self.idle_evict_ms = max(1, int(idle_evict_ms))
        self.window_ms = max(1, int(window_ms))
        self._lock = threading.Lock()
        self._streams: Dict[str, StreamLease] = {}
        # resource -> [(expires_ms, tokens)] — released over-reservation
        # usable by later admissions until the window rolls off.
        self._credit: Dict[str, List[Tuple[int, float]]] = {}
        self.opened = 0
        self.open_blocked = 0       # opens rejected (window/cap/capacity)
        self.closed = 0
        self.aborted = 0
        self.evicted = 0
        self.tokens_debited = 0.0   # live window debits (opens + overflow)
        self.tokens_streamed = 0.0  # actual output tokens via tick
        self.tokens_released = 0.0  # remainders returned as credit
        self.credit_used = 0.0      # debits avoided by consuming credit
        self.credit_expired = 0.0   # credit that rolled off unused

    # -- credit pool -------------------------------------------------------

    def _credit_expiry(self, now_ms: int) -> int:
        return (now_ms // self.window_ms + 1) * self.window_ms

    def add_credit(self, resource: str, tokens: float, now_ms: int) -> None:
        if tokens <= 0:
            return
        with self._lock:
            self._credit.setdefault(resource, []).append(
                (self._credit_expiry(now_ms), float(tokens)))

    def take_credit(self, resource: str, want: float, now_ms: int) -> float:
        """Consume up to ``want`` non-expired credit tokens; returns the
        amount granted."""
        if want <= 0:
            return 0.0
        granted = 0.0
        with self._lock:
            entries = self._credit.get(resource)
            if not entries:
                return 0.0
            keep: List[Tuple[int, float]] = []
            for expires, amount in entries:
                if expires <= now_ms:
                    self.credit_expired += amount
                    continue
                take = min(amount, want - granted)
                granted += take
                if amount - take > 1e-9:
                    keep.append((expires, amount - take))
            if keep:
                self._credit[resource] = keep
            else:
                self._credit.pop(resource, None)
            self.credit_used += granted
        return granted

    def credit_tokens(self, resource: Optional[str] = None,
                      now_ms: Optional[int] = None) -> float:
        with self._lock:
            total = 0.0
            for res, entries in self._credit.items():
                if resource is not None and res != resource:
                    continue
                for expires, amount in entries:
                    if now_ms is None or expires > now_ms:
                        total += amount
            return total

    # -- lease lifecycle ---------------------------------------------------

    def active(self, resource: Optional[str] = None) -> int:
        with self._lock:
            if resource is None:
                return len(self._streams)
            return sum(1 for s in self._streams.values()
                       if s.resource == resource)

    def at_capacity(self) -> bool:
        with self._lock:
            return len(self._streams) >= self.capacity

    def open(self, stream_id: str, resource: str, tenant: str,
             estimate: float, reserved: float, debited: float,
             now_ms: int) -> StreamLease:
        lease = StreamLease(
            stream_id=str(stream_id), resource=resource, tenant=tenant,
            estimate=float(estimate), reserved=float(reserved),
            remaining=float(reserved),
            streamed=0.0, debited=float(debited),
            opened_ms=int(now_ms), last_ms=int(now_ms))
        with self._lock:
            if lease.stream_id in self._streams:
                raise ValueError(f"stream {stream_id!r} already open")
            if len(self._streams) >= self.capacity:
                raise OverflowError(
                    f"stream ledger full ({self.capacity} leases)")
            self._streams[lease.stream_id] = lease
            self.opened += 1
            self.tokens_debited += float(debited)
        return lease

    def get(self, stream_id: str) -> Optional[StreamLease]:
        with self._lock:
            return self._streams.get(str(stream_id))

    def tick(self, stream_id: str, tokens: float,
             now_ms: int) -> Tuple[float, float]:
        """Record ``tokens`` actually streamed.  Returns ``(covered,
        overflow)``: ``covered`` came out of the reservation, ``overflow``
        exceeded the estimate and must be debited live by the caller."""
        tokens = float(tokens)
        if tokens < 0:
            raise ValueError("tick tokens must be >= 0")
        with self._lock:
            lease = self._streams.get(str(stream_id))
            if lease is None:
                raise KeyError(f"unknown stream {stream_id!r}")
            covered = min(lease.remaining, tokens)
            overflow = tokens - covered
            lease.remaining -= covered
            lease.streamed += tokens
            lease.last_ms = int(now_ms)
            self.tokens_streamed += tokens
            return covered, overflow

    def record_overflow_debit(self, tokens: float) -> None:
        if tokens > 0:
            with self._lock:
                self.tokens_debited += float(tokens)

    def close(self, stream_id: str, now_ms: int,
              aborted: bool = False) -> float:
        """Drop the lease; returns the unconsumed remainder (the caller
        converts it into expiring credit via :meth:`add_credit`)."""
        with self._lock:
            lease = self._streams.pop(str(stream_id), None)
            if lease is None:
                raise KeyError(f"unknown stream {stream_id!r}")
            if aborted:
                self.aborted += 1
            else:
                self.closed += 1
            remainder = lease.remaining
            if remainder > 0:
                self.tokens_released += remainder
            return remainder

    def evict(self, now_ms: int) -> List[StreamLease]:
        """Drop leases idle longer than ``idle_evict_ms`` (an abandoned
        generation whose client vanished) and expire stale credit.
        Returns the evicted leases; the caller credits their remainders
        (same contract as an abort)."""
        out: List[StreamLease] = []
        with self._lock:
            for sid in [s.stream_id for s in self._streams.values()
                        if now_ms - s.last_ms >= self.idle_evict_ms]:
                lease = self._streams.pop(sid)
                self.evicted += 1
                if lease.remaining > 0:
                    self.tokens_released += lease.remaining
                out.append(lease)
            for res in list(self._credit):
                keep = []
                for expires, amount in self._credit[res]:
                    if expires <= now_ms:
                        self.credit_expired += amount
                    else:
                        keep.append((expires, amount))
                if keep:
                    self._credit[res] = keep
                else:
                    self._credit.pop(res)
        return out

    def outstanding_tokens(self, resource: Optional[str] = None) -> float:
        with self._lock:
            return sum(s.remaining for s in self._streams.values()
                       if resource is None or s.resource == resource)

    # -- checkpoint graft (core/checkpoint.py) -----------------------------

    def checkpoint_rows(self) -> List[dict]:
        """streamId-keyed rows, the flowId-row idiom: a restore grafts
        surviving leases and starts unknown ones cold."""
        with self._lock:
            return [{
                "streamId": s.stream_id, "resource": s.resource,
                "tenant": s.tenant, "estimate": s.estimate,
                "reserved": s.reserved, "remaining": s.remaining,
                "streamed": s.streamed, "debited": s.debited,
                "openedMs": s.opened_ms, "lastMs": s.last_ms,
            } for s in self._streams.values()]

    def graft(self, rows: List[dict], now_ms: int) -> int:
        """Restore leases from checkpoint rows (capacity-capped; a row
        already open live wins over the checkpoint copy). ``last_ms`` is
        re-stamped to ``now_ms`` so a restore doesn't mass-evict."""
        grafted = 0
        with self._lock:
            for row in rows or []:
                sid = str(row.get("streamId", ""))
                if not sid or sid in self._streams \
                        or len(self._streams) >= self.capacity:
                    continue
                self._streams[sid] = StreamLease(
                    stream_id=sid,
                    resource=str(row.get("resource", "")),
                    tenant=str(row.get("tenant", "default")),
                    estimate=float(row.get("estimate", 0.0)),
                    reserved=float(row.get("reserved",
                                           row.get("estimate", 0.0))),
                    remaining=float(row.get("remaining", 0.0)),
                    streamed=float(row.get("streamed", 0.0)),
                    debited=float(row.get("debited", 0.0)),
                    opened_ms=int(row.get("openedMs", now_ms)),
                    last_ms=int(now_ms))
                grafted += 1
        return grafted

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._streams),
                "opened": self.opened,
                "openBlocked": self.open_blocked,
                "closed": self.closed,
                "aborted": self.aborted,
                "evicted": self.evicted,
                "tokensDebited": self.tokens_debited,
                "tokensStreamed": self.tokens_streamed,
                "tokensReleased": self.tokens_released,
                "creditUsed": self.credit_used,
                "creditExpired": self.credit_expired,
                "outstandingTokens": sum(
                    s.remaining for s in self._streams.values()),
                "creditTokens": sum(
                    a for entries in self._credit.values()
                    for _, a in entries),
            }
