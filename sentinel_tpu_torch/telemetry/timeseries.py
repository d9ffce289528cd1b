"""Host-side spill and query surface of the device flight recorder (port
of ``sentinel_tpu/telemetry/timeseries.py``).

The device keeps ~2 minutes of per-second telemetry (the
``FlightRecorder`` ring in ``ops/step.py``: exact per-second deltas of
event counts, block attribution, RT-histogram buckets and per-(reason,
rule-slot) bins, written once per second at the fold). This module is
the other half:

* :class:`TimeseriesHistory`: a bounded host ring of COMPACTED seconds.
  Spilling keeps each [*, R] device slice's active rows only, so an hour
  of history for a handful of hot resources costs kilobytes. A spilled
  second is the same tensor the device folded, just sparse.
* Query helpers: exact windows at any offset within retention
  (``query``), rendered to one JSON shape (``second_to_dict``).

The spill is pull-based: the engine reads the ring's stamps, gathers only
slots newer than the last spilled stamp and appends them here (no
background thread, no per-step host work). Readers trigger it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.telemetry.attribution import (
    ATTR_REASON_NAMES,
    slot_bins_to_dict,
)

DEFAULT_HISTORY_SECONDS = 1024


def page_newest_first(items: List, limit: Optional[int] = None,
                      offset: int = 0) -> List:
    """Newest-first pagination over a CHRONOLOGICALLY ordered list:
    ``offset`` skips the newest entries, ``limit`` caps the page size, and
    the page comes back still in chronological order. A limit larger than
    the list is the whole list, never a wrapped slice."""
    offset = max(0, int(offset))
    if offset:
        items = items[:-offset] if offset < len(items) else []
    if limit is not None:
        items = items[max(0, len(items) - max(0, int(limit))):]
    return items


class SecondRecord(NamedTuple):
    """One complete second, compacted to its active node rows."""

    stamp_ms: int          # second-start ms
    rows: np.ndarray       # int32[K] node rows with any signal this second
    events: np.ndarray     # int32[K, NUM_EVENTS]
    attr: np.ndarray       # int32[K, NUM_ATTR_REASONS]
    hist: np.ndarray       # int32[K, NUM_RT_BUCKETS]
    slot_attr: np.ndarray  # int32[NUM_ATTR_REASONS, NUM_SLOT_BINS]


def compact_second(stamp_ms: int, events: np.ndarray, attr: np.ndarray,
                   hist: np.ndarray, slot_attr: np.ndarray) -> SecondRecord:
    """Dense device slices ([E, R] / [A, R] / [H, R]) -> active-row record."""
    active = (events.any(axis=0) | attr.any(axis=0) | hist.any(axis=0))
    rows = np.nonzero(active)[0].astype(np.int32)
    return SecondRecord(
        stamp_ms=int(stamp_ms),
        rows=rows,
        events=np.ascontiguousarray(events[:, rows].T),
        attr=np.ascontiguousarray(attr[:, rows].T),
        hist=np.ascontiguousarray(hist[:, rows].T),
        slot_attr=np.asarray(slot_attr, np.int64).astype(np.int32),
    )


class TimeseriesHistory:
    """Bounded, stamp-ordered host ring of spilled seconds. Thread-safe:
    the engine spills under its own lock, readers query concurrently."""

    def __init__(self, retention_seconds: int = DEFAULT_HISTORY_SECONDS):
        self.retention_seconds = max(1, int(retention_seconds))
        self._lock = threading.Lock()
        # stamp_ms -> SecondRecord; insertion order is stamp order (the
        # spill feeds increasing stamps).
        self._seconds: "OrderedDict[int, SecondRecord]" = OrderedDict()
        self._last_stamp_ms = -1

    @property
    def last_stamp_ms(self) -> int:
        return self._last_stamp_ms

    def append(self, rec: SecondRecord) -> None:
        """Store one spilled second. All-idle seconds (no active rows, no
        slot data) advance the cursor but are not stored; readers treat a
        missing stamp as zeros."""
        with self._lock:
            if rec.stamp_ms <= self._last_stamp_ms:
                return  # already spilled (or out of order): first wins
            self._last_stamp_ms = rec.stamp_ms
            if rec.rows.size == 0 and not rec.slot_attr.any():
                return
            self._seconds[rec.stamp_ms] = rec
            while len(self._seconds) > self.retention_seconds:
                self._seconds.popitem(last=False)

    def query(self, start_ms: Optional[int] = None,
              end_ms: Optional[int] = None) -> List[SecondRecord]:
        """Stamp-ordered records with start_ms <= stamp < end_ms."""
        with self._lock:
            recs = list(self._seconds.values())
        return [r for r in recs
                if (start_ms is None or r.stamp_ms >= start_ms)
                and (end_ms is None or r.stamp_ms < end_ms)]

    def retained(self) -> int:
        with self._lock:
            return len(self._seconds)

    def clear(self) -> None:
        with self._lock:
            self._seconds.clear()
            self._last_stamp_ms = -1


def second_to_dict(rec: SecondRecord, metas: Sequence,
                   resource: Optional[str] = None) -> Dict:
    """Per-resource deltas for the second plus the global per-(reason,
    slot-bin) split. ``metas`` is the row metadata (row -> meta with
    .resource / .kind); only ClusterNode rows render."""
    from sentinel_tpu_torch.core.registry import KIND_CLUSTER

    resources: Dict[str, Dict] = {}
    for k, row in enumerate(rec.rows.tolist()):
        if row >= len(metas) or metas[row].kind != KIND_CLUSTER:
            continue
        name = metas[row].resource
        if resource is not None and name != resource:
            continue
        ev = rec.events[k]
        reasons = {r: int(rec.attr[k, ch])
                   for ch, r in enumerate(ATTR_REASON_NAMES)
                   if rec.attr[k, ch]}
        resources[name] = {
            "pass": int(ev[C.MetricEvent.PASS]),
            "block": int(ev[C.MetricEvent.BLOCK]),
            "success": int(ev[C.MetricEvent.SUCCESS]),
            "exception": int(ev[C.MetricEvent.EXCEPTION]),
            "rtSumMs": int(ev[C.MetricEvent.RT]),
            "occupiedPass": int(ev[C.MetricEvent.OCCUPIED_PASS]),
            "blockByReason": reasons,
            "rtBuckets": rec.hist[k].tolist(),
        }
    return {
        "timestamp": rec.stamp_ms,
        "resources": resources,
        "blockBySlot": slot_bins_to_dict(rec.slot_attr),
    }
