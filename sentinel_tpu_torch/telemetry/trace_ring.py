"""Sampled decision traces (port of ``sentinel_tpu/telemetry/trace_ring.py``):
every Nth blocked entry, pulled off the device asynchronously and kept on
the host.

A trace says what one concrete rejected request looked like: resource,
origin, reason, first-blocking rule slot and the instant window of its
row. The dispatch path only snapshots the columns the worker reads and
hands them over through a bounded queue (a full queue drops the batch,
counted). On a CUDA engine the snapshot of a device column is a
non-blocking copy into pinned host memory followed by one CUDA event,
enqueued on the engine's stream right after the step that produced it;
the daemon worker waits on that event in ITS thread, never on the step
stream's, then samples the blocked rows at the configured cadence,
resolves rows to names through the registry, and reads the blocked rows'
instant window through ``engine.row_stats()`` (under the engine lock).
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.config import (
    DEFAULT_TELEMETRY_TRACE_CAPACITY,
    DEFAULT_TELEMETRY_TRACE_SAMPLE_EVERY,
    TELEMETRY_TRACE_CAPACITY,
    TELEMETRY_TRACE_SAMPLE_EVERY,
)
from sentinel_tpu_torch.telemetry.attribution import encode_reason_code

# The batch and verdict columns the worker reads.
_BATCH_COLUMNS = ("cluster_row", "origin_row", "count", "entry_in")
_DECISION_COLUMNS = ("reason", "rule_slot")


def _host(col) -> np.ndarray:
    return col if isinstance(col, np.ndarray) else col.numpy()


class DecisionTraceBuffer:
    """Host-side ring of sampled blocked-entry traces for one engine."""

    def __init__(self, engine, sample_every: Optional[int] = None,
                 capacity: Optional[int] = None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.engine = engine
        if sample_every is None:
            sample_every = _cfg.get_int(
                TELEMETRY_TRACE_SAMPLE_EVERY,
                DEFAULT_TELEMETRY_TRACE_SAMPLE_EVERY)
        if capacity is None:
            capacity = _cfg.get_int(TELEMETRY_TRACE_CAPACITY,
                                    DEFAULT_TELEMETRY_TRACE_CAPACITY)
        self.sample_every = max(0, int(sample_every))  # 0 = disabled
        self.capacity = max(1, int(capacity))
        self._ring: List[Dict] = []
        self._lock = threading.Lock()
        # Bounded hand-off: the dispatch path never blocks on telemetry.
        self._queue: "queue.Queue" = queue.Queue(maxsize=8)
        # Serializes _process between the worker and drain(), so drain()
        # never returns while the worker is mid-item.
        self._proc_lock = threading.Lock()
        self._dropped = 0
        self._errors = 0
        self._error_logged_s = 0.0
        self._seen_blocked = 0
        self._recorded = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # stop() is terminal until start(): a submit racing or following
        # stop is a silent no-op, never a worker resurrection.
        self._stopped = False

    # -- dispatch-path side (cheap; runs under the engine lock) -----------

    @staticmethod
    def _snap(col, pending: list):
        """A copy of one column the later steps and a recycled staging
        buffer cannot change: numpy and CPU tensors are copied now; a
        CUDA tensor is copied into pinned memory without blocking, and
        ``pending`` notes that an event must order the worker's read."""
        if isinstance(col, np.ndarray):
            return col.copy()
        if col.device.type == "cuda":
            host = torch.empty(col.shape, dtype=col.dtype, pin_memory=True)
            host.copy_(col, non_blocking=True)
            pending.append(True)
            return host
        return col.clone()

    def submit(self, batch, decisions, now_ms: int) -> None:
        """Queue one dispatched batch's verdicts for async sampling.
        ``batch`` is the host staging dict or an ``EntryBatch`` of
        tensors. Never blocks: a full queue drops the batch (counted),
        and a stopped buffer ignores the submit."""
        if self.sample_every <= 0 or self._stopped:
            return
        self._ensure_worker()
        pending: list = []
        get = batch.get if isinstance(batch, dict) else \
            (lambda name: getattr(batch, name))
        cols = {name: self._snap(get(name), pending)
                for name in _BATCH_COLUMNS}
        for name in _DECISION_COLUMNS:
            cols[name] = self._snap(getattr(decisions, name), pending)
        event = None
        if pending:
            event = torch.cuda.Event()
            event.record()
        try:
            self._queue.put_nowait((cols, event, int(now_ms)))
        except queue.Full:
            self._dropped += 1

    # -- worker side ------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            with self._lock:
                # Re-check under the lock: stop() flips _stopped under it
                # before taking the worker out.
                if self._stopped:
                    return
                if self._worker is None or not self._worker.is_alive():
                    self._stop.clear()
                    self._worker = threading.Thread(
                        target=self._run, name="sentinel-torch-trace-pump",
                        daemon=True)
                    self._worker.start()
                    # The worker waits on CUDA events: a daemon thread
                    # inside a CUDA call at interpreter teardown can abort
                    # the process, so stop it before Python finalizes.
                    atexit.register(self.stop)

    def _pump_one(self) -> bool:
        """Dequeue and process ONE item under the processing lock, so an
        item is either still queued or being processed under the lock
        drain() takes, never invisibly in between."""
        with self._proc_lock:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return False
            try:
                self._process(*item)
            except Exception as ex:  # noqa: BLE001 — counted and logged
                self._errors += 1
                self._note_error(ex)
            return True

    def _note_error(self, ex: Exception) -> None:
        now = time.monotonic()
        if now - self._error_logged_s >= 10.0:
            self._error_logged_s = now
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn("trace worker failed to process a batch "
                            "(errors=%d): %r", self._errors, ex)

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._pump_one():
                self._stop.wait(0.05)

    def drain(self) -> None:
        """Process everything queued in the CALLER's thread and wait out
        any item the worker has in flight: afterwards every batch
        submitted before the call is reflected in the ring."""
        while self._pump_one():
            pass
        with self._proc_lock:
            pass

    def _process(self, cols: Dict, event, now_ms: int) -> None:
        if event is not None:
            event.synchronize()
        reasons = _host(cols["reason"])
        blocked_idx = np.nonzero(reasons > 0)[0]
        if blocked_idx.size == 0:
            return
        picked = []
        with self._lock:
            for i in blocked_idx.tolist():
                self._seen_blocked += 1
                if self._seen_blocked % self.sample_every == 0:
                    picked.append(i)
        if not picked:
            return
        slots = _host(cols["rule_slot"])
        rows = _host(cols["cluster_row"])
        origin_rows = _host(cols["origin_row"])
        counts = _host(cols["count"])
        entry_in = _host(cols["entry_in"])
        window = self._window_snapshot([int(rows[i]) for i in picked])
        metas = self.engine._device_metas()
        for i in picked:
            row = int(rows[i])
            orow = int(origin_rows[i])
            reason = int(reasons[i])
            slot = int(slots[i])
            trace = {
                "timestamp": now_ms,
                "resource": metas[row].resource if 0 <= row < len(metas)
                else f"row:{row}",
                "origin": metas[orow].origin if 0 <= orow < len(metas)
                else "",
                "reason": C.BlockReason(reason).name
                if reason in C.BlockReason._value2member_map_ else str(reason),
                "ruleSlot": slot,
                "reasonCode": encode_reason_code(reason, slot),
                "count": int(counts[i]),
                "entryIn": bool(entry_in[i]),
                "window": window.get(row, {}),
            }
            with self._lock:
                self._recorded += 1
                self._ring.append(trace)
                del self._ring[:-self.capacity]

    def _window_snapshot(self, rows: List[int]) -> Dict[int, Dict]:
        """Instant-window view of the blocked rows at trace time: one
        read per sampled batch, amortized by the sampling cadence."""
        try:
            totals, threads = self.engine.row_stats()
        except Exception:  # noqa: BLE001 — a trace without its window
            return {}
        out: Dict[int, Dict] = {}
        for row in set(rows):
            if not 0 <= row < totals.shape[0]:
                continue
            t = totals[row]
            out[row] = {
                "passQps": round(float(t[C.MetricEvent.PASS]), 2),
                "blockQps": round(float(t[C.MetricEvent.BLOCK]), 2),
                "curThreadNum": int(threads[row]),
            }
        return out

    # -- read side --------------------------------------------------------

    def snapshot(self, limit: Optional[int] = None,
                 offset: int = 0) -> Dict:
        """Ring + sampler counters, newest trace first. ``limit=0`` is the
        counters-only read; ``offset`` skips the newest N traces."""
        from sentinel_tpu_torch.telemetry.timeseries import page_newest_first

        with self._lock:
            traces = list(self._ring)
            seen, recorded = self._seen_blocked, self._recorded
        traces = page_newest_first(traces, limit, offset)
        traces.reverse()  # newest first
        return {
            "sampleEvery": self.sample_every,
            "capacity": self.capacity,
            "seenBlocked": seen,
            "recorded": recorded,
            "droppedBatches": self._dropped,
            "errors": self._errors,
            "traces": traces,
        }

    def start(self) -> "DecisionTraceBuffer":
        """Re-arm a stopped buffer; the worker spawns on the next submit."""
        self._stopped = False
        return self

    def stop(self) -> None:
        """Terminal until :meth:`start`: joins the worker, and later
        submits are silent no-ops."""
        # Flip and swap under the spawn lock; join OUTSIDE it (the worker
        # takes the same lock in _process).
        with self._lock:
            self._stopped = True
            self._stop.set()
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout=2.0)
        atexit.unregister(self.stop)
