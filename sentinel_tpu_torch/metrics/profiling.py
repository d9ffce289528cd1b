"""Step timing and kernel tracing (port of
``sentinel_tpu/metrics/profiling.py``).

  * **per-step timing** — every device dispatch (entry / exit batch) is
    recorded: an enqueue wall always (the host time of the dispatch
    call), and on every ``sync_every``-th dispatch a synchronous wall that
    waits for the device to finish the step. On the port's CUDA step the
    two are close: the fused step makes ~15 host syncs of its own, so
    most of its device work is done by the time the dispatch returns. The
    cadence is config-tunable (``csp.sentinel.profile.syncEvery``).
    Snapshots report p50/p95/p99 per kind; the pipeline's harvests add
    the queue-wait vs device-wait split.
  * **spans and counters** — :func:`start` / :func:`stop` /
    :func:`snapshot` switch a process-wide :class:`SpanRecorder` that the
    batch path, the metric seal and the trace pump report into: named
    spans on ``time.time_ns()`` (the profiler's own clock, so every
    thread's spans sit on a device trace's timeline) and counters, kept
    per thread in memory. A site is ``with span(name):`` or
    :func:`count`; off, each reads :data:`recorder` once and does nothing
    more.
  * **kernel traces** — :func:`trace` wraps ``torch.profiler`` so a window
    of real traffic can be captured as a Chrome / Perfetto trace, with the
    recorder's spans of every thread in it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def _pct(values, q: float) -> float:
    """Exact nearest-rank quantile: the ceil(q·n/100)-th order statistic,
    always an observed sample (p99 of 7 samples is the max)."""
    vals = np.sort(np.asarray(values, dtype=np.float64))
    idx = max(0, math.ceil(q / 100.0 * vals.size) - 1)
    return float(vals[idx])


# Cumulative step-duration histogram geometry (log2 edges, ms, + the +Inf
# overflow).
STEP_DURATION_EDGES_MS = (
    0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0)
NUM_STEP_DURATION_BUCKETS = len(STEP_DURATION_EDGES_MS) + 1


class StepTimer:
    """Lock-guarded rolling timing stats for device step dispatches."""

    def __init__(self, ring: int = 512, sync_every: int = 64):
        self._lock = threading.Lock()
        self._ring = ring
        self.sync_every = sync_every
        self._counts: Dict[str, int] = {}
        self._entries: Dict[str, int] = {}
        self._enqueue: Dict[str, list] = {}
        self._sync: Dict[str, list] = {}
        # Cumulative per-kind histogram of the sampled synchronous walls:
        # monotone for the engine's lifetime (reset() leaves it).
        self._duration_hist: Dict[str, list] = {}
        self._duration_sum_ms: Dict[str, float] = {}
        # Pipelined admission: per harvested cycle, the queue wait (oldest
        # ticket submit -> dispatch), the device wait (harvest waiting on
        # the verdicts) and the in-flight depth seen at harvest.
        self._pl_queue: list = []
        self._pl_device: list = []
        self._pl_depth_sum = 0
        self._pl_cycles = 0

    def record(self, kind: str, batch_n: int, enqueue_ms: float,
               sync_ms: Optional[float] = None) -> None:
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._entries[kind] = self._entries.get(kind, 0) + batch_n
            buf = self._enqueue.setdefault(kind, [])
            buf.append(enqueue_ms)
            del buf[:-self._ring]
            if sync_ms is not None:
                sbuf = self._sync.setdefault(kind, [])
                sbuf.append(sync_ms)
                del sbuf[:-self._ring]
                hist = self._duration_hist.setdefault(
                    kind, [0] * NUM_STEP_DURATION_BUCKETS)
                b = 0
                while b < len(STEP_DURATION_EDGES_MS) \
                        and sync_ms > STEP_DURATION_EDGES_MS[b]:
                    b += 1
                hist[b] += 1
                self._duration_sum_ms[kind] = \
                    self._duration_sum_ms.get(kind, 0.0) + sync_ms

    def record_pipeline(self, depth: int, queue_wait_ms: float,
                        device_wait_ms: float) -> None:
        """Record one harvested pipeline cycle's wait decomposition."""
        with self._lock:
            self._pl_cycles += 1
            self._pl_depth_sum += depth
            self._pl_queue.append(queue_wait_ms)
            del self._pl_queue[:-self._ring]
            self._pl_device.append(device_wait_ms)
            del self._pl_device[:-self._ring]

    def pipeline_snapshot(self) -> Dict[str, float]:
        """Queue-wait vs device-wait split + mean in-flight depth over the
        recorded harvests (zeros when empty)."""
        with self._lock:
            out: Dict[str, float] = {
                "harvestedCycles": self._pl_cycles,
                "meanInflightDepth": round(
                    self._pl_depth_sum / self._pl_cycles, 3)
                if self._pl_cycles else 0.0,
            }
            for name, ring in (("queueWait", self._pl_queue),
                               ("deviceWait", self._pl_device)):
                if ring:
                    out[f"{name}P50Ms"] = round(_pct(ring, 50), 3)
                    out[f"{name}P95Ms"] = round(_pct(ring, 95), 3)
                else:
                    out[f"{name}P50Ms"] = 0.0
                    out[f"{name}P95Ms"] = 0.0
            return out

    def duration_histogram(self) -> Dict[str, Dict]:
        """Cumulative sampled-step-wall histogram per kind:
        ``{kind: {"buckets": [...], "sumMs": float, "count": int}}``
        indexed like :data:`STEP_DURATION_EDGES_MS` plus the overflow."""
        with self._lock:
            return {
                kind: {
                    "buckets": list(hist),
                    "sumMs": self._duration_sum_ms.get(kind, 0.0),
                    "count": sum(hist),
                }
                for kind, hist in self._duration_hist.items()
            }

    def should_sync(self, kind: str) -> bool:
        """True on the sampled dispatches that should wait and measure."""
        with self._lock:
            return self._counts.get(kind, 0) % self.sync_every == 0

    def snapshot(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """Read (and with ``reset=True`` atomically clear) the stats."""
        with self._lock:
            out = {}
            for kind, n in self._counts.items():
                enq = self._enqueue.get(kind, []) or [0.0]
                sync = self._sync.get(kind)
                row = {
                    "dispatches": n,
                    "entries": self._entries.get(kind, 0),
                    "enqueueP50Ms": round(_pct(enq, 50), 3),
                    "enqueueP95Ms": round(_pct(enq, 95), 3),
                    "enqueueP99Ms": round(_pct(enq, 99), 3),
                }
                if sync:
                    row["stepP50Ms"] = round(_pct(sync, 50), 3)
                    row["stepP95Ms"] = round(_pct(sync, 95), 3)
                    row["stepP99Ms"] = round(_pct(sync, 99), 3)
                    row["stepSamples"] = len(sync)
                out[kind] = row
            if reset:
                self._clear()
            return out

    def _clear(self) -> None:
        self._counts.clear()
        self._entries.clear()
        self._enqueue.clear()
        self._sync.clear()

    def reset(self) -> None:
        with self._lock:
            self._clear()


# -- spans and counters -----------------------------------------------------

#: Spans a thread keeps; later ones are counted in its ``dropped``.
SPAN_CAPACITY = 1 << 18

# The fields of a span (a list, so that an open span can be closed and
# given its step in place).
_NAME, _START, _END, _ID, _PARENT, _STEP = range(6)


class _ThreadLog:
    """One thread's spans, open-span stack and counters. Only its own
    thread writes to it, so nothing here takes a lock."""

    __slots__ = ("tid", "thread", "spans", "stack", "counters", "dropped",
                 "next_id", "last_step")

    def __init__(self):
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread().name
        self.spans: List[list] = []
        self.stack: List[list] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.next_id = 0
        self.last_step: Optional[int] = None


class SpanRecorder:
    """Spans and counters of every thread, in memory until
    :meth:`snapshot`.

    A span has a name, a start and an end in ``time.time_ns()``, its
    thread, its parent (the span open on the same thread when it opened)
    and the engine's step sequence number: :meth:`step` gives it to every
    span open on the calling thread, a child takes its parent's, and a
    thread's first-level span takes the thread's last step. Counters are
    per thread and per name."""

    def __init__(self):
        self._local = threading.local()
        self._logs: List[_ThreadLog] = []
        self._lock = threading.Lock()
        self.start_ns = time.time_ns()

    def _log(self) -> _ThreadLog:
        try:
            return self._local.log
        except AttributeError:
            log = self._local.log = _ThreadLog()
            with self._lock:
                self._logs.append(log)
            return log

    def open(self, name: str) -> list:
        """Open a span on the calling thread; pass it to :meth:`close`."""
        log = self._log()
        stack = log.stack
        span = [name, time.time_ns(), 0, log.next_id,
                stack[-1][_ID] if stack else None,
                None if stack else log.last_step]
        log.next_id += 1
        stack.append(span)
        return span

    def close(self, span: list, end_ns: Optional[int] = None) -> None:
        """Close ``span`` and every span still open inside it (those, left
        open by an exception, are not kept)."""
        span[_END] = time.time_ns() if end_ns is None else end_ns
        log = self._log()
        stack = log.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is span:
                del stack[i:]
                break
        else:
            return  # an enclosing span closed past it
        if len(log.spans) < SPAN_CAPACITY:
            log.spans.append(span)
        else:
            log.dropped += 1

    def step(self, seq: int) -> None:
        """The calling thread is running step ``seq``: its open spans, and
        the children they open, belong to it."""
        log = self._log()
        log.last_step = seq
        for span in log.stack:
            span[_STEP] = seq

    def count(self, name: str) -> None:
        counters = self._log().counters
        counters[name] = counters.get(name, 0) + 1

    def thread_counters(self) -> Dict[str, int]:
        """A copy of the calling thread's counters."""
        return dict(self._log().counters)

    def snapshot(self) -> Dict:
        """Every thread's closed spans (their steps resolved through their
        parents) and counters since the recorder started (``start_ns``):
        ``{"clock": "time_ns", "start_ns", "threads": [{"tid", "thread",
        "spans": [{"name", "start_ns", "end_ns", "id", "parent",
        "step"}], "counters", "dropped"}]}``. Span ids are unique within
        their thread."""
        with self._lock:
            logs = list(self._logs)
        threads = []
        for log in logs:
            spans = list(log.spans)
            by_id = {s[_ID]: s for s in spans + list(log.stack)}
            out = []
            for s in spans:
                step, parent = s[_STEP], s[_PARENT]
                while step is None and parent in by_id:
                    step, parent = by_id[parent][_STEP], by_id[parent][_PARENT]
                out.append({"name": s[_NAME], "start_ns": s[_START],
                            "end_ns": s[_END], "id": s[_ID],
                            "parent": s[_PARENT], "step": step})
            threads.append({"tid": log.tid, "thread": log.thread,
                            "spans": out, "counters": dict(log.counters),
                            "dropped": log.dropped})
        return {"clock": "time_ns", "start_ns": self.start_ns,
                "threads": threads}


class _Span:
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: SpanRecorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> list:
        self.span = self.rec.open(self.name)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.rec.close(self.span)
        return False


_OFF = contextlib.nullcontext()


#: The live recorder while recording, else None. Every span and counter
#: site reads this one attribute and, when it is None, does nothing else.
recorder: Optional[SpanRecorder] = None
_last: Optional[SpanRecorder] = None
_switch = threading.Lock()


def start() -> SpanRecorder:
    """Start recording (a fresh recorder), or return the live one."""
    global recorder
    with _switch:
        if recorder is None:
            recorder = SpanRecorder()
        return recorder


def stop() -> Optional[SpanRecorder]:
    """Stop recording; the stopped recorder keeps what it recorded."""
    global recorder, _last
    with _switch:
        rec, recorder = recorder, None
        if rec is not None:
            _last = rec
        return rec


def span(name: str):
    """``with span(name):`` is a span of the calling thread while
    recording; off, a context that does nothing (allocated once)."""
    rec = recorder
    return _OFF if rec is None else _Span(rec, name)


def count(name: str) -> None:
    """Count one ``name`` on the calling thread while recording."""
    rec = recorder
    if rec is not None:
        rec.count(name)


def snapshot() -> Dict:
    """:meth:`SpanRecorder.snapshot` of the live recorder, else of the last
    one stopped (no threads before any recording)."""
    rec = recorder or _last
    return rec.snapshot() if rec is not None else {"clock": "time_ns",
                                                   "start_ns": None,
                                                   "threads": []}


def _add_spans_to_chrome_trace(path: str, snap: Dict, end_ns: int) -> None:
    """Add ``snap``'s spans to the Chrome trace at ``path`` as complete
    events of their own threads, on the trace's clock (its ``ts`` counts
    microseconds from ``baseTimeNanoseconds``), and each thread's
    counters as a counter track, ``sentinel counters (<thread>)``, that
    rises from 0 at the recorder's start to its totals at ``end_ns``."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    pid = os.getpid()
    for t in snap["threads"]:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": t["tid"], "args": {"name": t["thread"]}})
        for s in t["spans"]:
            events.append({"ph": "X", "cat": "sentinel", "name": s["name"],
                           "pid": pid, "tid": t["tid"],
                           "ts": (s["start_ns"] - base) / 1e3,
                           "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                           "args": {"step": s["step"]}})
        if t["counters"]:
            track = {"ph": "C", "cat": "sentinel", "pid": pid,
                     "tid": t["tid"],
                     "name": f"sentinel counters ({t['thread']})"}
            events.append(dict(track, ts=(snap["start_ns"] - base) / 1e3,
                               args={k: 0 for k in t["counters"]}))
            events.append(dict(track, ts=(end_ns - base) / 1e3,
                               args=dict(t["counters"])))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a kernel-level trace of everything inside the block with
    ``torch.profiler`` (CPU and, where present, CUDA activity) and write
    it as a Chrome / Perfetto trace under ``logdir``, with the span
    recorder on: the spans and counters of every thread (the metric
    timer's and the trace pump's too, which the profiler does not follow)
    join the trace on their own threads. Swallows nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    owned = recorder is None
    rec = start()
    try:
        with profile(activities=activities) as prof:
            yield logdir
    finally:
        end_ns = time.time_ns()
        if owned:
            stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, rec.snapshot(), end_ns)


def timed_call(timer: Optional[StepTimer], kind: str, batch_n: int,
               sync: Optional[Callable[[], None]], fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` (one step dispatch), recording its
    enqueue wall always and, on sampled dispatches, the wall after
    ``sync()`` (a wait on the engine's stream; None on the CPU, where the
    step has finished when it returns). The same two reads of the
    monotonic clock time the step for the timer and, while the recorder
    is on, give the ``step.<kind>`` span its length (from its start on
    the recorder's clock); ``timer=None`` records the span alone."""
    rec = recorder
    do_sync = timer is not None and timer.should_sync(kind)
    if rec is not None:
        span = rec.open("step." + kind)
    t0 = time.perf_counter_ns()
    out = fn(*args, **kwargs)
    t1 = time.perf_counter_ns()
    if rec is not None:
        rec.close(span, span[_START] + (t1 - t0))
    if timer is not None:
        sync_ms = None
        if do_sync:
            if sync is not None:
                sync()
            sync_ms = (time.perf_counter_ns() - t0) / 1e6
        timer.record(kind, batch_n, (t1 - t0) / 1e6, sync_ms)
    return out
