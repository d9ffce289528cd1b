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
  * **kernel traces** — :func:`trace` wraps ``torch.profiler`` so a window
    of real traffic can be captured as a Chrome / Perfetto trace.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Callable, Dict, Optional

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


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a kernel-level trace of everything inside the block with
    ``torch.profiler`` (CPU and, where present, CUDA activity) and write
    it as a Chrome / Perfetto trace under ``logdir``. Swallows nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_call(timer: StepTimer, kind: str, batch_n: int,
               sync: Optional[Callable[[], None]], fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` (one step dispatch), recording its
    enqueue wall always and, on sampled dispatches, the wall after
    ``sync()`` (a wait on the engine's stream; None on the CPU, where the
    step has finished when it returns)."""
    do_sync = timer.should_sync(kind)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync_ms = None
    if do_sync:
        if sync is not None:
            sync()
        sync_ms = (time.perf_counter() - t0) * 1e3
    timer.record(kind, batch_n, enqueue_ms, sync_ms)
    return out
