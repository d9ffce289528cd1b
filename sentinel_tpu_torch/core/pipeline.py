"""Pipelined admission: micro-batched, double-buffered device steps (port
of ``sentinel_tpu/core/pipeline.py``).

A collector thread drains concurrently submitted entries and exits into
ONE fused step per cycle, so callers stop queueing on the engine lock one
width-1 step at a time: a verdict costs the queue wait plus one step of
the cycle's width. Each cycle has three phases —

  * **stage** the next cycle's batch into a recycled pool buffer
    (``core/batch.py:BatchBufferPool``; pinned host memory on CUDA),
  * **compute**: the dispatch copies the buffer to the card without
    blocking and runs the step on the engine's stream, then enqueues the
    verdicts' copy back into pinned memory and records an event,
  * **harvest**: waits on the oldest cycle's event OUTSIDE the engine
    lock and resolves its tickets.

Up to ``inflight_depth`` entry cycles are in flight at once (default 2,
``csp.sentinel.pipeline.inflight.depth``). Every step runs on the one
engine stream, so completion order is dispatch order and one harvest
proves every earlier copy done. On the card the port's step is not
enqueue-only: it syncs with the host ~15 times (``utils/device.py:
host_bool``), so most of a cycle's device work is over when its dispatch
returns and little is left for the next cycle to overlap.

Ordering: exits drain BEFORE entries each cycle and submissions drain
FIFO, so a thread's exit→entry program order holds (THREAD gauges stay
exact). Widths come from the engine's ladder; a cycle never splits a
submission. An idle queue harvests everything in flight at once, so the
latency floor without concurrency stays one step.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Deque, List, Optional

from sentinel_tpu_torch.core.batch import (
    BATCH_WIDTHS as LADDER,
    BatchBufferPool,
    ladder_width as _ladder_width,
    stage_row,
)
from sentinel_tpu_torch.log.record_log import record_log


class _EntryTicket:
    __slots__ = ("fields", "done", "reason", "wait_us", "submit_ts")

    def __init__(self, fields):
        self.fields = fields  # dict of scalar batch fields (+ params tuple)
        self.done = threading.Event()
        self.reason = -1
        self.wait_us = 0
        self.submit_ts = time.perf_counter()


class _ExitTicket:
    __slots__ = ("fields", "retried")

    def __init__(self, fields):
        self.fields = fields
        self.retried = False


class _InFlight:
    """One dispatched entry cycle awaiting harvest: its tickets, the
    verdicts on their way to the host, the pool buffers the dispatch may
    still be reading, and the queue wait accrued at dispatch."""

    __slots__ = ("entries", "dec", "bufs", "queue_wait_ms")

    def __init__(self, entries, dec, bufs, queue_wait_ms):
        self.entries = entries
        self.dec = dec
        self.bufs = bufs  # [(kind, buf), ...] released on harvest
        self.queue_wait_ms = queue_wait_ms


class Pipeline:
    """The collector loop bound to one engine."""

    def __init__(self, engine, max_batch: int = LADDER[-1],
                 linger_s: Optional[float] = None,
                 inflight_depth: Optional[int] = None,
                 pool_widths: Optional[tuple] = None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.engine = engine
        self.max_batch = max_batch
        self.linger_s = (linger_s if linger_s is not None
                         else _cfg.pipeline_linger_us() / 1e6)
        self.inflight_depth = max(1, int(
            inflight_depth if inflight_depth is not None
            else _cfg.pipeline_inflight_depth()))
        widths = pool_widths
        if widths is None:
            # Every ladder width a cycle can hit: item counts cap at
            # max_batch, the staged width rounds UP the ladder.
            widths = _cfg.pipeline_pool_widths() \
                or tuple(w for w in LADDER if w <= _ladder_width(max_batch))
        self.pool = BatchBufferPool(prealloc_widths=widths,
                                    pinned=engine.device.type == "cuda")
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.join_timeout_s = 2.0
        self.closed = False
        self.cycles = 0
        self.batched = 0
        self.harvests = 0
        self.fail_open_cycles = 0
        # Entry cycles by ladder width (collector-thread-only mutation).
        self.widths = {}
        # In-flight records: collector-thread-only mutation; readers take
        # len() snapshots.
        self._inflight: Deque[_InFlight] = collections.deque()
        self.max_inflight = 0
        # Exit-only cycles have no harvest of their own: their buffers ride
        # here until folded into the NEXT dispatched entry cycle's record,
        # whose harvest (it runs after them on the one stream) proves their
        # copies done. Never released from here directly.
        self._orphan_bufs: List[tuple] = []

    # -- submission (any thread) ------------------------------------------

    def submit_entry(self, fields) -> Optional[_EntryTicket]:
        """None once the pipeline is closed (caller takes the sync path)."""
        if self.closed:
            return None
        ticket = _EntryTicket(fields)
        self._queue.put(ticket)
        return ticket

    def submit_exit(self, fields) -> bool:
        if self.closed:
            return False
        self._queue.put(_ExitTicket(fields))
        return True

    # -- stats (any thread) ------------------------------------------------

    def inflight_depth_now(self) -> int:
        return len(self._inflight)

    def stats(self) -> dict:
        return {
            "cycles": self.cycles,
            "batched": self.batched,
            "harvests": self.harvests,
            "failOpenCycles": self.fail_open_cycles,
            "inflightDepth": len(self._inflight),
            "inflightDepthMax": self.max_inflight,
            "configuredDepth": self.inflight_depth,
            "poolAllocated": self.pool.allocated,
            "poolReused": self.pool.reused,
        }

    # -- the loop ----------------------------------------------------------

    def start(self) -> "Pipeline":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sentinel-torch-pipeline",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self.closed = True  # reject new submissions first
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.join_timeout_s)
            if thread.is_alive():
                # The collector is wedged mid-cycle. An inline drain now
                # would run _cycle on two threads against one engine state:
                # refuse loudly; stragglers resolve when (if) the
                # collector's final drain runs.
                record_log.warn(
                    "pipeline collector still alive after %.1fs join; "
                    "refusing inline drain (collector owns the cycle)",
                    self.join_timeout_s)
                return
        # Collector gone: flush stragglers that beat the closed flag, then
        # resolve everything in flight. A failing drain fails its tickets
        # open inside _cycle; keep draining so stop() returns with every
        # ticket resolved. Orphaned exit buffers are NOT recycled: the
        # pool dies with the pipeline.
        while True:
            try:
                if not self._drain_cycle():
                    break
            except Exception as ex:  # noqa: BLE001 — keep draining
                record_log.warn("pipeline stop drain failed: %r", ex)
        self._harvest_all()
        self._orphan_bufs = []

    def _run(self):
        while not self._stop.is_set():
            try:
                if not self._drain_cycle():
                    if self._inflight:
                        # Queue idle with work in flight: resolve the
                        # oldest cycle now (the lone caller's floor stays
                        # one step).
                        self._harvest_one()
                        continue
                    # Nothing pending: block for the next submission, then
                    # fold it into a normal lingered cycle.
                    try:
                        item = self._queue.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self._drain_cycle(initial=[item])
            except Exception as ex:  # noqa: BLE001 — fail the cycle, live on
                record_log.warn("pipeline cycle failed: %r", ex)
        self._harvest_all()  # resolve every in-flight ticket before exit

    def _drain_cycle(self, initial=None) -> bool:
        items = list(initial) if initial else []
        while len(items) < self.max_batch:
            try:
                items.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not items:
            return False
        if self.linger_s and len(items) < self.max_batch:
            # A brief linger folds late-arriving concurrent callers in.
            threading.Event().wait(self.linger_s)
            while len(items) < self.max_batch:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        self._cycle(items)
        # Depth cap: with the configured number of cycles in flight,
        # resolve the oldest BEFORE staging another.
        while len(self._inflight) >= self.inflight_depth:
            self._harvest_one()
        return True

    def _cycle(self, items: List):
        exits = [t for t in items if isinstance(t, _ExitTicket)]
        entries = [t for t in items if isinstance(t, _EntryTicket)]
        exit_bufs: List[tuple] = []
        # Exits first: program order for exit→entry on one thread. A failed
        # exit flush is re-enqueued once: dropping exits would leak the
        # concurrency gauge for good.
        if exits:
            try:
                exit_bufs.append(("exit", self._flush_exits(exits)))
            except Exception:
                retry = [t for t in exits if not t.retried]
                for t in retry:
                    t.retried = True
                    self._queue.put(t)
                if not retry:  # second failure: give up loudly
                    raise
        if entries:
            try:
                self._flush_entries(entries, exit_bufs)
            except Exception:
                # The exit dispatch (if any) went through: its buffers wait
                # for a later harvest, like any orphan.
                self._orphan_bufs.extend(exit_bufs)
                for t in entries:
                    t.reason = -2  # engine error: caller passes unguarded
                    t.done.set()
                self.fail_open_cycles += 1
                raise
        elif exit_bufs:
            self._orphan_bufs.extend(exit_bufs)

    def _flush_exits(self, exits: List[_ExitTicket]):
        buf = self.pool.acquire("exit", _ladder_width(len(exits)))
        for i, t in enumerate(exits):
            stage_row(buf, i, t.fields)
        try:
            self.engine._run_exit_batch(buf)
        except Exception:
            # The failed step's state is dropped cold: nothing it copied
            # from the buffer survives it.
            self.pool.release("exit", buf)
            raise
        return buf

    def _flush_entries(self, entries: List[_EntryTicket],
                       exit_bufs: List[tuple]):
        t0 = time.perf_counter()
        width = _ladder_width(len(entries))
        buf = self.pool.acquire("entry", width)
        for i, t in enumerate(entries):
            stage_row(buf, i, t.fields)
        try:
            dec = self.engine._run_entry_batch(buf)
        except Exception:
            self.pool.release("entry", buf)
            raise
        # The verdicts' copy to pinned memory and its event, enqueued now
        # and waited for at harvest, outside the engine lock.
        dec = self.engine.stage_decisions(dec)
        queue_wait_ms = (t0 - entries[0].submit_ts) * 1e3
        self.cycles += 1
        self.batched += len(entries)
        self.widths[width] = self.widths.get(width, 0) + 1
        # Pending exit-only-cycle buffers dispatched BEFORE this step, so
        # this record's harvest proves their copies done too.
        bufs = [("entry", buf)] + exit_bufs + self._orphan_bufs
        self._orphan_bufs = []
        self._inflight.append(_InFlight(entries, dec, bufs, queue_wait_ms))
        if len(self._inflight) > self.max_inflight:
            self.max_inflight = len(self._inflight)

    # -- harvest -----------------------------------------------------------

    def _harvest_one(self) -> None:
        """Resolve the OLDEST in-flight cycle's tickets. Once its verdicts
        are on the host, the ordered stream guarantees every dispatch
        enqueued before it has completed, so its buffers (and any folded
        orphan exit buffers) go back to the pool."""
        rec = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            reasons, waits = self.engine.harvest_decisions(rec.dec)
        except Exception:
            # The step died after dispatch: fail this cycle's tickets open
            # (the engine has dropped to a cold state; the next dispatch
            # rebuilds it). Buffers are NOT recycled: the failed stream may
            # still reference them.
            for t in rec.entries:
                t.reason = -2
                t.done.set()
            self.fail_open_cycles += 1
            self.harvests += 1
            raise
        device_wait_ms = (time.perf_counter() - t0) * 1e3
        self.harvests += 1
        for i, t in enumerate(rec.entries):
            t.reason = int(reasons[i])
            t.wait_us = int(waits[i])
            t.done.set()
        self.engine.step_timer.record_pipeline(
            depth=len(self._inflight) + 1,
            queue_wait_ms=rec.queue_wait_ms,
            device_wait_ms=device_wait_ms)
        for kind, buf in rec.bufs:
            self.pool.release(kind, buf)

    def _harvest_all(self) -> None:
        while self._inflight:
            try:
                self._harvest_one()
            except Exception as ex:  # noqa: BLE001 — keep draining
                record_log.warn("pipeline drain harvest failed: %r", ex)
