"""1 Hz metric aggregation loop (port of ``sentinel_tpu/metrics/timer.py``;
reference: ``core:node/metric/MetricTimerListener.java``): pull sealed
seconds from the engine (``seal_metrics``) and append them to the metric
log. The listener only reads the engine it is given (or the module's
default engine); it never builds or moves one. ``init_ops_plane``
starts one that follows the default engine, and ``shutdown_ops_plane``
stops it.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.metrics.writer import MetricWriter


class MetricTimerListener:
    def __init__(self, engine=None, writer: Optional[MetricWriter] = None,
                 period_s: float = 1.0):
        # engine=None follows the live default engine (survives reset()).
        self._engine = engine
        self.writer = writer or MetricWriter()
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        import sentinel_tpu_torch

        return sentinel_tpu_torch.get_engine()

    def tick(self, now_ms: Optional[int] = None) -> int:
        """One aggregation pass (exposed for deterministic tests).

        Returns the number of lines written.
        """
        nodes = self.engine.seal_metrics(now_ms)
        by_second = {}
        for n in nodes:
            by_second.setdefault(n.timestamp, []).append(n)
        written = 0
        for second in sorted(by_second):
            batch = by_second[second]
            self.writer.write(second, batch)
            written += len(batch)
        return written

    def start(self) -> "MetricTimerListener":
        if self._thread is None:
            self._stop.clear()  # allow start() after a stop()
            self._thread = threading.Thread(
                target=self._run, name="sentinel-metrics-record", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        from sentinel_tpu_torch.log.record_log import record_log

        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception as ex:  # keep the 1 Hz loop alive, but say why
                record_log.warn("metric timer tick failed: %r", ex)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.writer.close()
