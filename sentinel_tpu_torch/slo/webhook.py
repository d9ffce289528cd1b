"""Alert webhook fan-out: bounded queue, background worker, retries
(port of ``sentinel_tpu/slo/webhook.py``).

Alert transitions (fired / resolved) POST as JSON to every configured
URL (``csp.sentinel.alert.webhook.urls``, comma-separated). Delivery is
strictly off the evaluation path: the SLO manager enqueues into a
BOUNDED queue (the overload stance — a dead webhook endpoint
must never turn into unbounded memory or a stalled evaluator; on a full
queue the oldest event is dropped and counted) and one worker thread
delivers with ``resilience.RetryPolicy`` backoff per attempt.

Payload contract (docs/OPERATIONS.md "SLOs & alerting")::

    POST <url>  Content-Type: application/json
    {"type": "fired" | "resolved", "seq": 17, "timestamp": 1700000000000,
     "source": "<app name>", "alert": {<alert fields — see `alerts`>}}

A 2xx response is delivered; anything else (or a connect failure)
retries up to ``csp.sentinel.alert.webhook.retries`` times with the
policy's jittered backoff, then counts as failed for that URL. Events
are delivered per-URL independently — one dead endpoint never blocks
the others beyond its own retry budget.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from sentinel_tpu_torch.resilience import RetryPolicy

QUEUE_CAPACITY = 256


class AlertWebhook:
    """Fan one engine's alert events out to the configured endpoints."""

    def __init__(self, urls: Optional[List[str]] = None,
                 timeout_ms: Optional[int] = None,
                 retries: Optional[int] = None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self.urls = list(urls) if urls is not None \
            else _cfg.alert_webhook_urls()
        self.timeout_s = (timeout_ms if timeout_ms is not None
                          else _cfg.alert_webhook_timeout_ms()) / 1000.0
        self.retries = (retries if retries is not None
                        else _cfg.alert_webhook_retries())
        # Short, capped backoff: webhook delivery shares its patience
        # budget with the alert's freshness — a minute-old page is noise.
        self.retry_policy = RetryPolicy.from_config(
            "alert.webhook", base_ms=100, max_ms=2_000)
        self._queue: "queue.Queue" = queue.Queue(maxsize=QUEUE_CAPACITY)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.delivered = 0
        self.failed = 0
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return bool(self.urls)

    def submit(self, event: Dict) -> None:
        """Enqueue one alert event; never blocks. On a full queue the
        OLDEST queued event is dropped (the newest transition is the one
        an operator needs) and counted."""
        if not self.enabled or self._stop.is_set():
            return
        self._ensure_worker()
        while True:
            try:
                self._queue.put_nowait(event)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    with self._lock:
                        self.dropped += 1
                except queue.Empty:
                    pass

    def _ensure_worker(self) -> None:
        if self._thread is not None:
            return
        with self._lock:
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._run, name="sentinel-alert-webhook",
                    daemon=True)
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "urls": len(self.urls),
                "queued": self._queue.qsize(),
                "delivered": self.delivered,
                "failed": self.failed,
                "dropped": self.dropped,
            }

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            body = json.dumps(event).encode("utf-8")
            for url in self.urls:
                self._deliver(url, body)

    def _deliver(self, url: str, body: bytes) -> None:
        session = self.retry_policy.session()
        for attempt in range(self.retries + 1):
            if self._stop.is_set() and attempt > 0:
                break  # drain the first try, never a shutdown-blocking loop
            try:
                req = urllib.request.Request(
                    url, data=body, method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    if 200 <= r.status < 300:
                        with self._lock:
                            self.delivered += 1
                        return
            except (urllib.error.URLError, OSError, ValueError):
                pass
            if attempt < self.retries:
                self._stop.wait(session.next_delay_ms() / 1000.0)
        with self._lock:
            self.failed += 1
