"""Dashboard metrics pipeline: poller + in-memory repository (port of
``sentinel_tpu/dashboard/metrics.py``, on the port's ``MetricNode``).

Reference: ``dashboard:metric/MetricFetcher.java`` (polls every healthy
machine's ``/metric`` on a ~1s cadence over a lagged window, parses
``MetricNode`` thin lines) + ``dashboard:repository/metric/
InMemoryMetricsRepository.java`` (per (app, resource) time-series, 5-minute
retention, queried by the UI).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.dashboard.client import ApiError, SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement
from sentinel_tpu_torch.metrics.metric_node import MetricNode

RETENTION_MS = 5 * 60_000   # reference: 5-minute in-memory retention
FETCH_LAG_MS = 2_000        # read sealed seconds only (reference lags ~6s)
FETCH_SPAN_MS = 6_000       # window length per poll


@dataclass
class MetricEntry:
    """One (app, resource, second) aggregated across machines."""

    timestamp: int
    pass_qps: int = 0
    block_qps: int = 0
    success_qps: int = 0
    exception_qps: int = 0
    rt_sum: float = 0.0       # sum of per-machine avg RT (weight = machines)
    machines: int = 0

    @property
    def avg_rt(self) -> float:
        return self.rt_sum / self.machines if self.machines else 0.0

    def to_dict(self, resource: str) -> Dict:
        return {
            "resource": resource, "timestamp": self.timestamp,
            "passQps": self.pass_qps, "blockQps": self.block_qps,
            "successQps": self.success_qps, "exceptionQps": self.exception_qps,
            "rt": round(self.avg_rt, 2),
        }


class InMemoryMetricsRepository:
    """(app, resource) -> {second_ts -> MetricEntry}, TTL-evicted."""

    def __init__(self, retention_ms: int = RETENTION_MS):
        self.retention_ms = retention_ms
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, str], Dict[int, MetricEntry]] = defaultdict(dict)

    def save(self, app: str, node: MetricNode) -> None:
        with self._lock:
            series = self._data[(app, node.resource)]
            e = series.get(node.timestamp)
            if e is None:
                e = series[node.timestamp] = MetricEntry(timestamp=node.timestamp)
            e.pass_qps += node.pass_qps
            e.block_qps += node.block_qps
            e.success_qps += node.success_qps
            e.exception_qps += node.exception_qps
            e.rt_sum += node.rt
            e.machines += 1

    def _evict(self, now_ms: int) -> None:
        floor = now_ms - self.retention_ms
        with self._lock:
            for key in list(self._data):
                series = self._data[key]
                for ts in [t for t in series if t < floor]:
                    del series[ts]
                if not series:
                    del self._data[key]

    def apps(self) -> List[str]:
        """Apps with any retained series (OpenMetrics export iterates
        this, not discovery — aggregates can outlive a machine's
        heartbeat within the retention window)."""
        with self._lock:
            return sorted({a for (a, _r) in self._data})

    def resources_of(self, app: str) -> List[str]:
        with self._lock:
            return sorted({r for (a, r) in self._data if a == app})

    def query(self, app: str, resource: str,
              start_ms: int, end_ms: int) -> List[Dict]:
        with self._lock:
            series = dict(self._data.get((app, resource), {}))
        return [e.to_dict(resource) for ts, e in sorted(series.items())
                if start_ms <= ts <= end_ms]

    def top_resources(self, app: str, start_ms: int, end_ms: int,
                      limit: int = 30) -> List[str]:
        """Resources ranked by total pass+block volume in the range
        (reference: ``queryTopResourceMetric``'s ordering)."""
        totals: Dict[str, int] = defaultdict(int)
        with self._lock:
            for (a, r), series in self._data.items():
                if a != app:
                    continue
                for ts, e in series.items():
                    if start_ms <= ts <= end_ms:
                        totals[r] += e.pass_qps + e.block_qps
        return [r for r, _ in
                sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]]


class MetricFetcher:
    """Background poller: every healthy machine's /metric -> repository."""

    def __init__(self, apps: AppManagement,
                 repository: Optional[InMemoryMetricsRepository] = None,
                 api: Optional[SentinelApiClient] = None,
                 interval_s: float = 1.0):
        self.apps = apps
        self.repository = repository or InMemoryMetricsRepository()
        self.api = api or SentinelApiClient(timeout_s=2.0)
        self.interval_s = interval_s
        # resume point per machine so seconds aren't double-counted
        self._last_fetched: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def fetch_once(self, now_ms: Optional[int] = None) -> int:
        """One sweep over all healthy machines; returns lines ingested."""
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        end = now_ms - FETCH_LAG_MS
        ingested = 0
        # Resume keys are kept for every REGISTERED machine (incl. ones on a
        # transient heartbeat blip — pruning those would re-fetch and
        # double-count seconds when they come back); only machines dead long
        # enough to be purged from the registry are dropped.
        self.apps.purge_dead(now_ms)
        registered = {m.key for app in self.apps.app_names()
                      for m in self.apps.machines(app, include_dead=True)}
        for app in self.apps.app_names():
            for m in self.apps.healthy_machines(app):
                start = self._last_fetched.get(m.key, end - FETCH_SPAN_MS) + 1
                start = max(start, end - FETCH_SPAN_MS)
                if start > end:
                    continue
                try:
                    text = self.api.fetch_metric(m.ip, m.port, start, end)
                except ApiError:
                    continue  # machine down mid-poll; heartbeat will expire it
                newest = self._last_fetched.get(m.key, 0)
                for line in text.splitlines():
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        node = MetricNode.from_thin_string(line)
                    except (ValueError, IndexError):
                        continue
                    self.repository.save(app, node)
                    newest = max(newest, node.timestamp)
                    ingested += 1
                if newest:
                    self._last_fetched[m.key] = newest
        # Machines that churned away (restarts on ephemeral ports) would
        # otherwise accumulate resume keys forever.
        for key in [k for k in self._last_fetched if k not in registered]:
            del self._last_fetched[key]
        self.repository._evict(now_ms)
        return ingested

    def start(self) -> "MetricFetcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dashboard-metric-fetcher", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.fetch_once()
            except Exception:  # never kill the poll loop
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
