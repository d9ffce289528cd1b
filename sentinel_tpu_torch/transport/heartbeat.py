"""Heartbeat sender (port of ``sentinel_tpu/transport/heartbeat.py``;
reference: ``SimpleHttpHeartbeatSender`` + ``HeartbeatSenderInitFunc``,
SURVEY.md §2.3, §3.4): periodic POST to the dashboard's
``/registry/machine`` so it discovers this instance and marks it healthy.
Dashboard list comes from ``csp.sentinel.dashboard.server``
(comma-separated ``host:port``); failures rotate to the next address.

Resilience: after a FULL rotation of dashboard addresses fails, the next
beat waits on a seedable ``RetryPolicy`` backoff (base = the heartbeat
interval) instead of hammering dead dashboards at the fixed cadence; one
success restores the cadence. The reported address falls back to
127.0.0.1 on a host with no route out.
"""

from __future__ import annotations

import os
import socket
import threading
import urllib.parse
import urllib.request
from typing import List, Optional

from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.resilience import RetryPolicy, faults, register_probe
from sentinel_tpu_torch.utils import time_util


def _local_ip() -> str:
    override = config.get("csp.sentinel.heartbeat.client.ip")
    if override:
        return override
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


class HeartbeatSender:
    def __init__(self, dashboards: Optional[List[str]] = None,
                 interval_ms: Optional[int] = None,
                 api_port: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        servers = dashboards
        if servers is None:
            raw = config.dashboard_server() or ""
            servers = [s.strip() for s in raw.split(",") if s.strip()]
        self.dashboards = servers
        self.interval_ms = interval_ms or config.heartbeat_interval_ms()
        self.api_port = api_port or config.api_port()
        self.retry_policy = retry_policy or RetryPolicy.from_config(
            "heartbeat", base_ms=self.interval_ms,
            max_ms=max(5 * 60_000, self.interval_ms))
        self._retry_session = self.retry_policy.session()
        self.consecutive_failures = 0
        self.last_success_ms = -1
        self._idx = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._probe_off = None

    def health(self) -> dict:
        return {"lastSuccessMs": self.last_success_ms,
                "consecutiveFailures": self.consecutive_failures,
                "intervalMs": self.interval_ms}

    def heartbeat_message(self) -> dict:
        import sentinel_tpu_torch

        return {
            "app": config.app_name(),
            "app_type": str(config.app_type()),
            "v": sentinel_tpu_torch.__version__,
            "version": str(int(__import__("time").time() * 1000)),
            "hostname": socket.gethostname(),
            "ip": _local_ip(),
            "port": str(self.api_port),
            "pid": str(os.getpid()),
        }

    def send_once(self) -> bool:
        """One POST to the current dashboard; rotate on failure."""
        if not self.dashboards:
            return False
        target = self.dashboards[self._idx % len(self.dashboards)]
        url = f"http://{target}/registry/machine"
        data = urllib.parse.urlencode(self.heartbeat_message()).encode("ascii")
        req = urllib.request.Request(url, data=data)
        # Optional shared secret: deployments that enable dashboard auth can
        # also close the (auth-exempt) registration endpoint to strangers.
        from sentinel_tpu_torch.core.config import HEARTBEAT_TOKEN

        token = config.get(HEARTBEAT_TOKEN, "") or ""
        if token:
            req.add_header("X-Sentinel-Heartbeat-Token", token)
        try:
            faults.fire("heartbeat.post")
            if self._post(req):
                # Monotonic: the exported last-success stamp must never
                # run backwards across a dashboard failover (rotating to
                # a dashboard whose clock the frozen test clock — or a
                # skewed host — reports earlier would otherwise make
                # "age since last success" jump negative on scrapes).
                self.last_success_ms = max(
                    self.last_success_ms, time_util.current_time_millis())
                return True
            self._idx += 1
            return False
        except OSError:
            self._idx += 1  # try the next dashboard next beat
            return False

    def _post(self, req) -> bool:
        """The actual POST (seam for tests; overridable)."""
        with urllib.request.urlopen(req, timeout=3) as resp:
            return 200 <= resp.status < 300

    def _next_wait_ms(self, ok: bool) -> int:
        """Cadence governor: steady interval while healthy; once EVERY
        configured dashboard has failed in a row (one full rotation),
        back off — a dead dashboard tier shouldn't eat a POST timeout
        per address per interval forever."""
        if ok:
            self.consecutive_failures = 0
            self._retry_session.reset()
            return self.interval_ms
        self.consecutive_failures += 1
        rotation = max(1, len(self.dashboards))
        if self.consecutive_failures % rotation == 0:
            return max(self.interval_ms, self._retry_session.next_delay_ms())
        return self.interval_ms

    def start(self) -> "HeartbeatSender":
        if self._thread is None:
            self._stop.clear()  # allow start() after a stop()
            self._probe_off = register_probe("heartbeat", self.health)
            self._thread = threading.Thread(
                target=self._run, name="sentinel-heartbeat", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        from sentinel_tpu_torch.log.record_log import record_log

        wait_ms = self.interval_ms
        while not self._stop.wait(wait_ms / 1000.0):
            try:
                ok = self.send_once()
            except Exception as ex:
                ok = False
                record_log.warn("heartbeat failed: %r", ex)
            wait_ms = self._next_wait_ms(ok)

    def stop(self) -> None:
        self._stop.set()
        if self._probe_off is not None:
            self._probe_off()
            self._probe_off = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
