"""Layered static configuration (port of ``sentinel_tpu/core/config.py``,
the keys this package reads).

Reference: ``core:config/SentinelConfig.java``. Environment variables
(the literal dotted key or its ``CSP_SENTINEL_*`` upper-snake form)
override values set with :meth:`SentinelConfig.set`, which override the
defaults. Keys keep the reference's dotted names. The JAX package's
properties-file layer is not ported: no key this package reads needs it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

# Keys read by this package.
LOG_DIR = "csp.sentinel.log.dir"
LEASE_ENABLED = "csp.sentinel.lease.enabled"
# profile.syncEvery: every Nth device dispatch waits for a true step wall
# (StepTimer sampling cadence; the rest record the enqueue wall only).
PROFILE_SYNC_EVERY = "csp.sentinel.profile.syncEvery"
# trace.sampleEvery: every Nth BLOCKED entry is retained as a decision
# trace (0 disables); trace.capacity bounds the host-side ring.
TELEMETRY_TRACE_SAMPLE_EVERY = "csp.sentinel.telemetry.trace.sampleEvery"
TELEMETRY_TRACE_CAPACITY = "csp.sentinel.telemetry.trace.capacity"
# Pipelined admission: entry cycles allowed in flight at once (1 = the
# synchronous ping-pong, 2 = double buffering); how long a cycle waits to
# fold late concurrent callers in; comma-separated ladder widths to
# pre-allocate staging buffers for (empty = every width up to max_batch).
PIPELINE_INFLIGHT_DEPTH = "csp.sentinel.pipeline.inflight.depth"
PIPELINE_LINGER_US = "csp.sentinel.pipeline.linger.us"
PIPELINE_POOL_WIDTHS = "csp.sentinel.pipeline.pool.widths"

DEFAULT_LEASE_ENABLED = "true"
DEFAULT_PROFILE_SYNC_EVERY = 64
DEFAULT_TELEMETRY_TRACE_SAMPLE_EVERY = 64
DEFAULT_TELEMETRY_TRACE_CAPACITY = 256
DEFAULT_PIPELINE_INFLIGHT_DEPTH = 2
DEFAULT_PIPELINE_LINGER_US = 100


def _env_key(key: str) -> str:
    return key.upper().replace(".", "_").replace("-", "_")


class SentinelConfig:
    """Process-wide key/value config: environment, then ``set``, then
    defaults."""

    def __init__(self):
        self._lock = threading.RLock()
        self._config: Dict[str, str] = {LEASE_ENABLED: DEFAULT_LEASE_ENABLED}

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            for env in (key, _env_key(key)):
                if env in os.environ:
                    return os.environ[env]
            return self._config.get(key, default)

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._config[key] = str(value)

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        try:
            return int(v) if v is not None else default
        except ValueError:
            return default

    def lease_enabled(self) -> bool:
        return (self.get(LEASE_ENABLED) or DEFAULT_LEASE_ENABLED).lower() \
            != "false"

    def log_dir(self) -> str:
        d = self.get(LOG_DIR)
        if d:
            return d
        return os.path.join(os.path.expanduser("~"), "logs", "csp")

    def pipeline_inflight_depth(self) -> int:
        v = self.get_int(PIPELINE_INFLIGHT_DEPTH,
                         DEFAULT_PIPELINE_INFLIGHT_DEPTH)
        return v if v > 0 else DEFAULT_PIPELINE_INFLIGHT_DEPTH

    def pipeline_linger_us(self) -> int:
        v = self.get_int(PIPELINE_LINGER_US, DEFAULT_PIPELINE_LINGER_US)
        return v if v >= 0 else DEFAULT_PIPELINE_LINGER_US

    def pipeline_pool_widths(self) -> tuple:
        """Parsed ladder widths to pre-allocate staging buffers for; () =
        the caller's default. Malformed entries are dropped."""
        out = []
        for part in (self.get(PIPELINE_POOL_WIDTHS) or "").split(","):
            try:
                w = int(part.strip())
            except ValueError:
                continue
            if w > 0:
                out.append(w)
        return tuple(out)

    def reset_for_tests(self) -> None:
        with self._lock:
            self._config = {LEASE_ENABLED: DEFAULT_LEASE_ENABLED}


config = SentinelConfig()
