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

DEFAULT_LEASE_ENABLED = "true"


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

    def lease_enabled(self) -> bool:
        return (self.get(LEASE_ENABLED) or DEFAULT_LEASE_ENABLED).lower() \
            != "false"

    def log_dir(self) -> str:
        d = self.get(LOG_DIR)
        if d:
            return d
        return os.path.join(os.path.expanduser("~"), "logs", "csp")

    def reset_for_tests(self) -> None:
        with self._lock:
            self._config = {LEASE_ENABLED: DEFAULT_LEASE_ENABLED}


config = SentinelConfig()
