"""App/machine discovery from client heartbeats (port of
``sentinel_tpu/dashboard/discovery.py``).

Reference: ``dashboard:discovery/MachineDiscovery.java`` +
``SimpleMachineDiscovery`` + ``AppManagement`` + ``MachineInfo`` — machines
register by POSTing ``/registry/machine`` (the engines' ``HeartbeatSender``
does this every 10s); a machine is healthy while its last heartbeat is
fresher than the timeout.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_UNHEALTHY_MS = 30_000  # 3 missed 10s heartbeats
DEAD_MS = 10 * 60_000          # drop from listings entirely


@dataclass
class MachineInfo:
    app: str
    ip: str
    port: int
    hostname: str = ""
    app_type: int = 0
    version: str = ""
    pid: int = 0
    last_heartbeat_ms: int = 0

    @property
    def key(self) -> str:
        return f"{self.ip}:{self.port}"

    def healthy(self, now_ms: Optional[int] = None) -> bool:
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        return now_ms - self.last_heartbeat_ms < DEFAULT_UNHEALTHY_MS

    def dead(self, now_ms: Optional[int] = None) -> bool:
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        return now_ms - self.last_heartbeat_ms > DEAD_MS

    def to_dict(self) -> Dict:
        return {
            "app": self.app, "ip": self.ip, "port": self.port,
            "hostname": self.hostname, "appType": self.app_type,
            "version": self.version, "pid": self.pid,
            "lastHeartbeat": self.last_heartbeat_ms,
            "healthy": self.healthy(),
        }


class AppManagement:
    """app -> {ip:port -> MachineInfo}; the dashboard's machine registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._apps: Dict[str, Dict[str, MachineInfo]] = {}

    def register(self, info: MachineInfo) -> None:
        info.last_heartbeat_ms = int(time.time() * 1000)
        with self._lock:
            self._apps.setdefault(info.app, {})[info.key] = info

    def app_names(self) -> List[str]:
        with self._lock:
            return sorted(self._apps)

    def machines(self, app: str, include_dead: bool = False) -> List[MachineInfo]:
        with self._lock:
            ms = list(self._apps.get(app, {}).values())
        if not include_dead:
            ms = [m for m in ms if not m.dead()]
        return sorted(ms, key=lambda m: m.key)

    def healthy_machines(self, app: str) -> List[MachineInfo]:
        return [m for m in self.machines(app) if m.healthy()]

    def remove(self, app: str, ip: str, port: int) -> bool:
        with self._lock:
            return self._apps.get(app, {}).pop(f"{ip}:{port}", None) is not None

    def purge_dead(self, now_ms: Optional[int] = None) -> int:
        """Drop machines silent past DEAD_MS from the registry entirely
        (callers prune their per-machine state against the survivors)."""
        removed = 0
        with self._lock:
            for app in list(self._apps):
                machines = self._apps[app]
                for key in [k for k, m in machines.items() if m.dead(now_ms)]:
                    del machines[key]
                    removed += 1
                if not machines:
                    del self._apps[app]
        return removed
