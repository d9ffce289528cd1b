"""Rotating framework logs (port of ``sentinel_tpu/log/record_log.py``).

Reference: ``core:log/RecordLog.java`` writing ``sentinel-record.log``, and
``LogSlot`` writing ``sentinel-block.log``. The block log keeps the
reference's one-line-per-blocked-request shape:
``timestamp|1|resource,BlockException-class,origin,count``; the record log
is a plain timestamped app log. Files open lazily on first write, under
``csp.sentinel.log.dir`` (``core/config.py``) as it stands then, so
importing the package never touches the filesystem.
"""

from __future__ import annotations

import datetime
import io
import os
import threading
from typing import Optional

from sentinel_tpu_torch.core.config import config


class RecordLog:
    """Size-rotated append-only log file."""

    def __init__(self, name: str, max_bytes: int = 50 * 1024 * 1024,
                 backups: int = 3, log_dir: Optional[str] = None):
        self.name = name
        self.max_bytes = max_bytes
        self.backups = backups
        self._dir_override = log_dir
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOWrapper] = None
        self._path: Optional[str] = None

    def _ensure_open(self):
        if self._fh is not None:
            return
        d = self._dir_override or config.log_dir()
        os.makedirs(d, exist_ok=True)
        self._path = os.path.join(d, self.name)
        self._fh = open(self._path, "a", encoding="utf-8")

    def _maybe_roll(self):
        if self._fh.tell() < self.max_bytes:
            return
        self._fh.close()
        for i in range(self.backups - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._fh = open(self._path, "a", encoding="utf-8")

    def write_line(self, line: str) -> None:
        with self._lock:
            try:
                self._ensure_open()
                self._fh.write(line + "\n")
                self._fh.flush()
                self._maybe_roll()
            except OSError:
                pass

    def info(self, msg: str, *args) -> None:
        if args:
            msg = msg % args
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        self.write_line(f"{ts} INFO {msg}")

    def warn(self, msg: str, *args) -> None:
        if args:
            msg = msg % args
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        self.write_line(f"{ts} WARN {msg}")

    @property
    def path(self) -> Optional[str]:
        """The file written to, once the first line opened it."""
        return self._path

    def close(self) -> None:
        """Close the file; the next write reopens it under the log
        directory configured then."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


record_log = RecordLog("sentinel-record.log")
block_log = RecordLog("sentinel-block.log")


def log_block(resource: str, exception_name: str, origin: str, count: int,
              now_ms: int) -> None:
    """``LogSlot`` analog: one line per blocked request."""
    origin = origin or ""
    block_log.write_line(
        f"{now_ms}|1|{resource},{exception_name},{origin},{count}")
