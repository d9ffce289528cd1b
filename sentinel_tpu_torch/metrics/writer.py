"""Rotating metric log writer (port of ``sentinel_tpu/metrics/writer.py``;
reference: ``core:node/metric/MetricWriter.java``).

File layout matches the reference: ``{dir}/{app}-metrics.log.{yyyy-MM-dd}.{n}``
plus a sibling ``.idx`` index mapping each written second to the byte offset
of its first line (the searcher seeks by it). Rolls to ``.{n+1}`` when a file
exceeds ``single_file_size``; keeps at most ``total_file_count`` data files
(oldest deleted), and starts a fresh ``.1`` on date change.

Index record format: big-endian ``(second_ts: int64, offset: int64)``.
"""

from __future__ import annotations

import datetime
import os
import struct
import threading
from typing import List, Optional

from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.metrics.metric_node import MetricNode

IDX_RECORD = struct.Struct(">qq")


def metric_file_name(app: str, date: str, index: int) -> str:
    return f"{app}-metrics.log.{date}.{index}"


def parse_metric_file(name: str):
    """-> (app, date, index) or None if not a metric data file."""
    if name.endswith(".idx") or ".log." not in name:
        return None
    head, _, tail = name.rpartition(".log.")
    if not head.endswith("-metrics"):
        return None
    parts = tail.rsplit(".", 1)
    if len(parts) != 2:
        return None
    try:
        return head[: -len("-metrics")], parts[0], int(parts[1])
    except ValueError:
        return None


class MetricWriter:
    def __init__(self, app: Optional[str] = None, base_dir: Optional[str] = None,
                 single_file_size: Optional[int] = None,
                 total_file_count: Optional[int] = None):
        self.app = app or config.app_name()
        self.base_dir = base_dir or config.log_dir()
        self.single_file_size = single_file_size or config.single_metric_file_size()
        self.total_file_count = total_file_count or config.total_metric_file_count()
        self._lock = threading.Lock()
        self._data = None
        self._idx = None
        self._cur_date: Optional[str] = None
        self._cur_index = 0
        self._last_second = -1

    # -- file management ---------------------------------------------------

    def _list_data_files(self) -> List[str]:
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return []
        out = []
        for n in names:
            parsed = parse_metric_file(n)
            if parsed and parsed[0] == self.app:
                out.append(n)
        out.sort(key=lambda n: (parse_metric_file(n)[1], parse_metric_file(n)[2]))
        return out

    def _open(self, date: str, index: int, append: bool):
        os.makedirs(self.base_dir, exist_ok=True)
        path = os.path.join(self.base_dir, metric_file_name(self.app, date, index))
        mode = "ab" if append else "wb"
        self._close_files()
        self._data = open(path, mode)
        self._idx = open(path + ".idx", mode)
        self._cur_date = date
        self._cur_index = index

    def _close_files(self):
        for f in (self._data, self._idx):
            if f is not None:
                f.close()
        self._data = self._idx = None

    def _roll(self, date: str):
        if self._cur_date == date:
            self._open(date, self._cur_index + 1, append=False)
        else:
            self._open(date, 1, append=False)
        self._trim_old()

    def _trim_old(self):
        files = self._list_data_files()
        while len(files) > self.total_file_count:
            victim = files.pop(0)
            for suffix in ("", ".idx"):
                try:
                    os.remove(os.path.join(self.base_dir, victim + suffix))
                except OSError:
                    pass

    def _ensure_open(self, date: str):
        if self._data is None:
            # Resume the newest same-date file, else start .1.
            latest = None
            for n in self._list_data_files():
                _, d, i = parse_metric_file(n)
                if d == date and (latest is None or i > latest):
                    latest = i
            self._open(date, latest or 1, append=latest is not None)
            self._trim_old()
        elif self._cur_date != date or self._data.tell() > self.single_file_size:
            self._roll(date)

    # -- writing -----------------------------------------------------------

    def write(self, timestamp_ms: int, nodes: List[MetricNode]) -> None:
        """Append one sealed second of nodes (idempotent per second)."""
        if not nodes:
            return
        second_ms = timestamp_ms - timestamp_ms % 1000
        with self._lock:
            if second_ms <= self._last_second:
                return
            self._last_second = second_ms
            date = datetime.datetime.fromtimestamp(second_ms / 1000).strftime("%Y-%m-%d")
            self._ensure_open(date)
            self._idx.write(IDX_RECORD.pack(second_ms, self._data.tell()))
            for node in nodes:
                node.timestamp = second_ms
                self._data.write((node.to_thin_string() + "\n").encode("utf-8"))
            self._data.flush()
            self._idx.flush()

    def close(self) -> None:
        with self._lock:
            self._close_files()
