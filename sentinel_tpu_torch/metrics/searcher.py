"""Metric log range reads (port of ``sentinel_tpu/metrics/searcher.py``;
reference: ``core:node/metric/MetricSearcher.java`` + ``MetricsReader.java``): seek by the ``.idx`` second->offset map, stream
lines, filter by time range and optional resource identity.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sentinel_tpu_torch.metrics.metric_node import MetricNode
from sentinel_tpu_torch.metrics.writer import IDX_RECORD, parse_metric_file

DEFAULT_MAX_LINES = 6000


class MetricSearcher:
    def __init__(self, base_dir: str, app: str):
        self.base_dir = base_dir
        self.app = app

    def _data_files(self) -> List[str]:
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
        return [os.path.join(self.base_dir, n) for n in out]

    @staticmethod
    def _seek_offset(idx_path: str, begin_ms: int) -> Optional[int]:
        """Offset of the first second >= begin_ms, or None if file is older."""
        try:
            with open(idx_path, "rb") as f:
                while True:
                    rec = f.read(IDX_RECORD.size)
                    if len(rec) < IDX_RECORD.size:
                        return None
                    second, offset = IDX_RECORD.unpack(rec)
                    if second >= begin_ms:
                        return offset
        except OSError:
            return None

    def find(self, begin_ms: int, recommend_lines: int = DEFAULT_MAX_LINES) -> List[MetricNode]:
        """Reference ``find(beginTimeMs, recommendLines)``: read forward from
        the first second >= begin until the line budget is spent."""
        return self._query(begin_ms, None, None, recommend_lines)

    def find_by_time_and_resource(self, begin_ms: int, end_ms: int,
                                  identity: Optional[str] = None,
                                  max_lines: int = DEFAULT_MAX_LINES) -> List[MetricNode]:
        return self._query(begin_ms, end_ms, identity, max_lines)

    def _query(self, begin_ms, end_ms, identity, max_lines) -> List[MetricNode]:
        out: List[MetricNode] = []
        for path in self._data_files():
            offset = self._seek_offset(path + ".idx", begin_ms)
            if offset is None:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    for raw in f:
                        try:
                            node = MetricNode.from_thin_string(raw.decode("utf-8"))
                        except (ValueError, UnicodeDecodeError):
                            continue
                        if node.timestamp < begin_ms:
                            continue
                        if end_ms is not None and node.timestamp > end_ms:
                            return out
                        if identity is not None and node.resource != identity:
                            continue
                        out.append(node)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out
