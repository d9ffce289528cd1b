"""``MetricNode``: one resource-second of aggregated statistics (port of
``sentinel_tpu/metrics/metric_node.py``).

The line format is an API (SURVEY.md §5: "this format is an API: dashboard
and ops tooling parse it"), byte-compatible with the reference's thin form::

    timestamp|resource|passQps|blockQps|successQps|exceptionQps|rt|occupiedPassQps|concurrency|classification

(reference: ``core:node/metric/MetricNode.java`` format/parse pair).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MetricNode:
    timestamp: int        # second-aligned epoch millis
    resource: str
    pass_qps: int = 0
    block_qps: int = 0
    success_qps: int = 0
    exception_qps: int = 0
    rt: float = 0.0       # average RT over the second (ms)
    occupied_pass_qps: int = 0
    concurrency: int = 0
    classification: int = 0  # ResourceType

    def to_thin_string(self) -> str:
        # Resource names may not contain the separator; scrub like the
        # reference does for illegal characters.
        res = self.resource.replace("|", "_")
        return (
            f"{self.timestamp}|{res}|{self.pass_qps}|{self.block_qps}|"
            f"{self.success_qps}|{self.exception_qps}|{int(self.rt)}|"
            f"{self.occupied_pass_qps}|{self.concurrency}|{self.classification}"
        )

    @classmethod
    def from_thin_string(cls, line: str) -> "MetricNode":
        parts = line.strip().split("|")
        if len(parts) < 7:
            raise ValueError(f"malformed metric line: {line!r}")
        node = cls(
            timestamp=int(parts[0]),
            resource=parts[1],
            pass_qps=int(parts[2]),
            block_qps=int(parts[3]),
            success_qps=int(parts[4]),
            exception_qps=int(parts[5]),
            rt=float(parts[6]),
        )
        if len(parts) > 7:
            node.occupied_pass_qps = int(parts[7])
        if len(parts) > 8:
            node.concurrency = int(parts[8])
        if len(parts) > 9:
            node.classification = int(parts[9])
        return node
