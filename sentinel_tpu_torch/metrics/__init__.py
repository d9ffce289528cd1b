"""Metric log pipeline (port of ``sentinel_tpu/metrics``): per-second
aggregation of every resource to a rotating log + index, and range reads
for the ops plane.
"""

from sentinel_tpu_torch.metrics.metric_node import MetricNode
from sentinel_tpu_torch.metrics.profiling import StepTimer
from sentinel_tpu_torch.metrics.profiling import trace as profile_trace
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.metrics.timer import MetricTimerListener
from sentinel_tpu_torch.metrics.writer import MetricWriter

__all__ = ["MetricNode", "MetricSearcher", "MetricTimerListener",
           "MetricWriter", "StepTimer", "profile_trace"]
