"""The metric timer's seal: the mean wall time of a
``MetricTimerListener.tick`` (``engine.seal_metrics`` and the metric log's
write) over the ticks that began inside the window."""


def read(t):
    return sum(t.seal_s) / len(t.seal_s) * 1e3 if t.seal_s else None
