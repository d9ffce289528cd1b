"""Device-integrated telemetry (port of ``sentinel_tpu/telemetry``):
decision attribution, decision traces, the OpenMetrics export, the flight
recorder's host history and the cross-process spans, with the reference
package's re-exports.
"""

from sentinel_tpu_torch.telemetry.attribution import (  # noqa: F401
    ATTR_REASON_NAMES,
    ATTR_REASON_VALUES,
    NUM_ATTR_REASONS,
    NUM_RT_BUCKETS,
    RT_BUCKET_EDGES_MS,
    decode_reason_code,
    encode_reason_code,
    histogram_quantile,
    rt_bucket_index,
)
from sentinel_tpu_torch.telemetry.openmetrics import (  # noqa: F401
    OPENMETRICS_CONTENT_TYPE,
    OpenMetricsBuilder,
)
from sentinel_tpu_torch.telemetry.spans import (  # noqa: F401
    SpanCollector,
    TraceContext,
    new_trace_context,
    parse_traceparent,
    to_otlp,
)
from sentinel_tpu_torch.telemetry.timeseries import (  # noqa: F401
    SecondRecord,
    TimeseriesHistory,
    second_to_dict,
)
from sentinel_tpu_torch.telemetry.trace_ring import (  # noqa: F401
    DecisionTraceBuffer,
)
