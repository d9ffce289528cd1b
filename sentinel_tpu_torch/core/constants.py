"""Core constants for sentinel-tpu.

Mirrors the semantic constants of the reference framework
(`core:Constants.java`, `core:slots/statistic/MetricEvent.java`,
`core:slots/block/RuleConstant.java`, `core:EntryType.java` — see SURVEY.md
§2.1; reference mount was empty, paths are upstream-layout citations), but the
*representation* is TPU-first: events are indices into the last axis of one
``[rows, buckets, events]`` stats tensor instead of a ``LongAdder[]`` per
node.
"""

from __future__ import annotations

import enum


class MetricEvent(enum.IntEnum):
    """Index into the event axis of the stats tensor.

    Reference: ``MetricEvent`` (PASS, BLOCK, EXCEPTION, SUCCESS, RT,
    OCCUPIED_PASS). RT is a *sum* of response times (ms); average RT =
    RT / SUCCESS. MIN_RT lives in a separate tensor because it is a min,
    not a sum.
    """

    PASS = 0
    BLOCK = 1
    EXCEPTION = 2
    SUCCESS = 3
    RT = 4
    OCCUPIED_PASS = 5


NUM_EVENTS = len(MetricEvent)


class EntryType(enum.IntEnum):
    """Traffic direction. Only IN traffic is guarded by system rules."""

    IN = 0
    OUT = 1


class ResourceType(enum.IntEnum):
    """Classification of a resource (reference: ``ResourceTypeConstants``)."""

    COMMON = 0
    COMMON_WEB = 1
    COMMON_RPC = 2
    COMMON_API_GATEWAY = 3
    COMMON_DB_SQL = 4


class BlockReason(enum.IntEnum):
    """Decision codes returned from the device step.

    0 means pass; nonzero maps 1:1 onto the reference's BlockException
    subclasses. WAIT means "pass after sleeping wait_ms" (rate-limiter
    pacing / cluster SHOULD_WAIT / priority occupy-future-window).
    """

    PASS = 0
    FLOW = 1
    DEGRADE = 2
    SYSTEM = 3
    AUTHORITY = 4
    PARAM_FLOW = 5
    WAIT = 6
    CUSTOM = 7  # SPI-registered device checker (core/spi.py)


# ---------------------------------------------------------------------------
# Rule constants (reference: RuleConstant.java)
# ---------------------------------------------------------------------------

FLOW_GRADE_THREAD = 0
FLOW_GRADE_QPS = 1

FLOW_STRATEGY_DIRECT = 0
FLOW_STRATEGY_RELATE = 1
FLOW_STRATEGY_CHAIN = 2

CONTROL_BEHAVIOR_DEFAULT = 0
CONTROL_BEHAVIOR_WARM_UP = 1
CONTROL_BEHAVIOR_RATE_LIMITER = 2
CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER = 3

DEGRADE_GRADE_RT = 0
DEGRADE_GRADE_EXCEPTION_RATIO = 1
DEGRADE_GRADE_EXCEPTION_COUNT = 2

DEGRADE_DEFAULT_SLOW_RATIO_THRESHOLD = 1.0
DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT = 5
DEGRADE_DEFAULT_STAT_INTERVAL_MS = 1000

AUTHORITY_WHITE = 0
AUTHORITY_BLACK = 1

PARAM_FLOW_GRADE_THREAD = 0
PARAM_FLOW_GRADE_QPS = 1

SYSTEM_RULE_NOT_SET = -1.0

COLD_FACTOR = 3  # warm-up controller cold factor (Guava SmoothWarmingUp)

LIMIT_APP_DEFAULT = "default"
LIMIT_APP_OTHER = "other"

# Encoded limit-origin ids in the flow-rule tensor.
ORIGIN_ID_DEFAULT = -1
ORIGIN_ID_OTHER = -2

# Circuit breaker states (reference 1.8: CircuitBreaker.State).
BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

# ---------------------------------------------------------------------------
# Well-known context / node names (reference: Constants.java, ContextUtil)
# ---------------------------------------------------------------------------

ROOT_NODE_NAME = "machine-root"
ENTRY_NODE_NAME = "__entry_node__"  # Constants.ENTRY_NODE aggregate of all IN
CONTEXT_DEFAULT_NAME = "sentinel_default_context"

MAX_CONTEXT_NAME_SIZE = 2000
MAX_SLOT_CHAIN_SIZE = 6000  # reference CtSph cap; we cap registry rows instead

DEFAULT_MAX_RT_MS = 4900  # csp.sentinel.statistic.max.rt default

# Prioritized entries may wait at most this long for the next window bucket
# (reference: OccupyTimeoutProperty default, capped at one sample bucket).
DEFAULT_OCCUPY_TIMEOUT_MS = 500

# Per-request acquire counts ride bf16 matmul operands on device
# (ops/segment.py), exact only up to 256; the API rejects larger counts.
MAX_ACQUIRE_COUNT = 256

# ---------------------------------------------------------------------------
# Window geometry: two windows per node row, matching the reference's
# ArrayMetric pair in StatisticNode (1s/2-bucket "second" window for
# instantaneous QPS + 60s/60-bucket "minute" window for the metric log).
# ---------------------------------------------------------------------------

SECOND_WINDOW_MS = 1000
SECOND_BUCKETS = 2  # -> 500ms buckets (SampleCountProperty default 2)
MINUTE_WINDOW_MS = 60_000
MINUTE_BUCKETS = 60  # -> 1s buckets
