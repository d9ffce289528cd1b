"""Cluster protocol + semantics constants (port of
``sentinel_tpu/cluster/constants.py``; reference:
``cluster-common:ClusterConstants.java``, ``core:cluster/TokenResultStatus.java``).
"""

from __future__ import annotations

import enum

# Message types on the wire (reference: ClusterConstants MSG_TYPE_*).
MSG_PING = 0
MSG_FLOW = 1
MSG_PARAM_FLOW = 2

# TPU-extension message types (no reference twin — SURVEY.md §7 M4's
# "forward StatisticSlot/rule checks" bridge). Values start at 10 to
# stay clear of any future reference assignments in the 0..9 range:
# a stock reference server receiving one replies BAD_REQUEST, which the
# bridge maps to its fail-open path.
MSG_ENTRY = 10  # full slot-chain check + stats commit on the backend
MSG_EXIT = 11   # exit/commit (RT, success, thread-count release)
# Fleet telemetry pull: a collector asks a leader for its
# flight-recorder spill (complete seconds after a cursor), instance
# health, and shard ownership — one epoch-stamped JSON entity per
# reply page. Stock reference servers answer BAD_REQUEST; the
# FleetView collector marks such leaders unsupported and moves on.
MSG_FLEET = 12
# Streaming-reservation ops (the llm/ package): a remote
# gateway drives stream_open / stream_tick / stream_close on the
# engine's reservation ledger over the token-server wire, so tick
# frames ride the same reactor + frontends as token requests. Stock
# reference servers answer BAD_REQUEST; callers treat that as
# "no reservation support" and fall back to plain weighted entries.
MSG_STREAM_TICK = 13

# Sub-ops inside a MSG_STREAM_TICK frame (first entity byte).
STREAM_OP_OPEN = 0
STREAM_OP_TICK = 1
STREAM_OP_CLOSE = 2
STREAM_OP_ABORT = 3

# ClusterFlowConfig.thresholdType (reference: ClusterRuleConstant).
THRESHOLD_AVG_LOCAL = 0  # effective threshold = count × connected clients
THRESHOLD_GLOBAL = 1     # effective threshold = count

DEFAULT_SAMPLE_COUNT = 10
DEFAULT_WINDOW_INTERVAL_MS = 1000
DEFAULT_MAX_OCCUPY_RATIO = 1.0  # ClusterServerConfigManager default
DEFAULT_MAX_ALLOWED_QPS = 30_000.0  # GlobalRequestLimiter per-namespace cap


class TokenResultStatus(enum.IntEnum):
    """Reference: ``TokenResultStatus`` (values are wire-visible)."""

    BAD_REQUEST = -4
    TOO_MANY_REQUEST = -2
    FAIL = -1
    OK = 0
    BLOCKED = 1
    SHOULD_WAIT = 2
    NO_RULE_EXISTS = 3
    NO_REF_RULE_EXISTS = 4
    NOT_AVAILABLE = 5
    # TPU extension (no reference twin): the server SHED this request
    # before it reached the device step — admission queue full / over
    # watermark / deadline expired in queue. Distinct from BLOCKED (a
    # quota verdict) and FAIL (no verdict at all): the server is alive
    # but saturated, the verdict is "not now", and the flow-response
    # waitMs field carries a retry-after hint. Clients back the target
    # off without tripping the breaker and serve the entry from the
    # local lease/fallback path. A stock reference client treats the
    # unknown status as its fallbackToLocal path — same degradation.
    OVERLOADED = 6
    # TPU extension (no reference twin): sharded multi-leader clusters
    # (cluster/sharding.py) partition the flowId space into hash slices,
    # each owned by exactly one leader. A request for a flow whose slice
    # this server does NOT own is answered WRONG_SLICE — not a quota
    # verdict, not a failure: the client's routing map is stale. The
    # reply carries the server's current shard-map version (flow
    # responses in waitMs, and canonically in a trailing map-version
    # TLV), so a routing client can walk the other leaders and self-heal
    # without waiting for a config push. A stock reference client treats
    # the unknown status as fallbackToLocal — same safe degradation.
    WRONG_SLICE = 7


class ClusterFlowEvent(enum.IntEnum):
    """Channels of the server-global window (reference: ``ClusterFlowEvent``)."""

    PASS = 0
    BLOCK = 1
    PASS_REQUEST = 2
    BLOCK_REQUEST = 3
    OCCUPIED_PASS = 4
    WAITING = 5


NUM_CLUSTER_EVENTS = len(ClusterFlowEvent)
